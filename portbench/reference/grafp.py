"""Plain reference of GraFPrint's model (arch 'grafp'): log-mel patch ->
peak embedding -> ViG graph encoder -> projector -> L2-normalised
fingerprint, written from the published design (github.com/chymaera96/
GraFP: encoder/graph_encoder.py, encoder/torch_vertex.py, simclr.py)
over a flat dict of float32 tensors.

Every Grapher rebuilds its k-nearest-neighbour graph (cosine of the fc1
features, self included) and applies the Max-Relative conv: the node's
features interleaved with max over neighbours minus the node, through a
grouped (4) pointwise conv. BatchNorm normalises the channel axis with
eps 1e-5: in eval mode from the running statistics, in train mode from
the batch's (biased variance). No kernel, no folding, no batching
tricks; products in float32 without TF32 (``ops.exact_float32``).

The dict's keys are the program's ``state_dict`` names, which the
benchmark fills itself (``yardstick/weights.py``); nothing here reads a
value that the program computed.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from portbench.reference.ops import Precision

# size: (blocks per stage, channels per stage), graph_encoder.py:96-110
SIZES = {
    "t": ((2, 2, 6, 2), (64, 128, 256, 512)),
    "s": ((2, 2, 6, 2), (80, 160, 400, 640)),
    "m": ((2, 2, 16, 2), (96, 192, 384, 768)),
    "l": ((2, 2, 18, 2), (128, 256, 512, 1024)),
}
BN_EPS = 1e-5
GROUPS = 4


class Pass:
    """One forward: the weights, the precision, and whether BatchNorm
    takes the batch's statistics (``train``); ``stats`` collects each
    BatchNorm's batch (mean, biased variance) in train mode."""

    def __init__(self, sd: Dict[str, torch.Tensor], precision: Precision,
                 train: bool = False):
        self.sd, self.p, self.train = sd, precision, train
        self.stats: Dict[str, tuple] = {}

    def bn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        sd = self.sd
        if self.train:
            axes = tuple(range(x.dim() - 1))
            mean = x.mean(axes)
            var = ((x - mean) ** 2).mean(axes)
            self.stats[name] = (mean.detach(), var.detach())
        else:
            mean, var = sd[f"{name}.running_mean"], sd[f"{name}.running_var"]
        return (x - mean) * torch.rsqrt(var + BN_EPS) * sd[f"{name}.weight"] + sd[f"{name}.bias"]

    def linear(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.p.linear(x, self.sd[f"{name}.weight"], self.sd.get(f"{name}.bias"))


def normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def peak_embed(ps: Pass, spec: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(B, n_mels, n_frames) -> (B, N, n_filters): min-max normalised
    spectrogram beside time and frequency coordinates, one strided conv,
    ReLU; node index = mel_row * width + frame."""
    b, h, w = spec.shape
    mn = spec.amin(dim=(1, 2), keepdim=True)
    mx = spec.amax(dim=(1, 2), keepdim=True)
    s = (spec - mn) / torch.clamp(mx - mn, min=1e-8)
    t_coord = torch.linspace(0.0, 1.0, w, device=spec.device).view(1, 1, w).expand(b, h, w)
    f_coord = torch.linspace(0.0, 1.0, h, device=spec.device).view(1, h, 1).expand(b, h, w)
    x = torch.stack([t_coord, f_coord, s], dim=1)
    wt = ps.sd["peak.conv.weight"]
    kh, kw = wt.shape[-2:]
    y = F.relu(ps.p.conv2d(x, wt, ps.sd["peak.conv.bias"],
                           stride=(int(cfg["peak_stride"]), 1), padding=(kh // 2, kw // 2)))
    return y.permute(0, 2, 3, 1).reshape(b, -1, wt.shape[0])


def grapher(ps: Pass, name: str, x: torch.Tensor, k: int) -> torch.Tensor:
    """fc1 -> BN -> Max-Relative graph conv over the k nearest (C -> 2C)
    -> BN -> ReLU -> fc2 -> BN, plus the input."""
    y = ps.bn(f"{name}.fc1_bn", ps.linear(f"{name}.fc1", x))
    with torch.no_grad():
        yn = normalize(y.detach())
        idx = torch.topk(torch.matmul(yn, yn.transpose(1, 2)), k, dim=-1).indices
    b, n, c = y.shape
    nbrs = y[torch.arange(b, device=y.device)[:, None, None], idx]   # (B, N, k, C)
    rel = nbrs.amax(dim=2) - y
    z = torch.stack([y, rel], dim=-1).reshape(b, n, GROUPS, 2 * c // GROUPS)
    w = ps.sd[f"{name}.gconv.conv.weight"]                            # (g, cig, cog)
    g = ps.p.einsum("bngi,gio->bngo", z, w).reshape(b, n, 2 * c)
    g = F.relu(ps.bn(f"{name}.gconv.bn", g + ps.sd[f"{name}.gconv.conv.bias"]))
    return ps.bn(f"{name}.fc2_bn", ps.linear(f"{name}.fc2", g)) + x


def ffn(ps: Pass, name: str, x: torch.Tensor) -> torch.Tensor:
    y = F.relu(ps.bn(f"{name}.fc1_bn", ps.linear(f"{name}.fc1", x)))
    return ps.bn(f"{name}.fc2_bn", ps.linear(f"{name}.fc2", y)) + x


def downsample(ps: Pass, name: str, x: torch.Tensor) -> torch.Tensor:
    """Stride-2 length-3 conv along the node axis, then BN."""
    y = ps.p.conv1d(x.transpose(1, 2), ps.sd[f"{name}.conv.weight"],
                    ps.sd[f"{name}.conv.bias"], stride=2, padding=1)
    return ps.bn(f"{name}.bn", y.transpose(1, 2))


def encoder(ps: Pass, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    blocks, _ = SIZES[cfg["size"]]
    k = int(cfg["k"])
    e = "encoder"
    x = F.leaky_relu(ps.bn(f"{e}.stem_bn", ps.linear(f"{e}.stem", x)), 0.2)
    idx = 0
    for stage, nb in enumerate(blocks):
        if stage > 0:
            x = downsample(ps, f"{e}.down{stage}", x)
        for _ in range(nb):
            x = grapher(ps, f"{e}.block{idx}_grapher", x, k)
            x = ffn(ps, f"{e}.block{idx}_ffn", x)
            idx += 1
    return ps.linear(f"{e}.proj", x).mean(dim=1)


def projector(ps: Pass, h: torch.Tensor) -> torch.Tensor:
    return normalize(ps.linear("projector.fc2", F.elu(ps.linear("projector.fc1", h))))


def forward(sd: Dict[str, torch.Tensor], spec: torch.Tensor, cfg: dict,
            precision: Optional[Precision] = None, train: bool = False,
            ps: Optional[Pass] = None) -> torch.Tensor:
    """(B, n_mels, n_frames) log-mel -> (B, d) fingerprints in float32.
    ``ps`` (optional) is the Pass to run, to read its ``stats`` after."""
    ps = ps or Pass(sd, precision or Precision("f32"), train)
    return projector(ps, encoder(ps, peak_embed(ps, spec.to(torch.float32), cfg), cfg))


def residual_scales(sd: Dict[str, torch.Tensor]):
    """Names of the BatchNorm scales that end a residual branch (each
    Grapher's and FFN's fc2_bn)."""
    return [k for k in sd if k.endswith("fc2_bn.weight")]
