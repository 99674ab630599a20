"""SimCLR wrapper: spectrogram -> PeakEmbed -> GraphEncoder -> projector
-> L2-normalised 128-d fingerprint z (port of ``grafp_tpu.models.simclr``,
eval-mode forward)."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from grafp_tpu_torch.core.device import resolve_device
from grafp_tpu_torch.models.gnn import GraphEncoder
from grafp_tpu_torch.models.layers import init_parameters, torch_default_init
from grafp_tpu_torch.models.peak_embed import PeakEmbed
from grafp_tpu_torch.ops.knn import l2_normalize

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Projector(nn.Module):
    """Linear(h -> d*u) -> ELU -> Linear(d*u -> d) (simclr.py:24-45)."""

    def __init__(self, h: int = 1024, d: int = 128, u: int = 32,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        dt = dtype or torch.float32
        self.fc1 = nn.Linear(h, d * u, dtype=dt)
        self.fc2 = nn.Linear(d * u, d, dtype=dt)

    def init_weights(self, g: torch.Generator) -> None:
        for fc in (self.fc1, self.fc2):
            torch_default_init(fc.weight, fc.bias, fc.in_features, g)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        z = F.elu(self.fc1(h.to(self.fc1.weight.dtype)))
        return self.fc2(z)


class SimCLRModel(nn.Module):
    """arch='grafp': (B, n_mels, n_frames) spectrogram -> (h, z)."""

    def __init__(self, encoder: GraphEncoder, n_filters: int = 8,
                 blur_kernel: Tuple[int, int] = (7, 7), peak_stride: int = 2,
                 h: int = 1024, d: int = 128, u: int = 32,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.peak = PeakEmbed(n_filters, tuple(blur_kernel), peak_stride,
                              dtype=dtype)
        self.encoder = encoder
        self.projector = Projector(h, d, u, dtype=dtype)

    def forward(self, spec: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (h, z): encoder embedding and fingerprint."""
        h = self.encoder(self.peak(spec))
        z = l2_normalize(self.projector(h), dim=-1)
        return h, z


def build_model(cfg, generator: Optional[torch.Generator] = None,
                device: Optional[Union[str, torch.device]] = None) -> SimCLRModel:
    """The flagship model from a Config, initialised from ``generator``
    (seed 0 when None) with the reference's torch initialisers, in eval
    mode on ``device`` (None = the CUDA card)."""
    dev = resolve_device(device)
    if cfg["arch"] != "grafp":
        raise NotImplementedError(
            f"arch {cfg['arch']!r}: the port has arch='grafp' only")
    quant = str(cfg["serve_quant"] or "none").lower()
    if quant != "none":
        raise NotImplementedError(
            f"serve_quant {quant!r}: int8 serving is a later slice of the port")
    name = cfg["compute_dtype"] or "float32"
    if name not in _DTYPES:
        raise ValueError(f"compute_dtype must be float32|bfloat16, got {name!r}")
    dtype = _DTYPES[name] if name != "float32" else None
    encoder = GraphEncoder(
        in_features=cfg["n_filters"], size=cfg["size"], k=int(cfg["k"]),
        emb_dims=cfg["h"], dilation_schedule=cfg["dilation_schedule"],
        drop_path_schedule=cfg["drop_path_schedule"], dtype=dtype)
    model = SimCLRModel(encoder, n_filters=cfg["n_filters"],
                        blur_kernel=tuple(cfg["blur_kernel"]),
                        peak_stride=cfg["peak_stride"], h=cfg["h"],
                        d=cfg["d"], u=cfg["u"], dtype=dtype)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    init_parameters(model, g)
    return model.to(dev).eval()
