"""SimCLR wrapper: spectrogram -> encoder -> projector -> L2-normalised
128-d fingerprint z (port of ``grafp_tpu.models.simclr``; eval and train
modes). arch 'grafp' puts PeakEmbed ahead of the GraphEncoder; the
baselines 'ast' (``models/ast.py``) and 'nafp' (``models/nafp.py``) take
the spectrogram directly."""

from __future__ import annotations

import copy
from typing import Dict, Iterable, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from grafp_tpu_torch.core.device import resolve_device
from grafp_tpu_torch.models.ast import ASTEncoder
from grafp_tpu_torch.models.gnn import GraphEncoder
from grafp_tpu_torch.models.layers import PointwiseConv, init_parameters
from grafp_tpu_torch.models.nafp import NAFPEncoder
from grafp_tpu_torch.models.peak_embed import PeakEmbed
from grafp_tpu_torch.ops.knn import l2_normalize

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# serve_quant -> the layers' quant mode (grafp_tpu/models/simclr.py:78-89)
_QUANT = {"none": None, "int8": "dynamic", "int8_static": "static",
          "int8_calibrate": "calibrate"}


class Projector(nn.Module):
    """Linear(h -> d*u) -> ELU -> Linear(d*u -> d) (simclr.py:24-45)."""

    def __init__(self, h: int = 1024, d: int = 128, u: int = 32,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fc1 = PointwiseConv(h, d * u, dtype=dtype)
        self.fc2 = PointwiseConv(d * u, d, dtype=dtype)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.elu(self.fc1(h)))


class SimCLRModel(nn.Module):
    """(B, n_mels, n_frames) spectrogram -> (h, z). PeakEmbed runs only
    for arch 'grafp'."""

    def __init__(self, encoder: nn.Module, n_filters: int = 8,
                 blur_kernel: Tuple[int, int] = (7, 7), peak_stride: int = 2,
                 h: int = 1024, d: int = 128, u: int = 32,
                 dtype: Optional[torch.dtype] = None, arch: str = "grafp"):
        super().__init__()
        self.peak = (PeakEmbed(n_filters, tuple(blur_kernel), peak_stride, dtype=dtype)
                     if arch == "grafp" else None)
        self.encoder = encoder
        self.projector = Projector(h, d, u, dtype=dtype)

    def forward(self, spec: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (h, z): encoder embedding and fingerprint."""
        h = self.encoder(spec if self.peak is None else self.peak(spec))
        z = l2_normalize(self.projector(h), dim=-1)
        return h, z


def build_model(cfg, generator: Optional[torch.Generator] = None,
                device: Optional[Union[str, torch.device]] = None,
                train: bool = False, fuse_serving: str = "auto") -> SimCLRModel:
    """The model of ``cfg["arch"]`` ('grafp', 'ast', 'nafp') from a
    Config, initialised from ``generator``
    (seed 0 when None) with the reference's torch initialisers, on
    ``device`` (None = the CUDA card), in eval mode, or in train mode
    (BatchNorm on batch statistics) when ``train``. Parameters are f32
    in both; ``compute_dtype`` sets the dtype they are cast to at use.
    ``fuse_serving`` goes to every Grapher ('auto': the fused block on the
    card, the unfused path on the CPU). The kernels take every k and node
    count that the JAX package's Pallas kernels take (N >= k).
    The grafp encoder takes the Config's schedules (``dilation_schedule``,
    ``drop_path``, ``drop_path_schedule``), ``knn_strategy`` (an unknown
    one raises ValueError), ``knn_block_size`` and ``remat``, as the JAX
    package's does (``grafp_tpu/models/simclr.py:98-100``).

    ``serve_quant`` (none | int8 | int8_static | int8_calibrate, else
    ValueError) makes the grafp encoder's convs int8 for serving
    (``models/layers.py``); the projector stays full precision, as in the
    JAX package, whose last linear feeds the fingerprint directly. The
    baselines refuse it (NotImplementedError), and ``create_train_state``
    refuses a quantised Config. 'int8_static' serves from the ``amax``
    buffers that ``calibrate_act_scales`` fills (``FingerprintPipeline``
    calibrates them itself when they are all 0)."""
    dev = resolve_device(device)
    arch = cfg["arch"]
    if arch not in ("grafp", "ast", "nafp"):
        raise NotImplementedError(f"arch {arch}")
    serve_quant = str(cfg["serve_quant"] or "none").lower()
    if serve_quant not in _QUANT:
        raise ValueError("serve_quant must be one of none|int8|int8_static|"
                         f"int8_calibrate, got {serve_quant!r}")
    quant = _QUANT[serve_quant]
    if quant and arch != "grafp":
        raise NotImplementedError("serve_quant int8 supports arch=grafp only")
    name = cfg["compute_dtype"] or "float32"
    if name not in _DTYPES:
        raise ValueError(f"compute_dtype must be float32|bfloat16, got {name!r}")
    dtype = _DTYPES[name] if name != "float32" else None
    if arch == "grafp":
        encoder, h = GraphEncoder(
            in_features=cfg["n_filters"], size=cfg["size"], k=int(cfg["k"]),
            emb_dims=cfg["h"], dilation_schedule=cfg["dilation_schedule"],
            drop_path=float(cfg["drop_path"]),
            drop_path_schedule=cfg["drop_path_schedule"],
            knn_block_rows=int(cfg["knn_block_size"]),
            knn_strategy=cfg["knn_strategy"], remat=bool(cfg["remat"]), dtype=dtype,
            fuse_serving=fuse_serving, quant=quant), cfg["h"]
    else:
        # the JAX projector takes the encoder's width, whatever cfg['h'] says
        encoder = (ASTEncoder if arch == "ast" else NAFPEncoder)(dtype=dtype)
        h = encoder.out_features
    model = SimCLRModel(encoder, n_filters=cfg["n_filters"],
                        blur_kernel=tuple(cfg["blur_kernel"]),
                        peak_stride=cfg["peak_stride"], h=h,
                        d=cfg["d"], u=cfg["u"], dtype=dtype, arch=arch)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    init_parameters(model, g)
    return model.to(dev).train(train)


def calibrate_act_scales(cfg, model_or_state, spec_batches: Iterable,
                         device: Optional[Union[str, torch.device]] = None
                         ) -> Dict[str, torch.Tensor]:
    """The activation maxima that ``serve_quant='int8_static'`` serves from
    (``grafp_tpu/models/simclr.py:134-167``): an 'int8_calibrate' model with
    the weights of ``model_or_state`` (a model, or a state_dict; any
    ``amax`` in it is dropped, so each call starts from 0) runs each
    (B, n_mels, n_frames) batch of ``spec_batches`` with the exact products
    and raises every quantised layer's ``amax`` to the running max |x| of
    its input. Returns {state_dict key ``....amax``: f32 scalar}, which a
    static model takes through ``load_state_dict(..., strict=False)`` or
    ``FingerprintPipeline(act_scales=...)``. Runs on ``device``: the model's
    own, or for a state_dict None = the CUDA card."""
    if isinstance(model_or_state, nn.Module):
        state = model_or_state.state_dict()
        if device is None:
            device = next(model_or_state.parameters()).device
    else:
        state = model_or_state
    ccfg = copy.copy(cfg)
    ccfg["serve_quant"] = "int8_calibrate"
    model = build_model(ccfg, device=device)
    model.load_state_dict({k: v for k, v in state.items() if not k.endswith(".amax")})
    dev = next(model.parameters()).device
    seen = 0
    with torch.no_grad():
        for spec in spec_batches:
            model(torch.as_tensor(spec, dtype=torch.float32, device=dev))
            seen += 1
    if not seen:
        raise ValueError("calibrate_act_scales: no calibration batches")
    return {k: v for k, v in model.state_dict().items() if k.endswith(".amax")}
