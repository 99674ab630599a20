"""SimCLR wrapper: spectrogram -> PeakEmbed -> GraphEncoder -> projector
-> L2-normalised 128-d fingerprint z (port of ``grafp_tpu.models.simclr``;
eval and train modes)."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from grafp_tpu_torch.core.device import resolve_device
from grafp_tpu_torch.models.gnn import GraphEncoder
from grafp_tpu_torch.models.layers import PointwiseConv, init_parameters
from grafp_tpu_torch.models.peak_embed import PeakEmbed
from grafp_tpu_torch.ops.knn import l2_normalize
from grafp_tpu_torch.ops.mrconv_concat import MAX_K, MAX_KN

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


def _check_kernel_shapes(cfg) -> None:
    """Refuse a Config whose first Grapher the CUDA selection cannot run:
    k above MAX_K, or k * N above MAX_KN for the stage-1 node count N (the
    JAX kernels need only N >= k, ``pallas_knn.py:184,381,594``)."""
    k = int(cfg["k"])
    kh = int(cfg["blur_kernel"][0])
    rows = (int(cfg["n_mels"]) + 2 * (kh // 2) - kh) // int(cfg["peak_stride"]) + 1
    n = rows * int(cfg["n_frames"])
    if k > MAX_K or k * n > MAX_KN:
        raise NotImplementedError(
            f"k={k} with N={n} nodes: the CUDA kernels take k <= {MAX_K} and "
            f"k * N <= {MAX_KN} (k * N = {k * n}); lifting the limit is a later "
            "change of the selection (csrc/mrconv_select.cuh); the CPU path "
            "has no limit")


def build_model(cfg, generator: Optional[torch.Generator] = None,
                device: Optional[Union[str, torch.device]] = None,
                train: bool = False, fuse_serving: str = "auto") -> SimCLRModel:
    """The flagship model from a Config, initialised from ``generator``
    (seed 0 when None) with the reference's torch initialisers, on
    ``device`` (None = the CUDA card), in eval mode, or in train mode
    (BatchNorm on batch statistics) when ``train``. Parameters are f32
    in both; ``compute_dtype`` sets the dtype they are cast to at use.
    ``fuse_serving`` goes to every Grapher ('auto': the fused block on the
    card, the unfused path on the CPU). On a CUDA device a Config whose
    k or node count the kernels do not take is refused here."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        _check_kernel_shapes(cfg)
    if cfg["arch"] != "grafp":
        raise NotImplementedError(
            f"arch {cfg['arch']!r}: the port has arch='grafp' only")
    quant = str(cfg["serve_quant"] or "none").lower()
    if quant != "none":
        raise NotImplementedError(
            f"serve_quant {quant!r}: int8 serving is a later slice of the port")
    strategy = cfg["knn_strategy"]
    if strategy not in ("auto", "pallas"):
        # the JAX Grapher runs the pair-layout MRConv for these
        # (grafp_tpu/models/gnn.py:262-287); the port's Grapher always
        # runs the kernel
        raise NotImplementedError(
            f"knn_strategy {strategy!r}: the pair-layout Grapher is a later "
            "slice of the port ('auto' and 'pallas' run the kernel)")
    name = cfg["compute_dtype"] or "float32"
    if name not in _DTYPES:
        raise ValueError(f"compute_dtype must be float32|bfloat16, got {name!r}")
    dtype = _DTYPES[name] if name != "float32" else None
    encoder = GraphEncoder(
        in_features=cfg["n_filters"], size=cfg["size"], k=int(cfg["k"]),
        emb_dims=cfg["h"], dilation_schedule=cfg["dilation_schedule"],
        drop_path_schedule=cfg["drop_path_schedule"], dtype=dtype,
        fuse_serving=fuse_serving)
    model = SimCLRModel(encoder, n_filters=cfg["n_filters"],
                        blur_kernel=tuple(cfg["blur_kernel"]),
                        peak_stride=cfg["peak_stride"], h=cfg["h"],
                        d=cfg["d"], u=cfg["u"], dtype=dtype)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    init_parameters(model, g)
    return model.to(dev).train(train)
