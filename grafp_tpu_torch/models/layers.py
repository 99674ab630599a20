"""Shared building blocks on channels-last (B, N, C) node tensors (port of
``grafp_tpu.models.layers``, eval-mode forward only).

Dtype rule, as flax applies it with ``dtype=bfloat16``: a dense layer
casts its input, kernel and bias to the compute dtype, so the port stores
those weights in the compute dtype; a BatchNorm keeps f32 statistics and
parameters, normalises in f32 and emits the compute dtype.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def act_layer(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation registry (reference torch_nn.py:9-25; flax's gelu is the
    tanh approximation)."""
    name = name.lower()
    if name == "relu":
        return F.relu
    if name == "leakyrelu":
        return lambda x: F.leaky_relu(x, negative_slope=0.2)
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "hswish":
        return F.hardswish
    if name == "elu":
        return F.elu
    raise NotImplementedError(f"activation [{name}] is not found")


# --- initialisers: the reference's torch defaults, from an explicit generator

def uniform_(t: torch.Tensor, bound: float, g: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_((torch.rand(t.shape, generator=g) * 2.0 - 1.0) * bound)


def normal_(t: torch.Tensor, std: float, g: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=g) * std)


def torch_default_init(weight: torch.Tensor, bias: Optional[torch.Tensor],
                       fan_in: int, g: torch.Generator) -> None:
    """nn.Linear/nn.Conv default: kaiming_uniform(a=sqrt(5)) weight, i.e.
    U(+-1/sqrt(fan_in)), and U(+-1/sqrt(fan_in)) bias."""
    uniform_(weight, 1.0 / math.sqrt(fan_in), g)
    if bias is not None:
        uniform_(bias, 1.0 / math.sqrt(fan_in), g)


class PointwiseConv(nn.Module):
    """1x1 conv over node tensors == a linear layer on the channel axis.
    ``weight`` is (out, in), as nn.Linear."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        dt = dtype or torch.float32
        self.weight = nn.Parameter(torch.empty(out_features, in_features, dtype=dt))
        self.bias = (nn.Parameter(torch.empty(out_features, dtype=dt))
                     if bias else None)

    def init_weights(self, g: torch.Generator) -> None:
        torch_default_init(self.weight, self.bias, self.weight.shape[1], g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


def grouped_as_concat_dense(w: torch.Tensor, c_in: int, c_out: int) -> torch.Tensor:
    """(g, cig, cog) grouped weights over an INTERLEAVED input layout ->
    dense (c_in, c_out) weight for the same map on the CONCAT layout
    [a || b] (copy of ``grafp_tpu.models.layers.grouped_as_concat_dense``).
    Row p is row interleave(p) of the block-diagonal expansion; entries off
    the blocks are exact zeros."""
    g, cig, cog = w.shape
    bd = w.new_zeros((g, cig, g, cog))
    idx = torch.arange(g, device=w.device)
    bd[idx, :, idx, :] = w
    bd = bd.reshape(c_in, c_out)                 # rows: interleaved order
    half = c_in // 2
    ar = torch.arange(half, device=w.device)
    return bd[torch.cat([2 * ar, 2 * ar + 1])]


class GroupedPointwiseConv(nn.Module):
    """Grouped 1x1 conv (reference BasicConv, groups=4) applied to the
    concat layout [x || rel - x] that the MRConv kernel emits. The
    parameters keep the reference's grouped (g, cig, cog) layout over the
    interleaved channels; the equivalent dense (c_in, c_out) weight is
    built once, after every parameter load, and applied as one matmul."""

    def __init__(self, in_features: int, out_features: int, groups: int = 4,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if in_features % groups or out_features % groups:
            raise ValueError((in_features, out_features, groups))
        dt = dtype or torch.float32
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(torch.empty(
            groups, in_features // groups, out_features // groups, dtype=dt))
        # the grouped conv's f32 output gets an f32 bias (flax adds it
        # after the f32-accumulated matmul)
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.register_buffer("dense", torch.empty(in_features, out_features,
                                                  dtype=dt), persistent=False)
        self.register_load_state_dict_post_hook(
            lambda module, _keys: module.refresh_dense())

    def init_weights(self, g: torch.Generator) -> None:
        # kaiming_normal over the torch fan_in (c_in / groups)
        normal_(self.weight, math.sqrt(2.0 / self.weight.shape[1]), g)
        with torch.no_grad():
            self.bias.zero_()
        self.refresh_dense()

    def refresh_dense(self) -> None:
        with torch.no_grad():
            self.dense.copy_(grouped_as_concat_dense(
                self.weight, self.in_features, self.out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.to(self.dense.dtype), self.dense)
        return y.to(torch.float32) + self.bias


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over the last (channel) axis from running
    statistics, eps 1e-5, computed in f32: (x - mean) * rsqrt(var + eps) *
    scale + bias, emitted in ``dtype`` (f32 when None)."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "training-mode BatchNorm belongs to the train slice; call "
                ".eval()")
        mul = torch.rsqrt(self.running_var + 1e-5) * self.weight
        y = (x.to(torch.float32) - self.running_mean) * mul + self.bias
        return y.to(self.dtype) if self.dtype else y


def init_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every submodule that defines ``init_weights(g)``, in
    module order, from one generator."""
    for m in model.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(generator)
    return model
