"""Shared building blocks on channels-last (B, N, C) node tensors (port of
``grafp_tpu.models.layers``).

Dtype rule, as flax applies it with ``param_dtype=float32`` and
``dtype=bfloat16``: every parameter is an f32 master copy that a layer
casts to the compute dtype at use, so gradients and optimizer updates
land on f32 values; a dense layer computes in the compute dtype; a
BatchNorm keeps f32 statistics and parameters, normalises in f32 and
emits the compute dtype. The grouped MRConv conv keeps its f32
accumulator (``dense_matmul_bf16grad``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_MOMENTUM = 0.9      # flax convention: ra = 0.9 * ra + 0.1 * batch
BN_EPS = 1e-5


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


def cast(t: Optional[torch.Tensor], dtype: Optional[torch.dtype]) -> Optional[torch.Tensor]:
    """An f32 master parameter in the compute dtype (None = f32)."""
    return None if t is None else t.to(dtype or torch.float32)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., i) @ (i, o) with an f32 result. Operands of one dtype; a bf16
    product accumulates in f32 without rounding its result to bf16. On
    the CPU, which has no bf16 x bf16 -> f32 kernel, the operands are
    upcast: bf16 values and their pairwise products are exact in f32."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    a2 = a.reshape(-1, a.shape[-1])
    if a.is_cuda:
        y = torch.mm(a2, b, out_dtype=torch.float32)
    else:
        y = torch.mm(a2.float(), b.float())
    return y.reshape(*a.shape[:-1], b.shape[-1])


class DenseMatmulBF16Grad(torch.autograd.Function):
    """``x @ w`` with an f32 result whose backward quantises the
    cotangent to x's dtype before both transposed products (port of
    ``grafp_tpu.models.layers.dense_matmul_bf16grad``): the forward keeps
    the f32 accumulator, the backward runs on bf16 operands. In f32 both
    casts are no-ops."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        return _mm_f32(x, w)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w = ctx.saved_tensors
        gq = g.to(x.dtype)
        dx = _mm_f32(gq, w.t()).to(x.dtype)
        dw = _mm_f32(x.reshape(-1, x.shape[-1]).t(),
                     gq.reshape(-1, gq.shape[-1])).to(w.dtype)
        return dx, dw


def dense_matmul_bf16grad(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return DenseMatmulBF16Grad.apply(x, w)


class PointwiseConv(nn.Module):
    """1x1 conv over node tensors == a linear layer on the channel axis.
    ``weight`` is (out, in), as nn.Linear."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = (nn.Parameter(torch.empty(out_features)) if bias else None)

    def init_weights(self, g: torch.Generator) -> None:
        torch_default_init(self.weight, self.bias, self.weight.shape[1], g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(cast(x, self.dtype), cast(self.weight, self.dtype),
                        cast(self.bias, self.dtype))


def grouped_as_concat_dense(w: torch.Tensor, c_in: int, c_out: int) -> torch.Tensor:
    """(g, cig, cog) grouped weights over an INTERLEAVED input layout ->
    dense (c_in, c_out) weight for the same map on the CONCAT layout
    [a || b] (copy of ``grafp_tpu.models.layers.grouped_as_concat_dense``).
    Row p is row interleave(p) of the block-diagonal expansion; entries off
    the blocks are exact zeros. Differentiable in ``w``."""
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
    concat layout [x || rel - x] that the MRConv kernel emits, as one
    dense matmul with an f32 result plus the f32 bias. The parameters
    keep the reference's grouped (g, cig, cog) layout over the
    interleaved channels; the dense weight is rebuilt from them on every
    forward, so gradients reach them and it never goes stale."""

    def __init__(self, in_features: int, out_features: int, groups: int = 4,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if in_features % groups or out_features % groups:
            raise ValueError((in_features, out_features, groups))
        self.dtype = dtype
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(torch.empty(
            groups, in_features // groups, out_features // groups))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def init_weights(self, g: torch.Generator) -> None:
        # kaiming_normal over the torch fan_in (c_in / groups)
        normal_(self.weight, math.sqrt(2.0 / self.weight.shape[1]), g)
        with torch.no_grad():
            self.bias.zero_()

    def dense_weight(self) -> torch.Tensor:
        """The (in, out) weight on the concat layout, in the compute dtype."""
        return cast(grouped_as_concat_dense(
            self.weight, self.in_features, self.out_features), self.dtype)

    def freeze(self) -> None:
        """Keep the dense weight as a buffer (moved by ``.to``, not saved)
        for a serving copy whose parameters no longer change
        (``models/fold_bn.py``)."""
        with torch.no_grad():
            self.register_buffer("frozen_dense", self.dense_weight().detach().clone(),
                                 persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self._buffers.get("frozen_dense")
        if w is None:
            w = self.dense_weight()
        return dense_matmul_bf16grad(cast(x, self.dtype), w) + self.bias


class BatchNorm(nn.Module):
    """BatchNorm over the last (channel) axis with flax's semantics, eps
    1e-5, in f32, emitted in ``dtype`` (f32 when None).

    Training: statistics of this batch over every axis but the last,
    mean and the fast variance E[x^2] - E[x]^2 clipped at 0; the running
    statistics take ``0.9 * running + 0.1 * batch`` with the BIASED batch
    variance (torch's F.batch_norm would store the unbiased one). Eval:
    the running statistics."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mean = x32.mean(axes)
            var = torch.clamp((x32 * x32).mean(axes) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.copy_(BN_MOMENTUM * self.running_mean
                                        + (1 - BN_MOMENTUM) * mean)
                self.running_var.copy_(BN_MOMENTUM * self.running_var
                                       + (1 - BN_MOMENTUM) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        y = (x32 - mean) * mul + self.bias
        return y.to(self.dtype) if self.dtype else y

    def affine(self):
        """The eval-mode map as an affine, BN(x) == x * s + t, f32, from the
        live parameters and running statistics on every call
        (``grafp_tpu.models.layers._BNParamsCore``, operation for
        operation)."""
        s = self.weight * torch.rsqrt(self.running_var + BN_EPS)
        return s, self.bias - self.running_mean * s


def init_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every submodule that defines ``init_weights(g)``, in
    module order, from one generator."""
    for m in model.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(generator)
    return model
