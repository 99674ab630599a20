"""Shared building blocks on channels-last (B, N, C) node tensors (port of
``grafp_tpu.models.layers``).

Dtype rule, as flax applies it with ``param_dtype=float32`` and
``dtype=bfloat16``: every parameter is an f32 master copy that a layer
casts to the compute dtype at use, so gradients and optimizer updates
land on f32 values; a dense layer computes in the compute dtype; a
BatchNorm keeps f32 statistics and parameters, normalises in f32 and
emits the compute dtype. The grouped MRConv conv keeps its f32
accumulator (``dense_matmul_bf16grad``).

int8 serving (``quant``, eval only; ``grafp_tpu/models/layers.py:73-337``):
a pointwise or grouped conv built with ``quant`` 'dynamic' or 'static'
quantises its input with one scale for the whole tensor (max |x| / 127,
per call, or from the calibrated ``amax`` buffer), its weight with one
scale per output channel, multiplies on ``torch._int_mm`` (int32 result,
exact), dequantises in f32 and casts to the compute dtype BEFORE the bias,
as the JAX package does; 'calibrate' runs the exact product and raises
``amax`` to the running max |x|. The int8 product is a library call, as
XLA's int8 ``dot_general`` is in the JAX package: neither is a Pallas
kernel.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Iterator, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from grafp_tpu_torch.parallel import distributed

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


def conv2d(x: torch.Tensor, conv: nn.Conv2d, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``conv`` (f32 master weights) as flax's ``nn.Conv(dtype=dtype)``
    computes it: input and weight cast to the compute dtype, the product
    returned in it, then the bias added in it. On the CPU a bf16 product
    runs as an f32 convolution of the bf16 values, rounded once (bf16
    products are exact in f32): PyTorch 2.13's CPU bf16 convolution
    returned NaN at random for NAFP's stage-4 shape."""
    x, w, b = cast(x, dtype), cast(conv.weight, dtype), cast(conv.bias, dtype)
    if x.dtype == torch.float32 or x.is_cuda:
        return F.conv2d(x, w, b, stride=conv.stride, padding=conv.padding)
    y = F.conv2d(x.float(), w.float(), None, stride=conv.stride,
                 padding=conv.padding).to(x.dtype)
    return y if b is None else y + b[:, None, None]


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


# --- int8 serving ----------------------------------------------------------

QUANT_MODES = ("dynamic", "static", "calibrate")


def quant_mode(quant) -> Optional[str]:
    """The ``quant`` knob normalised (``grafp_tpu/models/layers.py:157``):
    False/None -> None (the plain product), True -> 'dynamic', else one of
    'dynamic' | 'static' | 'calibrate'."""
    if not quant:
        return None
    if quant is True:
        return "dynamic"
    if str(quant) not in QUANT_MODES:
        raise ValueError(f"quant mode must be dynamic|static|calibrate, got {quant!r}")
    return str(quant)


def _by_127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 rounded once, as XLA divides: by a tensor on t's device. On
    a CUDA tensor PyTorch divides by a Python number through its
    reciprocal, which can land one f32 ulp away."""
    return t / torch.full((), 127.0, device=t.device)


def quantize_weight(w_oi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, in) f32 weight -> ((out, in) int8, (out,) f32 scales): one
    symmetric scale per output channel, max(max |w|, 1e-8) / 127, and
    round half to even (``_int8_matmul_core``, ``layers.py:73-87``)."""
    w = w_oi.detach().to(torch.float32)
    sw = _by_127(torch.clamp(w.abs().amax(dim=1), min=1e-8))
    return torch.round(w / sw[:, None]).to(torch.int8), sw


def _check_int_mm(rows: int, k: int, n: int) -> None:
    """torch._int_mm on a CUDA tensor takes more than 16 rows and inner and
    output widths that are multiples of 8; raise a clear error where a
    layer breaks that, rather than reach cuBLAS."""
    if rows <= 16 or k % 8 or n % 8:
        raise ValueError(
            f"int8 product of {rows} rows x {k} -> {n} channels: torch._int_mm on "
            "the card needs more than 16 rows and inner and output widths that "
            "are multiples of 8")


def int8_matmul(x: torch.Tensor, qw: torch.Tensor, sw: torch.Tensor,
                sx: torch.Tensor) -> torch.Tensor:
    """``x @ w`` on the int8 path, f32 result (``_int8_matmul_core``): x
    (..., in) quantised by the scalar scale ``sx`` (round half to even,
    clipped to +-127), the product of int8 x and ``qw`` (out, in) int8 on
    ``torch._int_mm`` in int32, then int32 -> f32 times (sx * sw)."""
    x2 = x.reshape(-1, x.shape[-1])
    if x2.is_cuda:
        _check_int_mm(x2.shape[0], x2.shape[1], qw.shape[0])
    qx = x2.to(torch.float32, copy=True).div_(sx).round_().clamp_(-127.0, 127.0)
    y = torch._int_mm(qx.to(torch.int8), qw.t())
    # int32 x f32 -> f32 in one pass: each int32 converted, then multiplied
    return torch.mul(y, sx * sw).reshape(*x.shape[:-1], qw.shape[0])


class _Int8Linear(nn.Module):
    """The int8 serving branch shared by ``PointwiseConv`` and
    ``GroupedPointwiseConv`` (``_QuantDenseCore``, ``layers.py:172-215``).
    A layer built with quant 'static' or 'calibrate' holds ``amax``, the
    calibrated activation max (f32 scalar buffer, 0 until calibrated). It is
    saved with the layer's state_dict, and a state_dict without it (a plain
    checkpoint) loads and leaves it as it is."""

    def _init_quant(self, quant) -> None:
        self.quant = quant_mode(quant)
        if self.quant in ("static", "calibrate"):
            self.register_buffer("amax", torch.zeros(()))

    def _load_from_state_dict(self, state_dict, prefix, local_metadata, strict,
                              missing_keys, unexpected_keys, error_msgs):
        super()._load_from_state_dict(state_dict, prefix, local_metadata, strict,
                                      missing_keys, unexpected_keys, error_msgs)
        if prefix + "amax" in missing_keys:
            missing_keys.remove(prefix + "amax")

    def dense_io(self) -> torch.Tensor:
        """The layer's f32 (in, out) weight."""
        raise NotImplementedError

    def freeze_int8(self) -> None:
        """Keep the quantised weight and its scales as buffers (moved by
        ``.to``, not saved) for a serving copy whose parameters no longer
        change (``models/fold_bn.py``)."""
        with torch.no_grad():
            qw, sw = quantize_weight(self.dense_io().t())
        self.register_buffer("frozen_qw", qw.contiguous(), persistent=False)
        self.register_buffer("frozen_sw", sw, persistent=False)

    def _quant_forward(self, x: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        dt = self.dtype or x.dtype
        if self.quant == "calibrate":
            y = _mm_f32(x.to(dt), self.dense_io().to(dt)).to(dt)
            with torch.no_grad():
                self.amax.copy_(torch.maximum(self.amax, x.abs().amax().to(torch.float32)))
        else:
            qw = self._buffers.get("frozen_qw")
            if qw is None:
                qw, sw = quantize_weight(self.dense_io().t())
            else:
                sw = self.frozen_sw
            if self.quant == "dynamic":
                lo, hi = torch.aminmax(x)                  # max |x| in one pass
                sx = _by_127(torch.clamp(torch.maximum(-lo, hi), min=1e-8).to(torch.float32))
            else:
                sx = _by_127(torch.clamp(self.amax, min=1e-8))
            y = int8_matmul(x, qw, sw, sx).to(dt)
        return y if bias is None else y + bias.to(dt)


class PointwiseConv(_Int8Linear):
    """1x1 conv over node tensors == a linear layer on the channel axis.
    ``weight`` is (out, in), as nn.Linear. ``quant`` (eval only): None, or
    'dynamic' | 'static' | 'calibrate' (``quant_mode``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None, quant=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = (nn.Parameter(torch.empty(out_features)) if bias else None)
        self._init_quant(quant)

    def init_weights(self, g: torch.Generator) -> None:
        torch_default_init(self.weight, self.bias, self.weight.shape[1], g)

    def dense_io(self) -> torch.Tensor:
        return self.weight.t()

    def freeze(self) -> None:
        if self.quant in ("dynamic", "static"):
            self.freeze_int8()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant:
            return self._quant_forward(x, self.bias)
        return F.linear(cast(x, self.dtype), cast(self.weight, self.dtype),
                        cast(self.bias, self.dtype))


def grouped_as_blockdiag_dense(w: torch.Tensor, c_in: int, c_out: int) -> torch.Tensor:
    """(g, cig, cog) grouped weights -> the block-diagonal dense (c_in,
    c_out) weight over the grouped conv's own consecutive-block channel
    layout (``grafp_tpu.models.layers._grouped_as_blockdiag_dense``);
    entries off the blocks are exact zeros. Differentiable in ``w``."""
    g, cig, cog = w.shape
    bd = w.new_zeros((g, cig, g, cog))
    idx = torch.arange(g, device=w.device)
    bd[idx, :, idx, :] = w
    return bd.reshape(c_in, c_out)


def grouped_as_concat_dense(w: torch.Tensor, c_in: int, c_out: int) -> torch.Tensor:
    """(g, cig, cog) grouped weights over an INTERLEAVED input layout ->
    dense (c_in, c_out) weight for the same map on the CONCAT layout
    [a || b] (copy of ``grafp_tpu.models.layers.grouped_as_concat_dense``).
    Row p is row interleave(p) of the block-diagonal expansion; entries off
    the blocks are exact zeros. Differentiable in ``w``."""
    bd = grouped_as_blockdiag_dense(w, c_in, c_out)   # rows: interleaved order
    half = c_in // 2
    ar = torch.arange(half, device=w.device)
    return bd[torch.cat([2 * ar, 2 * ar + 1])]


class GroupedPointwiseConv(_Int8Linear):
    """Grouped 1x1 conv (reference BasicConv, groups=4) with an f32 result
    plus the f32 bias. With ``concat_interleaved`` (the MRConv kernel
    path's form) it is one dense matmul on the concat layout [x || rel - x]
    that the MRConv kernel emits, the reference's channel interleave
    absorbed in the dense weight's rows, rebuilt from the grouped weight on
    every forward so that gradients reach it and it never goes stale.
    Without it (the pair-layout MRConv, EdgeConv, SAGE, GIN) it is the
    grouped product on the conv's own consecutive-block channel layout,
    computed as the JAX package computes it off the TPU: operands in the
    compute dtype, multiplied and summed in f32, the cotangent kept in f32
    (``grafp_tpu/models/layers.py:347-360``). The parameters keep the
    reference's grouped (g, cig, cog) layout.

    ``quant`` (eval only, ``quant_mode``): the int8 product of the same
    dense weight (its off-block zeros quantise to 0, so the per-output
    scales are the grouped ones), cast to the compute dtype before the
    bias (``grafp_tpu/models/layers.py:297-336``); the plain path keeps
    the f32 accumulator and bias."""

    def __init__(self, in_features: int, out_features: int, groups: int = 4,
                 dtype: Optional[torch.dtype] = None, quant=None,
                 concat_interleaved: bool = True):
        super().__init__()
        if in_features % groups or out_features % groups:
            raise ValueError((in_features, out_features, groups))
        self.dtype = dtype
        self.in_features, self.out_features = in_features, out_features
        self.concat_interleaved = concat_interleaved
        self.weight = nn.Parameter(torch.empty(
            groups, in_features // groups, out_features // groups))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self._init_quant(quant)

    def init_weights(self, g: torch.Generator) -> None:
        # kaiming_normal over the torch fan_in (c_in / groups)
        normal_(self.weight, math.sqrt(2.0 / self.weight.shape[1]), g)
        with torch.no_grad():
            self.bias.zero_()

    def dense_io(self) -> torch.Tensor:
        """The f32 (in, out) dense weight on the input's channel layout."""
        dense = (grouped_as_concat_dense if self.concat_interleaved
                 else grouped_as_blockdiag_dense)
        return dense(self.weight, self.in_features, self.out_features)

    def dense_weight(self) -> torch.Tensor:
        """The (in, out) dense weight in the compute dtype."""
        return cast(self.dense_io(), self.dtype)

    def freeze(self) -> None:
        """Keep the weight the forward would rebuild (the concat layout's
        dense weight in the compute dtype, or under int8 the quantised
        weight and its scales) as buffers (moved by ``.to``, not saved), for
        a serving copy whose parameters no longer change
        (``models/fold_bn.py``)."""
        if self.quant in ("dynamic", "static"):
            self.freeze_int8()
        elif self.concat_interleaved:
            with torch.no_grad():
                self.register_buffer("frozen_dense", self.dense_weight().detach().clone(),
                                     persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant:
            return self._quant_forward(x, self.bias)
        if not self.concat_interleaved:
            g, cig, cog = self.weight.shape
            xg = cast(x, self.dtype).reshape(*x.shape[:-1], g, cig)
            y = torch.einsum("...gi,gio->...go", xg.float(),
                             cast(self.weight, self.dtype).float())
            return y.reshape(*x.shape[:-1], g * cog) + self.bias
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
    variance (torch's F.batch_norm would store the unbiased one), unless
    ``update_stats`` is off (``frozen_statistics``). Eval: the running
    statistics.

    Under a process group (data-parallel training) the statistics are
    those of the global batch, as GSPMD computes them for the JAX
    package's global-batch step: the f32 sums of x and x^2 are summed over
    the ranks (differentiably) and divided by the global count, so the
    running statistics stay equal on every rank. ``Config.bn_cross_replica``
    changes nothing: the JAX CLI builds its model without an axis name,
    so its statistics are global either way."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.update_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        if self.training:
            axes = tuple(range(x.dim() - 1))
            if distributed.group_active():
                count = x32.numel() // x32.shape[-1] * distributed.world_size()
                sums = distributed.all_reduce_sum(
                    torch.stack([x32.sum(axes), (x32 * x32).sum(axes)]))
                mean, mean_sq = sums[0] / count, sums[1] / count
            else:
                mean, mean_sq = x32.mean(axes), (x32 * x32).mean(axes)
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            if self.update_stats:
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


@contextlib.contextmanager
def frozen_statistics(module: nn.Module) -> Iterator[None]:
    """Inside: the train-mode BatchNorms of ``module`` normalise with the
    batch's statistics but leave their running statistics alone. The
    recompute of a rematerialised block runs in it, so that a step updates
    them once, as flax discards the recompute's mutation (``nn.remat``)."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.update_stats = False
    try:
        yield
    finally:
        for bn in bns:
            bn.update_stats = True


class DropPath(nn.Module):
    """Per-sample stochastic depth (``grafp_tpu/models/layers.py:482-498``):
    the identity in eval or at rate 0; in train each sample is kept with
    probability keep = 1 - rate, as x / keep, and zeroed otherwise. The
    mask is drawn from ``generator``, the train step's own, which
    ``drop_path_generator`` sets for one forward (the JAX step hands its key
    to the model as ``rngs={"droppath": key}``), never from the global
    generator: a train-mode draw without one raises. Under data-parallel
    training ``global_rows`` = (n, rows) makes each draw one for the n rows
    of the global batch, of which this rank keeps ``rows``, so that every
    rank's masks are those that one process would draw."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None
        self.global_rows: Optional[Tuple[int, torch.Tensor]] = None

    def mask(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """The (B, 1, ..., 1) bool keep mask for x, one uniform draw per
        sample below keep; None where the path is the identity."""
        if not self.training or self.rate == 0.0:
            return None
        if self.generator is None:
            raise RuntimeError("DropPath in train mode draws from the train step's "
                               "generator: run the forward inside drop_path_generator")
        n = x.shape[0] if self.global_rows is None else self.global_rows[0]
        u = torch.rand((n,), generator=self.generator, device=self.generator.device)
        if self.global_rows is not None:
            u = u[self.global_rows[1]]
        return (u < 1.0 - self.rate).to(x.device).reshape((-1,) + (1,) * (x.dim() - 1))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x with the samples of ``mask`` (drawn here when None) kept as x /
        keep; keep is rounded to x's dtype first, as JAX's weakly typed
        Python float is, and divides as a device tensor (``_by_127``)."""
        if mask is None:
            mask = self.mask(x)
        if mask is None:
            return x
        keep = torch.full((), 1.0 - self.rate, dtype=x.dtype, device=x.device)
        return torch.where(mask, x / keep, torch.zeros_like(x))


@contextlib.contextmanager
def drop_path_generator(model: nn.Module, generator: torch.Generator,
                        global_rows: Optional[Tuple[int, torch.Tensor]] = None
                        ) -> Iterator[None]:
    """Inside: every DropPath of ``model`` draws its masks from
    ``generator`` (the train step's forward runs in it), for the global
    batch's rows when ``global_rows`` = (n, this rank's rows) is given."""
    paths = [m for m in model.modules() if isinstance(m, DropPath)]
    for m in paths:
        m.generator, m.global_rows = generator, global_rows
    try:
        yield
    finally:
        for m in paths:
            m.generator, m.global_rows = None, None


def init_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every submodule that defines ``init_weights(g)``, in
    module order, from one generator."""
    for m in model.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(generator)
    return model
