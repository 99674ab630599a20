"""One eval-mode Grapher block as one fused op: x (B, N, C) -> (B, N, C).

Port of ``grafp_tpu/ops/pallas_knn.py:grapher_block_pallas`` and its
guard ``grapher_block_supported``. With the three BatchNorms folded into
the linears before them (``models/gnn.py:Grapher`` folds them), the block
is, rounding to x's dtype dt where ``_grapher_kernel`` does:

    x1  = (x . w1 + c1) -> dt
    cat = [x1 || rel(x1) -> dt - x1]     (``ops/mrconv_concat.py``)
    g   = relu(cat . wg + cg) -> dt
    out = (g . w2 + c2 + x) -> dt        (residual added in f32)

w1 (C, C), wg (2C, 2C) (dense, concat layout), w2 (2C, C) in dt; c1 (1, C),
cg (1, 2C), c2 (1, C) in f32. Every product accumulates in f32.

Here live the guard, the plain PyTorch version ``grapher_block_reference``,
the wrapper ``grapher_block``, which launches the CUDA kernel in
``csrc/grapher_block.cu`` for a CUDA tensor, with its launch count
``.launches``, and ``GrapherBlock``, its autograd function, whose backward
raises: training uses the unfused path.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from grafp_tpu_torch.ops.build import load_library
from grafp_tpu_torch.ops.mrconv_concat import (
    _DTYPE_CODE,
    _check_kernel_input,
    _ptr,
    _raise_on,
    _workspace,
    mrconv_concat_reference,
)

# --- the guard, copied from pallas_knn.py:65-85,542-568 -------------------
# It sizes the Pallas kernel's VMEM working set. The port keeps the same
# predicate so that the same blocks fuse as in the JAX package.
_MAX_TILE_BF16 = 1024
_MAX_TILE_F32 = 512
_GRAPHER_VMEM_GUARD = 21 * (1 << 20)


def _tile_rows(n: int, dtype: torch.dtype) -> int:
    cap = _MAX_TILE_BF16 if dtype == torch.bfloat16 else _MAX_TILE_F32
    t = min(n, cap)
    while n % t:
        t //= 2
    return t


def _grapher_vmem_estimate(n: int, c: int, k: int, dtype: torch.dtype):
    ms = 2 if dtype == torch.bfloat16 else 4
    per = 4 * n * n + k * ms * n * n + (4 * k + 24) * n * c * 4
    w_bytes = 7 * c * c * ms + 16 * c
    return per, w_bytes


def grapher_block_supported(n: int, c: int, dtype: torch.dtype, k: int = 3) -> bool:
    """Whether the fused block takes (N, C, dtype, k): one row tile per item
    and one item's working set plus the 7 C^2 weights inside the JAX
    package's calibrated VMEM envelope."""
    per, w_bytes = _grapher_vmem_estimate(n, c, k, dtype)
    return _tile_rows(n, dtype) == n and per + w_bytes <= _GRAPHER_VMEM_GUARD


# --- the block --------------------------------------------------------------

def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, O) accumulated in f32: bf16 values and their products
    are exact in f32, so this equals a bf16 product with f32 accumulation
    up to summation order."""
    return torch.matmul(a.to(torch.float32), w.to(torch.float32))


def grapher_block_reference(x: torch.Tensor, k: int, w1, c1, wg, cg, w2,
                            c2) -> torch.Tensor:
    """Plain PyTorch version of the kernel (``pallas_knn.py:_grapher_kernel``)."""
    b, n, c = x.shape
    dt = x.dtype
    xf = x.reshape(b * n, c)
    x1 = (_mm(xf, w1) + c1).to(dt)
    cat = mrconv_concat_reference(x1.reshape(b, n, c), k).reshape(b * n, 2 * c)
    g = torch.relu(_mm(cat, wg) + cg).to(dt)
    y = _mm(g, w2) + c2
    return (y + xf.to(torch.float32)).to(dt).reshape(b, n, c)


def _check_weights(x: torch.Tensor, ws) -> None:
    c = x.shape[-1]
    shapes = ((c, c), (1, c), (2 * c, 2 * c), (1, 2 * c), (2 * c, c), (1, c))
    for i, (w, shape) in enumerate(zip(ws, shapes)):
        dtype = x.dtype if i % 2 == 0 else torch.float32
        if (tuple(w.shape) != shape or w.dtype != dtype or w.device != x.device
                or not w.is_contiguous()):
            raise ValueError(
                f"grapher_block: weight {i} is {tuple(w.shape)} {w.dtype} on "
                f"{w.device}, want contiguous {shape} {dtype} on {x.device}")


def grapher_block(x: torch.Tensor, k: int, w1, c1, wg, cg, w2, c2) -> torch.Tensor:
    """One eval-mode Grapher block on folded weights, x (B, N, C) f32 or
    bf16.

    Raises ValueError for a shape ``grapher_block_supported`` refuses. A
    CPU tensor goes through ``grapher_block_reference``. A CUDA tensor
    launches the kernel on the current stream, or raises: there is no
    fallback."""
    if x.dim() != 3 or not grapher_block_supported(x.shape[1], x.shape[2], x.dtype, k):
        raise ValueError(f"grapher_block: shape {tuple(x.shape)} {x.dtype} with "
                         f"k={k} is outside grapher_block_supported")
    if x.device.type == "cpu":
        return grapher_block_reference(x, k, w1, c1, wg, cg, w2, c2)
    if x.device.type != "cuda":
        raise ValueError(f"grapher_block: unsupported device {x.device}")
    _check_kernel_input(x, k, "grapher_block")
    ws = (w1, c1, wg, cg, w2, c2)
    _check_weights(x, ws)
    b, n, c = x.shape
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    # Scratch for the arrays that make a round trip through device memory
    # between the kernel's five launches (csrc/grapher_block.cu): x1 and its
    # keys (B, N, C), the concat and g (B, N, 2C). In bf16 the product
    # launches are bound by these bytes (the grouped conv at C = 512 by
    # operations); they stay because the selection needs all of an item's
    # x1 before it starts.
    x1, xn = torch.empty_like(x), torch.empty_like(x)
    cat = torch.empty((b, n, 2 * c), dtype=x.dtype, device=x.device)
    gbuf = torch.empty_like(cat)
    lib = _kernel_lib()
    # the selection's workspace at k > 8 (round groups)
    work = _workspace(lib.grapher_block_workspace, x, k)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.grapher_block_forward(
            x.data_ptr(), *(w.data_ptr() for w in ws), x1.data_ptr(), xn.data_ptr(),
            cat.data_ptr(), gbuf.data_ptr(), out.data_ptr(), _ptr(work), b, n, c, k,
            _DTYPE_CODE[x.dtype], stream)
    _raise_on(lib.grapher_block_error, err, "grapher_block")
    grapher_block.launches += 1
    return out


grapher_block.launches = 0


class GrapherBlock(torch.autograd.Function):
    """``grapher_block`` with no gradient, as the Pallas kernel has no VJP:
    differentiating through it raises (training uses the unfused path)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, k: int, *weights: torch.Tensor) -> torch.Tensor:
        return grapher_block(x, k, *weights)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        raise RuntimeError("grapher_block has no gradient: train with the "
                           "unfused Grapher (train mode never fuses)")


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = load_library("grapher_block")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.grapher_block_workspace.argtypes = [i32] * 5
    lib.grapher_block_workspace.restype = ctypes.c_longlong
    lib.grapher_block_forward.argtypes = [ptr] * 13 + [i32] * 5 + [ptr]
    lib.grapher_block_forward.restype = i32
    lib.grapher_block_error.argtypes = [i32]
    lib.grapher_block_error.restype = ctypes.c_char_p
    return lib
