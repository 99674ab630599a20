"""k-NN neighbour max: x (B, N, C) -> rel (B, N, C), the max over each
row's k most similar rows (cosine similarity, self included) of their
features, and its gradient.

Port of ``grafp_tpu/ops/pallas_knn.py:max_neighbors_pallas`` (forward
``_pallas_forward`` and custom-VJP backward ``_pallas_backward``). The
selection rule is that of ``ops/mrconv_concat.py`` (k threshold rounds on
immutable scores, tie groups averaged, f32 accumulation), with two
differences: the keys are ``l2_normalize(x)`` in x's dtype, computed
outside the kernel as XLA computes them outside the Pallas call, and the
output is rel itself, so the backward has no direct term.

Here live the plain PyTorch versions ``max_neighbors_reference`` and
``max_neighbors_backward_reference``; the wrappers ``max_neighbors`` and
``max_neighbors_backward``, which launch the CUDA kernels in
``csrc/max_neighbors.cu`` for a CUDA tensor, with their launch counts
``.launches``; and ``MaxNeighbors``, the autograd function that joins them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from grafp_tpu_torch.ops.build import load_library
from grafp_tpu_torch.ops.knn import l2_normalize
from grafp_tpu_torch.ops.mrconv_concat import (
    _DTYPE_CODE,
    _check_kernel_input,
    _ptr,
    _raise_on,
    _replay,
    _scatter,
    _workspace,
)


def _keys(x: torch.Tensor) -> torch.Tensor:
    """The kernel's keys: rows of x normalised in x's dtype, no gradient."""
    return l2_normalize(x.detach())


def max_neighbors_reference(x: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, N, C) -> rel (B, N, C) in
    x's dtype (``pallas_knn.py:_one_forward`` on keys ``_keys(x)``)."""
    return _replay(x, k, _keys(x))[-1].to(x.dtype)


def max_neighbors_backward_reference(x: torch.Tensor, g: torch.Tensor,
                                     k: int) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel: x and the cotangent g
    of rel, both (B, N, C) -> dx (B, N, C) in x's dtype
    (``pallas_knn.py:_one_backward``; g is rounded to the matmul dtype per
    round, the sum accumulates in f32)."""
    if g.shape != x.shape:
        raise ValueError(f"max_neighbors_backward: g {tuple(g.shape)} for x "
                         f"{tuple(x.shape)}")
    return _scatter(x, g, k, _keys(x)).to(x.dtype)


def max_neighbors(x: torch.Tensor, k: int) -> torch.Tensor:
    """rel for x (B, N, C), f32 or bf16.

    A CPU tensor goes through ``max_neighbors_reference``. A CUDA tensor
    launches the kernel on the current stream, after the keys are
    normalised here in PyTorch, or raises: there is no fallback."""
    if x.device.type == "cpu":
        return max_neighbors_reference(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"max_neighbors: unsupported device {x.device}")
    _check_kernel_input(x, k, "max_neighbors")
    b, n, c = x.shape
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    xn = _keys(x)
    lib = _kernel_lib()
    work = _workspace(lib.max_neighbors_workspace, x, k, 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.max_neighbors_forward(xn.data_ptr(), x.data_ptr(), out.data_ptr(),
                                        _ptr(work), b, n, c, k, _DTYPE_CODE[x.dtype],
                                        stream)
    _raise_on(lib.max_neighbors_error, err, "max_neighbors")
    max_neighbors.launches += 1
    return out


max_neighbors.launches = 0


def max_neighbors_backward(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """dx for x (B, N, C) and the cotangent g (B, N, C) of
    ``max_neighbors(x, k)``, in x's dtype.

    A CPU tensor goes through ``max_neighbors_backward_reference``. A CUDA
    tensor launches the backward kernel on the current stream, or raises.
    The kernel writes the per-round cotangents G (B, N, k, C) in the matmul
    dtype and the active score levels (B, N, k) to scratch allocated
    here, with the workspace of the shapes that run split."""
    if x.device.type == "cpu":
        return max_neighbors_backward_reference(x, g, k)
    if x.device.type != "cuda":
        raise ValueError(f"max_neighbors_backward: unsupported device {x.device}")
    _check_kernel_input(x, k, "max_neighbors_backward")
    b, n, c = x.shape
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"max_neighbors_backward: g {tuple(g.shape)} {g.dtype} "
                         f"on {g.device} for x {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}")
    if not g.is_contiguous():
        raise ValueError("max_neighbors_backward: g must be contiguous")
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    xn = _keys(x)
    grs = torch.empty((b, n, k, c), dtype=x.dtype, device=x.device)
    levels = torch.empty((b, n, k), dtype=torch.float32, device=x.device)
    lib = _kernel_lib()
    work = _workspace(lib.max_neighbors_workspace, x, k, 1)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.max_neighbors_backward(
            xn.data_ptr(), x.data_ptr(), g.data_ptr(), grs.data_ptr(),
            levels.data_ptr(), dx.data_ptr(), _ptr(work), b, n, c, k,
            _DTYPE_CODE[x.dtype], stream)
    _raise_on(lib.max_neighbors_error, err, "max_neighbors_backward")
    max_neighbors_backward.launches += 1
    return dx


max_neighbors_backward.launches = 0


class MaxNeighbors(torch.autograd.Function):
    """``max_neighbors`` with its gradient: the forward kernel (or plain
    version) forward, the backward kernel (or plain version) backward.
    Selection takes no gradient; k takes none."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, k: int) -> torch.Tensor:
        ctx.k = k
        ctx.save_for_backward(x)
        return max_neighbors(x, k)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (x,) = ctx.saved_tensors
        return max_neighbors_backward(x, g.contiguous(), ctx.k), None


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = load_library("max_neighbors")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.max_neighbors_workspace.argtypes = [i32] * 6
    lib.max_neighbors_workspace.restype = ctypes.c_longlong
    lib.max_neighbors_forward.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32,
                                          ptr]
    lib.max_neighbors_forward.restype = i32
    lib.max_neighbors_backward.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32,
                                           i32, i32, i32, ptr]
    lib.max_neighbors_backward.restype = i32
    lib.max_neighbors_error.argtypes = [i32]
    lib.max_neighbors_error.restype = ctypes.c_char_p
    return lib
