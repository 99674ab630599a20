"""Fused MRConv frontend: x (B, N, C) -> [x || rel(x) - x] (B, N, 2C),
and its gradient.

Port of ``grafp_tpu/ops/pallas_knn.py:mrconv_concat_pallas`` (forward
and custom-VJP backward). rel is the max over each row's k most similar
nodes (cosine similarity, self included) of their features, with the
reference's selection rule:

* rows and keys are L2-normalised in f32 (eps 1e-12), then cast to the
  matmul dtype (bf16 when x is bf16) before a dot accumulated in f32;
* k threshold rounds on the immutable score matrix: round r takes the
  whole tie group {s : s >= rowmax_r, s < rowmax_{r-1}} and extracts the
  MEAN of its rows' features;
* a row stops once k columns are consumed, so a large tie group ends it;
* rel - x is formed in x's dtype.

The gradient (``_concat_backward``/``_one_backward``): selection takes no
gradient; the cotangent g = [g_x || g_rel] gives
dx = g_x - g_rel + sum_r mask_r^T G_r, where G_r = g_rel on the
(row, channel) pairs whose running max round r won (the first active
round whose mean equals it), divided by the round's count and rounded to
the matmul dtype; the sum accumulates in f32 and dx is cast to x's dtype.

Here live the plain PyTorch versions ``mrconv_concat_reference`` and
``mrconv_concat_backward_reference`` (transcriptions of the Pallas
kernels' arithmetic, used on the CPU and as the yardstick on the card);
the wrappers ``mrconv_concat`` and ``mrconv_concat_backward``, which
launch the CUDA kernels in ``csrc/mrconv_concat.cu`` for a CUDA tensor,
with their launch counts ``.launches``; and ``MRConvConcat``, the
autograd function that joins the two.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from grafp_tpu_torch.ops.build import load_library

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _mm_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.bfloat16 if dtype == torch.bfloat16 else torch.float32


def _norm_rows_f32(x: torch.Tensor) -> torch.Tensor:
    x32 = x.to(torch.float32)
    n = torch.sqrt(torch.sum(x32 * x32, dim=-1, keepdim=True))
    return x32 / torch.clamp(n, min=1e-12)


def _check_nk(n: int, k: int) -> None:
    if n < k:
        # the threshold rounds assume a row never runs out of columns with
        # budget left (pallas_knn.py:_pallas_forward)
        raise ValueError(f"the k-NN selection requires N >= k (got N={n}, k={k})")


def _select_rounds(scores: torch.Tensor, k: int):
    """k rounds on an immutable (..., T, N) score matrix: round r's tie
    group is {s : s >= rowmax_r and s < rowmax_{r-1}}. Returns the 0/1
    masks (f32) and the f32 tie counts (floored at 1)."""
    thresh = torch.full(scores.shape[:-1] + (1,), float("inf"),
                        dtype=torch.float32, device=scores.device)
    neg = torch.tensor(float("-inf"), device=scores.device)
    masks, cnts = [], []
    for _ in range(k):
        live = scores < thresh
        rowmax = torch.amax(torch.where(live, scores, neg), dim=-1,
                            keepdim=True)
        mask = live & (scores >= rowmax)
        masks.append(mask.to(torch.float32))
        cnts.append(torch.clamp(masks[-1].sum(dim=-1, keepdim=True), min=1.0))
        thresh = rowmax
    return masks, cnts


def _replay(x: torch.Tensor, k: int, xn: Optional[torch.Tensor] = None):
    """The forward's arithmetic on (B, N, C) x: the k rounds' 0/1 masks
    (B, N, N) and counts, the per-round means (feats), which rows each
    round is active for, and rel, the running max over active rounds.

    The keys ``xn`` default to this kernel's: rows normalised in f32 and
    cast to the matmul dtype. ``ops/max_neighbors.py`` passes its own.

    Materialises the (B, N, N) f32 scores and k masks. Matmul-dtype values
    are carried in f32 for the products: bf16 values and their pairwise
    products are exact in f32, so this equals a bf16 matmul with f32
    accumulation up to summation order."""
    b, n, c = x.shape
    _check_nk(n, k)
    mm = _mm_dtype(x.dtype)
    if xn is None:
        xn = _norm_rows_f32(x).to(mm)
    xn = xn.to(mm).to(torch.float32)
    xmm = x.to(mm).to(torch.float32)
    scores = torch.matmul(xn, xn.transpose(-1, -2))        # (B, N, N) f32
    masks, cnts = _select_rounds(scores, k)
    rel = torch.full((b, n, c), float("-inf"), dtype=torch.float32,
                     device=x.device)
    consumed = torch.zeros((b, n, 1), dtype=torch.float32, device=x.device)
    feats, actives = [], []
    for mask, cnt in zip(masks, cnts):
        feats.append(torch.matmul(mask, xmm) / cnt)
        # rows whose k budget earlier tie groups consumed take no more
        actives.append(consumed < k)
        rel = torch.where(actives[-1], torch.maximum(rel, feats[-1]), rel)
        consumed = consumed + cnt
    return masks, cnts, feats, actives, rel


def _scatter(x: torch.Tensor, g_rel: torch.Tensor, k: int,
             xn: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The backward's scatter, in f32: replays the selection on the keys
    ``xn`` (as ``_replay``), picks each (row, channel)'s winning round (the
    first active round whose mean equals the running max), rounds
    G_r = where(win, g_rel, 0) / cnt_r to the matmul dtype, and sums
    mask_r^T G_r over all rounds through one transposed product
    (``pallas_knn.py:_one_backward``)."""
    masks, cnts, feats, actives, rel = _replay(x, k, xn)
    g_rel = g_rel.to(torch.float32)
    mm = _mm_dtype(x.dtype)
    claimed = torch.zeros_like(rel, dtype=torch.bool)
    grs = []
    for feat, active, cnt in zip(feats, actives, cnts):
        win = active & (feat == rel) & ~claimed
        claimed = claimed | win
        grs.append((torch.where(win, g_rel, 0.0) / cnt).to(mm).to(torch.float32))
    mstack = torch.cat(masks, dim=1)                       # (B, k*N, N)
    return torch.matmul(mstack.transpose(1, 2), torch.cat(grs, dim=1))


def mrconv_concat_reference(x: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, N, C) -> (B, N, 2C)."""
    rel = _replay(x, k)[-1]
    return torch.cat([x, rel.to(x.dtype) - x], dim=-1)


def mrconv_concat_backward_reference(x: torch.Tensor, g: torch.Tensor,
                                     k: int) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel: x (B, N, C) and the
    cotangent g (B, N, 2C) of [x || rel - x] -> dx (B, N, C) in x's dtype.

    The scatter of ``_scatter`` plus the direct term g_x - g_rel, cast to
    x's dtype (``pallas_knn.py:_concat_bwd_kernel``)."""
    b, n, c = x.shape
    if g.shape != (b, n, 2 * c):
        raise ValueError(f"mrconv_concat_backward: g {tuple(g.shape)} for x "
                         f"{tuple(x.shape)}")
    g32 = g.to(torch.float32)
    g_x, g_rel = g32[..., :c], g32[..., c:]
    return (_scatter(x, g_rel, k) + (g_x - g_rel)).to(x.dtype)


def _check_kernel_input(x: torch.Tensor, k: int, what: str) -> None:
    """Raise on what the CUDA kernels do not take."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: dtype {x.dtype} (float32 or bfloat16 only)")
    if x.dim() != 3:
        raise ValueError(f"{what}: want (B, N, C), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous")
    if k < 1:
        raise ValueError(f"{what}: k={k} below 1")
    _check_nk(x.shape[1], k)


def _workspace(size_fn, x: torch.Tensor, k: int, *backward: int) -> Optional[torch.Tensor]:
    """The selection's workspace for x (B, N, C), of the size the library's
    ``*_workspace`` gives (``csrc/mrconv_select.cuh:make_plan``), or None
    when the call needs none: shapes past k = 8 or k * N = 8192 carry
    state between round groups and bitmap windows in it."""
    b, n, c = x.shape
    nbytes = size_fn(b, n, c, k, _DTYPE_CODE[x.dtype], *backward)
    if nbytes < 0:
        raise ValueError(f"the selection kernels do not take {tuple(x.shape)} "
                         f"{x.dtype} with k={k}")
    return torch.empty(nbytes, dtype=torch.uint8, device=x.device) if nbytes else None


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _raise_on(error_fn, err: int, what: str) -> None:
    """Raise when a library's launch returned a CUDA error; ``error_fn`` is
    the library's ``*_error`` (code -> message)."""
    if err != 0:
        raise RuntimeError(f"{what} kernel failed: {error_fn(err).decode()} ({err})")


def mrconv_concat(x: torch.Tensor, k: int) -> torch.Tensor:
    """[x || rel(x) - x] for x (B, N, C), f32 or bf16.

    A CPU tensor goes through ``mrconv_concat_reference``. A CUDA tensor
    launches the kernel on the current stream, or raises: there is no
    fallback."""
    if x.device.type == "cpu":
        return mrconv_concat_reference(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"mrconv_concat: unsupported device {x.device}")
    _check_kernel_input(x, k, "mrconv_concat")
    b, n, c = x.shape
    out = torch.empty((b, n, 2 * c), dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    # the normalised rows, written by the kernel's first launch
    scratch = torch.empty_like(x)
    lib = _kernel_lib()
    work = _workspace(lib.mrconv_concat_workspace, x, k, 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mrconv_concat_forward(x.data_ptr(), scratch.data_ptr(),
                                        out.data_ptr(), _ptr(work), b, n, c, k,
                                        _DTYPE_CODE[x.dtype], stream)
    _raise_on(lib.mrconv_concat_error, err, "mrconv_concat")
    mrconv_concat.launches += 1
    return out


mrconv_concat.launches = 0


def mrconv_concat_backward(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """dx for x (B, N, C) and the cotangent g (B, N, 2C) of
    ``mrconv_concat(x, k)``, in x's dtype.

    A CPU tensor goes through ``mrconv_concat_backward_reference``. A CUDA
    tensor launches the backward kernel on the current stream, or raises.
    The kernel writes the normalised rows, the per-round cotangents
    G (B, N, k, C) in the matmul dtype and the active score levels
    (B, N, k) to scratch allocated here, with the workspace of the shapes
    that run split."""
    if x.device.type == "cpu":
        return mrconv_concat_backward_reference(x, g, k)
    if x.device.type != "cuda":
        raise ValueError(f"mrconv_concat_backward: unsupported device {x.device}")
    _check_kernel_input(x, k, "mrconv_concat_backward")
    b, n, c = x.shape
    if g.shape != (b, n, 2 * c) or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"mrconv_concat_backward: g {tuple(g.shape)} "
                         f"{g.dtype} on {g.device} for x {tuple(x.shape)} "
                         f"{x.dtype} on {x.device}")
    if not g.is_contiguous():
        raise ValueError("mrconv_concat_backward: g must be contiguous")
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    xn = torch.empty_like(x)
    grs = torch.empty((b, n, k, c), dtype=x.dtype, device=x.device)
    levels = torch.empty((b, n, k), dtype=torch.float32, device=x.device)
    lib = _kernel_lib()
    work = _workspace(lib.mrconv_concat_workspace, x, k, 1)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mrconv_concat_backward(
            x.data_ptr(), g.data_ptr(), xn.data_ptr(), grs.data_ptr(),
            levels.data_ptr(), dx.data_ptr(), _ptr(work), b, n, c, k,
            _DTYPE_CODE[x.dtype], stream)
    _raise_on(lib.mrconv_concat_error, err, "mrconv_concat_backward")
    mrconv_concat_backward.launches += 1
    return dx


mrconv_concat_backward.launches = 0


class MRConvConcat(torch.autograd.Function):
    """``mrconv_concat`` with its gradient: the forward kernel (or plain
    version) forward, the backward kernel (or plain version) backward.
    k takes no gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, k: int) -> torch.Tensor:
        ctx.k = k
        ctx.save_for_backward(x)
        return mrconv_concat(x, k)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (x,) = ctx.saved_tensors
        return mrconv_concat_backward(x, g.contiguous(), ctx.k), None


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = load_library("mrconv_concat")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mrconv_concat_workspace.argtypes = [i32] * 6
    lib.mrconv_concat_workspace.restype = ctypes.c_longlong
    lib.mrconv_concat_forward.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32,
                                          i32, i32, ptr]
    lib.mrconv_concat_forward.restype = i32
    lib.mrconv_concat_backward.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                           i32, i32, i32, i32, i32, ptr]
    lib.mrconv_concat_backward.restype = i32
    lib.mrconv_concat_error.argtypes = [i32]
    lib.mrconv_concat_error.restype = ctypes.c_char_p
    return lib
