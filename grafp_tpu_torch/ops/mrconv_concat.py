"""Fused MRConv frontend: x (B, N, C) -> [x || rel(x) - x] (B, N, 2C).

Port of ``grafp_tpu/ops/pallas_knn.py:mrconv_concat_pallas`` (forward).
rel is the max over each row's k most similar nodes (cosine similarity,
self included) of their features, with the reference's selection rule:

* rows and keys are L2-normalised in f32 (eps 1e-12), then cast to the
  matmul dtype (bf16 when x is bf16) before a dot accumulated in f32;
* k threshold rounds on the immutable score matrix: round r takes the
  whole tie group {s : s >= rowmax_r, s < rowmax_{r-1}} and extracts the
  MEAN of its rows' features;
* a row stops once k columns are consumed, so a large tie group ends it;
* rel - x is formed in x's dtype.

Three things live here: ``mrconv_concat_reference``, the plain PyTorch
version (a transcription of the Pallas kernel's arithmetic, used on the
CPU and as the yardstick on the card); ``mrconv_concat``, the wrapper
that launches the CUDA kernel in ``csrc/mrconv_concat.cu`` for a CUDA
tensor; and the wrapper's launch count, ``mrconv_concat.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from grafp_tpu_torch.ops.build import load_library

# the kernel keeps each row's top-k score levels in registers
MAX_K = 8
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
        raise ValueError(f"mrconv_concat requires N >= k (got N={n}, k={k})")


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


def mrconv_concat_reference(x: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, N, C) -> (B, N, 2C).

    Materialises the (B, N, N) f32 scores and k masks. Matmul-dtype values
    are carried in f32 for the products: bf16 values and their pairwise
    products are exact in f32, so this equals a bf16 matmul with f32
    accumulation up to summation order."""
    b, n, c = x.shape
    _check_nk(n, k)
    mm = _mm_dtype(x.dtype)
    xn = _norm_rows_f32(x).to(mm).to(torch.float32)
    xmm = x.to(mm).to(torch.float32)
    scores = torch.matmul(xn, xn.transpose(-1, -2))        # (B, N, N) f32
    masks, cnts = _select_rounds(scores, k)
    rel = torch.full((b, n, c), float("-inf"), dtype=torch.float32,
                     device=x.device)
    consumed = torch.zeros((b, n, 1), dtype=torch.float32, device=x.device)
    for mask, cnt in zip(masks, cnts):
        feat = torch.matmul(mask, xmm) / cnt
        # rows whose k budget earlier tie groups consumed take no more
        active = consumed < k
        rel = torch.where(active, torch.maximum(rel, feat), rel)
        consumed = consumed + cnt
    return torch.cat([x, rel.to(x.dtype) - x], dim=-1)


def mrconv_concat(x: torch.Tensor, k: int) -> torch.Tensor:
    """[x || rel(x) - x] for x (B, N, C), f32 or bf16.

    A CPU tensor goes through ``mrconv_concat_reference``. A CUDA tensor
    launches the kernel on the current stream, or raises: there is no
    fallback."""
    if x.device.type == "cpu":
        return mrconv_concat_reference(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"mrconv_concat: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"mrconv_concat: dtype {x.dtype} (float32 or "
                        "bfloat16 only)")
    if x.dim() != 3:
        raise ValueError(f"mrconv_concat: want (B, N, C), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("mrconv_concat: x must be contiguous")
    b, n, c = x.shape
    _check_nk(n, k)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"mrconv_concat: k={k} outside 1..{MAX_K}")
    out = torch.empty((b, n, 2 * c), dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    # the normalised rows, written by the kernel's first launch
    scratch = torch.empty_like(x)
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mrconv_concat_forward(x.data_ptr(), scratch.data_ptr(),
                                        out.data_ptr(), b, n, c, k,
                                        _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        msg = lib.mrconv_concat_error(err).decode()
        raise RuntimeError(f"mrconv_concat kernel failed: {msg} ({err})")
    mrconv_concat.launches += 1
    return out


mrconv_concat.launches = 0


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = load_library("mrconv_concat")
    lib.mrconv_concat_forward.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.mrconv_concat_forward.restype = ctypes.c_int
    lib.mrconv_concat_error.argtypes = [ctypes.c_int]
    lib.mrconv_concat_error.restype = ctypes.c_char_p
    return lib
