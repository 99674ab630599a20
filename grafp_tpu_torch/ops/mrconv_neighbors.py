"""Neighbour-max strategies for the Max-Relative graph op (port of
``grafp_tpu.ops.mrconv_neighbors``).

All return rel = the max over the k most similar nodes (self included) of
their features, shape (B, N, C), in x's dtype; callers subtract x
themselves. Selection uses the features with gradients stopped (the
reference builds its graphs under no_grad, torch_edge.py:15).

  'exact'   top-k of the f32 similarity + gather (reference semantics).
  'approx'  the JAX package's ``lax.approx_max_k``, a TPU partial-reduction
            top-k; off the TPU JAX computes an exact top-k, and so does
            the port: ``topk_lower_first`` (``lax.top_k``'s order) on the
            similarity in ``compute_dtype`` keys.
  'onehot'  k rounds of row argmax, pick the neighbour, mask it: exact
            k-NN max. The JAX package extracts the row with a one-hot
            product; the port gathers it, which is the same value for
            finite features.
  'pallas'  the CUDA kernels of ``ops/max_neighbors.py`` (forward and
            backward, through ``MaxNeighbors``); on a CPU tensor their
            plain versions.
  'auto'    'pallas' on a CUDA tensor, 'onehot' on the CPU (the JAX
            package: the accelerator's kernel, else onehot).
"""

from __future__ import annotations

import torch

from grafp_tpu_torch.ops.knn import (
    gather_neighbors,
    knn_graph,
    l2_normalize,
    topk_lower_first,
)
from grafp_tpu_torch.ops.max_neighbors import MaxNeighbors


def _similarity(x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """(B, N, N) f32 cosine similarity of keys normalised in x's dtype and
    cast to ``compute_dtype``."""
    xn = l2_normalize(x.detach()).to(compute_dtype).to(torch.float32)
    return torch.matmul(xn, xn.transpose(1, 2))


def max_neighbors_exact(x: torch.Tensor, k: int,
                        compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return torch.amax(gather_neighbors(x, knn_graph(x, k)), dim=2)


def max_neighbors_approx(x: torch.Tensor, k: int,
                         compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    idx = topk_lower_first(_similarity(x, compute_dtype), k)[1]
    return torch.amax(gather_neighbors(x, idx), dim=2)


def max_neighbors_onehot(x: torch.Tensor, k: int,
                         compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """k x (argmax, pick, mask): exact k-NN feature max."""
    sim = _similarity(x, compute_dtype)                    # (B, N, N)
    xc = x.to(compute_dtype)
    rel = torch.full_like(x, float("-inf"))
    for _ in range(k):
        nbr = torch.argmax(sim, dim=-1, keepdim=True)      # (B, N, 1)
        feat = gather_neighbors(xc, nbr)[:, :, 0]          # (B, N, C)
        rel = torch.maximum(rel, feat.to(x.dtype))
        sim = sim.scatter(-1, nbr, float("-inf"))          # mask the taken one
    return rel


def _max_neighbors_pallas(x: torch.Tensor, k: int,
                          compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return MaxNeighbors.apply(x.contiguous(), k)


def _max_neighbors_auto(x: torch.Tensor, k: int,
                        compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    if x.is_cuda:
        return _max_neighbors_pallas(x, k, compute_dtype)
    return max_neighbors_onehot(x, k, compute_dtype)


_STRATEGIES = {
    "exact": max_neighbors_exact,
    "approx": max_neighbors_approx,
    "onehot": max_neighbors_onehot,
    "pallas": _max_neighbors_pallas,
    "auto": _max_neighbors_auto,
}


def max_relative_neighbors(x: torch.Tensor, k: int, strategy: str = "onehot",
                           compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The max over the k most similar nodes (self included) of their
    features, (B, N, C) -> (B, N, C); callers subtract x themselves."""
    if strategy not in _STRATEGIES:
        raise ValueError(f"knn strategy {strategy!r}: one of {sorted(_STRATEGIES)}")
    return _STRATEGIES[strategy](x, k, compute_dtype)
