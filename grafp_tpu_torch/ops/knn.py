"""Row normalisation and the dense k-NN graph (port of
``grafp_tpu.ops.knn``).

For L2-normalised features, -||x_i - x_j||^2 = 2 cos(x_i, x_j) - 2, so the
k nearest nodes by distance are the k most similar by cosine: one batched
product and a top-k, self included. The graph is a function of the
features with gradients stopped (the reference builds it under no_grad,
torch_edge.py:15). Indices are int64, PyTorch's index dtype (the JAX
package returns int32), nearest first.
"""

from __future__ import annotations

from typing import Optional

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """torch.nn.functional.normalize semantics: x / max(||x||, eps), with
    the norm rounded as XLA rounds ``jnp.linalg.norm``: squares and sum in
    f32, the sum cast to x's dtype, then the square root in x's dtype (for
    bf16 this gives the JAX package's keys bit for bit)."""
    x32 = x.to(torch.float32)
    n = torch.sqrt(torch.sum(x32 * x32, dim=dim, keepdim=True).to(x.dtype))
    return x / torch.clamp(n, min=eps)


def pairwise_sqdist(x: torch.Tensor, y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Squared L2 distances, x (B, N, C), y (B, M, C) -> (B, N, M) f32."""
    if y is None:
        y = x
    x2 = torch.sum(x * x, dim=-1, keepdim=True)           # (B, N, 1)
    y2 = torch.sum(y * y, dim=-1, keepdim=True)           # (B, M, 1)
    inner = torch.matmul(x.to(torch.float32), y.to(torch.float32).transpose(-1, -2))
    return x2 - 2.0 * inner + y2.transpose(-1, -2)


def dilate_neighbors(idx: torch.Tensor, dilation: int) -> torch.Tensor:
    """Keep every dilation-th neighbour (reference torch_edge.py:252-254),
    idx (..., k*dilation) -> (..., k)."""
    if dilation <= 1:
        return idx
    return idx[..., ::dilation]


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def knn_graph(x: torch.Tensor, k: int, block_rows: int = 0,
              compute_dtype: str = "float32") -> torch.Tensor:
    """Indices (B, N, k) of the k nearest nodes of every node (by L2 on
    channel-normalised features, self included), nearest first.

    ``block_rows`` 0 builds the dense (B, N, N) similarity; > 0 takes the
    query rows in tiles of that many, bounding the similarity at
    (B, block_rows, N) (the reference's chunked path, torch_edge.py:82-94).
    The keys are normalised in x's dtype and cast to ``compute_dtype``; the
    similarity accumulates in f32."""
    xn = l2_normalize(x.detach()).to(_DTYPES[compute_dtype]).to(torch.float32)
    n = xn.shape[1]
    if block_rows and block_rows < n:
        return torch.cat([
            torch.topk(torch.matmul(xn[:, r0:r0 + block_rows], xn.transpose(1, 2)),
                       k, dim=-1).indices
            for r0 in range(0, n, block_rows)], dim=1)
    return torch.topk(torch.matmul(xn, xn.transpose(1, 2)), k, dim=-1).indices


def gather_neighbors(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Neighbour features, x (B, N, C), idx (B, N, k) -> (B, N, k, C) (the
    reference's batched_index_select, gcn_lib/torch_nn.py:79-99, channels
    last)."""
    b = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[b, idx]
