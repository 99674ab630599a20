"""Lloyd k-means on the card (port of ``grafp_tpu.retrieval.kmeans``).

The IVF coarse quantizer and the PQ codebooks train with it. Assignment is
a distance product and an argmax; the update sums each cluster's rows
(``index_add_``) and divides by its count; an empty cluster is re-seeded
from a random data row.

Every random draw is explicit: the initial centroid rows and the re-seed
rows of each iteration come either from a ``torch.Generator`` or from the
caller (the tests pass the JAX function's draws). Rows are assigned in
chunks, so the (rows, k) score matrix never exceeds ``ASSIGN_ROWS`` rows;
the multi-subspace form of the PQ trainer would otherwise hold (S, M,
ksub) scores, 64 GiB for 64 subspaces of 2^20 rows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# rows per assignment chunk: (S, rows, k) f32 scores are 1 GiB for 64
# subspaces of 256 centroids, 64 MiB for one space of 1024
ASSIGN_ROWS = 1 << 14


def assign(data: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(..., M, d), (..., k, d) -> (..., M) int64 nearest-centroid ids:
    argmax of x.c - ||c||^2 / 2, the lower id among equal scores."""
    half_sq = 0.5 * torch.sum(centroids * centroids, dim=-1)
    out = []
    for s in range(0, data.shape[-2], ASSIGN_ROWS):
        chunk = data[..., s:s + ASSIGN_ROWS, :]
        score = torch.matmul(chunk, centroids.transpose(-1, -2))
        out.append(torch.argmax(score.sub_(half_sq[..., None, :]), dim=-1))
    return torch.cat(out, dim=-1)


def draw_kmeans_rows(m: int, k: int, iters: int, generator: torch.Generator,
                     lead: Tuple[int, ...] = ()) -> Tuple[torch.Tensor, torch.Tensor]:
    """(init (*lead, k), reseed (*lead, iters, k)) row indices: k distinct
    rows of m (row j % m when m < k), and k rows of m per iteration."""
    n = 1
    for s in lead:
        n *= s
    if m >= k:
        init = torch.stack([torch.randperm(m, generator=generator)[:k]
                            for _ in range(n)])
    else:
        init = (torch.arange(k) % m).expand(n, k)
    reseed = torch.randint(0, m, (n, iters, k), generator=generator)
    return init.reshape(*lead, k), reseed.reshape(*lead, iters, k)


def kmeans(data: torch.Tensor, k: int, iters: int = 20,
           generator: Optional[torch.Generator] = None,
           init: Optional[torch.Tensor] = None,
           reseed: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(centroids (*S, k, d), assignment (*S, M)) for f32 data (*S, M, d),
    one independent k-means per leading index (the PQ subspaces).

    ``init`` (*S, k) and ``reseed`` (*S, iters, k) are the draws (row
    indices); missing ones come from ``generator`` (seed 0 when None)."""
    lead, (m, d) = tuple(data.shape[:-2]), data.shape[-2:]
    if init is None or reseed is None:
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        init, reseed = draw_kmeans_rows(m, k, iters, g, lead)
    flat = data.reshape(-1, m, d)
    n = flat.shape[0]
    init = init.reshape(n, k).to(data.device)
    reseed = reseed.reshape(n, iters, k).to(data.device)
    batch = torch.arange(n, device=data.device)[:, None]
    cent = flat[batch, init]                                  # (n, k, d)
    ones = torch.ones(m, device=data.device)
    for it in range(iters):
        a = assign(flat, cent) + batch * k                    # (n, M) flat ids
        sums = torch.zeros(n * k, d, device=data.device).index_add_(
            0, a.reshape(-1), flat.reshape(-1, d))
        counts = torch.zeros(n * k, device=data.device).index_add_(
            0, a.reshape(-1), ones.repeat(n))
        new = (sums / torch.clamp(counts, min=1.0)[:, None]).reshape(n, k, d)
        rand_pts = flat[batch, reseed[:, it]]
        cent = torch.where((counts > 0).reshape(n, k, 1), new, rand_pts)
    return cent.reshape(*lead, k, d), assign(flat, cent).reshape(*lead, m)
