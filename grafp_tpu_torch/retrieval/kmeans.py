"""Lloyd k-means on the card (port of ``grafp_tpu.retrieval.kmeans``).

The IVF coarse quantizer and the PQ codebooks train with it. Assignment is
a distance product and an argmax; the update sums each cluster's rows by
a one-hot product, as the JAX package does, and divides by its count; an
empty cluster is re-seeded from a random data row. The sums take no float
atomics: on the card a scatter-add (``index_add_``) adds each cluster's
rows in a different order on every run, and so trains other centroids
from the same data (ROADMAP.md C12); a product and the chunks' sums in a
fixed order give one answer for one input.

Every random draw is explicit: the initial centroid rows and the re-seed
rows of each iteration come either from a ``torch.Generator`` or from the
caller (the tests pass the JAX function's draws). Rows are assigned in
chunks, so the (rows, k) score matrix never exceeds ``ASSIGN_ROWS`` rows;
the multi-subspace form of the PQ trainer would otherwise hold (S, M,
ksub) scores, 64 GiB for 64 subspaces of 2^20 rows. The update's one-hot
matrix of a chunk is written over that chunk's scores, so it takes no
memory of its own.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# rows per assignment chunk: (S, rows, k) f32 scores are 1 GiB for 64
# subspaces of 256 centroids, 64 MiB for one space of 1024
ASSIGN_ROWS = 1 << 14


def _scores(chunk: torch.Tensor, centroids: torch.Tensor,
            half_sq: torch.Tensor) -> torch.Tensor:
    """(..., rows, k) x.c - ||c||^2 / 2: the larger, the nearer."""
    return torch.matmul(chunk, centroids.transpose(-1, -2)).sub_(half_sq[..., None, :])


def assign(data: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(..., M, d), (..., k, d) -> (..., M) int64 nearest-centroid ids:
    argmax of x.c - ||c||^2 / 2, the lower id among equal scores."""
    half_sq = 0.5 * torch.sum(centroids * centroids, dim=-1)
    return torch.cat([torch.argmax(_scores(data[..., s:s + ASSIGN_ROWS, :], centroids,
                                           half_sq), dim=-1)
                      for s in range(0, data.shape[-2], ASSIGN_ROWS)], dim=-1)


def cluster_sums(data: torch.Tensor, centroids: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums (n, k, d), counts (n, k)) of the rows of data (n, M, d)
    nearest each of centroids (n, k, d), as ``assign`` assigns them. Each
    chunk of ``ASSIGN_ROWS`` rows adds its one-hot product onehot^T x to
    the sums, chunk after chunk, so the order of every addition is fixed
    (``grafp_tpu/retrieval/kmeans.py:41-42`` forms the same product over
    all rows at once). The counts are whole numbers, added in int64."""
    n, m, d = data.shape
    k = centroids.shape[1]
    half_sq = 0.5 * torch.sum(centroids * centroids, dim=-1)
    sums = torch.zeros(n, k, d, device=data.device)
    counts = torch.zeros(n, k, dtype=torch.int64, device=data.device)
    for s in range(0, m, ASSIGN_ROWS):
        chunk = data[:, s:s + ASSIGN_ROWS]
        score = _scores(chunk, centroids, half_sq)
        ids = torch.argmax(score, dim=-1)                     # (n, rows)
        onehot = score.zero_().scatter_(-1, ids[..., None], 1.0)
        sums.baddbmm_(onehot.transpose(1, 2), chunk)
        counts.scatter_add_(1, ids, torch.ones_like(ids))
    return sums, counts.to(torch.float32)


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
    for it in range(iters):
        sums, counts = cluster_sums(flat, cent)
        new = sums / torch.clamp(counts, min=1.0)[..., None]
        rand_pts = flat[batch, reseed[:, it]]
        cent = torch.where((counts > 0)[..., None], new, rand_pts)
    return cent.reshape(*lead, k, d), assign(flat, cent).reshape(*lead, m)
