"""Plain reference of the 'ivfpq' index of GraFP's eval (eval.py:65-69:
FAISS IndexIVFPQ with ``n_centroids`` coarse cells, 64 sub-quantizers of
8 bits, nprobe 20): Lloyd k-means for the coarse cells and for each
subspace's codebook, every row coded by its nearest cell and nearest
codeword per subspace, and a search that ranks the rows of the query's
nprobe nearest cells by the squared L2 distance to their PQ
reconstruction.

The trainers are a frozen copy of the program's seeded Lloyd iterations
(``grafp_tpu_torch/retrieval/kmeans.py``, ``pq.py``: the same draws from
a CPU generator seeded 0 for the cells and 1 for the codebooks, each
cluster summed chunk by chunk as a one-hot product, an empty cluster
re-seeded from a drawn row), so that the centroids and codebooks are
worked out again from the rows and not taken from the program. Distances
are float64 of float32 reconstructions.
"""

from __future__ import annotations

from typing import Tuple

import torch

ASSIGN_ROWS = 1 << 14
ITERS = 20


def _scores(chunk, centroids, half_sq):
    return torch.matmul(chunk, centroids.transpose(-1, -2)).sub_(half_sq[..., None, :])


def assign(data: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(..., M, d), (..., k, d) -> (..., M) nearest ids by x.c - |c|^2 / 2."""
    half_sq = 0.5 * torch.sum(centroids * centroids, dim=-1)
    return torch.cat([torch.argmax(_scores(data[..., s:s + ASSIGN_ROWS, :], centroids, half_sq),
                                   dim=-1)
                      for s in range(0, data.shape[-2], ASSIGN_ROWS)], dim=-1)


def kmeans(data: torch.Tensor, k: int, seed: int) -> torch.Tensor:
    """(*S, k, d) centroids of f32 data (*S, M, d), one Lloyd run per
    leading index, ITERS iterations."""
    lead, (m, d) = tuple(data.shape[:-2]), data.shape[-2:]
    flat = data.reshape(-1, m, d)
    n = flat.shape[0]
    g = torch.Generator().manual_seed(seed)
    init = torch.stack([torch.randperm(m, generator=g)[:k] for _ in range(n)])
    reseed = torch.randint(0, m, (n, ITERS, k), generator=g).to(data.device)
    batch = torch.arange(n, device=data.device)[:, None]
    cent = flat[batch, init.to(data.device)]
    for it in range(ITERS):
        half_sq = 0.5 * torch.sum(cent * cent, dim=-1)
        sums = torch.zeros(n, k, d, device=data.device)
        counts = torch.zeros(n, k, dtype=torch.int64, device=data.device)
        for s in range(0, m, ASSIGN_ROWS):
            chunk = flat[:, s:s + ASSIGN_ROWS]
            score = _scores(chunk, cent, half_sq)
            ids = torch.argmax(score, dim=-1)
            onehot = score.zero_().scatter_(-1, ids[..., None], 1.0)
            sums.baddbmm_(onehot.transpose(1, 2), chunk)
            counts.scatter_add_(1, ids, torch.ones_like(ids))
        counts = counts.to(torch.float32)
        new = sums / torch.clamp(counts, min=1.0)[..., None]
        cent = torch.where((counts > 0)[..., None], new, flat[batch, reseed[:, it]])
    return cent.reshape(*lead, k, d)


class Index:
    """Coarse centroids, codebooks (n_sub, 256, d / n_sub), and each row's
    cell and codes, worked out from ``train`` rows and coded ``rows``."""

    def __init__(self, train: torch.Tensor, nlist: int, n_sub: int = 64, ksub: int = 256):
        self.n_sub, self.d = n_sub, train.shape[1]
        self.centroids = kmeans(train, nlist, seed=0)
        sub = train.reshape(train.shape[0], n_sub, -1).transpose(0, 1).contiguous()
        self.codebooks = kmeans(sub, ksub, seed=1)

    def add(self, rows: torch.Tensor) -> None:
        """Code ``rows`` after the rows added before (ids follow on)."""
        cells = assign(rows, self.centroids)
        sub = rows.reshape(rows.shape[0], self.n_sub, -1).transpose(0, 1)
        codes = torch.cat([assign(sub[:, s:s + ASSIGN_ROWS], self.codebooks).T
                           for s in range(0, rows.shape[0], ASSIGN_ROWS)]).to(torch.uint8)
        if hasattr(self, "cells"):
            cells, codes = torch.cat([self.cells, cells]), torch.cat([self.codes, codes])
        self.cells, self.codes = cells, codes

    def decode(self, ids: torch.Tensor) -> torch.Tensor:
        sidx = torch.arange(self.n_sub, device=ids.device)[None, :]
        return self.codebooks[sidx, self.codes[ids].long()].reshape(ids.shape[0], self.d)

    def probed(self, q: torch.Tensor, nprobe: int) -> torch.Tensor:
        """(nprobe,) cells nearest the query row q."""
        score = self.centroids @ q - 0.5 * torch.sum(self.centroids ** 2, dim=1)
        return torch.topk(score, nprobe).indices

    def candidates(self, q: torch.Tensor, nprobe: int) -> torch.Tensor:
        """Ids of the rows in the query row's probed cells."""
        member = torch.zeros(self.centroids.shape[0], dtype=torch.bool, device=q.device)
        member[self.probed(q, nprobe)] = True
        return torch.nonzero(member[self.cells]).squeeze(1)

    def distances(self, q: torch.Tensor, ids: torch.Tensor, rounding=None) -> torch.Tensor:
        """float64 squared L2 distances from the query row q to the
        reconstructions of rows ``ids`` (rounded first by ``rounding``)."""
        out = []
        for s in range(0, ids.shape[0], 1 << 22):
            rec = self.decode(ids[s:s + (1 << 22)])
            if rounding is not None:
                rec = rounding(rec)
            out.append(((rec.double() - q.double()[None, :]) ** 2).sum(dim=1))
        return torch.cat(out) if out else torch.zeros(0, dtype=torch.float64, device=q.device)

    def search_row(self, q: torch.Tensor, nprobe: int, k: int, rounding=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(ids of the k nearest probed rows, their distances, and the
        candidates' ids) for one query row; ranked by the distances to
        reconstructions rounded by ``rounding`` when given."""
        cand = self.candidates(q, nprobe)
        dist = self.distances(q, cand, rounding)
        top = torch.topk(dist, min(k, cand.shape[0]), largest=False)
        return cand[top.indices], top.values, cand
