"""Exact nearest-neighbour search on the card (port of
``grafp_tpu.retrieval.search``, single device).

For a query block Q and a fingerprint database DB the squared-L2
distances are ||q||^2 - 2 q.DB^T + ||db||^2: one (Q, d) x (d, M) f32
product (TF32 off, ``grafp_tpu_torch/__init__.py``) plus rank-1
corrections, then a top-k. Pad rows are masked to the worst distance
before the selection, never after it, so that they cannot crowd real
candidates out of a block's top-k.

Selection order is part of the result: ``lax.top_k`` puts the lower index
first among equal values, and the sequence eval's hit rates depend on it.
``torch.topk`` promises no order among ties, so ``topk_lower_first``
selects on a composite int64 key (the value's order-preserving bits, then
the reversed index), which is exact and gives the JAX order.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from grafp_tpu_torch.core.device import resolve_device

# Rows per scored block, shared by the index family and the streaming
# scan. A block of 1024 queries (index.QUERY_CHUNK) by 2^20 rows holds a
# 4 GiB f32 distance matrix and its 8 GiB int64 selection key; the 'l2'
# search over a 2^20-row catalogue peaked at 22.4 GiB on an H100 80GB
# HBM3 (700 W), against 7.4 GiB for 256 queries, which searched 7 % slower
# (chip_smoke.py). (The JAX package's 1M-row floor was a TPU v5e slow
# path for smaller f32 blocks; it has no counterpart here.)
DB_BLOCK_ROWS = 1 << 20


def topk_lower_first(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest values of f32 ``x`` along the last axis, largest
    first, the lower index first among equal values (``lax.top_k``'s
    order). -0.0 counts as 0.0; NaN is not expected."""
    n = x.shape[-1]
    bits = (x.to(torch.float32) + 0.0).contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    key.mul_(1 << 32)
    key.add_(torch.arange(n - 1, -1, -1, device=x.device))
    idx = torch.topk(key, k, dim=-1).indices
    return torch.gather(x, -1, idx), idx


def _sq_norms(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * x, dim=-1)


def _topk_dist(q: torch.Tensor, db: torch.Tensor, k: int,
               db_sq: Optional[torch.Tensor] = None, metric: str = "l2",
               n_valid: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense block scorer: (scores, ids), squared-L2 distances ascending
    for 'l2', inner products descending for 'ip'. Rows at index >=
    ``n_valid`` are masked to the worst score before selection."""
    inner = torch.matmul(q, db.T)
    pad = None
    if n_valid is not None:
        pad = torch.arange(db.shape[0], device=db.device)[None, :] >= n_valid
    if metric == "ip":
        if pad is not None:
            inner.masked_fill_(pad, -float("inf"))
        return topk_lower_first(inner, k)
    if db_sq is None:
        db_sq = _sq_norms(db)
    dist = _sq_norms(q)[:, None] - 2.0 * inner + db_sq[None, :]
    if pad is not None:
        dist.masked_fill_(pad, float("inf"))
    s, i = topk_lower_first(-dist, k)
    return -s, i


def _merge(best_s, best_i, s, i, k: int, metric: str):
    """Running top-k merge of [best || new], earlier entries first among
    ties (``lax.top_k`` over the concatenation)."""
    sign = -1.0 if metric == "l2" else 1.0
    cat_s = torch.cat([best_s, s], dim=1)
    cat_i = torch.cat([best_i, i], dim=1)
    ms, sel = topk_lower_first(sign * cat_s, k)
    return sign * ms, torch.gather(cat_i, 1, sel)


def exact_topk(q: torch.Tensor, db: torch.Tensor, k: int, metric: str = "l2",
               block_rows: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k, q (Q, d), db (M, d) -> (Q, k) scores and int64 ids.

    ``block_rows`` > 0 scores the DB rows in blocks of that many, merging a
    running top-k, so the transient is Q x block_rows scores."""
    m = db.shape[0]
    if not block_rows or block_rows >= m:
        return _topk_dist(q, db, k, metric=metric)
    worst = float("inf") if metric == "l2" else -float("inf")
    best_s = torch.full((q.shape[0], k), worst, device=q.device)
    best_i = torch.zeros((q.shape[0], k), dtype=torch.int64, device=q.device)
    for base in range(0, m, block_rows):
        rows = db[base:base + block_rows]
        s, i = _topk_dist(q, rows, min(k, rows.shape[0]), metric=metric)
        best_s, best_i = _merge(best_s, best_i, s, i + base, k, metric)
    return best_s, best_i


def masked_scan_search(q: torch.Tensor, rows_or_codes: torch.Tensor,
                       codebooks: Optional[torch.Tensor],
                       cells: Optional[torch.Tensor],
                       member: Optional[torch.Tensor], m_valid: int, k: int,
                       block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan behind the index family (``search.py:_masked_scan_local``):
    per block of ``block`` rows, (decode ->) squared-L2 distances -> pad
    mask (ids >= m_valid) -> IVF probe mask -> block top-k -> running
    merge. Returns (Q, k) distances and ids; a slot with no candidate
    holds an infinite distance.

    rows_or_codes: (M, d) rows (f32, or a bf16 decode cache scored in
    f32), or (M, n_sub) uint8 PQ codes with ``codebooks`` (n_sub, ksub,
    dsub). cells (M,) int cell ids, -1 on pad rows, and member (Q, nlist)
    bool probe membership, both None without IVF."""
    nq = q.shape[0]
    q2 = torch.sum(q * q, dim=1, keepdim=True)
    best_s = torch.full((nq, k), float("inf"), device=q.device)
    best_i = torch.full((nq, k), -1, dtype=torch.int64, device=q.device)
    sidx = None if codebooks is None else torch.arange(codebooks.shape[0],
                                                       device=q.device)
    for base in range(0, rows_or_codes.shape[0], block):
        blk = rows_or_codes[base:base + block]
        if codebooks is not None:
            blk = codebooks[sidx[None, :], blk.long()].reshape(blk.shape[0], -1)
        rows = blk.to(torch.float32)
        dist = torch.matmul(q, rows.T).mul_(-2.0).add_(q2)
        dist.add_(torch.sum(rows * rows, dim=1)[None, :])
        ids = torch.arange(base, base + rows.shape[0], device=q.device)
        dist.masked_fill_((ids >= m_valid)[None, :], float("inf"))
        if member is not None:
            c = cells[base:base + block]
            ok = member[:, c.clamp(min=0)] & (c >= 0)[None, :]
            dist.masked_fill_(~ok, float("inf"))
        nd, sel = topk_lower_first(dist.neg_(), min(k, rows.shape[0]))
        best_s, best_i = _merge(best_s, best_i, -nd, ids[sel], k, "l2")
    return best_s, best_i


def exact_topk_streaming(q: np.ndarray, db, k: int, host_block: int = 1 << 22,
                         device_block: int = DB_BLOCK_ROWS, metric: str = "l2",
                         device: Optional[Union[str, torch.device]] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact top-k over a database larger than the card's memory: host
    blocks (memmap reads) go through ``exact_topk`` on ``device`` (None =
    the CUDA card) and merge on the host, earlier blocks first among
    ties."""
    device = resolve_device(device)
    qd = torch.as_tensor(np.asarray(q, np.float32), device=device)
    best_s = np.full((len(q), k), np.inf if metric == "l2" else -np.inf, np.float32)
    best_i = np.full((len(q), k), -1, np.int64)
    sign = -1.0 if metric == "l2" else 1.0
    for start in range(0, db.shape[0], host_block):
        blk = torch.as_tensor(np.asarray(db[start:start + host_block], np.float32),
                              device=device)
        s, i = exact_topk(qd, blk, min(k, blk.shape[0]), metric=metric,
                          block_rows=min(device_block, blk.shape[0]))
        cat_s = np.concatenate([best_s, s.cpu().numpy()], axis=1)
        cat_i = np.concatenate([best_i, i.cpu().numpy() + start], axis=1)
        order = np.argsort(sign * -cat_s, axis=1, kind="stable")[:, :k]
        best_s = np.take_along_axis(cat_s, order, 1)
        best_i = np.take_along_axis(cat_i, order, 1)
    return best_s, best_i
