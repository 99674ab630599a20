"""Exact nearest-neighbour search on the card (port of
``grafp_tpu.retrieval.search``).

For a query block Q and a fingerprint database DB the squared-L2
distances are ||q||^2 - 2 q.DB^T + ||db||^2: one (Q, d) x (d, M) f32
product (TF32 off, ``grafp_tpu_torch/__init__.py``) plus rank-1
corrections, then a top-k. Pad rows are masked to the worst distance
before the selection, never after it, so that they cannot crowd real
candidates out of a block's top-k.

Selection order is part of the result: ``lax.top_k`` puts the lower index
first among equal values, and the sequence eval's hit rates depend on it.
``torch.topk`` promises no order among ties, so ``topk_lower_first``
(``ops/knn.py``, shared with the k-NN graph) selects on a composite int64
key (the value's order-preserving bits, then the reversed index), which is
exact and gives the JAX order.

``scan_topk='approx'`` selects each block's candidates with the semantics
of ``lax.approx_max_k`` on a TPU (``topk_approx``; Chern et al., "TPU-KNN",
2022): the row is reduced to M bins, each keeping its largest value, and
the top-k of the bin winners is taken exactly. The cross-block merge stays
exact, as in the JAX package.

Several devices: ``exact_topk_sharded`` and ``masked_scan_search_sharded``
take the database as a list of row shards, each on its own device (the
'db' axis of a ``DeviceMesh``, ``core/mesh.shard_rows``). Each shard is
scored where it lies, with the single-device body, and yields its local
top-k under global row ids; the ndev x k candidates then go to the first
shard's device and merge in one exact top-k, earlier shards first among
ties, as ``shard_map`` with an all-gather does in the JAX package. The
launches on different cards overlap: nothing waits for the host between
them.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import math

import numpy as np
import torch

from grafp_tpu_torch.core.device import resolve_device
from grafp_tpu_torch.ops.knn import _order_key, topk_lower_first

# Rows per scored block, shared by the index family and the streaming
# scan. A block of 1024 queries (index.QUERY_CHUNK) by 2^20 rows holds a
# 4 GiB f32 distance matrix and its 8 GiB int64 selection key; the 'l2'
# search over a 2^20-row catalogue peaked at 22.4 GiB on an H100 80GB
# HBM3 (700 W), against 7.4 GiB for 256 queries, which searched 7 % slower
# (chip_smoke.py). (The JAX package's 1M-row floor was a TPU v5e slow
# path for smaller f32 blocks; it has no counterpart here.)
DB_BLOCK_ROWS = 1 << 20


def approx_bins(n: int, k: int, recall_target: float) -> int:
    """The number of bins M of ``topk_approx``: the least power of two with
    ((M - 1) / M)^(k - 1) >= recall_target, the chance that a top-k element
    shares its bin with none of the other k - 1, i.e. M >= 1 / (1 -
    recall_target^(1 / (k - 1))); at least k. n (exact) when k = 1, when
    recall_target >= 1 or when M would not be below n."""
    if k <= 1 or recall_target >= 1.0:
        return n
    need = 1.0 / (1.0 - recall_target ** (1.0 / (k - 1)))
    m = 1 << max(int(math.ceil(math.log2(max(need, k)))), 0)
    return m if m < n else n


def topk_approx(x: torch.Tensor, k: int, recall_target: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.approx_max_k``'s semantics on a TPU for f32 ``x`` (Q, n): the
    row's columns go to M = ``approx_bins`` bins, column i to bin i mod M;
    each bin keeps its largest value (the lower index among equal ones);
    the k largest bin winners come out as ``topk_lower_first`` orders them.
    Expected recall against the exact top-k is at least ``recall_target``;
    exact (``topk_lower_first`` itself) when M = n."""
    n = x.shape[-1]
    m = approx_bins(n, k, recall_target)
    if m >= n:
        return topk_lower_first(x, k)
    key = _order_key(x)
    pad = (-n) % m
    if pad:
        key = torch.nn.functional.pad(key, (0, pad), value=torch.iinfo(torch.int64).min)
    best = key.view(*key.shape[:-1], -1, m).amax(dim=-2)        # (Q, M) bin winners
    top = torch.topk(best, k, dim=-1).values
    idx = (n - 1) - (top & 0xFFFFFFFF)
    return torch.gather(x, -1, idx), idx


def approx_topk_ip(q: torch.Tensor, db: torch.Tensor, k: int,
                   recall_target: float = 0.95) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inner-product top-k with the approximate selection
    (``grafp_tpu/retrieval/search.py:90-103``): for L2-normalised
    fingerprints the inner-product ranking is the L2 ranking."""
    return topk_approx(torch.matmul(q, db.T), k, recall_target)


def _sq_norms(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * x, dim=-1)


def _select(x: torch.Tensor, k: int, scan_topk: str, recall_target: float):
    """The k largest of each row: exact (``topk_lower_first``) or, with
    'approx', ``topk_approx`` at ``recall_target``."""
    if scan_topk == "approx":
        return topk_approx(x, k, recall_target)
    return topk_lower_first(x, k)


def _topk_dist(q: torch.Tensor, db: torch.Tensor, k: int,
               db_sq: Optional[torch.Tensor] = None, metric: str = "l2",
               n_valid: Optional[int] = None, scan_topk: str = "exact",
               recall_target: float = 0.99) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense block scorer: (scores, ids), squared-L2 distances ascending
    for 'l2', inner products descending for 'ip'. Rows at index >=
    ``n_valid`` are masked to the worst score before selection, which is
    exact or, with ``scan_topk='approx'``, ``topk_approx``."""
    inner = torch.matmul(q, db.T)
    pad = None
    if n_valid is not None:
        pad = torch.arange(db.shape[0], device=db.device)[None, :] >= n_valid
    if metric == "ip":
        if pad is not None:
            inner.masked_fill_(pad, -float("inf"))
        return _select(inner, k, scan_topk, recall_target)
    if db_sq is None:
        db_sq = _sq_norms(db)
    dist = _sq_norms(q)[:, None] - 2.0 * inner + db_sq[None, :]
    if pad is not None:
        dist.masked_fill_(pad, float("inf"))
    s, i = _select(-dist, k, scan_topk, recall_target)
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
                       block: int, scan_topk: str = "exact",
                       recall_target: float = 0.99,
                       id_base: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan behind the index family (``search.py:_masked_scan_local``):
    per block of ``block`` rows, (decode ->) squared-L2 distances -> pad
    mask (ids >= m_valid) -> IVF probe mask -> block top-k -> running
    merge. Returns (Q, k) distances and ids; a slot with no candidate
    holds an infinite distance.

    rows_or_codes: (M, d) rows (f32, or a bf16 decode cache scored in
    f32), or (M, n_sub) uint8 PQ codes with ``codebooks`` (n_sub, ksub,
    dsub). cells (M,) int cell ids, -1 on pad rows, and member (Q, nlist)
    bool probe membership, both None without IVF. ``scan_topk``: each
    block's selection, 'exact' (``topk_lower_first``) or 'approx'
    (``topk_approx`` at ``recall_target``); the merge across blocks is
    exact either way. ``id_base`` is the global id of the first row (a
    shard's offset in ``masked_scan_search_sharded``); ``m_valid`` counts
    global rows."""
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
        ids = torch.arange(id_base + base, id_base + base + rows.shape[0],
                           device=q.device)
        dist.masked_fill_((ids >= m_valid)[None, :], float("inf"))
        if member is not None:
            c = cells[base:base + block]
            ok = member[:, c.clamp(min=0)] & (c >= 0)[None, :]
            dist.masked_fill_(~ok, float("inf"))
        kk = min(k, rows.shape[0])
        nd, sel = _select(dist.neg_(), kk, scan_topk, recall_target)
        best_s, best_i = _merge(best_s, best_i, -nd, ids[sel], k, "l2")
    return best_s, best_i


def _merge_shards(parts, k: int, metric: str, device: torch.device):
    """One exact top-k over the shards' candidates, gathered onto
    ``device`` in shard order (the all-gather merge of the JAX package)."""
    sign = -1.0 if metric == "l2" else 1.0
    cat_s = torch.cat([s.to(device) for s, _ in parts], dim=1)
    cat_i = torch.cat([i.to(device) for _, i in parts], dim=1)
    ms, sel = topk_lower_first(sign * cat_s, k)
    return sign * ms, torch.gather(cat_i, 1, sel)


def exact_topk_sharded(q: torch.Tensor, shards: Sequence[torch.Tensor], k: int,
                       metric: str = "l2", m_valid: Optional[int] = None,
                       scan_topk: str = "exact", recall_target: float = 0.99
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of q (Q, d) over the rows of ``shards``, equal (M_s, d) row
    blocks of one database, each on its own device
    (``grafp_tpu/retrieval/search.py:exact_topk_sharded``). Each shard
    takes its local top-k (``_topk_dist``; approximate with
    ``scan_topk='approx'``) under global ids; the merge is exact. Rows at
    global index >= ``m_valid`` (the caller's padding) are masked before
    the local selection. Returns (Q, k) scores and ids on the first
    shard's device; with exact selection they equal ``exact_topk``'s up
    to ties."""
    sizes = [s.shape[0] for s in shards]
    m_valid = sum(sizes) if m_valid is None else int(m_valid)
    kk = min(k, sizes[0])
    parts, base = [], 0
    for rows in shards:
        s, i = _topk_dist(q.to(rows.device), rows, kk, metric=metric,
                          n_valid=m_valid - base, scan_topk=scan_topk,
                          recall_target=recall_target)
        parts.append((s, i + base))
        base += rows.shape[0]
    return _merge_shards(parts, k, metric, shards[0].device)


def masked_scan_search_sharded(q: torch.Tensor, shards: Sequence[torch.Tensor],
                               codebooks: Optional[torch.Tensor],
                               cells: Optional[Sequence[torch.Tensor]],
                               member: Optional[torch.Tensor], m_valid: int, k: int,
                               block: int, scan_topk: str = "exact",
                               recall_target: float = 0.99
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``masked_scan_search`` with the rows (or PQ codes) in ``shards``,
    equal row blocks each on its own device, and ``cells`` (None without
    IVF) split alike (``search.py:masked_scan_search_sharded`` of the JAX
    package): each device scans its shard with the single-device body,
    global row ids from the shard's offset, and the ndev x k candidates
    merge exactly on the first shard's device. ``scan_topk='approx'``
    applies to the blocks' local selection only. Pad rows (global id >=
    ``m_valid``) are masked."""
    parts, base = [], 0
    for r, rows in enumerate(shards):
        dev = rows.device
        parts.append(masked_scan_search(
            q.to(dev), rows, None if codebooks is None else codebooks.to(dev),
            None if cells is None else cells[r],
            None if member is None else member.to(dev), m_valid, k, block,
            scan_topk, recall_target, id_base=base))
        base += rows.shape[0]
    return _merge_shards(parts, k, "l2", shards[0].device)


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
