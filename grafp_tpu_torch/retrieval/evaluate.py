"""Sequence-level retrieval evaluation (port of
``grafp_tpu.retrieval.evaluate``; the reference's eval_faiss,
eval.py:170-332).

Protocol (the reference's): index = dummy_db ++ db; the ground truth of
query row i is i + len(dummy_db). For each test id and sequence length
sl:
  1. top-k_probe segment search for each of the sl query rows;
  2. offset compensation: a hit id at row o proposes the sequence start
     id - o (eval.py:273-275);
  3. unique non-negative candidate starts (duplicates masked, not
     rescored);
  4. sequence score = mean_i q_i . recon[cid + i] over the valid window
     (the mean over the shorter window when cid + sl runs past the DB
     end, as numpy's slice truncation in eval.py:281-287);
  5. rank the top 10 -> top-1 exact / top-1 near (+-1 segment) / top-3 /
     top-10 hit rates (eval.py:289-311).

One batched search covers all (test id, row) segments; candidate windows
are scored in blocks of test ids, on the card (``_score_block``) or from
the memmaps on the host (``_score_block_host``), with the same tie order
(the lower candidate first among equal scores, ``lax.top_k``'s).

Artifacts have the reference's names and layouts: <result_dir>/
hit_rates.npy (4, n_sl), raw_score.npy (n_test, 4 n_sl), and
<emb_dir>/test_ids.npy.
"""

from __future__ import annotations

import os
import time
import uuid
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from grafp_tpu_torch.core.device import resolve_device
from grafp_tpu_torch.retrieval.index import get_index
from grafp_tpu_torch.retrieval.memmap_io import load_memmap_data
from grafp_tpu_torch.retrieval.search import topk_lower_first

# test ids scored per call: 256 ids x 380 candidates x 19 rows x 128 f32
# is a 0.9 GiB window gather at the longest sequence
TID_BLOCK = 256

# Rescoring on the card holds the merged (dummy ++ db) fingerprints there.
# Past this size it gathers windows from the memmaps on the host instead
# (the role of the reference's fake_recon_index, eval.py:218-237): 32 GiB
# of an 80 GB H100 (fma_large's 31M-row DB is 16 GB), beside the index
# and the scan's 22 GiB transient (index.QUERY_CHUNK), which measured
# 22.4 GiB on an H100 80GB HBM3 at 700 W.
RESCORE_BUDGET = 32 << 30


class ConcatRows:
    """Virtual row-wise concat of two (memmap-backed) 2-d arrays; gathers
    rows without materialising the merged DB."""

    def __init__(self, a, b):
        self.a, self.b = a, b
        self.shape = (a.shape[0] + b.shape[0], a.shape[1])
        self.nbytes = self.shape[0] * self.shape[1] * 4

    def gather(self, rows: np.ndarray) -> np.ndarray:
        out = np.empty((len(rows), self.shape[1]), np.float32)
        split = self.a.shape[0]
        lo = rows < split
        out[lo] = self.a[rows[lo]]
        out[~lo] = self.b[rows[~lo] - split]
        return out

    def materialize(self) -> np.ndarray:
        return np.concatenate([np.asarray(self.a), np.asarray(self.b)], axis=0)


def _score_block(recon: torch.Tensor, q: torch.Tensor, cand: torch.Tensor,
                 valid: torch.Tensor, sl: int, k10: int = 10
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """On recon's device: recon (M, d), q (B, sl, d), cand (B, C) candidate
    starts, valid (B, C) -> (top scores (B, k10), top ids (B, k10)); an
    empty slot is -inf / -999999."""
    m = recon.shape[0]
    c = cand.shape[1]
    rows = cand[..., None] + torch.arange(sl, device=cand.device)[None, None, :]
    in_range = rows < m
    win = recon[rows.clamp(0, m - 1)]                       # (B, C, sl, d)
    sims = torch.einsum("bcsd,bsd->bcs", win, q)
    sims = torch.where(in_range, sims, 0.0)
    denom = torch.clamp(in_range.sum(-1), min=1)
    scores = torch.where(valid, sims.sum(-1) / denom, -float("inf"))
    kk = min(k10, c)
    top_s, sel = topk_lower_first(scores, kk)
    top_ids = torch.gather(cand, 1, sel)
    top_ids = torch.where(torch.isfinite(top_s), top_ids, -999999)
    if kk < k10:
        top_s = torch.nn.functional.pad(top_s, (0, k10 - kk), value=-float("inf"))
        top_ids = torch.nn.functional.pad(top_ids, (0, k10 - kk), value=-999999)
    return top_s, top_ids


def _score_block_host(recon, q: np.ndarray, cand: np.ndarray, valid: np.ndarray,
                      sl: int, k10: int = 10) -> Tuple[np.ndarray, np.ndarray]:
    """Host twin of ``_score_block`` (window truncation, tie order and
    -999999 fill the same), gathering the windows from ``recon`` (a
    ``ConcatRows`` or an array, memmaps included)."""
    m = recon.shape[0]
    b, c = cand.shape
    rows = cand[..., None] + np.arange(sl)[None, None, :]
    in_range = rows < m
    flat = np.clip(rows, 0, m - 1).reshape(-1)
    if hasattr(recon, "gather"):
        win = recon.gather(flat)
    else:
        win = np.asarray(recon[flat], np.float32)
    win = win.reshape(b, c, sl, -1)
    sims = np.einsum("bcsd,bsd->bcs", win, q, optimize=True)
    sims = np.where(in_range, sims, 0.0)
    denom = np.maximum(in_range.sum(axis=-1), 1)
    scores = np.where(valid, sims.sum(axis=-1) / denom, -np.inf)
    kk = min(k10, c)
    # a stable argsort of -scores keeps the lower index first among ties
    sel = np.argsort(-scores, axis=1, kind="stable")[:, :kk]
    top_s = np.take_along_axis(scores, sel, 1).astype(np.float32)
    top_ids = np.take_along_axis(cand, sel, 1)
    top_ids = np.where(np.isfinite(top_s), top_ids, -999999)
    if kk < k10:
        top_s = np.pad(top_s, ((0, 0), (0, k10 - kk)), constant_values=-np.inf)
        top_ids = np.pad(top_ids, ((0, 0), (0, k10 - kk)), constant_values=-999999)
    return top_s, top_ids


def _unique_candidates(ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(B, C) int -> sorted ids with duplicate and negative entries masked."""
    s = np.sort(ids, axis=1)
    dup = np.zeros_like(s, dtype=bool)
    dup[:, 1:] = s[:, 1:] == s[:, :-1]
    return s, (s >= 0) & ~dup


def evaluate_sequences(index, recon, query: np.ndarray, test_ids: np.ndarray,
                       gt_ids: np.ndarray, test_seq_len: Sequence[int],
                       k_probe: int = 20, verbose: bool = True,
                       rescore: str = "auto",
                       device: Optional[Union[str, torch.device]] = None,
                       stats: Optional[dict] = None
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(top1_exact, top1_near, top3_exact, top10_exact), each (n_test, n_sl)
    ints. ``rescore``: 'device' holds the merged DB on ``device`` (None =
    the CUDA card), 'host' gathers candidate windows from ``recon`` on the
    host (the same results), 'auto' takes 'device' up to RESCORE_BUDGET
    bytes. A ``stats`` dict receives the tier taken ('rescore'), the
    seconds of the search and of the rescoring ('search_s', 'rescore_s',
    the card's copy of the merged DB included) and the top-10 ids
    ('top_ids', (n_test, n_sl, 10), -999999 for an empty slot)."""
    n_test = len(test_ids)
    max_sl = int(max(test_seq_len))
    nbytes = getattr(recon, "nbytes", recon.shape[0] * recon.shape[1] * 4)
    chosen = rescore == "auto"
    if chosen:
        rescore = "device" if nbytes <= RESCORE_BUDGET else "host"
    t_copy = time.time()
    if rescore == "device":
        dev = resolve_device(device)
        recon_dev = torch.as_tensor(
            np.asarray(recon.materialize() if isinstance(recon, ConcatRows) else recon,
                       np.float32), device=dev)
    elif verbose and chosen:
        print(f"[eval] rescoring on host ({nbytes / 2**30:.1f} GB merged DB > "
              f"budget {RESCORE_BUDGET / 2**30:.1f} GB)")

    rescore_s = time.time() - t_copy

    # one batched segment search for all rows of all test sequences
    rows = np.minimum((test_ids[:, None] + np.arange(max_sl)[None, :]).reshape(-1),
                      len(query) - 1)
    t0 = time.time()
    _, hits = index.search(query[rows], k_probe)
    hits = hits.reshape(n_test, max_sl, k_probe)
    search_s = time.time() - t0
    if verbose:
        print(f"[eval] segment search: {search_s:.2f}s "
              f"({n_test * max_sl} rows, k={k_probe})")

    # offset compensation once at the longest length; misses stay invalid
    comp = hits - np.arange(max_sl)[None, :, None]
    comp = np.where(hits < 0, -1, comp)

    n_sl = len(test_seq_len)
    top1_exact = np.zeros((n_test, n_sl), int)
    top1_near = np.zeros((n_test, n_sl), int)
    top3_exact = np.zeros((n_test, n_sl), int)
    top10_exact = np.zeros((n_test, n_sl), int)
    top10 = np.full((n_test, n_sl, 10), -999999, np.int64)
    for si, sl in enumerate(test_seq_len):
        sl = int(sl)
        cand_s, valid = _unique_candidates(comp[:, :sl, :].reshape(n_test, sl * k_probe))
        t0 = time.time()
        for b0 in range(0, n_test, TID_BLOCK):
            b1 = min(b0 + TID_BLOCK, n_test)
            qs = np.stack([query[t:t + sl] for t in test_ids[b0:b1]]).astype(np.float32)
            if rescore == "device":
                _, top_ids = _score_block(
                    recon_dev, torch.as_tensor(qs, device=dev),
                    torch.as_tensor(cand_s[b0:b1], device=dev),
                    torch.as_tensor(valid[b0:b1], device=dev), sl)
                pred = top_ids.cpu().numpy()
            else:
                _, pred = _score_block_host(recon, qs, cand_s[b0:b1], valid[b0:b1], sl)
            gt = gt_ids[b0:b1]
            top10[b0:b1, si] = pred
            top1_exact[b0:b1, si] = pred[:, 0] == gt
            top1_near[b0:b1, si] = np.abs(pred[:, 0] - gt) <= 1
            top3_exact[b0:b1, si] = (pred[:, :3] == gt[:, None]).any(axis=1)
            top10_exact[b0:b1, si] = (pred[:, :10] == gt[:, None]).any(axis=1)
        rescore_s += time.time() - t0
        if verbose:
            print(f"[eval] seq_len {sl}: rescoring {time.time() - t0:.2f}s")
    if stats is not None:
        stats.update(rescore=rescore, search_s=search_s, rescore_s=rescore_s,
                     top_ids=top10)
    return top1_exact, top1_near, top3_exact, top10_exact


def resolve_test_ids(test_ids, n_query: int, max_sl: int) -> np.ndarray:
    """Reference semantics (eval.py:240-247): 'all' -> every viable start;
    a numeric string -> a seeded permutation subset; else a .npy path.
    Ids from an array or a file are clamped into [0, n_query - max_sl], so
    that no window runs past the query end."""
    def _clamp(ids: np.ndarray) -> np.ndarray:
        return np.clip(ids, 0, max(n_query - max_sl, 0))

    if isinstance(test_ids, np.ndarray):
        return _clamp(test_ids.astype(int))
    if str(test_ids).lower() == "all":
        return np.arange(0, n_query - max_sl, 1)
    if str(test_ids).isnumeric():
        np.random.seed(42)
        return np.random.permutation(n_query - max_sl)[: int(test_ids)]
    return _clamp(np.load(test_ids).astype(int))


def eval_faiss(emb_dir: str, emb_dummy_dir: Optional[str] = None,
               index_type: str = "ivfpq", max_train: float = 1e7, test_ids="icassp",
               test_seq_len="1 3 5 9 11 19", k_probe: int = 20,
               n_centroids: int = 64, verbose: bool = True,
               scan_topk: str = "exact", scan_recall: float = 0.99,
               rescore: str = "auto",
               device: Optional[Union[str, torch.device]] = None,
               mesh=None, stats: Optional[dict] = None) -> np.ndarray:
    """The reference's eval.py:170-332 on the port's index family, on
    ``device`` (None = the CUDA card): loads the query, db and dummy_db
    memmaps, builds and trains the index (any type of ``get_index``) on
    dummy_db, adds dummy_db and db, rescores sequences (``rescore``:
    'auto' | 'device' | 'host') and returns the (4, n_sl) hit rates in
    percent, saved beside raw_score.npy and test_ids.npy. ``scan_topk``,
    ``scan_recall`` and ``mesh`` (a ``DeviceMesh`` whose 'db' axis shards
    the index's rows; None = one device) go to ``get_index``.

    ``stats``: a dict that receives the index ('index'), the seconds of
    each stage ('load_s', 'train_s', 'add_s', and ``evaluate_sequences``'s
    'search_s' and 'rescore_s'), the rescoring tier and the top-10 ids of
    every test id and length ('rescore', 'top_ids')."""
    if rescore not in ("auto", "device", "host"):
        raise ValueError(f"rescore must be 'auto', 'device' or 'host', got {rescore!r}")
    if isinstance(test_seq_len, str):
        test_seq_len = np.asarray(list(map(int, test_seq_len.split())))
    else:
        test_seq_len = np.asarray(test_seq_len)
    device = resolve_device(device)

    t0 = time.time()
    query, _ = load_memmap_data(emb_dir, "query", display=verbose)
    db, _ = load_memmap_data(emb_dir, "db", display=verbose)
    dummy_db, dummy_db_shape = load_memmap_data(emb_dummy_dir or emb_dir, "dummy_db",
                                                display=verbose)
    secs = {"load_s": time.time() - t0}
    t0 = time.time()
    index = get_index(index_type, dummy_db, dummy_db.shape, max_train,
                      n_centroids=n_centroids, scan_topk=scan_topk,
                      scan_recall=scan_recall, device=device, mesh=mesh)
    secs["train_s"] = time.time() - t0
    t0 = time.time()
    index.add(dummy_db)
    index.add(db)
    secs["add_s"] = time.time() - t0
    if verbose:
        print(f"Added total {index.ntotal} items to DB. {secs['add_s']:>4.2f} sec.")

    # the reference rescores with the original fingerprints, not the PQ
    # reconstructions (its fake_recon_index holds raw rows)
    recon = ConcatRows(dummy_db, db)
    tids = resolve_test_ids(test_ids, len(query), int(max(test_seq_len)))
    gt_ids = tids + int(dummy_db_shape[0])
    if verbose:
        print(f"test_id: {test_ids},  n_test: {len(tids)}")
    t1e, t1n, t3e, t10e = evaluate_sequences(
        index, recon, np.asarray(query), tids, gt_ids, test_seq_len,
        k_probe=k_probe, verbose=verbose, rescore=rescore, device=device, stats=stats)
    hit_rates = np.stack([100.0 * t1e.mean(axis=0), 100.0 * t1n.mean(axis=0),
                          100.0 * t3e.mean(axis=0), 100.0 * t10e.mean(axis=0)])

    result_dir = os.path.join(emb_dir, str(uuid.uuid4().hex)[:8])
    os.makedirs(result_dir, exist_ok=True)
    np.save(f"{result_dir}/hit_rates.npy", hit_rates)
    np.save(f"{result_dir}/raw_score.npy", np.concatenate((t1e, t1n, t3e, t10e), axis=1))
    np.save(f"{emb_dir}/test_ids.npy", tids)
    if verbose:
        print(f"Saved test_ids, hit-rates and raw score to {result_dir}.")
    if stats is not None:
        stats.update(secs, index=index)
    return hit_rates
