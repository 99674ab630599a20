#!/usr/bin/env python3
"""The fma_large evaluation geometry through the PyTorch/CUDA port on one
card: the counterpart of scripts/fma_large_smoke.py, from the port.

It writes the same memmaps as that script, from the same numpy
RandomState streams: 30.6M dummy rows (seed 0) and 500k db rows (seed 1),
unit-norm 128-d f32, and queries = db + 0.25 noise (seed 2),
renormalised, segment-aligned with the db rows. In all 31.1M x 128 f32 =
15.9 GB. It then runs the port's eval_faiss('ivfpq', n_centroids=64,
k_probe=20, max_train=1M, test_ids="500", test_seq_len="1 11 19") over
them on the card, once with rescore='auto' (the merged DB fits
RESCORE_BUDGET, so the card rescores), then searches the same index
again and rescores on the host (evaluate_sequences over eval_faiss's
test ids), and requires the two tiers' hit rates and top-10 ids to be
equal. It prints the seconds of each
stage (data, index train, add, search, rescoring), the host's peak RSS,
the card's peak memory (torch.cuda.max_memory_allocated) and the hit
rates.

    python scripts/torch_port_fma_large_smoke.py [--dummy 30600000]
        [--nq 500000] [--root DIR] [--data-only]

The memmaps go under ROOT/rows<dummy>+<nq>_seeds0-2 (ROOT defaults to
torch_port_fma_large under the temp directory) and are reused when all
three are there; the full size needs 16 GB of disk.
"""

from __future__ import annotations

import argparse
import os
import resource
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

D = 128
DUMMY_ROWS = 30_600_000
QUERY_ROWS = 500_000
# the JAX script's eval_faiss arguments
EVAL = dict(index_type="ivfpq", max_train=1_000_000, test_ids="500",
            test_seq_len="1 11 19", k_probe=20, n_centroids=64)
# the first builds the index, the second searches it again
TIERS = ("auto", "host")


def write_memmap(path, fname, n, seed, base=None, noise=0.0):
    """Chunked normalized random rows; base+noise for corrupted copies
    (scripts/fma_large_smoke.py:write_memmap, byte for byte)."""
    mm = np.memmap(os.path.join(path, fname + ".mm"), np.float32,
                   mode="w+", shape=(n, D))
    rng = np.random.RandomState(seed)
    chunk = 1 << 20
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        if base is None:
            x = rng.randn(e - s, D).astype(np.float32)
        else:
            x = base[s:e] + noise * rng.randn(e - s, D).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True) + 1e-9
        mm[s:e] = x
    mm.flush()
    np.save(os.path.join(path, fname + "_shape.npy"), np.array([n, D]))
    return mm


def data_dir(root: str, dummy: int, nq: int) -> str:
    return os.path.join(root, f"rows{dummy}+{nq}_seeds0-2")


def _complete(path: str, dummy: int, nq: int) -> bool:
    """All three memmaps written to their end (a shape file is saved after
    its rows are flushed)."""
    for name, n in (("dummy_db", dummy), ("db", nq), ("query", nq)):
        shape = os.path.join(path, name + "_shape.npy")
        if not os.path.exists(shape) or np.load(shape).tolist() != [n, D]:
            return False
    return True


def make_data(root: str, dummy: int, nq: int):
    """(the memmaps' directory, seconds spent writing them, None when they
    were already there)."""
    path = data_dir(root, dummy, nq)
    if _complete(path, dummy, nq):
        print(f"[data] reusing {path}", flush=True)
        return path, None
    os.makedirs(path, exist_ok=True)
    for name in ("dummy_db", "db", "query"):       # a half-written set
        shape = os.path.join(path, name + "_shape.npy")
        if os.path.exists(shape):
            os.remove(shape)
    t0 = time.time()
    write_memmap(path, "dummy_db", dummy, seed=0)
    db = write_memmap(path, "db", nq, seed=1)
    # queries = corrupted copies of the db rows (segment-aligned)
    write_memmap(path, "query", nq, seed=2, base=db, noise=0.25)
    secs = time.time() - t0
    print(f"[data] {dummy + nq:,} x {D} memmaps "
          f"({(dummy + nq) * D * 4 / 1e9:.1f} GB) in {secs:.1f}s", flush=True)
    return path, secs


def peak_rss_gb() -> float:
    """The process's peak resident set (Linux reports KiB), in GB; pages
    of the memmaps it has read count."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def _search_again(path: str, index, rescore: str, kw: dict, device, verbose: bool,
                  stats: dict) -> np.ndarray:
    """eval_faiss's evaluation over an index it built at ``path``, for its
    test ids (test_ids.npy beside the memmaps), rescoring on ``rescore``:
    the (4, n_sl) hit rates; ``stats`` as eval_faiss fills it, with no
    training or adding."""
    from grafp_tpu_torch.retrieval.evaluate import ConcatRows, evaluate_sequences
    from grafp_tpu_torch.retrieval.memmap_io import load_memmap_data

    t0 = time.time()
    query, _ = load_memmap_data(path, "query", display=False)
    db, _ = load_memmap_data(path, "db", display=False)
    dummy, _ = load_memmap_data(path, "dummy_db", display=False)
    tids = np.load(os.path.join(path, "test_ids.npy"))
    stats.update(load_s=time.time() - t0, train_s=0.0, add_s=0.0)
    hits = evaluate_sequences(index, ConcatRows(dummy, db), np.asarray(query), tids,
                              tids + len(dummy), np.asarray(kw["test_seq_len"].split(), int),
                              k_probe=kw["k_probe"], verbose=verbose, rescore=rescore,
                              device=device, stats=stats)
    return np.stack([100.0 * h.mean(axis=0) for h in hits])


def run(path: str, device=None, verbose: bool = True, **overrides) -> dict:
    """eval_faiss over the memmaps at ``path`` with rescore='auto', then
    the same index searched again and rescored on the host. Returns
    {tier: {"hit_rates", "top_ids", "rescore" (the tier taken), "load_s",
    "train_s", "add_s" (0 for 'host', which reuses the index),
    "search_s", "rescore_s", "total_s", "peak_rss_gb", "card_peak_gb"
    (None off the card)}, "index": the index}. Raises AssertionError when
    two tiers' hit rates or top ids differ."""
    import torch

    from grafp_tpu_torch.core.device import resolve_device
    from grafp_tpu_torch.retrieval.evaluate import eval_faiss

    device = resolve_device(device)
    on_card = device.type == "cuda"
    kw = {**EVAL, **overrides}
    out, index = {}, None
    for tier in TIERS:
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        stats = {}
        t0 = time.time()
        if index is None:
            # get_index subsamples its training rows with the global numpy
            # stream (as the reference does)
            np.random.seed(0)
            hr = eval_faiss(path, verbose=verbose, rescore=tier, device=device,
                            stats=stats, **kw)
            index = stats.pop("index")
        else:
            hr = _search_again(path, index, tier, kw, device, verbose, stats)
        out[tier] = dict(stats, hit_rates=hr, total_s=time.time() - t0,
                         peak_rss_gb=peak_rss_gb(),
                         card_peak_gb=(torch.cuda.max_memory_allocated(device) / 1e9
                                       if on_card else None))
        r = out[tier]
        print(f"[eval] rescore={tier} ({r['rescore']}): train {r['train_s']:.1f}s  "
              f"add {r['add_s']:.1f}s  search {r['search_s']:.1f}s  rescoring "
              f"{r['rescore_s']:.1f}s  total {r['total_s']:.1f}s; peak RSS "
              f"{r['peak_rss_gb']:.2f} GB, card peak "
              + (f"{r['card_peak_gb']:.2f} GB" if on_card else "n/a"), flush=True)
        print(f"[eval] top1-exact {np.round(hr[0], 1)}  top1-near "
              f"{np.round(hr[1], 1)}  top3 {np.round(hr[2], 1)}", flush=True)
    first, second = (out[tier] for tier in TIERS)
    assert np.array_equal(second["hit_rates"], first["hit_rates"]), \
        "hit rates differ between the rescoring tiers"
    same = second["top_ids"] == first["top_ids"]
    assert same.all(), (f"top ids differ between the rescoring tiers at "
                        f"{int((~same).sum())} of {same.size} slots")
    print("[eval] tiers auto, host: equal hit rates and top-10 ids", flush=True)
    out["index"] = index
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dummy", type=int, default=DUMMY_ROWS)
    ap.add_argument("--nq", type=int, default=QUERY_ROWS)
    ap.add_argument("--root", default=os.path.join(tempfile.gettempdir(),
                                                   "torch_port_fma_large"))
    ap.add_argument("--data-only", action="store_true",
                    help="write (or find) the memmaps and stop")
    args = ap.parse_args(argv)

    path, data_s = make_data(args.root, args.dummy, args.nq)
    print(f"[data] {'reused' if data_s is None else f'{data_s:.1f}s'}; peak RSS "
          f"{peak_rss_gb():.2f} GB", flush=True)
    if args.data_only:
        return 0
    t0 = time.time()
    run(path)
    print(f"[eval] total {time.time() - t0:.0f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
