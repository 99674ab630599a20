"""HNSW approximate nearest-neighbour index on the host (port of
``grafp_tpu.retrieval.hnsw``).

The reference's 'hnsw' mode is CPU FAISS IndexHNSWFlat(M=16,
efConstruction=80) (eval.py:90-98). HNSW is a sequential graph walk, so,
as in the reference, it runs on the host's CPU whatever device the other
index types use: ``get_index('hnsw', device=...)`` ignores ``device``.
That is the design of the index, not a fallback from the card; the card's
'l2' and 'ivfpq' scans are the fast path for a catalogue that fits it.

Malkov-Yashunin construction: geometric level sampling (mult = 1/ln(M)),
greedy descent through the upper layers, an ef-bounded beam at the
insertion layer, closest-M neighbour selection with backlink pruning.
Two backends compute it:
- 'native' (``native/hnsw_native.py``, C++, levels from std::mt19937),
  which 'auto' means; a failed build raises, nothing falls back;
- 'python' (numpy, levels from ``np.random.RandomState(seed)``), only
  when asked for by name.
"""

from __future__ import annotations

import heapq
import math
from typing import List, Optional, Tuple

import numpy as np


class IndexHNSW:
    # Sequential Python insertion: ~100k rows take minutes on one core.
    # The JAX package measured its C++ backend on one host core at 1,096
    # rows/s around 100k rows and ~500 rows/s on average to 1M
    # (grafp_tpu/retrieval/hnsw.py:32-42), so 2M rows take hours; past the
    # bounds use 'l2' or 'ivfpq' on the card. max_rows overrides.
    DEFAULT_MAX_ROWS = 100_000
    NATIVE_MAX_ROWS = 2_000_000

    def __init__(self, d: int, m: int = 16, ef_construction: int = 80,
                 ef_search: int = 64, seed: int = 0,
                 max_rows: Optional[int] = None, backend: str = "auto"):
        if backend not in ("auto", "native", "python"):
            raise ValueError(f"backend must be auto|native|python, got {backend!r}")
        self.d = d
        self.m = m
        self.m0 = 2 * m            # level-0 degree (FAISS convention)
        self.ef_construction = ef_construction
        self.ef_search = ef_search
        self._native = None
        if backend != "python":
            from grafp_tpu_torch.native.hnsw_native import HNSWNative

            self._native = HNSWNative(d, m=m, ef_construction=ef_construction, seed=seed)
        if max_rows is None:
            max_rows = (self.NATIVE_MAX_ROWS if self._native is not None
                        else self.DEFAULT_MAX_ROWS)
        self.max_rows = max_rows
        self.mult = 1.0 / math.log(m)
        self.rng = np.random.RandomState(seed)
        self.vectors: Optional[np.ndarray] = None
        self.levels: List[int] = []
        # neighbors[level][node] -> list of ids
        self.neighbors: List[List[List[int]]] = []
        self.entry: int = -1
        self.max_level: int = -1
        self.ntotal = 0
        self.nprobe = 20  # unused; factory contract
        self.is_trained = True

    # ---- internals ----
    def _dist(self, q: np.ndarray, ids) -> np.ndarray:
        v = self.vectors[np.asarray(ids, np.int64)]
        diff = v - q[None, :]
        return np.einsum("ij,ij->i", diff, diff)

    def _search_layer(self, q: np.ndarray, entry: int, ef: int,
                      level: int) -> List[Tuple[float, int]]:
        """Beam search; returns [(dist, id)] of up to ef closest."""
        d0 = float(self._dist(q, [entry])[0])
        visited = {entry}
        cand = [(d0, entry)]               # min-heap by dist
        best = [(-d0, entry)]              # max-heap of current ef best
        nbrs_l = self.neighbors[level]
        while cand:
            dc, c = heapq.heappop(cand)
            if dc > -best[0][0]:
                break
            nbrs = [n for n in nbrs_l[c] if n not in visited]
            if nbrs:
                visited.update(nbrs)
                ds = self._dist(q, nbrs)
                for dn, n in zip(ds, nbrs):
                    dn = float(dn)
                    if dn < -best[0][0] or len(best) < ef:
                        heapq.heappush(cand, (dn, n))
                        heapq.heappush(best, (-dn, n))
                        if len(best) > ef:
                            heapq.heappop(best)
        return sorted((-nd, i) for nd, i in best)

    def _greedy(self, q: np.ndarray, entry: int, level: int) -> int:
        cur = entry
        cur_d = float(self._dist(q, [cur])[0])
        improved = True
        while improved:
            improved = False
            nbrs = self.neighbors[level][cur]
            if nbrs:
                ds = self._dist(q, nbrs)
                j = int(np.argmin(ds))
                if ds[j] < cur_d:
                    cur, cur_d = nbrs[j], float(ds[j])
                    improved = True
        return cur

    # ---- public API (factory contract) ----
    def train(self, data) -> None:
        pass

    def add(self, data) -> None:
        data = np.ascontiguousarray(np.asarray(data, np.float32))
        if self.ntotal + len(data) > self.max_rows:
            raise ValueError(
                f"IndexHNSW: {self.ntotal + len(data):,} rows exceeds the "
                f"host-side construction bound of {self.max_rows:,} "
                "(sequential insertion); use index_type 'l2' (exact, on the "
                "card) or 'ivfpq' instead, or construct with max_rows=... to "
                "override")
        if self._native is not None:
            self._native.add(data)
            self.ntotal = self._native.ntotal
            return
        start = self.ntotal
        self.vectors = (data if self.vectors is None
                        else np.concatenate([self.vectors, data]))
        for i in range(len(data)):
            self._insert(start + i)
        self.ntotal = len(self.vectors)

    def _insert(self, idx: int) -> None:
        level = int(-math.log(max(self.rng.rand(), 1e-12)) * self.mult)
        self.levels.append(level)
        prev_max = self.max_level
        while self.max_level < level:
            self.max_level += 1
            self.neighbors.append([[] for _ in range(idx)])
        for lv in range(len(self.neighbors)):
            while len(self.neighbors[lv]) <= idx:
                self.neighbors[lv].append([])
        if self.entry < 0:
            self.entry = idx
            return
        q = self.vectors[idx]
        cur = self.entry
        for lv in range(prev_max, level, -1):
            cur = self._greedy(q, cur, lv)
        for lv in range(min(level, prev_max), -1, -1):
            found = self._search_layer(q, cur, self.ef_construction, lv)
            cap = self.m0 if lv == 0 else self.m
            chosen = [i for _, i in found[:cap]]
            self.neighbors[lv][idx] = chosen
            for n in chosen:
                lst = self.neighbors[lv][n]
                lst.append(idx)
                if len(lst) > cap:
                    ds = self._dist(self.vectors[n], lst)
                    keep = np.argsort(ds)[:cap]
                    self.neighbors[lv][n] = [lst[j] for j in keep]
            cur = found[0][1]
        if level > prev_max:
            self.entry = idx

    def search(self, q, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(Q, d) queries -> (Q, k) squared-L2 distances and int64 ids, on the
        host; ids of missing results are -1."""
        q = np.asarray(q, np.float32)
        if self._native is not None:
            return self._native.search(np.ascontiguousarray(q), k, ef_search=self.ef_search)
        nq = len(q)
        dists = np.full((nq, k), np.inf, np.float32)
        ids = np.full((nq, k), -1, np.int64)
        ef = max(self.ef_search, k)
        for r in range(nq):
            if self.entry < 0:
                continue
            cur = self.entry
            for lv in range(self.max_level, 0, -1):
                cur = self._greedy(q[r], cur, lv)
            found = self._search_layer(q[r], cur, ef, 0)[:k]
            for j, (dd, ii) in enumerate(found):
                dists[r, j] = dd
                ids[r, j] = ii
        return dists, ids

    def reconstruct_n(self, start: int, n: int) -> np.ndarray:
        if self._native is not None:
            return self._native.reconstruct_n(start, n)
        return np.asarray(self.vectors[start:start + n])
