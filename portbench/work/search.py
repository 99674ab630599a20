"""Catalogue search: ``rows`` random unit rows (fma_large's dummy rows and
db rows together) made on the card from the seed a piece at a time and
copied to the host once, an index from the program's ``get_index`` trained on the
configuration's ``max_nitem_train`` of them drawn from the seed, then
every row added. One
unit is one request: one query sequence of ``sl`` consecutive catalogue
rows (each of ``seq_lens`` equally often, in an order drawn from the
seed) from a seeded start, each row moved by
Gaussian noise of a norm drawn per request from ``noise``, renormalised,
and searched with one ``index.search(q, k)``. Closed loop, one client; a
request's latency runs from the call to its ids on the host.

Correctness: requests drawn from the seed, one of the longest among them,
are judged after the window: the reference makes the catalogue again
from the seed, trains its own cells and codebooks, codes every row, and for
each query row ranks its probed rows by the float64 distance to their
reconstructions. The gap of a returned id is its reference distance
less the reference's distance at the same rank.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.work.base import Work
from portbench.reference import ivfpq
from portbench.reference.ops import fp8_round
from portbench.yardstick.traffic import seed_words

CHUNK = 1 << 22       # catalogue rows drawn at a time


class Search(Work):

    def chunks(self):
        """The catalogue's (start, float32 unit rows) pieces of CHUNK rows,
        each drawn on the device from a generator seeded by the run's seed
        and its index, so that any piece can be made again alone."""
        n, d = int(self.traffic["rows"]), int(self.cfg["d"])
        for c, s in enumerate(range(0, n, CHUNK)):
            g = torch.Generator(device=self.device).manual_seed(seed_words(self.seed, 1000 + c))
            rows = torch.randn((min(CHUNK, n - s), d), generator=g, device=self.device)
            yield s, rows.div_(torch.linalg.vector_norm(rows, dim=1, keepdim=True))

    def train_ids(self) -> np.ndarray:
        rs = np.random.RandomState(seed_words(self.seed, 12))
        n = int(self.traffic["rows"])
        return np.sort(rs.choice(n, int(self.cfg["max_nitem_train"]), replace=False))

    def setup(self) -> None:
        from grafp_tpu_torch.retrieval.index import get_index

        t = self.traffic
        self.k, self.nprobe = int(t["k"]), int(self.cfg["nprobe"])
        with self.spans("setup.catalogue"):
            # the index adds from host arrays: the rows go to pinned memory once
            n, d = int(t["rows"]), int(self.cfg["d"])
            pinned = torch.empty((n, d), pin_memory=self.device.type == "cuda")
            for s, rows in self.chunks():
                pinned[s:s + rows.shape[0]].copy_(rows)
            host = pinned.numpy()
        with self.spans("setup.requests"):
            self.requests = self.make_requests(host)
        with self.spans("setup.index_train"):
            self.index = get_index(self.cfg["index_type"], host[self.train_ids()],
                                   (int(self.cfg["max_nitem_train"]), host.shape[1]),
                                   max_nitem_train=int(self.cfg["max_nitem_train"]),
                                   n_centroids=int(self.cfg["n_centroids"]), device=self.device)
            self.index.nprobe = self.nprobe
        with self.spans("setup.index_add"):
            self.index.add(host)
        del host
        with self.spans("setup.warm"):
            for sl in sorted({len(q) for q in self.requests}):
                self.index.search(next(q for q in self.requests if len(q) == sl), self.k)
        if self.fault == "alter_answer":
            inner = self.index.search

            def search(q, k):
                d, i = inner(q, k)
                i = i.copy()
                i[:, 0] = (i[:, 0] + 1) % self.index.ntotal
                return d, i

            self.index.search = search
        self.latency: List[float] = []
        self.answers: Dict[int, np.ndarray] = {}
        self.order: List[int] = []      # the request of each unit
        self.rows_queried = 0

    def make_requests(self, host: np.ndarray) -> List[np.ndarray]:
        """``requests`` query sequences, as the module says."""
        t = self.traffic
        rs = np.random.RandomState(seed_words(self.seed, 13))
        lens = [int(s) for s in t["seq_lens"]]
        n = int(t["requests"])
        # every seed sends the same lengths, as many of each, in its own order
        order = rs.permutation([lens[i % len(lens)] for i in range(n)])
        lo, hi = (float(x) for x in t["noise"])
        out = []
        for sl in order:
            start = rs.randint(0, host.shape[0] - sl)
            q = host[start:start + sl] + rs.uniform(lo, hi) / np.sqrt(host.shape[1]) * \
                rs.randn(sl, host.shape[1]).astype(np.float32)
            out.append((q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32))
        return out

    def useful_rows(self, ref) -> np.ndarray:
        """For each request, the catalogue rows in each query row's nprobe
        nearest cells, summed over its rows: the (query, row) pairs the
        request needs scored. Cells are the reference's (``ref``, built by
        ``check``), each row in its nearest, so that the count does not
        follow the program's own centroids."""
        c = ref.centroids
        half = 0.5 * torch.sum(c * c, dim=1)
        sizes = torch.bincount(ref.cells, minlength=c.shape[0]).to(torch.float64)
        q = torch.as_tensor(np.concatenate(self.requests), device=self.device)
        per_row = sizes[torch.topk(q @ c.T - half, self.nprobe, dim=1).indices].sum(1)
        ends = np.cumsum([len(r) for r in self.requests])
        parts = torch.tensor_split(per_row.cpu(), ends[:-1].tolist())
        return np.array([float(x.sum()) for x in parts])

    def unit(self) -> None:
        from time import perf_counter
        j = self.units % len(self.requests)
        q = self.requests[j]
        t0 = perf_counter()
        with self.spans("index_search"):
            _, ids = self.index.search(q, self.k)
        self.latency.append(perf_counter() - t0)
        self.answers.setdefault(j, ids)
        self.order.append(j)
        self.rows_queried += len(q)
        self.units += 1

    def end_to_end(self, window_s: float) -> Dict[str, float]:
        return {"search_p95_ms": 1e3 * float(np.percentile(self.latency, 95))}

    def counters(self) -> Dict[str, float]:
        return {"units": self.units, "rows_queried": self.rows_queried}

    def late_counters(self, first: int, last: int) -> Dict[str, float]:
        """``bound_s`` of units first..last-1: per request the least time
        of the work it needs, the larger of 2 d operations a probed
        (query, row) pair at the bf16 peak and each probed row's code
        read once (64 bytes) with the queries and the k results."""
        from portbench.yardstick.flops import BF16_OPS_S, HBM_BYTES_S
        d, bound = int(self.cfg["d"]), 0.0
        for j in self.order[first:last]:
            rows, useful = len(self.requests[j]), self.useful[j]
            t_bytes = (useful / rows * 64 + rows * d * 4 + rows * self.k * 12) / HBM_BYTES_S
            bound += max(2 * d * useful / BF16_OPS_S, t_bytes)
        return {"bound_s": bound}

    def release(self) -> None:
        del self.index
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> List[dict]:
        rs = np.random.RandomState(seed_words(self.seed, 17))
        answered = sorted(self.answers)
        longest = max(answered, key=lambda j: len(self.requests[j]))
        rest = [j for j in answered if j != longest]
        n = min(int(self.traffic["check_requests"]) - 1, len(rest))
        picked = [longest] + [rest[i] for i in rs.choice(len(rest), n, replace=False)]
        ids = torch.as_tensor(self.train_ids(), device=self.device)
        train = torch.cat([rows[ids[(ids >= s) & (ids < s + rows.shape[0])] - s]
                           for s, rows in self.chunks()])
        ref = ivfpq.Index(train, int(self.cfg["n_centroids"]))
        for _, rows in self.chunks():
            ref.add(rows)
        self.useful = self.useful_rows(ref)
        gap, missing = 0.0, 0
        for j in picked:
            for r, q in enumerate(torch.as_tensor(self.requests[j], device=self.device)):
                want, want_d, cand = ref.search_row(q, self.nprobe, self.k)
                if self.control:
                    got = ref.search_row(q, self.nprobe, self.k, rounding=fp8_round)[0]
                else:
                    got = torch.as_tensor(self.answers[j][r], device=self.device)
                inside = torch.isin(got, cand)
                missing += int((~inside).sum()) + self.k - int(got.shape[0])
                got_d = ref.distances(q, got[inside])
                if got_d.numel():
                    gap = max(gap, float((got_d - want_d[inside]).max()))
        return [{"name": "ids_outside_probe", "value": missing},
                {"name": "rank_gap_max", "value": gap}]
