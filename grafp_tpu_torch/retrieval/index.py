"""The index family on the card (port of ``grafp_tpu.retrieval.index``,
single device): 'l2' (flat exact), 'ivf' (IVFFlat, nlist = 400) and
'ivfpq' (n_centroids cells, 64 x 8-bit PQ), behind the reference's
factory contract: get_index(index_type, train_data, shape,
max_nitem_train, n_centroids) -> an index with .train / .add /
.search(q, k) / .nprobe / .ntotal (reference eval.py:9-123).

Every index scores dense blocks of rows with one engine
(``search.masked_scan_search``): rows stay in add order with a cell id
each, and IVF selectivity is a probe mask (a row is scored iff its cell
is among the query's nprobe nearest cells), so recall is exactly IVF's;
PQ storage is scanned through a decoded bf16 cache, or decoded per block
when the cache does not fit. Missing results are id -1 with an infinite distance (FAISS's
convention).
"""

from __future__ import annotations

import time
from typing import Optional, Tuple, Union

import numpy as np
import torch

from grafp_tpu_torch.core.device import resolve_device
from grafp_tpu_torch.retrieval.kmeans import assign, kmeans
from grafp_tpu_torch.retrieval.pq import ProductQuantizer
from grafp_tpu_torch.retrieval.search import (
    DB_BLOCK_ROWS,
    masked_scan_search,
    topk_lower_first,
)

# rows per add() upload: 4M rows of 128 f32 are 2 GiB of host memory per
# step, so a memmap catalogue (fma_large's 30.6M rows, 15.7 GB) is read
# and uploaded in pieces; an 80 GB H100 holds the whole catalogue
_ADD_CHUNK = 1 << 22
# index types of the JAX package that the port has not taken yet
_LATER = ("ivfpq-rr", "lsh", "hnsw")


class _BlockScanSearcher:
    """Shared search: query chunks through ``masked_scan_search``."""

    # Queries per scan call. With DB_BLOCK_ROWS rows a block, 1024 queries
    # peaked at 22.4 GiB of distances and selection keys and searched 6 %
    # faster than 256 (7.4 GiB) on an H100 80GB HBM3 at 700 W
    # (chip_smoke.py); the eval's 9,500-row batches go through in ten
    # calls.
    QUERY_CHUNK = 1024

    def __init__(self, device: torch.device):
        self.device = device
        self.nprobe = 20
        self.ntotal = 0
        self.is_trained = True

    def _payload(self):
        """(rows_or_codes (M, *), codebooks or None, cells or None) on the
        card, cached per add() epoch."""
        raise NotImplementedError

    def _coarse_membership(self, q: torch.Tensor) -> Optional[torch.Tensor]:
        """(Q, nlist) bool: is cell c probed by query q. None = no IVF."""
        return None

    def search(self, q: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(Q, d) queries -> (Q, k) f32 distances and int64 ids, on the
        host; ids of missing results are -1."""
        q = np.asarray(q, np.float32)
        ds, ids = [], []
        for s in range(0, len(q), self.QUERY_CHUNK):
            d, i = self._search_chunk(q[s:s + self.QUERY_CHUNK], k)
            ds.append(d)
            ids.append(i)
        return np.concatenate(ds), np.concatenate(ids)

    def _search_chunk(self, q: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        qd = torch.as_tensor(q, device=self.device)
        rows, codebooks, cells = self._payload()
        member = self._coarse_membership(qd) if cells is not None else None
        d, i = masked_scan_search(qd, rows, codebooks, cells, member, self.ntotal,
                                  k, min(DB_BLOCK_ROWS, max(rows.shape[0], 1)))
        d, i = d.cpu().numpy(), i.cpu().numpy()
        return d, np.where(np.isinf(d), -1, i)


class IndexFlat(_BlockScanSearcher):
    """Exact L2 (reference 'l2'; FAISS IndexFlatL2)."""

    def __init__(self, d: int, device: torch.device):
        super().__init__(device)
        self.d = d
        self._rows = []
        self._cache = None

    def train(self, data) -> None:   # a flat index trains nothing (eval.py:118)
        pass

    def add(self, data) -> None:
        for s in range(0, len(data), _ADD_CHUNK):
            chunk = np.asarray(data[s:s + _ADD_CHUNK], np.float32)
            self._rows.append(torch.as_tensor(chunk, device=self.device))
            self.ntotal += len(chunk)
        self._cache = None

    def _payload(self):
        if self._cache is None:
            self._cache = (torch.cat(self._rows), None, None)
        return self._cache

    def reconstruct_n(self, start: int, n: int) -> np.ndarray:
        return self._payload()[0][start:start + n].cpu().numpy()


class IndexIVFFlat(IndexFlat):
    """Coarse k-means cells + probe-masked exact scan (reference 'ivf',
    nlist = 400, eval.py:61-64). ``train`` draws from a generator seeded
    with ``seed``; ``centroids`` may also be set directly."""

    def __init__(self, d: int, nlist: int, device: torch.device, seed: int = 0):
        super().__init__(d, device)
        self.nlist = nlist
        self.seed = seed
        self.centroids: Optional[torch.Tensor] = None
        self.is_trained = False
        self._cells = []

    def train(self, data) -> None:
        data = torch.as_tensor(np.asarray(data, np.float32), device=self.device)
        self.centroids, _ = kmeans(data, self.nlist,
                                   generator=torch.Generator().manual_seed(self.seed))
        self.is_trained = True

    def _assign_chunks(self, data):
        """(chunk on the card, its cells) per _ADD_CHUNK rows of ``data``."""
        if not self.is_trained:
            raise RuntimeError("train the index before add")
        for s in range(0, len(data), _ADD_CHUNK):
            chunk = torch.as_tensor(np.asarray(data[s:s + _ADD_CHUNK], np.float32),
                                    device=self.device)
            yield chunk, assign(chunk, self.centroids)

    def add(self, data) -> None:
        for chunk, cells in self._assign_chunks(data):
            self._rows.append(chunk)
            self._cells.append(cells)
            self.ntotal += chunk.shape[0]
        self._cache = None

    def _payload(self):
        if self._cache is None:
            self._cache = (torch.cat(self._rows), None, torch.cat(self._cells))
        return self._cache

    def _coarse_membership(self, q):
        score = torch.matmul(q, self.centroids.T)
        score -= 0.5 * torch.sum(self.centroids * self.centroids, dim=1)[None, :]
        probed = topk_lower_first(score, min(self.nprobe, self.nlist))[1]
        member = torch.zeros((q.shape[0], self.nlist), dtype=torch.bool,
                             device=q.device)
        return member.scatter_(1, probed, True)


class IndexIVFPQ(IndexIVFFlat):
    """IVF cells + PQ-compressed storage (reference 'ivfpq': n_centroids
    cells, code_sz = 64, nbits = 8, eval.py:65-69). The PQ trains from a
    generator seeded with ``seed + 1``; search scans a decoded bf16 cache
    of the codes (2 bytes a dimension) when it fits
    ``decoded_cache_budget``, else decodes each block from the codes."""

    def __init__(self, d: int, nlist: int, device: torch.device,
                 code_sz: int = 64, nbits: int = 8, seed: int = 0):
        super().__init__(d, nlist, device, seed)
        self.pq = ProductQuantizer(d, code_sz, 2 ** nbits)
        self._codes = []

    def train(self, data) -> None:
        super().train(data)
        data = torch.as_tensor(np.asarray(data, np.float32), device=self.device)
        self.pq.train(data, generator=torch.Generator().manual_seed(self.seed + 1))

    def add(self, data) -> None:
        for chunk, cells in self._assign_chunks(data):
            self._codes.append(self.pq.encode(chunk))
            self._cells.append(cells)
            self.ntotal += chunk.shape[0]
        self._cache = None

    def decoded_cache_budget(self) -> int:
        """Bytes the decoded bf16 cache may take: the card's memory less the
        scan's transient (QUERY_CHUNK x DB_BLOCK_ROWS pairs at 22 bytes,
        as measured) and 16 GiB for the rescoring DB and the runtime;
        unbounded on the CPU."""
        if self.device.type != "cuda":
            return 1 << 62
        total = torch.cuda.get_device_properties(self.device).total_memory
        transient = self.QUERY_CHUNK * DB_BLOCK_ROWS * 22
        return max(total - transient - (16 << 30), 1 << 30)

    def _payload(self):
        if self._cache is None:
            codes, cells = torch.cat(self._codes), torch.cat(self._cells)
            if codes.shape[0] * self.d * 2 <= self.decoded_cache_budget():
                self._cache = (self.pq.decode(codes).to(torch.bfloat16), None, cells)
            else:
                self._cache = (codes, self.pq.codebooks, cells)
        return self._cache

    def reconstruct_n(self, start: int, n: int) -> np.ndarray:
        codes = torch.cat(self._codes)[start:start + n]
        return self.pq.decode(codes).cpu().numpy()


def get_index(index_type: str, train_data, train_data_shape,
              max_nitem_train: float = 2e7, n_centroids: int = 64,
              scan_topk: str = "exact",
              device: Optional[Union[str, torch.device]] = None):
    """Factory with the reference's contract (eval.py:9-123): build, train
    on (subsampled) data, set nprobe = 20, return, on ``device`` (None =
    the CUDA card). The reference's ``use_gpu`` is left out: ``device``
    decides.

    'ivfpq-rr', 'lsh' and 'hnsw' are not ported yet, and neither is
    ``scan_topk='approx'`` (``lax.approx_max_k`` has no PyTorch
    counterpart): they raise NotImplementedError."""
    if scan_topk != "exact":
        raise NotImplementedError(
            f"scan_topk={scan_topk!r}: the port selects exactly; "
            "lax.approx_max_k has no PyTorch counterpart")
    device = resolve_device(device)
    d = int(train_data_shape[1])
    mode = index_type.lower()
    print(f"Creating index: {mode}")
    if mode == "l2":
        index = IndexFlat(d, device)
    elif mode == "ivf":
        index = IndexIVFFlat(d, 400, device)
    elif mode == "ivfpq":
        index = IndexIVFPQ(d, n_centroids, device, code_sz=64, nbits=8)
    elif mode in _LATER:
        raise NotImplementedError(
            f"index {mode!r} is not ported yet (ROADMAP.md queue A, the "
            "remaining index types)")
    else:
        raise ValueError(mode)
    start = time.time()
    n = len(train_data)
    if n > max_nitem_train:
        print("Training index using {:>3.2f} % of data...".format(
            100.0 * max_nitem_train / n))
        sel = np.random.permutation(n)[: int(max_nitem_train)]
        index.train(train_data[np.sort(sel)])
    else:
        print("Training index...")
        index.train(np.asarray(train_data))
    print("Elapsed time: {:.2f} seconds.".format(time.time() - start))
    index.nprobe = 20
    return index
