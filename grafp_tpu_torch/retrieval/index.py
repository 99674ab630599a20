"""The index family on the card (port of ``grafp_tpu.retrieval.index``):
'l2' (flat exact), 'ivf' (IVFFlat, nlist = 400), 'ivfpq'
(n_centroids cells, 64 x 8-bit PQ), 'ivfpq-rr' (the same with a 4 x 4-bit
residual PQ re-rank), 'lsh' (256-bit random-hyperplane codes) and 'hnsw'
(on the host, ``retrieval/hnsw.py``), behind the reference's factory
contract: get_index(index_type, train_data, shape, max_nitem_train,
n_centroids) -> an index with .train / .add / .search(q, k) / .nprobe /
.ntotal (reference eval.py:9-123).

Every index but 'hnsw' scores dense blocks of rows with one engine
(``search.masked_scan_search``): rows stay in add order with a cell id
each, and IVF selectivity is a probe mask (a row is scored iff its cell
is among the query's nprobe nearest cells), so recall is exactly IVF's;
PQ storage is scanned through a decoded bf16 cache, or decoded per block
when the cache does not fit. ``scan_topk='approx'`` selects each block's
candidates approximately (``search.topk_approx``). Missing results are id
-1 with an infinite distance (FAISS's convention).

Several devices: ``get_index(..., mesh=)`` with a ``DeviceMesh`` whose 'db'
axis holds more than one device gives 'l2' as ``IndexFlatSharded`` and
attaches the mesh to the rest of the scan family ('ivf', 'ivfpq',
'ivfpq-rr', 'lsh'): the rows (or PQ codes), and the cell ids, are split
into equal shards, one a device, padded to a whole number of scan blocks
a shard, and searched by ``search.masked_scan_search_sharded`` (
``exact_topk_sharded`` for 'l2'). Results equal the single-device index's
up to ties. 'hnsw' stays on the host.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple, Union

import numpy as np
import torch

from grafp_tpu_torch.core.device import resolve_device
from grafp_tpu_torch.core.mesh import DB_AXIS, shard_rows
from grafp_tpu_torch.retrieval.kmeans import assign, kmeans
from grafp_tpu_torch.retrieval.pq import ProductQuantizer
from grafp_tpu_torch.retrieval.search import (
    DB_BLOCK_ROWS,
    exact_topk_sharded,
    masked_scan_search,
    masked_scan_search_sharded,
    topk_lower_first,
)
from grafp_tpu_torch.retrieval.hnsw import IndexHNSW

# rows per add() upload: 4M rows of 128 f32 are 2 GiB of host memory per
# step, so a memmap catalogue (fma_large's 30.6M rows, 15.7 GB) is read
# and uploaded in pieces; an 80 GB H100 holds the whole catalogue
_ADD_CHUNK = 1 << 22


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
        # each block's selection: 'exact' or 'approx' at scan_recall
        self.scan_topk = "exact"
        self.scan_recall = 0.99
        # a DeviceMesh whose 'db' axis shards the payload rows, or None
        self.mesh = None
        self._shards = None

    def _db_ndev(self) -> int:
        return 1 if self.mesh is None else int(self.mesh.shape.get(DB_AXIS, 1))

    def _row_block(self, n_rows: int) -> int:
        """The scan block of a payload of n_rows: the rows are padded to a
        multiple of block x ndev, so that every device's shard is a whole
        number of scan blocks."""
        return min(DB_BLOCK_ROWS, -(-max(n_rows, 1) // self._db_ndev()))

    def _put_rows(self, x: torch.Tensor, block: int, fill=0):
        """``x`` split by rows over the mesh's 'db' devices, each shard a
        multiple of ``block`` rows; pad rows hold ``fill``."""
        return shard_rows(x, self.mesh, DB_AXIS, multiple=block, fill=fill)

    def _shard_payload(self, rows, codebooks, cells, block: int):
        """(row shards, codebooks, cell shards or None) of a payload."""
        return (self._put_rows(rows, block), codebooks,
                None if cells is None else self._put_rows(cells, block, fill=-1))

    def _sharded_payload(self):
        """The payload's shards and scan block, cached per payload."""
        payload = self._payload()
        if self._shards is None or self._shards[0] is not payload:
            block = self._row_block(payload[0].shape[0])
            self._shards = (payload, self._shard_payload(*payload, block), block)
        return self._shards[1:]

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
        if self._db_ndev() > 1:
            (rows, codebooks, cells), block = self._sharded_payload()
            member = self._coarse_membership(qd) if cells is not None else None
            d, i = masked_scan_search_sharded(qd, rows, codebooks, cells, member,
                                              self.ntotal, k, block, self.scan_topk,
                                              self.scan_recall)
        else:
            rows, codebooks, cells = self._payload()
            member = self._coarse_membership(qd) if cells is not None else None
            d, i = masked_scan_search(qd, rows, codebooks, cells, member, self.ntotal,
                                      k, min(DB_BLOCK_ROWS, max(rows.shape[0], 1)),
                                      self.scan_topk, self.scan_recall)
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


class IndexFlatSharded(IndexFlat):
    """Exact L2 with the rows split over the 'db' devices of ``mesh``: a
    distance product and local top-k per device, one exact merge
    (``search.exact_topk_sharded``; ``grafp_tpu/retrieval/index.py:218-250``).
    The rows are padded to a multiple of the device count; ``m_valid``
    masks the padding. Same results as IndexFlat up to ties."""

    def __init__(self, d: int, device: torch.device, mesh):
        super().__init__(d, device)
        self.mesh = mesh

    def _search_chunk(self, q: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        (rows, _, _), _ = self._sharded_payload()
        d, i = exact_topk_sharded(torch.as_tensor(q, device=self.device), rows, k,
                                  m_valid=self.ntotal, scan_topk=self.scan_topk,
                                  recall_target=self.scan_recall)
        d, i = d.cpu().numpy(), i.cpu().numpy()
        return d, np.where(np.isinf(d), -1, i)

    def _row_block(self, n_rows: int) -> int:
        return 1                  # rows padded to a multiple of the shard count


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

    def _fits_decoded(self, n_rows: int) -> bool:
        """Whether n_rows fit the decoded cache; sharded, the budget is
        each device's, times the shard count."""
        return n_rows * self.d * 2 <= self.decoded_cache_budget() * self._db_ndev()

    def _payload(self):
        if self._cache is None:
            codes, cells = torch.cat(self._codes), torch.cat(self._cells)
            if self._db_ndev() == 1 and self._fits_decoded(codes.shape[0]):
                self._cache = (self._decode_bf16(codes), None, cells)
            else:            # sharded: each shard decodes on its own device
                self._cache = (codes, self.pq.codebooks, cells)
        return self._cache

    def _decode_bf16(self, codes: torch.Tensor) -> torch.Tensor:
        """The decoded bf16 cache, filled _ADD_CHUNK rows at a time: a
        one-shot decode holds int64 codes and f32 rows beside it, six
        times the cache (at fma_large's 31.1M rows the card peaked at
        68.21 GB with it, H100 80GB HBM3, 700 W)."""
        out = torch.empty((codes.shape[0], self.d), dtype=torch.bfloat16,
                          device=codes.device)
        for s in range(0, codes.shape[0], _ADD_CHUNK):
            out[s:s + _ADD_CHUNK] = self.pq.decode(codes[s:s + _ADD_CHUNK])
        return out

    def _shard_payload(self, codes, codebooks, cells, block: int):
        shards, _, cell_shards = super()._shard_payload(codes, codebooks, cells, block)
        if codebooks is None or not self._fits_decoded(codes.shape[0]):
            return shards, codebooks, cell_shards    # a decoded cache, or codes
        decoded = []
        for c in shards:
            cb = codebooks.to(c.device)
            sidx = torch.arange(cb.shape[0], device=c.device)
            decoded.append(cb[sidx[None, :], c.long()].reshape(c.shape[0], self.d)
                           .to(torch.bfloat16))
        return decoded, None, cell_shards

    def reconstruct_n(self, start: int, n: int) -> np.ndarray:
        codes = torch.cat(self._codes)[start:start + n]
        return self.pq.decode(codes).cpu().numpy()


class IndexIVFPQR(IndexIVFPQ):
    """IVFPQ with a residual re-rank (reference 'ivfpq-rr', M_refine = 4,
    nbits_refine = 4, eval.py:77-85; ``grafp_tpu/retrieval/index.py:385-456``):
    a second PQ encodes each row's residual x - pq_reconstruction; a search
    takes the k * k_factor best PQ candidates and re-scores them against
    (PQ + refine) reconstructions. The refine PQ trains from a generator
    seeded with ``seed + 2``. Both code arrays are kept on the host, where
    the re-rank gathers and decodes only the candidates' rows."""

    def __init__(self, d: int, nlist: int, device: torch.device,
                 code_sz: int = 64, nbits: int = 8, m_refine: int = 4,
                 nbits_refine: int = 4, k_factor: int = 4, seed: int = 0):
        super().__init__(d, nlist, device, code_sz, nbits, seed)
        self.refine = ProductQuantizer(d, m_refine, 2 ** nbits_refine)
        self.k_factor = k_factor
        self._rcodes = []
        self._rr_cache = None

    def train(self, data) -> None:
        super().train(data)
        x = torch.as_tensor(np.asarray(data, np.float32), device=self.device)
        res = x - self.pq.decode(self.pq.encode(x))
        self.refine.train(res, generator=torch.Generator().manual_seed(self.seed + 2))

    def add(self, data) -> None:
        for s in range(0, len(data), _ADD_CHUNK):
            chunk = np.asarray(data[s:s + _ADD_CHUNK], np.float32)
            super().add(chunk)                    # appends this chunk's PQ codes
            x = torch.as_tensor(chunk, device=self.device)
            res = x - self.pq.decode(self._codes[-1])
            self._rcodes.append(self.refine.encode(res).cpu().numpy())
        self._rr_cache = None

    def _host_code_arrays(self):
        """(PQ codes, refine codes) on the host, cached per add() epoch."""
        if self._rr_cache is None:
            self._rr_cache = (torch.cat(self._codes).cpu().numpy(),
                              np.concatenate(self._rcodes))
        return self._rr_cache

    def _search_chunk(self, q: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        d0, i0 = super()._search_chunk(q, k * self.k_factor)
        codes, rcodes = self._host_code_arrays()
        flat = np.maximum(i0, 0).reshape(-1)
        rec = (self.pq.decode_host(codes[flat])
               + self.refine.decode_host(rcodes[flat])).reshape(*i0.shape, -1)
        qd = torch.as_tensor(q, device=self.device)
        dist = torch.sum((qd[:, None, :] - torch.as_tensor(rec, device=self.device)) ** 2,
                         dim=-1)
        cand = torch.as_tensor(i0, device=self.device)
        dist.masked_fill_(cand < 0, float("inf"))
        nd, sel = topk_lower_first(-dist, k)
        d = (-nd).cpu().numpy()
        return d, np.where(np.isinf(d), -1, torch.gather(cand, 1, sel).cpu().numpy())


class IndexLSH(_BlockScanSearcher):
    """Random-hyperplane LSH, nbits = 256 (reference eval.py:71-74;
    ``grafp_tpu/retrieval/index.py:459-511``): a row's code is the sign of
    its projection on each plane, +-1 int8. Search runs on the shared block
    scan: the squared L2 distance between two +-1 codes is 4 x their Hamming
    distance (both norms are nbits), so the scan ranks by Hamming distance
    and the distances come back divided by 4. The planes are drawn from the
    index's own ``torch.Generator(seed)``; ``planes`` may also be set."""

    def __init__(self, d: int, device: torch.device, nbits: int = 256, seed: int = 0):
        super().__init__(device)
        self.d = d
        self.nbits = nbits
        self.planes = torch.randn(d, nbits, generator=torch.Generator().manual_seed(seed)
                                  ).to(device)
        self._codes = []
        self._cache = None

    def train(self, data) -> None:
        pass

    def _sign(self, x: torch.Tensor) -> torch.Tensor:
        proj = torch.matmul(x, self.planes)
        return torch.where(proj >= 0, 1, -1).to(torch.int8)

    def add(self, data) -> None:
        for s in range(0, len(data), _ADD_CHUNK):
            chunk = torch.as_tensor(np.asarray(data[s:s + _ADD_CHUNK], np.float32),
                                    device=self.device)
            self._codes.append(self._sign(chunk))
            self.ntotal += chunk.shape[0]
        self._cache = None

    def _payload(self):
        if self._cache is None:
            self._cache = (torch.cat(self._codes), None, None)
        return self._cache

    def search(self, q: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        qd = torch.as_tensor(np.asarray(q, np.float32), device=self.device)
        d, i = super().search(self._sign(qd).to(torch.float32).cpu().numpy(), k)
        return d / 4.0, i


def get_index(index_type: str, train_data, train_data_shape,
              max_nitem_train: float = 2e7, n_centroids: int = 64,
              scan_topk: str = "exact", scan_recall: float = 0.99,
              device: Optional[Union[str, torch.device]] = None, mesh=None):
    """Factory with the reference's contract (eval.py:9-123): build, train
    on (subsampled) data, set nprobe = 20, return, on ``device`` (None =
    the CUDA card). The reference's ``use_gpu`` is left out: ``device``
    decides. 'hnsw' runs on the host whatever ``device`` says, as the
    reference's CPU FAISS IndexHNSWFlat does (eval.py:90-98): a sequential
    graph walk, not a fallback. ``scan_topk`` ('exact' | 'approx') and
    ``scan_recall`` (in (0, 1]) set the block scan's selection; anything
    else raises ValueError, as does an unknown index type;
    'ivfpq-ondisk' raises NotImplementedError, as in the JAX package.
    ``mesh``: a ``DeviceMesh`` whose 'db' axis, when it holds more than
    one device, shards the rows: 'l2' is then ``IndexFlatSharded``, the
    rest of the scan family gets the mesh attached, and 'hnsw' ignores
    it. The index trains, and takes its rows, on ``device``."""
    if scan_topk not in ("exact", "approx"):
        raise ValueError(f"scan_topk must be 'exact' or 'approx', got {scan_topk!r}")
    if not 0.0 < float(scan_recall) <= 1.0:
        raise ValueError(f"scan_recall must be in (0, 1], got {scan_recall!r}")
    d = int(train_data_shape[1])
    mode = index_type.lower()
    if mode == "ivfpq-ondisk":
        raise NotImplementedError(mode)
    if mode not in ("l2", "ivf", "ivfpq", "ivfpq-rr", "lsh", "hnsw"):
        raise ValueError(mode)
    print(f"Creating index: {mode}")
    sharded = mesh is not None and mesh.shape.get(DB_AXIS, 1) > 1
    if mode == "hnsw":
        index = IndexHNSW(d, m=16, ef_construction=80)
    else:
        device = resolve_device(device)
        if mode == "l2" and sharded:
            index = IndexFlatSharded(d, device, mesh)
        elif mode == "l2":
            index = IndexFlat(d, device)
        elif mode == "ivf":
            index = IndexIVFFlat(d, 400, device)
        elif mode == "ivfpq":
            index = IndexIVFPQ(d, n_centroids, device, code_sz=64, nbits=8)
        elif mode == "ivfpq-rr":
            index = IndexIVFPQR(d, n_centroids, device, code_sz=64, nbits=8,
                                m_refine=4, nbits_refine=4)
        else:
            index = IndexLSH(d, device, nbits=256)
        index.scan_topk, index.scan_recall = scan_topk, float(scan_recall)
        if sharded:
            index.mesh = mesh
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
