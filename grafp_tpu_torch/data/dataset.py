"""Host-side dataset and loaders (port of ``grafp_tpu.data.dataset``; the
reference's NeuralfpDataset + torch DataLoader role, modules/data.py:15-117).

Semantics kept from the reference:
  * decode -> mono downmix -> sinc resample to fs (data.py:45-57);
  * train: a random region of offset*fs + dur*fs samples, two
    independent 1-s crops from it (the temporal-offset positive pair,
    data.py:67-80), silence rejection (max |x| < silence -> next track,
    data.py:82-84), amplitude normalisation by the 0.95-quantile of the
    FULL track (data.py:86-89), pad/truncate to exactly dur*fs;
  * val/test: the whole resampled track;
  * failure budget: per-index error counts; a track is ignored for good
    after error_threshold failures; a failure skips to the next index
    (data.py:37-52).

The corruption (IR + noise) runs on the card inside the train step
(``dsp/augment.py``), so the host only decodes and crops. Prefetch is a
thread pool that does numpy work only: every CUDA call, the copy of a
batch to the card included, stays on the thread that iterates the
batcher (the CUDA kernels set per-shape launch limits process-wide and
need the calling thread's context).
"""

from __future__ import annotations

import os
import queue
import struct
import threading
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from grafp_tpu_torch.core.mesh import local_batch_size
from grafp_tpu_torch.data.audio_io import AudioDecodeError, load_audio
from grafp_tpu_torch.data.indexing import load_index
from grafp_tpu_torch.data.resample import resample_sinc
from grafp_tpu_torch.dsp.augment import AugmentBanks


def qtile_norm(y: np.ndarray, q: float, eps: float = 1e-8) -> float:
    """Reference util.py:99-100."""
    return eps + float(np.quantile(np.abs(y), q))


class FingerprintDataset:
    """Index-addressable track source with the reference's failure budget."""

    def __init__(self, cfg, path: str, train: bool = False,
                 seed: Optional[int] = None, cache_decoded: bool = False,
                 cache_dir: Optional[str] = None):
        self.cfg = cfg
        self.train = train
        self.norm = cfg["norm"]
        self.offset = cfg["offset"]
        self.sample_rate = cfg["fs"]
        self.dur = cfg["dur"]
        self.silence = cfg["silence"]
        self.error_threshold = cfg["error_threshold"]
        self.filenames: Dict[str, str] = load_index(
            cfg, path, mode="train" if train else "valid"
        )
        print(f"Loaded {len(self.filenames)} files from {path}")
        self.ignore_idx: set = set()
        self.error_counts: Dict[int, int] = {}
        self._errors_lock = threading.Lock()
        # Every train crop comes from a FRESH RandomState derived from
        # (seed, epoch, track index), so batch contents do not depend on
        # which PairBatcher thread decoded the track (the reference pins
        # its crops by seeding its DataLoader workers).
        self.seed = (int(seed) if seed is not None
                     else int(np.random.randint(0, 2 ** 31 - 1)))
        self.epoch = 0
        # Decode-once caches (both off by default): the reference decodes
        # and resamples every track every epoch.
        #   cache_decoded: an in-RAM dict; epoch 2 on is decode-free.
        #   cache_dir: each decoded track is written once as
        #     <cache_dir>/<idx>.npy and memmapped thereafter, across
        #     processes too.
        self.cache_decoded = cache_decoded
        self._cache: Dict[int, np.ndarray] = {}
        self._norm: Dict[int, float] = {}  # full-track qtile per track
        self.cache_dir = cache_dir
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)

    def __len__(self) -> int:
        return len(self.filenames)

    def _cache_path(self, idx: int) -> str:
        return os.path.join(self.cache_dir, f"{idx}.npy")

    def _norm_path(self, idx: int) -> str:
        return os.path.join(self.cache_dir, f"{idx}.norm.npy")

    def _atomic_save(self, path: str, arr) -> None:
        # tmp + rename: PairBatcher worker threads may decode the same
        # track concurrently on the first epoch
        tmp = path + f".tmp{threading.get_ident()}"
        with open(tmp, "wb") as f:
            np.save(f, arr)
        os.replace(tmp, path)

    def _load_track(self, idx: int) -> Optional[np.ndarray]:
        if self.cache_decoded and idx in self._cache:
            return self._cache[idx]
        if self.cache_dir:
            try:
                return np.load(self._cache_path(idx), mmap_mode="r")
            except (OSError, ValueError):
                pass  # not cached yet (or a torn write): decode below
        try:
            audio, sr = load_audio(self.filenames[str(idx)])
        # Decode and IO failures only (the reference's budget covers decode
        # errors, modules/data.py:37-52); a programming error in the decode
        # path must not turn into a silently skipped track. struct.error,
        # ValueError and EOFError are what malformed containers raise out
        # of the Python RIFF and ffmpeg readers.
        except (AudioDecodeError, OSError, KeyError, ValueError,
                EOFError, struct.error):
            print(f"Error loading: {self.filenames.get(str(idx), idx)}")
            with self._errors_lock:
                self.error_counts[idx] = self.error_counts.get(idx, 0) + 1
                if self.error_counts[idx] > self.error_threshold:
                    self.ignore_idx.add(idx)
            return None
        out = resample_sinc(audio, sr, self.sample_rate)
        if self.cache_decoded:
            self._cache[idx] = out
        if self.cache_dir:
            self._atomic_save(self._cache_path(idx), out)
            if self.train and self.norm is not None:
                # a sidecar norm: a fresh process reading the cache pays
                # no full-track quantile per track
                nv = qtile_norm(out, q=self.norm)
                self._norm[idx] = nv
                self._atomic_save(self._norm_path(idx), np.float64(nv))
        return out

    def __getitem__(self, idx: int):
        """Train: (x_i, x_j) float32 (clip_frames,). Val: full track."""
        for attempt in range(len(self.filenames)):
            j = (idx + attempt) % len(self.filenames)
            if j in self.ignore_idx:
                continue
            out = self._get_one(j)
            if out is not None:
                return out
        raise RuntimeError("no loadable tracks in dataset")

    def _crop_rng(self, idx: int) -> np.random.RandomState:
        """Fresh RandomState for (seed, epoch, idx): draws are identical
        regardless of which PairBatcher thread lands on the track."""
        return np.random.RandomState(
            np.random.SeedSequence(
                [self.seed, self.epoch, idx]).generate_state(4)
        )

    def _get_one(self, idx: int):
        audio = self._load_track(idx)
        if audio is None:
            return None
        clip = int(self.sample_rate * self.dur)
        if len(audio) <= clip:
            return None
        if not self.train:
            return audio

        offset_mod = int(self.sample_rate * self.offset + clip)
        if len(audio) <= offset_mod:
            return None
        rng = self._crop_rng(idx)
        r = rng.randint(0, len(audio) - offset_mod)
        ri = rng.randint(0, offset_mod - clip)
        rj = rng.randint(0, offset_mod - clip)
        region = audio[r:r + offset_mod]
        x_i = region[ri:ri + clip]
        x_j = region[rj:rj + clip]
        if np.abs(x_i).max() < self.silence or np.abs(x_j).max() < self.silence:
            return None  # silence -> try the next track (data.py:82-84)
        if self.norm is not None:
            # the 0.95-quantile of the FULL track (reference data.py:86-89)
            # depends only on the track: once per process, not per epoch
            nv = self._norm.get(idx)
            if nv is None and self.cache_dir:
                try:
                    nv = float(np.load(self._norm_path(idx)))
                    self._norm[idx] = nv
                except (OSError, ValueError):
                    nv = None
            if nv is None:
                nv = qtile_norm(audio, q=self.norm)
                self._norm[idx] = nv
            x_i = x_i / nv
            x_j = x_j / nv

        def fit(x):
            if len(x) < clip:
                return np.pad(x, (0, clip - len(x)))
            return x[:clip]

        return fit(x_i).astype(np.float32), fit(x_j).astype(np.float32)


class PairBatcher:
    """Shuffled, drop-last (B, T) pair batches of numpy arrays with
    threaded prefetch (the reference's DataLoader(shuffle=True, workers=8,
    drop_last=True), train.py:125-127). The batch order of an epoch is a
    permutation seeded by ``seed + epoch``; ``epoch`` counts the
    iterations begun, so a resumed run sets it to the epochs done.

    ``shard`` = (rank, ranks) makes each batch this data-parallel rank's
    rows of the global ``batch_size`` batch, rows [rank b, (rank + 1) b)
    with b = batch_size / ranks: the same tracks and crops as one process
    reads there (a crop depends on the track and the epoch only), and only
    they are decoded."""

    def __init__(self, dataset: FingerprintDataset, batch_size: int,
                 seed: int = 0, num_threads: int = 4, prefetch: int = 2,
                 shard: Tuple[int, int] = (0, 1)):
        rank, ranks = shard
        self.ds = dataset
        self.global_bsz = batch_size
        self.bsz = local_batch_size(batch_size, ranks)
        self.rank = rank
        self.seed = seed
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.ds) // self.global_bsz

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = np.random.RandomState(self.seed + self.epoch).permutation(
            len(self.ds)
        )
        # pin the dataset's crop RNG to this epoch so worker threads draw
        # the same crops whatever the interleave
        self.ds.epoch = self.epoch
        self.epoch += 1
        n_batches = len(self)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        idx_q: "queue.Queue" = queue.Queue()
        for b in range(n_batches):
            rows = order[b * self.global_bsz:(b + 1) * self.global_bsz]
            idx_q.put((b, rows[self.rank * self.bsz:(self.rank + 1) * self.bsz]))
        results: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        lock = threading.Lock()
        next_emit = [0]
        failed = threading.Event()

        def worker():
            # A worker's exception is a poison pill: it goes straight onto
            # out_q (past the in-order buffer; the consumer aborts on
            # sight) and stops every worker from taking new batches, so the
            # consumer never waits on out_q.get() for a batch that will
            # not come.
            while not failed.is_set():
                try:
                    b, ids = idx_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    xi = np.empty(
                        (self.bsz, self.ds.cfg.clip_frames), np.float32
                    )
                    xj = np.empty_like(xi)
                    for row, i in enumerate(ids):
                        xi[row], xj[row] = self.ds[int(i)]
                except BaseException as e:  # noqa: BLE001 - re-raised by the consumer
                    failed.set()
                    out_q.put(e)
                    return
                with lock:
                    results[b] = (xi, xj)
                    while next_emit[0] in results:
                        out_q.put(results.pop(next_emit[0]))
                        next_emit[0] += 1

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(min(self.num_threads, max(n_batches, 1)))
        ]
        for t in threads:
            t.start()
        for _ in range(n_batches):
            item = out_q.get()
            if isinstance(item, BaseException):
                raise RuntimeError(
                    "PairBatcher worker failed while building a batch"
                ) from item
            yield item


class TrackLoader:
    """Full tracks one at a time for the given indices (the bsz=1 sampler
    loaders of the reference, train.py:144-156, test_fp.py:258-270). The
    DB builders read it through ``.ds`` and ``.indices``."""

    def __init__(self, dataset: FingerprintDataset, indices: Sequence[int]):
        if dataset.train:
            raise ValueError("TrackLoader reads whole tracks: pass a "
                             "dataset made with train=False")
        self.ds = dataset
        self.indices = list(int(i) for i in indices)

    def __len__(self) -> int:
        return len(self.indices)

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in self.indices:
            yield self.ds[i]


def build_augment_banks(
    noise_paths: Sequence[str],
    ir_paths: Sequence[str],
    fs: int,
    noise_len_s: float = 2.0,
    ir_len_s: float = 2.0,
    max_noise: int = 512,
    max_ir: int = 256,
    seed: int = 0,
) -> AugmentBanks:
    """Decode noise and IR corpora into fixed-shape banks
    (``dsp.augment.AugmentBanks``, on the CPU; the train step and the
    builders move them to their device). Corpora larger than max_* are
    subsampled with the reference's seed-42 convention."""
    rng = np.random.RandomState(42 if seed == 0 else seed)

    def _load_some(paths, cap):
        paths = list(paths)
        if len(paths) > cap:
            paths = [paths[i] for i in rng.permutation(len(paths))[:cap]]
        clips = []
        for p in paths:
            try:
                x, sr = load_audio(p)
            except (AudioDecodeError, OSError):
                continue
            clips.append(resample_sinc(x, sr, fs))
        return clips

    noise = _load_some(noise_paths, max_noise) if noise_paths else []
    irs = _load_some(ir_paths, max_ir) if ir_paths else []
    return AugmentBanks.from_arrays(
        noise_clips=noise or None,
        ir_clips=irs or None,
        noise_len=int(noise_len_s * fs),
        ir_len=int(ir_len_s * fs),
    )
