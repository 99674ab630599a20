"""Fingerprint pipeline and database builders (port of
``grafp_tpu.fp.builder``; reference test_fp.py:87-158, generate.py:34-57).

The pipeline serves through a BatchNorm-folded copy of the model
(``models/fold_bn.py``) on the card, of any arch: the baselines, which
have no BatchNorm, serve as they are. Track lengths are bucketed as in the
reference pipeline: the true track is reflect-padded with its own
samples, zero-filled up to the next multiple of ``bucket_s`` seconds, and
only the reference-defined segments are kept, so every fingerprint equals
an unbucketed computation.

The builders pack up to ``build_pack`` consecutive tracks of one bucket
length into one log-mel call and one run of full ``batch_size`` embed
batches, and stream the fingerprints, strictly in track order, into the
reference's float32 memmaps (``retrieval/memmap_io.MemmapWriter``): row
order is the eval's ground truth. Query corruption (IR, then noise at
val_snr, reference transformations.py:34-48,97-109) runs on the card
through ``dsp.augment.augment_with_draws``, with each track's draws taken
explicitly (``track_corruption_draws``).
"""

from __future__ import annotations

import math
import os
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from grafp_tpu_torch.core.device import resolve_device
from grafp_tpu_torch.dsp.augment import (
    AugmentBanks,
    AugmentDraws,
    augment_with_draws,
    sample_augment_draws,
)
from grafp_tpu_torch.dsp.melspec import LogMelConfig, log_mel_spectrogram
from grafp_tpu_torch.dsp.segment import num_segments, unfold_segments
from grafp_tpu_torch.models.fold_bn import fold_batch_norms
from grafp_tpu_torch.retrieval.memmap_io import MemmapWriter

# Tracks per packed call when the Config sets no build_pack. On an H100
# 80GB HBM3 at 700 W, building 96 tracks of 20-40 s ran 1-4 % faster at
# pack 8 than at pack 1 (a track's last, partial batch is shared;
# chip_smoke.py).
DEFAULT_BUILD_PACK = 8


class FingerprintPipeline:
    """Serving and DB-build entry points around a BatchNorm-folded copy of
    an eval-mode SimCLRModel on ``device`` (None = the CUDA card)."""

    def __init__(self, model, cfg, batch_size: int = 256,
                 bucket_s: float = 10.0,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.model = fold_batch_norms(model.to(self.device))
        self.cfg = cfg
        self.batch_size = batch_size
        self.fs = int(cfg["fs"])
        self.bucket = int(bucket_s * self.fs)
        self.n_fft = int(cfg["n_fft"])
        self.hop = int(cfg["hop_len"])
        self.n_frames = int(cfg["n_frames"])
        self.step = cfg.seg_hop_frames
        self.d = int(cfg["d"])
        self.val_snr = tuple(float(s) for s in cfg["val_snr"])
        self.build_pack = max(1, int(cfg.get("build_pack") or DEFAULT_BUILD_PACK))
        self.mcfg = LogMelConfig.from_config(cfg)
        self.mcfg_nopad = LogMelConfig(
            sample_rate=self.mcfg.sample_rate, n_fft=self.mcfg.n_fft,
            win_length=self.mcfg.win_length, hop_length=self.mcfg.hop_length,
            n_mels=self.mcfg.n_mels, center=False,
        )

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def _pack(self, pack: Optional[int]) -> int:
        return self.build_pack if pack is None else max(1, int(pack))

    @torch.inference_mode()
    def embed(self, spec) -> torch.Tensor:
        """(B, n_mels, n_frames) log-mel -> (B, d) f32 fingerprints."""
        _, z = self.model(self._tensor(spec))
        return z.to(torch.float32)

    def _embed_batches(self, segs: torch.Tensor) -> torch.Tensor:
        """(S, n_mels, n_frames) -> (S, d), in batches of batch_size."""
        return torch.cat([self.embed(segs[i:i + self.batch_size])
                          for i in range(0, segs.shape[0], self.batch_size)])

    @torch.inference_mode()
    def fingerprint_waves(self, waves) -> torch.Tensor:
        """(B, clip samples) 1-s waves -> (B, d) fingerprints: centered
        log-mel, then the model."""
        return self.embed(log_mel_spectrogram(self._tensor(waves), self.mcfg))

    # -- per-track spectrogram, exact tail semantics --------------------
    def _pad_track(self, wave: np.ndarray) -> Tuple[np.ndarray, int]:
        """Reflect-pad true samples + zero-fill to the length bucket;
        returns (padded (1, L), n_true_segments)."""
        t = len(wave)
        n_true_frames = 1 + t // self.hop
        pad = self.n_fft // 2
        w = np.concatenate([wave[pad:0:-1], wave, wave[-2:-pad - 2:-1]])
        bucket_len = pad * 2 + max(
            self.bucket, int(math.ceil(t / self.bucket)) * self.bucket
        )
        if len(w) < bucket_len:
            w = np.pad(w, (0, bucket_len - len(w)))
        s_true = num_segments(n_true_frames, self.n_frames, self.step)
        return w[None, :], s_true

    @torch.inference_mode()
    def track_logmel(self, wave: np.ndarray) -> np.ndarray:
        """(T,) float32 -> (n_mels, 1 + T//hop) log-mel, identical to the
        centered computation on the unbucketed track."""
        wave = np.asarray(wave, np.float32)
        padded, _ = self._pad_track(wave)
        n_true_frames = 1 + len(wave) // self.hop
        mel = log_mel_spectrogram(self._tensor(padded), self.mcfg_nopad)
        return mel[0, :, :n_true_frames].cpu().numpy()

    def segments_for(self, wave: np.ndarray) -> np.ndarray:
        """(T,) -> (S, n_mels, n_frames) float32 model inputs."""
        spec = torch.as_tensor(self.track_logmel(wave))
        return unfold_segments(spec, self.n_frames, self.step).numpy()

    @torch.inference_mode()
    def _embed_padded(self, padded: np.ndarray, s_true: Sequence[int]) -> List[np.ndarray]:
        """(K, L) padded tracks of one bucket -> K (S_k, d) fingerprint
        arrays: one log-mel call, the true segments of all K embedded in
        full batches, one copy back."""
        mel = log_mel_spectrogram(self._tensor(padded), self.mcfg_nopad)
        segs = torch.cat([unfold_segments(m, self.n_frames, self.step)[:s]
                          for m, s in zip(mel, s_true)])
        z = self._embed_batches(segs).cpu().numpy()
        return np.split(z, np.cumsum(s_true)[:-1])

    def fingerprint_track(self, wave: np.ndarray) -> np.ndarray:
        """(T,) raw audio -> (S, d) fingerprints, wave to fingerprints on
        the device, in batches of ``batch_size`` segments."""
        return self.fingerprint_tracks([wave], pack=1)[0]

    def fingerprint_tracks(self, waves, pack: Optional[int] = None) -> List[np.ndarray]:
        """Raw tracks (T_i,) -> (S_i, d) fingerprints each. Runs of up to
        ``pack`` (default ``build_pack``) consecutive tracks of one bucket
        length share one ``_embed_padded`` call; rows are independent of
        the packing (eval-mode model), so each equals its
        ``fingerprint_track``."""
        padded = [self._pad_track(np.asarray(w, np.float32)) for w in waves]
        kpack = self._pack(pack)
        out: List[Optional[np.ndarray]] = [None] * len(padded)
        i = 0
        while i < len(padded):
            if padded[i][1] <= 0:
                out[i] = np.zeros((0, self.d), np.float32)
                i += 1
                continue
            length = padded[i][0].shape[1]
            group = [i]
            j = i + 1
            while (j < len(padded) and len(group) < kpack and padded[j][1] > 0
                   and padded[j][0].shape[1] == length):
                group.append(j)
                j += 1
            zs = self._embed_padded(np.concatenate([padded[g][0] for g in group]),
                                    [padded[g][1] for g in group])
            for g, z in zip(group, zs):
                out[g] = z
            i = j
        return out

    # -- query corruption ------------------------------------------------
    def corrupt_track(self, wave: np.ndarray, banks: Optional[AugmentBanks],
                      draws: AugmentDraws, ir_prob: float = 1.0) -> np.ndarray:
        """Reference val_transform on one track: IR (p = ir_prob) then noise
        at val_snr (p = 1), with one track's ``draws`` (batch 1) and
        ``banks`` on the pipeline's device."""
        return self.corrupt_tracks([wave], banks, [draws], ir_prob, pack=1)[0]

    @torch.inference_mode()
    def corrupt_tracks(self, waves, banks: Optional[AugmentBanks],
                       draws: Sequence[AugmentDraws], ir_prob: float = 1.0,
                       pack: Optional[int] = None) -> List[np.ndarray]:
        """``corrupt_track`` for a list of tracks, one draw set each; runs
        of up to ``pack`` tracks of equal true length share one call, which
        gives each track the result of its own (the augment is per row)."""
        waves = [np.asarray(w, np.float32) for w in waves]
        if banks is None or (banks.noise is None and banks.ir is None):
            return waves
        kpack = self._pack(pack)
        out: List[Optional[np.ndarray]] = [None] * len(waves)
        i = 0
        while i < len(waves):
            j = i + 1
            while j < len(waves) and j - i < kpack and len(waves[j]) == len(waves[i]):
                j += 1
            batch = self._tensor(np.stack(waves[i:j]))
            d = AugmentDraws(**{
                f: None if getattr(draws[i], f) is None
                else torch.cat([getattr(draws[g], f) for g in range(i, j)])
                for f in vars(draws[i])})
            y = augment_with_draws(batch, banks, d, ir_prob, 1.0).cpu().numpy()
            out[i:j] = list(y)
            i = j
        return out

    # -- rolling full-batch embedder ------------------------------------
    def embed_stream(self, segment_blocks: Iterable[np.ndarray],
                     writer: MemmapWriter) -> int:
        """Feed ragged per-track segment blocks; embed in full
        ``batch_size`` batches (the last one padded); append to ``writer``
        in order. Returns the rows written."""
        b = self.batch_size
        buf = np.zeros((0, self.mcfg.n_mels, self.n_frames), np.float32)
        total = 0

        def emit(batch: np.ndarray, n_valid: int) -> None:
            nonlocal total
            writer.append(self.embed(batch).cpu().numpy()[:n_valid])
            total += n_valid

        for block in segment_blocks:
            block = np.asarray(block, np.float32)
            if len(block) == 0:
                continue
            buf = np.concatenate([buf, block]) if len(buf) else block
            while len(buf) >= b:
                emit(buf[:b], b)
                buf = buf[b:]
        if len(buf):
            emit(np.pad(buf, ((0, b - len(buf)), (0, 0), (0, 0))), len(buf))
        return total


def _track_waves(loader) -> Iterator[np.ndarray]:
    """The tracks of ``loader`` as float32 waves, in order, read one at a
    time as the build reaches them: a loader with ``.ds`` and ``.indices``
    (a track loader) is indexed, any other iterable gives its waves."""
    if hasattr(loader, "ds") and hasattr(loader, "indices"):
        waves = (loader.ds[int(i)] for i in loader.indices)
    else:
        waves = iter(loader)
    return (np.asarray(w, np.float32) for w in waves)


def _chunks(it: Iterable, n: int) -> Iterator[list]:
    buf: list = []
    for x in it:
        buf.append(x)
        if len(buf) == n:
            yield buf
            buf = []
    if buf:
        yield buf


def _capacity(loader_len: int, cfg, max_track_s: float = 40.0) -> int:
    frames = 1 + int(max_track_s * cfg["fs"]) // cfg["hop_len"]
    per_track = num_segments(frames, cfg["n_frames"], cfg.seg_hop_frames)
    return max(loader_len * per_track, 1024)


def track_corruption_draws(banks: AugmentBanks, n: int, seed: int,
                           snr_range: Tuple[float, float],
                           ir_prob: float = 1.0) -> List[AugmentDraws]:
    """The corruption draws of n tracks (batch 1 each), in track order,
    from one ``torch.Generator`` seeded with ``seed``."""
    g = torch.Generator().manual_seed(seed)
    return [sample_augment_draws(banks, 1, g, snr_range, ir_prob, 1.0)
            for _ in range(n)]


def create_dummy_db(loader, pipeline: FingerprintPipeline, output_root_dir: str,
                    fname: str = "dummy_db", verbose: bool = True,
                    pack: Optional[int] = None) -> Tuple[int, int]:
    """Clean fingerprints of every track (reference test_fp.py:127-158)
    into <output_root_dir>/<fname>.mm, ``pack`` tracks a call. Returns the
    memmap's (rows, d)."""
    kpack = pipeline._pack(pack)
    writer = MemmapWriter(output_root_dir, fname, pipeline.d,
                          capacity=_capacity(len(loader), pipeline.cfg))
    done = 0
    for chunk in _chunks(_track_waves(loader), kpack):
        for z in pipeline.fingerprint_tracks(chunk, pack=kpack):
            if verbose and done % 100 == 0:
                print(f"=> dummy db [{done}/{len(loader)}]")
            done += 1
            if len(z):
                writer.append(z)
    return writer.close()


def create_fp_db(loader, pipeline: FingerprintPipeline,
                 banks: Optional[AugmentBanks], output_root_dir: str,
                 seed: int = 0, ir_prob: float = 1.0, verbose: bool = True,
                 pack: Optional[int] = None,
                 draws: Optional[Sequence[AugmentDraws]] = None) -> Tuple[int, int]:
    """Paired clean (db.mm) and corrupted (query.mm) fingerprints per track
    (reference test_fp.py:87-125), each track truncated to the shorter of
    its two segment counts, so that row i of one is row i of the other:
    the eval's ground truth. ``draws``: one ``AugmentDraws`` per track
    (batch 1), by default ``track_corruption_draws(banks, len(loader),
    seed, val_snr, ir_prob)``. Returns the query memmap's (rows, d)."""
    kpack = pipeline._pack(pack)
    cap = _capacity(len(loader), pipeline.cfg)
    w_db = MemmapWriter(output_root_dir, "db", pipeline.d, capacity=cap)
    w_q = MemmapWriter(output_root_dir, "query", pipeline.d, capacity=cap)
    if banks is not None:
        banks = banks.to(pipeline.device)
        if draws is None:
            draws = track_corruption_draws(banks, len(loader), seed,
                                           pipeline.val_snr, ir_prob)
    else:
        draws = [None] * len(loader)

    done = 0
    for chunk in _chunks(zip(_track_waves(loader), draws), kpack):
        waves = [w for w, _ in chunk]
        corrupted = pipeline.corrupt_tracks(waves, banks, [d for _, d in chunk],
                                            ir_prob=ir_prob, pack=kpack)
        for z_clean, z_dirty in zip(pipeline.fingerprint_tracks(waves, pack=kpack),
                                    pipeline.fingerprint_tracks(corrupted, pack=kpack)):
            if verbose and done % 10 == 0:
                print(f"=> fp db [{done}/{len(loader)}]")
            done += 1
            s = min(len(z_clean), len(z_dirty))
            if s:
                w_db.append(z_clean[:s])
                w_q.append(z_dirty[:s])
    w_db.close()
    return w_q.close()


def create_db(loader, pipeline: FingerprintPipeline, output_dir: str,
              concat: bool = True, verbose: bool = True,
              pack: Optional[int] = None) -> np.ndarray:
    """Standalone fingerprint extraction -> <output_dir>/fingerprints.npy
    (reference generate.py:34-57): one (rows, d) array, or with ``concat``
    False an object array of per-track arrays."""
    kpack = pipeline._pack(pack)
    outs = []
    for chunk in _chunks(_track_waves(loader), kpack):
        for z in pipeline.fingerprint_tracks(chunk, pack=kpack):
            if verbose and len(outs) % 10 == 0:
                print(f"=> generate [{len(outs)}/{len(loader)}]")
            outs.append(z)
    fp = np.concatenate(outs, axis=0) if concat else np.array(outs, dtype=object)
    os.makedirs(output_dir, exist_ok=True)
    np.save(os.path.join(output_dir, "fingerprints.npy"), fp)
    return fp
