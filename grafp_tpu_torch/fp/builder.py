"""Fingerprint pipeline and database builders (port of
``grafp_tpu.fp.builder``; reference test_fp.py:87-158, generate.py:34-57).

The pipeline serves through a BatchNorm-folded copy of the model
(``models/fold_bn.py``) on the card, of any arch: the baselines, which
have no BatchNorm, serve as they are. Under ``serve_quant='int8_static'``
it serves from the model's calibrated activation maxima, or from
``act_scales``; when it has neither (the CLIs load plain checkpoints), it
calibrates once on the first model inputs it sees, as the JAX pipeline
does (``grafp_tpu/fp/builder.py:157-175``). Track lengths are bucketed as in the
reference pipeline: the true track is reflect-padded with its own
samples, zero-filled up to the next multiple of ``bucket_s`` seconds, and
only the reference-defined segments are kept, so every fingerprint equals
an unbucketed computation.

Every model call runs on one of a few static shapes, as the JAX pipeline's
jitted ``_embed`` does: the builders embed only full ``batch_size``
batches, the last one zero-padded and its extra rows dropped
(``grafp_tpu/fp/builder.py:113-150``). On the card the model runs from
one captured CUDA graph per input shape (``fp/graphs.py``), captured at
the first call of the shape after the lazy calibration; a capture that
fails raises. On the CPU, the caller's explicit choice, it runs eagerly.

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

import functools
import math
import os
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

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
from grafp_tpu_torch.fp.graphs import CapturedForward
from grafp_tpu_torch.models.fold_bn import fold_batch_norms
from grafp_tpu_torch.models.simclr import calibrate_act_scales
from grafp_tpu_torch.retrieval.memmap_io import MemmapWriter

# Tracks per packed call when the Config sets no build_pack. On an H100
# 80GB HBM3 at 700 W, building 96 tracks of 20-40 s ran 1-4 % faster at
# pack 8 than at pack 1 (a track's last, partial batch is shared;
# chip_smoke.py).
DEFAULT_BUILD_PACK = 8


def _serve(model, x: torch.Tensor) -> torch.Tensor:
    """The serving forward: (B, n_mels, n_frames) -> (B, d) f32."""
    _, z = model(x)
    return z.to(torch.float32)


class FingerprintPipeline:
    """Serving and DB-build entry points around a BatchNorm-folded copy of
    an eval-mode SimCLRModel on ``device`` (None = the CUDA card).

    ``act_scales`` ({``....amax`` key: value}, from ``calibrate_act_scales``)
    sets a static int8 model's activation maxima. A static model whose
    maxima are all 0 and that gets none is calibrated lazily: one exact
    'int8_calibrate' pass of the unfolded ``model`` over the first (<=
    ``batch_size``) model inputs the pipeline sees, the first track's
    segments in the track builders (``_ensure_calibrated``). Under dynamic
    int8 a fingerprint depends on the rest of its batch (one activation
    scale per tensor), as in the JAX package."""

    def __init__(self, model, cfg, batch_size: int = 256,
                 bucket_s: float = 10.0,
                 device: Optional[Union[str, torch.device]] = None,
                 act_scales: Optional[Dict[str, torch.Tensor]] = None):
        self.device = resolve_device(device)
        self.model = fold_batch_norms(model.to(self.device))
        # the card replays one graph per input shape (fp/graphs.py); it
        # holds the folded model, not the pipeline, so dropping the
        # pipeline frees the graphs' pools
        self.graphs = (CapturedForward(functools.partial(_serve, self.model))
                       if self.device.type == "cuda" else None)
        if act_scales:
            self._set_scales(act_scales)
        amax = [b for n, b in self.model.named_buffers() if n.endswith("amax")]
        quant = str(cfg.get("serve_quant") or "none").lower()
        self._needs_calibration = (quant == "int8_static" and not act_scales
                                   and all(float(a) == 0.0 for a in amax))
        # the unfolded model, kept only until it is calibrated
        self._source = model if self._needs_calibration else None
        # dynamic int8: one activation scale per tensor, so a row depends
        # on the rest of its embed batch
        self._batch_coupled = quant == "int8"
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

    def _set_scales(self, scales: Dict[str, torch.Tensor]) -> None:
        with torch.no_grad():
            for key, val in scales.items():
                self.model.get_buffer(key).copy_(torch.as_tensor(val))

    def _ensure_calibrated(self, spec_batch) -> None:
        """The lazy one-shot calibration (see the class): a no-op unless it
        is still due and ``spec_batch`` holds a row."""
        if not self._needs_calibration or len(spec_batch) == 0:
            return
        self._set_scales(calibrate_act_scales(
            self.cfg, self._source, [spec_batch[:self.batch_size]], device=self.device))
        self._needs_calibration, self._source = False, None

    def _pack(self, pack: Optional[int]) -> int:
        return self.build_pack if pack is None else max(1, int(pack))

    @torch.inference_mode()
    def embed(self, spec) -> torch.Tensor:
        """(B, n_mels, n_frames) log-mel -> (B, d) f32 fingerprints; on the
        card a replay of B's graph, captured at B's first call after the
        lazy calibration, so that it captures the scales."""
        self._ensure_calibrated(spec)
        x = self._tensor(spec)
        return _serve(self.model, x) if self.graphs is None else self.graphs(x)

    def _embed_batches(self, segs: torch.Tensor) -> torch.Tensor:
        """(S, n_mels, n_frames) -> (S, d) in full batch_size batches: the
        last zero-padded and its extra rows dropped, as the JAX package's
        ``_embed_track(s)`` do, so every model call has one shape."""
        s, b = segs.shape[0], self.batch_size
        segs = torch.nn.functional.pad(segs, (0, 0, 0, 0, 0, (-s) % b))
        return torch.cat([self.embed(segs[i:i + b])
                          for i in range(0, segs.shape[0], b)])[:s]

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
    def _embed_padded(self, padded: np.ndarray, s_true: Sequence[int],
                      kpack: int = 1) -> List[np.ndarray]:
        """(K, L) padded tracks of one bucket -> K (S_k, d) fingerprint
        arrays: one log-mel call, the true segments of all K embedded in
        full batches (``_embed_batches``), one copy back.

        Under dynamic int8 the batches are the JAX package's
        (``grafp_tpu/fp/builder.py:113-150``), since a row depends on its
        batch there: every segment of the bucket (the tail's too), a group
        of fewer than ``kpack`` > 1 tracks repeat-padded with its last
        track, and the last batch zero-padded to ``batch_size``."""
        mel = log_mel_spectrogram(self._tensor(padded), self.mcfg_nopad)
        if not self._batch_coupled:
            segs = torch.cat([unfold_segments(m, self.n_frames, self.step)[:s]
                              for m, s in zip(mel, s_true)])
            z = self._embed_batches(segs).cpu().numpy()
            return np.split(z, np.cumsum(s_true)[:-1])
        k = mel.shape[0]
        if kpack > 1 and k < kpack:
            mel = torch.cat([mel, mel[-1:].expand(kpack - k, -1, -1)])
        segs = torch.cat([unfold_segments(m, self.n_frames, self.step) for m in mel])
        s_b = segs.shape[0] // mel.shape[0]
        z = self._embed_batches(segs)[:k * s_b].reshape(k, s_b, -1).cpu().numpy()
        return [z[t, :s] for t, s in enumerate(s_true)]

    def fingerprint_track(self, wave: np.ndarray) -> np.ndarray:
        """(T,) raw audio -> (S, d) fingerprints, wave to fingerprints on
        the device, in batches of ``batch_size`` segments."""
        return self.fingerprint_tracks([wave], pack=1)[0]

    def fingerprint_tracks(self, waves, pack: Optional[int] = None) -> List[np.ndarray]:
        """Raw tracks (T_i,) -> (S_i, d) fingerprints each. Runs of up to
        ``pack`` (default ``build_pack``) consecutive tracks of one bucket
        length share one ``_embed_padded`` call. Without quantisation the
        rows are independent of the packing (eval-mode model), so each
        equals its ``fingerprint_track``. Under ``serve_quant='int8'``
        (dynamic) they are not: one activation scale per tensor makes a
        row depend on the other tracks of its embed batch, as in the JAX
        package (``grafp_tpu/fp/builder.py:314``), so a packed build's rows
        equal the JAX package's at the same packing."""
        padded = [self._pad_track(np.asarray(w, np.float32)) for w in waves]
        if self._needs_calibration:
            first = next((w for w, (_, s) in zip(waves, padded) if s > 0), None)
            if first is not None:
                self._ensure_calibrated(self.segments_for(np.asarray(first, np.float32)))
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
                                    [padded[g][1] for g in group], kpack)
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
            self._ensure_calibrated(batch[:n_valid])
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
