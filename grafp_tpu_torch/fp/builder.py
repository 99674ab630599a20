"""Fingerprint serving pipeline (port of the serving methods of
``grafp_tpu.fp.builder.FingerprintPipeline``).

Track lengths are bucketed as in the reference pipeline: the true track is
reflect-padded with its own samples, zero-filled up to the next multiple
of ``bucket_s`` seconds, and only the reference-defined segments are kept,
so every fingerprint equals an unbucketed computation.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

from grafp_tpu_torch.core.device import resolve_device
from grafp_tpu_torch.dsp.melspec import LogMelConfig, log_mel_spectrogram
from grafp_tpu_torch.dsp.segment import num_segments, unfold_segments


class FingerprintPipeline:
    """Serving entry points around an eval-mode SimCLRModel."""

    def __init__(self, model, cfg, batch_size: int = 256,
                 bucket_s: float = 10.0,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.batch_size = batch_size
        self.fs = int(cfg["fs"])
        self.bucket = int(bucket_s * self.fs)
        self.n_fft = int(cfg["n_fft"])
        self.hop = int(cfg["hop_len"])
        self.n_frames = int(cfg["n_frames"])
        self.step = cfg.seg_hop_frames
        self.d = int(cfg["d"])
        self.mcfg = LogMelConfig.from_config(cfg)
        self.mcfg_nopad = LogMelConfig(
            sample_rate=self.mcfg.sample_rate, n_fft=self.mcfg.n_fft,
            win_length=self.mcfg.win_length, hop_length=self.mcfg.hop_length,
            n_mels=self.mcfg.n_mels, center=False,
        )

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    @torch.inference_mode()
    def embed(self, spec) -> torch.Tensor:
        """(B, n_mels, n_frames) log-mel -> (B, d) f32 fingerprints."""
        _, z = self.model(self._tensor(spec))
        return z.to(torch.float32)

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
    def fingerprint_track(self, wave: np.ndarray) -> np.ndarray:
        """(T,) raw audio -> (S, d) fingerprints, wave to fingerprints on
        the device, in batches of ``batch_size`` segments."""
        wave = np.asarray(wave, np.float32)
        padded, s_true = self._pad_track(wave)
        if s_true <= 0:
            return np.zeros((0, self.d), np.float32)
        mel = log_mel_spectrogram(self._tensor(padded), self.mcfg_nopad)[0]
        segs = unfold_segments(mel, self.n_frames, self.step)[:s_true]
        zs = [self.embed(segs[i:i + self.batch_size])
              for i in range(0, s_true, self.batch_size)]
        return torch.cat(zs).cpu().numpy()
