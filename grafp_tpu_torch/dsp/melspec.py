"""Log-mel spectrogram frontend (port of ``grafp_tpu.dsp.melspec``).

torchaudio semantics as in the reference: center=True with reflect
padding, periodic Hann window, power 2, HTK mel scale without filterbank
norm, and power-to-dB with amin 1e-10 and no top_db clamp. The real DFT
runs as two matmuls against precomputed windowed cos/sin bases (the JAX
package's ``method='matmul'``, the only method here); these are plain
large products, left to cuBLAS.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Filterbank / window construction (host-side numpy, cached)
# ---------------------------------------------------------------------------

def _hz_to_mel_htk(f: np.ndarray) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz_htk(m: np.ndarray) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=16)
def mel_filterbank(
    n_freqs: int,
    n_mels: int,
    sample_rate: int,
    f_min: float = 0.0,
    f_max: float | None = None,
) -> np.ndarray:
    """Triangular HTK mel filterbank, (n_freqs, n_mels) float32, as
    torchaudio.functional.melscale_fbanks(norm=None, mel_scale='htk'),
    including its integer-division Nyquist grid."""
    if f_max is None:
        f_max = float(sample_rate) / 2.0
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel_htk(f_min), _hz_to_mel_htk(f_max), n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]                       # (n_mels+1,)
    slopes = f_pts[None, :] - all_freqs[:, None]          # (n_freqs, n_mels+2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _hann_window(win_length: int, n_fft: int) -> np.ndarray:
    """Periodic Hann of win_length, zero-padded symmetrically to n_fft."""
    n = np.arange(win_length, dtype=np.float64)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))
    if win_length < n_fft:
        left = (n_fft - win_length) // 2
        out = np.zeros(n_fft)
        out[left:left + win_length] = w
        w = out
    return w.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _rdft_bases(n_fft: int, win_length: int) -> Tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT cos/sin bases, each (n_fft, n_fft//2+1) f32."""
    n_freqs = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_freqs, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    w = _hann_window(win_length, n_fft).astype(np.float64)[:, None]
    return (
        (np.cos(ang) * w).astype(np.float32),
        (-np.sin(ang) * w).astype(np.float32),
    )


@functools.lru_cache(maxsize=16)
def _device_tables(n_fft: int, win_length: int, n_mels: int, sample_rate: int,
                   f_min: float, f_max, device: str):
    """cos/sin bases and the transposed filterbank as tensors on
    ``device``, uploaded once per configuration."""
    cos_b, sin_b = _rdft_bases(n_fft, win_length)
    fb = mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate, f_min, f_max)
    to = functools.partial(torch.as_tensor, device=device)
    return to(cos_b), to(sin_b), to(np.ascontiguousarray(fb.T))


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LogMelConfig:
    sample_rate: int = 16000
    n_fft: int = 1024
    win_length: int = 1024
    hop_length: int = 512
    n_mels: int = 64
    f_min: float = 0.0
    f_max: float | None = None
    amin: float = 1e-10          # AmplitudeToDB clamp floor
    center: bool = True          # False: caller pre-padded (fp builder)

    @classmethod
    def from_config(cls, cfg) -> "LogMelConfig":
        return cls(
            sample_rate=cfg["fs"],
            n_fft=cfg["n_fft"],
            win_length=cfg["win_len"],
            hop_length=cfg["hop_len"],
            n_mels=cfg["n_mels"],
        )


# ---------------------------------------------------------------------------
# Core
# ---------------------------------------------------------------------------

def _frame(x: torch.Tensor, n_fft: int, hop: int, center: bool = True) -> torch.Tensor:
    """(..., T) -> (..., n_frames, n_fft) with reflect center-padding.
    center=False assumes the caller already padded."""
    if center:
        pad = n_fft // 2
        lead = x.shape[:-1]
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
        x = x.reshape(*lead, x.shape[-1])
    return x.unfold(-1, n_fft, hop)


def power_spectrogram(x: torch.Tensor, mcfg: LogMelConfig) -> torch.Tensor:
    """(..., T) -> (..., n_freqs, n_frames) power spectrogram (|STFT|^2)."""
    cos_b, sin_b, _ = _device_tables(
        mcfg.n_fft, mcfg.win_length, mcfg.n_mels, mcfg.sample_rate,
        mcfg.f_min, mcfg.f_max, str(x.device))
    frames = _frame(x.to(torch.float32), mcfg.n_fft, mcfg.hop_length,
                    mcfg.center)
    re = torch.matmul(frames, cos_b)
    im = torch.matmul(frames, sin_b)
    p = re * re + im * im                                  # (..., n_frames, n_freqs)
    return p.transpose(-1, -2)                             # (..., n_freqs, n_frames)


def mel_spectrogram(x: torch.Tensor, mcfg: LogMelConfig) -> torch.Tensor:
    """(..., T) -> (..., n_mels, n_frames) mel-power spectrogram."""
    p = power_spectrogram(x, mcfg)                         # (..., F, T')
    _, _, fb_t = _device_tables(
        mcfg.n_fft, mcfg.win_length, mcfg.n_mels, mcfg.sample_rate,
        mcfg.f_min, mcfg.f_max, str(x.device))
    return torch.matmul(fb_t, p)                           # (..., M, T')


def amplitude_to_db(p: torch.Tensor, mcfg: LogMelConfig) -> torch.Tensor:
    """Power -> dB as AmplitudeToDB(stype='power') with the reference's
    defaults: 10*log10(clamp(p, amin)), ref = 1, no top_db floor."""
    return 10.0 * torch.log10(torch.clamp(p, min=mcfg.amin))


def log_mel_spectrogram(x: torch.Tensor, mcfg: LogMelConfig) -> torch.Tensor:
    """(..., T) audio -> (..., n_mels, n_frames) log-mel in dB; (..., 64,
    32) for 1 s at 16 kHz with the grafp config."""
    return amplitude_to_db(mel_spectrogram(x, mcfg), mcfg)
