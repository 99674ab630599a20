"""Plain log-mel frontend of the reference: torchaudio's MelSpectrogram
semantics as the published GraFPrint config uses them (center=True with
reflect padding, periodic Hann window, power 2, HTK mel scale without
filterbank norm), then power to dB with amin 1e-10 and no top_db floor.

Computed with ``torch.stft`` in float64, independent of the program's
DFT-by-matmul frontend. Imports nothing of the program.
"""

from __future__ import annotations

import math

import torch


def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int,
                   device=None) -> torch.Tensor:
    """(n_freqs, n_mels) float64 HTK triangles, as
    torchaudio.functional.melscale_fbanks(norm=None, mel_scale='htk')."""
    def hz_to_mel(f):
        return 2595.0 * math.log10(1.0 + f / 700.0)

    all_freqs = torch.linspace(0, sample_rate // 2, n_freqs, dtype=torch.float64,
                               device=device)
    m_pts = torch.linspace(hz_to_mel(0.0), hz_to_mel(sample_rate / 2.0), n_mels + 2,
                           dtype=torch.float64, device=device)
    f_pts = 700.0 * (10.0 ** (m_pts / 2595.0) - 1.0)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return torch.clamp(torch.minimum(down, up), min=0.0)


def log_mel(wave: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(..., T) audio -> (..., n_mels, 1 + T // hop) log-mel in dB,
    float32 (computed in float64)."""
    n_fft, hop, win = int(cfg["n_fft"]), int(cfg["hop_len"]), int(cfg["win_len"])
    x = wave.to(torch.float64)
    lead = x.shape[:-1]
    x = x.reshape(-1, x.shape[-1])
    window = torch.hann_window(win, periodic=True, dtype=torch.float64, device=x.device)
    spec = torch.stft(x, n_fft, hop_length=hop, win_length=win, window=window,
                      center=True, pad_mode="reflect", return_complex=True)
    power = spec.real ** 2 + spec.imag ** 2                 # (B, F, frames)
    fb = mel_filterbank(n_fft // 2 + 1, int(cfg["n_mels"]), int(cfg["fs"]), x.device)
    mel = torch.einsum("bft,fm->bmt", power, fb)
    db = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
    return db.to(torch.float32).reshape(*lead, *db.shape[-2:])


def segment_hop(cfg: dict) -> int:
    """Frames between consecutive fingerprints: int(n_frames * (1 -
    overlap)), at least 1."""
    return max(1, int(int(cfg["n_frames"]) * (1 - float(cfg["overlap"]))))


def track_segments(wave: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(T,) one track -> (S, n_mels, n_frames): the log-mel of the whole
    track cut into windows of n_frames frames every ``segment_hop``
    frames; a track shorter than one window gives none."""
    mel = log_mel(wave, cfg)                                # (M, frames)
    n, step = int(cfg["n_frames"]), segment_hop(cfg)
    if mel.shape[-1] < n:
        return mel.new_zeros((0, mel.shape[0], n))
    return mel.unfold(1, n, step).permute(1, 0, 2).contiguous()
