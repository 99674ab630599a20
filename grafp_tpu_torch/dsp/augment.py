"""Waveform augmentations on the device (port of ``grafp_tpu.dsp.augment``).

The reference's torch-audiomentations chain (modules/transformations.py:
25-48): per-example impulse-response convolution, then background noise
at an SNR drawn from a range, each applied with a probability.

* ApplyImpulseResponse: y = full convolution(x, ir) truncated to the
  input length. With precomputed partition spectra it runs as a
  uniform-partitioned overlap-add whose DFTs are matmuls
  (``apply_ir_os``); ``apply_ir`` is the ``torch.fft`` form for IR banks
  without spectra.
* AddBackgroundNoise: noise scaled so rms(x) / rms(noise) = 10^(snr/20);
  a silent noise row passes x through.

``augment_waveforms`` splits into a sampler, ``sample_augment_draws``,
which takes every random draw from an explicit ``torch.Generator`` in the
JAX function's order (IR rows, IR take, noise rows, noise offsets, SNR,
noise take), and a deterministic core, ``augment_with_draws``, which takes
those draws as tensors, so the same draws give the JAX function's result.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, fields
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

HOP = 1024          # partition / frame size; N = 2048-point DFT
_LANE = 128         # noise offsets are quantised to 128-sample blocks
_OFFSET_RANGE = 2 ** 30


def _next_pow2(n: int) -> int:
    return 1 << (int(n - 1).bit_length())


def apply_ir(x: torch.Tensor, ir: torch.Tensor) -> torch.Tensor:
    """FFT convolution of audio (..., T) with impulse responses (..., L)
    (zero-padded rows contribute nothing), truncated to T."""
    t, l = x.shape[-1], ir.shape[-1]
    n = _next_pow2(t + l - 1)
    xf = torch.fft.rfft(x, n=n, dim=-1)
    hf = torch.fft.rfft(ir, n=n, dim=-1)
    y = torch.fft.irfft(xf * hf, n=n, dim=-1)
    return y[..., :t].to(x.dtype)


@functools.lru_cache(maxsize=4)
def _dft_mats(hop: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fwd_re, fwd_im, inv) matrices of an N = 2*hop real DFT of a
    hop-sample frame (the zero padding is the row slice) and of its
    inverse (copy of ``grafp_tpu.dsp.augment._dft_mats``)."""
    n = 2 * hop
    bins = n // 2 + 1
    t = np.arange(hop)[:, None]
    f = np.arange(bins)[None, :]
    ang = -2.0 * np.pi * t * f / n
    fwd_re = np.cos(ang).astype(np.float32)            # (hop, bins)
    fwd_im = np.sin(ang).astype(np.float32)
    tt = np.arange(n)[None, :]
    ff = np.arange(bins)[:, None]
    c = np.cos(2.0 * np.pi * ff * tt / n)
    s = np.sin(2.0 * np.pi * ff * tt / n)
    w = np.full((bins, 1), 2.0)
    w[0] = 1.0
    w[-1] = 1.0
    inv = np.concatenate([w * c, -w * s], axis=0).astype(np.float32) / n
    return fwd_re, fwd_im, inv


@functools.lru_cache(maxsize=8)
def _dft_tensors(hop: int, device: str) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.as_tensor(m, device=device) for m in _dft_mats(hop))


def partitioned_ir_spectra(ir_bank: np.ndarray, hop: int = HOP
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row partition spectra of an IR bank (n_ir, L), computed once on
    the host: (re, im), each (n_ir, P, hop + 1) f32 with P = ceil(L/hop)."""
    ir_bank = np.asarray(ir_bank, np.float32)
    n_ir, l = ir_bank.shape
    p = -(-l // hop)
    padded = np.zeros((n_ir, p * hop), np.float32)
    padded[:, :l] = ir_bank
    spec = np.fft.rfft(padded.reshape(n_ir, p, hop), n=2 * hop, axis=-1)
    return (torch.from_numpy(spec.real.astype(np.float32)),
            torch.from_numpy(spec.imag.astype(np.float32)))


def apply_ir_os(x: torch.Tensor, hf_re: torch.Tensor, hf_im: torch.Tensor,
                hop: int = HOP) -> torch.Tensor:
    """Per-example IR convolution from precomputed partition spectra.

    x: (B, T); hf_re/hf_im: (B, P, hop + 1). Returns (B, T), the full
    linear convolution truncated to T. Output block m sums X[m-p] * H[p]
    over the partitions (only blocks m < nblk reach y[:T]); the DFTs are
    matmuls against ``_dft_mats``; the blocks overlap-add at hop."""
    b, t = x.shape
    p = hf_re.shape[1]
    fwd_re, fwd_im, inv = _dft_tensors(hop, str(x.device))
    nblk = -(-t // hop)
    xf = F.pad(x, (0, nblk * hop - t)).reshape(b, nblk, hop)
    xr = torch.matmul(xf, fwd_re)
    xi = torch.matmul(xf, fwd_im)
    yr = torch.zeros_like(xr)
    yi = torch.zeros_like(xi)
    for pp in range(min(p, nblk)):
        xr_s, xi_s = xr[:, : nblk - pp], xi[:, : nblk - pp]
        hr = hf_re[:, pp][:, None, :]
        hi = hf_im[:, pp][:, None, :]
        yr[:, pp:] += xr_s * hr - xi_s * hi
        yi[:, pp:] += xr_s * hi + xi_s * hr
    blocks = torch.matmul(torch.cat([yr, yi], dim=-1), inv)  # (B, nblk, 2hop)
    y = torch.zeros((b, (nblk + 1) * hop), dtype=torch.float32, device=x.device)
    y[:, : nblk * hop] += blocks[..., :hop].reshape(b, -1)
    y[:, hop:] += blocks[..., hop:].reshape(b, -1)
    return y[:, :t].to(x.dtype)


def _rms(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return torch.sqrt(torch.mean(x * x, dim=-1) + eps)


def mix_noise_at_snr(x: torch.Tensor, noise: torch.Tensor,
                     snr_db: torch.Tensor) -> torch.Tensor:
    """x + gain * noise with rms(x) / rms(gain * noise) = 10^(snr/20) per
    example; silent noise rows (rms < 1e-9) pass x through."""
    x_rms = _rms(x)
    n_rms = _rms(noise)
    gain = x_rms / (n_rms * torch.pow(10.0, snr_db / 20.0))
    gain = torch.where(n_rms < 1e-9, torch.zeros_like(gain), gain)
    return x + gain[..., None] * noise


def _pack(clips: List[np.ndarray], length: int, loop: bool):
    """Ragged 1-D clips -> ((rows, length) f32, (rows,) valid counts).
    Looped rows (noise) are tiled to fill and padded to a multiple of
    128 samples; others (IRs) are zero-padded."""
    if length == 0:
        length = max(len(c) for c in clips)
    if loop:
        length = -(-length // _LANE) * _LANE
    rows, valid = [], []
    for c in clips:
        c = np.asarray(c, np.float32).reshape(-1)
        if len(c) == 0:
            c = np.zeros(1, np.float32)
        if loop and len(c) < length:
            c = np.tile(c, -(-length // len(c)))
        c = c[:length]
        valid.append(len(c))
        rows.append(np.pad(c, (0, length - len(c))))
    return (torch.from_numpy(np.stack(rows)),
            torch.from_numpy(np.array(valid, np.int64)))


@dataclass
class AugmentBanks:
    """Fixed-shape corpora for the augment.

    noise: (n_noise, noise_len) f32, each row one background-noise clip,
        looped to noise_len (a multiple of 128); ir: (n_ir, ir_len) f32,
        each row one impulse response, zero-padded; noise_valid /
        ir_valid: true samples per row; ir_spec_re / ir_spec_im: the IR
        rows' partition spectra (n_ir, P, HOP + 1) for ``apply_ir_os``."""

    noise: Optional[torch.Tensor] = None
    ir: Optional[torch.Tensor] = None
    noise_valid: Optional[torch.Tensor] = None
    ir_valid: Optional[torch.Tensor] = None
    ir_spec_re: Optional[torch.Tensor] = None
    ir_spec_im: Optional[torch.Tensor] = None

    @staticmethod
    def from_arrays(noise_clips: Optional[list] = None,
                    ir_clips: Optional[list] = None,
                    noise_len: int = 0, ir_len: int = 0) -> "AugmentBanks":
        """Banks from ragged host arrays (lists of 1-D arrays), on the CPU;
        ``to(device)`` moves them."""
        banks = AugmentBanks()
        if noise_clips:
            banks.noise, banks.noise_valid = _pack(noise_clips, noise_len, True)
        if ir_clips:
            banks.ir, banks.ir_valid = _pack(ir_clips, ir_len, False)
            banks.ir_spec_re, banks.ir_spec_im = partitioned_ir_spectra(
                banks.ir.numpy())
        return banks

    def to(self, device) -> "AugmentBanks":
        return AugmentBanks(**{
            f.name: None if getattr(self, f.name) is None
            else getattr(self, f.name).to(device) for f in fields(self)})


@dataclass
class AugmentDraws:
    """The random draws of one ``augment_waveforms`` call, (B,) each:
    IR rows; uniforms in [0, 1) that decide the IR take (< ir_prob);
    noise rows; raw noise offsets in [0, 2^30) (reduced modulo each row's
    room in ``_sample_noise``); SNRs in dB; uniforms for the noise take."""

    ir_rows: Optional[torch.Tensor] = None
    ir_take: Optional[torch.Tensor] = None
    noise_rows: Optional[torch.Tensor] = None
    noise_offsets: Optional[torch.Tensor] = None
    snr: Optional[torch.Tensor] = None
    noise_take: Optional[torch.Tensor] = None


def sample_augment_draws(banks: AugmentBanks, batch: int,
                         generator: torch.Generator,
                         snr_range: Tuple[float, float], ir_prob: float = 1.0,
                         noise_prob: float = 1.0) -> AugmentDraws:
    """Every draw of ``augment_waveforms`` from ``generator``, on its
    device, in the JAX function's order."""
    kw = dict(generator=generator, device=generator.device)
    d = AugmentDraws()
    if banks.ir is not None and ir_prob > 0:
        d.ir_rows = torch.randint(0, banks.ir.shape[0], (batch,), **kw)
        d.ir_take = torch.rand((batch,), **kw)
    if banks.noise is not None and noise_prob > 0:
        d.noise_rows = torch.randint(0, banks.noise.shape[0], (batch,), **kw)
        d.noise_offsets = torch.randint(0, _OFFSET_RANGE, (batch,), **kw)
        lo, hi = float(snr_range[0]), float(snr_range[1])
        d.snr = lo + (hi - lo) * torch.rand((batch,), **kw)
        d.noise_take = torch.rand((batch,), **kw)
    return d


def _sample_noise(banks: AugmentBanks, rows: torch.Tensor,
                  offsets: torch.Tensor, t: int) -> torch.Tensor:
    """(B, t) noise snippets: row ``rows``, starting at ``offsets`` modulo
    the row's room, rounded down to a 128-sample block, gathered as whole
    blocks (indices past the bank clamp to its last block, as JAX's
    gather clamps)."""
    n_rows, row_len = banks.noise.shape
    nblk = -(-t // _LANE)
    max_off = torch.clamp(banks.noise_valid[rows] - nblk * _LANE, min=1)
    offs = offsets % max_off
    blk0 = rows * (row_len // _LANE) + offs // _LANE
    idx = blk0[:, None] + torch.arange(nblk, device=rows.device)[None, :]
    bank_blocks = banks.noise.reshape(-1, _LANE)
    idx = torch.clamp(idx, max=bank_blocks.shape[0] - 1)
    return bank_blocks[idx].reshape(rows.shape[0], nblk * _LANE)[:, :t]


def augment_with_draws(x: torch.Tensor, banks: AugmentBanks,
                       draws: AugmentDraws, ir_prob: float = 1.0,
                       noise_prob: float = 1.0) -> torch.Tensor:
    """The deterministic augment: IR convolution where ir_take < ir_prob,
    then noise at the drawn SNR where noise_take < noise_prob."""
    b, t = x.shape
    y = x
    if banks.ir is not None and ir_prob > 0:
        rows = draws.ir_rows.to(x.device)
        if banks.ir_spec_re is not None:
            convolved = apply_ir_os(y, banks.ir_spec_re[rows],
                                    banks.ir_spec_im[rows])
        else:
            convolved = apply_ir(y, banks.ir[rows])
        take = draws.ir_take.to(x.device) < ir_prob
        y = torch.where(take[:, None], convolved, y)
    if banks.noise is not None and noise_prob > 0:
        noise = _sample_noise(banks, draws.noise_rows.to(x.device),
                              draws.noise_offsets.to(x.device), t)
        noised = mix_noise_at_snr(y, noise, draws.snr.to(x.device))
        take = draws.noise_take.to(x.device) < noise_prob
        y = torch.where(take[:, None], noised, y)
    return y


def augment_waveforms(x: torch.Tensor, banks: AugmentBanks,
                      generator: torch.Generator,
                      snr_range: Tuple[float, float], ir_prob: float = 1.0,
                      noise_prob: float = 1.0) -> torch.Tensor:
    """The train/val corruption chain on a batch (B, T): IR convolution
    with probability ir_prob, then background noise at snr ~ U[snr_range]
    with probability noise_prob (reference transformations.py:25-48)."""
    draws = sample_augment_draws(banks, x.shape[0], generator, snr_range,
                                 ir_prob, noise_prob)
    return augment_with_draws(x, banks, draws, ir_prob, noise_prob)
