"""Plain reference of the training augment (GraFP's transformations.py:
25-48, torch-audiomentations' ApplyImpulseResponse then
AddBackgroundNoise), in float64, from the same raw clips and the same
random draws the program takes.

The draws are re-taken here from a generator seeded as the program's
step generator is, in the order the program's ``sample_augment_draws``
takes them (IR rows, IR take, noise rows, noise offsets, SNR, noise
take): a frozen copy of that sampler and of its noise-snippet rule
(``grafp_tpu_torch/dsp/augment.py:221-255``), so both sides corrupt each
clip alike. The banks are packed here from the raw clips, not taken from
the program.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

LANE = 128            # noise offsets are quantised to 128-sample blocks
OFFSET_RANGE = 2 ** 30


class Banks:
    """Noise rows looped to ``noise_len`` (rounded up to LANE) and IR rows
    zero-padded to ``ir_len``, float64 on ``device``, with each row's
    count of true samples."""

    def __init__(self, noise: List[np.ndarray], irs: List[np.ndarray], noise_len: int,
                 ir_len: int, device):
        noise_len = -(-noise_len // LANE) * LANE
        rows, valid = [], []
        for c in noise:
            c = np.asarray(c, np.float64)
            if len(c) < noise_len:
                c = np.tile(c, -(-noise_len // len(c)))
            c = c[:noise_len]
            valid.append(len(c))
            rows.append(np.pad(c, (0, noise_len - len(c))))
        self.noise = torch.as_tensor(np.stack(rows), device=device)
        self.noise_valid = torch.as_tensor(valid, device=device)
        self.ir = torch.as_tensor(np.stack([np.pad(np.asarray(c, np.float64)[:ir_len],
                                                   (0, ir_len - min(len(c), ir_len)))
                                            for c in irs]), device=device)


def draws(banks: Banks, batch: int, g: torch.Generator, snr: Tuple[float, float]) -> dict:
    """Every draw of one augment call, IR and noise each applied with
    probability 1 (their takes are drawn all the same)."""
    kw = dict(generator=g, device=g.device)
    d = {"ir_rows": torch.randint(0, banks.ir.shape[0], (batch,), **kw),
         "ir_take": torch.rand((batch,), **kw),
         "noise_rows": torch.randint(0, banks.noise.shape[0], (batch,), **kw),
         "noise_offsets": torch.randint(0, OFFSET_RANGE, (batch,), **kw)}
    lo, hi = float(snr[0]), float(snr[1])
    d["snr"] = lo + (hi - lo) * torch.rand((batch,), **kw)
    d["noise_take"] = torch.rand((batch,), **kw)
    return d


def noise_snippets(banks: Banks, rows: torch.Tensor, offsets: torch.Tensor, t: int) -> torch.Tensor:
    """(B, t): row ``rows`` from ``offsets`` modulo the row's room, rounded
    down to a LANE block, read as whole blocks (clamped to the bank's
    last block)."""
    row_len = banks.noise.shape[1]
    nblk = -(-t // LANE)
    room = torch.clamp(banks.noise_valid[rows] - nblk * LANE, min=1)
    blk0 = rows * (row_len // LANE) + (offsets % room) // LANE
    idx = blk0[:, None] + torch.arange(nblk, device=rows.device)[None, :]
    blocks = banks.noise.reshape(-1, LANE)
    idx = torch.clamp(idx, max=blocks.shape[0] - 1)
    return blocks[idx].reshape(rows.shape[0], nblk * LANE)[:, :t]


def augment(x: torch.Tensor, banks: Banks, d: dict, ir_prob: float = 1.0,
            noise_prob: float = 1.0) -> torch.Tensor:
    """(B, T) clips -> the same clips convolved with their impulse
    response (full linear convolution, truncated to T) where the IR take
    is under ``ir_prob``, then mixed with their noise snippet at the drawn
    SNR (rms ratio 10^(snr/20); a silent snippet adds nothing) where the
    noise take is under ``noise_prob``. float64."""
    x = x.to(torch.float64)
    b, t = x.shape
    ir = banks.ir[d["ir_rows"]]
    n = 1 << int(t + ir.shape[1] - 2).bit_length()
    conv = torch.fft.irfft(torch.fft.rfft(x, n=n) * torch.fft.rfft(ir, n=n), n=n)[:, :t]
    y = torch.where((d["ir_take"] < ir_prob)[:, None], conv, x)
    noise = noise_snippets(banks, d["noise_rows"], d["noise_offsets"], t)
    y_rms = torch.sqrt((y * y).mean(-1) + 1e-12)
    n_rms = torch.sqrt((noise * noise).mean(-1) + 1e-12)
    gain = y_rms / (n_rms * 10.0 ** (d["snr"].to(torch.float64) / 20.0))
    gain = torch.where(n_rms < 1e-9, torch.zeros_like(gain), gain)
    return torch.where((d["noise_take"] < noise_prob)[:, None], y + gain[:, None] * noise, y)
