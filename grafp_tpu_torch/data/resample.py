"""Windowed-sinc polyphase resampler (port of ``grafp_tpu.data.resample``;
the torchaudio.transforms.Resample role, reference modules/data.py:56-57).

Implements the same algorithm as torchaudio's sinc_interp_hann kernel
(lowpass_filter_width=6, rolloff=0.99): reduce the rate pair by their
gcd, build a (new_freq, taps) bank of Hann-windowed sincs evaluated at
the fractional phases, and convolve with stride orig_freq. Output length
is ceil(len * new / orig), matching torchaudio.

Runs on the host (numpy) inside the data loader: one matmul of the
strided input frames with the kernel bank.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np


@functools.lru_cache(maxsize=64)
def _kernel(orig_freq: int, new_freq: int,
            lowpass_filter_width: int = 6,
            rolloff: float = 0.99) -> Tuple[np.ndarray, int]:
    """Returns (kernels (new_freq, width*2 + orig_freq), width)."""
    assert lowpass_filter_width > 0
    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)
    idx = np.arange(-width, width + orig_freq, dtype=np.float64)[None, :] / orig_freq
    t = np.arange(0, -new_freq, -1, dtype=np.float64)[:, None] / new_freq + idx
    t *= base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t *= np.pi
    scale = base_freq / orig_freq
    kernels = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernels *= window * scale
    return kernels.astype(np.float32), int(width)


def resample_sinc(x: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """(T,) float32 -> resampled (ceil(T*new/orig),) float32."""
    if orig_sr == new_sr:
        return np.asarray(x, np.float32)
    g = math.gcd(int(orig_sr), int(new_sr))
    orig, new = int(orig_sr) // g, int(new_sr) // g
    kernels, width = _kernel(orig, new)
    x = np.asarray(x, np.float32)
    n = len(x)
    target_len = int(math.ceil(new * n / orig))
    xp = np.pad(x, (width, width + orig))
    # frames of size taps with hop orig: (num_frames, taps)
    taps = kernels.shape[1]
    num_frames = (len(xp) - taps) // orig + 1
    strided = np.lib.stride_tricks.as_strided(
        xp, shape=(num_frames, taps),
        strides=(xp.strides[0] * orig, xp.strides[0]),
    )
    # (num_frames, taps) x (taps, new) -> (num_frames, new) -> interleave.
    # The explicit contiguous copy matters: numpy matmul on an as_strided
    # view falls back to its slow non-BLAS kernel (22x slower for a 30 s
    # 44.1k->16k track, scripts/profile_input_pipeline.py).
    out = np.ascontiguousarray(strided) @ kernels.T
    return out.reshape(-1)[:target_len].astype(np.float32)
