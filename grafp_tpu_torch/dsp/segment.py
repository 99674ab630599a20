"""Segment unfolding: full-track spectrogram -> overlapping model inputs
(port of ``grafp_tpu.dsp.segment``)."""

from __future__ import annotations

import torch


def num_segments(total_frames: int, n_frames: int, step: int) -> int:
    """Segments produced by torch.Tensor.unfold: floor((total - size) /
    step) + 1, or 0 when total < size."""
    if total_frames < n_frames:
        return 0
    return (total_frames - n_frames) // step + 1


def unfold_segments(spec: torch.Tensor, n_frames: int, step: int) -> torch.Tensor:
    """(n_mels, T) -> (n_segments, n_mels, n_frames); segment s covers
    frames [s*step, s*step + n_frames)."""
    n_mels, total = spec.shape
    if num_segments(total, n_frames, step) == 0:
        return spec.new_zeros((0, n_mels, n_frames))
    return spec.unfold(1, n_frames, step).permute(1, 0, 2)
