"""SpecAugment time and frequency masking (port of
``grafp_tpu.dsp.specaug``).

The reference wires torchaudio TimeMasking(time_mask, iid_masks=True) and
FrequencyMasking(freq_mask, True) but comments them out of the grafp path
(transformations.py:59-62,79-85); the config keys remain. torchaudio's
semantics: per-example iid masks, width ~ U[0, param), start uniform in
the valid range, the masked region set to 0.

``spec_augment`` takes its uniforms from an explicit ``torch.Generator``
in the JAX function's order (time width, time start, frequency width,
frequency start, B each); ``mask_axis`` is the deterministic core, so the
same uniforms give the JAX function's result.
"""

from __future__ import annotations

import torch


def mask_axis(spec: torch.Tensor, u_width: torch.Tensor, u_start: torch.Tensor,
              param: int, axis: int) -> torch.Tensor:
    """Zero a span along ``axis`` (1 = frequency, 2 = time) of (B, F, T):
    width = u_width * param, start = u_start * (size - width), the
    positions in [start, start + width); u_* are (B,) uniforms in [0, 1)."""
    b, size = spec.shape[0], spec.shape[axis]
    width = u_width.to(spec.device, torch.float32) * param
    start = u_start.to(spec.device, torch.float32) * (size - width)
    pos = torch.arange(size, device=spec.device)[None, :]
    mask = (pos >= start[:, None]) & (pos < (start + width)[:, None])
    shape = [b, 1, 1]
    shape[axis] = size
    return torch.where(mask.reshape(shape), torch.zeros((), dtype=spec.dtype,
                                                        device=spec.device), spec)


def spec_augment(spec: torch.Tensor, generator: torch.Generator,
                 time_mask: int = 8, freq_mask: int = 16) -> torch.Tensor:
    """(B, n_mels, n_frames) -> a masked copy: one time and one frequency
    mask per example, iid, drawn from ``generator`` (on its device)."""
    b = spec.shape[0]
    u = torch.rand((4, b), generator=generator, device=generator.device)
    out = mask_axis(spec, u[0], u[1], time_mask, axis=2)
    return mask_axis(out, u[2], u[3], freq_mask, axis=1)
