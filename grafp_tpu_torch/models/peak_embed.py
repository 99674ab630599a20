"""Spectrogram -> node-embedding frontend (port of
``grafp_tpu.models.peak_embed.PeakEmbed``).

Per-example min-max normalisation (guarded by 1e-8 for silent segments),
two linspace coordinate channels in [T, F, S] order, one 7x7 conv with
stride (2, 1) and ReLU, then graph nodes with index mel_row * W + col.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from grafp_tpu_torch.models.layers import normal_


class PeakEmbed(nn.Module):
    def __init__(self, n_filters: int = 8, kernel: Tuple[int, int] = (7, 7),
                 stride: int = 2, dtype: Optional[torch.dtype] = None):
        super().__init__()
        kh, kw = kernel
        self.n_filters = n_filters
        self.conv = nn.Conv2d(3, n_filters, (kh, kw), stride=(stride, 1),
                              padding=(kh // 2, kw // 2),
                              dtype=dtype or torch.float32)

    def init_weights(self, g: torch.Generator) -> None:
        # kaiming_normal over fan_out, zero bias
        w = self.conv.weight
        normal_(w, math.sqrt(2.0 / (w.shape[0] * w.shape[2] * w.shape[3])), g)
        with torch.no_grad():
            self.conv.bias.zero_()

    def forward(self, spec: torch.Tensor) -> torch.Tensor:
        """(B, n_mels, n_frames) -> (B, N, n_filters)."""
        b, h, w = spec.shape
        mn = torch.amin(spec, dim=(1, 2), keepdim=True)
        mx = torch.amax(spec, dim=(1, 2), keepdim=True)
        s = (spec - mn) / torch.clamp(mx - mn, min=1e-8)
        t_coord = torch.linspace(0.0, 1.0, w, device=spec.device,
                                 dtype=s.dtype).view(1, 1, w).expand(b, h, w)
        f_coord = torch.linspace(0.0, 1.0, h, device=spec.device,
                                 dtype=s.dtype).view(1, h, 1).expand(b, h, w)
        x = torch.stack([t_coord, f_coord, s], dim=1)       # (B, 3, H, W)
        y = F.relu(self.conv(x.to(self.conv.weight.dtype)))  # (B, C, H/2, W)
        return y.permute(0, 2, 3, 1).reshape(b, -1, self.n_filters)
