"""NAFP baseline encoder: a separable conv stack with full-shape LayerNorm
(port of ``grafp_tpu.models.nafp``; reference
encoder/neural_audio_fp.py:12-46).

(B, 256, 32) spectrogram -> 8 stages, each a (1, 3)/stride-(1, 2) conv +
LayerNorm over all of (C, H, W) + ReLU, then a (3, 1)/stride-(2, 1) conv +
LN + ReLU, with channels 128, 128, 256, 256, 512, 512, 1024, 1024 ->
(B, 1024): the spatial dims reach 1 x 1 at stage 7. NCHW throughout; the
LayerNorm's parameters are (C, H, W), as the reference's.

Dtype rule, flax's: each conv casts its input and weight to the compute
dtype and returns it. The LayerNorm of a bf16 map rounds where the JAX
package's jitted forward does on the CPU: the mean and the variance
accumulate in f32 and are rounded to bf16, the centred map and sqrt(var +
eps) are rounded to bf16, their quotient stays f32 (XLA drops that
rounding), and the f32 affine is one fused multiply-add, so ReLU runs in
f32 and the next conv casts back.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from grafp_tpu_torch.models.layers import conv2d, torch_default_init

CHANNELS = (128, 128, 256, 256, 512, 512, 1024, 1024)  # chang_fp
LN_EPS = 1e-5


class FullShapeLayerNorm(nn.Module):
    """torch nn.LayerNorm(normalized_shape=[C, H, W]) with the JAX
    package's rounding: normalise and apply the affine over all of (C, H,
    W) of a (B, C, H, W) map."""

    def __init__(self, shape: Tuple[int, int, int]):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(shape))
        self.bias = nn.Parameter(torch.zeros(shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var, mu = torch.var_mean(x.float(), (1, 2, 3), correction=0, keepdim=True)
        if x.dtype == torch.float32:
            y = (x - mu) / torch.sqrt(var + LN_EPS)
        else:
            # XLA's rounding of the JAX expression under jit: the centred
            # map, eps and sqrt(var + eps) in bf16, the quotient in f32
            eps = float(torch.tensor(LN_EPS).to(x.dtype))
            den = torch.sqrt(var.to(x.dtype) + eps)
            y = (x - mu.to(x.dtype)).float() / den.float()
        return torch.addcmul(self.bias, y, self.weight)


def _out(n: int, k: int) -> int:
    """Output length of a kernel-k, stride-2, pad-(k // 2) axis (k = 1: the
    stride-1 axis)."""
    return n if k == 1 else (n + 2 * (k // 2) - k) // 2 + 1


class NAFPEncoder(nn.Module):
    """(B, in_height, in_width) spectrogram -> (B, 1024) embedding."""

    def __init__(self, in_height: int = 256, in_width: int = 32,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.out_features = CHANNELS[-1]
        h, w, c_in = in_height, in_width, 1
        for i, ch in enumerate(CHANNELS):
            w = _out(w, 3)
            setattr(self, f"conv{i}a", nn.Conv2d(c_in, ch, (1, 3), stride=(1, 2),
                                                 padding=(0, 1)))
            setattr(self, f"ln{i}a", FullShapeLayerNorm((ch, h, w)))
            h = _out(h, 3)
            setattr(self, f"conv{i}b", nn.Conv2d(ch, ch, (3, 1), stride=(2, 1),
                                                 padding=(1, 0)))
            setattr(self, f"ln{i}b", FullShapeLayerNorm((ch, h, w)))
            c_in = ch

    def init_weights(self, g: torch.Generator) -> None:
        # the reference's conv default: U(+-1/sqrt(fan_in)), fan_in = 3 * C_in
        for i in range(len(CHANNELS)):
            for name in (f"conv{i}a", f"conv{i}b"):
                conv = getattr(self, name)
                torch_default_init(conv.weight, conv.bias, conv.weight[0].numel(), g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x[:, None]
        for i in range(len(CHANNELS)):
            for half in "ab":
                y = conv2d(y, getattr(self, f"conv{i}{half}"), self.dtype)
                y = F.relu(getattr(self, f"ln{i}{half}")(y), inplace=True)
        return y.reshape(y.shape[0], -1)
