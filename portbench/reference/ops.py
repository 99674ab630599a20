"""Products of the plain reference, in float32 (TF32 off) or, for the
correctness control, with both operands rounded to float8 e4m3 first.

The control stands for the precision below the configuration's
bfloat16: each operand of every product is scaled by one factor per
tensor (max |x| / 448, the e4m3 maximum), rounded to e4m3 and scaled
back, then multiplied in float32. Gradients pass the rounding unchanged
(straight through), so a training control still learns.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one per-tensor scale, in float32,
    with an identity gradient."""
    x32 = x.to(torch.float32)
    scale = torch.clamp(x32.detach().abs().amax() / E4M3_MAX, min=1e-30)
    q = (x32.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x32 + (q - x32.detach())


ROUNDING = {"f32": lambda x: x.to(torch.float32), "fp8": fp8_round}


class Precision:
    """'f32' or 'fp8': how the reference's products round their operands."""

    def __init__(self, name: str = "f32"):
        if name not in ROUNDING:
            raise ValueError(f"precision {name!r}: one of {sorted(ROUNDING)}")
        self.name = name

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        return ROUNDING[self.name](x)

    def linear(self, x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (..., in) times w (out, in), plus b."""
        return F.linear(self.operand(x), self.operand(w), b)

    def conv1d(self, x, w, b, **kw):
        return F.conv1d(self.operand(x), self.operand(w), b, **kw)

    def conv2d(self, x, w, b, **kw):
        return F.conv2d(self.operand(x), self.operand(w), b, **kw)

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, self.operand(a), self.operand(b))


@contextlib.contextmanager
def exact_float32() -> Iterator[None]:
    """float32 products without TF32 inside the block (the card would
    otherwise round their operands to 10 mantissa bits); restored after."""
    mm, cd = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd
