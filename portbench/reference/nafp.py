"""Plain reference of the NAFP baseline (Chang et al., ICASSP 2021,
arXiv:2010.11910) as GraFPrint's baselines define it
(encoder/neural_audio_fp.py): a (B, 256, 32) log-mel map through eight
stages, each a (1, 3) conv of stride (1, 2) and a (3, 1) conv of stride
(2, 1), every conv followed by a LayerNorm over the whole (C, H, W) map
and ReLU, channels 128, 128, 256, 256, 512, 512, 1024, 1024, down to a
1024-d vector; then the projector and an L2 norm, as for GraFPrint.

Over a flat dict of float32 tensors keyed by the program's state_dict
names; products in float32 without TF32 (``ops.exact_float32``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from portbench.reference.grafp import Pass, projector
from portbench.reference.ops import Precision

STAGES = 8
LN_EPS = 1e-5


def encoder(ps: Pass, spec: torch.Tensor) -> torch.Tensor:
    sd = ps.sd
    y = spec.to(torch.float32)[:, None]
    for i in range(STAGES):
        for half, stride, pad in (("a", (1, 2), (0, 1)), ("b", (2, 1), (1, 0))):
            y = ps.p.conv2d(y, sd[f"encoder.conv{i}{half}.weight"],
                            sd[f"encoder.conv{i}{half}.bias"], stride=stride, padding=pad)
            var, mu = torch.var_mean(y, dim=(1, 2, 3), correction=0, keepdim=True)
            y = (y - mu) / torch.sqrt(var + LN_EPS)
            y = F.relu(y * sd[f"encoder.ln{i}{half}.weight"] + sd[f"encoder.ln{i}{half}.bias"])
    return y.reshape(y.shape[0], -1)


def forward(sd: Dict[str, torch.Tensor], spec: torch.Tensor, cfg: dict,
            precision: Optional[Precision] = None, train: bool = False,
            ps: Optional[Pass] = None) -> torch.Tensor:
    """(B, 256, 32) log-mel -> (B, d) fingerprints in float32 (NAFP has
    no BatchNorm, so ``train`` changes nothing)."""
    ps = ps or Pass(sd, precision or Precision("f32"), train)
    return projector(ps, encoder(ps, spec))


def residual_scales(sd: Dict[str, torch.Tensor]):
    return []
