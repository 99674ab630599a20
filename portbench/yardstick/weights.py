"""Weights of a cell, made from the seed on the run's device in one draw,
then calibrated so that seeded weights act like trained ones.

``make_weights`` fills every float entry of the program's state_dict
template (its names and shapes only) from one ``torch.randn`` on a
generator on the device: a weight of fan-in f as N(0, 2 / f) (He), a
bias as 0.02 N(0, 1), a BatchNorm or LayerNorm scale as 1 + 0.1 N(0, 1)
and its shift as 0.1 N(0, 1) (as ``tests/torch_port_util.py``'s
``randomize_jax_variables`` and ``calibrate_baseline`` draw them), running
statistics 0 and 1.

``calibrate`` is a frozen copy of ``tests/torch_port_util.py:152-193``
computed by the reference, not the program: every residual branch's last
BatchNorm scale times 0.1, then every BatchNorm's running statistics set
to the batch statistics of its input in one train-mode reference forward.
Without it the fingerprints of unrelated inputs crowd (mean pairwise
cosine 0.999996), so no comparison of rows could tell wrong from right.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.reference.grafp import Pass
from portbench.reference.ops import Precision, exact_float32

RESIDUAL_GAIN = 0.1
NORM_MARKS = ("_bn.", ".bn.", ".ln")


def _fan_in(name: str, shape) -> int:
    if "gconv" in name and len(shape) == 3:       # grouped (g, c_in / g, c_out / g)
        return int(shape[1])
    n = 1
    for s in shape[1:]:
        n *= int(s)
    return n


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % (1 << 63))


def make_weights(template: Dict[str, torch.Tensor], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for every floating entry of
    ``template`` but int8 serving's activation maxima (``amax``, which a
    quantised model adds), drawn as the module says from one generator
    seeded with ``seed``: the same weights whatever the serving mode."""
    names = [k for k, v in template.items()
             if v.is_floating_point() and not k.endswith("amax")]
    total = sum(template[k].numel() for k in names)
    flat = torch.randn(total, generator=generator(seed, device), device=device)
    out, off = {}, 0
    for k in names:
        shape = template[k].shape
        v = flat[off:off + template[k].numel()].view(shape)
        off += template[k].numel()
        norm = any(m in k for m in NORM_MARKS)
        if k.endswith("running_mean"):
            v = torch.zeros_like(v)
        elif k.endswith("running_var"):
            v = torch.ones_like(v)
        elif norm and k.endswith("weight"):
            v = 1.0 + 0.1 * v
        elif norm and k.endswith("bias"):
            v = 0.1 * v
        elif k.endswith("bias") or v.dim() < 2:
            v = 0.02 * v
        else:
            v = v * (2.0 / _fan_in(k, shape)) ** 0.5
        out[k] = v.contiguous()
    return out


@torch.no_grad()
def calibrate(sd: Dict[str, torch.Tensor], ref, spec: torch.Tensor, cfg: dict) -> None:
    """In place: residual gains, then running statistics from one
    train-mode reference forward of the log-mel ``spec``."""
    for k in ref.residual_scales(sd):
        sd[k].mul_(RESIDUAL_GAIN)
    ps = Pass(sd, Precision("f32"), train=True)
    with exact_float32():
        ref.forward(sd, spec, cfg, ps=ps)
    for name, (mean, var) in ps.stats.items():
        sd[f"{name}.running_mean"] = mean.contiguous()
        sd[f"{name}.running_var"] = var.contiguous()
