"""Plain reference of GraFPrint's SimCLR training step (GraFP train.py,
simclr/ntxent.py): augment the second view, log-mel of both views, one
train-mode forward of the 2B stacked batch (BatchNorm on the batch's
statistics), NT-Xent at temperature tau over the interleaved pairs,
autograd, then Adam (betas 0.9 / 0.999, eps 1e-8, the learning rate of
the per-epoch cosine schedule) over every parameter.

float32 products without TF32; each Grapher and FFN is recomputed in the
backward (``torch.utils.checkpoint``) so that a 512-row step fits beside
nothing else on the card.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference import augment as ref_augment
from portbench.reference import grafp
from portbench.reference.logmel import log_mel
from portbench.reference.ops import Precision, exact_float32

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def cosine_lr(cfg: dict, steps_per_epoch: int) -> Callable[[int], float]:
    """step -> learning rate: lr0 down to min_lr over T_max epochs by a
    cosine, stepped once an epoch (the reference's CosineAnnealingLR)."""
    lr, min_lr, t_max = float(cfg["lr"]), float(cfg["min_lr"]), int(cfg["T_max"])

    def at(step: int) -> float:
        phase = min(step // max(steps_per_epoch, 1), t_max) / t_max
        return min_lr + (lr - min_lr) * 0.5 * (1.0 + math.cos(math.pi * phase))

    return at


def ntxent(z_i: torch.Tensor, z_j: torch.Tensor, tau: float) -> torch.Tensor:
    """The mean over all 2B rows of the cross-entropy of each row's
    similarities (self left out) against its pair's."""
    b = z_i.shape[0]
    z = torch.stack([z_i, z_j], dim=1).reshape(2 * b, -1)
    sim = (z @ z.t()) / tau
    sim = sim.masked_fill(torch.eye(2 * b, dtype=torch.bool, device=z.device), float("-inf"))
    target = torch.arange(2 * b, device=z.device) ^ 1
    return F.cross_entropy(sim, target)


def grafp_train_forward(params: Dict[str, torch.Tensor], spec: torch.Tensor, cfg: dict,
                        precision: Precision) -> torch.Tensor:
    """The train-mode grafp forward with each block recomputed in the
    backward."""
    ps = grafp.Pass(params, precision, train=True)
    blocks, _ = grafp.SIZES[cfg["size"]]
    k = int(cfg["k"])
    e = "encoder"
    x = grafp.peak_embed(ps, spec, cfg)
    x = F.leaky_relu(ps.bn(f"{e}.stem_bn", ps.linear(f"{e}.stem", x)), 0.2)
    idx = 0
    for stage, nb in enumerate(blocks):
        if stage > 0:
            x = grafp.downsample(ps, f"{e}.down{stage}", x)
        for _ in range(nb):
            x = checkpoint(grafp.grapher, ps, f"{e}.block{idx}_grapher", x, k, use_reentrant=False)
            x = checkpoint(grafp.ffn, ps, f"{e}.block{idx}_ffn", x, use_reentrant=False)
            idx += 1
    return grafp.projector(ps, ps.linear(f"{e}.proj", x).mean(dim=1))


def train_steps(sd: Dict[str, torch.Tensor], batches: List[tuple],
                generators: List[torch.Generator], banks: ref_augment.Banks, cfg: dict,
                steps_per_epoch: int, precision: Precision, trainable: List[str]) -> dict:
    """Run len(batches) steps from the weights ``sd`` (not changed). Each
    batch is (x_i, x_j) raw clips; ``generators[s]`` gives step s's
    augment draws. Returns the loss of every step, the first step's
    gradient of every parameter, and the parameters after the last
    step."""
    params = {k: v.detach().clone() for k, v in sd.items()}
    for name in trainable:
        params[name].requires_grad_(True)
    m = {n: torch.zeros_like(params[n]) for n in trainable}
    v = {n: torch.zeros_like(params[n]) for n in trainable}
    lr_at = cosine_lr(cfg, steps_per_epoch)
    losses, first_grad = [], None
    tau = float(cfg["tau"])
    snr = tuple(float(s) for s in cfg["tr_snr"])
    for step, ((x_i, x_j), g) in enumerate(zip(batches, generators)):
        b = x_i.shape[0]
        with torch.no_grad():
            d = ref_augment.draws(banks, b, g, snr)
            x_j = ref_augment.augment(x_j, banks, d, float(cfg["ir_prob"]),
                                      float(cfg["noise_prob"]))
            spec = log_mel(torch.cat([x_i.to(torch.float64), x_j]), cfg)
        with exact_float32():
            z = grafp_train_forward(params, spec, cfg, precision)
            loss = ntxent(z[:b], z[b:], tau)
            grads = torch.autograd.grad(loss, [params[n] for n in trainable])
        losses.append(float(loss.detach()))
        if first_grad is None:
            first_grad = {n: gr.detach().clone() for n, gr in zip(trainable, grads)}
        lr = lr_at(step)
        t = step + 1
        with torch.no_grad():
            for n, gr in zip(trainable, grads):
                m[n].mul_(BETAS[0]).add_(gr, alpha=1 - BETAS[0])
                v[n].mul_(BETAS[1]).addcmul_(gr, gr, value=1 - BETAS[1])
                denom = (v[n] / (1 - BETAS[1] ** t)).sqrt_().add_(ADAM_EPS)
                params[n].addcdiv_(m[n], denom, value=-lr / (1 - BETAS[0] ** t))
    return {"losses": losses, "first_grad": first_grad,
            "params": {n: params[n].detach() for n in trainable}}
