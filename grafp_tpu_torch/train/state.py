"""Train state and optimisation schedule (port of
``grafp_tpu.train.state``).

Optimizer parity with the reference (train.py:174-175): Adam(lr=8e-5,
betas (0.9, 0.999), eps 1e-8) and CosineAnnealingLR stepped once per
EPOCH with T_max=400 and eta_min=7e-7, in closed form:
    lr(e) = eta_min + (lr0 - eta_min) * (1 + cos(pi * min(e, T_max) / T_max)) / 2
(the phase is clamped at T_max: the reference trains exactly T_max
epochs).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch


def cosine_epoch_schedule(lr: float, min_lr: float, t_max: int,
                          steps_per_epoch: int) -> Callable[[int], float]:
    """step -> learning rate of the per-epoch cosine schedule."""

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        phase = min(epoch, t_max) / t_max
        return min_lr + (lr - min_lr) * 0.5 * (1.0 + math.cos(math.pi * phase))

    return schedule


@dataclass
class TrainState:
    """The model (in train mode), its Adam optimizer, the schedule that
    sets the optimizer's lr before each update, and the count of updates
    taken. A train step updates it in place."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0


def create_train_state(model: torch.nn.Module, cfg,
                       steps_per_epoch: int = 1) -> TrainState:
    """Adam over every parameter of ``model`` with the config's cosine
    schedule; puts the model in train mode. Refuses a config with
    ``serve_quant`` set: the int8 round() has zero gradient, so training
    would silently not learn."""
    if str(cfg["serve_quant"] or "none").lower() != "none":
        raise ValueError("serve_quant is extraction-only; unset it for "
                         "training (the int8 round() has zero gradient)")
    schedule = cosine_epoch_schedule(cfg["lr"], cfg["min_lr"], cfg["T_max"],
                                     steps_per_epoch)
    optimizer = torch.optim.Adam(model.parameters(), lr=schedule(0),
                                 betas=(0.9, 0.999), eps=1e-8)
    return TrainState(model=model.train(), optimizer=optimizer,
                      schedule=schedule)
