"""The training step (port of ``grafp_tpu.train.step.make_train_step``).

    raw waves (x_i, x_j) -> augment x_j (IR + SNR noise) -> log-mel of
    both views -> ONE stacked 2B forward through PeakEmbed, GraphEncoder
    and the projector in train mode -> NT-Xent -> backward -> Adam.

Both views go through the model as one 2B batch, so BatchNorm statistics
are joint over (x_i, x_j), as in the JAX package (the reference runs two
forwards, simclr.py:29-45). The augment and the log-mel take no
gradient. The step's generator feeds the augment and then the model's
DropPath masks ('ramp' schedule), as the JAX step's key feeds both
(``grafp_tpu/train/step.py:55-67``).

Data parallel (``torchrun``, ``parallel/distributed.py``): under a process
group of N ranks each rank passes its own b = B / N rows of x_i and x_j,
rows [r b, (r + 1) b) of the global batch, and the step computes what the
JAX package's global-batch program computes on B rows. The augment and the
DropPath masks are drawn for the global batch from the step's generator,
the same on every rank, and each rank keeps its rows (in the stacked 2B
batch: [r b, (r + 1) b) and B + [r b, (r + 1) b)); BatchNorm statistics
and NT-Xent negatives are global (``models/layers.BatchNorm``,
``train/loss.global_views``); the gradients are averaged over the ranks.
The loss and grad norm are the global batch's, bit-equal on every rank,
and so are the parameters after the update.

One answer for one input, as the JAX package's jitted step gives: the
forward and the backward run under ``deterministic_convolutions``. cuDNN
otherwise picks, for the weight gradients of the PeakEmbed and Downsample
convolutions in f32, of AST's patch conv in f32 and of NAFP's convs in
f32 and bf16, algorithms that add in another order on every run
(ROADMAP.md C11, C13); it chooses during the backward, so the scope
encloses ``loss.backward()``. It is scoped to the step: serving keeps
the algorithms it captured.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, Optional, Union

import torch

from grafp_tpu_torch.core.device import resolve_device
from grafp_tpu_torch.dsp.augment import (
    AugmentBanks,
    augment_with_draws,
    sample_augment_draws,
)
from grafp_tpu_torch.dsp.melspec import LogMelConfig, log_mel_spectrogram
from grafp_tpu_torch.models.layers import drop_path_generator
from grafp_tpu_torch.parallel import distributed
from grafp_tpu_torch.train.loss import global_views, ntxent_loss
from grafp_tpu_torch.train.state import TrainState


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    return torch.sqrt(sum(torch.sum(t.to(torch.float32) ** 2) for t in tensors))


@contextlib.contextmanager
def deterministic_convolutions() -> Iterator[None]:
    """Inside the block cuDNN runs only its deterministic convolution
    algorithms (its other settings untouched); the flag is restored on
    exit. The step has no path around them."""
    cudnn = torch.backends.cudnn
    before = cudnn.deterministic
    cudnn.deterministic = True
    try:
        yield
    finally:
        cudnn.deterministic = before


def make_train_step(model: torch.nn.Module, cfg,
                    banks: Optional[AugmentBanks] = None,
                    device: Optional[Union[str, torch.device]] = None) -> Callable:
    """Build the train step for ``model`` on ``device`` (None = the CUDA
    card; raises without it).

    step(state, x_i, x_j, generator) -> {"loss", "grad_norm"}
      x_i, x_j: (B, T) f32 raw waveforms (x_j before augmentation), the
        rank's own rows under a process group;
      generator: the torch.Generator the augment, then DropPath, draw
      from. Updates
      ``state`` (parameters, BatchNorm running statistics, optimizer,
      step) in place; the metrics are 0-d f32 tensors on the device."""
    dev = resolve_device(device)
    mcfg = LogMelConfig.from_config(cfg)
    tau = float(cfg["tau"])
    snr = tuple(float(s) for s in cfg["tr_snr"])
    ir_p = float(cfg["ir_prob"])
    noise_p = float(cfg["noise_prob"])
    if banks is not None and banks.noise is None and banks.ir is None:
        banks = None
    banks = banks.to(dev) if banks is not None else None

    def step(state: TrainState, x_i, x_j, generator: torch.Generator
             ) -> Dict[str, torch.Tensor]:
        if state.model is not model:
            raise ValueError("make_train_step: the state holds another model")
        x_i = torch.as_tensor(x_i, dtype=torch.float32, device=dev)
        x_j = torch.as_tensor(x_j, dtype=torch.float32, device=dev)
        b = x_i.shape[0]
        parallel = distributed.group_active()
        r, n = distributed.rank(), distributed.world_size()
        mine = slice(r * b, (r + 1) * b)
        with torch.no_grad():
            if banks is not None:
                draws = sample_augment_draws(banks, n * b, generator, snr, ir_p, noise_p)
                x_j = augment_with_draws(x_j, banks, draws.rows(mine) if parallel else draws,
                                         ir_p, noise_p)
            spec = log_mel_spectrogram(torch.cat([x_i, x_j]), mcfg)
        rows = None
        if parallel:
            own = torch.arange(mine.start, mine.stop, device=generator.device)
            rows = (2 * n * b, torch.cat([own, n * b + own]))
        with deterministic_convolutions():
            with drop_path_generator(model, generator, rows):
                _, z = model.train()(spec)
            loss = ntxent_loss(*global_views(z[:b], z[b:]), tau)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        if parallel:
            distributed.average_gradients(model.parameters())
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        gnorm = global_norm(grads)
        for group in state.optimizer.param_groups:
            group["lr"] = state.schedule(state.step)
        state.optimizer.step()
        state.step += 1
        return {"loss": loss.detach(), "grad_norm": gnorm.detach()}

    return step
