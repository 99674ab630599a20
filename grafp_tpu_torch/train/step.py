"""The training step (port of ``grafp_tpu.train.step.make_train_step``).

    raw waves (x_i, x_j) -> augment x_j (IR + SNR noise) -> log-mel of
    both views -> ONE stacked 2B forward through PeakEmbed, GraphEncoder
    and the projector in train mode -> NT-Xent -> backward -> Adam.

Both views go through the model as one 2B batch, so BatchNorm statistics
are joint over (x_i, x_j), as in the JAX package (the reference runs two
forwards, simclr.py:29-45). The augment and the log-mel take no
gradient.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch

from grafp_tpu_torch.core.device import resolve_device
from grafp_tpu_torch.dsp.augment import AugmentBanks, augment_waveforms
from grafp_tpu_torch.dsp.melspec import LogMelConfig, log_mel_spectrogram
from grafp_tpu_torch.train.loss import ntxent_loss
from grafp_tpu_torch.train.state import TrainState


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    return torch.sqrt(sum(torch.sum(t.to(torch.float32) ** 2) for t in tensors))


def make_train_step(model: torch.nn.Module, cfg,
                    banks: Optional[AugmentBanks] = None,
                    device: Optional[Union[str, torch.device]] = None) -> Callable:
    """Build the train step for ``model`` on ``device`` (None = the CUDA
    card; raises without it).

    step(state, x_i, x_j, generator) -> {"loss", "grad_norm"}
      x_i, x_j: (B, T) f32 raw waveforms (x_j before augmentation);
      generator: the torch.Generator the augment draws from. Updates
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
        with torch.no_grad():
            if banks is not None:
                x_j = augment_waveforms(x_j, banks, generator, snr, ir_p, noise_p)
            spec = log_mel_spectrogram(torch.cat([x_i, x_j]), mcfg)
        _, z = model.train()(spec)
        b = x_i.shape[0]
        loss = ntxent_loss(z[:b], z[b:], tau)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        gnorm = global_norm(grads)
        for group in state.optimizer.param_groups:
            group["lr"] = state.schedule(state.step)
        state.optimizer.step()
        state.step += 1
        return {"loss": loss.detach(), "grad_norm": gnorm.detach()}

    return step
