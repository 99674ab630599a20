"""NT-Xent contrastive loss (port of ``grafp_tpu.train.loss``).

z = interleave(z_i, z_j) row-wise -> (2B, d), pairs at (2t, 2t+1), as the
reference's stack(dim=1).view (simclr/ntxent.py:4-29). Row r's positive
is r XOR 1; the self column is masked to -inf, which equals the
reference's slicing-out of self.

Under data-parallel training ``global_views`` gathers every rank's
projections, so that each rank computes the loss of the global batch with
its global negatives, as the JAX package's global-batch step does.
"""

from __future__ import annotations

from typing import Tuple

import torch

from grafp_tpu_torch.parallel import distributed


def global_views(z_i: torch.Tensor, z_j: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's (b, d) views -> the global batch's (B, d) views, in
    JAX's order: rank 0's rows, then rank 1's, ..., so that each positive
    pair stays the pair that the single-process step pairs. Differentiable
    (``distributed.all_gather``); the identity without a process group."""
    if not distributed.group_active():
        return z_i, z_j
    b = z_i.shape[0]
    z = distributed.all_gather(torch.cat([z_i, z_j]))      # (world, 2b, d)
    return z[:, :b].reshape(-1, z.shape[-1]), z[:, b:].reshape(-1, z.shape[-1])


def ntxent_loss(z_i: torch.Tensor, z_j: torch.Tensor, tau: float) -> torch.Tensor:
    """z_i, z_j: (B, d) L2-normalised projections. Returns the scalar f32
    loss. Similarities accumulate in f32 (bf16 products are exact in
    f32)."""
    b, d = z_i.shape
    z = torch.stack([z_i, z_j], dim=1).reshape(2 * b, d).to(torch.float32)
    sim = torch.matmul(z, z.t()) / tau
    n = 2 * b
    diag = torch.eye(n, dtype=torch.bool, device=z.device)
    logits = sim.masked_fill(diag, float("-inf"))
    log_prob = logits - torch.nan_to_num(logits.amax(dim=1, keepdim=True))
    log_prob = log_prob - torch.log(torch.exp(log_prob).sum(dim=1, keepdim=True))
    rows = torch.arange(n, device=z.device)
    return -torch.mean(log_prob[rows, rows ^ 1])
