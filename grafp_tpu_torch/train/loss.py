"""NT-Xent contrastive loss (port of ``grafp_tpu.train.loss``).

z = interleave(z_i, z_j) row-wise -> (2B, d), pairs at (2t, 2t+1), as the
reference's stack(dim=1).view (simclr/ntxent.py:4-29). Row r's positive
is r XOR 1; the self column is masked to -inf, which equals the
reference's slicing-out of self.
"""

from __future__ import annotations

import torch


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
