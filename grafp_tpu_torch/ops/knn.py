"""Row normalisation (port of ``grafp_tpu.ops.knn.l2_normalize``)."""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """torch.nn.functional.normalize semantics: x / max(||x||, eps)."""
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(n, min=eps)
