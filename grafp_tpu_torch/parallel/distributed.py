"""Several processes and several devices (port of
``grafp_tpu.parallel.distributed``).

* training: data parallel across processes, one card each, launched by
  ``torchrun --nproc_per_node N``. ``initialize_distributed`` joins the
  process group; the train step then computes what the JAX package's
  global-batch program computes (``train/step.py``): BatchNorm statistics
  and NT-Xent negatives over the global batch, through the autograd-aware
  collectives below, and gradients averaged across ranks.
* retrieval: one process lays the database rows over the 'db' axis of a
  ``DeviceMesh`` (``retrieval_mesh``); each device scores its shard and
  the candidates merge on the first (``retrieval/search.py``).
* hybrid: ('data', 'db') for concurrent fingerprinting and search.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist

from grafp_tpu_torch.core.device import resolve_device
from grafp_tpu_torch.core.mesh import DeviceMesh, make_mesh, visible_devices


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device: Optional[Union[str, torch.device]] = None) -> bool:
    """Join the process group of a multi-process run; a no-op for one
    process. Call before any work on the device.

    With no arguments it reads torchrun's environment (WORLD_SIZE, RANK,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT); ``coordinator_address``
    (host:port), ``num_processes`` and ``process_id`` override it. The
    backend follows ``device`` (None = the card): NCCL on a card, gloo on
    the CPU. On a card the process also takes card LOCAL_RANK as its
    current device, so that ``resolve_device(None)`` gives the rank's own.
    Returns whether this call joined a group (the caller then destroys it
    when done)."""
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", 1))
    if world <= 1 or dist.is_initialized():
        return False
    rank = int(process_id if process_id is not None else os.environ["RANK"])
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init, world_size=world, rank=rank)
    return True


def group_active() -> bool:
    """Whether this process belongs to an initialised process group (a
    group of one included, as on a one-card machine)."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if group_active() else 1


def rank() -> int:
    return dist.get_rank() if group_active() else 0


class _AllGather(torch.autograd.Function):
    """Every rank's ``x`` stacked along a new leading axis, (world, *x).
    The backward sums the cotangent over the ranks and keeps this rank's
    slice: each rank then holds world x its share of the gradient of the
    loss that every rank computes in full, and averaging the gradients
    across ranks removes the factor."""

    @staticmethod
    def forward(ctx, x):
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x.contiguous())
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g)
        return g[dist.get_rank()]


class _AllReduceSum(torch.autograd.Function):
    """The sum of ``x`` over the ranks; the backward sums the cotangent
    over the ranks too (see ``_AllGather`` for the factor)."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """(world, *x.shape): every rank's ``x``, differentiable."""
    return _AllGather.apply(x)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable."""
    return _AllReduceSum.apply(x)


def average_gradients(params) -> None:
    """Each parameter's gradient replaced by its mean over the ranks, in
    one all-reduce of one flat f32 buffer; every rank then holds the same
    bits."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).to(torch.float32) for g in grads])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n


def barrier() -> None:
    if group_active():
        dist.barrier()


def training_mesh(devices: Optional[Sequence[torch.device]] = None) -> DeviceMesh:
    """Every device on the 'data' axis."""
    return make_mesh(n_data=0, n_db=1, devices=devices)


def retrieval_mesh(devices: Optional[Sequence[torch.device]] = None) -> DeviceMesh:
    """Every device on the 'db' axis."""
    devices = list(visible_devices() if devices is None else devices)
    return make_mesh(n_data=1, n_db=len(devices), devices=devices)


def hybrid_mesh(n_db: int, devices: Optional[Sequence[torch.device]] = None) -> DeviceMesh:
    """n_db devices on 'db', the remaining ones on 'data'."""
    return make_mesh(n_data=0, n_db=n_db, devices=devices)
