"""Device mesh and row-sharding helpers (port of ``grafp_tpu.core.mesh``).

A ``DeviceMesh`` is a (data, db) grid of ``torch.device``s under the axis
names of the JAX package:

    'data'  the batch axis of training and fingerprint generation;
    'db'    the database-row axis of retrieval: each device scores its
            shard of the rows and takes a local top-k, and the candidates
            are merged on the first device (``retrieval/search.py``).

One process drives every device of a mesh, as a single JAX controller
drives a ``shard_map``; data-parallel training across processes goes
through ``torch.distributed`` instead (``parallel/distributed.py``).
The same device may stand in several cells of a mesh (the CPU tests lay
8 'db' shards on the CPU; the one-card smoke run lays 4 on the card).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

DATA_AXIS = "data"
DB_AXIS = "db"


class DeviceMesh:
    """A grid of devices, ``devices[i][j]`` at data index i, db index j;
    ``shape`` maps each axis name to its size, as a JAX mesh's does."""

    def __init__(self, devices: Sequence[Sequence[torch.device]]):
        self.devices = [[torch.device(d) for d in row] for row in devices]
        self.axis_names = (DATA_AXIS, DB_AXIS)
        self.shape: Dict[str, int] = {DATA_AXIS: len(self.devices),
                                      DB_AXIS: len(self.devices[0])}

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` at index 0 of the other axis."""
        if axis == DATA_AXIS:
            return [row[0] for row in self.devices]
        if axis == DB_AXIS:
            return list(self.devices[0])
        raise ValueError(f"unknown mesh axis {axis!r}")

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape}, {self.devices})"


def visible_devices() -> List[torch.device]:
    """The CUDA cards this process sees (none on a host without CUDA)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_data: int = 0, n_db: int = 1,
              devices: Optional[Sequence[Union[str, torch.device]]] = None) -> DeviceMesh:
    """A ('data', 'db') mesh over ``devices`` (None = the visible cards;
    on the CPU, pass them). n_data = 0 means all remaining devices; for one
    axis pass n_db = 1 (training) or n_data = 1 (retrieval). Raises
    ValueError when the devices do not divide by n_db or are too few."""
    devices = list(visible_devices() if devices is None else devices)
    total = len(devices)
    if n_data == 0:
        if total % max(n_db, 1) != 0:
            raise ValueError(f"{total} devices not divisible by n_db={n_db}")
        n_data = total // max(n_db, 1)
    use = n_data * n_db
    if use > total:
        raise ValueError(f"mesh {n_data}x{n_db} needs {use} > {total} devices")
    if use == 0:
        raise ValueError("a mesh needs at least one device")
    return DeviceMesh([devices[i * n_db:(i + 1) * n_db] for i in range(n_data)])


def db_mesh_from_config(cfg) -> Optional[DeviceMesh]:
    """Retrieval mesh from the config's ``mesh_db`` knob, or None.

    ``mesh_db > 1`` lays that many visible cards on the 'db' axis, so that
    eval_faiss -> get_index('l2') builds the sharded index
    (IndexFlatSharded) and the scan family shards its rows. The default
    (0 or 1) keeps the single-card path. Returns None, and never raises,
    when the host has fewer cards, so a config written for several cards
    still runs on one."""
    n_db = int(cfg.get("mesh_db", 0) or 0) if hasattr(cfg, "get") else int(cfg)
    if n_db <= 1:
        return None
    devices = visible_devices()
    if len(devices) < n_db:
        print(f"[mesh] mesh_db={n_db} requested but only {len(devices)} "
              f"device(s) visible; falling back to single-chip retrieval")
        return None
    return make_mesh(n_data=1, n_db=n_db, devices=devices[:n_db])


def local_batch_size(global_batch: int, mesh: Union[DeviceMesh, int]) -> int:
    """Rows per 'data' shard (``mesh`` may also be the shard count, e.g.
    the process group's world size); raises when they do not divide."""
    n = mesh.shape[DATA_AXIS] if isinstance(mesh, DeviceMesh) else int(mesh)
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} % {n} devices != 0")
    return global_batch // n


def shard_rows(x: Union[np.ndarray, torch.Tensor], mesh: DeviceMesh,
               axis: str = DB_AXIS, multiple: int = 1,
               fill: float = 0) -> List[torch.Tensor]:
    """``x`` split by rows over the devices of ``axis``: rows padded with
    ``fill`` to a multiple of (devices x ``multiple``), then one equal
    piece per device, on that device (the counterpart of ``device_put``
    with a row sharding). Pad rows are the caller's to mask."""
    x = torch.as_tensor(x)
    devices = mesh.axis_devices(axis)
    step = len(devices) * max(int(multiple), 1)
    pad = (-x.shape[0]) % step
    if pad:
        x = torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill,
                                     dtype=x.dtype, device=x.device)])
    per = x.shape[0] // len(devices)
    return [x[i * per:(i + 1) * per].to(d) for i, d in enumerate(devices)]
