"""The port's device mesh and its multi-process set-up on the CPU
(``grafp_tpu_torch.core.mesh``, ``grafp_tpu_torch.parallel``), mirroring
tests/test_mesh.py and tests/test_parallel.py on explicit lists of 8 CPU
devices beside the JAX package's 8 virtual devices: the same shapes, the
same errors, the presets, the row shards, the single-process
``initialize_distributed``, and ``db_mesh_from_config`` with no card (None
for mesh_db 0, 1 and 8, and the JAX package's notice, word for word, for
8)."""

import jax
import numpy as np
import pytest
import torch

from grafp_tpu.core import mesh as jmesh
from grafp_tpu.parallel import hybrid_mesh as j_hybrid_mesh
from grafp_tpu.parallel import retrieval_mesh as j_retrieval_mesh
from grafp_tpu.parallel import training_mesh as j_training_mesh
from grafp_tpu_torch.core import Config
from grafp_tpu_torch.core.mesh import (
    DATA_AXIS,
    DB_AXIS,
    DeviceMesh,
    db_mesh_from_config,
    local_batch_size,
    make_mesh,
    shard_rows,
)
from grafp_tpu_torch.parallel import (
    hybrid_mesh,
    initialize_distributed,
    retrieval_mesh,
    training_mesh,
)

CPUS = [torch.device("cpu")] * 8


def _shape(m):
    return (m.shape[DATA_AXIS], m.shape[DB_AXIS])


@pytest.mark.parametrize("n_data,n_db", [(0, 1), (4, 2), (1, 8), (0, 4), (2, 1)])
def test_make_mesh_shapes_match_jax(n_data, n_db):
    m = make_mesh(n_data, n_db, CPUS)
    j = jmesh.make_mesh(n_data, n_db)
    assert isinstance(m, DeviceMesh)
    assert _shape(m) == (j.shape[jmesh.DATA_AXIS], j.shape[jmesh.DB_AXIS])
    assert m.axis_names == tuple(j.axis_names)
    assert len(m.axis_devices(DATA_AXIS)) == m.shape[DATA_AXIS]
    assert len(m.axis_devices(DB_AXIS)) == m.shape[DB_AXIS]


@pytest.mark.parametrize("n_data,n_db", [(16, 1), (0, 3), (3, 3)])
def test_make_mesh_errors_match_jax(n_data, n_db):
    with pytest.raises(ValueError):
        jmesh.make_mesh(n_data, n_db)
    with pytest.raises(ValueError):
        make_mesh(n_data, n_db, CPUS)


def test_make_mesh_defaults_to_the_cards():
    """No devices given: the visible cards (none on a host without CUDA,
    where the mesh cannot be made)."""
    if torch.cuda.is_available():
        m = make_mesh()
        assert m.shape[DATA_AXIS] * m.shape[DB_AXIS] == torch.cuda.device_count()
    else:
        with pytest.raises(ValueError):
            make_mesh()


def test_presets_match_jax():
    assert _shape(training_mesh(CPUS)) == (8, 1) == (
        j_training_mesh().shape["data"], j_training_mesh().shape["db"])
    assert _shape(retrieval_mesh(CPUS)) == (1, 8) == (
        j_retrieval_mesh().shape["data"], j_retrieval_mesh().shape["db"])
    assert _shape(hybrid_mesh(2, CPUS)) == (4, 2) == (
        j_hybrid_mesh(n_db=2).shape["data"], j_hybrid_mesh(n_db=2).shape["db"])


def test_local_batch_size_matches_jax():
    m, j = make_mesh(devices=CPUS), jmesh.make_mesh()
    assert local_batch_size(256, m) == jmesh.local_batch_size(256, j) == 32
    assert local_batch_size(256, 2) == 128
    for fn, mesh in ((local_batch_size, m), (jmesh.local_batch_size, j)):
        with pytest.raises(ValueError):
            fn(10, mesh)


@pytest.mark.parametrize("rows", [16, 13])
def test_shard_rows_and_gather(rows):
    """Rows split like a 'db' row sharding: equal pieces in order, padded
    to a multiple of the device count (and of ``multiple``), one per
    device; concatenated, the rows come out in order."""
    x = torch.arange(rows * 2, dtype=torch.float32).reshape(rows, 2)
    m = make_mesh(n_data=1, n_db=8, devices=CPUS)
    shards = shard_rows(x, m)
    per = -(-rows // 8)
    assert [s.shape[0] for s in shards] == [per] * 8
    back = torch.cat(shards)
    assert torch.equal(back[:rows], x) and not back[rows:].any()
    # JAX's device_put over the 'db' axis holds the same rows per device
    xj = np.concatenate([x.numpy(), np.zeros((8 * per - rows, 2), np.float32)])
    put = jax.device_put(xj, jmesh.db_sharding(jmesh.make_mesh(n_data=1, n_db=8)))
    for got, want in zip(shards, sorted(put.addressable_shards,
                                        key=lambda s: s.index[0].start)):
        assert np.array_equal(got.numpy(), np.asarray(want.data))
    cells = shard_rows(torch.arange(rows), m, multiple=4, fill=-1)
    assert all(c.shape[0] % 4 == 0 for c in cells)
    assert int((torch.cat(cells) == -1).sum()) == 32 * -(-rows // 32) - rows
    data = shard_rows(x, make_mesh(n_data=4, n_db=2, devices=CPUS), axis=DATA_AXIS)
    assert len(data) == 4


def test_initialize_distributed_single_process_noop():
    assert initialize_distributed(device="cpu") is False
    assert initialize_distributed(num_processes=1, device="cpu") is False
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("mesh_db", [0, 1, 8])
def test_db_mesh_from_config_without_cards(mesh_db, capsys):
    """A config written for 8 cards runs on one (or none): None, and the
    JAX package's notice for 8. The JAX function sees its 8 virtual
    devices, so its notice is checked with mesh_db 9."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("this host has several cards")
    n = torch.cuda.device_count()
    assert db_mesh_from_config(Config(mesh_db=mesh_db)) is None
    out = capsys.readouterr().out
    if mesh_db <= 1:
        assert out == ""
        return
    assert out == (f"[mesh] mesh_db={mesh_db} requested but only {n} device(s) "
                   "visible; falling back to single-chip retrieval\n")
    assert jmesh.db_mesh_from_config({"mesh_db": 9}) is None
    assert capsys.readouterr().out == out.replace(f"={mesh_db}", "=9").replace(
        f"only {n} ", "only 8 ")
    assert db_mesh_from_config(mesh_db) is None             # a bare count too
