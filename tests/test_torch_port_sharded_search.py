"""The port's DB-sharded search on the CPU against the JAX package's on its
8-virtual-device mesh (``exact_topk_sharded``, ``masked_scan_search_sharded``
through ``get_index(mesh=)``, ``IndexFlatSharded``, ``eval_faiss(mesh=)``),
with the port's 8 'db' shards all on the CPU, and test_fp with mesh_db 8
(fault C7: it ran nowhere before; with fewer cards it searches on one
device, with the hit rates of mesh_db 0).

Tolerances: ``exact_topk_sharded`` ids equal and scores within 1e-5 of
JAX's; the index family's ids equal outside near ties (a rank whose
distance is within 1e-4 of the next: the two packages' products, and the
shards' products against the single device's, sum in another order) and
distances within 1e-4 (1e-3 for the PQ indexes, whose codes may differ at
such ties; the JAX side encodes on its own); hit rates equal exactly. The
approximate local selection is held by its recall against the exact
search: at least the target less 0.02 (tests/test_index.py:219 holds
JAX's; on the CPU JAX's approx_max_k is exact)."""

import os

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from grafp_tpu.core import mesh as jmesh  # noqa: E402
from grafp_tpu.retrieval import evaluate as jev  # noqa: E402
from grafp_tpu.retrieval import index as jix  # noqa: E402
from grafp_tpu.retrieval import search as jse  # noqa: E402
from grafp_tpu.retrieval.memmap_io import save_memmap  # noqa: E402
from grafp_tpu_torch.core.mesh import make_mesh, shard_rows  # noqa: E402
from grafp_tpu_torch.retrieval import evaluate as tev  # noqa: E402
from grafp_tpu_torch.retrieval import index as tix  # noqa: E402
from grafp_tpu_torch.retrieval import pq as tpq  # noqa: E402
from grafp_tpu_torch.retrieval import search as tse  # noqa: E402
from tests.fixtures import make_wav_dir  # noqa: E402
from tests.torch_port_util import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU = torch.device("cpu")
GAP = 1e-4


@pytest.fixture(scope="module")
def meshes():
    """(the port's 8 CPU 'db' shards, JAX's 8-virtual-device 'db' mesh)."""
    return make_mesh(n_data=1, n_db=8, devices=[CPU] * 8), jmesh.make_mesh(n_data=1, n_db=8)


def _unit(rs, n, d):
    x = rs.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _assert_ids_equal_outside_ties(got, want, dist):
    gaps = np.diff(dist, axis=1)
    close = (gaps > 0) & (gaps < GAP)
    near = np.zeros(dist.shape, bool)
    near[:, 1:] |= close
    near[:, :-1] |= close
    assert near.mean() < 0.25
    np.testing.assert_array_equal(got[~near], want[~near])


@pytest.mark.parametrize("rows,metric", [(1024, "l2"), (1003, "l2"), (1003, "ip")])
def test_exact_topk_sharded_matches_jax(meshes, rows, metric):
    """8 shards; 1003 rows leave the last shard 3 pad rows, masked through
    m_valid."""
    tmesh, jm = meshes
    rs = np.random.RandomState(rows)
    db, q = rs.randn(rows, 32).astype(np.float32), rs.randn(40, 32).astype(np.float32)
    want_s, want_i = jse.exact_topk_sharded(jnp.asarray(q), jnp.asarray(db), 10, jm,
                                            metric=metric)
    shards = shard_rows(db, tmesh)
    assert len(shards) == 8 and all(s.shape[0] == -(-rows // 8) for s in shards)
    got_s, got_i = tse.exact_topk_sharded(torch.tensor(q), shards, 10, metric=metric,
                                          m_valid=rows)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-5)
    assert int(got_i.max()) < rows
    # and the single-device search
    one_s, one_i = tse.exact_topk(torch.tensor(q), torch.tensor(db), 10, metric=metric)
    np.testing.assert_array_equal(got_i.numpy(), one_i.numpy())


def test_exact_topk_sharded_approx_local_selection(meshes):
    """8 shards of 4096 rows, k = 10 at recall 0.95: each shard's
    selection takes 256 bins (``approx_bins``), the merge stays exact.
    Recall@10 against the exact search at least 0.93; the first
    neighbour, a planted near copy, is always found."""
    tmesh, _ = meshes
    rs = np.random.RandomState(3)
    db = _unit(rs, 8 * 4096, 32)
    pick = rs.choice(len(db), 200, replace=False)
    q = db[pick] + 0.01 * rs.randn(200, 32).astype(np.float32)
    assert tse.approx_bins(4096, 10, 0.95) == 256
    shards = shard_rows(db, tmesh)
    _, exact = tse.exact_topk_sharded(torch.tensor(q), shards, 10)
    _, approx = tse.exact_topk_sharded(torch.tensor(q), shards, 10, scan_topk="approx",
                                       recall_target=0.95)
    exact, approx = exact.numpy(), approx.numpy()
    recall = np.mean([len(set(a) & set(e)) / 10 for a, e in zip(approx, exact)])
    assert recall >= 0.93, recall
    assert (approx[:, 0] == pick).all()


def _jax_index(kind, data, jm):
    idx = jix.get_index(kind, data, data.shape, False, n_centroids=16, mesh=jm)
    if kind != "lsh":
        assert idx.mesh is jm
    return idx


def _port_index(kind, data, jidx, mesh):
    """The port's index through get_index(mesh=) with the JAX index's
    trained centroids, PQs and planes."""
    idx = tix.get_index(kind, data, data.shape, n_centroids=16, device="cpu", mesh=mesh)
    if kind in ("ivf", "ivfpq", "ivfpq-rr"):
        idx.centroids = torch.tensor(np.asarray(jidx.centroids))
    if kind in ("ivfpq", "ivfpq-rr"):
        idx.pq = tpq.ProductQuantizer.from_state(jidx.pq.state())
    if kind == "ivfpq-rr":
        idx.refine = tpq.ProductQuantizer.from_state(jidx.refine.state())
    if kind == "lsh":
        idx.planes = torch.tensor(np.asarray(jidx.planes))
    return idx


@pytest.mark.parametrize("kind", ["ivf", "ivfpq", "ivfpq-rr", "lsh"])
def test_scan_family_through_get_index_mesh(meshes, kind):
    """'ivf', 'ivfpq', 'ivfpq-rr' and 'lsh' with their rows over 8 shards
    (1300 rows: padded to whole scan blocks a shard) against JAX's
    get_index(mesh=) and the port's single-device index."""
    tmesh, jm = meshes
    rs = np.random.RandomState(8)
    d = 64
    train, db = _unit(rs, 600, d), _unit(rs, 700, d)
    q = db[rs.choice(700, 40, replace=False)] + 0.05 * rs.randn(40, d).astype(np.float32)
    jidx = _jax_index(kind, train, jm)
    sharded = _port_index(kind, train, jidx, tmesh)
    single = _port_index(kind, train, jidx, None)
    assert sharded.mesh is tmesh and single.mesh is None
    for idx in (jidx, sharded, single):
        idx.add(train)
        idx.add(db)
        idx.nprobe = 5
    want_d, want_i = jidx.search(q, 20)
    got_d, got_i = sharded.search(q, 20)
    one_d, one_i = single.search(q, 20)
    (rows, _, cells), block = sharded._sharded_payload()
    assert len(rows) == 8 and all(r.shape[0] % block == 0 for r in rows)
    assert sum(r.shape[0] for r in rows) >= 1300 and (cells is None) == (kind == "lsh")
    atol = 1e-3 if kind.startswith("ivfpq") else 1e-4
    np.testing.assert_allclose(got_d, want_d, rtol=0, atol=atol)
    _assert_ids_equal_outside_ties(got_i, want_i, want_d)
    np.testing.assert_allclose(got_d, one_d, rtol=0, atol=1e-4)
    _assert_ids_equal_outside_ties(got_i, one_i, one_d)


def test_flat_sharded_and_hnsw_through_get_index(meshes):
    tmesh, _ = meshes
    rs = np.random.RandomState(2)
    db = _unit(rs, 1001, 32)
    q = db[:30] + 0.02 * rs.randn(30, 32).astype(np.float32)
    flat = tix.get_index("l2", db, db.shape, device="cpu", mesh=tmesh)
    assert isinstance(flat, tix.IndexFlatSharded)
    assert not isinstance(tix.get_index("l2", db, db.shape, device="cpu",
                                        mesh=make_mesh(1, 1, [CPU])), tix.IndexFlatSharded)
    one = tix.get_index("l2", db, db.shape, device="cpu")
    jflat = jix.IndexFlatSharded(32, meshes[1])
    for idx in (flat, one, jflat):
        idx.add(db)
    d, i = flat.search(q, 7)
    np.testing.assert_array_equal(i, one.search(q, 7)[1])
    want_d, want_i = jflat.search(q, 7)
    np.testing.assert_array_equal(i, want_i)
    np.testing.assert_allclose(d, want_d, rtol=1e-4, atol=1e-5)
    assert (i[:, 0] == np.arange(30)).all()
    hnsw = tix.get_index("hnsw", db, db.shape, device="cpu", mesh=tmesh)
    assert not hasattr(hnsw, "mesh")


@pytest.fixture()
def emb_dir(tmp_path):
    """tests/test_evaluate.py's synthetic fingerprint DBs."""
    rng = np.random.RandomState(0)
    d = 16
    dummy = _unit(rng, 300, d)
    db = _unit(rng, 80, d)
    q = db + 0.05 * rng.randn(80, d).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    save_memmap(str(tmp_path), "dummy_db", dummy)
    save_memmap(str(tmp_path), "db", db)
    save_memmap(str(tmp_path), "query", q)
    return str(tmp_path)


def test_eval_faiss_mesh_matches_jax(emb_dir, meshes):
    """tests/test_evaluate.py:128-140: eval_faiss 'l2' with a db mesh gives
    JAX's hit rates, and the single device's."""
    tmesh, jm = meshes
    want = jev.eval_faiss(emb_dir, index_type="l2", nogpu=True, test_ids="all",
                          test_seq_len="1 3", verbose=False, mesh=jm)
    got = tev.eval_faiss(emb_dir, index_type="l2", test_ids="all", test_seq_len="1 3",
                         verbose=False, device="cpu", mesh=tmesh)
    one = tev.eval_faiss(emb_dir, index_type="l2", test_ids="all", test_seq_len="1 3",
                         verbose=False, device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, one)


def test_test_fp_mesh_db_8_gives_the_hit_rates_of_mesh_db_0(tmp_path, capsys):
    """Fault C7: test_fp with mesh_db 8 on a host with fewer cards prints the
    notice, searches on one device and gives mesh_db 0's hit rates (the
    same fingerprint dir is recomputed)."""
    from grafp_tpu_torch.cli import test_fp_main
    from grafp_tpu_torch.core import Config
    from grafp_tpu_torch.models import build_model
    from grafp_tpu_torch.train.checkpoint import save_ckp

    fs = 1000
    make_wav_dir(str(tmp_path / "val_audio"), n=6, dur_s=12.0, sr=fs, seed=2)
    make_wav_dir(str(tmp_path / "noise"), n=4, dur_s=3.0, sr=fs, seed=3, kind="noise")
    make_wav_dir(str(tmp_path / "ir"), n=3, dur_s=0.25, sr=fs, seed=4, kind="ir")
    os.makedirs(tmp_path / "data")
    base = {"data_dir": "data", "noise_dir": str(tmp_path / "noise"),
            "ir_dir": str(tmp_path / "ir"), "fs": fs, "win_len": 256, "hop_len": 128,
            "n_fft": 256, "n_mels": 16, "n_frames": 8, "overlap": 0.5, "val_snr": [5, 5]}
    model = build_model(Config(**{k: v for k, v in base.items() if k != "data_dir"}),
                        generator=torch.Generator().manual_seed(0), device="cpu")
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        save_ckp({"state_dict": model.state_dict()}, "m", "checkpoint", "current")
        np.save("data/val_audio_indices.npy", np.random.RandomState(0).permutation(6))
        with open("test_config.yaml", "w") as f:
            yaml.safe_dump({"m": ["current"]}, f)
        hit = {}
        for mesh_db in (0, 8):
            with open(f"mesh{mesh_db}.yaml", "w") as f:
                yaml.safe_dump({**base, "mesh_db": mesh_db}, f)
            capsys.readouterr()
            (fp_dir, hit[mesh_db]), = test_fp_main.main([
                "--config", f"mesh{mesh_db}.yaml", "--test_config", "test_config.yaml",
                "--test_dir", str(tmp_path / "val_audio"), "--n_query_db", "2",
                "--small_test", "--test_ids", "4", "--query_lens", "2,3",
                "--recompute"], device="cpu").values()
            out = capsys.readouterr().out
            assert ("[mesh] mesh_db=8 requested but only" in out) == (mesh_db == 8)
    finally:
        os.chdir(cwd)
    assert hit[0].shape == (4, 2) and np.isfinite(hit[0]).all()
    np.testing.assert_array_equal(hit[8], hit[0])
