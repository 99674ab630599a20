"""The port's protocol-scale drivers against the JAX repo's, on the CPU at
small sizes: scripts/torch_port_fma_large_smoke.py against
scripts/fma_large_smoke.py and scripts/torch_port_e2e_synthetic_icassp.py
against scripts/e2e_synthetic_icassp.py, on the same seeds.

- The memmaps (50,000 dummy / 2,000 db and query rows) and the wav corpora
  (music, noise, IR) are byte-equal to the JAX scripts' and fixture's.
- The fma_large protocol (the JAX script's eval_faiss arguments, 8 cells)
  at 12,000 dummy / 2,000 query rows: the port's eval_faiss, rescoring on
  the device (here the CPU) and on the host, gives JAX's eval_faiss hit
  rates and raw scores on the same memmaps, with the port's 'ivfpq' on
  the JAX index's centroids and codebooks (the two packages draw their
  k-means from different generators). The rows are few because the JAX
  index's add costs ~2.5 ms a row on this CPU (81 s for 32,000 rows on two
  cores, its PQ encode), not because the port's path changes with size.
- The e2e driver at a tiny size (8 tracks of 4 s at 1 kHz, the geometry of
  tests/test_torch_port_train.py, 2 steps, one SNR) completes and returns
  a (4, n_sl) table; its first two losses are the JAX script's loop's on
  the same batches from the same weights (the port's seeded ones, carried
  to the JAX tree, so that the JAX side runs no init), in f32 and with the augment's
  probabilities at 0 (the packages' augment draws come from different
  generators): the first within rtol 5e-5, the second within 1e-3 (the
  one-step and trajectory tolerances of tests/test_torch_port_train.py),
  at that file's small lr (2e-7). At the Config's lr (8e-5) Adam's first
  update moves every weight by about lr times the sign of its gradient,
  and near-zero gradients' signs are rounding noise: the port's own second
  loss then lies at 0.073 or 0.120 with one or four torch threads, JAX's
  at 0.547, while the port's loss on JAX's updated weights is JAX's
  0.5470 (measured on this corpus).
"""

import copy
import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grafp_tpu.core.config import Config as JConfig  # noqa: E402
from grafp_tpu.data.dataset import FingerprintDataset as JDataset  # noqa: E402
from grafp_tpu.data.dataset import PairBatcher as JPairBatcher  # noqa: E402
from grafp_tpu.data.dataset import build_augment_banks as j_augment_banks  # noqa: E402
from grafp_tpu.data.indexing import load_augmentation_index as j_aug_index  # noqa: E402
from grafp_tpu.models import build_model as j_build_model  # noqa: E402
from grafp_tpu.retrieval import evaluate as jev  # noqa: E402
from grafp_tpu.train import make_train_step as j_train_step  # noqa: E402
from grafp_tpu.train.state import TrainState as JTrainState  # noqa: E402
from grafp_tpu.train.state import make_optimizer as j_make_optimizer  # noqa: E402
from grafp_tpu_torch.convert import state_dict_from_jax  # noqa: E402
from grafp_tpu_torch.data.synthetic import make_wav_dir  # noqa: E402
from grafp_tpu_torch.fp import FingerprintPipeline  # noqa: E402
from grafp_tpu_torch.models import build_model  # noqa: E402
from grafp_tpu_torch.retrieval import evaluate as tev  # noqa: E402
from grafp_tpu_torch.retrieval import index as tix  # noqa: E402
from grafp_tpu_torch.retrieval import pq as tpq  # noqa: E402
from tests.fixtures import make_wav_dir as j_make_wav_dir  # noqa: E402
from tests.torch_port_util import ivfpq_candidate_faults  # noqa: E402
from tests.torch_port_util import jax_variables_from_port  # noqa: E402
from tests.torch_port_util import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
CPU = torch.device("cpu")
# scripts/fma_large_smoke.py's eval_faiss arguments, at 8 cells
FMA_EVAL = dict(index_type="ivfpq", max_train=1_000_000, test_ids="500",
                test_seq_len="1 11 19", k_probe=20, n_centroids=8)
# tests/test_torch_port_train.py's geometry (1 s at 1 kHz, N = 64 nodes)
# and its small lr, which keeps two steps comparable
TINY = dict(win_len=256, hop_len=128, n_fft=256, n_mels=16, n_frames=8)
OPT = dict(lr=2e-7, min_lr=2e-8)


def _script(name: str):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fma():
    return _script("torch_port_fma_large_smoke")


@pytest.fixture(scope="module")
def memmaps(tmp_path_factory, fma):
    """The fma_large memmaps at 50,000 / 2,000 rows, written by the JAX
    script's write_memmap and by the port's (its make_data)."""
    jax_script = _script("fma_large_smoke")
    jdir = tmp_path_factory.mktemp("fma_jax")
    db = jax_script.write_memmap(str(jdir), "dummy_db", 50_000, seed=0)
    db = jax_script.write_memmap(str(jdir), "db", 2_000, seed=1)
    jax_script.write_memmap(str(jdir), "query", 2_000, seed=2, base=db, noise=0.25)
    path, secs = fma.make_data(str(tmp_path_factory.mktemp("fma_port")), 50_000, 2_000)
    assert secs is not None
    return jdir, Path(path)


@pytest.mark.parametrize("name", ["dummy_db", "db", "query"])
def test_write_memmap_is_the_jax_scripts_byte_for_byte(memmaps, name):
    jdir, tdir = memmaps
    for suffix in (".mm", "_shape.npy"):
        assert (tdir / (name + suffix)).read_bytes() == (jdir / (name + suffix)).read_bytes()


def test_make_data_reuses_complete_memmaps_and_redoes_a_partial_set(fma, memmaps, tmp_path):
    _, tdir = memmaps
    assert fma.make_data(str(tdir.parent), 50_000, 2_000) == (str(tdir), None)
    path, _ = fma.make_data(str(tmp_path), 1_000, 100)
    want = (Path(path) / "query.mm").read_bytes()
    os.remove(os.path.join(path, "query_shape.npy"))       # a write cut short
    assert fma.make_data(str(tmp_path), 1_000, 100)[1] is not None
    assert fma._complete(path, 1_000, 100)
    assert (Path(path) / "query.mm").read_bytes() == want


@pytest.mark.parametrize("kind", ["music", "noise", "ir"])
def test_make_wav_dir_is_the_fixtures_byte_for_byte(tmp_path, kind):
    got = make_wav_dir(str(tmp_path / "port"), n=3, dur_s=2.0, sr=16000, seed=5, kind=kind)
    want = j_make_wav_dir(str(tmp_path / "jax"), n=3, dur_s=2.0, sr=16000, seed=5, kind=kind)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    for a, b in zip(got, want):
        assert Path(a).read_bytes() == Path(b).read_bytes()


def _results(emb_dir, before):
    new = [d for d in sorted(set(os.listdir(emb_dir)) - before)
           if os.path.isdir(os.path.join(emb_dir, d))]
    assert len(new) == 1
    return (np.load(os.path.join(emb_dir, new[0], "hit_rates.npy")),
            np.load(os.path.join(emb_dir, new[0], "raw_score.npy")))


@pytest.fixture(scope="module")
def protocol(tmp_path_factory, fma):
    """The fma_large protocol at 12,000 dummy / 2,000 query rows: JAX's
    eval_faiss (its hit rates and raw scores) and a maker of the port's
    'ivfpq' trained as JAX's (its centroids and codebooks), with no rows."""
    path, _ = fma.make_data(str(tmp_path_factory.mktemp("protocol")), 12_000, 2_000)
    trained, real = {}, jev.get_index

    def capture(*args, **kw):
        trained["index"] = real(*args, **kw)
        return trained["index"]

    before = set(os.listdir(path))
    jev.get_index = capture
    try:
        want_hr = jev.eval_faiss(path, nogpu=True, verbose=False, **FMA_EVAL)
    finally:
        jev.get_index = real
    want = _results(path, before)
    np.testing.assert_array_equal(want_hr, want[0])
    jidx = trained["index"]

    def make_index():
        idx = tix.IndexIVFPQ(128, FMA_EVAL["n_centroids"], CPU, code_sz=64, nbits=8)
        idx.pq = tpq.ProductQuantizer.from_state(jidx.pq.state())
        idx.centroids = torch.tensor(np.asarray(jidx.centroids))
        idx.is_trained = True
        idx.nprobe = jidx.nprobe
        return idx

    return path, want, make_index


def _rows(path, name):
    return np.memmap(os.path.join(path, name + ".mm"), np.float32, mode="r",
                     shape=tuple(np.load(os.path.join(path, name + "_shape.npy"))))


@pytest.mark.parametrize("rescore", ["device", "host"])
def test_fma_large_protocol_matches_jax(protocol, rescore, monkeypatch):
    """The port's eval_faiss, adding every row to an index trained as
    JAX's, gives JAX's hit rates and raw scores."""
    path, (want_hr, want_raw), make_index = protocol
    monkeypatch.setattr(tev, "get_index", lambda *args, **kw: make_index())
    before, stats = set(os.listdir(path)), {}
    hr = tev.eval_faiss(path, verbose=False, rescore=rescore, device="cpu",
                        stats=stats, **FMA_EVAL)
    got_hr, got_raw = _results(path, before)
    np.testing.assert_array_equal(hr, got_hr)
    assert hr.shape == (4, 3) and stats["rescore"] == rescore
    assert stats["index"].ntotal == 14_000 and stats["top_ids"].shape == (500, 3, 10)
    print(f"fma_large protocol, 12,000 rows, rescore={rescore}: {hr.tolist()}")
    np.testing.assert_array_equal(got_hr, want_hr)
    np.testing.assert_array_equal(got_raw, want_raw)
    assert hr[0, -1] == 100.0 and 0.0 < hr[0, 0] < 100.0


def test_fma_large_driver_runs_both_tiers_on_one_index(tmp_path, fma, capsys):
    """The driver end to end on the CPU at 1,000 / 200 rows: the index is
    trained and filled once, both tiers give the same hit rates and top
    ids, every stage's seconds are reported."""
    path, _ = fma.make_data(str(tmp_path), 1_000, 200)
    out = fma.run(path, device="cpu", verbose=False, n_centroids=8, test_ids="50")
    first, second = out["auto"], out["host"]
    assert first["rescore"] == "device"
    assert first["train_s"] > 0 and first["add_s"] > 0
    assert second["train_s"] == second["add_s"] == 0.0 and second["rescore"] == "host"
    assert first["card_peak_gb"] is None and first["peak_rss_gb"] > 0
    assert out["index"].ntotal == 1_200
    np.testing.assert_array_equal(first["hit_rates"], second["hit_rates"])
    np.testing.assert_array_equal(first["top_ids"], second["top_ids"])
    assert "equal hit rates and top-10 ids" in capsys.readouterr().out


@pytest.fixture(scope="module")
def filled(protocol):
    """The port's 'ivfpq' over the 14,000 protocol rows, added 4,096 rows
    a piece (_ADD_CHUNK), so that its decode cache is filled in four
    pieces; three of its eight cells probed. (path, index, query rows
    of the test ids, their exact float64 top-1 ids)."""
    path, _, make_index = protocol
    idx = make_index()
    idx.nprobe = 3
    chunk = tix._ADD_CHUNK
    tix._ADD_CHUNK = 4096
    try:
        for name in ("dummy_db", "db"):
            idx.add(_rows(path, name))
        idx._payload()
    finally:
        tix._ADD_CHUNK = chunk
    merged = np.concatenate([_rows(path, "dummy_db"), _rows(path, "db")]).astype(np.float64)
    q = np.asarray(_rows(path, "query")[np.load(os.path.join(path, "test_ids.npy"))])
    exact = np.argmax(q.astype(np.float64) @ merged.T, axis=1)
    return path, idx, q, exact


def test_decode_cache_in_pieces_is_the_one_shot_decode(filled, monkeypatch):
    _, idx, _, _ = filled
    codes = torch.cat(idx._codes)
    monkeypatch.setattr(tix, "_ADD_CHUNK", 4096)
    assert codes.shape[0] > 3 * 4096
    assert torch.equal(idx._decode_bf16(codes), idx.pq.decode(codes).bfloat16())
    assert torch.equal(idx._cache[0], idx.pq.decode(codes).bfloat16())


def _candidate_faults(path, idx, q, exact):
    dist, cand = idx.search(q, 20)
    merged = tev.ConcatRows(_rows(path, "dummy_db"), _rows(path, "db"))
    return ivfpq_candidate_faults(q, dist, cand, exact, merged.gather,
                                  idx.centroids.numpy(), idx.pq.codebooks.numpy(), 3)


def test_ivfpq_candidates_hold_to_the_float64_recomputation(filled):
    """chip_smoke.py phase 16a's check of the 'ivfpq' search, here on the
    CPU: no fault, and the exact top-1 of many test ids is held to it."""
    path, idx, q, exact = filled
    faults, bound = _candidate_faults(path, idx, q, exact)
    print(f"ivfpq candidates at 14,000 rows: faults {faults}, exact top-1 held "
          f"for {bound} of {len(q)}")
    assert faults == {"unprobed": 0, "distance": 0, "missed": 0}
    assert bound > len(q) // 4


@pytest.mark.parametrize("fault", ["rows_past_8192_dropped", "a_cache_piece_shifted",
                                   "every_cell_probed"])
def test_ivfpq_candidate_check_fails_on_a_fault(filled, fault):
    """Each fault fails the check: a search that drops the rows past the
    second piece, a decode cache whose third piece holds the second's
    rows, a search that ignores the probe mask."""
    path, good, q, exact = filled
    idx = copy.copy(good)
    if fault == "rows_past_8192_dropped":
        idx.ntotal = 8192
    elif fault == "a_cache_piece_shifted":
        rows = good._cache[0].clone()
        rows[8192:12288] = rows[4096:8192]
        idx._cache = (rows,) + good._cache[1:]
    else:
        idx.nprobe = FMA_EVAL["n_centroids"]
    faults, _ = _candidate_faults(path, idx, q, exact)
    print(f"{fault}: {faults}")
    assert sum(faults.values()) > 0


@pytest.fixture(scope="module")
def e2e_run(tmp_path_factory):
    """The JAX script's train loop (scripts/e2e_synthetic_icassp.py:106-114)
    for its two steps and the port's driver, on one tiny corpus from the
    same initial weights."""
    e2e = _script("torch_port_e2e_synthetic_icassp")
    root = str(tmp_path_factory.mktemp("e2e"))
    corpus = e2e.make_corpora(root, 8, 4.0, fs=1000)
    common = dict(fs=1000, compute_dtype="float32", noise_prob=0.0, ir_prob=0.0,
                  **TINY, **OPT)
    cfg = e2e.e2e_config(corpus, 8, 4, **common)

    # scripts/e2e_synthetic_icassp.py:87-97 on the JAX package
    jcfg = JConfig(**{k: cfg[k] for k in (
        "data_dir", "train_dir", "val_dir", "noise_dir", "ir_dir", "offset", "overlap",
        "train_sz", "val_sz", "bsz_train")}, **common)
    noise = j_aug_index(jcfg["noise_dir"], splits=0.8)
    irs = j_aug_index(jcfg["ir_dir"], splits=0.8)
    banks = j_augment_banks(noise["train"], irs["train"], jcfg.fs)
    jm = j_build_model(jcfg)
    loader = JPairBatcher(JDataset(jcfg, jcfg.train_dir, train=True, seed=0), 4, seed=0,
                          num_threads=2)
    # grafp_tpu.train.create_train_state without its init: the port's seeded
    # weights in the JAX tree
    port = build_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu",
                       train=True)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.key(0)},
                                            jnp.zeros((2, 16, 8)), False))
    params, stats = jax_variables_from_port(port, shapes)
    init = state_dict_from_jax(params, stats, port)
    tx = j_make_optimizer(jcfg, max(len(loader), 1))
    params = jax.tree.map(jnp.asarray, params)
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        batch_stats=jax.tree.map(jnp.asarray, stats),
                        opt_state=tx.init(params), tx=tx, apply_fn=jm.apply)
    step = j_train_step(jm, jcfg, banks)
    want = []
    for i, (xi, xj) in enumerate(loader):
        state, m = step(state, jnp.asarray(xi), jnp.asarray(xj),
                        jax.random.fold_in(jax.random.key(0), i))
        want.append(float(m["loss"]))
    # the builders pad each group's last batch to batch_size: embed the
    # tiny tracks in batches of 32, as tests/test_torch_port_cli.py does
    defaults = FingerprintPipeline.__init__.__defaults__
    FingerprintPipeline.__init__.__defaults__ = (32,) + defaults[1:]
    try:
        got = e2e.run(root, tracks=8, dur=4.0, epochs=1, bsz=4, queries=2, device="cpu",
                      snrs=(10,), init_state=init, **common)
    finally:
        FingerprintPipeline.__init__.__defaults__ = defaults
    return got, want


def test_e2e_driver_completes_on_the_cpu(e2e_run):
    got, _ = e2e_run
    assert got["steps"] == 2 and len(got["epoch_loss"]) == 1
    assert np.isfinite(got["epoch_loss"]).all()
    for table in (got["hit_rates"][10]["ivfpq"], got["hit_rates"][10]["l2"], got["baseline"]):
        assert table.shape == (4, 5) and ((table >= 0) & (table <= 100)).all()
        assert (table[3] >= table[2]).all() and (table[2] >= table[0]).all()
    secs, rows = got["build"][10]
    assert rows > 0 and got["embed_batches"] > 0
    # the CPU runs the kernels' plain versions: no launch
    assert all(n == 0 for path in got["launches"].values() for n in path.values())


def test_e2e_first_losses_match_the_jax_scripts_loop(e2e_run):
    got, want = e2e_run
    losses = got["step_losses"][0]
    print(f"e2e first losses: port {losses}, JAX {want}")
    assert len(want) == len(losses) == 2
    np.testing.assert_allclose(losses[0], want[0], rtol=5e-5)
    np.testing.assert_allclose(losses[1], want[1], rtol=1e-3)
