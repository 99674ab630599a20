"""The port's memmap IO and fingerprint-DB builders
(grafp_tpu_torch/retrieval/memmap_io.py, grafp_tpu_torch/fp/builder.py)
against the JAX package's, on the CPU, on the same weights and
synthetic waves (no wav files), with a tiny log-mel geometry (fs 1 kHz,
16 mels, 8-frame segments, 64 graph nodes, a 2 s length bucket).

Tolerances: memmaps byte-equal; builder outputs with equal row counts and
cos > 0.9999 per row (the JAX model's f32 CPU path against the port's
folded f32 CPU path); the query rows with the corruption fed the draws of
JAX's ``track_corruption_keys``. The port's packing changes no row
beyond f32 summation order: max |d| <= 1e-3 on the unit-norm
fingerprints (the batch's make-up changes the CPU product's blocking,
which a k-NN near tie amplifies; a row in the wrong place would be off by
~0.1) and 1e-5 on corrupted waves.

The weights: the port's initial ones with random BatchNorm affines,
calibrated as chip_smoke.py's are (residual branches' last BatchNorm scale
0.1, statistics from a train-mode forward over segments of other noise
tracks), so that rows differ; every built row must lie nearer its own
reference row than any other, above a cosine floor that exceeds every
cosine between two different rows (``hold_rows``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grafp_tpu.core.config import Config as JConfig  # noqa: E402
from grafp_tpu.dsp import augment as jaug  # noqa: E402
from grafp_tpu.fp import builder as jb  # noqa: E402
from grafp_tpu.models import build_model as j_build_model  # noqa: E402
from grafp_tpu.retrieval import memmap_io as jmm  # noqa: E402
from grafp_tpu_torch.core import Config  # noqa: E402
from grafp_tpu_torch.dsp import augment as taug  # noqa: E402
from grafp_tpu_torch.fp import builder as tb  # noqa: E402
from grafp_tpu_torch.models import build_model  # noqa: E402
from grafp_tpu_torch.retrieval import memmap_io as tmm  # noqa: E402
from tests.torch_port_util import (  # noqa: E402
    calibrated_jax_variables,
    hold_rows,
    load_jax_weights,
    one_torch_thread,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TINY = dict(fs=1000, win_len=256, hop_len=128, n_fft=256, n_mels=16, n_frames=8,
            overlap=0.5, val_snr=[5, 15])
PACK = 4
# three bucket runs, a too-short track (0 segments) and unequal lengths
LENGTHS = (1900, 1900, 1900, 3500, 3500, 1500, 2600, 500, 3500, 1900)


def _waves(seed=0):
    rs = np.random.RandomState(seed)
    return [(0.2 * rs.randn(n)).astype(np.float32) for n in LENGTHS]


def _bank_clips(seed=1):
    rs = np.random.RandomState(seed)
    noise = [rs.randn(n).astype(np.float32) for n in (700, 4100, 5000)]
    irs = [(rs.randn(n) * np.exp(-np.arange(n) / 60.0)).astype(np.float32)
           for n in (250, 90, 1)]
    return noise, irs


@pytest.fixture(scope="module")
def pipes():
    jcfg = JConfig(**TINY)
    jm = j_build_model(jcfg)
    cfg = Config(**TINY)
    # the port's initial weights through the bridge (eval_shape compiles
    # nothing), BatchNorms randomised and calibrated on other tracks' segments
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.key(0)},
                                            jnp.zeros((1, 16, 8)), False))
    model = build_model(cfg, device="cpu")
    segs = tb.FingerprintPipeline(model, cfg, bucket_s=2.0, device="cpu").segments_for
    spec = np.concatenate([segs(w) for w in _waves(99)])
    params, stats = calibrated_jax_variables(model, shapes, spec)
    jp = jb.FingerprintPipeline(jm, jcfg, params, stats, batch_size=16, bucket_s=2.0)
    port = load_jax_weights(build_model(cfg, device="cpu"), params, stats)
    tp = tb.FingerprintPipeline(port, cfg, batch_size=16, bucket_s=2.0, device="cpu")
    noise, irs = _bank_clips()
    banks = (jaug.AugmentBanks.from_arrays(noise_clips=noise, ir_clips=irs,
                                           noise_len=4000, ir_len=250),
             taug.AugmentBanks.from_arrays(noise_clips=noise, ir_clips=irs,
                                           noise_len=4000, ir_len=250))
    return jp, tp, banks


def _jax_draws(jbanks, n, seed, snr):
    """The per-track draws of JAX's create_fp_db: track_corruption_keys'
    keys through augment_waveforms' splits (augment.py:262-288), batch 1."""
    out = []
    for data in jb.track_corruption_keys(seed, n):
        key = jax.random.wrap_key_data(jnp.asarray(data))
        k_ir_row, k_ir_p, k_n, k_snr, k_np = jax.random.split(key, 5)
        k_row, k_off = jax.random.split(k_n)
        d = dict(
            ir_rows=jax.random.randint(k_ir_row, (1,), 0, jbanks.ir.shape[0]),
            ir_take=jax.random.uniform(k_ir_p, (1,)),
            noise_rows=jax.random.randint(k_row, (1,), 0, jbanks.noise.shape[0]),
            noise_offsets=jax.random.randint(k_off, (1,), 0, 2 ** 30),
            snr=jax.random.uniform(k_snr, (1,), minval=snr[0], maxval=snr[1]),
            noise_take=jax.random.uniform(k_np, (1,)))
        out.append(taug.AugmentDraws(**{k: torch.tensor(np.asarray(v))
                                        for k, v in d.items()}))
    return out


def _assert_rows_close(got, want, what="rows"):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and len(got) > 0
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                  * np.linalg.norm(want, axis=-1))
    assert (cos > 0.9999).all(), cos.min()
    hold_rows(what, got, want, 0.9999)


def test_memmap_writer_and_save_are_byte_equal_to_jax(tmp_path):
    rs = np.random.RandomState(2)
    blocks = [rs.randn(n, 8).astype(np.float32) for n in (5, 40, 1, 300)]
    for name, mod in (("jax", jmm), ("port", tmm)):
        w = mod.MemmapWriter(str(tmp_path / name), "db", 8, capacity=16)  # grows
        for blk in blocks:
            w.append(blk)
        assert w.close() == (346, 8)
        mod.save_memmap(str(tmp_path / name), "query", blocks[1])
    for fname in ("db.mm", "db_shape.npy", "query.mm", "query_shape.npy"):
        assert ((tmp_path / "jax" / fname).read_bytes()
                == (tmp_path / "port" / fname).read_bytes()), fname
    data, shape = tmm.load_memmap_data(str(tmp_path / "port"), "db", display=False)
    np.testing.assert_array_equal(data, np.concatenate(blocks))
    assert tuple(shape) == (346, 8)
    with pytest.raises(ValueError):
        tmm.MemmapWriter(str(tmp_path / "x"), "db", 8, capacity=4).append(blocks[0][:, :4])


def test_create_dummy_db_matches_jax(pipes, tmp_path):
    jp, tp, _ = pipes
    waves = _waves()
    assert jb.create_dummy_db(waves, jp, str(tmp_path / "jax"), verbose=False,
                              pack=PACK) == tb.create_dummy_db(
        waves, tp, str(tmp_path / "port"), verbose=False, pack=PACK)
    want, _ = jmm.load_memmap_data(str(tmp_path / "jax"), "dummy_db", display=False)
    got, _ = tmm.load_memmap_data(str(tmp_path / "port"), "dummy_db", display=False)
    assert len(got) == sum(len(tp.segments_for(w)) for w in waves)
    _assert_rows_close(got, want, "create_dummy_db port vs JAX")


def test_create_fp_db_with_jax_draws_matches_jax(pipes, tmp_path):
    jp, tp, (jbanks, tbanks) = pipes
    waves = _waves(3)
    want_n = jb.create_fp_db(waves, jp, jbanks, str(tmp_path / "jax"), seed=5,
                             verbose=False, pack=PACK)
    draws = _jax_draws(jbanks, len(waves), 5, TINY["val_snr"])
    got_n = tb.create_fp_db(waves, tp, tbanks, str(tmp_path / "port"), seed=5,
                            verbose=False, pack=PACK, draws=draws)
    assert got_n == want_n
    for name in ("db", "query"):
        want, _ = jmm.load_memmap_data(str(tmp_path / "jax"), name, display=False)
        got, _ = tmm.load_memmap_data(str(tmp_path / "port"), name, display=False)
        _assert_rows_close(got, want, f"create_fp_db {name} port vs JAX")
    db, _ = tmm.load_memmap_data(str(tmp_path / "port"), "db", display=False)
    q, _ = tmm.load_memmap_data(str(tmp_path / "port"), "query", display=False)
    assert len(db) == len(q) and not np.allclose(db, q)


def test_create_db_matches_jax(pipes, tmp_path):
    jp, tp, _ = pipes
    waves = _waves(4)[:4]
    want = jb.create_db(waves, jp, str(tmp_path / "jax"), verbose=False, pack=PACK)
    got = tb.create_db(waves, tp, str(tmp_path / "port"), verbose=False, pack=PACK)
    _assert_rows_close(got, want, "create_db port vs JAX")
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "fingerprints.npy"), got)
    per_track = tb.create_db(waves, tp, str(tmp_path / "obj"), concat=False,
                             verbose=False)
    assert [len(z) for z in per_track] == [len(tp.segments_for(w)) for w in waves]


@pytest.mark.parametrize("pack", [1, 3, 8])
def test_packing_changes_no_row(pipes, pack):
    """Packed calls give each track its own fingerprint_track rows, and
    corrupt_tracks each track its corrupt_track result."""
    _, tp, (_, tbanks) = pipes
    waves = _waves(6)
    got = tp.fingerprint_tracks(waves, pack=pack)
    for w, z in zip(waves, got):
        want = tp.fingerprint_track(w)
        assert z.shape == want.shape
        np.testing.assert_allclose(z, want, rtol=0, atol=1e-3)
    want = np.concatenate([tp.fingerprint_track(w) for w in waves])
    hold_rows(f"pack {pack} vs fingerprint_track", np.concatenate(got), want, 0.9999)
    draws = tb.track_corruption_draws(tbanks, len(waves), 0, tp.val_snr)
    dirty = tp.corrupt_tracks(waves, tbanks, draws, pack=pack)
    for w, d, y in zip(waves, draws, dirty):
        np.testing.assert_allclose(y, tp.corrupt_track(w, tbanks, d), rtol=0, atol=1e-5)


def test_fingerprint_tracks_match_jax(pipes):
    """Ragged tracks in packed groups, each group embedded in full batches
    as the JAX package's _embed_tracks does: every row within the
    builders' tolerance of the JAX pipeline's."""
    jp, tp, _ = pipes
    waves = _waves()
    got = tp.fingerprint_tracks(waves, pack=PACK)
    want = jp.fingerprint_tracks(waves, pack=PACK)
    assert [len(z) for z in got] == [len(z) for z in want]
    _assert_rows_close(np.concatenate(got), np.concatenate(want),
                       f"fingerprint_tracks pack {PACK} port vs JAX")


@pytest.mark.parametrize("pack", [1, PACK])
def test_the_builders_call_the_model_with_full_batches_only(pipes, tmp_path, pack):
    """A spy on the served model: fingerprint_tracks, create_dummy_db and
    embed_stream give it only (batch_size, n_mels, n_frames) batches, the
    JAX package's one static shape, however ragged the tracks."""
    _, tp, _ = pipes
    seen = []
    spy = tp.model.register_forward_pre_hook(lambda m, args: seen.append(tuple(args[0].shape)))
    try:
        waves = _waves(11)
        rows = [len(z) for z in tp.fingerprint_tracks(waves, pack=pack)]
        tb.create_dummy_db(waves, tp, str(tmp_path), verbose=False, pack=pack)
        blocks = [tp.segments_for(w) for w in waves[:3]]
        w = tmm.MemmapWriter(str(tmp_path), "s", tp.d, capacity=100)
        tp.embed_stream(iter(blocks), w)
        w.close()
    finally:
        spy.remove()
    assert any(r % tp.batch_size for r in rows) and seen        # ragged tails
    assert set(seen) == {(tp.batch_size, TINY["n_mels"], TINY["n_frames"])}


def test_create_fp_db_draws_from_its_seed(pipes, tmp_path):
    _, tp, (_, tbanks) = pipes
    waves = _waves(7)[:4]
    for run in ("a", "b"):
        tb.create_fp_db(waves, tp, tbanks, str(tmp_path / run), seed=9, verbose=False)
    assert ((tmp_path / "a" / "query.mm").read_bytes()
            == (tmp_path / "b" / "query.mm").read_bytes())


class _Tracks:
    """A dataset of waves that records the order in which it is read."""

    def __init__(self, waves):
        self.waves, self.reads = waves, []

    def __getitem__(self, i):
        self.reads.append(i)
        return self.waves[i]


class _TrackLoader:
    """A loader with .ds and .indices, as a track loader has."""

    def __init__(self, waves):
        self.ds = _Tracks(waves)
        self.indices = list(range(len(waves)))

    def __len__(self):
        return len(self.indices)


def test_builders_take_a_track_loader_and_read_it_in_order(pipes, tmp_path):
    _, tp, _ = pipes
    waves = _waves(8)
    loader = _TrackLoader(waves)
    loader.indices = loader.indices[::-1]
    n, _ = tb.create_dummy_db(loader, tp, str(tmp_path), verbose=False, pack=2)
    assert loader.ds.reads == loader.indices
    waves = waves[::-1]
    got, _ = tmm.load_memmap_data(str(tmp_path), "dummy_db", display=False)
    want = np.concatenate(tp.fingerprint_tracks(waves))
    assert n == len(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    hold_rows("track loader build vs fingerprint_tracks", got, want, 0.9999)


def test_chunks_and_track_waves_keep_order():
    assert list(tb._chunks(range(7), 3)) == [[0, 1, 2], [3, 4, 5], [6]]
    loader = _TrackLoader([np.full(3, i, np.float64) for i in range(5)])
    loader.indices = [3, 0, 4]
    lazy = tb._track_waves(loader)
    assert loader.ds.reads == []         # nothing is read before it is needed
    first = next(lazy)
    assert loader.ds.reads == [3]
    got = [first, *lazy]
    assert [int(w[0]) for w in got] == [3, 0, 4]
    assert all(w.dtype == np.float32 for w in got)


def test_embed_stream_keeps_order_and_count(pipes, tmp_path):
    _, tp, _ = pipes
    rs = np.random.RandomState(10)
    blocks = [rs.randn(n, 16, 8).astype(np.float32) for n in (5, 23, 1, 0, 7)]
    w = tmm.MemmapWriter(str(tmp_path), "t", tp.d, capacity=100)
    assert tp.embed_stream(iter(blocks), w) == 36
    w.close()
    data, _ = tmm.load_memmap_data(str(tmp_path), "t", display=False)
    want = tp.embed(np.concatenate(blocks)).numpy()
    np.testing.assert_allclose(data, want, rtol=0, atol=1e-3)
    hold_rows("embed_stream vs embed", data, want, 0.9999)


def test_builder_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    model = build_model(Config(**TINY), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.FingerprintPipeline(model, Config(**TINY))


def test_bf16_row_norms_are_the_jax_packages(pipes):
    """ROADMAP C4: bf16 fingerprints are not unit-norm in f32. Both
    packages normalise in bf16 (the norm's square root rounded to bf16,
    then each component), so the same bf16 rows get bit-equal unit rows
    from either. Through each package's bf16 pipeline on the same
    calibrated weights, the rows themselves part (the port folds its
    BatchNorms, so its products round elsewhere) and their norms with
    them, but the JAX package's rows miss 1 as far as the port's do:
    neither norm spread may exceed the other's by half (measured on 32
    rows: JAX |n - 1| <= 0.003173, mean 0.001381; the port 0.003412, mean
    0.001329)."""
    from grafp_tpu.ops.knn import l2_normalize as j_l2_normalize
    from grafp_tpu_torch.ops.knn import l2_normalize

    jp, _, _ = pipes
    rows = jnp.asarray(np.random.RandomState(8).randn(64, 128), jnp.bfloat16)
    want = np.asarray(jax.jit(lambda v: j_l2_normalize(v, axis=-1))(rows).astype(jnp.float32))
    got = l2_normalize(torch.tensor(np.asarray(rows.astype(jnp.float32))).to(torch.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(), want)

    bf16 = dict(TINY, compute_dtype="bfloat16")
    jp16 = jb.FingerprintPipeline(j_build_model(JConfig(**bf16)), JConfig(**bf16), jp.params,
                                  jp.batch_stats, batch_size=16, bucket_s=2.0)
    tp16 = tb.FingerprintPipeline(
        load_jax_weights(build_model(Config(**bf16), device="cpu"), jp.params, jp.batch_stats),
        Config(**bf16), batch_size=16, bucket_s=2.0, device="cpu")
    waves = _waves(3)
    off = {}
    for name, pipe in (("jax", jp16), ("port", tp16)):
        z = np.concatenate([pipe.fingerprint_track(w) for w in waves]).astype(np.float64)
        off[name] = np.abs(np.linalg.norm(z, axis=1) - 1)
        print(f"{name} bf16 rows ({len(z)}): |norm - 1| max {off[name].max():.6f} "
              f"mean {off[name].mean():.6f}")
    assert off["jax"].max() > 1e-3                     # the JAX package's own rows
    for stat in (np.max, np.mean):
        a, b = stat(off["jax"]), stat(off["port"])
        assert max(a, b) <= 1.5 * min(a, b), (stat.__name__, a, b)
