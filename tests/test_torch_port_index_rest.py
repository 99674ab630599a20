"""The rest of the port's index family (grafp_tpu_torch/retrieval/index.py
'ivfpq-rr' and 'lsh', retrieval/hnsw.py with native/hnsw_native.py, and
``scan_topk='approx'`` in retrieval/search.py) against the JAX package's
(grafp_tpu/retrieval/index.py:385-511, retrieval/hnsw.py,
retrieval/search.py:43-103) on the CPU, on the same numpy data.

Tolerances:
- 'ivfpq-rr', on the JAX index's coarse centroids and both codebooks:
  cells equal, PQ codes equal but on rows within f32 rounding of two
  centroids (under 5 %, counted); on JAX's codes too, ids equal and
  distances within 1e-5;
- 'lsh', on the JAX index's planes: codes equal except where a projection
  lies within 1e-5 of 0 (counted; both packages' f32 products may round
  it to either sign), ids and Hamming distances equal;
- 'hnsw': ids and distances equal to the JAX package's on the same rows
  and seed, per backend (the Python backends draw levels from numpy's
  RandomState, the C++ ones from std::mt19937);
- 'approx': mean recall against the exact selection at least the target
  (XLA lowers ``lax.approx_max_k`` to an exact top-k on the CPU, so JAX's
  own result is the exact one here); bit-equal to the exact path at
  ``scan_recall`` = 1.0; the merge across blocks exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grafp_tpu.retrieval import hnsw as jhnsw  # noqa: E402
from grafp_tpu.retrieval import index as jix  # noqa: E402
from grafp_tpu.retrieval import search as jse  # noqa: E402
from grafp_tpu.retrieval.memmap_io import save_memmap  # noqa: E402
from grafp_tpu_torch.native import hnsw_native  # noqa: E402
from grafp_tpu_torch.retrieval import evaluate as tev  # noqa: E402
from grafp_tpu_torch.retrieval import hnsw as thnsw  # noqa: E402
from grafp_tpu_torch.retrieval import index as tix  # noqa: E402
from grafp_tpu_torch.retrieval import pq as tpq  # noqa: E402
from grafp_tpu_torch.retrieval import search as tse  # noqa: E402
from tests.torch_port_util import one_torch_thread  # noqa: E402, F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU = torch.device("cpu")
SIGN_BAND = 1e-5


def _unit(rs, n, d):
    x = rs.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _catalogue(seed=8, n_train=600, n_db=700, d=64, nq=40):
    rs = np.random.RandomState(seed)
    train, db = _unit(rs, n_train, d), _unit(rs, n_db, d)
    q = db[rs.choice(n_db, nq, replace=False)] + 0.05 * rs.randn(nq, d).astype(np.float32)
    return train, db, q


def test_ivfpqr_matches_jax_on_carried_over_training():
    """On the JAX index's centroids and both codebooks: the port's codes
    equal JAX's except where a row lies within f32 rounding of two PQ
    centroids (counted); with JAX's codes carried across too, the re-rank's
    ids are equal and its distances within 1e-5."""
    train, db, q = _catalogue()
    d = train.shape[1]
    jidx = jix.IndexIVFPQR(d, 16, code_sz=64, nbits=8, m_refine=4, nbits_refine=4)
    jidx.train(train)
    tidx = tix.IndexIVFPQR(d, 16, CPU, code_sz=64, nbits=8, m_refine=4, nbits_refine=4)
    tidx.centroids = torch.tensor(np.asarray(jidx.centroids))
    tidx.pq = tpq.ProductQuantizer.from_state(jidx.pq.state())
    tidx.refine = tpq.ProductQuantizer.from_state(jidx.refine.state())
    tidx.is_trained = True
    for idx in (jidx, tidx):
        idx.add(train)
        idx.add(db)
        idx.nprobe = 5
    assert tidx.ntotal == jidx.ntotal == 1300
    jcodes = np.concatenate([np.asarray(c) for c in jidx._codes])
    moved = (torch.cat(tidx._codes).numpy() != jcodes).any(1)
    print(f"ivfpq-rr: {int(moved.sum())} of {len(moved)} rows with another PQ code")
    assert moved.mean() < 0.05
    np.testing.assert_array_equal(torch.cat(tidx._cells).numpy(),
                                  np.concatenate([np.asarray(c) for c in jidx._cells]))
    tidx._codes, tidx._cache = [torch.tensor(jcodes)], None
    tidx._rcodes, tidx._rr_cache = [np.concatenate(jidx._rcodes)], None
    want_d, want_i = jidx.search(q, 20)
    got_d, got_i = tidx.search(q, 20)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_d, want_d, rtol=0, atol=1e-5)
    # the re-rank moves ids relative to the PQ stage alone
    pq_i = tix.IndexIVFPQ._search_chunk(tidx, q, 20)[1]
    assert (pq_i != got_i).any()


def test_ivfpqr_trains_its_refine_quantizer_on_the_residual():
    """The port's own training: the refine codebooks are (4, 16, d/4), and
    PQ + refine reconstructs the rows closer than PQ alone."""
    train, db, _ = _catalogue(seed=9)
    idx = tix.IndexIVFPQR(64, 8, CPU)
    idx.train(train)
    idx.add(db)
    assert tuple(idx.refine.codebooks.shape) == (4, 16, 16)
    codes, rcodes = idx._host_code_arrays()
    pq = idx.pq.decode_host(codes)
    both = pq + idx.refine.decode_host(rcodes)
    assert ((both - db) ** 2).sum() < 0.9 * ((pq - db) ** 2).sum()


def test_lsh_matches_jax_on_carried_over_planes():
    train, db, q = _catalogue(seed=10, d=128)
    jidx = jix.IndexLSH(128, nbits=256)
    tidx = tix.IndexLSH(128, CPU, nbits=256)
    tidx.planes = torch.tensor(np.asarray(jidx.planes))
    data = np.concatenate([train, db])
    for idx in (jidx, tidx):
        idx.train(train)
        idx.add(data)
    proj = data.astype(np.float64) @ np.asarray(jidx.planes, np.float64)
    band = np.abs(proj) < SIGN_BAND
    got_codes = tidx._payload()[0].numpy()
    want_codes = np.concatenate(jidx._codes)
    print(f"lsh: {int(band.sum())} of {band.size} projections within {SIGN_BAND:g} of 0")
    np.testing.assert_array_equal(got_codes[~band], want_codes[~band])
    assert set(np.unique(got_codes)) == {-1, 1}
    want_d, want_i = jidx.search(q, 20)
    got_d, got_i = tidx.search(q, 20)
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_i, want_i)
    assert (got_d == np.round(got_d)).all() and (np.diff(got_d, axis=1) >= 0).all()


def test_lsh_planes_come_from_the_index_seed():
    a, b, c = (tix.IndexLSH(16, CPU, nbits=32, seed=s) for s in (3, 3, 4))
    assert torch.equal(a.planes, b.planes) and not torch.equal(a.planes, c.planes)


def _corpus(seed, n=500, d=24, nq=40):
    rs = np.random.RandomState(seed)
    db = _unit(rs, n, d)
    gt = rs.choice(n, nq, replace=False)
    return db, db[gt] + 0.03 * rs.randn(nq, d).astype(np.float32), gt


@pytest.mark.parametrize("backend", ["python", "native"])
def test_hnsw_matches_jax(backend):
    db, q, gt = _corpus(11)
    jidx = jhnsw.IndexHNSW(db.shape[1], seed=5, backend=backend)
    tidx = thnsw.IndexHNSW(db.shape[1], seed=5, backend=backend)
    assert (tidx._native is None) == (backend == "python")
    for idx in (jidx, tidx):
        idx.add(db[:300])
        idx.add(db[300:])
    want_d, want_i = jidx.search(q, 10)
    got_d, got_i = tidx.search(q, 10)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_d, want_d)
    assert np.mean(got_i[:, 0] == gt) >= 0.95
    np.testing.assert_array_equal(tidx.reconstruct_n(10, 5), db[10:15])


def test_hnsw_row_guards():
    assert thnsw.IndexHNSW.DEFAULT_MAX_ROWS == 100_000
    assert thnsw.IndexHNSW.NATIVE_MAX_ROWS == 2_000_000
    assert thnsw.IndexHNSW(8, backend="python").max_rows == 100_000
    assert thnsw.IndexHNSW(8).max_rows == 2_000_000
    rs = np.random.RandomState(12)
    for backend in ("python", "native"):
        idx = thnsw.IndexHNSW(8, max_rows=10, backend=backend)
        idx.add(rs.randn(6, 8).astype(np.float32))
        with pytest.raises(ValueError, match="'l2'"):
            idx.add(rs.randn(5, 8).astype(np.float32))
        assert idx.ntotal == 6                  # the refused add left it as it was


def test_hnsw_native_build_failure_raises(monkeypatch):
    """'auto' means the C++ backend: a build that fails raises, and the
    Python backend runs only when asked for by name. The library is built
    under the package's _build/ and named by a hash of the source and the
    command."""
    path = hnsw_native._lib_path()
    assert path.parent == hnsw_native.BUILD_DIR and path.name.startswith("libhnsw_native-")
    monkeypatch.setattr(hnsw_native, "CXX", "no-such-compiler-for-this-test")
    with pytest.raises(hnsw_native.NativeUnavailable, match="build failed"):
        thnsw.IndexHNSW(8)
    with pytest.raises(hnsw_native.NativeUnavailable):
        thnsw.IndexHNSW(8, backend="native")
    assert thnsw.IndexHNSW(8, backend="python")._native is None
    with pytest.raises(ValueError, match="backend"):
        thnsw.IndexHNSW(8, backend="faiss")


def test_approx_bins_follow_the_recall_formula():
    for k, r in ((20, 0.99), (20, 0.95), (10, 0.9), (2, 0.5)):
        m = tse.approx_bins(1 << 20, k, r)
        assert m & (m - 1) == 0 and m >= k
        assert ((m - 1) / m) ** (k - 1) >= r
        assert m == k or ((m // 2 - 1) / (m // 2)) ** (k - 1) < r
    assert tse.approx_bins(1 << 20, 20, 1.0) == 1 << 20      # exact
    assert tse.approx_bins(1 << 20, 1, 0.9) == 1 << 20
    assert tse.approx_bins(1000, 20, 0.999) == 1000          # M would not be below n


@pytest.mark.parametrize("recall", [0.9, 0.95, 0.99])
def test_approx_selection_recall_against_exact_and_jax(recall):
    rs = np.random.RandomState(13)
    x = rs.randn(128, 1 << 13).astype(np.float32)
    _, want = jax.lax.approx_max_k(jnp.asarray(x), 20, recall_target=recall)
    want = np.asarray(want)
    exact = tse.topk_lower_first(torch.tensor(x), 20)[1].numpy()
    np.testing.assert_array_equal(want, exact)       # XLA's CPU lowering is exact
    vals, got = tse.topk_approx(torch.tensor(x), 20, recall)
    got = got.numpy()
    hit = np.mean([len(set(a) & set(b)) / 20 for a, b in zip(got, want)])
    print(f"approx recall@20 at target {recall}: {hit:.4f}")
    assert hit >= recall
    np.testing.assert_array_equal(vals.numpy(), np.take_along_axis(x, got, 1))
    assert (np.diff(vals.numpy(), axis=1) <= 0).all()


def test_approx_topk_ip_matches_jax():
    """The serving search ``approx_topk_ip`` (inner products, approximate
    selection) against the JAX package's on unit rows: recall of its ids
    against JAX's (exact on the CPU) at least the target, values the
    inner products of its ids."""
    rs = np.random.RandomState(18)
    q, db = _unit(rs, 32, 64), _unit(rs, 1 << 12, 64)
    _, want = jse.approx_topk_ip(jnp.asarray(q), jnp.asarray(db), 10, recall_target=0.9)
    vals, got = tse.approx_topk_ip(torch.tensor(q), torch.tensor(db), 10, 0.9)
    hit = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(got.numpy(), np.asarray(want))])
    assert hit >= 0.9
    np.testing.assert_allclose(vals.numpy(), np.take_along_axis(q @ db.T, got.numpy(), 1),
                               rtol=0, atol=1e-6)


def test_approx_at_recall_one_is_the_exact_path():
    train, db, q = _catalogue(seed=14)
    rows = np.concatenate([train, db])
    exact = tse.masked_scan_search(torch.tensor(q), torch.tensor(rows), None, None, None,
                                   len(rows), 20, 256)
    one = tse.masked_scan_search(torch.tensor(q), torch.tensor(rows), None, None, None,
                                 len(rows), 20, 256, "approx", 1.0)
    for a, b in zip(exact, one):
        assert torch.equal(a, b)


def test_approx_scan_merges_blocks_exactly():
    """With several blocks, the scan's result is the exact top-k over the
    union of every block's approximate candidates, earlier blocks first
    among ties, and matches JAX's masked scan (exact on the CPU) at the
    target recall."""
    rs = np.random.RandomState(15)
    rows, q = _unit(rs, 4096, 32), _unit(rs, 64, 32)
    k, block, recall = 20, 1024, 0.9
    got_d, got_i = tse.masked_scan_search(torch.tensor(q), torch.tensor(rows), None, None,
                                          None, len(rows), k, block, "approx", recall)
    qd = torch.tensor(q)
    cand_d, cand_i = [], []
    for base in range(0, len(rows), block):
        r = torch.tensor(rows[base:base + block])
        dist = (qd * qd).sum(1, keepdim=True) - 2 * qd @ r.T + (r * r).sum(1)[None]
        nd, sel = tse.topk_approx(-dist, k, recall)
        cand_d.append(-nd)
        cand_i.append(sel + base)
    nd, sel = tse.topk_lower_first(-torch.cat(cand_d, 1), k)
    np.testing.assert_array_equal(got_i.numpy(), torch.gather(torch.cat(cand_i, 1), 1, sel))
    np.testing.assert_array_equal(got_d.numpy(), -nd.numpy())
    want_d, want_i = jse.masked_scan_search(
        jnp.asarray(q), jnp.asarray(rows), jnp.zeros((1, 1, 1)), jnp.zeros(len(rows), jnp.int32),
        jnp.zeros((64, 1), bool), jnp.int32(len(rows)), k, block, scan_topk="approx",
        recall_target=recall)
    want_i = np.asarray(want_i)
    hit = np.mean([len(set(a) & set(b)) / k for a, b in zip(got_i.numpy(), want_i)])
    assert hit >= recall


@pytest.mark.parametrize("case", [("ivfpq-rr", "exact"), ("lsh", "exact"),
                                  ("hnsw", "exact"), ("l2", "approx"),
                                  ("ivfpq", "approx")])
def test_get_index_builds_and_searches(case):
    """The acceptance side of the refusals that went: each type builds,
    trains, adds and finds the rows the queries were drawn from."""
    kind, scan = case
    train, db, q = _catalogue(seed=16, d=128)
    idx = tix.get_index(kind, train, train.shape, n_centroids=16, scan_topk=scan,
                        scan_recall=0.95, device="cpu")
    idx.add(train)
    idx.add(db)
    assert idx.ntotal == 1300 and idx.nprobe == 20
    d, i = idx.search(db[:50], 10)
    assert d.shape == i.shape == (50, 10) and (i >= 0).all()
    assert np.mean(i[:, 0] == np.arange(600, 650)) >= 0.95
    if kind != "hnsw":
        assert (idx.scan_topk, idx.scan_recall) == (scan, 0.95)


@pytest.mark.parametrize("kind", ["ivfpq-rr", "lsh", "hnsw"])
def test_eval_faiss_runs_the_new_types(kind, tmp_path):
    """eval_faiss on a small catalogue whose queries are the db rows
    themselves: well-formed hit rates, and 100 % top-1 at every length."""
    rs = np.random.RandomState(17)
    save_memmap(str(tmp_path), "dummy_db", _unit(rs, 600, 128))
    db = _unit(rs, 120, 128)
    save_memmap(str(tmp_path), "db", db)
    save_memmap(str(tmp_path), "query", db)
    hr = tev.eval_faiss(str(tmp_path), index_type=kind, test_ids="40", test_seq_len="1 3 5",
                        n_centroids=16, verbose=False, scan_topk="approx",
                        scan_recall=0.95, device="cpu")
    assert hr.shape == (4, 3) and (hr[0] == 100).all()
