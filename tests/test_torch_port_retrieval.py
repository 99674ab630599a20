"""The port's retrieval engine (grafp_tpu_torch/retrieval/) against the
JAX package's (grafp_tpu/retrieval/) on the CPU, on the same numpy data
and the JAX functions' own random draws.

Tolerances: k-means centroids and PQ codebooks within 1e-5; assignments,
codes and search ids equal, except at a search rank whose distance is
within 1e-4 of the next (the two packages' f32 products sum in another
order; ranks skipped so are under a quarter, which the tests check);
search distances within 1e-4 (1e-3 for IVFPQ, whose codes may differ at
such near ties); the sequence eval's hit-rate and raw-score arrays
equal. Among exactly equal scores the lower index comes first, as
lax.top_k does, on deliberate ties."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grafp_tpu.retrieval import evaluate as jev  # noqa: E402
from grafp_tpu.retrieval import index as jix  # noqa: E402
from grafp_tpu.retrieval import kmeans as jkm  # noqa: E402
from grafp_tpu.retrieval import pq as jpq  # noqa: E402
from grafp_tpu.retrieval import search as jse  # noqa: E402
from grafp_tpu.retrieval.memmap_io import save_memmap  # noqa: E402
from grafp_tpu_torch.retrieval import evaluate as tev  # noqa: E402
from grafp_tpu_torch.retrieval import index as tix  # noqa: E402
from grafp_tpu_torch.retrieval import kmeans as tkm  # noqa: E402
from grafp_tpu_torch.retrieval import pq as tpq  # noqa: E402
from grafp_tpu_torch.retrieval import search as tse  # noqa: E402

CPU = torch.device("cpu")
GAP = 1e-4


def _unit(rs, n, d):
    x = rs.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _jax_kmeans_draws(key, m, k, iters):
    """The row draws of grafp_tpu.retrieval.kmeans.kmeans (kmeans.py:33-50)."""
    init = np.asarray(jax.random.permutation(key, m)[:k])
    reseed = np.stack([np.asarray(jax.random.randint(kk, (k,), 0, m))
                       for kk in jax.random.split(key, iters)])
    return torch.tensor(init), torch.tensor(reseed)


def _assert_ids_equal_outside_ties(got, want, dist):
    """ids equal at every rank whose distance (the reference's, ascending)
    is not within GAP of the rank before or after it (at most a quarter
    of the ranks are skipped so)."""
    gaps = np.diff(dist, axis=1)
    close = (gaps > 0) & (gaps < GAP)
    near = np.zeros(dist.shape, bool)
    near[:, 1:] |= close
    near[:, :-1] |= close
    assert near.mean() < 0.25
    np.testing.assert_array_equal(got[~near], want[~near])


@pytest.mark.parametrize("case", ["random", "ties", "zeros_and_inf"])
def test_topk_lower_first_matches_lax_top_k(case):
    rs = np.random.RandomState(0)
    x = rs.randn(5, 300).astype(np.float32)
    if case != "random":
        x = rs.randint(0, 4, size=(5, 300)).astype(np.float32)
    if case == "zeros_and_inf":
        x[0, :50] = -0.0
        x[1, 10:20] = np.inf
        x[2, :] = -np.inf
    got_v, got_i = tse.topk_lower_first(torch.tensor(x), 40)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 40)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_kmeans_with_jax_draws_matches_jax():
    rs = np.random.RandomState(1)
    m, d, k, iters = 600, 8, 16, 6
    data = (3 * rs.randn(k, d)[rs.randint(0, k, m)] + rs.randn(m, d)).astype(np.float32)
    data[:20] = data[20]                         # a tie group of 21 rows
    key = jax.random.key(3)
    want_c, want_a = jkm.kmeans(key, jnp.asarray(data), k, iters)
    init, reseed = _jax_kmeans_draws(key, m, k, iters)
    got_c, got_a = tkm.kmeans(torch.tensor(data), k, iters, init=init, reseed=reseed)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_array_equal(
        tkm.assign(torch.tensor(data), got_c).numpy(),
        np.asarray(jkm.assign(jnp.asarray(data), want_c)))


def test_kmeans_draws_from_a_generator_and_fewer_rows_than_k():
    data = torch.tensor(np.random.RandomState(2).randn(5, 4).astype(np.float32))
    c1, a1 = tkm.kmeans(data, 8, 3, generator=torch.Generator().manual_seed(4))
    c2, a2 = tkm.kmeans(data, 8, 3, generator=torch.Generator().manual_seed(4))
    assert torch.equal(c1, c2) and torch.equal(a1, a2)
    assert c1.shape == (8, 4) and a1.shape == (5,)
    assert torch.equal(c1[:5], data)          # rows j % m, every row its own cell


@pytest.fixture(scope="module")
def trained_pq():
    """A JAX ProductQuantizer trained on 1000 rows (d 16, 8 subspaces of
    256 centroids) and the port's, trained with the same draws."""
    rs = np.random.RandomState(5)
    data = rs.randn(1000, 16).astype(np.float32)
    key, iters = jax.random.key(1), 4
    jq = jpq.ProductQuantizer(16, 8, 256)
    jq.train(key, jnp.asarray(data), iters=iters)
    draws = [_jax_kmeans_draws(kk, 1000, 256, iters) for kk in jax.random.split(key, 8)]
    tq = tpq.ProductQuantizer(16, 8, 256)
    tq.train(torch.tensor(data), iters=iters, init=torch.stack([a for a, _ in draws]),
             reseed=torch.stack([b for _, b in draws]))
    return data, jq, tq


def test_pq_train_encode_decode_match_jax(trained_pq):
    data, jq, tq = trained_pq
    np.testing.assert_allclose(tq.codebooks.numpy(), np.asarray(jq.codebooks),
                               rtol=0, atol=1e-5)
    codes = tq.encode(torch.tensor(data))
    assert codes.dtype == torch.uint8
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jq.encode(jnp.asarray(data))))
    want = np.asarray(jq.decode(jnp.asarray(codes.numpy())))
    np.testing.assert_allclose(tq.decode(codes).numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tq.decode_host(codes.numpy()), want, rtol=0, atol=1e-5)
    st = tpq.ProductQuantizer.from_state(jq.state())
    assert torch.equal(st.encode(torch.tensor(data)), codes)


@pytest.mark.parametrize("block_rows", [0, 64, 1000])
def test_exact_topk_matches_jax_and_keeps_lower_index_on_ties(block_rows):
    rs = np.random.RandomState(6)
    db = _unit(rs, 300, 16)
    db[50:60] = db[40]                         # ten exact copies of row 40
    q = _unit(rs, 9, 16)
    q[0] = db[40]
    want_s, want_i = jse.exact_topk(jnp.asarray(q), jnp.asarray(db), 12,
                                    block_rows=block_rows)
    got_s, got_i = tse.exact_topk(torch.tensor(q), torch.tensor(db), 12,
                                  block_rows=block_rows)
    want_s, want_i = np.asarray(want_s), np.asarray(want_i)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=0, atol=1e-4)
    _assert_ids_equal_outside_ties(got_i.numpy(), want_i, want_s)
    assert got_i[0, :11].tolist() == [40] + list(range(50, 60))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_exact_topk_streaming_and_ip_match_jax(metric):
    """The host-block streaming scan (host blocks of 128 rows, device
    blocks of 48) and the inner-product metric, against JAX's."""
    rs = np.random.RandomState(11)
    db = _unit(rs, 300, 16)
    db[200:205] = db[7]
    q = _unit(rs, 6, 16)
    q[0] = db[7]
    want_s, want_i = jse.exact_topk_streaming(q, db, 10, host_block=128,
                                              device_block=48, metric=metric)
    got_s, got_i = tse.exact_topk_streaming(q, db, 10, host_block=128,
                                            device_block=48, metric=metric,
                                            device="cpu")
    sign = 1.0 if metric == "l2" else -1.0
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-4)
    _assert_ids_equal_outside_ties(got_i, np.asarray(want_i), sign * np.asarray(want_s))
    assert got_i[0, :6].tolist() == [7, 200, 201, 202, 203, 204]
    s, i = tse.exact_topk(torch.tensor(q), torch.tensor(db), 10, metric=metric)
    assert torch.equal(i, torch.tensor(got_i))


def _scan_inputs(rs, m=500, pad=140, d=16, nlist=8, nq=11):
    rows = np.concatenate([_unit(rs, m, d), np.zeros((pad, d), np.float32)])
    rows[100:110] = rows[90]                   # exact ties
    cells = np.concatenate([rs.randint(0, nlist, m), -np.ones(pad, int)]).astype(np.int32)
    member = rs.rand(nq, nlist) < 0.5
    q = _unit(rs, nq, d)
    q[0] = rows[90]
    return q, rows, cells, member


@pytest.mark.parametrize("kind", ["flat", "ivf", "ivfpq"])
def test_masked_scan_search_matches_jax_with_pad_rows(kind, trained_pq):
    """Zero pad rows past m_valid must never be selected, ahead of real
    rows or not; the probe mask drops rows of unprobed cells."""
    rs = np.random.RandomState(7)
    q, rows, cells, member = _scan_inputs(rs)
    m = 500
    codebooks = None
    payload = rows
    if kind == "ivfpq":
        _, jq, _ = trained_pq
        payload = np.asarray(jq.encode(jnp.asarray(rows)))
        codebooks = np.asarray(jq.codebooks)
    has_cells = kind != "flat"
    want_s, want_i = jse.masked_scan_search(
        jnp.asarray(q), jnp.asarray(payload),
        jnp.asarray(codebooks if codebooks is not None else np.zeros((1, 1, 1), np.float32)),
        jnp.asarray(cells), jnp.asarray(member), jnp.int32(m), 20, 128,
        has_cells=has_cells, has_codes=codebooks is not None)
    got_s, got_i = tse.masked_scan_search(
        torch.tensor(q), torch.tensor(payload),
        None if codebooks is None else torch.tensor(codebooks),
        torch.tensor(cells) if has_cells else None,
        torch.tensor(member) if has_cells else None, m, 20, 128)
    want_s, want_i = np.asarray(want_s), np.asarray(want_i)
    got_s, got_i = got_s.numpy(), got_i.numpy()
    finite = np.isfinite(want_s)
    np.testing.assert_array_equal(np.isfinite(got_s), finite)
    np.testing.assert_allclose(got_s[finite], want_s[finite], rtol=0, atol=1e-4)
    _assert_ids_equal_outside_ties(np.where(finite, got_i, -1),
                                   np.where(finite, want_i, -1), want_s)
    assert (got_i[finite] < m).all()
    if kind == "flat":
        assert got_i[0, :11].tolist() == [90] + list(range(100, 110))


def _jax_index(kind, d, data, nlist=16):
    if kind == "l2":
        idx = jix.IndexFlat(d)
    elif kind == "ivf":
        idx = jix.IndexIVFFlat(d, nlist)
    else:
        idx = jix.IndexIVFPQ(d, nlist, code_sz=64, nbits=8)
    idx.train(data)
    return idx


def _port_like(jidx, kind, d, nlist=16):
    """The port's index with the JAX index's trained centroids and PQ."""
    if kind == "l2":
        return tix.IndexFlat(d, CPU)
    if kind == "ivf":
        idx = tix.IndexIVFFlat(d, nlist, CPU)
    else:
        idx = tix.IndexIVFPQ(d, nlist, CPU, code_sz=64, nbits=8)
        idx.pq = tpq.ProductQuantizer.from_state(jidx.pq.state())
    idx.centroids = torch.tensor(np.asarray(jidx.centroids))
    idx.is_trained = True
    return idx


@pytest.mark.parametrize("kind", ["l2", "ivf", "ivfpq"])
def test_index_search_matches_jax_on_carried_over_training(kind):
    rs = np.random.RandomState(8)
    d = 64
    train = _unit(rs, 600, d)
    db = _unit(rs, 700, d)
    q = db[rs.choice(700, 40, replace=False)] + 0.05 * rs.randn(40, d).astype(np.float32)
    jidx = _jax_index(kind, d, train)
    tidx = _port_like(jidx, kind, d)
    for idx in (jidx, tidx):
        idx.add(train)
        idx.add(db)
        idx.nprobe = 5
    want_d, want_i = jidx.search(q, 20)
    got_d, got_i = tidx.search(q, 20)
    assert tidx.ntotal == jidx.ntotal == 1300
    # 'ivfpq': a code may differ where a row's subspace value is as near to
    # two centroids within f32 rounding, which moves its distance by ~1e-4
    np.testing.assert_allclose(got_d, want_d, rtol=0,
                               atol=1e-3 if kind == "ivfpq" else 1e-4)
    _assert_ids_equal_outside_ties(got_i, want_i, want_d)
    if kind == "ivfpq":
        np.testing.assert_allclose(tidx.reconstruct_n(600, 5), jidx.reconstruct_n(600, 5),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("bad", [("ivfpq-ondisk", "exact", 0.99, NotImplementedError),
                                 ("l2", "aprox", 0.99, ValueError),
                                 ("lsh", "approx", 0.0, ValueError),
                                 ("faiss", "exact", 0.99, ValueError)])
def test_get_index_refuses_what_is_not_ported(bad):
    """What get_index still refuses: 'ivfpq-ondisk' (as the JAX package
    does), a scan_topk or scan_recall typo, an unknown type. The types and
    the selection these cases once refused ('ivfpq-rr', 'lsh', 'hnsw',
    scan_topk='approx') came in slice 9 and are built and searched in
    tests/test_torch_port_index_rest.py::test_get_index_builds_and_searches."""
    kind, scan, recall, err = bad
    data = np.zeros((10, 64), np.float32)
    with pytest.raises(err):
        tix.get_index(kind, data, data.shape, scan_topk=scan, scan_recall=recall,
                      device="cpu")


def test_get_index_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    data = np.zeros((10, 64), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tix.get_index("l2", data, data.shape)


def test_score_block_ties_window_truncation_and_fill():
    """Identical windows score equal: the lower candidate must rank first,
    on the card's path (torch), on the host's (numpy) and in JAX's; a
    window past the DB end averages its in-range rows; unused slots are
    -999999."""
    rs = np.random.RandomState(9)
    recon = _unit(rs, 60, 8)
    recon[30:33] = recon[10:13]                  # window 30 equals window 10
    q = np.stack([recon[10:13], recon[57:60]]).astype(np.float32)   # (2, 3, 8)
    cand = np.array([[5, 10, 30, 58, -1, 10], [58, 57, 59, 2, 3, 4]])
    cand_s, valid = tev._unique_candidates(cand)
    got_s, got_i = tev._score_block(torch.tensor(recon), torch.tensor(q),
                                    torch.tensor(cand_s), torch.tensor(valid), 3)
    host_s, host_i = tev._score_block_host(recon, q, cand_s, valid, 3)
    want_s, want_i = jev._score_block(jnp.asarray(recon), jnp.asarray(q),
                                      jnp.asarray(cand_s), jnp.asarray(valid), 3)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(host_i, np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6, atol=1e-6)
    assert got_i[0, :2].tolist() == [10, 30] and got_i[0, -1] == -999999
    assert got_i[1, 0] == 57


def test_resolve_test_ids_matches_jax(tmp_path):
    for ids in ("all", "7", np.array([-3, 5, 1000])):
        np.testing.assert_array_equal(tev.resolve_test_ids(ids, 50, 5),
                                      jev.resolve_test_ids(ids, 50, 5))
    np.save(tmp_path / "ids.npy", np.array([2, 99]))
    np.testing.assert_array_equal(tev.resolve_test_ids(str(tmp_path / "ids.npy"), 50, 5),
                                  [2, 45])


@pytest.fixture(scope="module")
def emb_dir(tmp_path_factory):
    """Synthetic fingerprint memmaps in the reference layout: db rows are
    the clean versions of the query rows, plus a dummy corpus; d = 64 so
    that the 64-subspace PQ applies."""
    path = tmp_path_factory.mktemp("emb")
    rs = np.random.RandomState(0)
    d = 64
    db = _unit(rs, 120, d)
    q = db + 0.25 * rs.randn(120, d).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    save_memmap(str(path), "dummy_db", _unit(rs, 500, d))
    save_memmap(str(path), "db", db)
    save_memmap(str(path), "query", q)
    return str(path)


def _results(emb_dir, before):
    new = sorted(set(os.listdir(emb_dir)) - before)
    out = [d for d in new if os.path.isdir(os.path.join(emb_dir, d))]
    assert len(out) == 1
    return (np.load(os.path.join(emb_dir, out[0], "hit_rates.npy")),
            np.load(os.path.join(emb_dir, out[0], "raw_score.npy")),
            np.load(os.path.join(emb_dir, "test_ids.npy")))


@pytest.fixture(scope="module")
def jax_evals(emb_dir):
    """JAX's eval_faiss for 'l2' and 'ivfpq' (n_centroids 16): its result
    arrays and its trained 'ivfpq' index."""
    out, trained = {}, {}
    real = jev.get_index

    def capture(*args, **kw):
        trained["index"] = real(*args, **kw)
        return trained["index"]

    for kind in ("l2", "ivfpq"):
        before = set(os.listdir(emb_dir))
        jev.get_index = capture
        try:
            jev.eval_faiss(emb_dir, index_type=kind, nogpu=True, test_ids="all",
                           test_seq_len="1 3 5", n_centroids=16, verbose=False)
        finally:
            jev.get_index = real
        out[kind] = (_results(emb_dir, before), trained["index"])
    return out


@pytest.mark.parametrize("rescore", ["device", "host"])
@pytest.mark.parametrize("kind", ["l2", "ivfpq"])
def test_eval_faiss_matches_jax(emb_dir, jax_evals, kind, rescore, monkeypatch):
    """The port's eval_faiss on the same memmaps, with 'ivfpq' on the JAX
    index's centroids and codebooks: the same hit rates, raw scores and
    test ids, whichever side rescores."""
    (want_hr, want_raw, want_ids), jidx = jax_evals[kind]
    if kind == "ivfpq":
        monkeypatch.setattr(tev, "get_index",
                            lambda *a, **kw: _port_like(jidx, kind, 64))
    before = set(os.listdir(emb_dir))
    hr = tev.eval_faiss(emb_dir, index_type=kind, test_ids="all",
                        test_seq_len="1 3 5", n_centroids=16, verbose=False,
                        rescore=rescore, device="cpu")
    got_hr, got_raw, got_ids = _results(emb_dir, before)
    np.testing.assert_array_equal(hr, got_hr)
    assert got_hr.shape == (4, 3) and got_raw.shape == (115, 12)
    np.testing.assert_array_equal(got_hr, want_hr)
    np.testing.assert_array_equal(got_raw, want_raw)
    np.testing.assert_array_equal(got_ids, want_ids)
    assert got_hr.dtype == want_hr.dtype and got_raw.dtype == want_raw.dtype
    if kind == "l2":
        assert (got_hr[0] > 0).all() and (got_hr[3] >= got_hr[2]).all()
