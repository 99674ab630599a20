"""Tests of the port that need an NVIDIA card (marker ``cuda``). They
import torch and the port only, so they also run where JAX is absent:

    python -m pytest --noconftest -q -m cuda tests/test_torch_port_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX for the other tests.)
Without a card every test here skips."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grafp_tpu_torch.models.gnn import Grapher  # noqa: E402
from grafp_tpu_torch.models.layers import init_parameters  # noqa: E402
from grafp_tpu_torch.ops.grapher_block import (  # noqa: E402
    _mm,
    grapher_block,
    grapher_block_reference,
)
from grafp_tpu_torch.ops.max_neighbors import (  # noqa: E402
    MaxNeighbors,
    max_neighbors,
    max_neighbors_backward,
    max_neighbors_backward_reference,
    max_neighbors_reference,
)
from grafp_tpu_torch.ops.mrconv_concat import (  # noqa: E402
    MRConvConcat,
    _norm_rows_f32,
    mrconv_concat,
    mrconv_concat_backward,
    mrconv_concat_backward_reference,
    mrconv_concat_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(card, dtype, b=3, n=200, c=40):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(b, n, c, generator=g)
    x[:, 10:30] = x[:, 10:11]                 # a tie group of 20 rows
    x[:, 41::7] = 2.0 * x[:, 40::7][:, : x[:, 41::7].shape[1]]   # scaled copies
    return x.to(card, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_version(card, dtype):
    """Ragged shapes (N, C not multiples of the tiles) with exact ties:
    the kernel equals the plain version (the x half bit for bit; rel - x
    within 1e-6 in f32, one bf16 ulp in bf16) and counts one launch."""
    dt = getattr(torch, dtype)
    x = _inputs(card, dt)
    before = mrconv_concat.launches
    got = mrconv_concat(x, 3).float()
    want = mrconv_concat_reference(x, 3).float()
    torch.cuda.synchronize()
    assert mrconv_concat.launches == before + 1
    c = x.shape[-1]
    assert torch.equal(got[..., :c], want[..., :c])
    if dt == torch.float32:
        tol = torch.full_like(want, 1e-6)
    else:
        tol = torch.ldexp(torch.ones_like(want), torch.frexp(want)[1] - 8)
    assert bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("k", [1, 2, 5, 8])
def test_kernel_other_k(card, k):
    x = _inputs(card, torch.float32, b=2, n=96, c=24)
    got, want = mrconv_concat(x, k), mrconv_concat_reference(x, k)
    assert bool(((got - want).abs() <= 1e-6).all())


@pytest.mark.parametrize("fault", ["dtype", "contiguous", "k", "rank", "kn"])
def test_wrapper_rejects_what_the_kernel_does_not_take(card, fault):
    x = torch.randn(2, 64, 16, device=card)
    args = {"dtype": (x.half(), 3), "contiguous": (x.transpose(1, 2), 3),
            "k": (x, 9), "rank": (x[0], 3),
            "kn": (torch.randn(1, 1100, 8, device=card), 8)}[fault]
    before = mrconv_concat.launches
    with pytest.raises((TypeError, ValueError)):
        mrconv_concat(*args)
    assert mrconv_concat.launches == before


def _bf16_ulp(t):
    return torch.ldexp(torch.ones_like(t), torch.frexp(t)[1] - 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernel_matches_plain_version(card, dtype):
    """Ragged shapes with a tie group of 20 rows and scaled copies: the
    backward kernel equals the plain version within f32 summation order
    (1e-5 + 1e-5 |ref|) or one bf16 ulp (+1e-6), counts one launch, and
    two launches give bit-equal dx."""
    dt = getattr(torch, dtype)
    x = _inputs(card, dt)
    g = torch.randn(x.shape[0], x.shape[1], 2 * x.shape[2],
                    generator=torch.Generator().manual_seed(1)).to(card, dt)
    before = mrconv_concat_backward.launches
    got = mrconv_concat_backward(x, g, 3)
    again = mrconv_concat_backward(x, g, 3)
    want = mrconv_concat_backward_reference(x, g, 3).float()
    torch.cuda.synchronize()
    assert mrconv_concat_backward.launches == before + 2
    assert got.dtype == dt and torch.equal(got, again)
    got = got.float()
    if dt == torch.float32:
        tol = 1e-5 + 1e-5 * want.abs()
    else:
        tol = _bf16_ulp(want) + 1e-6
    assert bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("k", [1, 2, 5, 8])
def test_backward_kernel_other_k(card, k):
    x = _inputs(card, torch.float32, b=2, n=96, c=24)
    g = torch.randn(2, 96, 48, device=card)
    got = mrconv_concat_backward(x, g, k)
    want = mrconv_concat_backward_reference(x, g, k)
    assert bool(((got - want).abs() <= 1e-5 + 1e-5 * want.abs()).all())


def test_autograd_launches_both_kernels(card):
    """MRConvConcat through autograd: one forward and one backward launch,
    and the gradient equals the backward wrapper's."""
    x = _inputs(card, torch.float32, b=2, n=64, c=16).requires_grad_()
    g = torch.randn(2, 64, 32, device=card)
    f0, b0 = mrconv_concat.launches, mrconv_concat_backward.launches
    (dx,) = torch.autograd.grad(MRConvConcat.apply(x, 3), x, g)
    torch.cuda.synchronize()
    assert (mrconv_concat.launches - f0, mrconv_concat_backward.launches - b0) == (1, 1)
    assert torch.equal(dx, mrconv_concat_backward(x.detach(), g, 3))


@pytest.mark.parametrize("fault", ["dtype", "contiguous", "shape"])
def test_backward_wrapper_rejects_what_the_kernel_does_not_take(card, fault):
    x = torch.randn(2, 64, 16, device=card)
    g = torch.randn(2, 64, 32, device=card)
    args = {"dtype": (x, g.bfloat16(), 3),
            "contiguous": (x, g.transpose(0, 1).contiguous().transpose(0, 1), 3),
            "shape": (x, g[..., :16].contiguous(), 3)}[fault]
    before = mrconv_concat_backward.launches
    with pytest.raises((TypeError, ValueError)):
        mrconv_concat_backward(*args)
    assert mrconv_concat_backward.launches == before


# --- the selection's tiles at their edges (kernels #3 and #4) ---------------

# chip_smoke.py's near-tie band
NEAR_TIE_EPS = {torch.float32: 1e-4, torch.bfloat16: 1e-3}

# (B, N, C, k) and how the rows tie. Tiles: 64 rows x 128 keys, channels
# in steps of 16 (bf16, zero-padded) or 32 (f32).
_EDGES = {
    "N100-C40": (2, 100, 40, 3, None),             # N under one key tile, not a multiple of 16
    "N3-k3-C24": (2, 3, 24, 3, None),              # N = k
    "C24": (2, 160, 24, 3, None),                  # C not a multiple of 16
    "C640": (2, 96, 640, 3, None),
    "all-identical": (2, 130, 40, 3, "item"),      # item 1: a tie group of N in round 0
    "tie-across-row-tiles": (2, 200, 64, 3, "span"),   # rows 40-89: pass B's gather
    "B1-k8": (1, 150, 40, 8, None),
}


def _edge_inputs(card, dt, b, n, c, ties):
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(b, n, c, generator=gen)
    if ties == "item":
        x[1] = x[1, :1]
    elif ties == "span":
        x[:, 40:90] = x[:, 40:41]
    g = torch.randn(b, n, 2 * c, generator=gen)
    return x.to(card, dt), g.to(card, dt)


def _near_tie_rows(x, k, backward):
    """(B, N): rows whose top-(k+1) scores (in f64, as chip_smoke.py
    takes them) have a gap in (0, eps); for dx, every row among the
    top-(k+1) of such a row."""
    xn = _norm_rows_f32(x).to(x.dtype).double()
    scores = xn @ xn.transpose(1, 2)
    top = scores.topk(min(k + 1, x.shape[1]), dim=-1).values
    gaps = top[..., :-1] - top[..., 1:]
    near = ((gaps > 0) & (gaps < NEAR_TIE_EPS[x.dtype])).any(-1)
    if not backward:
        return near
    return ((scores >= top[..., -1:]) & near[..., None]).any(1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(_EDGES))
def test_selection_tile_edges(card, case, dtype):
    """The forward (rel - x) and the backward (dx) at the edges of the
    kernels' tiles, against the plain versions, two launches bit-equal.
    rel - x within 1e-6 (f32) or one bf16 ulp; dx within 1e-5 + 1e-5 |ref|
    (f32) or one bf16 ulp + 1e-6. Rows with a near tie in the plain
    version's top-(k+1) scores (chip_smoke.py's band: a gap in (0, 1e-4)
    in f32, (0, 1e-3) in bf16; for dx, those rows' top-(k+1) rows) may
    differ, at most 1 % of the rows or one: the bf16 scores come from the
    tensor cores, which add each 16-channel step's products in another
    order than the plain version's matmul, so a near tie can flip there
    that the f32 fmaf chain keeps."""
    dt = getattr(torch, dtype)
    b, n, c, k, ties = _EDGES[case]
    x, g = _edge_inputs(card, dt, b, n, c, ties)
    out, out2 = mrconv_concat(x, k), mrconv_concat(x, k)
    dx, dx2 = mrconv_concat_backward(x, g, k), mrconv_concat_backward(x, g, k)
    want_out = mrconv_concat_reference(x, k)
    want_dx = mrconv_concat_backward_reference(x, g, k).float()
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(dx, dx2)
    assert torch.equal(out[..., :c], x)
    rel, want_rel = out[..., c:].float(), want_out[..., c:].float()
    if dt == torch.float32:
        ok_rel = (rel - want_rel).abs() <= 1e-6
        ok_dx = (dx - want_dx).abs() <= 1e-5 + 1e-5 * want_dx.abs()
    else:
        ok_rel = (rel - want_rel).abs() <= _bf16_ulp(want_rel)
        ok_dx = (dx.float() - want_dx).abs() <= _bf16_ulp(want_dx) + 1e-6
    for ok, backward in ((ok_rel, False), (ok_dx, True)):
        bad = ~ok.all(-1)
        assert not bool((bad & ~_near_tie_rows(x, k, backward)).any())
        assert int(bad.sum()) <= max(1, 0.01 * bad.numel())


# --- max_neighbors (kernels #1 and #2) -------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_max_neighbors_kernels_match_plain_versions(card, dtype):
    """Ragged shapes with a tie group of 20 rows and scaled copies: rel
    within 1e-6 (f32) or one bf16 ulp of the plain version, dx within f32
    summation order (1e-5 + 1e-5 |ref|) or one bf16 ulp (+1e-6); one launch
    each, and two backward launches bit-equal."""
    dt = getattr(torch, dtype)
    x = _inputs(card, dt)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(1)).to(card, dt)
    f0, b0 = max_neighbors.launches, max_neighbors_backward.launches
    rel = max_neighbors(x, 3)
    dx, again = max_neighbors_backward(x, g, 3), max_neighbors_backward(x, g, 3)
    torch.cuda.synchronize()
    assert (max_neighbors.launches - f0, max_neighbors_backward.launches - b0) == (1, 2)
    assert rel.dtype == dt and dx.dtype == dt and torch.equal(dx, again)
    want_rel = max_neighbors_reference(x, 3).float()
    want_dx = max_neighbors_backward_reference(x, g, 3).float()
    if dt == torch.float32:
        assert bool(((rel - want_rel).abs() <= 1e-6).all())
        assert bool(((dx - want_dx).abs() <= 1e-5 + 1e-5 * want_dx.abs()).all())
    else:
        assert bool(((rel.float() - want_rel).abs() <= _bf16_ulp(want_rel)).all())
        assert bool(((dx.float() - want_dx).abs() <= _bf16_ulp(want_dx) + 1e-6).all())


@pytest.mark.parametrize("k", [1, 2, 5, 8])
def test_max_neighbors_kernels_other_k(card, k):
    x = _inputs(card, torch.float32, b=2, n=96, c=24)
    g = torch.randn(2, 96, 24, device=card)
    assert bool(((max_neighbors(x, k) - max_neighbors_reference(x, k)).abs() <= 1e-6).all())
    got = max_neighbors_backward(x, g, k)
    want = max_neighbors_backward_reference(x, g, k)
    assert bool(((got - want).abs() <= 1e-5 + 1e-5 * want.abs()).all())


def test_max_neighbors_autograd_launches_both_kernels(card):
    x = _inputs(card, torch.float32, b=2, n=64, c=16).requires_grad_()
    g = torch.randn(2, 64, 16, device=card)
    f0, b0 = max_neighbors.launches, max_neighbors_backward.launches
    (dx,) = torch.autograd.grad(MaxNeighbors.apply(x, 3), x, g)
    torch.cuda.synchronize()
    assert (max_neighbors.launches - f0, max_neighbors_backward.launches - b0) == (1, 1)
    assert torch.equal(dx, max_neighbors_backward(x.detach(), g, 3))


# --- grapher_block (kernel #5) ---------------------------------------------

def _folded(card, dt, c, seed=2):
    """An eval-mode Grapher of width c whose weights and BatchNorm
    statistics all come from ``seed`` (not from the global generator, so
    the block is the same whichever tests ran before)."""
    g = Grapher(c, k=3, fuse_serving="on", dtype=dt)
    gen = torch.Generator().manual_seed(seed)
    init_parameters(g, gen)
    with torch.no_grad():
        for bn in (g.fc1_bn, g.gconv.bn, g.fc2_bn):
            bn.running_mean.normal_(0.0, 0.3, generator=gen)
            bn.running_var.uniform_(0.5, 2.0, generator=gen)
    return g.to(card).eval()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grapher_block_kernel_matches_plain_version(card, dtype):
    """Ragged shapes (N = 100, C = 40: no tile divides them) with a tie
    group of 20 rows: the kernel equals the plain version within 1e-4 +
    1e-4 |ref| (f32) or 3 bf16 ulps of each row's largest output (bf16),
    and counts one launch."""
    dt = getattr(torch, dtype)
    g = _folded(card, dt, 40)
    x = _inputs(card, dt, b=3, n=100, c=40)
    ws = g.folded_weights(dt)
    before = grapher_block.launches
    got = grapher_block(x, 3, *ws).float()
    want = grapher_block_reference(x, 3, *ws).float()
    torch.cuda.synchronize()
    assert grapher_block.launches == before + 1
    if dt == torch.float32:
        assert bool(((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all())
    else:
        scale = want.abs().amax(-1, keepdim=True)
        assert bool(((got - want).abs() <= 3 * _bf16_ulp(scale)).all())


def test_grapher_block_f32_holds_over_weight_draws(card):
    """The f32 block on the ragged tie-heavy input above against its plain
    version, at the same tolerance, over 50 seeded weight and BatchNorm
    draws: a draw whose k-NN selection the kernel flipped would fail."""
    x = _inputs(card, torch.float32, b=3, n=100, c=40)
    for seed in range(100, 150):
        ws = _folded(card, torch.float32, 40, seed=seed).folded_weights(torch.float32)
        got = grapher_block(x, 3, *ws)
        want = grapher_block_reference(x, 3, *ws)
        assert bool(((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all()), seed


# The product kernels' edges: (B, N, C, on a side stream). bf16 tiles are
# 128 rows x up to 256 columns in chunks of 64, K in steps of 64; TMA needs
# rows of a multiple of 16 bytes, so C = 20 takes the cp.async path for fc1
# and fc2. f32 tiles are 128 x 128, K in steps of 16.
_PRODUCT_EDGES = {
    "C16": (2, 128, 16, False),
    "C24": (2, 128, 24, False),
    "C40": (2, 128, 40, False),
    "C80": (2, 128, 80, False),
    "C20-rows-not-16-bytes": (2, 96, 20, False),
    "N256-C400": (2, 256, 400, False),             # size s's ragged stage 3
    "B1-N100": (1, 100, 40, False),                # B N not a multiple of the row tile
    "B128-N128-C512": (128, 128, 512, False),      # many tiles
    "side-stream": (2, 128, 64, True),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(_PRODUCT_EDGES))
def test_grapher_block_product_edges(card, case, dtype):
    """The fused block at the edges of its product kernels' tiles against
    the plain version, at test_grapher_block_kernel_matches_plain_version's
    tolerances (1e-4 + 1e-4 |ref| in f32, 3 bf16 ulps of each row's largest
    output in bf16), two launches bit-equal. Rows with a near tie in the
    plain x1's top-(k+1) scores (chip_smoke.py's band) may select
    differently, at most 1 % of the rows or one. The side-stream case
    launches on a non-default stream and must equal the launch on the
    default one bit for bit."""
    dt = getattr(torch, dtype)
    b, n, c, side = _PRODUCT_EDGES[case]
    ws = _folded(card, dt, c).folded_weights(dt)
    x = torch.randn(b, n, c, generator=torch.Generator().manual_seed(4)).to(card, dt)
    before = grapher_block.launches
    if side:
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            got, again = grapher_block(x, 3, *ws), grapher_block(x, 3, *ws)
        torch.cuda.current_stream().wait_stream(stream)
        assert torch.equal(got, grapher_block(x, 3, *ws))
    else:
        got, again = grapher_block(x, 3, *ws), grapher_block(x, 3, *ws)
    want = grapher_block_reference(x, 3, *ws).float()
    torch.cuda.synchronize()
    assert grapher_block.launches - before == (3 if side else 2)
    assert got.dtype == dt and torch.equal(got, again)
    got = got.float()
    if dt == torch.float32:
        ok = (got - want).abs() <= 1e-4 + 1e-4 * want.abs()
    else:
        ok = (got - want).abs() <= 3 * _bf16_ulp(want.abs().amax(-1, keepdim=True))
    bad = ~ok.all(-1)
    x1 = (_mm(x.reshape(b * n, c), ws[0]) + ws[1]).to(dt).reshape(b, n, c)
    assert not bool((bad & ~_near_tie_rows(x1, 3, False)).any())
    assert int(bad.sum()) <= max(1, 0.01 * bad.numel())


def test_fused_grapher_launches_the_kernel(card):
    g = _folded(card, torch.bfloat16, 64)
    x = torch.randn(2, 128, 64, device=card, dtype=torch.bfloat16)
    f0, m0 = grapher_block.launches, mrconv_concat.launches
    with torch.no_grad():
        y = g(x)
    torch.cuda.synchronize()
    assert (grapher_block.launches - f0, mrconv_concat.launches - m0) == (1, 0)
    assert y.shape == x.shape and bool(torch.isfinite(y.float()).all())


@pytest.mark.parametrize("fault", ["weight_dtype", "bias_dtype", "shape"])
def test_grapher_block_wrapper_rejects_what_the_kernel_does_not_take(card, fault):
    g = _folded(card, torch.float32, 16)
    x = torch.randn(2, 32, 16, device=card)
    ws = list(g.folded_weights(torch.float32))
    if fault == "weight_dtype":
        ws[0] = ws[0].bfloat16()
    elif fault == "bias_dtype":
        ws[1] = ws[1].bfloat16()
    else:
        x = torch.randn(2, 128, 1024, device=card)
    before = grapher_block.launches
    with pytest.raises(ValueError):
        grapher_block(x, 3, *ws)
    assert grapher_block.launches == before


# --- the evaluation path: 'auto' fusing, the C1 refusal, search and rescoring

def test_fuse_serving_auto_resolves_on_the_tensors_device(card):
    g = Grapher(16, fuse_serving="auto")
    assert g.fuses(torch.zeros(1, 8, 16, device=card))
    assert not g.fuses(torch.zeros(1, 8, 16))
    model = _folded(card, torch.bfloat16, 64)
    model.fuse_serving = "auto"
    x = torch.randn(2, 128, 64, device=card, dtype=torch.bfloat16)
    before = grapher_block.launches
    with torch.no_grad():
        model(x)
    torch.cuda.synchronize()
    assert grapher_block.launches == before + 1


def test_build_model_refuses_what_the_kernels_do_not_take_on_the_card(card):
    from grafp_tpu_torch.core import Config
    from grafp_tpu_torch.models import build_model

    with pytest.raises(NotImplementedError, match="k <= 8 and k \\* N <= 8192"):
        build_model(Config(k=9), device=card)
    assert build_model(Config(k=9), device="cpu") is not None


def _db_with_ties(rows=5000, d=128, seed=0):
    g = torch.Generator().manual_seed(seed)
    db = torch.nn.functional.normalize(torch.randn(rows, d, generator=g), dim=1)
    db[100:120] = db[50]                        # twenty exact copies of row 50
    q = torch.nn.functional.normalize(torch.randn(64, d, generator=g), dim=1)
    q[0] = db[50]
    return db, q


@pytest.mark.parametrize("kind", ["l2", "ivfpq"])
def test_search_on_the_card_matches_the_cpu_path(card, kind):
    """The same index contents and training on the card and on the CPU:
    ids equal except at ranks within 1e-4 of a neighbour, the tie group
    in index order, distances within 1e-4."""
    from grafp_tpu_torch.retrieval import index as tix

    db, q = _db_with_ties()
    cpu = tix.get_index(kind, db.numpy(), db.shape, device="cpu")
    if kind == "l2":
        dev = tix.IndexFlat(128, card)
    else:
        cpu.nprobe = 8
        dev = tix.IndexIVFPQ(128, cpu.nlist, card)
        dev.centroids = cpu.centroids.to(card)
        dev.pq.codebooks = cpu.pq.codebooks.to(card)
        dev.is_trained = True
    for idx in (cpu, dev):
        idx.add(db.numpy())
        idx.nprobe = 8
    want_d, want_i = cpu.search(q.numpy(), 30)
    got_d, got_i = dev.search(q.numpy(), 30)
    assert np.abs(got_d - want_d).max() <= 1e-4
    gaps = np.diff(want_d, axis=1)
    close = (gaps > 0) & (gaps < 1e-4)
    near = np.zeros(want_d.shape, bool)
    near[:, 1:] |= close
    near[:, :-1] |= close
    assert (got_i[~near] == want_i[~near]).all()
    if kind == "l2":
        assert got_i[0, :21].tolist() == [50] + list(range(100, 120))


def test_score_block_on_the_card_matches_the_host(card):
    from grafp_tpu_torch.retrieval import evaluate as tev

    db, _ = _db_with_ties(2000, 64, seed=1)
    recon = db.numpy()
    rs = np.random.RandomState(2)
    tids = rs.randint(0, 1900, 40)
    sl = 5
    q = np.stack([recon[t:t + sl] for t in tids]) + 0.1 * rs.randn(40, sl, 64).astype(np.float32)
    cand = np.concatenate([tids[:, None] + rs.randint(-3, 4, (40, 30)),
                           np.full((40, 5), 100), rs.randint(1990, 2000, (40, 5))], 1)
    cand_s, valid = tev._unique_candidates(cand)
    _, got = tev._score_block(torch.as_tensor(recon, device=card),
                              torch.as_tensor(q.astype(np.float32), device=card),
                              torch.as_tensor(cand_s, device=card),
                              torch.as_tensor(valid, device=card), sl)
    _, want = tev._score_block_host(recon, q.astype(np.float32), cand_s, valid, sl)
    assert (got.cpu().numpy() == want).all()
