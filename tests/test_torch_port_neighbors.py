"""The port's neighbour-max op (grafp_tpu_torch/ops/max_neighbors.py,
ops/mrconv_neighbors.py) and dense k-NN graph (ops/knn.py) against the JAX
package: the plain versions of kernels #1/#2 against max_neighbors_pallas
in interpret mode and jax.vjp of it, as tests/test_pallas_knn.py runs them,
and every strategy of max_relative_neighbors.

Tolerances: forward f32 atol 1e-6 (same selection, another summation
order); bf16 equal or within one bf16 ulp (a tie group's f32 mean may round
to the other neighbouring bf16 value; the port's bf16 keys equal the JAX
package's bit for bit). Backward f32 rtol 1e-5, atol 1e-6; bf16 atol 2% of
max |dx|, as tests/test_pallas_knn.py holds the bf16 backward. Strategies
and graphs: indices equal, features within 1e-6."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grafp_tpu.ops import knn as jknn  # noqa: E402
from grafp_tpu.ops.mrconv_neighbors import (  # noqa: E402
    max_relative_neighbors as j_max_relative_neighbors,
)
from grafp_tpu.ops.pallas_knn import max_neighbors_pallas  # noqa: E402
from grafp_tpu_torch.ops import knn  # noqa: E402
from grafp_tpu_torch.ops.max_neighbors import (  # noqa: E402
    MaxNeighbors,
    max_neighbors,
    max_neighbors_backward,
    max_neighbors_backward_reference,
    max_neighbors_reference,
)
from grafp_tpu_torch.ops.mrconv_neighbors import max_relative_neighbors  # noqa: E402
from tests.torch_port_util import (  # noqa: E402
    WIDE_IDS,
    WIDE_KINDS,
    WIDE_SHAPES,
    bf16_ulp,
    to_torch,
    wide_f32_tol,
    wide_input,
)


def _inputs(kind: str, rng):
    """(x, k) with the ties selection must handle: duplicate rows (a tie
    group of 5), power-of-two scaled rows (exact ties between distinct
    rows), a level-1 tie group that straddles the k budget, or random."""
    if kind == "random":
        return rng.randn(2, 64, 16).astype(np.float32), 3
    if kind == "duplicates":
        x = rng.randn(2, 32, 8).astype(np.float32)
        x[:, 3:8] = x[:, 2:3]
        return x, 3
    if kind == "scaled":
        x = rng.randn(2, 32, 8).astype(np.float32)
        x[:, 1::4] = 2.0 * x[:, 0::4]
        return x, 2
    a = rng.randn(8).astype(np.float32)                     # straddle
    b = (a + 0.3 * rng.randn(8)).astype(np.float32)
    rest = [-(a + rng.rand(8).astype(np.float32)) for _ in range(6)]
    return np.stack([a, a, b, 2.0 * b] + rest).astype(np.float32)[None], 3


KINDS = ["random", "duplicates", "scaled", "straddle"]
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_reference_matches_pallas(rng, kind, dt):
    x, k = _inputs(kind, rng)
    tdt, jdt = DTYPES[dt]
    want = np.asarray(max_neighbors_pallas(jnp.asarray(x).astype(jdt), k, True)
                      .astype(jnp.float32))
    got = max_neighbors_reference(to_torch(x, tdt), k)
    assert got.dtype == tdt
    got = got.float().numpy()
    if dt == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        assert (np.abs(got - want) <= bf16_ulp(want)).all()


@pytest.mark.parametrize("kind", WIDE_KINDS)
@pytest.mark.parametrize("shape,k", WIDE_SHAPES, ids=WIDE_IDS)
def test_reference_matches_pallas_past_the_old_limit(rng, shape, k, kind):
    """k = 8, 9, 16 at N = 1024, k = 3 at N = 3200 and k = N: the shapes
    the card's selection takes in round groups and key windows. f32 within
    1e-6 (wide_f32_tol: where a tie group outgrows it, the N/8 identical
    rows of 'duplicates' on the rows that take them in and the scaled
    copies of 'straddle', the rounding of the group's mean, which each side
    sums in another order, is added); bf16 as the module."""
    x = wide_input(shape, k, kind, rng)
    for tdt, jdt in DTYPES.values():
        want = np.asarray(max_neighbors_pallas(jnp.asarray(x).astype(jdt), k, True)
                          .astype(jnp.float32))
        got = max_neighbors_reference(to_torch(x, tdt), k).float().numpy()
        if tdt == torch.float32:
            assert (np.abs(got - want) <= wide_f32_tol(x, k, kind)).all()
        else:
            assert (np.abs(got - want) <= bf16_ulp(want)).all()


def test_duplicate_rows_take_their_own_feature(rng):
    """5 identical rows: their 3 nearest are the duplicates, whose tie
    group's mean is the row itself."""
    row = rng.randn(8).astype(np.float32)
    x = np.stack([row] * 5 + [rng.randn(8).astype(np.float32)
                              for _ in range(3)])[None]
    got = max_neighbors_reference(to_torch(x), 3).numpy()[0]
    for i in range(5):
        np.testing.assert_allclose(got[i], row, rtol=1e-6, atol=1e-6)


def _pallas_vjp(x: np.ndarray, g: np.ndarray, k: int, jdt) -> np.ndarray:
    _, vjp = jax.vjp(lambda a: max_neighbors_pallas(a, k, True),
                     jnp.asarray(x).astype(jdt))
    return np.asarray(vjp(jnp.asarray(g).astype(jdt))[0].astype(jnp.float32))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_backward_reference_matches_pallas_vjp(rng, kind, dt):
    x, k = _inputs(kind, rng)
    g = rng.randn(*x.shape).astype(np.float32)
    tdt, jdt = DTYPES[dt]
    want = _pallas_vjp(x, g, k, jdt)
    got = max_neighbors_backward_reference(to_torch(x, tdt), to_torch(g, tdt), k)
    assert got.dtype == tdt
    got = got.float().numpy()
    if dt == "bf16":
        np.testing.assert_allclose(got, want, rtol=0, atol=0.02 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", WIDE_KINDS)
@pytest.mark.parametrize("shape,k", WIDE_SHAPES, ids=WIDE_IDS)
def test_backward_reference_matches_pallas_vjp_past_the_old_limit(rng, shape, k, kind):
    """The backward at the shapes of
    test_reference_matches_pallas_past_the_old_limit, f32 and bf16."""
    x = wide_input(shape, k, kind, rng)
    g = rng.randn(*x.shape).astype(np.float32)
    for tdt, jdt in DTYPES.values():
        want = _pallas_vjp(x, g, k, jdt)
        got = max_neighbors_backward_reference(to_torch(x, tdt), to_torch(g, tdt), k)
        got = got.float().numpy()
        if tdt == torch.bfloat16:
            np.testing.assert_allclose(got, want, rtol=0, atol=0.02 * np.abs(want).max())
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_n_less_than_k_raises(rng):
    x = to_torch(rng.randn(1, 2, 8))
    for fn in (lambda: max_neighbors_reference(x, 3), lambda: max_neighbors(x, 3),
               lambda: max_neighbors_backward(x, x, 3)):
        with pytest.raises(ValueError, match="N >= k"):
            fn()


def test_backward_rejects_a_misshapen_cotangent(rng):
    x = to_torch(rng.randn(1, 16, 8))
    with pytest.raises(ValueError, match="g"):
        max_neighbors_backward_reference(x, to_torch(rng.randn(1, 16, 16)), 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_equals_the_plain_backward(rng, dtype):
    """MaxNeighbors through torch.autograd.grad gives the plain backward
    bit for bit on the CPU, and launches nothing."""
    dt = getattr(torch, dtype)
    x, k = _inputs("duplicates", rng)
    g = to_torch(rng.randn(*x.shape), dt)
    xt = to_torch(x, dt).requires_grad_()
    before = (max_neighbors.launches, max_neighbors_backward.launches)
    y = MaxNeighbors.apply(xt, k)
    assert torch.equal(y, max_neighbors_reference(xt.detach(), k))
    (dx,) = torch.autograd.grad(y, xt, g)
    assert torch.equal(dx, max_neighbors_backward_reference(xt.detach(), g, k))
    assert torch.equal(dx, max_neighbors_backward(xt.detach(), g, k))
    assert (max_neighbors.launches, max_neighbors_backward.launches) == before


# --- max_relative_neighbors ------------------------------------------------

@pytest.mark.parametrize("strategy", ["exact", "approx", "onehot"])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_strategy_matches_jax(rng, strategy, compute):
    """Random inputs (no near ties): the same neighbours, the same max."""
    x = rng.randn(2, 40, 16).astype(np.float32)
    want = np.asarray(j_max_relative_neighbors(
        jnp.asarray(x), 3, strategy=strategy, compute_dtype=getattr(jnp, compute)))
    got = max_relative_neighbors(to_torch(x), 3, strategy=strategy,
                                 compute_dtype=getattr(torch, compute))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_pallas_and_auto_strategies_on_the_cpu(rng):
    """'pallas' is MaxNeighbors (the plain versions on a CPU tensor, with a
    gradient); 'auto' is 'onehot' on the CPU. Both equal the JAX 'pallas'
    strategy here: random inputs have no ties."""
    x = rng.randn(2, 32, 8).astype(np.float32)
    want = np.asarray(max_neighbors_pallas(jnp.asarray(x), 3, True))
    xt = to_torch(x).requires_grad_()
    got = max_relative_neighbors(xt, 3, strategy="pallas")
    assert got.grad_fn is not None
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)
    auto = max_relative_neighbors(to_torch(x), 3, strategy="auto")
    assert torch.equal(auto, max_relative_neighbors(to_torch(x), 3, "onehot"))
    with pytest.raises(ValueError, match="strategy"):
        max_relative_neighbors(to_torch(x), 3, strategy="sorted")


def test_onehot_gradient_matches_jax(rng):
    x = rng.randn(1, 24, 8).astype(np.float32)
    want = np.asarray(jax.grad(lambda a: jnp.sum(j_max_relative_neighbors(
        a, 3, strategy="onehot") ** 2))(jnp.asarray(x)))
    xt = to_torch(x).requires_grad_()
    (max_relative_neighbors(xt, 3, strategy="onehot") ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-5, atol=1e-6)


# --- the k-NN graph --------------------------------------------------------

@pytest.mark.parametrize("block_rows", [0, 8, 12])
def test_knn_graph_matches_jax(rng, block_rows):
    """Dense and query-row-tiled (12 does not divide N = 40)."""
    x = rng.randn(2, 40, 16).astype(np.float32)
    want = np.asarray(jknn.knn_graph(jnp.asarray(x), 5, block_rows=block_rows))
    got = knn.knn_graph(to_torch(x), 5, block_rows=block_rows)
    assert got.shape == (2, 40, 5) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[..., 0] == torch.arange(40)).all()          # self first


def test_gather_and_dilate_match_jax(rng):
    x = rng.randn(2, 40, 16).astype(np.float32)
    idx = np.asarray(jknn.knn_graph(jnp.asarray(x), 6))
    want = np.asarray(jknn.gather_neighbors(jnp.asarray(x), jnp.asarray(idx)))
    got = knn.gather_neighbors(to_torch(x), torch.tensor(idx, dtype=torch.int64))
    np.testing.assert_array_equal(got.numpy(), want)
    for d in (1, 2, 3):
        np.testing.assert_array_equal(
            knn.dilate_neighbors(torch.tensor(idx), d).numpy(),
            np.asarray(jknn.dilate_neighbors(jnp.asarray(idx), d)))


def test_pairwise_sqdist_matches_jax(rng):
    x = rng.randn(2, 20, 8).astype(np.float32)
    y = rng.randn(2, 12, 8).astype(np.float32)
    for args in ((x,), (x, y)):
        want = np.asarray(jknn.pairwise_sqdist(*map(jnp.asarray, args)))
        got = knn.pairwise_sqdist(*map(to_torch, args)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_l2_normalize_matches_jax(rng, dt):
    """bf16: bit for bit (the norm rounded as XLA rounds it); f32: within
    one ulp (summation order)."""
    tdt, jdt = DTYPES[dt]
    x = (rng.randn(64, 100) * rng.choice([1e-3, 1.0, 30.0], size=(64, 1))).astype(np.float32)
    x[:2] = 0.0
    want = np.asarray(jknn.l2_normalize(jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    got = knn.l2_normalize(to_torch(x, tdt)).float().numpy()
    if dt == "bf16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)
