"""The port's MRConv kernel module (grafp_tpu_torch/ops/mrconv_concat.py)
against the JAX package's Pallas kernel, run in interpret mode on the CPU
as tests/test_pallas_knn.py runs it: the forward, and the backward against
jax.vjp of mrconv_concat_pallas.

Tolerances: forward f32 atol 1e-6 (same selection, summation order may
differ); bf16 equal or within one bf16 ulp (the f32 mean of a tie group
may round to the other neighbouring bf16 value). Backward f32 rtol 1e-5,
atol 1e-6 (the scatter's f32 sums in another order); bf16 atol 2% of max
|dx|, as tests/test_pallas_knn.py holds the bf16 backward."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grafp_tpu.ops.pallas_knn import mrconv_concat_pallas  # noqa: E402
from grafp_tpu_torch.ops.mrconv_concat import (  # noqa: E402
    MRConvConcat,
    mrconv_concat,
    mrconv_concat_backward,
    mrconv_concat_backward_reference,
    mrconv_concat_reference,
)
from tests.torch_port_util import (  # noqa: E402
    WIDE_IDS,
    WIDE_KINDS,
    WIDE_SHAPES,
    bf16_ulp,
    to_torch,
    wide_f32_tol,
    wide_input,
)


def _pallas(x: np.ndarray, k: int, bf16: bool = False) -> np.ndarray:
    xj = jnp.asarray(x)
    if bf16:
        xj = xj.astype(jnp.bfloat16)
    return np.asarray(mrconv_concat_pallas(xj, k, True).astype(jnp.float32))


def _port(x: np.ndarray, k: int, bf16: bool = False) -> np.ndarray:
    xt = to_torch(x, torch.bfloat16 if bf16 else torch.float32)
    return mrconv_concat_reference(xt, k).to(torch.float32).numpy()


@pytest.mark.parametrize("shape,k", [((2, 64, 16), 3), ((3, 16, 4), 2)])
def test_reference_matches_pallas_f32(rng, shape, k):
    x = rng.randn(*shape).astype(np.float32)
    np.testing.assert_allclose(_port(x, k), _pallas(x, k), rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape,k", [((2, 64, 16), 3), ((3, 16, 4), 2)])
def test_reference_matches_pallas_bf16(rng, shape, k):
    x = rng.randn(*shape).astype(np.float32)
    got, want = _port(x, k, True), _pallas(x, k, True)
    c = shape[-1]
    np.testing.assert_array_equal(got[..., :c], want[..., :c])
    assert (np.abs(got - want) <= bf16_ulp(want)).all()


@pytest.mark.parametrize("kind", WIDE_KINDS)
@pytest.mark.parametrize("shape,k", WIDE_SHAPES, ids=WIDE_IDS)
def test_reference_matches_pallas_past_the_old_limit(rng, shape, k, kind):
    """k = 8, 9, 16 at N = 1024, k = 3 at N = 3200 and k = N: the shapes
    the card's selection takes in round groups and key windows. f32 within
    1e-6 (wide_f32_tol: where a tie group outgrows it, the N/8 identical
    rows of 'duplicates' on the rows that take them in and the scaled
    copies of 'straddle', the rounding of the group's mean, which each side
    sums in another order, is added: up to 3.4e-6 |x| measured at N =
    3200); bf16 as the module."""
    x = wide_input(shape, k, kind, rng)
    got, want = _port(x, k), _pallas(x, k)
    tol = np.concatenate([np.full(x.shape, 1e-6), wide_f32_tol(x, k, kind)], -1)
    assert (np.abs(got - want) <= tol).all()
    got, want = _port(x, k, True), _pallas(x, k, True)
    c = shape[-1]
    np.testing.assert_array_equal(got[..., :c], want[..., :c])
    assert (np.abs(got - want) <= bf16_ulp(want)).all()


def test_duplicate_rows(rng):
    """5 identical rows + noise: the duplicates' neighbours are the
    duplicates themselves, and their tie group's mean is the row."""
    row = rng.randn(8).astype(np.float32)
    x = np.stack([row] * 5 + [rng.randn(8).astype(np.float32)
                              for _ in range(11)])[None]
    got = _port(x, 3)
    np.testing.assert_allclose(got, _pallas(x, 3), rtol=0, atol=1e-6)
    for i in range(5):
        np.testing.assert_allclose(got[0, i, 8:], 0.0, atol=1e-6)


def test_exact_tie_takes_the_mean(rng):
    """x_j = 2 x_i ties EXACTLY with x_i after normalisation; the round
    extracts the mean 1.5 x_i, not the first or the larger one."""
    base = rng.randn(12, 8).astype(np.float32)
    base[1] = 2.0 * base[0]
    x = base[None]
    got = _port(x, 1)
    np.testing.assert_allclose(got, _pallas(x, 1), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0, 0, 8:], 1.5 * base[0] - base[0],
                               rtol=1e-6, atol=1e-6)


def test_tie_group_straddles_budget(rng):
    """k=3 with a level-0 group of 2 (a, a) and a level-1 group of 2 (b,
    2b): round 1 is active (consumed 2 < 3) and takes the whole group's
    mean 1.5 b; round 2 is inactive (consumed 4)."""
    a = rng.randn(8).astype(np.float32)
    b = (a + 0.3 * rng.randn(8)).astype(np.float32)
    rest = [-(a + rng.rand(8).astype(np.float32)) for _ in range(6)]
    x = np.stack([a, a, b, 2.0 * b] + rest).astype(np.float32)[None]
    got = _port(x, 3)
    np.testing.assert_allclose(got, _pallas(x, 3), rtol=0, atol=1e-6)
    want_rel = np.maximum(a, 1.5 * b)
    np.testing.assert_allclose(got[0, 0, 8:], want_rel - a, rtol=1e-6,
                               atol=1e-6)


def test_n_less_than_k_raises(rng):
    x = to_torch(rng.randn(1, 2, 8))
    with pytest.raises(ValueError, match="N >= k"):
        mrconv_concat_reference(x, 3)
    with pytest.raises(ValueError, match="N >= k"):
        mrconv_concat(x, 3)


def test_wrapper_uses_plain_version_on_cpu(rng):
    """On a CPU tensor the wrapper returns the plain version's result and
    launches nothing."""
    x = to_torch(rng.randn(2, 32, 8))
    before = mrconv_concat.launches
    np.testing.assert_array_equal(mrconv_concat(x, 3).numpy(),
                                  mrconv_concat_reference(x, 3).numpy())
    assert mrconv_concat.launches == before


# --- the backward ---------------------------------------------------------

def _pallas_vjp(x: np.ndarray, g: np.ndarray, k: int, bf16: bool) -> np.ndarray:
    dt = jnp.bfloat16 if bf16 else jnp.float32
    _, vjp = jax.vjp(lambda a: mrconv_concat_pallas(a, k, True),
                     jnp.asarray(x).astype(dt))
    return np.asarray(vjp(jnp.asarray(g).astype(dt))[0].astype(jnp.float32))


def _backward_inputs(kind: str, rng):
    """(x, k) with the ties the backward must route: duplicate rows (a tie
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


@pytest.mark.parametrize("kind", ["random", "duplicates", "scaled", "straddle"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_backward_reference_matches_pallas_vjp(rng, kind, bf16):
    x, k = _backward_inputs(kind, rng)
    g = rng.randn(*x.shape[:-1], 2 * x.shape[-1]).astype(np.float32)
    want = _pallas_vjp(x, g, k, bf16)
    dt = torch.bfloat16 if bf16 else torch.float32
    got = mrconv_concat_backward_reference(to_torch(x, dt), to_torch(g, dt), k)
    assert got.dtype == dt
    got = got.float().numpy()
    if bf16:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=0.02 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", WIDE_KINDS)
@pytest.mark.parametrize("shape,k", WIDE_SHAPES, ids=WIDE_IDS)
def test_backward_reference_matches_pallas_vjp_past_the_old_limit(rng, shape, k, kind):
    """The backward at the shapes of
    test_reference_matches_pallas_past_the_old_limit, f32 and bf16."""
    x = wide_input(shape, k, kind, rng)
    g = rng.randn(*x.shape[:-1], 2 * x.shape[-1]).astype(np.float32)
    for dt in (torch.float32, torch.bfloat16):
        want = _pallas_vjp(x, g, k, dt == torch.bfloat16)
        got = mrconv_concat_backward_reference(to_torch(x, dt), to_torch(g, dt), k)
        got = got.float().numpy()
        if dt == torch.bfloat16:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=0.02 * np.abs(want).max())
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,c", [(1024, 64), (512, 128)])
def test_backward_reference_at_a_full_stage_shape(rng, n, c):
    """Stages 1 and 2 of size t, f32, with a tie group of 41 rows; at
    N = 1024 the Pallas backward sums dx over two query tiles."""
    x = rng.randn(1, n, c).astype(np.float32)
    x[:, 100:140] = x[:, 99:100]
    g = rng.randn(1, n, 2 * c).astype(np.float32)
    want = _pallas_vjp(x, g, 3, False)
    got = mrconv_concat_backward_reference(to_torch(x), to_torch(g), 3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_equals_the_plain_backward(rng, dtype):
    """MRConvConcat through torch.autograd.grad gives the plain backward
    bit for bit on the CPU, and launches nothing."""
    dt = getattr(torch, dtype)
    x, k = _backward_inputs("duplicates", rng)
    g = to_torch(rng.randn(*x.shape[:-1], 2 * x.shape[-1]), dt)
    xt = to_torch(x, dt).requires_grad_()
    before = (mrconv_concat.launches, mrconv_concat_backward.launches)
    y = MRConvConcat.apply(xt, k)
    assert torch.equal(y, mrconv_concat_reference(xt.detach(), k))
    (dx,) = torch.autograd.grad(y, xt, g)
    assert torch.equal(dx, mrconv_concat_backward_reference(xt.detach(), g, k))
    assert torch.equal(dx, mrconv_concat_backward(xt.detach(), g, k))
    assert (mrconv_concat.launches, mrconv_concat_backward.launches) == before


def test_backward_rejects_a_misshapen_cotangent(rng):
    x = to_torch(rng.randn(1, 16, 8))
    with pytest.raises(ValueError, match="g"):
        mrconv_concat_backward_reference(x, to_torch(rng.randn(1, 16, 8)), 3)
