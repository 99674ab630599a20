"""The port's MRConv kernel module (grafp_tpu_torch/ops/mrconv_concat.py)
against the JAX package's Pallas kernel, run in interpret mode on the CPU
as tests/test_pallas_knn.py runs it.

Tolerances: f32 atol 1e-6 (same selection, summation order may differ);
bf16 equal or within one bf16 ulp (the f32 mean of a tie group may round
to the other neighbouring bf16 value)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from grafp_tpu.ops.pallas_knn import mrconv_concat_pallas  # noqa: E402
from grafp_tpu_torch.ops.mrconv_concat import (  # noqa: E402
    mrconv_concat,
    mrconv_concat_reference,
)
from tests.torch_port_util import bf16_ulp, to_torch  # noqa: E402


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
