"""Tests of the port that need an NVIDIA card (marker ``cuda``). They
import torch and the port only, so they also run where JAX is absent:

    python -m pytest --noconftest -q -m cuda tests/test_torch_port_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX for the other tests.)
Without a card every test here skips."""

import pytest

torch = pytest.importorskip("torch")

from grafp_tpu_torch.ops.mrconv_concat import (  # noqa: E402
    mrconv_concat,
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


@pytest.mark.parametrize("fault", ["dtype", "contiguous", "k", "rank"])
def test_wrapper_rejects_what_the_kernel_does_not_take(card, fault):
    x = torch.randn(2, 64, 16, device=card)
    args = {"dtype": (x.half(), 3), "contiguous": (x.transpose(1, 2), 3),
            "k": (x, 9), "rank": (x[0], 3)}[fault]
    before = mrconv_concat.launches
    with pytest.raises((TypeError, ValueError)):
        mrconv_concat(*args)
    assert mrconv_concat.launches == before
