"""Tests of the port that need an NVIDIA card (marker ``cuda``). They
import torch and the port only, so they also run where JAX is absent:

    python -m pytest --noconftest -q -m cuda tests/test_torch_port_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX for the other tests.)
Without a card every test here skips."""

import pytest

torch = pytest.importorskip("torch")

from grafp_tpu_torch.ops.mrconv_concat import (  # noqa: E402
    MRConvConcat,
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


@pytest.mark.parametrize("fault", ["dtype", "contiguous", "k", "rank"])
def test_wrapper_rejects_what_the_kernel_does_not_take(card, fault):
    x = torch.randn(2, 64, 16, device=card)
    args = {"dtype": (x.half(), 3), "contiguous": (x.transpose(1, 2), 3),
            "k": (x, 9), "rank": (x[0], 3)}[fault]
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
