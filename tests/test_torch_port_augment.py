"""The port's augment (grafp_tpu_torch/dsp/augment.py) against the JAX
package's (grafp_tpu/dsp/augment.py): the banks, the IR convolutions, the
noise gather and mix, and the whole chain with the random draws that JAX
makes from its key splits handed to the port's deterministic core.

Tolerances: banks, spectra and noise gathers bit-equal (the same numpy
code and the same indices); convolutions atol 1e-4 (f32 DFT matmuls and
FFTs summed in another order, on waves of unit scale); noise mixing rtol
1e-5 (pow and sqrt of two libraries)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grafp_tpu.dsp import augment as jaug  # noqa: E402
from grafp_tpu_torch.dsp import augment as taug  # noqa: E402
from tests.torch_port_util import to_torch  # noqa: E402

B, T = 6, 3000            # three 1024-sample blocks
SNR = (0.0, 20.0)


def _clips(rng):
    noise = [rng.randn(n).astype(np.float32) for n in (700, 4100, 5000)]
    irs = [(rng.randn(n) * np.exp(-np.arange(n) / 300.0)).astype(np.float32)
           for n in (2500, 900, 1)]
    return noise, irs


def _banks(rng, spectra: bool = True):
    noise, irs = _clips(rng)
    jb = jaug.AugmentBanks.from_arrays(noise_clips=noise, ir_clips=irs,
                                       noise_len=4000, ir_len=2500)
    tb = taug.AugmentBanks.from_arrays(noise_clips=noise, ir_clips=irs,
                                       noise_len=4000, ir_len=2500)
    if not spectra:
        jb.ir_spec_re = jb.ir_spec_im = None
        tb.ir_spec_re = tb.ir_spec_im = None
    return jb, tb


def _jax_draws(banks, key, b):
    """The draws of grafp_tpu.dsp.augment.augment_waveforms, from its key
    splits (augment.py:288, :262-268), as the port's AugmentDraws."""
    k_ir_row, k_ir_p, k_n, k_snr, k_np = jax.random.split(key, 5)
    k_row, k_off = jax.random.split(k_n)
    draws = dict(
        ir_rows=jax.random.randint(k_ir_row, (b,), 0, banks.ir.shape[0]),
        ir_take=jax.random.uniform(k_ir_p, (b,)),
        noise_rows=jax.random.randint(k_row, (b,), 0, banks.noise.shape[0]),
        noise_offsets=jax.random.randint(k_off, (b,), 0, 2 ** 30),
        snr=jax.random.uniform(k_snr, (b,), minval=SNR[0], maxval=SNR[1]),
        noise_take=jax.random.uniform(k_np, (b,)))
    return taug.AugmentDraws(**{k: torch.tensor(np.asarray(v))
                                for k, v in draws.items()})


def test_banks_match_jax(rng):
    """Noise rows looped to a multiple of 128 samples, IR rows zero-padded,
    valid counts, and the IR partition spectra."""
    jb, tb = _banks(rng)
    for name in ("noise", "noise_valid", "ir", "ir_valid", "ir_spec_re",
                 "ir_spec_im"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)), name)
    assert tb.noise.shape == (3, 4096) and tb.ir_spec_re.shape == (3, 3, 1025)


def test_apply_ir_os_and_fft_match_jax(rng):
    jb, tb = _banks(rng)
    x = rng.randn(3, T).astype(np.float32)
    want = np.asarray(jaug.apply_ir_os(jnp.asarray(x), jb.ir_spec_re,
                                       jb.ir_spec_im))
    got = taug.apply_ir_os(to_torch(x), tb.ir_spec_re, tb.ir_spec_im).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    want_fft = np.asarray(jaug.apply_ir(jnp.asarray(x), jb.ir))
    got_fft = taug.apply_ir(to_torch(x), tb.ir).numpy()
    np.testing.assert_allclose(got_fft, want_fft, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, got_fft, rtol=0, atol=1e-4)


def test_sample_noise_and_mix_match_jax(rng):
    jb, tb = _banks(rng)
    key = jax.random.key(3)
    draws = _jax_draws(jb, key, B)
    _, _, k_n, _, _ = jax.random.split(key, 5)
    want = np.asarray(jaug._sample_noise(jb, k_n, B, T))
    got = taug._sample_noise(tb, draws.noise_rows, draws.noise_offsets, T)
    np.testing.assert_array_equal(got.numpy(), want)
    x = rng.randn(B, T).astype(np.float32)
    silent = np.zeros((1, T), np.float32)
    noise = np.concatenate([want[:-1], silent])       # a silent row passes x
    want_mix = np.asarray(jaug.mix_noise_at_snr(
        jnp.asarray(x), jnp.asarray(noise), jnp.asarray(draws.snr.numpy())))
    got_mix = taug.mix_noise_at_snr(to_torch(x), to_torch(noise), draws.snr)
    np.testing.assert_allclose(got_mix.numpy(), want_mix, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got_mix[-1].numpy(), x[-1])


@pytest.mark.parametrize("spectra", [True, False], ids=["gemm", "fft"])
def test_augment_core_with_jax_draws_matches_jax(rng, spectra):
    """The whole chain at probability 0.5 for both steps (so some rows
    take each branch), the JAX draws fed to the port's core."""
    jb, tb = _banks(rng, spectra)
    x = rng.randn(B, T).astype(np.float32)
    key = jax.random.key(7)
    want = np.asarray(jaug.augment_waveforms(jnp.asarray(x), jb, key, SNR,
                                             0.5, 0.5))
    draws = _jax_draws(jb, key, B)
    assert 0 < int((draws.ir_take < 0.5).sum()) < B
    got = taug.augment_with_draws(to_torch(x), tb, draws, 0.5, 0.5).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_sampler_draws_in_range_and_repeats(rng):
    _, tb = _banks(rng)
    d1 = taug.sample_augment_draws(tb, 64, torch.Generator().manual_seed(0), SNR)
    d2 = taug.sample_augment_draws(tb, 64, torch.Generator().manual_seed(0), SNR)
    for name in ("ir_rows", "ir_take", "noise_rows", "noise_offsets", "snr",
                 "noise_take"):
        assert torch.equal(getattr(d1, name), getattr(d2, name)), name
    assert int(d1.ir_rows.max()) < 3 and int(d1.noise_rows.max()) < 3
    assert 0 <= int(d1.noise_offsets.min()) and int(d1.noise_offsets.max()) < 2 ** 30
    assert SNR[0] <= float(d1.snr.min()) and float(d1.snr.max()) < SNR[1]
    x = to_torch(rng.randn(4, T))
    same = taug.augment_waveforms(x, tb, torch.Generator().manual_seed(0), SNR,
                                  0.0, 0.0)
    assert torch.equal(same, x)
    moved = taug.augment_waveforms(x, tb, torch.Generator().manual_seed(0), SNR)
    assert moved.shape == x.shape and bool(torch.isfinite(moved).all())
    assert not torch.allclose(moved, x)
