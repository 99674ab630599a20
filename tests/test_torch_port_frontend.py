"""The port's frontend (log-mel, segment unfold, PeakEmbed) against the
JAX package on the same numpy inputs. Tolerance: f32 atol 1e-4 on dB
values and on PeakEmbed activations (matmul summation order differs)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grafp_tpu.dsp import melspec as jmel  # noqa: E402
from grafp_tpu.dsp.segment import unfold_segments as j_unfold  # noqa: E402
from grafp_tpu.models.peak_embed import PeakEmbed as JPeakEmbed  # noqa: E402
from grafp_tpu_torch.dsp import melspec as tmel  # noqa: E402
from grafp_tpu_torch.dsp.segment import num_segments, unfold_segments  # noqa: E402
from grafp_tpu_torch.models.peak_embed import PeakEmbed  # noqa: E402
from tests.torch_port_util import load_jax_weights, to_torch  # noqa: E402


@pytest.mark.parametrize("center,n_samples", [(True, 16000), (False, 17024)])
def test_log_mel_matches_jax(rng, center, n_samples):
    waves = rng.randn(3, n_samples).astype(np.float32)
    jcfg = jmel.LogMelConfig(center=center)
    tcfg = tmel.LogMelConfig(center=center)
    want = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(waves), jcfg))
    got = tmel.log_mel_spectrogram(to_torch(waves), tcfg).numpy()
    assert got.shape == want.shape == (3, 64, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_log_mel_silence_hits_the_amin_floor():
    """A silent wave is clamped at amin=1e-10: -100 dB everywhere, as in
    the reference."""
    got = tmel.log_mel_spectrogram(torch.zeros(1, 16000), tmel.LogMelConfig())
    np.testing.assert_array_equal(got.numpy(), np.full((1, 64, 32), -100.0,
                                                       np.float32))


def test_unfold_segments_matches_jax(rng):
    spec = rng.randn(64, 100).astype(np.float32)
    want = np.asarray(j_unfold(jnp.asarray(spec), 32, 3))
    got = unfold_segments(to_torch(spec), 32, 3).numpy()
    np.testing.assert_array_equal(got, want)
    assert num_segments(100, 32, 3) == 23 and num_segments(31, 32, 3) == 0
    assert unfold_segments(to_torch(spec[:, :31]), 32, 3).shape == (0, 64, 32)


def test_peak_embed_matches_jax(rng):
    spec = (10.0 * rng.randn(2, 64, 32)).astype(np.float32)
    spec[1] = -100.0                         # a silent segment: guarded 0/0
    jm = JPeakEmbed()
    variables = jm.init(jax.random.key(0), jnp.asarray(spec))
    want = np.asarray(jm.apply(variables, jnp.asarray(spec)))
    tm = load_jax_weights(PeakEmbed(), variables["params"], {})
    with torch.no_grad():
        got = tm(to_torch(spec)).numpy()
    assert got.shape == want.shape == (2, 1024, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
