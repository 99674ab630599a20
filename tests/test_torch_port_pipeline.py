"""The port's track path (FingerprintPipeline.fingerprint_track and its
bucketed, center=False log-mel) against the JAX pipeline on the same
weights and wave. Tolerance: log-mel atol 1e-4 dB; fingerprints cos >
0.9999 per row."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grafp_tpu.core.config import Config as JConfig  # noqa: E402
from grafp_tpu.fp.builder import FingerprintPipeline as JPipeline  # noqa: E402
from grafp_tpu.models import build_model as j_build_model  # noqa: E402
from grafp_tpu_torch.core import Config  # noqa: E402
from grafp_tpu_torch.fp import FingerprintPipeline  # noqa: E402
from grafp_tpu_torch.models import build_model  # noqa: E402
from tests.torch_port_util import load_jax_weights, randomize_jax_variables  # noqa: E402

# a 4 s bucket keeps the JAX side's padded segment count small; the 3 s
# wave is still zero-filled to the bucket, so the exact-tail rule is
# exercised
BUCKET_S = 4.0


@pytest.fixture(scope="module")
def pipelines():
    jcfg = JConfig()
    jm = j_build_model(jcfg)
    v = jm.init({"params": jax.random.key(0)},
                jnp.zeros((1, 64, 32), jnp.float32), False)
    params, stats = randomize_jax_variables(v["params"], v["batch_stats"])
    jp = JPipeline(jm, jcfg, params, stats, batch_size=8, bucket_s=BUCKET_S)
    cfg = Config()
    port = load_jax_weights(build_model(cfg, device="cpu"), params, stats)
    tp = FingerprintPipeline(port, cfg, batch_size=8, bucket_s=BUCKET_S,
                             device="cpu")
    return jp, tp


def test_track_logmel_and_segments_match_jax(pipelines):
    jp, tp = pipelines
    wave = np.random.RandomState(5).randn(48000 + 123).astype(np.float32)
    np.testing.assert_allclose(tp.track_logmel(wave), jp.track_logmel(wave),
                               rtol=0, atol=1e-4)
    got, want = tp.segments_for(wave), jp.segments_for(wave)
    assert got.shape == want.shape == (21, 64, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_fingerprint_track_matches_jax(pipelines):
    jp, tp = pipelines
    wave = np.random.RandomState(6).randn(48000).astype(np.float32)
    got, want = tp.fingerprint_track(wave), jp.fingerprint_track(wave)
    assert got.shape == want.shape == (21, 128)
    cos = (got * want).sum(-1)
    assert (cos > 0.9999).all(), cos


def test_fingerprint_track_too_short_is_empty(pipelines):
    _, tp = pipelines
    assert tp.fingerprint_track(np.zeros(1000, np.float32)).shape == (0, 128)
