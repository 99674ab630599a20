"""The port's serving model against the JAX package on shared weights
(converted by grafp_tpu_torch.convert.state_dict_from_jax) and shared
numpy inputs, in f32. Tolerance: rtol/atol 2e-3 on (h, z) and cos(z) >
0.9999, as tests/test_torch_import.py holds the JAX model to a torch
replica."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grafp_tpu.core.config import Config as JConfig  # noqa: E402
from grafp_tpu.dsp.melspec import LogMelConfig as JLogMelConfig  # noqa: E402
from grafp_tpu.dsp.melspec import log_mel_spectrogram as j_log_mel  # noqa: E402
from grafp_tpu.models import build_model as j_build_model  # noqa: E402
from grafp_tpu_torch.convert import state_dict_from_jax  # noqa: E402
from grafp_tpu_torch.core import Config  # noqa: E402
from grafp_tpu_torch.fp import FingerprintPipeline  # noqa: E402
from grafp_tpu_torch.models import Grapher, build_model  # noqa: E402
from tests.torch_port_util import (  # noqa: E402
    load_jax_weights,
    randomize_jax_variables,
    to_torch,
)


def _jax_model(jcfg, spec_shape):
    model = j_build_model(jcfg)
    v = model.init({"params": jax.random.key(0)},
                   jnp.zeros(spec_shape, jnp.float32), False)
    params, stats = randomize_jax_variables(v["params"], v["batch_stats"])
    return model, params, stats


def _assert_close(got_h, got_z, want_h, want_z):
    np.testing.assert_allclose(got_h, want_h, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got_z, want_z, rtol=2e-3, atol=2e-3)
    cos = (got_z * want_z).sum(-1)
    assert (cos > 0.9999).all(), cos


def test_tiny_slice_matches_jax_pallas_path(rng):
    """N = 128 nodes, size t; the JAX side runs the Pallas kernel in
    interpret mode (knn_strategy='pallas')."""
    kw = dict(n_mels=16, n_frames=16)
    model, params, stats = _jax_model(JConfig(knn_strategy="pallas", **kw),
                                      (1, 16, 16))
    spec = (10.0 * rng.randn(2, 16, 16)).astype(np.float32)
    want_h, want_z = model.apply({"params": params, "batch_stats": stats},
                                 jnp.asarray(spec), False)
    port = load_jax_weights(build_model(Config(**kw), device="cpu"),
                            params, stats)
    with torch.no_grad():
        h, z = port(to_torch(spec))
    _assert_close(h.numpy(), z.numpy(), np.asarray(want_h), np.asarray(want_z))


def test_full_width_wave_to_z_matches_jax(rng):
    """Default Config (64x32 log-mel, N = 1024, size t), B = 2 raw waves
    through the log-mel and the model, against the JAX model's default CPU
    path."""
    jcfg = JConfig()
    model, params, stats = _jax_model(jcfg, (1, 64, 32))
    waves = rng.randn(2, jcfg.clip_frames).astype(np.float32)
    spec = j_log_mel(jnp.asarray(waves), JLogMelConfig.from_config(jcfg))
    want_h, want_z = model.apply({"params": params, "batch_stats": stats},
                                 spec, False)
    cfg = Config()
    port = load_jax_weights(build_model(cfg, device="cpu"), params, stats)
    pipe = FingerprintPipeline(port, cfg, device="cpu")
    z = pipe.fingerprint_waves(waves).numpy()
    with torch.no_grad():
        h, _ = port(to_torch(np.asarray(spec)))
    _assert_close(h.numpy(), z, np.asarray(want_h), np.asarray(want_z))


def _tiny_tree():
    cfg = JConfig(n_mels=16, n_frames=16)
    _, params, stats = _jax_model(cfg, (1, 16, 16))
    return params, stats, build_model(Config(n_mels=16, n_frames=16),
                                      device="cpu")


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_weight_bridge_rejects_bad_trees(fault):
    params, stats, port = _tiny_tree()
    state_dict_from_jax(params, stats, port)       # the clean tree converts
    proj = params["encoder"]["proj"]["Dense_0"]
    if fault == "missing":
        del proj["bias"]
        err = KeyError
    elif fault == "extra":
        proj["scale"] = np.ones_like(proj["bias"])
        err = KeyError
    else:
        proj["bias"] = np.zeros(proj["bias"].shape[0] + 1, np.float32)
        err = ValueError
    with pytest.raises(err):
        state_dict_from_jax(params, stats, port)


@pytest.mark.parametrize("kwargs", [dict(conv="edge"), dict(dilation=2)])
def test_grapher_outside_the_slice_raises(kwargs):
    with pytest.raises(NotImplementedError, match="later"):
        Grapher(8, **kwargs)


@pytest.mark.parametrize("override", [dict(serve_quant="int8"),
                                      # the port has every arch of the JAX
                                      # package (grafp, ast, nafp) since slice 8
                                      dict(arch="resnet"),
                                      dict(compute_dtype="float16"),
                                      dict(knn_strategy="onehot"),
                                      dict(knn_strategy="exact"),
                                      dict(knn_strategy="approx"),
                                      dict(arch="ast", serve_quant="int8"),
                                      dict(arch="nafp", serve_quant="int8_static")])
def test_build_model_rejects_unported_configs(override):
    with pytest.raises((NotImplementedError, ValueError)):
        build_model(Config(**override), device="cpu")


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(Config())


def test_batchnorm_train_mode_uses_batch_statistics():
    """A train-mode forward normalises with the batch's statistics: it
    differs from the eval-mode one, moves every running statistic, and
    leaves the eval forward's running statistics alone; DropPath ('ramp')
    is still refused."""
    cfg = Config(n_mels=16, n_frames=16)
    port = build_model(cfg, device="cpu")
    spec = torch.randn(2, 16, 16, generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in port.state_dict().items()
              if "running_" in k}
    with torch.no_grad():
        _, z_eval = port(spec)
        assert all(torch.equal(v, port.state_dict()[k]) for k, v in before.items())
        _, z_train = port.train()(spec)
    assert not torch.allclose(z_eval, z_train)
    after = port.state_dict()
    assert all(not torch.equal(v, after[k]) for k, v in before.items())
    with pytest.raises(NotImplementedError, match="later"):
        build_model(Config(n_mels=16, n_frames=16, drop_path_schedule="ramp"),
                    device="cpu")
