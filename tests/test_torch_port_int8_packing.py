"""Fault C6: under dynamic int8 (``serve_quant='int8'``) a fingerprint
depends on the rest of its embed batch (one activation scale per tensor),
so a DB build's rows depend on how its tracks are packed, in both
packages. ``FingerprintPipeline.fingerprint_tracks`` then builds the JAX
package's batches (every segment of the bucket, short groups repeat-padded
to the pack, the last batch zero-padded), and its packed rows equal the
JAX package's at the same packing.

On the same 7 tracks of one length bucket at pack 3 (groups of 3, 3 and a
repeat-padded 1), on calibrated weights at the 1 kHz geometry of the JAX
package's own pipeline test (one JAX compile): each port row nearest its
own JAX row above cos 0.995, with a mean above 0.999 (measured: min
0.99778, mean 0.99929 over 271 rows; one batch through the two models alone
gives min 0.9981 at this geometry, since each int8 layer rounds values that
differ by f32 rounding to the nearest step); against the port's own rows at
pack 1 the rows at packs 3 and 8 fall below 0.995 (measured: min 0.97973
and 0.97890), so the packing is seen; at pack 1 the rows are
``fingerprint_track``'s. Without quantisation the rows do not depend on the
packing (tests/test_torch_port_db.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grafp_tpu.core.config import Config as JConfig  # noqa: E402
from grafp_tpu.fp.builder import FingerprintPipeline as JPipeline  # noqa: E402
from grafp_tpu.models import build_model as j_build_model  # noqa: E402
from grafp_tpu_torch.convert import state_dict_from_jax  # noqa: E402
from grafp_tpu_torch.core import Config  # noqa: E402
from grafp_tpu_torch.fp import FingerprintPipeline  # noqa: E402
from grafp_tpu_torch.models import build_model  # noqa: E402
from tests.torch_port_util import (  # noqa: E402
    calibrated_jax_variables,
    hold_rows,
    one_torch_thread,
    to_torch,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PIPE = dict(fs=1000, win_len=256, hop_len=128, n_fft=256, n_mels=16, n_frames=8)
FLOOR, MEAN_FLOOR = 0.995, 0.999


@pytest.fixture(scope="module")
def pipes():
    shapes = jax.eval_shape(lambda: j_build_model(JConfig(**PIPE)).init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 16, 8)), False))
    spec = (10.0 * np.random.RandomState(13).randn(32, 16, 8)).astype(np.float32)
    params, stats = calibrated_jax_variables(build_model(Config(**PIPE), device="cpu"),
                                             shapes, to_torch(spec))
    jcfg, cfg = JConfig(**PIPE, serve_quant="int8"), Config(**PIPE, serve_quant="int8")
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, stats, model))
    rs = np.random.RandomState(5)
    waves = [rs.randn(int(rs.uniform(3000, 9500))).astype(np.float32) for _ in range(7)]
    return (FingerprintPipeline(model, cfg, device="cpu"),
            JPipeline(j_build_model(jcfg), jcfg, params, stats), waves)


def _cos(a, b):
    a, b = np.concatenate(a), np.concatenate(b)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def test_packed_int8_rows_equal_the_jax_package(pipes):
    pipe, jpipe, waves = pipes
    got = pipe.fingerprint_tracks(waves, pack=3)
    want = jpipe.fingerprint_tracks(waves, pack=3)
    assert [len(z) for z in got] == [len(z) for z in want]
    least, _ = hold_rows("int8 pack 3: port vs JAX", np.concatenate(got),
                         np.concatenate(want), FLOOR, MEAN_FLOOR)
    print(f"int8 pack 3, port vs JAX: min cos {least:.5f}, mean "
          f"{_cos(got, want).mean():.5f}")


def test_int8_rows_depend_on_the_packing(pipes):
    pipe, _, waves = pipes
    one = pipe.fingerprint_tracks(waves, pack=1)
    assert all(np.array_equal(z, pipe.fingerprint_track(w)) for z, w in zip(one, waves))
    for pack in (3, 8):
        cos = _cos(pipe.fingerprint_tracks(waves, pack=pack), one)
        print(f"int8 pack {pack} vs pack 1: min cos {cos.min():.5f}, mean {cos.mean():.5f}")
        assert cos.min() < FLOOR


@pytest.mark.parametrize("pack,tracks", [(1, 2), (3, 7)])
def test_int8_builds_call_the_model_with_full_batches_only(pipes, pack, tracks):
    """A spy on the served model: under dynamic int8 too, every model call
    is one full batch_size batch, the JAX package's static shape."""
    pipe, _, waves = pipes
    waves = waves[:tracks]
    seen = []
    spy = pipe.model.register_forward_pre_hook(
        lambda m, args: seen.append(tuple(args[0].shape)))
    try:
        pipe.fingerprint_tracks(waves, pack=pack)
    finally:
        spy.remove()
    assert set(seen) == {(pipe.batch_size, PIPE["n_mels"], PIPE["n_frames"])}
