"""The port's BatchNorm fold (grafp_tpu_torch/models/fold_bn.py) and the
'auto' fused-Grapher switch, on the CPU.

Tolerances: each folded layer (stem, FFN, Downsample, Grapher unfused and
fused) against its unfolded self on the same input, f32, max |d| <= 1e-5
(1 + max |ref|): the fold rounds each weight once and reorders an f32
multiply-add. The whole folded model against the unfolded one: max |dz|
<= 1e-3, cos(z) > 0.99999 and |dh| <= 1e-3 (1 + max |h|), because each
Grapher's k-NN selection amplifies those roundings where two neighbours'
scores are nearly tied (a few nodes move far more than the rounding, and
on some weight draws the fingerprints by more than 1e-4; the mean over
nodes dilutes them). The folded port against the JAX model run on
``fold_batch_norms`` + ``neutral_batch_stats``: tests/test_torch_port_model.py's
rtol/atol 2e-3 on (h, z) and cos(z) > 0.9999. The JAX side runs its
default CPU path."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grafp_tpu.core.config import Config as JConfig  # noqa: E402
from grafp_tpu.models import build_model as j_build_model  # noqa: E402
from grafp_tpu.models.fold_bn import fold_batch_norms as j_fold  # noqa: E402
from grafp_tpu.models.fold_bn import neutral_batch_stats as j_neutral  # noqa: E402
from grafp_tpu_torch.core import Config  # noqa: E402
from grafp_tpu_torch.fp import FingerprintPipeline  # noqa: E402
from grafp_tpu_torch.models import Grapher, build_model  # noqa: E402
from grafp_tpu_torch.models.fold_bn import fold_batch_norms, neutral_batch_stats  # noqa: E402
from grafp_tpu_torch.models.layers import BatchNorm  # noqa: E402
from grafp_tpu_torch.models.simclr import _check_kernel_shapes  # noqa: E402
from tests.torch_port_util import (  # noqa: E402
    jax_variables_from_port,
    load_jax_weights,
    randomize_jax_variables,
    to_torch,
)

KW = dict(n_mels=16, n_frames=16)           # N = 128 nodes, size t


@pytest.fixture(scope="module")
def jax_tree():
    """The JAX model and a random (params, batch_stats) pair: the port's
    initial weights through the bridge (``jax.eval_shape`` of the init
    gives the tree without compiling it), BatchNorms randomised."""
    model = j_build_model(JConfig(**KW))
    shapes = jax.eval_shape(lambda: model.init({"params": jax.random.key(0)},
                                               jnp.zeros((1, 16, 16)), False))
    params, stats = jax_variables_from_port(build_model(Config(**KW), device="cpu"),
                                            shapes)
    params, stats = randomize_jax_variables(params, stats)
    return model, params, stats


def _spec(seed=0, b=3):
    return (10.0 * np.random.RandomState(seed).randn(b, 16, 16)).astype(np.float32)


def _bn_count(model):
    return sum(isinstance(m, BatchNorm) for m in model.modules())


def _close(got, want, tol):
    return float((got - want).abs().max()) <= tol * (1 + float(want.abs().max()))


@pytest.mark.parametrize("fuse", ["off", "on"])
def test_each_folded_layer_matches_unfolded(jax_tree, fuse):
    _, params, stats = jax_tree
    port = load_jax_weights(build_model(Config(**KW), device="cpu", fuse_serving=fuse),
                            params, stats)
    folded = fold_batch_norms(port)
    enc, fenc = port.encoder, folded.encoder
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        x = torch.randn(2, 128, 8, generator=g)
        assert _close(fenc.stem(x), enc.stem_bn(enc.stem(x)), 1e-5)
        # (layer, nodes, channels in) at N = 128 nodes
        for name, n, c in (("block0_grapher", 128, 64), ("block0_ffn", 128, 64),
                           ("down1", 128, 64), ("block2_ffn", 64, 128),
                           ("block4_grapher", 32, 256), ("down3", 32, 256)):
            x = torch.randn(2, n, c, generator=g)
            assert _close(getattr(fenc, name)(x), getattr(enc, name)(x), 1e-5), name


@pytest.mark.parametrize("fuse", ["off", "on"])
def test_folded_port_matches_unfolded(jax_tree, fuse):
    _, params, stats = jax_tree
    port = load_jax_weights(build_model(Config(**KW), device="cpu", fuse_serving=fuse),
                            params, stats)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    folded = fold_batch_norms(port)
    assert _bn_count(port) == 64 and _bn_count(folded) == 0
    for key, val in port.state_dict().items():
        assert torch.equal(val, before[key]), key     # the input model stays
    x = to_torch(_spec())
    with torch.no_grad():
        h, z = port(x)
        hf, zf = folded(x)
        _, zff = fold_batch_norms(folded)(x)          # folding twice is a no-op
    assert float((zf - z).abs().max()) <= 1e-3 and _close(hf, h, 1e-3)
    assert bool(((zf * z).sum(-1) > 0.99999).all())
    assert torch.equal(zff, zf)


def test_folded_port_matches_jax_folded_tree(jax_tree):
    """JAX on its folded params and neutral statistics against the port's
    fold of the same unfolded weights; and the JAX folded tree mapped onto
    the port through neutral_batch_stats and state_dict_from_jax."""
    model, params, stats = jax_tree
    jf, jn = j_fold(params, stats), j_neutral(stats)
    spec = _spec(1)
    want_h, want_z = model.apply({"params": jf, "batch_stats": jn},
                                 jnp.asarray(spec), False)
    want_h, want_z = np.asarray(want_h), np.asarray(want_z)
    port = fold_batch_norms(load_jax_weights(build_model(Config(**KW), device="cpu"),
                                             params, stats))
    mapped = load_jax_weights(build_model(Config(**KW), device="cpu"), jf,
                              neutral_batch_stats(stats))
    for ws in (jn, neutral_batch_stats(stats)):
        assert set(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
            lambda a: float(np.asarray(a).max()), ws))) <= {0.0, float(np.float32(1 - 1e-5))}
    with torch.no_grad():
        for m in (port, mapped, fold_batch_norms(mapped)):
            h, z = m(to_torch(spec))
            np.testing.assert_allclose(h.numpy(), want_h, rtol=2e-3, atol=2e-3)
            np.testing.assert_allclose(z.numpy(), want_z, rtol=2e-3, atol=2e-3)
            assert ((z.numpy() * want_z).sum(-1) > 0.9999).all()


def test_pipeline_serves_the_folded_model(jax_tree):
    _, params, stats = jax_tree
    port = load_jax_weights(build_model(Config(**KW), device="cpu"), params, stats)
    pipe = FingerprintPipeline(port, Config(**KW), device="cpu")
    assert _bn_count(pipe.model) == 0 and _bn_count(port) == 64
    with torch.no_grad():
        _, z = port(to_torch(_spec(2)))
    assert (pipe.embed(_spec(2)) - z).abs().max() <= 1e-3


def test_auto_keeps_the_unfused_path_on_the_cpu(monkeypatch):
    """'auto' resolves on the tensor's device: off on the CPU ('on' fuses
    everywhere, 'off' nowhere)."""
    x = torch.zeros(1, 8, 16)
    assert not Grapher(16, fuse_serving="auto").fuses(x)
    assert Grapher(16, fuse_serving="on").fuses(x)
    assert not Grapher(16, fuse_serving="off").fuses(x)
    import grafp_tpu_torch.models.gnn as gnn

    calls = []
    monkeypatch.setattr(gnn.GrapherBlock, "apply",
                        lambda *a: calls.append(a) or a[0])
    model = build_model(Config(**KW), device="cpu")
    with torch.no_grad():
        model(to_torch(_spec()))
    assert calls == []


def test_build_model_on_the_cpu_takes_k_above_the_kernel_limit():
    """C1: k = 9 builds and runs on the CPU (plain versions, no limit)."""
    cfg = Config(k=9, **KW)
    model = build_model(cfg, device="cpu")
    with torch.no_grad():
        _, z = model(to_torch(_spec(b=2)))
    assert z.shape == (2, 128) and bool(torch.isfinite(z).all())


@pytest.mark.parametrize("over", [dict(k=9), dict(n_frames=300)],
                         ids=["k", "kn"])
def test_kernel_shape_check_names_the_limit(over):
    """What build_model refuses on a CUDA device: k > 8, and k * N > 8192
    (k = 3 with 32 x 300 = 9600 nodes)."""
    with pytest.raises(NotImplementedError, match="k <= 8 and k \\* N <= 8192"):
        _check_kernel_shapes(Config(**over))
    _check_kernel_shapes(Config())
