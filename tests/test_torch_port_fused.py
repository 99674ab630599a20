"""The port's fused Grapher (grafp_tpu_torch/ops/grapher_block.py and
models/gnn.py with fuse_serving='on') against the JAX package: the plain
version of kernel #5 against grapher_block_pallas in interpret mode, the
fused Grapher and a tiny size-t GraphEncoder against JAX's
fuse_serving='on' modules on shared weights with non-trivial BatchNorm
statistics, and the fused port against the unfused port.

Tolerances: the block in f32 rtol/atol 1e-5 (products summed in another
order); in bf16 rows equal up to 3 bf16 ulps of the row's largest output
(a product's f32 sum in another order can round x1 or g to the other
neighbouring bf16 value, and that moves the later products by about an
ulp of their scale). Modules in f32: 1e-4 (fused vs unfused, as
tests/test_fused_grapher.py), the encoder 2e-3 and cos > 0.9999 (as
tests/test_torch_port_model.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grafp_tpu.models.gnn import Grapher as JGrapher  # noqa: E402
from grafp_tpu.models.gnn import GraphEncoder as JGraphEncoder  # noqa: E402
from grafp_tpu.ops.pallas_knn import grapher_block_pallas  # noqa: E402
from grafp_tpu.ops.pallas_knn import (  # noqa: E402
    grapher_block_supported as j_grapher_block_supported,
)
from grafp_tpu_torch.core import Config  # noqa: E402
from grafp_tpu_torch.fp import FingerprintPipeline  # noqa: E402
from grafp_tpu_torch.models import build_model  # noqa: E402
from grafp_tpu_torch.models.gnn import Grapher, GraphEncoder  # noqa: E402
from grafp_tpu_torch.models.layers import init_parameters  # noqa: E402
from grafp_tpu_torch.models.simclr import SimCLRModel  # noqa: E402
from grafp_tpu_torch.ops.grapher_block import (  # noqa: E402
    grapher_block,
    grapher_block_reference,
    grapher_block_supported,
)
from tests.torch_port_util import (  # noqa: E402
    load_jax_weights,
    randomize_jax_variables,
    to_torch,
)

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _block_inputs(n: int, c: int, kind: str, rs: np.random.RandomState):
    """x (2, N, C) and folded weights at the scales a Grapher gives them."""
    x = rs.randn(2, n, c).astype(np.float32)
    if kind == "duplicates":
        x[:, 3:9] = x[:, 2:3]
    w1 = (rs.randn(c, c) / np.sqrt(c)).astype(np.float32)
    wg = (rs.randn(2 * c, 2 * c) / np.sqrt(2 * c)).astype(np.float32)
    w2 = (rs.randn(2 * c, c) / np.sqrt(2 * c)).astype(np.float32)
    c1, cg, c2 = (0.1 * rs.randn(1, c)).astype(np.float32), \
        (0.1 * rs.randn(1, 2 * c)).astype(np.float32), \
        (0.1 * rs.randn(1, c)).astype(np.float32)
    return x, (w1, c1, wg, cg, w2, c2)


def _bf16_row_ok(got: np.ndarray, want: np.ndarray, ulps: int = 3) -> np.ndarray:
    scale = np.abs(want).max(-1, keepdims=True)
    ulp = np.exp2(np.floor(np.log2(np.maximum(scale, 1e-30))) - 7)
    return (np.abs(got - want) <= ulps * ulp).all(-1)


@pytest.mark.parametrize("kind", ["random", "duplicates"])
@pytest.mark.parametrize("n,c", [(16, 8), (64, 16)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_reference_matches_pallas(n, c, kind, dt):
    tdt, jdt = DTYPES[dt]
    x, ws = _block_inputs(n, c, kind, np.random.RandomState(n + c))
    jws = [jnp.asarray(w).astype(jdt if i % 2 == 0 else jnp.float32)
           for i, w in enumerate(ws)]
    want = np.asarray(grapher_block_pallas(jnp.asarray(x).astype(jdt), 3, *jws,
                                           interpret=True).astype(jnp.float32))
    tws = [to_torch(w, tdt if i % 2 == 0 else torch.float32) for i, w in enumerate(ws)]
    got = grapher_block_reference(to_torch(x, tdt), 3, *tws)
    assert got.dtype == tdt
    got = got.float().numpy()
    if dt == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert _bf16_row_ok(got, want).all()


@pytest.mark.parametrize("kind", ["random", "duplicates"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_reference_matches_pallas_at_k9(kind, dt):
    """k = 9 (the card's selection in two round groups) on a stage shape
    the guard admits at k = 9 (N = 128, C = 32), at the tolerances above."""
    n, c, k = 128, 32, 9
    tdt, jdt = DTYPES[dt]
    assert grapher_block_supported(n, c, tdt, k)
    x, ws = _block_inputs(n, c, kind, np.random.RandomState(n + c))
    jws = [jnp.asarray(w).astype(jdt if i % 2 == 0 else jnp.float32)
           for i, w in enumerate(ws)]
    want = np.asarray(grapher_block_pallas(jnp.asarray(x).astype(jdt), k, *jws,
                                           interpret=True).astype(jnp.float32))
    tws = [to_torch(w, tdt if i % 2 == 0 else torch.float32) for i, w in enumerate(ws)]
    got = grapher_block_reference(to_torch(x, tdt), k, *tws).float().numpy()
    if dt == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert _bf16_row_ok(got, want).all()


def test_wrapper_uses_plain_version_on_cpu_and_guards(rng):
    x, ws = _block_inputs(16, 8, "random", rng)
    xt, tws = to_torch(x), [to_torch(w) for w in ws]
    before = grapher_block.launches
    assert torch.equal(grapher_block(xt, 3, *tws), grapher_block_reference(xt, 3, *tws))
    assert grapher_block.launches == before
    # C = 1024 at N = 128 is over the guard's envelope in either dtype
    big = torch.zeros(1, 128, 1024)
    with pytest.raises(ValueError, match="grapher_block_supported"):
        grapher_block(big, 3, *tws)


def test_guard_equals_jax():
    for n in (8, 16, 64, 100, 128, 256, 512, 1024, 2048):
        for c in (8, 64, 80, 160, 400, 512, 640, 768, 1024):
            for dt in ("f32", "bf16"):
                for k in (3, 9, 16):
                    tdt, jdt = DTYPES[dt]
                    assert grapher_block_supported(n, c, tdt, k) == \
                        j_grapher_block_supported(n, c, jdt, k), (n, c, dt, k)
    assert not grapher_block_supported(128, 1024, torch.bfloat16, 3)
    assert not grapher_block_supported(1024, 64, torch.bfloat16, 16)
    assert not grapher_block_supported(1024, 64, torch.float32, 3)


# --- modules -----------------------------------------------------------------

def _perturb_stats(stats, rs):
    """Random non-trivial running statistics (tests/test_fused_grapher.py's
    pattern), so that the BatchNorm folding carries weight."""
    def walk(tree):
        out = {}
        for key, val in tree.items():
            if hasattr(val, "items"):
                out[key] = walk(val)
            elif key == "mean":
                out[key] = rs.normal(size=val.shape, scale=0.3).astype(np.float32)
            elif key == "var":
                out[key] = rs.uniform(0.5, 2.0, size=val.shape).astype(np.float32)
            else:
                out[key] = np.asarray(val, np.float32)
        return out
    return walk(stats)


def _jax_grapher(n, c, x):
    jm = JGrapher(c, k=3, knn_strategy="pallas", fuse_serving="on")
    v = jm.init({"params": jax.random.key(0)}, jnp.asarray(x), False)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    return jm, params, _perturb_stats(v["batch_stats"], np.random.RandomState(1))


@pytest.mark.parametrize("n,c", [(16, 8), (64, 16)])
def test_fused_grapher_matches_jax(n, c, rng):
    x = rng.randn(2, n, c).astype(np.float32)
    jm, params, stats = _jax_grapher(n, c, x)
    want = np.asarray(jm.apply({"params": params, "batch_stats": stats},
                               jnp.asarray(x), False))
    port = load_jax_weights(Grapher(c, k=3, fuse_serving="on"), params, stats).eval()
    before = grapher_block.launches
    with torch.no_grad():
        got = port(to_torch(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert grapher_block.launches == before           # the CPU runs the plain version


@pytest.mark.parametrize("n,c", [(16, 8), (64, 16)])
def test_fused_matches_unfused_port(n, c, rng):
    x = to_torch(rng.randn(2, n, c))
    _, params, stats = _jax_grapher(n, c, x.numpy())
    fused = load_jax_weights(Grapher(c, k=3, fuse_serving="on"), params, stats).eval()
    unfused = Grapher(c, k=3)
    unfused.load_state_dict(fused.state_dict())
    unfused.eval()
    with torch.no_grad():
        np.testing.assert_allclose(fused(x).numpy(), unfused(x).numpy(),
                                   rtol=1e-4, atol=1e-4)


def test_fused_grapher_has_no_gradient_in_eval_and_fuses_not_in_train(rng):
    """Eval: differentiating through the fused op raises, as the Pallas
    kernel has no VJP. Train: the block does not fuse, so every parameter
    gets a finite gradient."""
    g = Grapher(8, k=3, fuse_serving="on")
    init_parameters(g, torch.Generator().manual_seed(0))
    x = to_torch(rng.randn(2, 16, 8))
    with pytest.raises(RuntimeError, match="no gradient"):
        g.eval()(x).sum().backward()
    g.zero_grad()
    (g.train()(x) ** 2).sum().backward()
    for name, p in g.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


def test_fuse_serving_auto_and_off_do_not_fuse(rng):
    x = to_torch(rng.randn(2, 16, 8))
    ref = Grapher(8, k=3, fuse_serving="on")
    init_parameters(ref, torch.Generator().manual_seed(0))
    ref.eval()
    for mode in ("auto", "off"):
        g = Grapher(8, k=3, fuse_serving=mode).eval()
        g.load_state_dict(ref.state_dict())
        y = g(x)
        assert y.grad_fn is not None and "GrapherBlock" not in type(y.grad_fn).__name__
    assert "GrapherBlock" in type(ref(x).grad_fn).__name__
    with pytest.raises(ValueError, match="fuse_serving"):
        Grapher(8, fuse_serving="yes")


def test_state_dicts_agree():
    fused = GraphEncoder(size="t", emb_dims=32, fuse_serving="on").state_dict()
    unfused = GraphEncoder(size="t", emb_dims=32).state_dict()
    assert list(fused) == list(unfused)
    assert all(fused[k].shape == unfused[k].shape for k in fused)


def test_tiny_encoder_matches_jax(rng):
    """Size t at N = 64 (stages N = 64/32/16/8): every block fuses on both
    sides; the JAX side runs grapher_block_pallas in interpret mode."""
    x = rng.randn(2, 64, 8).astype(np.float32)
    kw = dict(size="t", k=3, emb_dims=32)
    jm = JGraphEncoder(knn_strategy="pallas", fuse_serving="on", **kw)
    v = jm.init({"params": jax.random.key(0)}, jnp.asarray(x), False)
    params, stats = randomize_jax_variables(v["params"], v["batch_stats"], seed=2)
    want = np.asarray(jm.apply({"params": params, "batch_stats": stats},
                               jnp.asarray(x), False))
    port = load_jax_weights(GraphEncoder(8, fuse_serving="on", **kw), params,
                            stats).eval()
    with torch.no_grad():
        got = port(to_torch(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert (cos > 0.9999).all(), cos


def test_pipeline_serves_the_fused_model():
    """A SimCLRModel over GraphEncoder(fuse_serving='on') with the unfused
    model's state_dict: fingerprint_waves, embed and fingerprint_track give
    the unfused model's fingerprints (f32, cos > 0.9999 per row)."""
    cfg = Config(n_mels=16, n_frames=16)
    unfused = build_model(cfg, device="cpu")
    enc = GraphEncoder(in_features=cfg["n_filters"], size=cfg["size"], k=int(cfg["k"]),
                       emb_dims=cfg["h"], fuse_serving="on")
    fused = SimCLRModel(enc, n_filters=cfg["n_filters"], blur_kernel=tuple(cfg["blur_kernel"]),
                        peak_stride=cfg["peak_stride"], h=cfg["h"], d=cfg["d"], u=cfg["u"])
    fused.load_state_dict(unfused.state_dict())
    pf = FingerprintPipeline(fused, cfg, batch_size=4, device="cpu")
    pu = FingerprintPipeline(unfused, cfg, batch_size=4, device="cpu")
    rs = np.random.RandomState(3)
    waves = rs.randn(3, cfg.clip_frames).astype(np.float32)
    wave = rs.randn(2 * cfg.fs).astype(np.float32)
    for a, b in ((pf.fingerprint_waves(waves), pu.fingerprint_waves(waves)),
                 (pf.fingerprint_track(wave), pu.fingerprint_track(wave))):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and np.isfinite(a).all()
        assert ((a * b).sum(-1) > 0.9999).all()
    spec = pf.segments_for(wave)[:2]
    assert torch.allclose(pf.embed(spec), pu.embed(spec), atol=1e-4)
