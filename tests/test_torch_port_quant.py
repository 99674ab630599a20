"""int8 serving in the port (grafp_tpu_torch/models/layers.py quant,
models/simclr.py serve_quant and calibrate_act_scales, the pipeline's lazy
calibration) against the JAX package's (grafp_tpu/models/layers.py:73-337,
models/simclr.py:78-167, fp/builder.py:157-175) on the CPU, on the same
numpy inputs and the same weights (carried across by
``convert.state_dict_from_jax``).

Tolerances:
- one layer (a pointwise conv, the block-diagonal grouped conv, the
  concat-interleaved MRConv conv) in f32, dynamic and static: within 1e-6
  relative of the output's largest value, as the int32 accumulation is
  exact and the dequantisation is the same f32 arithmetic;
- calibrated activation maxima: within 1e-6 relative for one layer (the
  same input on both sides); for a whole model within 1e-5 relative, since
  each layer's input already differs from JAX's by the f32 roundings of
  the layers before it (the exact models' own deviation): measured up to
  1.4e-6 relative at the 62nd layer, on JAX's kernel path in interpret
  mode, which sums the grouped conv in the port's order. In bf16 a layer's
  max can move by far more (a different near-tied neighbour feeds an
  outlier node: 0.138 relative measured), so bf16 maxima are compared
  through what they serve, the static fingerprints;
- folded int8 against unfolded int8: each row nearest its own above
  0.999, as the port against JAX, for the same cause (the fold rounds each
  weight once: measured 29 of 14.9M weight codes one int8 step apart, at
  half-way points; rows min cos 0.99943 over 32 rows); and folded int8
  no further from the exact model than unfolded int8 (mean cos within
  1e-3);
- whole models: each fingerprint row nearest its own JAX row
  (``hold_rows``) above a cosine floor of 0.999 (f32) or 0.99 (bf16). Both
  packages quantise the same activations, but a value within f32 rounding
  of a rounding boundary may land one int8 step apart, and each Grapher's
  k-NN selection carries such steps on. The dynamic scale is one max over
  the whole batch, so a fingerprint depends on its batch: both sides get
  equal batches.
- the lazy pipelines of a track (each package's own maxima and own
  BatchNorm fold): each row nearest its own JAX row above TRACK_FLOOR,
  derived beside it from measured spreads; the exact links around it
  (lazy maxima = an explicit calibration of the first batch; the
  pipeline's rows = those of a pipeline given it) are held bit for bit,
  and the unfolded models on the track's segments, under the same
  maxima, above 0.999 (``_hold_lazy_track``).
The weights are calibrated as chip_smoke.py's are, so that unrelated
inputs give distinct fingerprints."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grafp_tpu.core.config import Config as JConfig  # noqa: E402
from grafp_tpu.fp.builder import FingerprintPipeline as JPipeline  # noqa: E402
from grafp_tpu.models import build_model as j_build_model  # noqa: E402
from grafp_tpu.models import layers as jl  # noqa: E402
from grafp_tpu.models.simclr import calibrate_act_scales as j_calibrate  # noqa: E402
from grafp_tpu_torch.convert import state_dict_from_jax  # noqa: E402
from grafp_tpu_torch.core import Config  # noqa: E402
from grafp_tpu_torch.fp import FingerprintPipeline  # noqa: E402
from grafp_tpu_torch.models import build_model, calibrate_act_scales  # noqa: E402
from grafp_tpu_torch.models import layers as tl  # noqa: E402
from grafp_tpu_torch.models.fold_bn import fold_batch_norms  # noqa: E402
from grafp_tpu_torch.retrieval.memmap_io import MemmapWriter  # noqa: E402
from tests.torch_port_util import (  # noqa: E402
    calibrated_jax_variables,
    hold_rows,
    one_torch_thread,
    to_torch,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LAYER_RTOL = 1e-6
SCALE_RTOL = 1e-6
MODEL_SCALE_RTOL = 1e-5
Z_FLOOR = {"float32": 0.999, "bfloat16": 0.99}
# the lazy pipelines' rows, port against JAX, each under its own lazy
# maxima and its own BatchNorm fold: maxima 1e-6 relative apart (measured
# 1.02e-6 to 1.32e-6) move this model's int8_static rows to min cos
# 0.9979 (the port's own rows, every maximum times 1 +- 1e-6, four sign
# draws on three inputs: 0.9979-0.9993), and the JAX package's folded
# rows lie at min cos 0.99863 from its own unfolded ones (same maxima,
# the track's segments); 1 - (1 - 0.9979) - (1 - 0.99863) = 0.99653
TRACK_FLOOR = 0.9965
TINY = dict(n_mels=16, n_frames=16)                  # N = 128 nodes, size t
# the pipeline's geometry in the JAX package's own lazy-calibration test
PIPE = dict(fs=1000, win_len=256, hop_len=128, n_fft=256, n_mels=16, n_frames=8)
SERVE = {"int8": "dynamic", "int8_static": "static"}


def _x(seed, shape=(4, 32, 64)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax_layer(kind, mode):
    if kind == "pointwise":
        return jl.PointwiseConv(48, quant=mode)
    return jl.GroupedPointwiseConv(48, quant=mode,
                                   concat_interleaved=kind == "grouped_concat")


def _port_layer(kind, mode, params):
    if kind == "pointwise":
        layer = tl.PointwiseConv(64, 48, quant=mode)
        w, b = params["Dense_0"]["kernel"].T, params["Dense_0"]["bias"]
    else:
        layer = tl.GroupedPointwiseConv(64, 48, quant=mode,
                                        concat_interleaved=kind == "grouped_concat")
        w, b = params["kernel"], params["bias"]
    with torch.no_grad():
        layer.weight.copy_(torch.tensor(np.asarray(w)))
        layer.bias.copy_(torch.tensor(np.asarray(b)))
    return layer


def _layer_params(kind, x):
    params = jax.tree.map(np.asarray, _jax_layer(kind, False).init(
        jax.random.key(1), jnp.asarray(x))["params"])
    if kind != "pointwise":           # the grouped bias starts at zero
        params["bias"] = 0.1 * np.random.RandomState(2).randn(48).astype(np.float32)
    return params


@pytest.mark.parametrize("mode", ["dynamic", "static"])
@pytest.mark.parametrize("kind", ["pointwise", "grouped_blockdiag", "grouped_concat"])
def test_int8_layer_matches_jax(kind, mode):
    """One layer in f32: the port's int8 product against JAX's on the same
    weights and input; the static scale is 0.8 of the input's max, so some
    activations saturate."""
    x = _x(0)
    params = _layer_params(kind, x)
    variables = {"params": params}
    amax = np.float32(0.8 * np.abs(x).max())
    if mode == "static":
        variables["act_scales"] = ({"Dense_0": {"amax": amax}} if kind == "pointwise"
                                   else {"amax": amax})
    want = np.asarray(_jax_layer(kind, mode).apply(variables, jnp.asarray(x)))
    port = _port_layer(kind, mode, params)
    if mode == "static":
        port.amax.fill_(float(amax))
    with torch.no_grad():
        got = port(torch.tensor(x)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=LAYER_RTOL * scale)
    # and the int8 product tracks the exact one
    with torch.no_grad():
        exact = _port_layer(kind, None, params)(torch.tensor(x)).numpy()
    cos = (got * exact).sum() / (np.linalg.norm(got) * np.linalg.norm(exact))
    assert cos > 0.99, cos


@pytest.mark.parametrize("kind", ["pointwise", "grouped_blockdiag", "grouped_concat"])
def test_calibrate_layer_records_the_running_max(kind):
    """'calibrate': the exact product, and amax raised to the running max
    |x| over two calls, as JAX's mutable 'act_scales' collection."""
    x1, x2 = _x(3), 2.0 * _x(4)
    params = _layer_params(kind, x1)
    layer = _jax_layer(kind, "calibrate")
    scales = None
    for x in (x1, x2):
        v = {"params": params, **({"act_scales": scales} if scales else {})}
        want, upd = layer.apply(v, jnp.asarray(x), mutable=["act_scales"])
        scales = upd["act_scales"]
    port = _port_layer(kind, "calibrate", params)
    with torch.no_grad():
        port(torch.tensor(x1))
        got = port(torch.tensor(x2)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    jmax = float(jax.tree.leaves(scales)[0])
    assert abs(float(port.amax) - jmax) <= SCALE_RTOL * jmax
    assert float(port.amax) == float(np.abs(x2).max())


def test_int8_product_rounds_like_jax():
    """Round half to even and clip at +-127, scales per output column:
    ``int8_matmul`` of a hand-made input equals the numpy product of the
    same quantised values."""
    x = np.array([[0.5, 1.5, 2.5, -0.5, -1.5, 300.0, -300.0, 7.0]] * 17, np.float32)
    w = np.random.RandomState(5).randn(8, 8).astype(np.float32)
    qw, sw = tl.quantize_weight(torch.tensor(w).t())
    got = tl.int8_matmul(torch.tensor(x), qw, sw, torch.tensor(1.0)).numpy()
    qx = np.clip(np.round(x), -127, 127)            # numpy rounds half to even
    ref_sw = np.maximum(np.abs(w).max(0), 1e-8) / 127.0
    want = (qx @ np.round(w / ref_sw)) * ref_sw
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(qw.numpy(), np.round(w / ref_sw).T)


@pytest.fixture(scope="module")
def tiny_tree():
    """The JAX model's (params, batch_stats) for the tiny config: the port's
    weights, BatchNorms randomised and calibrated on 64 spectrograms."""
    shapes = jax.eval_shape(lambda: j_build_model(JConfig(**TINY)).init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 16, 16)), False))
    return calibrated_jax_variables(build_model(Config(**TINY), device="cpu"), shapes,
                                    to_torch(_spec((64, 16, 16), 100)))


@pytest.fixture(scope="module")
def full_tree():
    shapes = jax.eval_shape(lambda: j_build_model(JConfig()).init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 64, 32)), False))
    return calibrated_jax_variables(build_model(Config(), device="cpu"), shapes,
                                    to_torch(_spec((16, 64, 32), 101)))


def _spec(shape, seed):
    return (10.0 * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


def _port(cfg, params, stats, scales=None):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, stats, model, scales))
    return model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", ["tiny", "full"])
def test_int8_model_matches_jax(size, dtype, request):
    """int8 and int8_static z of the whole model against the JAX package's
    on one batch of spectrograms (the same batch on both sides), the
    static scales calibrated by each package on another batch and
    compared; each row nearest its own JAX row."""
    params, stats = request.getfixturevalue(f"{size}_tree")
    kw = dict(TINY if size == "tiny" else {}, compute_dtype=dtype)
    shape = (6, 16, 16) if size == "tiny" else (4, 64, 32)
    calib, spec = _spec(shape, 7), _spec(shape, 8)
    j_scales = j_calibrate(JConfig(**kw), params, stats,
                           [jnp.asarray(calib)])
    t_scales = calibrate_act_scales(Config(**kw), _port(Config(**kw), params, stats),
                                    [calib])
    assert len(jax.tree.leaves(j_scales)) == len(t_scales) == 62
    got = _port(Config(**kw, serve_quant="int8_static"), params, stats,
                j_scales).state_dict()
    dev = max(abs(float(val) - float(got[key])) / float(got[key])
              for key, val in t_scales.items())
    print(f"{size} {dtype}: calibrated maxima, port vs JAX, max relative deviation "
          f"{dev:.3g}")
    if dtype == "float32":
        assert dev <= MODEL_SCALE_RTOL
    for serve, mode in SERVE.items():
        jm = j_build_model(JConfig(**kw, serve_quant=serve))
        v = {"params": params, "batch_stats": stats}
        if mode == "static":
            v["act_scales"] = j_scales
        _, want = jm.apply(v, jnp.asarray(spec), False)
        port = _port(Config(**kw, serve_quant=serve), params, stats,
                     j_scales if mode == "static" else None)
        with torch.no_grad():
            _, z = port(to_torch(spec))
        hold_rows(f"{size} {dtype} {serve}: port vs JAX", z.float(),
                  np.asarray(want, np.float32), Z_FLOOR[dtype])


@pytest.mark.parametrize("serve", ["int8", "int8_static"])
def test_folded_int8_serving_matches_unfolded(serve, tiny_tree):
    """The pipeline serves a BatchNorm-folded copy: under int8 the fold
    commutes with the weight scales (models/fold_bn.py), so the folded
    layers' int8 codes are the unfolded ones up to the sign of the scale
    (but at half-way points), the folded int8 model's rows lie nearest the
    unfolded int8 model's, f32, and no further from the exact model's."""
    params, stats = tiny_tree
    cfg = Config(**TINY, serve_quant=serve)
    model = _port(cfg, params, stats)
    spec = _spec((16, 16, 16), 9)
    if serve == "int8_static":
        model.load_state_dict(calibrate_act_scales(cfg, model, [_spec((16, 16, 16), 10)]),
                              strict=False)
    folded = fold_batch_norms(model)
    assert not any(isinstance(m, tl.BatchNorm) for m in folded.encoder.modules())
    moved = total = 0
    for m, mf in zip(model.modules(), folded.modules()):
        if getattr(m, "quant", None) in ("dynamic", "static"):
            q = tl.quantize_weight(m.dense_io().t())[0]
            moved += int((q.abs() != mf.frozen_qw.abs()).sum())
            total += q.numel()
    assert total > 0 and moved <= 1e-5 * total, (moved, total)
    with torch.no_grad():
        _, z = model(to_torch(spec))
        _, zf = folded(to_torch(spec))
        _, zx = _port(Config(**TINY), params, stats)(to_torch(spec))
    hold_rows(f"{serve}: folded vs unfolded", zf, z, Z_FLOOR["float32"])
    near = [(a.double() * zx.double()).sum(-1).mean().item() for a in (z, zf)]
    print(f"{serve}: mean cos to the exact model, unfolded {near[0]:.6f}, folded "
          f"{near[1]:.6f}; weight codes one step apart: {moved} of {total}")
    assert near[1] > near[0] - 1e-3


def test_build_model_serves_every_serve_quant(tiny_tree):
    """The acceptance side of the refusals that went: arch grafp builds and
    serves under int8, int8_static and int8_calibrate with the plain
    state_dict (its keys unchanged; a plain checkpoint loads); a quantised
    Grapher never fuses, whatever fuse_serving says; the projector stays
    full precision."""
    params, stats = tiny_tree
    plain = _port(Config(**TINY), params, stats)
    spec = to_torch(_spec((4, 16, 16), 11))
    for serve in ("int8", "int8_static", "int8_calibrate"):
        model = build_model(Config(**TINY, serve_quant=serve), device="cpu",
                            fuse_serving="on")
        model.load_state_dict(plain.state_dict())
        weights = {k for k in model.state_dict() if not k.endswith(".amax")}
        assert weights == set(plain.state_dict())
        assert all(g.fuse_serving == "off" for g in model.encoder.modules()
                   if hasattr(g, "fuses"))
        assert model.projector.fc1.quant is None and model.encoder.proj.quant
        if serve == "int8_static":
            model.load_state_dict(calibrate_act_scales(Config(**TINY), plain, [spec]),
                                  strict=False)
        with torch.no_grad():
            _, z = model(spec)
        assert z.shape == (4, 128) and bool(torch.isfinite(z).all())


@pytest.mark.parametrize("override", [dict(serve_quant="int4"),
                                      dict(arch="ast", serve_quant="int8"),
                                      dict(arch="nafp", serve_quant="int8_calibrate")])
def test_build_model_refuses_what_int8_does_not_serve(override):
    err = ValueError if override["serve_quant"] == "int4" else NotImplementedError
    with pytest.raises(err, match="serve_quant"):
        build_model(Config(**override), device="cpu")


def test_weight_bridge_carries_act_scales(tiny_tree):
    """JAX's act_scales land on the amax buffers; a leaf that maps to no
    buffer (a dynamic model has none) raises; without act_scales a static
    model loads and keeps its zeros."""
    params, stats = tiny_tree
    cfg = Config(**TINY, serve_quant="int8_static")
    scales = j_calibrate(JConfig(**TINY), params, stats, [jnp.asarray(_spec((2, 16, 16), 12))])
    model = build_model(cfg, device="cpu")
    sd = state_dict_from_jax(params, stats, model, scales)
    want = float(scales["encoder"]["block3_grapher"]["gconv"]["GroupedPointwiseConv_0"]["amax"])
    assert float(sd["encoder.block3_grapher.gconv.conv.amax"]) == want
    assert float(sd["encoder.stem.amax"]) == float(scales["encoder"]["stem"]["Dense_0"]["amax"])
    model.load_state_dict(state_dict_from_jax(params, stats, model))
    assert float(model.encoder.stem.amax) == 0.0
    with pytest.raises(KeyError):
        state_dict_from_jax(params, stats, build_model(Config(**TINY, serve_quant="int8"),
                                                       device="cpu"), scales)


@pytest.fixture(scope="module")
def lazy_track():
    """JAX's test of the same name, on the port: a static pipeline with no
    scales calibrates on the first track's segments (<= batch_size). What
    the checks of ``_hold_lazy_track`` read: the port pipeline's rows and
    lazy maxima, an explicit ``calibrate_act_scales`` over the same batch
    and the rows of a pipeline given it, the JAX pipeline's lazy maxima
    and rows, and the unfolded int8_static model of each package on the
    track's segments under JAX's lazy maxima."""
    jcfg = JConfig(**PIPE, serve_quant="int8_static")
    cfg = Config(**PIPE, serve_quant="int8_static")
    shapes = jax.eval_shape(lambda: j_build_model(JConfig(**PIPE)).init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 16, 8)), False))
    params, stats = calibrated_jax_variables(build_model(Config(**PIPE), device="cpu"),
                                             shapes, to_torch(_spec((32, 16, 8), 13)))
    wave = np.random.RandomState(8).randn(4000).astype(np.float32)
    jpipe = JPipeline(j_build_model(jcfg), jcfg, params, stats)
    jz = jpipe.fingerprint_track(wave)
    model = _port(cfg, params, stats)
    pipe = FingerprintPipeline(model, cfg, device="cpu")
    assert pipe._needs_calibration
    z = pipe.fingerprint_track(wave)
    assert z.shape == jz.shape and np.isfinite(z).all() and not pipe._needs_calibration
    segs = pipe.segments_for(wave)
    first = segs[:pipe.batch_size]
    ref = calibrate_act_scales(Config(**PIPE), model, [first])
    j_scales = jpipe.extra_variables["act_scales"]
    _, jz_unfolded = j_build_model(jcfg).apply(
        {"params": params, "batch_stats": stats, "act_scales": j_scales},
        jnp.asarray(segs), False)
    with torch.no_grad():
        _, z_unfolded = _port(cfg, params, stats, j_scales)(to_torch(segs))
    return dict(
        cfg=cfg, model=model, wave=wave, segs=segs, z=z,
        lazy={k: float(v) for k, v in pipe.model.state_dict().items()
              if k.endswith("amax")},
        ref=ref,
        z_ref=FingerprintPipeline(model, cfg, device="cpu",
                                  act_scales=ref).fingerprint_track(wave),
        jlazy=state_dict_from_jax(params, stats, model, j_scales), jz=jz,
        z_unfolded=z_unfolded.numpy(), jz_unfolded=np.asarray(jz_unfolded, np.float32))


def _hold_lazy_track(t):
    """The lazy calibration's checks (C8 in ROADMAP.md):
    - the lazy maxima equal an explicit ``calibrate_act_scales`` over the
      first batch exactly, and JAX's lazy ones within MODEL_SCALE_RTOL;
    - the pipeline's rows equal, bit for bit and in order, those of a
      pipeline given that explicit calibration;
    - the unfolded int8_static model of each package on the track's
      segments, both under JAX's lazy maxima: each row nearest its own
      JAX row above Z_FLOOR (as ``test_int8_model_matches_jax``; measured
      min cos 0.99956);
    - the pipelines' rows, port against JAX: each nearest its own row
      above TRACK_FLOOR.
    Raises AssertionError."""
    assert len(t["lazy"]) == len(t["ref"]) == 62
    for key, val in t["lazy"].items():
        assert val == float(t["ref"][key]), key
        assert abs(val - float(t["jlazy"][key])) <= MODEL_SCALE_RTOL * val, key
    np.testing.assert_array_equal(t["z"], t["z_ref"])
    hold_rows("int8_static on the track's segments, unfolded, JAX's lazy maxima: "
              "port vs JAX", t["z_unfolded"], t["jz_unfolded"], Z_FLOOR["float32"])
    hold_rows("lazy int8_static track: port vs JAX", t["z"], t["jz"], TRACK_FLOOR)


def test_int8_static_lazy_calibration_in_pipeline(lazy_track, tmp_path):
    """The port's lazy calibration against JAX's (``_hold_lazy_track``);
    a second pipeline fed through embed_stream calibrates too; a pipeline
    given the scales does not; the caller's model keeps its zeros."""
    _hold_lazy_track(lazy_track)
    cfg, model, segs = lazy_track["cfg"], lazy_track["model"], lazy_track["segs"]
    assert float(model.encoder.stem.amax) == 0.0        # the caller's model untouched

    pipe2 = FingerprintPipeline(model, cfg, batch_size=4, device="cpu")
    writer = MemmapWriter(str(tmp_path), "db", pipe2.d, capacity=64)
    assert pipe2.embed_stream([segs[:6]], writer) == 6 and not pipe2._needs_calibration
    writer.close()
    assert not FingerprintPipeline(model, cfg, device="cpu",
                                   act_scales=lazy_track["ref"])._needs_calibration


def _served_with(t, scales):
    """``t`` with the lazy maxima replaced by ``scales`` and the rows by
    what a pipeline given them serves."""
    pipe = FingerprintPipeline(t["model"], t["cfg"], device="cpu", act_scales=scales)
    return dict(t, lazy={k: float(v) for k, v in scales.items()},
                z=pipe.fingerprint_track(t["wave"]))


@pytest.mark.parametrize("fault", ["rows_out_of_order", "one_scale_off_1e-4",
                                   "calibrated_on_another_batch"])
def test_lazy_track_checks_fail_on_a_fault(lazy_track, fault):
    """Each fault the lazy path could have fails ``_hold_lazy_track``: its
    rows served out of order, one maximum 1e-4 relative off (ten times
    MODEL_SCALE_RTOL), or a calibration over segments other than the
    first batch's."""
    t = lazy_track
    if fault == "rows_out_of_order":
        bad = dict(t, z=np.roll(t["z"], 1, axis=0))
    elif fault == "one_scale_off_1e-4":
        key = "encoder.block4_grapher.gconv.conv.amax"
        bad = _served_with(t, {**t["ref"], key: t["ref"][key] * (1 + 1e-4)})
    else:
        bad = _served_with(t, calibrate_act_scales(Config(**PIPE), t["model"],
                                                   [t["segs"][5:]]))
    with pytest.raises(AssertionError):
        _hold_lazy_track(bad)


@pytest.mark.parametrize("name", ["encoder.block0_grapher.fc2.bias", "peak.conv.weight"])
def test_track_floor_fails_a_fault_of_the_served_model(lazy_track, name):
    """TRACK_FLOOR alone fails rows served by a pipeline given the first
    batch's maxima whose model is off by 1e-3 in one place: the folded
    bias of block 0's Grapher fc2 (+1e-3; min cos to JAX measured
    0.99533) or the peak convolution's weights (times 1 + 1e-3; 0.99497),
    against 0.99916 without the fault. (The same fault deeper in the
    encoder moves the rows less: 0.9975-0.9993.)"""
    t = lazy_track
    pipe = FingerprintPipeline(t["model"], t["cfg"], device="cpu", act_scales=t["ref"])
    with torch.no_grad():
        p = dict(pipe.model.named_parameters())[name]
        if name.endswith("bias"):
            p.add_(1e-3)
        else:
            p.mul_(1 + 1e-3)
    z = pipe.fingerprint_track(t["wave"])
    with pytest.raises(AssertionError, match="below cos"):
        hold_rows(f"lazy int8_static track, {name} off by 1e-3: port vs JAX", z, t["jz"],
                  TRACK_FLOOR)
