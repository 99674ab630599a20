"""The port's baseline encoders (grafp_tpu_torch/models/ast.py, nafp.py),
their train step, SpecAugment (dsp/specaug.py) and AudioTransform
(dsp/pipeline.py) against the JAX package, on the CPU, at full width:
the AST under config/ast.yaml ((64, 100) log-mel, B = 4), NAFP under
``Config(arch='nafp', n_mels=256)`` ((256, 32) log-mel, B = 2). The same
numpy weights go to both packages through ``convert.state_dict_from_jax``,
the same log-mel segments of 1-s clips (tests/fixtures.py's melodies) to
both models.

The weights: the port's initial ones with ``calibrate_baseline``
(tests/torch_port_util.py): LayerNorm affines drawn at random, and the
AST's cls token and positions non-zero, so that unrelated clips give
rows that a floor can tell apart (the tests print the largest cosine
between two different rows).

Tolerances, with their reasons:
* f32 models: z within 1e-5 of JAX's, cos >= 0.99999 per row, each row
  nearest its own JAX row above that floor (measured: max |dz| <= 2.5e-7).
* bf16 models: rows, not bits: each row nearest its own JAX row above cos
  0.999 (measured: AST 0.99997, NAFP 0.99991). The products sum in
  another order than XLA's, so a value near a bf16 rounding boundary
  rounds the other way, and that spreads through the layers. NAFP's
  full-shape LayerNorm alone is held to bits against the jitted flax
  layer in bf16; the AST's attention core within one bf16 ulp.
* One f32 train step (bsz_train 8, one stacked 2B forward, NT-Xent):
  the loss within rel 1e-5, the grad norm within rel 1e-3 and every
  gradient tensor at cos >= 0.99999 against JAX's (chip_smoke.py's
  LOSS_RTOL and GNORM_RTOL for the grafp step); the JAX side is
  ``grafp_tpu/train/step.py``'s loss without the augment, compiled once
  per arch in a module-scoped fixture.
* SpecAugment: the JAX function's output exactly, given the same
  uniforms; AudioTransform's train and eval outputs (no corruption)
  within 1e-4 dB of JAX's (the log-mel's f32 summation order).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grafp_tpu.core.config import Config as JConfig  # noqa: E402
from grafp_tpu.core.config import load_config as j_load_config  # noqa: E402
from grafp_tpu.dsp.melspec import LogMelConfig as JLogMelConfig  # noqa: E402
from grafp_tpu.dsp.melspec import log_mel_spectrogram as j_log_mel  # noqa: E402
from grafp_tpu.dsp.pipeline import AudioTransform as JAudioTransform  # noqa: E402
from grafp_tpu.dsp.specaug import spec_augment as j_spec_augment  # noqa: E402
from grafp_tpu.models import build_model as j_build_model  # noqa: E402
from grafp_tpu.models.nafp import FullShapeLayerNorm as JFullShapeLayerNorm  # noqa: E402
from grafp_tpu.train.loss import ntxent_loss as j_ntxent  # noqa: E402
from grafp_tpu.train.step import optax_global_norm  # noqa: E402
from grafp_tpu.utils import helpers as jh  # noqa: E402
from grafp_tpu_torch.convert import state_dict_from_jax  # noqa: E402
from grafp_tpu_torch.core import Config, load_config  # noqa: E402
from grafp_tpu_torch.dsp.augment import AugmentBanks  # noqa: E402
from grafp_tpu_torch.dsp.melspec import LogMelConfig, log_mel_spectrogram  # noqa: E402
from grafp_tpu_torch.dsp.pipeline import AudioTransform  # noqa: E402
from grafp_tpu_torch.dsp.specaug import mask_axis, spec_augment  # noqa: E402
from grafp_tpu_torch.models import build_model  # noqa: E402
from grafp_tpu_torch.models.ast import dot_product_attention_reference  # noqa: E402
from grafp_tpu_torch.models.nafp import FullShapeLayerNorm  # noqa: E402
from grafp_tpu_torch.train import create_train_state, make_train_step  # noqa: E402
from grafp_tpu_torch.utils import helpers as th  # noqa: E402
from tests.fixtures import _melody  # noqa: E402
from tests.torch_port_util import (  # noqa: E402
    bf16_ulp,
    calibrate_baseline,
    hold_rows,
    jax_variables_from_port,
    one_torch_thread,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

AST_YAML = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "config", "ast.yaml")
BATCH = {"ast": 4, "nafp": 2}
STEP_BATCH = 8
F32_COS, BF16_COS = 0.99999, 0.999
LOSS_RTOL, GNORM_RTOL, GRAD_COS = 1e-5, 1e-3, 0.99999


def _configs(arch, dtype="float32"):
    """(port Config, JAX Config) of ``arch`` in ``dtype``: config/ast.yaml
    for the AST; Config() with n_mels 256 for NAFP (the repo has no NAFP
    config)."""
    if arch == "ast":
        cfg, jcfg = load_config(AST_YAML), j_load_config(AST_YAML)
    else:
        cfg, jcfg = Config(arch="nafp", n_mels=256), JConfig(arch="nafp", n_mels=256)
    for c in (cfg, jcfg):
        c["compute_dtype"] = dtype
        c["bsz_train"] = STEP_BATCH
    return cfg, jcfg


def _waves(n, seed):
    """(n, 16000) 1-s melodies, each of its own."""
    rs = np.random.RandomState(seed)
    t = np.arange(16000) / 16000
    return np.stack([_melody(rs, t, 16000) for _ in range(n)]).astype(np.float32)


def _spec(cfg, n, seed):
    return log_mel_spectrogram(torch.tensor(_waves(n, seed)),
                               LogMelConfig.from_config(cfg)).numpy()


@pytest.fixture(scope="module")
def weights():
    """Per arch: the JAX (params, batch_stats) holding the port's
    calibrated initial weights."""
    out = {}
    for arch in ("ast", "nafp"):
        cfg, jcfg = _configs(arch)
        model = build_model(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
        calibrate_baseline(model, seed=2)
        jm = j_build_model(jcfg)
        shapes = jax.eval_shape(lambda: jm.init(
            {"params": jax.random.key(0)}, jnp.zeros((1, cfg.n_mels, cfg.n_frames)), False))
        out[arch] = jax_variables_from_port(model, shapes)
    return out


def _port(arch, dtype, weights, train=False):
    cfg, _ = _configs(arch, dtype)
    model = build_model(cfg, device="cpu", train=train)
    model.load_state_dict(state_dict_from_jax(*weights[arch], model))
    return model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["ast", "nafp"])
def test_encoder_matches_jax(weights, arch, dtype):
    cfg, jcfg = _configs(arch, dtype)
    spec = _spec(cfg, BATCH[arch], seed=10)
    params, stats = weights[arch]
    jh_, jz = jax.jit(lambda v, x: j_build_model(jcfg).apply(v, x, False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(spec))
    want = np.asarray(jz.astype(jnp.float32))
    with torch.no_grad():
        h, z = _port(arch, dtype, weights)(torch.tensor(spec))
    assert h.shape == (BATCH[arch], 1024) and z.shape == (BATCH[arch], 128)
    got = z.float().numpy()
    print(f"{arch} {dtype}: max |dz| {np.abs(got - want).max():.3g}")
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        assert ((got * want).sum(-1) >= F32_COS).all()
        hold_rows(f"{arch} f32 vs JAX", got, want, F32_COS)
    else:
        hold_rows(f"{arch} bf16 vs JAX bf16", got, want, BF16_COS)


def test_nafp_layernorm_rounds_as_the_jitted_jax_layer():
    """bf16 in, f32 out: bit-equal to the jitted flax FullShapeLayerNorm;
    f32 within 1e-5."""
    rs = np.random.RandomState(3)
    x = (2 * rs.randn(3, 16, 8, 64) + 0.3).astype(np.float32)       # (B, H, W, C)
    scale = (1 + 0.1 * rs.randn(16, 8, 64)).astype(np.float32)
    bias = (0.1 * rs.randn(16, 8, 64)).astype(np.float32)
    ln = FullShapeLayerNorm((64, 16, 8))
    with torch.no_grad():
        ln.weight.copy_(torch.tensor(scale.transpose(2, 0, 1)))
        ln.bias.copy_(torch.tensor(bias.transpose(2, 0, 1)))
    apply = jax.jit(lambda v, a: JFullShapeLayerNorm().apply(v, a))
    for dtype, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        xj = jnp.asarray(x).astype(jdt)
        want = np.asarray(apply({"params": {"scale": scale, "bias": bias}}, xj))
        with torch.no_grad():
            xt = torch.tensor(np.asarray(xj.astype(jnp.float32))).to(dtype)
            got = ln(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        if dtype == torch.bfloat16:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_matches_jax(dtype):
    """The CPU attention against jax.nn.dot_product_attention at the AST's
    shape (10 heads of 64 over 11 tokens): f32 within 1e-5 (the exp and
    the sums of another library), bf16 within one bf16 ulp."""
    rs = np.random.RandomState(4)
    # (B, T, heads, hd); the keys scaled so that the softmax is peaked
    q, k, v = (rs.randn(4, 11, 10, 64).astype(np.float32) * s for s in (1, 3, 1))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(jax.jit(jax.nn.dot_product_attention)(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v))).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = dot_product_attention_reference(
        *(torch.tensor(np.asarray(jnp.asarray(a).astype(jdt).astype(jnp.float32)))
          .to(tdt).transpose(1, 2) for a in (q, k, v)))
    got = got.transpose(1, 2).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        assert (np.abs(got - want) <= bf16_ulp(want)).all()


def test_ast_refuses_a_wrong_geometry():
    model = build_model(load_config(AST_YAML), device="cpu")
    with pytest.raises(ValueError, match="doesn't match model"):
        model(torch.zeros(1, 64, 32))


@pytest.mark.parametrize("arch", ["ast", "nafp"])
def test_parameter_count_equals_jax(weights, arch, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    want = jh.count_parameters(weights[arch][0], write_summary=False)
    got = th.count_parameters(_port(arch, "float32", weights), arch)
    assert got == want
    assert open(f"model_summary_{arch}.txt").read().endswith(
        f"Total Trainable Params: {got}")


@pytest.mark.parametrize("arch", ["ast", "nafp"])
def test_build_model_takes_the_baselines_without_the_kernel_check(arch, monkeypatch):
    """build_model builds the baselines for the card and the CPU alike: no
    check of the grafp encoder's kernel shapes runs (none is left since the
    selection takes every k and N), the grafp encoder builds under the same
    Config (config/ast.yaml counts 32 x 100 nodes, k N = 9600), and the
    baseline has no peak embed. Without a card the model fails to move
    there."""
    import grafp_tpu_torch.models.simclr as simclr

    cfg, _ = _configs(arch, "bfloat16")
    assert not hasattr(simclr, "_check_kernel_shapes")
    with monkeypatch.context() as m:
        m.setattr(simclr, "resolve_device", lambda d: torch.device("cuda"))
        for name in (arch, "grafp"):
            cfg["arch"] = name
            try:
                model = simclr.build_model(cfg, device="cuda")
            except (AssertionError, RuntimeError):
                assert not torch.cuda.is_available()      # no card to move onto
            else:
                assert (model.peak is None) == (name != "grafp")
    cfg["arch"] = arch
    model = simclr.build_model(cfg, device="cpu")
    assert model.peak is None and not any(k.startswith("peak.") for k in model.state_dict())


@pytest.fixture(scope="module")
def steps(weights):
    """Per arch: one f32 train step of the port and the JAX step's loss,
    grad norm and gradients on the same batch and weights."""
    out = {}
    for arch in ("ast", "nafp"):
        cfg, jcfg = _configs(arch)
        x_i = _waves(STEP_BATCH, seed=20)
        x_j = (x_i + 0.05 * np.random.RandomState(21).randn(*x_i.shape)).astype(np.float32)
        params, stats = weights[arch]
        jm = j_build_model(jcfg)
        mcfg = JLogMelConfig.from_config(jcfg)

        @jax.jit
        def j_step(p, xi, xj):
            # grafp_tpu/train/step.py:make_train_step without the augment,
            # returning the gradients as well
            spec = j_log_mel(jnp.concatenate([xi, xj], axis=0), mcfg)

            def loss_fn(pp):
                (_, z), _ = jm.apply({"params": pp, "batch_stats": stats}, spec, True,
                                     mutable=["batch_stats"])
                return j_ntxent(z[:STEP_BATCH], z[STEP_BATCH:], jcfg.tau)

            loss, grads = jax.value_and_grad(loss_fn)(p)
            return loss, optax_global_norm(grads), grads

        loss, gnorm, grads = j_step(params, x_i, x_j)
        model = _port(arch, "float32", weights, train=True)
        state = create_train_state(model, cfg, steps_per_epoch=1)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        m = make_train_step(model, cfg, device="cpu")(state, x_i, x_j,
                                                      torch.Generator().manual_seed(0))
        out[arch] = (model, state, before, m, float(loss), float(gnorm),
                     state_dict_from_jax(jax.tree.map(np.asarray, grads), {}, model))
    return out


@pytest.mark.parametrize("arch", ["ast", "nafp"])
def test_train_step_matches_jax(steps, arch):
    model, state, before, m, loss, gnorm, want = steps[arch]
    got_loss, got_gnorm = float(m["loss"]), float(m["grad_norm"])
    cos_min = 1.0
    for name, p in model.named_parameters():
        g, ref = p.grad.double(), want[name].double()
        cos_min = min(cos_min, float((g * ref).sum() / (g.norm() * ref.norm())))
    print(f"{arch} step: loss {got_loss:.8f} vs {loss:.8f}, grad norm {got_gnorm:.6f} vs "
          f"{gnorm:.6f}, least gradient cos {cos_min:.9f}")
    assert abs(got_loss - loss) <= LOSS_RTOL * abs(loss)
    assert abs(got_gnorm - gnorm) <= GNORM_RTOL * gnorm
    assert cos_min >= GRAD_COS
    assert state.step == 1
    assert all(not torch.equal(before[n], p) for n, p in model.named_parameters())


def test_spec_augment_masks_and_bounds():
    """The properties tests/test_specaug_pipeline.py checks of the JAX
    function."""
    out = spec_augment(torch.ones(4, 64, 32), torch.Generator().manual_seed(0), 8, 16).numpy()
    assert out.shape == (4, 64, 32)
    assert ((out == 0) | (out == 1)).all() and (out == 0).any()
    assert len(set((out == 0).sum(axis=(1, 2)).tolist())) > 1       # iid per example
    for b in range(4):
        assert (out[b] == 0).all(axis=0).sum() <= 8                  # time columns
        assert (out[b] == 0).all(axis=1).sum() <= 16                 # mel rows


def test_spec_augment_equals_jax_given_the_same_draws():
    """The uniforms of the JAX function's keys, fed to the port's
    ``mask_axis`` in its order (time, then frequency), give its output
    exactly."""
    rs = np.random.RandomState(5)
    spec = rs.randn(6, 64, 100).astype(np.float32)
    key = jax.random.key(7)
    want = np.asarray(j_spec_augment(jnp.asarray(spec), key, 50, 32))
    got = torch.tensor(spec)
    for k, param, axis in zip(jax.random.split(key), (50, 32), (2, 1)):
        k1, k2 = jax.random.split(k)
        u = [torch.tensor(np.asarray(jax.random.uniform(kk, (6,)))) for kk in (k1, k2)]
        got = mask_axis(got, u[0], u[1], param, axis)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 0).any()


def test_spec_augment_draws_from_its_generator():
    spec = torch.randn(8, 64, 32, generator=torch.Generator().manual_seed(1))
    a, b, c = (spec_augment(spec, torch.Generator().manual_seed(s)) for s in (3, 3, 4))
    assert torch.equal(a, b) and not torch.equal(a, c)


def _tiny_cfg(cls):
    return cls(fs=1000, win_len=256, hop_len=128, n_fft=256, n_mels=16, n_frames=8,
               overlap=0.5, tr_snr=[0, 20], val_snr=[0, 20], dur=1.0)


def _bank_clips(rs):
    return dict(noise_clips=[rs.randn(n).astype(np.float32) for n in (9000, 7000)],
                ir_clips=[np.r_[1.0, 0.5 * rs.randn(n)].astype(np.float32) for n in (15, 9)],
                noise_len=9000, ir_len=16)


@pytest.mark.parametrize("mode", ["train", "eval", "eval_dummy"])
def test_audio_transform_equals_jax_without_corruption(mode):
    rs = np.random.RandomState(6)
    cfg, jcfg = _tiny_cfg(Config), _tiny_cfg(JConfig)
    train = mode == "train"
    x_i = rs.randn(*((4, 1000) if train else (5000,))).astype(np.float32)
    x_j = None if mode == "eval_dummy" else (x_i + 0.1 * rs.randn(*x_i.shape)).astype(np.float32)
    got = AudioTransform(cfg, train=train, device="cpu")(x_i, x_j)
    want = JAudioTransform(jcfg, train=train)(x_i, x_j)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape == ((4, 16, 8) if train else (9, 16, 8))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)


def test_audio_transform_corrupts_x_j_only():
    """cpu mode corrupts x_j and keeps x_i; eval mode corrupts x_j's
    segments, with IR unless abl; the same seed gives the same draws."""
    rs = np.random.RandomState(7)
    banks = AugmentBanks.from_arrays(**_bank_clips(rs))
    cfg = _tiny_cfg(Config)
    xi, xj = (rs.randn(1000).astype(np.float32) for _ in range(2))
    xi_out, xj_out = AudioTransform(cfg, banks=banks, cpu=True, device="cpu")(xi, xj)
    assert xi_out is xi and xj_out.shape == (1000,)
    assert not np.allclose(xj_out.numpy(), xj)
    track = rs.randn(5000).astype(np.float32)
    outs = {}
    for abl in (False, True):
        for seed in (0, 0, 1):
            X_i, X_j = AudioTransform(cfg, banks=banks, train=False, abl=abl, seed=seed,
                                      device="cpu")(track, track)
            assert X_i.shape == X_j.shape == (9, 16, 8)
            assert not torch.allclose(X_i, X_j)
            outs.setdefault(abl, []).append(X_j)
    for runs in outs.values():
        assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    assert not torch.equal(outs[False][0], outs[True][0])


def test_audio_transform_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        AudioTransform(_tiny_cfg(Config))
