"""The port's train slice against the JAX package on shared numpy weights
and inputs: the pieces (training-mode BatchNorm, dense_matmul_bf16grad,
the bf16 grouped MRConv conv, NT-Xent, the cosine schedule) and one whole
f32 train step on the tiny geometry of tests/test_train_step.py, whose
JAX side runs the Pallas kernel in interpret mode (knn_strategy='pallas')
in one module-scoped compile.

Tolerances, with their reasons:
* BatchNorm, NT-Xent, schedule: f32 summation order (atol/rtol <= 1e-5);
  bf16 outputs within one bf16 ulp.
* Train step: the loss within rtol 5e-5, the grad norm within rtol 5e-3;
  every gradient tensor within 2% of its L2 norm plus 1e-5 of the grad
  norm, and cos > 0.9999 where the tensor's max is over 1e-4 of the grad
  norm (measured: cos >= 0.999996, L2 error <= 0.3 %). The step's gradients
  are ill-conditioned in f32: the BatchNorm fast variance E[x^2] - E[x]^2
  cancels, so the port alone moves its gradients by ~3e-3 relative when
  only the order of the BatchNorm sums changes. Some gradients are zero by construction (a bias that a
  train-mode BatchNorm follows, and the fc1 BatchNorm bias of a Grapher,
  since rel(x + b) - (x + b) = rel(x) - x): there both sides give noise
  below 1e-8 of the grad norm.
* After one Adam step a parameter matches JAX's within 0.01 lr (plus f32
  rounding) wherever the two gradients agree in sign and lie over 1e3
  Adam eps (99.86 % of the elements); where they do not
  (a near-zero gradient, whose sign is noise) it may differ by 2 lr, since
  Adam's first update is ~lr * sign(g). The Adam moments match optax's.
  The three-step trajectory uses a small lr (2e-7): with a larger one those
  differences move node features across near ties of the k-NN selection,
  and the losses part at the third step.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grafp_tpu.core.config import Config as JConfig  # noqa: E402
from grafp_tpu.dsp.melspec import LogMelConfig as JLogMelConfig  # noqa: E402
from grafp_tpu.dsp.melspec import log_mel_spectrogram as j_log_mel  # noqa: E402
from grafp_tpu.models import build_model as j_build_model  # noqa: E402
from grafp_tpu.models import gnn as jgnn  # noqa: E402
from grafp_tpu.models import layers as jlayers  # noqa: E402
from grafp_tpu.train.loss import ntxent_loss as j_ntxent  # noqa: E402
from grafp_tpu.train.state import TrainState as JTrainState  # noqa: E402
from grafp_tpu.train.state import cosine_epoch_schedule as j_schedule  # noqa: E402
from grafp_tpu.train.state import make_optimizer as j_make_optimizer  # noqa: E402
from grafp_tpu.train.step import optax_global_norm  # noqa: E402
from grafp_tpu_torch.convert import state_dict_from_jax  # noqa: E402
from grafp_tpu_torch.core import Config  # noqa: E402
from grafp_tpu_torch.models import build_model  # noqa: E402
from grafp_tpu_torch.models.gnn import MRConv  # noqa: E402
from grafp_tpu_torch.models.layers import BatchNorm, dense_matmul_bf16grad  # noqa: E402
from grafp_tpu_torch.train import (  # noqa: E402
    TrainState,
    cosine_epoch_schedule,
    create_train_state,
    make_train_step,
    ntxent_loss,
)
from tests.torch_port_util import (  # noqa: E402
    bf16_ulp,
    jax_variables_from_port,
    randomize_jax_variables,
    to_torch,
)

# tests/test_train_step.py:16-22: 1 s at 1 kHz, 16 mels x 8 frames, N = 64
TINY = dict(fs=1000, win_len=256, hop_len=128, n_fft=256, n_mels=16,
            n_frames=8, bsz_train=8)
# a small lr keeps three steps comparable (see the module docstring); the
# schedule moves every step (steps_per_epoch 1, T_max 2)
OPT = dict(lr=2e-7, min_lr=2e-8, T_max=2)
STEPS = 3
# pairs per step: the Pallas kernel unrolls one copy of its body per item of
# the stacked 2B batch, so the JAX compile grows with B
BATCH = 4
ADAM_EPS = 1e-8


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32))


# --- BatchNorm ------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_matches_flax(rng, dtype):
    """Batch statistics over (B, N), the biased variance into the running
    statistics (0.9 / 0.1), output in the compute dtype; and the gradients
    through the statistics."""
    c = 12
    x = (3.0 + rng.randn(4, 10, c)).astype(np.float32)
    if dtype == "bfloat16":
        x = _bf16(x)
    scale = (1 + 0.1 * rng.randn(c)).astype(np.float32)
    bias = (0.1 * rng.randn(c)).astype(np.float32)
    mean = (0.2 * rng.randn(c)).astype(np.float32)
    var = (0.5 + rng.rand(c)).astype(np.float32)
    cot = rng.randn(*x.shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    jbn = jlayers.BatchNorm(dtype=jdt)
    params = {"BatchNorm_0": {"scale": scale, "bias": bias}}
    stats = {"BatchNorm_0": {"mean": mean, "var": var}}
    xj = jnp.asarray(x).astype(jdt or jnp.float32)

    def f(p, xx):
        y, upd = jbn.apply({"params": p, "batch_stats": stats}, xx, True,
                           mutable=["batch_stats"])
        return y, upd["batch_stats"]["BatchNorm_0"]

    (want, new), vjp = jax.vjp(f, params, xj)
    d_params, d_x = vjp((jnp.asarray(cot).astype(want.dtype),
                         jax.tree.map(jnp.zeros_like, stats["BatchNorm_0"])))

    tdt = torch.bfloat16 if dtype == "bfloat16" else None
    bn = BatchNorm(c, dtype=tdt).train()
    with torch.no_grad():
        for t, a in ((bn.weight, scale), (bn.bias, bias),
                     (bn.running_mean, mean), (bn.running_var, var)):
            t.copy_(torch.tensor(a))
    xt = to_torch(x, tdt or torch.float32).requires_grad_()
    got = bn(xt)
    assert got.dtype == (tdt or torch.float32)
    got.backward(to_torch(cot, got.dtype))
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "bfloat16":
        assert (np.abs(got.detach().float().numpy() - want) <= bf16_ulp(want)).all()
    else:
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), new["mean"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), new["var"], rtol=1e-5, atol=1e-6)
    g = d_params["BatchNorm_0"]
    np.testing.assert_allclose(bn.weight.grad.numpy(), g["scale"], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(bn.bias.grad.numpy(), g["bias"], rtol=1e-4, atol=1e-3)
    dx = np.asarray(d_x.astype(jnp.float32))
    got_dx = xt.grad.float().numpy()
    if dtype == "bfloat16":
        assert (np.abs(got_dx - dx) <= 2 * bf16_ulp(dx) + 1e-3).all()
    else:
        np.testing.assert_allclose(got_dx, dx, rtol=1e-4, atol=1e-5)


# --- the grouped MRConv conv ---------------------------------------------

def test_dense_matmul_bf16grad_matches_jax(rng):
    """bf16 x bf16 with an f32 result; the backward quantises the
    cotangent to bf16 before both products. Forward within f32 summation
    order, dx and dw within one bf16 ulp."""
    x = _bf16(rng.randn(3, 5, 16))
    w = _bf16(rng.randn(16, 8))
    g = rng.randn(3, 5, 8).astype(np.float32)
    bf = jnp.bfloat16
    want, vjp = jax.vjp(jlayers.dense_matmul_bf16grad, jnp.asarray(x, bf),
                        jnp.asarray(w, bf))
    want_dx, want_dw = (np.asarray(a.astype(jnp.float32))
                        for a in vjp(jnp.asarray(g)))
    xt = to_torch(x, torch.bfloat16).requires_grad_()
    wt = to_torch(w, torch.bfloat16).requires_grad_()
    got = dense_matmul_bf16grad(xt, wt)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    got.backward(to_torch(g))
    assert xt.grad.dtype == wt.grad.dtype == torch.bfloat16
    for t, ref in ((xt, want_dx), (wt, want_dw)):
        assert (np.abs(t.grad.float().numpy() - ref) <= bf16_ulp(ref)).all()


@pytest.mark.parametrize("train", [False, True])
def test_mrconv_bf16_keeps_the_f32_accumulator(rng, train):
    """The grouped conv of a bf16 MRConv on the concat layout against the
    JAX MRConv(input_layout='concat', dtype=bf16), shared weights: within
    one bf16 ulp (measured: no output differs). Before the repair the
    port rounded the product to bf16 ahead of the f32 bias and BatchNorm;
    that version is rebuilt here and must deviate more (measured: 261 of
    1536 outputs, max 0.0156)."""
    c2, n = 32, 24
    y = _bf16(rng.randn(2, n, c2))
    w = (0.25 * rng.randn(4, c2 // 4, c2 // 4)).astype(np.float32)
    b = (0.1 * rng.randn(c2)).astype(np.float32)
    bn = {"scale": (1 + 0.1 * rng.randn(c2)).astype(np.float32),
          "bias": (0.1 * rng.randn(c2)).astype(np.float32)}
    stats = {"mean": (0.2 * rng.randn(c2)).astype(np.float32),
             "var": (0.5 + rng.rand(c2)).astype(np.float32)}
    jm = jgnn.MRConv(c2, input_layout="concat", dtype=jnp.bfloat16)
    params = {"GroupedPointwiseConv_0": {"kernel": w, "bias": b},
              "BatchNorm_0": {"BatchNorm_0": bn}}
    out = jm.apply({"params": params,
                    "batch_stats": {"BatchNorm_0": {"BatchNorm_0": stats}}},
                   jnp.asarray(y, jnp.bfloat16), None, train,
                   mutable=["batch_stats"])[0]
    want = np.asarray(out.astype(jnp.float32))

    port = MRConv(c2, c2, dtype=torch.bfloat16)
    sd = {"conv.weight": w, "conv.bias": b, "bn.weight": bn["scale"],
          "bn.bias": bn["bias"], "bn.running_mean": stats["mean"],
          "bn.running_var": stats["var"]}
    port.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    port.train(train)
    yt = to_torch(y, torch.bfloat16)
    with torch.no_grad():
        got = port(yt).float().numpy()
        dense = port.conv.dense_weight()
        rounded = torch.matmul(yt, dense).float() + port.conv.bias
        old = port.act(port.bn(rounded)).float().numpy()
    err, err_old = np.abs(got - want), np.abs(old - want)
    assert (err <= bf16_ulp(want)).all(), err.max()
    assert err.max() < err_old.max() and err.mean() < err_old.mean(), (
        err.max(), err_old.max())


# --- loss and schedule ----------------------------------------------------

def test_ntxent_matches_jax(rng):
    z = rng.randn(12, 16).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    zi, zj = z[:6], z[6:]
    want, grads = jax.value_and_grad(
        lambda a, b: j_ntxent(a, b, 0.05), argnums=(0, 1))(jnp.asarray(zi),
                                                             jnp.asarray(zj))
    ti, tj = to_torch(zi).requires_grad_(), to_torch(zj).requires_grad_()
    got = ntxent_loss(ti, tj, 0.05)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(grads[0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tj.grad.numpy(), np.asarray(grads[1]), rtol=1e-5, atol=1e-6)


def test_cosine_schedule_matches_jax():
    """The port computes in float64, the JAX schedule in f32: rtol 1e-5."""
    args = (8e-5, 7e-7, 400, 5)
    got, want = cosine_epoch_schedule(*args), j_schedule(*args)
    for step in (0, 1, 4, 5, 999, 1000, 1995, 1999, 2000, 2005, 5000):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-5)
    assert got(2000) == got(9999) == pytest.approx(7e-7)


def test_create_train_state_refuses_serve_quant():
    cfg = Config(**TINY)
    model = build_model(cfg, device="cpu", train=True)
    cfg["serve_quant"] = "int8"
    with pytest.raises(ValueError, match="serve_quant"):
        create_train_state(model, cfg)


def test_train_step_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = Config(**TINY)
    model = build_model(cfg, device="cpu", train=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(model, cfg)


# --- one whole train step -------------------------------------------------

@pytest.fixture(scope="module")
def trajectories():
    """STEPS f32 steps of the JAX train step and of the port on one fixed
    batch from shared weights; returns per-step JAX (loss, grad norm,
    grads, params, batch stats) and the port's (loss, grad norm, grads,
    state_dict)."""
    rs = np.random.RandomState(0)
    x_i = rs.randn(BATCH, TINY["fs"]).astype(np.float32)
    x_j = (x_i + 0.3 * rs.randn(BATCH, TINY["fs"])).astype(np.float32)

    cfg = Config(**TINY, **OPT)
    port = build_model(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu", train=True)
    jcfg = JConfig(knn_strategy="pallas", **TINY, **OPT)
    jm = j_build_model(jcfg)
    shapes = jax.eval_shape(
        lambda k: jm.init({"params": k}, jnp.zeros((2, 16, 8)), False),
        jax.random.key(0))
    params, stats = jax_variables_from_port(port, shapes)
    params, stats = randomize_jax_variables(params, stats, seed=1)
    port.load_state_dict(state_dict_from_jax(params, stats, port))

    tx = j_make_optimizer(jcfg, 1)
    params = jax.tree.map(jnp.asarray, params)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         batch_stats=jax.tree.map(jnp.asarray, stats),
                         opt_state=tx.init(params), tx=tx, apply_fn=jm.apply)
    mcfg = JLogMelConfig.from_config(jcfg)

    @jax.jit
    def j_step(state, xi, xj):
        # grafp_tpu/train/step.py:make_train_step without the augment,
        # returning the gradients as well
        spec = j_log_mel(jnp.concatenate([xi, xj], axis=0), mcfg)

        def loss_fn(p):
            (_, z), upd = state.apply_fn(
                {"params": p, "batch_stats": state.batch_stats}, spec, True,
                mutable=["batch_stats"])
            return j_ntxent(z[:BATCH], z[BATCH:], jcfg.tau), upd["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params)
        new = state.apply_gradients(grads, new_stats)
        return new, loss, optax_global_norm(grads), grads

    state = create_train_state(port, cfg, steps_per_epoch=1)
    step = make_train_step(port, cfg, device="cpu")
    jax_out, port_out = [], []
    for _ in range(STEPS):
        jstate, loss, gnorm, grads = j_step(jstate, x_i, x_j)
        adam = jstate.opt_state[0]            # optax.adam: scale_by_adam first
        jax_out.append((float(loss), float(gnorm),
                        jax.tree.map(np.asarray, grads),
                        jax.tree.map(np.asarray, jstate.params),
                        jax.tree.map(np.asarray, jstate.batch_stats),
                        (jax.tree.map(np.asarray, adam.mu),
                         jax.tree.map(np.asarray, adam.nu))))
        m = step(state, x_i, x_j, torch.Generator().manual_seed(0))
        moments = {n: (state.optimizer.state[p]["exp_avg"].clone(),
                       state.optimizer.state[p]["exp_avg_sq"].clone())
                   for n, p in port.named_parameters()}
        port_out.append((float(m["loss"]), float(m["grad_norm"]),
                         {n: p.grad.clone() for n, p in port.named_parameters()},
                         {k: v.clone() for k, v in port.state_dict().items()},
                         moments))
    assert isinstance(state, TrainState) and state.step == STEPS
    return port, jax_out, port_out


def test_train_step_loss_and_grads_match_jax(trajectories):
    port, jax_out, port_out = trajectories
    loss_j, gnorm_j, grads_j, _, stats_j, _ = jax_out[0]
    loss_p, gnorm_p, grads_p, _, _ = port_out[0]
    np.testing.assert_allclose(loss_p, loss_j, rtol=5e-5)
    np.testing.assert_allclose(gnorm_p, gnorm_j, rtol=5e-3)
    want = state_dict_from_jax(grads_j, stats_j, port)
    for name, got in grads_p.items():
        got, ref = got.numpy(), want[name].numpy()
        norm = np.linalg.norm(ref)
        assert np.linalg.norm(got - ref) <= 0.02 * norm + 1e-5 * gnorm_j, name
        if np.abs(ref).max() < 1e-4 * gnorm_j:
            continue
        cos = (got * ref).sum() / (np.linalg.norm(got) * norm)
        assert cos > 0.9999, (name, cos)


def test_train_step_updates_match_jax(trajectories):
    """After one Adam step. Adam's first update is lr * g / (|g| + eps),
    i.e. ~lr * sign(g), so it is held elementwise against JAX's where the
    port's and JAX's gradients agree in sign and are both over 1e3 Adam
    eps (below that the update is a fraction of lr): within 0.01 lr plus
    two f32 spacings of the parameter (the rounding of both updated
    values); at least 95 % of the elements must be held so (measured:
    99.86 %, worst 6e-4 lr). Every element is within 2 lr. Where the signs
    disagree, the gradient is noise: JAX's must be under 1e-4 of the grad
    norm there, and such elements must be under 0.2 % (measured: 0.077 %).
    A skipped or sign-reversed update fails. The Adam moments equal optax's
    mu and nu up to the gradients' own deviation (so beta1 and beta2 are
    held, which the first update itself does not show); the BatchNorm
    running statistics within 1e-5 (the same batch statistics up to
    summation order)."""
    port, jax_out, port_out = trajectories
    _, gnorm_j, grads_j, params_j, stats_j, (mu_j, nu_j) = jax_out[0]
    _, _, grads_p, got, moments = port_out[0]
    lr = OPT["lr"]
    want = state_dict_from_jax(params_j, stats_j, port)
    want_g = state_dict_from_jax(grads_j, stats_j, port)
    want_mu = state_dict_from_jax(mu_j, stats_j, port)
    want_nu = state_dict_from_jax(nu_j, stats_j, port)
    n_noise = n_sure = n_all = 0
    worst = 0.0
    for name, ref in want.items():
        ref, new = ref.numpy(), got[name].numpy()
        err = np.abs(new - ref)
        if "running_" in name:
            assert err.max() <= 1e-5 + 1e-5 * np.abs(ref).max(), (name, err.max())
            continue
        g_ref, g_got = want_g[name].numpy(), grads_p[name].numpy()
        slack = 2 * np.spacing(np.abs(ref))
        agree = np.sign(g_ref) == np.sign(g_got)
        sure = agree & (np.minimum(np.abs(g_ref), np.abs(g_got)) >= 1e3 * ADAM_EPS)
        excess = (err - slack)[sure]
        worst = max(worst, float(excess.max(initial=0.0)) / lr)
        assert (excess <= 0.01 * lr).all(), (name, excess.max() / lr)
        assert (err <= 2 * lr + slack).all(), name
        assert (np.abs(g_ref[~agree]) <= 1e-4 * gnorm_j).all(), name
        n_noise += int((~agree).sum())
        n_sure += int(sure.sum())
        n_all += ref.size
        m_got, v_got = (t.numpy() for t in moments[name])
        m_ref, v_ref = want_mu[name].numpy(), want_nu[name].numpy()
        assert np.linalg.norm(m_got - m_ref) <= (
            0.02 * np.linalg.norm(m_ref) + 1e-6 * gnorm_j), name
        assert np.linalg.norm(v_got - v_ref) <= (
            0.05 * np.linalg.norm(v_ref) + 1e-9 * gnorm_j ** 2), name
    print(f"update error beyond f32 rounding where the signs agree: "
          f"{worst:.3g} lr on {n_sure}/{n_all} elements; elements with "
          f"disagreeing gradient signs {n_noise}; grad norm {gnorm_j:.4g}")
    assert n_noise <= 2e-3 * n_all, (n_noise, n_all)
    assert n_sure >= 0.95 * n_all, (n_sure, n_all)


def test_train_step_trajectory_stays_close(trajectories):
    """Three steps on one batch (the schedule's lr moves each step): the
    losses stay within rtol 1e-3 and the grad norms within 1e-2, and the
    loss falls on both sides."""
    _, jax_out, port_out = trajectories
    lj = [o[0] for o in jax_out]
    lp = [o[0] for o in port_out]
    np.testing.assert_allclose(lp, lj, rtol=1e-3)
    np.testing.assert_allclose([o[1] for o in port_out],
                               [o[1] for o in jax_out], rtol=1e-2)
    assert lj[-1] < lj[0] and lp[-1] < lp[0], (lj, lp)
