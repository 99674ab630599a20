"""The GraphEncoder's remaining options in the port against the JAX
package: the 'ramp' schedules, the pair-layout Grapher (knn_strategy
'exact', 'onehot', 'approx'), EdgeConv, SAGE and GIN, at size t on 16 x 16
log-mel (N = 128 down to 16, so k * dilation = 9 fits stage 4), on numpy
inputs from a seed and shared weights (``calibrated_jax_variables``: the
port's weights, BatchNorms drawn and calibrated, mapped to the JAX tree);
then DropPath against its definition, remat against no remat, the k-NN
graph's tie order and ``knn_block_size``, the weight bridge of every conv
from a JAX init, and the fold of every new model.

Tolerances, with their reasons:
* forward, eval and train mode (train: batch statistics, drop_path 0,
  since the two packages draw DropPath masks from different generators):
  f32 z within 1e-5 of JAX's (summation order; measured <= 5e-7). bf16:
  each row nearest its own JAX row (``hold_rows``) above cos 0.995, and
  the port's rows as near JAX's f32 rows as JAX's own bf16 rows are (mean
  cosine at most 1e-3 below). The two packages round bf16 activations at
  other points (torch adds a linear's bias before rounding its product,
  XLA after), and a dilated or edge graph turns such roundings into other
  neighbours: measured on these inputs, the already ported 'reference'
  model's rows reach cos 0.9986 to JAX's, the new paths' 0.9959 ('ramp')
  to 0.9996, while each package's bf16 rows lie as near the f32 rows as
  the other's (mean cosines 0.9962-0.9996, within 4e-4). A floor of 0.999
  would fail the reference model itself.
* one 'ramp' train step: the tolerances of
  ``tests/test_torch_port_train.py::test_train_step_loss_and_grads_match_jax``.
* remat, DropPath's mask and x / keep, k-NN indices: exact.
* the fold: f32 rows above cos 0.9999 (``hold_rows``), as
  ``chip_smoke.py`` holds the fold.
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
from grafp_tpu.ops.knn import knn_graph as j_knn_graph  # noqa: E402
from grafp_tpu.train.loss import ntxent_loss as j_ntxent  # noqa: E402
from grafp_tpu.train.step import optax_global_norm  # noqa: E402
from grafp_tpu_torch.convert import state_dict_from_jax  # noqa: E402
from grafp_tpu_torch.core import Config  # noqa: E402
from grafp_tpu_torch.models import build_model  # noqa: E402
from grafp_tpu_torch.models.fold_bn import fold_batch_norms  # noqa: E402
from grafp_tpu_torch.models.gnn import GraphEncoder, Grapher  # noqa: E402
from grafp_tpu_torch.models.layers import (  # noqa: E402
    BatchNorm,
    DropPath,
    drop_path_generator,
    init_parameters,
)
from grafp_tpu_torch.ops.knn import knn_graph  # noqa: E402
from grafp_tpu_torch.train import create_train_state, make_train_step  # noqa: E402
from tests.torch_port_util import (  # noqa: E402
    calibrated_jax_variables,
    hold_rows,
    jax_variables_from_port,
    load_jax_weights,
    one_torch_thread,  # noqa: F401 (the fixture)
    randomize_jax_variables,
    to_torch,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TINY = dict(n_mels=16, n_frames=16)
# the train step's geometry: 1 s at 1 kHz, hop 64 -> 16 x 16 log-mel
STEP = dict(fs=1000, win_len=256, hop_len=64, n_fft=256, n_mels=16, n_frames=16,
            bsz_train=4)
RAMP = dict(dilation_schedule="ramp", drop_path_schedule="ramp")
# Config overrides and graph conv of each case
CASES = {"ramp": (dict(RAMP, drop_path=0.0), "mr"),
         "exact": (dict(knn_strategy="exact"), "mr"),
         "onehot": (dict(knn_strategy="onehot"), "mr"),
         "approx": (dict(knn_strategy="approx"), "mr"),
         "edge": ({}, "edge"), "sage": ({}, "sage"), "gin": ({}, "gin")}
ROWS = 8
F32_ATOL = 1e-5
BF16_FLOOR = 0.995
BF16_MEAN_SLACK = 1e-3
FOLD_FLOOR = 0.9999
_DT = {"float32": None, "bfloat16": torch.bfloat16}


def _spec(seed=0, rows=ROWS):
    return (10.0 * np.random.RandomState(seed).randn(rows, 16, 16)).astype(np.float32)


def _jax_model(case, dtype, **extra):
    over, conv = CASES[case]
    jm = j_build_model(JConfig(compute_dtype=dtype, **{**TINY, **over, **extra}))
    return jm.clone(encoder=jm.encoder.clone(conv=conv)) if conv != "mr" else jm


def _port_model(case, dtype, **extra):
    over, conv = CASES[case]
    cfg = Config(compute_dtype=dtype, **{**TINY, **over, **extra})
    model = build_model(cfg, device="cpu")
    if conv != "mr":
        model.encoder = GraphEncoder(in_features=cfg["n_filters"], k=int(cfg["k"]),
                                     conv=conv, emb_dims=cfg["h"],
                                     knn_block_rows=int(cfg["knn_block_size"]),
                                     dtype=_DT[dtype])
        init_parameters(model, torch.Generator().manual_seed(0))
    return model


def _shapes(jm):
    return jax.eval_shape(lambda k: jm.init({"params": k}, jnp.zeros((1, 16, 16)), False),
                          jax.random.key(0))


@pytest.fixture(scope="module")
def runs():
    """(case, dtype) -> {mode: (port z, JAX z)} for mode 'eval' and
    'train', one JAX compile each; the weights of a case are calibrated
    once, in f32, and shared by both dtypes."""
    weights, out = {}, {}
    spec = _spec()

    def get(case, dtype):
        if case not in weights:
            port = _port_model(case, "float32")
            weights[case] = calibrated_jax_variables(
                port, _shapes(_jax_model(case, "float32")), spec)
        if (case, dtype) not in out:
            params, stats = weights[case]
            jm = _jax_model(case, dtype)

            @jax.jit
            def both(v, s):
                _, ze = jm.apply(v, s, False)
                (_, zt), _ = jm.apply(v, s, True, mutable=["batch_stats"])
                return ze, zt

            want = both({"params": params, "batch_stats": stats}, jnp.asarray(spec))
            port = load_jax_weights(_port_model(case, dtype), params, stats)
            got = {}
            with torch.no_grad():
                got["eval"] = port.eval()(to_torch(spec))[1]
                got["train"] = port.train()(to_torch(spec))[1]
            out[(case, dtype)] = {
                mode: (got[mode].float().numpy(), np.asarray(w.astype(jnp.float32)))
                for mode, w in zip(("eval", "train"), want)}
        return out[(case, dtype)]

    return get


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(runs, case, dtype, mode):
    got, want = runs(case, dtype)[mode]
    assert got.shape == want.shape == (ROWS, 128)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
        return
    hold_rows(f"{case} bf16 {mode}", got, want, BF16_FLOOR)
    want32 = runs(case, "float32")[mode][1]

    def mean_cos(a, b):
        return float(np.mean((a * b).sum(1) / np.linalg.norm(a, axis=1)
                             / np.linalg.norm(b, axis=1)))

    port_cos, jax_cos = mean_cos(got, want32), mean_cos(want, want32)
    print(f"{case} {mode}: mean cos to JAX's f32 rows, port bf16 {port_cos:.6f}, "
          f"JAX bf16 {jax_cos:.6f}")
    assert port_cos >= jax_cos - BF16_MEAN_SLACK


def test_paths_launch_no_kernel_where_jax_runs_none():
    """Which path each block takes: the 'ramp' model keeps the kernel path
    (and fusion) at its four dilation-1 blocks only; 'exact', 'onehot' and
    'approx' and the index convs never take it."""
    ramp = _port_model("ramp", "float32").encoder
    graphers = [getattr(ramp, f"block{i}_grapher") for i in range(12)]
    assert [g.dilation for g in graphers] == [1] * 4 + [2] * 4 + [3] * 4
    assert [g.kernel for g in graphers] == [True] * 4 + [False] * 8
    assert [g.fuse_serving for g in graphers] == ["auto"] * 4 + ["off"] * 8
    assert [g.gconv.conv.concat_interleaved for g in graphers] == [True] * 4 + [False] * 8
    for case in ("exact", "onehot", "approx", "edge", "sage", "gin"):
        enc = _port_model(case, "float32").encoder
        assert not any(getattr(enc, f"block{i}_grapher").kernel for i in range(12)), case


def test_ramp_schedules_are_the_jax_package_s():
    enc = _port_model("ramp", "float32", drop_path=0.1).encoder
    for i in range(12):
        want_d = jgnn.dilation_for_block(i, 3, "ramp")
        want_p = jgnn.drop_path_for_block(i, 12, 0.1, "ramp")
        g, f = getattr(enc, f"block{i}_grapher"), getattr(enc, f"block{i}_ffn")
        assert g.dilation == want_d and g.drop_path.rate == f.drop_path.rate == want_p


# --- one 'ramp' train step -------------------------------------------------

def test_ramp_train_step_matches_jax():
    """One f32 step of the 'ramp' model (drop_path 0) on one fixed batch,
    JAX's own step function beside the port's make_train_step (the JAX
    side without the augment): loss rtol 5e-5, grad norm rtol 5e-3, every
    gradient within 2 % of its L2 norm plus 1e-5 of the grad norm, and cos
    > 0.9999 where its max is over 1e-4 of the grad norm
    (``tests/test_torch_port_train.py``)."""
    rs = np.random.RandomState(0)
    b = STEP["bsz_train"]
    x_i = rs.randn(b, STEP["fs"]).astype(np.float32)
    x_j = (x_i + 0.3 * rs.randn(b, STEP["fs"])).astype(np.float32)
    cfg = Config(**STEP, **RAMP, drop_path=0.0)
    port = build_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu",
                       train=True)
    jcfg = JConfig(**STEP, **RAMP, drop_path=0.0)
    jm = j_build_model(jcfg)
    params, stats = randomize_jax_variables(*jax_variables_from_port(port, _shapes(jm)),
                                            seed=1)
    port.load_state_dict(state_dict_from_jax(params, stats, port))
    mcfg = JLogMelConfig.from_config(jcfg)

    @jax.jit
    def j_grads(p, xi, xj):
        spec = j_log_mel(jnp.concatenate([xi, xj], axis=0), mcfg)

        def loss_fn(pp):
            (_, z), _ = jm.apply({"params": pp, "batch_stats": stats}, spec, True,
                                 mutable=["batch_stats"])
            return j_ntxent(z[:b], z[b:], jcfg.tau)

        loss, grads = jax.value_and_grad(loss_fn)(p)
        return loss, optax_global_norm(grads), grads

    loss_j, gnorm_j, grads_j = j_grads(params, x_i, x_j)
    loss_j, gnorm_j = float(loss_j), float(gnorm_j)
    state = create_train_state(port, cfg, steps_per_epoch=1)
    m = make_train_step(port, cfg, device="cpu")(state, x_i, x_j,
                                                 torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(m["loss"]), loss_j, rtol=5e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), gnorm_j, rtol=5e-3)
    want = state_dict_from_jax(jax.tree.map(np.asarray, grads_j), stats, port)
    for name, p in port.named_parameters():
        got, ref = p.grad.numpy(), want[name].numpy()
        norm = np.linalg.norm(ref)
        assert np.linalg.norm(got - ref) <= 0.02 * norm + 1e-5 * gnorm_j, name
        if np.abs(ref).max() < 1e-4 * gnorm_j:
            continue
        cos = (got * ref).sum() / (np.linalg.norm(got) * norm)
        assert cos > 0.9999, (name, cos)


# --- DropPath and remat ----------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_drop_path_is_its_definition(dtype):
    """Train mode, rate 0.3, 4000 samples: sample i is kept where the
    generator's i-th uniform draw lies below keep = 0.7 (the mask read
    back from the output), as x / keep exactly, keep rounded to x's dtype
    as JAX's weakly typed float is (the kept values equal JAX's x / keep
    bit for bit), and zero otherwise; the share kept within 4 sigma of
    keep. Eval, rate 0 and a train-mode draw without a generator: the
    identity, the identity, RuntimeError."""
    dt = getattr(torch, dtype)
    rate, keep, n = 0.3, 0.7, 4000
    x = torch.randn(n, 3, 5, generator=torch.Generator().manual_seed(1)).to(dt)
    dp = DropPath(rate).train()
    with pytest.raises(RuntimeError, match="generator"):
        dp(x)
    with drop_path_generator(dp, torch.Generator().manual_seed(5)):
        y = dp(x)
    assert dp.generator is None
    mask = torch.rand(n, generator=torch.Generator().manual_seed(5)) < keep
    assert torch.equal((y != 0).any(-1).any(-1), mask)
    assert y.dtype == dt and not y[~mask].any()
    k = torch.tensor(keep).to(dt).double()
    assert torch.equal(y[mask], (x[mask].double() / k).to(dt))
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if dtype == "bfloat16"
                                               else jnp.float32)
    want = np.asarray((jx / keep).astype(jnp.float32))
    assert np.array_equal(y[mask].float().numpy(), want[mask.numpy()])
    share = mask.double().mean().item()
    assert abs(share - keep) < 4 * (keep * (1 - keep) / n) ** 0.5
    assert dp.eval()(x) is x and DropPath(0.0).train()(x) is x


def _one_step(remat: bool, drop_path: float):
    """One CPU train step of the 'ramp' model at STEP's geometry from one
    seed; returns (loss, gradients, running statistics, the number of
    forwards of block 11's last BatchNorm)."""
    cfg = Config(**STEP, **RAMP, drop_path=drop_path, remat=remat)
    model = build_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu",
                        train=True)
    calls = []
    model.encoder.block11_grapher.fc2_bn.register_forward_hook(
        lambda *a: calls.append(1))
    rs = np.random.RandomState(0)
    x_i = rs.randn(STEP["bsz_train"], STEP["fs"]).astype(np.float32)
    x_j = (x_i + 0.3 * rs.randn(*x_i.shape)).astype(np.float32)
    m = make_train_step(model, cfg, device="cpu")(
        create_train_state(model, cfg, steps_per_epoch=1), x_i, x_j,
        torch.Generator().manual_seed(3))
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    stats = {k: v.clone() for k, v in model.state_dict().items() if "running_" in k}
    return m["loss"], grads, stats, len(calls)


def test_remat_changes_no_loss_gradient_or_statistic():
    """remat=True against remat=False, one step with the 'ramp' DropPath at
    peak 0.5 (so that samples are dropped: the loss differs from drop_path
    0's): loss, every gradient and every running statistic bit-equal; the
    recompute ran (block 11's fc2_bn forwarded twice, not once)."""
    loss, grads, stats, calls = _one_step(False, 0.5)
    loss_r, grads_r, stats_r, calls_r = _one_step(True, 0.5)
    assert (calls, calls_r) == (1, 2)
    assert not torch.equal(loss, _one_step(False, 0.0)[0])
    assert torch.equal(loss, loss_r)
    assert grads.keys() == grads_r.keys() and stats.keys() == stats_r.keys()
    for name in grads:
        assert torch.equal(grads[name], grads_r[name]), name
    for name in stats:
        assert torch.equal(stats[name], stats_r[name]), name


# --- the k-NN graph ----------------------------------------------------------

def _tie_heavy(kind, seed=0):
    x = np.random.RandomState(seed).randn(2, 64, 16).astype(np.float32)
    if kind == "duplicates":
        x[:, 8:24] = x[:, 8:9]                   # 16 equal rows
    else:
        x[:, 1::4] = 2.0 * x[:, 0::4]            # equal keys, distinct rows
    return x


@pytest.mark.parametrize("k", [3, 9])
@pytest.mark.parametrize("kind", ["duplicates", "scaled"])
def test_knn_graph_tie_order_matches_jax(kind, k):
    """Larger score first, the lower index first among equal scores, as
    ``lax.top_k`` orders them: the indices equal JAX's, and so do every
    dilation's."""
    x = _tie_heavy(kind)
    want = np.asarray(j_knn_graph(jnp.asarray(x), k))
    got = knn_graph(torch.tensor(x), k).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("block_rows", [7, 32, 100])
def test_knn_block_size_equals_the_dense_graph(block_rows):
    """Query rows in tiles of ``block_rows`` (7 leaves a ragged tile; 100
    exceeds N = 64): the indices equal the dense path's and JAX's tiled
    path's, on tie-heavy rows."""
    x = _tie_heavy("duplicates", seed=1)
    dense = knn_graph(torch.tensor(x), 9)
    assert torch.equal(knn_graph(torch.tensor(x), 9, block_rows=block_rows), dense)
    want = np.asarray(j_knn_graph(jnp.asarray(x), 9, block_rows=block_rows))
    assert np.array_equal(dense.numpy(), want)


def test_knn_block_size_reaches_every_graph():
    """Config(knn_block_size=16) reaches every dilated block of the 'ramp'
    model and every EdgeConv block; z equals the dense graph's bit for
    bit."""
    spec = to_torch(_spec(2, rows=4))
    for case in ("ramp", "edge"):
        zs = []
        for rows in (0, 16):
            model = _port_model(case, "float32", knn_block_size=rows).eval()
            graphers = [m for m in model.modules() if isinstance(m, Grapher)]
            assert all(g.knn_block_rows == rows for g in graphers)
            with torch.no_grad():
                zs.append(model(spec)[1])
        assert torch.equal(*zs), case


# --- the bridge and the fold -------------------------------------------------

@pytest.mark.parametrize("conv", ["mr", "edge", "sage", "gin"])
def test_bridge_maps_a_jax_init_of_each_conv(conv):
    """A JAX init of one Grapher (the pair-layout MRConv at dilation 2 for
    'mr'), BatchNorms and biases drawn, GIN's eps 0.25: the tree maps with
    no missing or extra key (SAGE's 3-D nn1 / nn2 kernels keep their
    layout), and the port's block equals JAX's in eval and train mode
    within 1e-5."""
    kw = dict(dilation=2) if conv == "mr" else dict(conv=conv)
    jg = jgnn.Grapher(16, **kw)
    x = np.random.RandomState(3).randn(2, 32, 16).astype(np.float32)
    v = jax.tree.map(np.asarray, jg.init(jax.random.key(1), jnp.asarray(x), False))
    params, stats = randomize_jax_variables(v["params"], v["batch_stats"], seed=2)
    if conv == "gin":
        params["gconv"]["eps"] = np.float32(0.25)
    if conv == "sage":
        params["gconv"]["nn1"]["bias"] = 0.1 * np.ones(16, np.float32)
    port = Grapher(16, **kw)
    port.load_state_dict(state_dict_from_jax(params, stats, port))
    if conv == "sage":
        assert torch.equal(port.gconv.nn1.weight, torch.tensor(params["gconv"]["nn1"]["kernel"]))
    for train in (False, True):
        want = jg.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train,
                        mutable=["batch_stats"])[0]
        with torch.no_grad():
            got = port.train(train)(to_torch(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("case", ["ramp", "edge", "sage", "gin"])
def test_fold_keeps_each_model(case):
    """The folded f32 model against the unfolded one on calibrated weights:
    each row nearest its own above cos 0.9999. SAGE keeps its nn1_bn and
    nn2_bn (the JAX fold knows no such site); every other graph conv's
    BatchNorm is folded."""
    model = _port_model(case, "float32")
    calibrated_jax_variables(model, _shapes(_jax_model(case, "float32")), _spec())
    folded = fold_batch_norms(model)
    spec = to_torch(_spec(4))
    with torch.no_grad():
        z, zf = model.eval()(spec)[1], folded(spec)[1]
    hold_rows(f"{case} folded vs unfolded", zf, z, FOLD_FLOOR)
    bns = [n for n, m in folded.named_modules() if isinstance(m, BatchNorm)]
    if case == "sage":
        assert bns and all(n.endswith(("nn1_bn", "nn2_bn")) for n in bns), bns
    else:
        assert not bns, bns
