"""The port's bf16-vs-f32 training study
(scripts/torch_port_bf16_train_study.py) against the JAX script's protocol
(scripts/bf16_train_study.py:25-50) on the CPU, at the tiny geometry of
tests/test_torch_port_train.py, drop_path_schedule 'reference' (all 0).

The JAX side makes the script's calls: ``create_train_state`` with
``key(0)`` and ``make_train_step`` with no banks, then the eval forward of
the trained state on x_eval's log-mel. The port starts from JAX's initial
weights (``state_dict_from_jax``). Without banks neither package draws
anything (DropPath is off), so the two trajectories can be compared. Both
run their defaults: on the CPU the JAX package's 'auto' k-NN strategy is
'onehot' (its Pallas kernel runs on a TPU only), the port's is the kernel
path's plain version. The lr is tests/test_torch_port_train.py's 2e-7:
with the study's 8e-5 the f32 losses part at the second step (measured at
8 pairs: 6.6 %), where updates move node features across near ties of the
k-NN selection.

Tolerances, with their reasons:
* f32 losses over STEPS steps within rtol 1e-3 (test_torch_port_train.py's
  trajectory tolerance; measured <= 1.5e-5), and the trained f32
  fingerprints within 1e-4 (measured <= 2e-6).
* bf16 losses: from this initialisation (NT-Xent at tau 0.05) a bf16 run
  is chaotic, and the two packages round bf16 activations at other points
  (torch adds a linear's bias before rounding its product, XLA after;
  tests/test_torch_port_graph_convs.py). Measured on these inputs: the
  first bf16 loss, before any update, lay 0.5 % from JAX's (3.1348
  against 3.1197), while JAX's own first bf16 loss moved by 30 % under
  input noise of BF16_NOISE relative, below bf16's resolution, and its
  later losses by 84-217 %; noise of 1e-7 (the f32 rule of
  tests/test_torch_port_fold.py) moved nothing in 2 of 3 draws, since bf16
  absorbs it. So each bf16 loss is held within 1e-3 relative plus
  SPREAD_TIMES JAX's spread under BF16_NOISE over NOISE_DRAWS draws: a
  check for a gross fault only (a bf16 run that diverges or does not
  train); the gap below is the study's own measure.
* The gap: the port's bf16-vs-f32 loss difference (mean relative over the
  steps) and its trained fingerprints' cosines to its own f32 ones (min
  and mean) against the band of JAX's, from its clean bf16 run and its
  runs under BF16_NOISE, each against JAX's f32 run: the port's lies
  inside the band, widened by SPREAD_TIMES its width, or on its better
  side (measured: loss gap 0.261 against JAX's 0.177-0.491, min cos
  0.98918 against 0.98674-0.98890).
* ``main`` prints the JAX script's five result lines, matched by regex.
"""

import concurrent.futures
import contextlib
import functools
import io
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from grafp_tpu.core.config import Config as JConfig  # noqa: E402
from grafp_tpu.dsp.melspec import LogMelConfig as JLogMelConfig  # noqa: E402
from grafp_tpu.dsp.melspec import log_mel_spectrogram as j_log_mel  # noqa: E402
from grafp_tpu.models import build_model as j_build_model  # noqa: E402
from grafp_tpu.train import create_train_state as j_create_train_state  # noqa: E402
from grafp_tpu.train import make_train_step as j_make_train_step  # noqa: E402
from grafp_tpu_torch.convert import state_dict_from_jax  # noqa: E402
from grafp_tpu_torch.core import Config  # noqa: E402
from grafp_tpu_torch.models import build_model  # noqa: E402
from tests.torch_port_util import load_script, one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# tests/test_torch_port_train.py's geometry: 1 s at 1 kHz, 16 mels x 8 frames
TINY = dict(fs=1000, win_len=256, hop_len=128, n_fft=256, n_mels=16, n_frames=8)
OPT = dict(lr=2e-7)
STEPS = 4
PAIRS = 4
EVAL_ROWS = 8
NOISE_DRAWS = 3
# relative input noise under bf16's resolution (8 significant bits: half an
# ulp is 2^-9, about 2e-3)
BF16_NOISE = 1e-3
SPREAD_TIMES = 2.0
DTYPES = ("float32", "bfloat16")


def study():
    return load_script("torch_port_bf16_train_study")


def _compile_jax(jcfg, x_i, x_j, x_eval):
    """The JAX script's programs at the tiny geometry, compiled ahead of
    time on worker threads (XLA compiles outside the interpreter lock):
    {"init": key -> the f32 model's TrainState, dtype: (step, eval)}, with
    eval(params, batch_stats, waves) -> z."""
    models = {dt: j_build_model(jcfg[dt]) for dt in DTYPES}
    key = jax.random.key(0)

    def init(k):
        return j_create_train_state(models["float32"], jcfg["float32"], k, STEPS)

    shapes = jax.eval_shape(init, key)
    mcfg = JLogMelConfig.from_config(jcfg["float32"])

    def eval_fn(model):
        def fn(params, batch_stats, waves):
            _, z = model.apply({"params": params, "batch_stats": batch_stats},
                               j_log_mel(waves, mcfg), False)
            return z
        return jax.jit(fn)

    jobs = {"init": lambda: jax.jit(init).lower(key).compile()}
    for dt in DTYPES:
        state = shapes.replace(apply_fn=models[dt].apply)
        step = j_make_train_step(models[dt], jcfg[dt], None, donate=False)
        jobs[dt, "step"] = (lambda s=step, st=state:
                            s.lower(st, x_i, x_j, key).compile())
        jobs[dt, "eval"] = (lambda m=models[dt]: eval_fn(m).lower(
            shapes.params, shapes.batch_stats, x_eval).compile())
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(job) for name, job in jobs.items()}
        compiled = {name: f.result() for name, f in futures.items()}
    return models, compiled


def _jax_run(models, compiled, state0, dt, x_i, x_j, x_eval):
    """The JAX script's run() on the compiled programs: (losses, z)."""
    state = state0.replace(apply_fn=models[dt].apply)
    losses = []
    for i in range(STEPS):
        state, m = compiled[dt, "step"](state, x_i, x_j, jax.random.key(1000 + i))
        losses.append(float(m["loss"]))
    z = compiled[dt, "eval"](state.params, state.batch_stats, x_eval)
    return np.asarray(losses), np.asarray(z, np.float32)


@pytest.fixture(scope="module")
def runs():
    """Both packages' (losses, z) per dtype, and JAX's bf16 run on inputs
    under BF16_NOISE relative noise (NOISE_DRAWS draws)."""
    st = study()
    _, x_i, x_j, x_eval = st.study_data(PAIRS, EVAL_ROWS, TINY["fs"])
    jcfg = {dt: JConfig(compute_dtype=dt, **TINY, **OPT) for dt in DTYPES}
    models, compiled = _compile_jax(jcfg, x_i, x_j, x_eval)
    # flax initialisers run in f32, so the f32 model's init is the bf16
    # model's too (the JAX script's premise)
    state0 = compiled["init"](jax.random.key(0))
    jax_out = {dt: _jax_run(models, compiled, state0, dt, x_i, x_j, x_eval)
               for dt in DTYPES}
    noise = np.random.RandomState(3)
    noisy = [_jax_run(models, compiled, state0, "bfloat16",
                      *((x * (1 + BF16_NOISE * noise.randn(*x.shape))).astype(np.float32)
                        for x in (x_i, x_j)), x_eval)
             for _ in range(NOISE_DRAWS)]

    cfg = Config(**TINY, **OPT)
    sd = state_dict_from_jax(state0.params, state0.batch_stats,
                             build_model(cfg, device="cpu"))
    port = {dt: st.run(dt, STEPS, None, x_i, x_j, x_eval, cfg, sd, "cpu")[:2]
            for dt in DTYPES}
    return jax_out, noisy, port


def _gap(l32, z32, l16, z16):
    """(mean relative bf16-vs-f32 loss difference, min cos, mean cos of the
    trained fingerprints)."""
    cos = study().row_cosines(z16, z32)
    return np.array([np.mean(np.abs(l16 - l32) / np.abs(l32)), cos.min(), cos.mean()])


def test_f32_trajectory_matches_jax(runs):
    jax_out, _, port = runs
    (lj, zj), (lp, zp) = jax_out["float32"], port["float32"]
    np.testing.assert_allclose(lp, lj, rtol=1e-3)
    np.testing.assert_allclose(zp, zj, rtol=0, atol=1e-4)


def test_bf16_trajectory_within_the_reference_spread(runs):
    jax_out, noisy, port = runs
    lj, lp = jax_out["bfloat16"][0], port["bfloat16"][0]
    spread = np.max([np.abs(n[0] - lj) for n in noisy], axis=0)
    print(f"bf16 losses: port {lp}, JAX {lj}, JAX's spread under input noise {spread}")
    assert (np.abs(lp - lj) <= 1e-3 * np.abs(lj) + SPREAD_TIMES * spread).all(), (
        lp, lj, spread)


def test_bf16_gap_within_the_reference_gap(runs):
    """The port's bf16 run lies no farther from its f32 run than JAX's bf16
    runs (clean and under input noise) lie from JAX's f32 run, up to
    SPREAD_TIMES the width of JAX's band: a loss gap no larger, and
    fingerprint cosines no lower."""
    jax_out, noisy, port = runs
    j32 = jax_out["float32"]
    band = np.array([_gap(*j32, *run) for run in noisy + [jax_out["bfloat16"]]])
    width = SPREAD_TIMES * (band.max(0) - band.min(0))
    got = _gap(*port["float32"], *port["bfloat16"])
    print(f"(loss gap, min cos, mean cos): port {got}, JAX {band[-1]}, "
          f"JAX under input noise {band[:-1].tolist()}")
    assert got[0] <= band[:, 0].max() + width[0], (got, band)
    assert (got[1:] >= band[:, 1:].min(0) - width[1:]).all(), (got, band)


def test_main_prints_the_jax_scripts_lines(monkeypatch):
    """main() with the script's own banks at the tiny geometry, 2 steps, on
    2 pairs and 4 held-out rows of its data (64 and 32 by default)."""
    st = study()
    monkeypatch.setattr(st, "study_data", functools.partial(st.study_data, 2, 4))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert st.main(["2", "--device", "cpu"], cfg=Config(**TINY)) == 0
    lines = out.getvalue().splitlines()
    num = r"-?\d+\.\d{4}"
    patterns = [r"device=cpu steps=2",
                rf"\[f32 \] \d+s  loss\[0\]={num} loss\[-1\]={num}",
                rf"\[bf16\] \d+s  loss\[0\]={num} loss\[-1\]={num}",
                rf"loss \|rel diff\|: mean {num} max {num} final {num}",
                rf"trained-fingerprint cosine bf16-vs-f32 runs: min {num} mean {num}",
                rf"last-10-step mean loss: f32 {num} bf16 {num}"]
    assert len(lines) == len(patterns), lines
    for line, pattern in zip(lines, patterns):
        assert re.fullmatch(pattern, line), (line, pattern)


def test_study_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    st = study()
    _, x_i, x_j, x_eval = st.study_data(1, 1, TINY["fs"])
    with pytest.raises(RuntimeError, match="CUDA"):
        st.run("float32", 1, None, x_i, x_j, x_eval, Config(**TINY))
    with pytest.raises(RuntimeError, match="CUDA"):
        st.main(["1"], cfg=Config(**TINY))


def test_determinism_probe_reports_each_run(monkeypatch):
    """scripts/torch_port_determinism.py (the reproduction of C11 and its
    kind) at the tiny geometry on 2 pairs, its step paths that take k = 3
    at 8 nodes, then again under deterministic algorithms: on the CPU every
    step is deterministic, so each line reports equal losses and no
    differing tensor, and no op warns."""
    det = load_script("torch_port_determinism")
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    paths = ["size t", "pair", "edge", "sage", "gin"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert det.main(["--device", "cpu", "--paths", ",".join(paths), "--pairs", "2",
                         "--deterministic-algorithms"], cfg=Config(**TINY)) == 0
    lines = out.getvalue().splitlines()
    labels = [f"{p} {dt} step (2 pairs)" for p in paths for dt in ("float32", "bfloat16")]
    assert lines[0] == "device=cpu" and len(lines) == 2 * len(labels) + 3, lines
    steps = lines[1:1 + len(labels)]
    again = lines[1 + len(labels):1 + 2 * len(labels)]
    for label, line, line2 in zip(labels, steps, again):
        for text, prefix in ((line, ""), (line2, "deterministic algorithms, ")):
            assert text.startswith(f"{prefix}{label}: losses "), text
            loss = re.search(r"losses (\S+) (\S+);", text)
            assert loss and loss.group(1) == loss.group(2), text
            assert re.search(r"; 0 of \d+ tensors differ \[\]; ", text), text
    assert lines[-2] == "deterministic algorithms, warnings []", lines[-2]
    assert lines[-1] == f"paths with a differing tensor: 0 of {len(labels)} []", lines[-1]
