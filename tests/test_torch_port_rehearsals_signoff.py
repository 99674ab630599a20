"""The port's int8_static retrieval sign-off
(scripts/torch_port_e2e_int8_retrieval_signoff.py) against the JAX script
scripts/e2e_int8_retrieval_signoff.py on the CPU: one tiny workspace
(scripts/torch_port_setup_synth_icassp.py --tiny: 1 kHz, 16 mels, f32),
the same weights passed as the port's .pth and as the JAX package's Orbax
checkpoint, as tests/test_torch_port_cli.py does.

Tolerances: the dummy DBs, port against JAX: the unquantised rows within
1e-3 and each nearest its own JAX row (tests/test_torch_port_cli.py's rule
for the CLIs' DBs, with no cosine floor: two rows of a track lie too close
for one); the int8_static rows, where each package calibrates its maxima
lazily on its own first track, each nearest its own row above TRACK_FLOOR
(tests/test_torch_port_quant.py, where it is derived). The hit rates
differ by construction (each package draws its corruptions from its own
generator): each table is only held to lie in [0, 100]."""

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from grafp_tpu_torch.core import Config  # noqa: E402
from grafp_tpu_torch.fp import FingerprintPipeline  # noqa: E402
from grafp_tpu_torch.models import build_model  # noqa: E402
from grafp_tpu_torch.retrieval.memmap_io import load_memmap_data  # noqa: E402
from grafp_tpu_torch.train.checkpoint import save_ckp  # noqa: E402
from tests.torch_port_util import (  # noqa: E402
    calibrated_jax_variables,
    hold_rows,
    load_script,
    one_torch_thread,
    to_torch,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# the model geometry of the workspace's --tiny config
TINY = dict(fs=1000, win_len=256, hop_len=128, n_fft=256, n_mels=16, n_frames=8)
# where each package calibrates its int8_static maxima on its own first
# track: tests/test_torch_port_quant.py's floor for the lazy pipelines
TRACK_FLOOR = 0.9965

SIGNOFF = dict(n_query_db=8, snrs=(10, 0))


@pytest.fixture(scope="module")
def signoff(tmp_path_factory):
    """A tiny workspace (24 eval tracks of 4 s, 7 rows each; 8 of them the
    queries), seeded weights calibrated to behave like trained ones, saved
    as the port's .pth and as the JAX package's Orbax checkpoint, and the
    sign-off of each package on it: the JAX script's main() (its DBs moved
    to signoff_jax), then the port's run(). Both pipelines embed in
    batches of 32. The JAX builders run their track groups on one worker
    thread here: on several (``_ordered_overlap``'s default 4) the lazy
    int8_static calibration goes to whichever group's thread reaches it
    first, not always the first track's (seen: the ninth track's, whose
    maxima move the rows to cos 0.982), where the port calibrates on the
    first track's segments as the JAX pipeline's docstring says."""
    import jax
    import jax.numpy as jnp

    from grafp_tpu.core.config import Config as JConfig
    from grafp_tpu.fp import builder as j_builder
    from grafp_tpu.fp.builder import FingerprintPipeline as JPipeline
    from grafp_tpu.models import build_model as j_build_model
    from grafp_tpu.train.checkpoint import save_ckp as j_save_ckp

    ws = tmp_path_factory.mktemp("signoff")
    load_script("torch_port_setup_synth_icassp").setup(str(ws), train_tracks=0, eval_tracks=24,
                                                   dur=4.0, tiny=True)
    cfg = yaml.safe_load(open(ws / "synth.yaml"))
    cfg.update(scan_topk="approx", scan_recall=0.99)       # as the r5 sweep writes it
    yaml.safe_dump(cfg, open(ws / "synth_eval.yaml", "w"), sort_keys=False)

    shapes = jax.eval_shape(lambda: j_build_model(JConfig(**TINY)).init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 16, 8)), False))
    model = build_model(Config(**TINY), device="cpu")
    spec = (10.0 * np.random.RandomState(13).randn(32, 16, 8)).astype(np.float32)
    params, stats = calibrated_jax_variables(model, shapes, to_torch(spec))
    ckpt = str(ws / "run" / "checkpoint")
    save_ckp({"state_dict": model.state_dict()}, "tc29r5", ckpt, "best")
    j_save_ckp({"epoch": 1, "params": params, "batch_stats": stats}, "tc29r5", ckpt, "best")

    pipes = (FingerprintPipeline, JPipeline)
    saved = [p.__init__.__defaults__ for p in pipes]
    overlap = j_builder._ordered_overlap.__defaults__
    FingerprintPipeline.__init__.__defaults__ = (32,) + saved[0][1:]
    JPipeline.__init__.__defaults__ = saved[1][:-3] + (32,) + saved[1][-2:]
    j_builder._ordered_overlap.__defaults__ = (1,) + overlap[1:]
    argv = sys.argv
    try:
        sys.argv = ["e2e_int8_retrieval_signoff.py", "--root", str(ws), "--n_query_db",
                    str(SIGNOFF["n_query_db"]), "--snrs"] + [str(s) for s in SIGNOFF["snrs"]]
        lines = _stdout_of(load_script("e2e_int8_retrieval_signoff").main)
        os.rename(ws / "signoff", ws / "signoff_jax")
        port_lines = []
        port = _stdout_of(lambda: port_lines.append(
            load_script("torch_port_e2e_int8_retrieval_signoff").run(str(ws), device="cpu",
                                                                  **SIGNOFF)))
    finally:
        sys.argv = argv
        for p, d in zip(pipes, saved):
            p.__init__.__defaults__ = d
        j_builder._ordered_overlap.__defaults__ = overlap
    return ws, json.loads(lines[-1]), port_lines[0], port


def _stdout_of(fn):
    """The lines ``fn()`` prints, echoed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    print(buf.getvalue())
    return buf.getvalue().splitlines()


def test_signoff_prints_the_jax_scripts_line(signoff):
    _, want, out, port_lines = signoff
    got = json.loads(port_lines[-1])
    assert got == out["summary"]
    assert got.keys() == want.keys() and got["signoff"] == want["signoff"]
    assert sorted(got["per_snr"]) == sorted(want["per_snr"]) == ["0", "10"]
    for snr, row in got["per_snr"].items():
        assert row.keys() == want["per_snr"][snr].keys()
        assert all(len(v) == 6 for v in row.values())
    assert got["worst_delta_pp"] == min(min(r["top1_exact_delta_pp"] + r["top3_delta_pp"])
                                        for r in got["per_snr"].values())
    for hr in out["hit_rates"].values():
        assert hr.shape == (4, 6) and ((hr >= 0) & (hr <= 100)).all()
    # on the CPU no kernel launches; every build embedded
    assert all(n == 0 for q in out["launches"].values() for n in q.values())
    assert all(n > 0 for n in out["embed_batches"].values())


@pytest.mark.parametrize("quant", ["bf16", "int8_static"])
def test_signoff_dummy_rows_are_the_jax_scripts(signoff, quant):
    ws, _, out, _ = signoff
    got = load_memmap_data(out["dummy_dirs"][quant], "dummy_db", display=False)[0]
    want = load_memmap_data(str(ws / "signoff_jax" / quant / "dummy"), "dummy_db",
                            display=False)[0]
    assert got.shape == want.shape == (16 * 7, 128)
    if quant == "bf16":                     # the tiny config serves f32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
        hold_rows("sign-off bf16 dummy rows vs the JAX script's", got, want)
    else:
        hold_rows("sign-off int8_static dummy rows vs the JAX script's", got, want,
                  TRACK_FLOOR)
    # the clean query-side rows do not depend on the SNR
    dbs = [load_memmap_data(os.path.join(os.path.dirname(out["dummy_dirs"][quant]),
                                         f"snr{s}"), "db", display=False)[0]
           for s in SIGNOFF["snrs"]]
    np.testing.assert_array_equal(dbs[0], dbs[1])
