"""Data-parallel training of the port across two gloo processes on the CPU,
against the JAX package's single-device step and the port's one-process
step, on the tiny geometry of tests/test_train_step.py at a global B = 8.

The two ranks are this file run as a script (``__main__`` below), spawned
once for the module on a free localhost port; each passes its own 4 rows
to ``make_train_step`` under a gloo process group. The scenarios:

* 'plain': one f32 step, no augment, DropPath off. Against JAX's
  ``make_train_step`` (without the augment) on the same numpy inputs and
  weights: the loss within rel 1e-5 and the grad norm within rel 1e-2,
  JAX's own tolerance for its sharded step (tests/test_train_step.py:83).
* 'cross_replica': 'plain' with ``bn_cross_replica=True``, which changes
  nothing (the JAX CLI never passes an axis name): bit-equal to 'plain'.
* 'ramp': two steps with synthetic noise and IR banks and DropPath rising
  to 0.1. Against the port's one-process step on the 8 rows: losses
  within rel 1e-5, the grad norms within rel 1e-3, the BatchNorm running
  statistics within 1e-6 + 5e-6 |x| (1e-6 + 1e-6 |x| after 'plain''s one
  step); the two ranks' parameters and statistics bit-equal to each other.

The one-process and two-rank runs differ by f32 rounding only: the
statistics' sums are split over the ranks, and a CPU product of 4 rows
rounds differently from one of 8 (measured: 1.1e-6 at a running variance
of 1.55 after one step, 2.5e-6 at 1.29 after two, whose forward also sees
the first update's sign noise; losses 1e-6 apart). A small lr keeps the
second step comparable.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.torch_port_util import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# a small lr keeps two steps comparable: Adam's first update is ~lr x
# sign(g), and where g ~ 0 its sign is rounding noise (tests/test_torch_port_train.py)
TINY = dict(fs=1000, win_len=256, hop_len=128, n_fft=256, n_mels=16,
            n_frames=8, bsz_train=8, lr=2e-7, min_lr=2e-8, T_max=2)
B, WORLD = 8, 2
SCENARIOS = {
    "plain": dict(cfg={}, steps=1, banks=False),
    "cross_replica": dict(cfg={"bn_cross_replica": True}, steps=1, banks=False),
    "ramp": dict(cfg={"drop_path_schedule": "ramp", "drop_path": 0.1}, steps=2,
                 banks=True),
}


def _banks(data):
    from grafp_tpu_torch.dsp.augment import AugmentBanks

    return AugmentBanks.from_arrays(noise_clips=list(data["noise"]),
                                    ir_clips=list(data["irs"]), noise_len=2048)


def run_scenarios(data: dict, rank: int, world: int) -> dict:
    """Every scenario on this process's rows of the global batch (all of
    them when world is 1): {scenario: {"loss", "grad_norm" per step,
    "params", "stats"}}."""
    from grafp_tpu_torch.core import Config
    from grafp_tpu_torch.models import build_model
    from grafp_tpu_torch.train import create_train_state, make_train_step

    b = B // world
    mine = slice(rank * b, (rank + 1) * b)
    out = {}
    for name, sc in SCENARIOS.items():
        cfg = Config(**TINY, **sc["cfg"])
        model = build_model(cfg, device="cpu", train=True)
        model.load_state_dict(data["state_dict"])
        state = create_train_state(model, cfg, steps_per_epoch=1)
        step = make_train_step(model, cfg, _banks(data) if sc["banks"] else None,
                               device="cpu")
        losses, norms = [], []
        for s in range(sc["steps"]):
            m = step(state, data["x_i"][mine], data["x_j"][mine],
                     torch.Generator().manual_seed(100 + s))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[name] = {"loss": losses, "grad_norm": norms,
                     "params": {k: p.detach().clone() for k, p in model.named_parameters()},
                     "stats": {k: v.clone() for k, v in model.named_buffers()
                               if k.endswith(("running_mean", "running_var"))}}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_torch_thread):
    """(JAX's 'plain' loss and grad norm, the one-process runs, rank 0's
    and rank 1's runs). The ranks run while this process computes JAX's
    step and the one-process runs."""
    import jax
    import jax.numpy as jnp

    from grafp_tpu.core.config import Config as JConfig
    from grafp_tpu.models import build_model as j_build_model
    from grafp_tpu.train.state import TrainState as JTrainState
    from grafp_tpu.train.state import make_optimizer as j_make_optimizer
    from grafp_tpu.train.step import make_train_step as j_make_train_step
    from grafp_tpu_torch.convert import state_dict_from_jax
    from grafp_tpu_torch.core import Config
    from grafp_tpu_torch.models import build_model
    from tests.torch_port_util import jax_variables_from_port, randomize_jax_variables

    rs = np.random.RandomState(0)
    x_i = rs.randn(B, TINY["fs"]).astype(np.float32)
    x_j = (x_i + 0.3 * rs.randn(B, TINY["fs"])).astype(np.float32)
    port = build_model(Config(**TINY), generator=torch.Generator().manual_seed(0),
                       device="cpu", train=True)
    jcfg = JConfig(**TINY)
    jm = j_build_model(jcfg)
    shapes = jax.eval_shape(lambda k: jm.init({"params": k}, jnp.zeros((2, 16, 8)), False),
                            jax.random.key(0))
    params, stats = randomize_jax_variables(*jax_variables_from_port(port, shapes), seed=1)
    data = {"x_i": torch.from_numpy(x_i), "x_j": torch.from_numpy(x_j),
            "state_dict": state_dict_from_jax(params, stats, port),
            "noise": [rs.randn(3000).astype(np.float32) for _ in range(3)],
            "irs": [(rs.randn(300) * np.exp(-np.arange(300) / 40.0)).astype(np.float32)
                    for _ in range(2)]}
    work = tmp_path_factory.mktemp("ddp")
    torch.save(data, work / "inputs.pt")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port_no = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(WORLD), str(port_no), str(work)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(WORLD)]

    # JAX's single-device step, the augment off (banks=None), on the same
    # weights and rows
    tx = j_make_optimizer(jcfg, 1)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                         batch_stats=jax.tree.map(jnp.asarray, stats),
                         opt_state=tx.init(jparams), tx=tx, apply_fn=jm.apply)
    _, m = j_make_train_step(jm, jcfg, banks=None, donate=False)(
        jstate, jnp.asarray(x_i), jnp.asarray(x_j), jax.random.key(0))
    jax_plain = (float(m["loss"]), float(m["grad_norm"]))
    one = run_scenarios(data, 0, 1)

    ranks = []
    for r, p in enumerate(procs):
        log, _ = p.communicate(timeout=300)
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
        ranks.append(torch.load(work / f"rank{r}.pt"))
    return jax_plain, one, ranks


def test_two_rank_step_matches_jax(runs):
    (loss_j, gnorm_j), _, ranks = runs
    for got in ranks:
        np.testing.assert_allclose(got["plain"]["loss"][0], loss_j, rtol=1e-5)
        np.testing.assert_allclose(got["plain"]["grad_norm"][0], gnorm_j, rtol=1e-2)


@pytest.mark.parametrize("scenario,stats_rtol", [("plain", 1e-6), ("ramp", 5e-6)])
def test_two_rank_steps_match_one_process(runs, scenario, stats_rtol):
    _, one, ranks = runs
    want = one[scenario]
    for got in ranks:
        np.testing.assert_allclose(got[scenario]["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got[scenario]["grad_norm"], want["grad_norm"],
                                   rtol=1e-3)
        for k, v in want["stats"].items():
            np.testing.assert_allclose(got[scenario]["stats"][k].numpy(), v.numpy(),
                                       rtol=stats_rtol, atol=1e-6, err_msg=k)
    # every rank ends with the same bits
    assert ranks[0][scenario]["loss"] == ranks[1][scenario]["loss"]
    for k, v in ranks[0][scenario]["params"].items():
        assert torch.equal(v, ranks[1][scenario]["params"][k]), k
    for k, v in ranks[0][scenario]["stats"].items():
        assert torch.equal(v, ranks[1][scenario]["stats"][k]), k


def test_bn_cross_replica_changes_nothing(runs):
    _, one, ranks = runs
    for got in ranks + [one]:
        a, b = got["plain"], got["cross_replica"]
        assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
        for k, v in a["params"].items():
            assert torch.equal(v, b["params"][k]), k


if __name__ == "__main__":
    rank_, world_, port_, work_ = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    from grafp_tpu_torch.parallel import initialize_distributed

    joined = initialize_distributed(f"localhost:{port_}", world_, rank_, device="cpu")
    assert joined, "no process group"
    result = run_scenarios(torch.load(os.path.join(work_, "inputs.pt"), weights_only=False),
                           rank_, world_)
    torch.save(result, os.path.join(work_, f"rank{rank_}.pt"))
    torch.distributed.destroy_process_group()
