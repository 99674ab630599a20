"""train_main data parallel on the CPU: ``python -m torch.distributed.run
--nproc_per_node 2`` over the port's train CLI (its ``main`` on the CPU, so
gloo), on the tiny wav corpus of tests/test_torch_port_cli.py at a global
batch of 4 (2 rows a rank, 2 steps an epoch), beside the one-process run
of the same command. From one seeded epoch-0 checkpoint one process and two
ranks each ``--resume`` and train an epoch, with validation.

* The two ranks' epoch loss within rel 1e-4 of the one process's (the lr
  is small, so that Adam's sign noise on near-zero gradients cannot part
  the two runs within an epoch: tests/test_torch_port_distributed.py).
* ``--resume`` loads on both ranks; rank 0 alone validates and writes the
  checkpoints (the files of the one-process run, under its own name).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from grafp_tpu_torch.core import load_config  # noqa: E402
from grafp_tpu_torch.models import build_model  # noqa: E402
from grafp_tpu_torch.train import create_train_state  # noqa: E402
from grafp_tpu_torch.train.checkpoint import load_ckp, save_ckp, train_payload  # noqa: E402
from tests.fixtures import make_wav_dir  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 1000
ON_CPU = """
import sys
from grafp_tpu_torch.cli import train_main
train_main.main(sys.argv[1:], device="cpu")
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(ws, argv, ranks):
    """The train CLI on the CPU in ``ranks`` processes (torchrun when more
    than one), from the workspace; returns the Popen."""
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, str(ws / "on_cpu.py")] + argv
    if ranks > 1:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
               "--nproc_per_node", str(ranks), "--master_addr", "localhost",
               "--master_port", str(_free_port()), str(ws / "on_cpu.py")] + argv
    return subprocess.Popen(cmd, cwd=ws, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _wait(proc, what):
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, f"{what} failed:\n{out[-6000:]}"
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ws = tmp_path_factory.mktemp("ddp_cli")
    make_wav_dir(str(ws / "train_audio"), n=8, dur_s=6.0, sr=FS, seed=1)
    make_wav_dir(str(ws / "val_audio"), n=6, dur_s=12.0, sr=FS, seed=2)
    make_wav_dir(str(ws / "noise"), n=4, dur_s=3.0, sr=FS, seed=3, kind="noise")
    make_wav_dir(str(ws / "ir"), n=3, dur_s=0.25, sr=FS, seed=4, kind="ir")
    os.makedirs(ws / "data")
    cfg = {
        "data_dir": "data", "train_dir": str(ws / "train_audio"),
        "val_dir": str(ws / "val_audio"), "noise_dir": str(ws / "noise"),
        "ir_dir": str(ws / "ir"), "fs": FS, "win_len": 256, "hop_len": 128,
        "n_mels": 16, "n_fft": 256, "n_frames": 8, "overlap": 0.5, "train_sz": 8,
        "val_sz": 6, "bsz_train": 4, "lr": 2.0e-7, "min_lr": 2.0e-8, "T_max": 2,
        "n_epochs": 2, "n_dummy": 4, "n_query": 2,
    }
    with open(ws / "tiny.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    (ws / "on_cpu.py").write_text(ON_CPU)
    model = build_model(load_config(str(ws / "tiny.yaml")),
                        generator=torch.Generator().manual_seed(0), device="cpu", train=True)
    state = create_train_state(model, load_config(str(ws / "tiny.yaml")), steps_per_epoch=2)
    save_ckp(train_payload(state, 0, [], []), "start", str(ws / "checkpoint"), "current")
    argv = ["--config", "tiny.yaml", "--seed", "42", "--epochs", "1", "--validate_every",
            "1", "--resume", "checkpoint/model_start_current.pth"]
    one = _launch(ws, argv + ["--ckp", "one"], 1)
    two = _launch(ws, argv + ["--ckp", "two"], 2)
    return {"ws": ws, "one": _wait(one, "one process"), "two": _wait(two, "two ranks")}


def test_two_ranks_follow_the_one_process_run(runs):
    ws = runs["ws"]
    one = load_ckp(str(ws / "checkpoint" / "model_one_current.pth"))
    two = load_ckp(str(ws / "checkpoint" / "model_two_current.pth"))
    assert one["epoch"] == two["epoch"] == 1 and one["step"] == two["step"] == 2
    assert len(two["loss"]) == 1 and all(np.isfinite(two["loss"]))
    np.testing.assert_allclose(two["loss"], one["loss"], rtol=1e-4)
    assert runs["two"].count("=> loading checkpoint") == 2          # on every rank
    # both ranks report the global batch's loss
    steps = [line for line in runs["two"].splitlines() if line.startswith("Step [0/2]")]
    assert len(steps) == 2 and steps[0] == steps[1]


def test_rank_0_alone_validates_and_saves(runs):
    ws = runs["ws"]
    assert runs["one"].count("-------Validation hit-rates-------") == 1
    assert runs["two"].count("-------Validation hit-rates-------") == 1
    files = os.listdir(ws / "checkpoint")
    assert ({f.replace("model_two_", "") for f in files if f.startswith("model_two_")}
            == {f.replace("model_one_", "") for f in files if f.startswith("model_one_")})
    assert "model_two_current.pth" in files
    assert not [f for f in files if f.endswith(".tmp")]
    assert len(os.listdir(ws / "runs" / "two")) == 1
