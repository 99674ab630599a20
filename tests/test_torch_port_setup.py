"""The port's reproduction entry points on the CPU: ``cli.setup_config`` and
``cli.setup_icassp`` against the root setup_config.py and setup_icassp.py
(the same files written from the same inputs), and the sweeps under
scripts/torch_port_*.sh: each passes ``bash -n``; run with an interpreter
that records instead of running, every command line it would run is
accepted by the port CLI's own argparse, in the originals' number; the
rehearsal sweeps (torch_port_e2e_*.sh) run the same flags from the same
working directories as their JAX originals (scripts/e2e_*.sh), recorded
the same way; and torch_port_test_pipeline.sh end to end on a tiny corpus
with a port checkpoint, its CLI run on the CPU."""

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from grafp_tpu_torch.cli import setup_config, setup_icassp  # noqa: E402
from tests.fixtures import make_wav_dir  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# script -> (arguments, command lines it runs, the checkpoint link it makes);
# "{T}" in an argument is the test's working directory
LINK = "checkpoint/model_tc_29_best.pth"
R5_LINK = "checkpoint/model_tc29r5_best.pth"
SWEEPS = {
    "torch_port_icassp.sh": (["AUDIO/fma_medium", "AUG", "CKPT"], 22, LINK),
    "torch_port_ablation.sh": (["10", "CKPT"], 4, LINK),
    "torch_port_test_pipeline.sh": (["10", "CKPT"], 1, LINK),
    "torch_port_baselines_ablation.sh": (["5", "CKPT"], 4, LINK),
    "torch_port_baselines_test_pipeline.sh": ([], 1, None),
    "torch_port_e2e_cli_icassp.sh": (["{T}/ROOT", "2"], 7, None),
    "torch_port_e2e_cli_icassp_r4.sh": (["{T}/ROOT", "2"], 7, None),
    "torch_port_e2e_cli_icassp_r5.sh": (["{T}/ROOT", "2"], 7, None),
    "torch_port_e2e_cli_icassp_7m.sh": (["{T}/ROOT", "{T}/R5ROOT"], 1,
                                        "ROOT/run/" + R5_LINK),
    "torch_port_e2e_int8_signoff.sh": (["{T}/ROOT", "{T}/R5ROOT"], 6,
                                       "ROOT/run_int8_static/" + R5_LINK),
    "torch_port_e2e_train_input_mp3.sh": (["{T}/ROOT", "2"], 3, None),
}
# an interpreter for the sweeps that records each command line instead of
# running it; the test then parses them with the port CLIs' argparse
RECORD = """
import json, os, sys
with open(sys.argv[1], "a") as f:
    f.write(json.dumps([os.getcwd()] + sys.argv[2:]) + "\\n")
"""
# an interpreter that runs the port CLI's main on the CPU, its
# FingerprintPipeline embedding in batches of 32, not 256: the builders
# embed only full batches (each group's last one zero-padded), a row does
# not depend on its batch (eval mode), and at 256 the 2-row tracks below
# would spend most of the time on padding rows
ON_CPU = """
import importlib, sys
from grafp_tpu_torch.fp import FingerprintPipeline
assert sys.argv[1] == "-m"
defaults = FingerprintPipeline.__init__.__defaults__
FingerprintPipeline.__init__.__defaults__ = (32,) + defaults[1:]
importlib.import_module(sys.argv[2]).main(sys.argv[3:], device="cpu")
"""


def _root_script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _parse(argv):
    """Parse one recorded command line (``-m module args...``) with the
    argparse of the port CLI that it runs; argparse exits on a flag it
    does not know."""
    from grafp_tpu_torch.cli import baseline_test_fp, test_fp_main, train_main
    from grafp_tpu_torch.cli.baseline_train import with_defaults

    assert argv[0] == "-m", argv
    name, args = argv[1], argv[2:]
    if name == "grafp_tpu_torch.cli.train":
        return train_main.build_argparser().parse_args(args)
    if name == "grafp_tpu_torch.cli.baseline_test_fp":
        return test_fp_main.build_argparser().parse_args(
            with_defaults(args, baseline_test_fp.DEFAULTS))
    return {"grafp_tpu_torch.cli.test_fp": test_fp_main,
            "grafp_tpu_torch.cli.setup_config": setup_config,
            "grafp_tpu_torch.cli.setup_icassp": setup_icassp}[name].build_argparser(
    ).parse_args(args)


def _env():
    return {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}


def _sweep_inputs(tmp_path):
    """What the sweeps read before their CLIs run: a checkpoint dir CKPT,
    r5's trained checkpoint (the port's .pth and the JAX package's Orbax
    dir) under R5ROOT, a workspace config ROOT/synth.yaml and an (empty)
    mp3 corpus ROOT/mp3_tracks."""
    os.makedirs(tmp_path / "CKPT")
    (tmp_path / "CKPT" / "model_tc_29_best.pth").write_bytes(b"")
    ckpt = tmp_path / "R5ROOT" / "run" / "checkpoint"
    os.makedirs(ckpt / "model_tc29r5_best")
    (ckpt / "model_tc29r5_best.pth").write_bytes(b"")
    os.makedirs(tmp_path / "ROOT" / "mp3_tracks")
    shutil.copy(os.path.join(REPO, "config", "grafp.yaml"), tmp_path / "ROOT" / "synth.yaml")


def _record(tmp_path, path, args, python=None):
    """Run the sweep at ``path`` from ``tmp_path`` with the recording
    interpreter as PYTHON (and, where ``python`` is given, as ``python``
    on PATH too, which forwards ``python -`` to this interpreter); returns
    the recorded (cwd, argv) lines."""
    (tmp_path / "record.py").write_text(RECORD)
    log = tmp_path / "lines.jsonl"
    env = {**_env(), "PYTHON": f"{sys.executable} {tmp_path / 'record.py'} {log}"}
    if python:
        os.makedirs(tmp_path / "bin")
        (tmp_path / "bin" / "python").write_text(
            f'#!/bin/bash\nif [ "$1" = - ]; then exec {sys.executable} "$@"; fi\n'
            f'exec {sys.executable} {tmp_path / "record.py"} {log} "$@"\n')
        os.chmod(tmp_path / "bin" / "python", 0o755)
        env["PATH"] = f"{tmp_path / 'bin'}:{env['PATH']}"
    args = [a.replace("{T}", str(tmp_path)) for a in args]
    out = subprocess.run(["bash", path] + args, cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    if not log.exists():
        return []
    return [json.loads(x) for x in log.read_text().splitlines()]


@pytest.mark.parametrize("dirs", [{}, {"train_dir": "/data/train", "val_dir": "/data/val"}])
def test_setup_config_writes_the_root_scripts_yamls(tmp_path, dirs, monkeypatch):
    root = _root_script("setup_config")
    for name in ("jax", "port"):
        shutil.copytree(os.path.join(REPO, "config"), tmp_path / name / "config")
    flags = {"train_dir": None, "val_dir": None, **dirs,
             "noise_dir": "/aug/noise", "ir_dir": "/aug/ir"}
    monkeypatch.chdir(tmp_path / "jax")
    root.main(argparse.Namespace(**flags))
    monkeypatch.chdir(tmp_path / "port")
    setup_config.main([f"--{k}={v}" for k, v in flags.items() if v is not None])
    for cfg in ("grafp.yaml", "ast.yaml"):
        want = (tmp_path / "jax" / "config" / cfg).read_text()
        assert (tmp_path / "port" / "config" / cfg).read_text() == want
        loaded = yaml.safe_load(want)
        assert loaded["noise_dir"] == "/aug/noise" and loaded["ir_dir"] == "/aug/ir"
        assert loaded["train_dir"] == dirs.get("train_dir", "PATH/TO/TRAINING/DATA")
    with pytest.raises(SystemExit):
        setup_config.main(["--noise_dir", "/n"])            # --ir_dir is required


def test_setup_icassp_writes_the_root_scripts_indexes(tmp_path, monkeypatch):
    root = _root_script("setup_icassp")
    for name in ("jax", "port"):
        os.makedirs(tmp_path / name / "data")
        for idx, old in (("fma_medium", "/old/fma_medium/000/1.mp3"),
                         ("ir", "/old/ir/a/1.wav"), ("noise", "/old/noise/b/2.wav")):
            with open(tmp_path / name / "data" / f"{idx}.json", "w") as f:
                json.dump({"0": old, "1": old.replace("1.", "3.")}, f)
    argv = ["--test_dir", "/new/fma_medium", "--ir_dir", "/new/ir",
            "--noise_dir", "/new/noise", "--eval_type", "fma_medium"]
    monkeypatch.chdir(tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", ["setup_icassp.py"] + argv)
    root.main()
    monkeypatch.chdir(tmp_path / "port")
    setup_icassp.main(argv)
    for idx in ("fma_medium", "ir", "noise"):
        want = (tmp_path / "jax" / "data" / f"{idx}.json").read_text()
        assert (tmp_path / "port" / "data" / f"{idx}.json").read_text() == want
    assert json.loads(want)["0"] == "/new/noise/b/2.wav"
    for d in ("data", "checkpoint", "runs"):
        assert (tmp_path / "port" / d).is_dir()


@pytest.mark.parametrize("script", sorted(SWEEPS))
def test_sweep_command_lines_parse(tmp_path, script):
    args, n_lines, link = SWEEPS[script]
    path = os.path.join(REPO, "scripts", script)
    assert subprocess.run(["bash", "-n", path]).returncode == 0
    _sweep_inputs(tmp_path)
    lines = [argv for _, *argv in _record(tmp_path, path, args)]
    assert len(lines) == n_lines, lines
    parsed = [_parse(line) for line in lines]
    if script.startswith("torch_port_baselines"):
        assert all(a.encoder == "ast" and a.config == "config/ast.yaml" for a in parsed)
    if link:                              # the checkpoint is linked, not copied
        assert os.path.islink(tmp_path / link)


# port sweep -> its JAX original under scripts/, and the CLI module each
# original script stands for
ORIGINALS = {f"torch_port_{name}.sh": f"{name}.sh" for name in (
    "e2e_cli_icassp", "e2e_cli_icassp_r4", "e2e_cli_icassp_r5", "e2e_cli_icassp_7m",
    "e2e_int8_signoff", "e2e_train_input_mp3")}
MODULES = {"train.py": "grafp_tpu_torch.cli.train", "test_fp.py": "grafp_tpu_torch.cli.test_fp"}


@pytest.mark.parametrize("script", sorted(ORIGINALS))
def test_rehearsal_sweeps_run_the_originals_command_lines(tmp_path, script):
    """Each rehearsal sweep runs, from the same working directory (relative
    to its ROOT), the same CLI with the same flags as its JAX original, in
    the same order: the originals' SNR rows, unique names and isolated
    working directories."""
    args = SWEEPS[script][0]
    got = {}
    for side, name in (("port", script), ("jax", ORIGINALS[script])):
        os.makedirs(tmp_path / side)
        _sweep_inputs(tmp_path / side)
        lines = _record(tmp_path / side, os.path.join(REPO, "scripts", name), args,
                        python=side == "jax")
        got[side] = [[x.replace(str(tmp_path / side), "{T}") for x in line]
                     for line in lines]
    assert len(got["jax"]) == len(got["port"]) == SWEEPS[script][1]
    for (jcwd, prog, *jflags), (cwd, dash_m, module, *flags) in zip(got["jax"],
                                                                     got["port"]):
        assert cwd == jcwd and dash_m == "-m" and flags == jflags, (jcwd, prog, jflags)
        assert module == MODULES[os.path.basename(prog)]


def test_test_pipeline_sweep_end_to_end(tmp_path):
    """torch_port_test_pipeline.sh on 510 tracks of 1.1 s at 1 kHz (the
    script asks for 500 query tracks; tc_29's overlap 0.9 gives each 2
    segments) with an untrained seeded checkpoint
    passed as the checkpoint directory: tc_29's preset, exact 'l2' search,
    the hit rates written under logs/store."""
    from grafp_tpu_torch.core import Config
    from grafp_tpu_torch.models import build_model
    from grafp_tpu_torch.train.checkpoint import save_ckp

    fs = 1000
    paths = make_wav_dir(str(tmp_path / "audio"), n=510, dur_s=1.1, sr=fs, seed=5)
    make_wav_dir(str(tmp_path / "noise"), n=4, dur_s=3.0, sr=fs, seed=3, kind="noise")
    make_wav_dir(str(tmp_path / "ir"), n=3, dur_s=0.25, sr=fs, seed=4, kind="ir")
    os.makedirs(tmp_path / "data")
    os.makedirs(tmp_path / "config")
    with open(tmp_path / "data" / "fma_medium.json", "w") as f:
        json.dump({str(i): p for i, p in enumerate(paths)}, f)
    np.save(tmp_path / "data" / "fma_medium_indices.npy",
            np.random.RandomState(0).permutation(len(paths)))
    np.save(tmp_path / "data" / "medeval_ids.npy", np.arange(0, 4000, 40))
    geometry = dict(fs=fs, win_len=256, hop_len=128, n_fft=256, n_mels=16, n_frames=8)
    with open(tmp_path / "config" / "grafp.yaml", "w") as f:
        yaml.safe_dump({**geometry, "data_dir": "data", "noise_dir": str(tmp_path / "noise"),
                        "ir_dir": str(tmp_path / "ir")}, f)
    shutil.copy(os.path.join(REPO, "config", "test_config.yaml"), tmp_path / "config")
    model = build_model(Config(**geometry), generator=torch.Generator().manual_seed(0),
                        device="cpu")
    save_ckp({"state_dict": model.state_dict()}, "tc_29", str(tmp_path / "trained"), "best")
    (tmp_path / "on_cpu.py").write_text(ON_CPU)
    env = {**_env(), "PYTHON": f"{sys.executable} {tmp_path / 'on_cpu.py'}"}
    out = subprocess.run(["bash", os.path.join(REPO, "scripts", "torch_port_test_pipeline.sh"),
                          "10", "trained"], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "Top-1 exact hit rate" in out.stdout
    saved = [os.path.join(r, "hit_rates.npy") for r, _, fs_ in
             os.walk(tmp_path / "logs" / "store") if "hit_rates.npy" in fs_]
    assert len(saved) == 1
    hr = np.load(saved[0])
    assert hr.shape == (4, 4) and ((hr >= 0) & (hr <= 100)).all()
    assert (hr[3] >= hr[2]).all() and (hr[2] >= hr[0]).all()
