"""The port's protocol rehearsals on the CPU, at the tiny geometry
(1 kHz, 16 mels, f32): scripts/torch_port_setup_synth_icassp.py against
scripts/setup_synth_icassp.py (the same files from the same arguments),
the r5 sweep scripts/torch_port_e2e_cli_icassp_r5.sh end to end through
the port's CLIs, the port's LAME encoder
(grafp_tpu_torch/native/mp3_native.write) and mp3 corpus against the JAX
package's, and scripts/torch_port_profile_input_pipeline.py on the CPU.

Tolerances: the workspaces' files, the wavs and the mp3 files are equal
byte for byte (the yaml after each root is replaced by a placeholder).
The r5 sweep's hit-rate tables are held to lie in [0, 100]. The sign-off
against the JAX script is in tests/test_torch_port_rehearsals_signoff.py."""

import os
import subprocess
import sys

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from grafp_tpu_torch.native import mp3_native  # noqa: E402
from tests.torch_port_util import load_script as _script  # noqa: E402
from tests.torch_port_util import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the model geometry of the workspaces' --tiny config
TINY = dict(fs=1000, win_len=256, hop_len=128, n_fft=256, n_mels=16, n_frames=8)
# an interpreter for the sweeps that runs the port CLI's main on the CPU:
# without TensorFlow (TensorBoard writes its events without it, and the
# import costs ~17 s a process), its FingerprintPipeline embedding in
# batches of 8, not 256 (the builders embed only full batches, each group
# of up to 8 one-row tracks padded to one; a row does not depend on its
# batch in eval mode)
ON_CPU = """
import importlib, sys
sys.modules["tensorflow"] = None
from grafp_tpu_torch.fp import FingerprintPipeline
assert sys.argv[1] == "-m"
defaults = FingerprintPipeline.__init__.__defaults__
FingerprintPipeline.__init__.__defaults__ = (8,) + defaults[1:]
importlib.import_module(sys.argv[2]).main(sys.argv[3:], device="cpu")
"""


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


@pytest.mark.parametrize("tiny", [True, False], ids=["tiny", "16kHz"])
def test_setup_writes_the_jax_scripts_files(tmp_path, monkeypatch, tiny):
    argv = ["--train_tracks", "3", "--eval_tracks", "5", "--dur", "2.5" if tiny else "1.5",
            "--bsz", "2"] + (["--tiny"] if tiny else [])
    roots = {side: str(tmp_path / side) for side in ("jax", "port")}
    monkeypatch.setattr(sys, "argv", ["setup_synth_icassp.py", "--root", roots["jax"]] + argv)
    _script("setup_synth_icassp").main()
    assert _script("torch_port_setup_synth_icassp").main(["--root", roots["port"]] + argv) == 0
    files = _files(roots["jax"])
    assert files == _files(roots["port"]) and len(files) == 3 + 5 + 24 + 12 + 3
    for name in files:
        want, got = (open(os.path.join(roots[s], name), "rb").read() for s in ("jax", "port"))
        if name == "synth.yaml":
            want, got = (x.decode().replace(roots[s], "ROOT")
                         for x, s in ((want, "jax"), (got, "port")))
        assert got == want, name
    cfg = yaml.safe_load(open(os.path.join(roots["port"], "synth.yaml")))
    assert cfg["fs"] == (1000 if tiny else 16000) and cfg["val_sz"] == 5
    assert cfg["val_dir"].endswith("train_tracks") and cfg["bsz_train"] == 2


# --- the mp3 encoder ---------------------------------------------------------

needs_lame = pytest.mark.skipif(not mp3_native.encoder_available(),
                                reason="libmp3lame is not on this host")


@needs_lame
@pytest.mark.parametrize("shape", [(24000,), (24000, 1), (24000, 2)],
                         ids=["mono", "one-column", "stereo"])
def test_mp3_write_equals_jax(tmp_path, shape):
    """The port's LAME binding writes the JAX package's bytes, on seeded
    input that also goes past full scale (the clip to int16)."""
    from grafp_tpu.native import mp3_native as jmp3

    x = (0.6 * np.random.RandomState(len(shape)).randn(*shape)).astype(np.float32)
    for kbps in (128, 64):
        mp3_native.write(str(tmp_path / "port.mp3"), x, 16000, kbps=kbps)
        jmp3.write(str(tmp_path / "jax.mp3"), x, 16000, kbps=kbps)
        got = (tmp_path / "port.mp3").read_bytes()
        assert len(got) > 1000 and got == (tmp_path / "jax.mp3").read_bytes()
    with pytest.raises(ValueError):
        mp3_native.write(str(tmp_path / "bad.mp3"), np.zeros((10, 3), np.float32), 16000)


@needs_lame
def test_mp3_corpus_equals_the_jax_scripts(tmp_path):
    """build_corpus of the port's input profiler writes the mp3 files of
    scripts/profile_input_pipeline.py's, from the same stream."""
    want = _script("profile_input_pipeline").build_corpus(str(tmp_path / "jax"), 4, 1.5, 8000)
    got = _script("torch_port_profile_input_pipeline").build_corpus(
        str(tmp_path / "port"), 4, 1.5, 8000)
    names = sorted(os.listdir(want))
    assert names == sorted(os.listdir(got)) and len(names) == 4
    for name in names:
        assert open(os.path.join(got, name), "rb").read() == \
            open(os.path.join(want, name), "rb").read(), name


@pytest.mark.skipif(not (mp3_native.encoder_available() and mp3_native.decoder_available()),
                    reason="libmp3lame or libmpg123 is not on this host")
def test_input_profiler_on_the_cpu(tmp_path):
    prof = _script("torch_port_profile_input_pipeline")
    out = prof.run(str(tmp_path), tracks=4, dur=2.0, bsz=2, master_sr=8000, threads=2,
                   device="cpu", compute_dtype="float32", **TINY)
    rates = [out["device_pairs_per_s"], *out["micro"].values(), *out["epochs"].values()]
    assert len(out["epochs"]) == 7 and all(np.isfinite(r) and r > 0 for r in rates)
    assert sorted(os.listdir(tmp_path / "decoded_cache")) == sorted(
        f"{i}{ext}" for i in range(4) for ext in (".npy", ".norm.npy"))


@pytest.mark.parametrize("name", ["torch_port_e2e_int8_retrieval_signoff",
                                  "torch_port_profile_input_pipeline"])
def test_drivers_default_to_the_card(tmp_path, name):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        _script(name).run(str(tmp_path))


# --- the r5 sweep end to end -------------------------------------------------

def _repo_state():
    out = {}
    for d in ("checkpoint", "logs", "runs"):
        for root, _, files in os.walk(os.path.join(REPO, d)):
            for f in files:
                out[os.path.join(root, f)] = os.stat(os.path.join(root, f)).st_mtime_ns
    return out


@pytest.fixture(scope="module")
def r5_run(tmp_path_factory):
    """torch_port_e2e_cli_icassp_r5.sh for 1 epoch on a tiny workspace:
    8 train tracks of 12 s (validation's 2 query tracks must give more rows
    than its longest sequence, 19) and 410 eval tracks of 1.1 s, one row
    each (the sweep's 400 query tracks; 10 dummy tracks), written by two
    calls of the port's setup (the second reuses the train tracks)."""
    setup = _script("torch_port_setup_synth_icassp").setup
    ws = tmp_path_factory.mktemp("r5")
    setup(str(ws), train_tracks=8, eval_tracks=0, dur=12.0, bsz=4, tiny=True)
    setup(str(ws), train_tracks=8, eval_tracks=410, dur=1.1, bsz=4, tiny=True)
    (ws / "on_cpu.py").write_text(ON_CPU)
    before = _repo_state()
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
           "PYTHON": f"{sys.executable} {ws / 'on_cpu.py'}"}
    out = subprocess.run(["bash", os.path.join(REPO, "scripts", "torch_port_e2e_cli_icassp_r5.sh"),
                          str(ws), "1"], cwd=ws, env=env, capture_output=True, text=True,
                         timeout=900)
    return ws, out, before


def test_r5_sweep_end_to_end(r5_run):
    ws, out, before = r5_run
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert out.stdout.rstrip().endswith("==== done ====")
    run = ws / "run"
    for tag in ("best", "current"):
        assert (run / "checkpoint" / f"model_tc29r5_{tag}.pth").is_file()
    assert yaml.safe_load(open(ws / "test_config.yaml")) == {"tc29r5": ["best"]}
    evalcfg = yaml.safe_load(open(ws / "synth_eval.yaml"))
    assert evalcfg["scan_topk"] == "approx" and evalcfg["scan_recall"] == 0.99
    # one dummy DB, reused by the five rows after the first; one sanir row
    assert out.stdout.count("=> Computing dummy fingerprints...") == 1
    assert out.stdout.count("=> Skipping dummy db creation...") == 5
    assert out.stdout.count("Queries without IR augmentation!") == 1
    assert out.stdout.count("-------Validation hit-rates-------") == 1
    store = run / "logs" / "store"
    tables = [np.load(os.path.join(d, "hit_rates.npy")) for d, _, files in
              os.walk(store / "medium" / "model_tc29r5_best") if "hit_rates.npy" in files]
    assert len(tables) == 6 and out.stdout.count("-------Test hit-rates-------") == 6
    assert os.listdir(store) == ["medium", "valid"] or sorted(os.listdir(store)) == [
        "medium", "valid"]
    for hr in tables:
        assert hr.shape == (4, 6) and np.isfinite(hr).all()
        assert ((hr >= 0) & (hr <= 100)).all() and (hr[3] >= hr[0]).all()
    assert _repo_state() == before


def test_rehearsals_script_parses():
    """scripts/torch_port_rehearsals.sh, which runs the rehearsals at their
    defaults on the card only, at least parses."""
    path = os.path.join(REPO, "scripts", "torch_port_rehearsals.sh")
    assert subprocess.run(["bash", "-n", path]).returncode == 0
