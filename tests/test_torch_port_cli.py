"""The port's CLIs end to end on the CPU (grafp_tpu_torch/cli/*), on a tiny
synthesised corpus at the 1 kHz geometry of tests/test_cli_e2e.py: train 2
epochs with validation -> resume to epoch 3 -> test_fp --small_test ->
generate, in-process ``main(argv, device="cpu")`` calls from a temp working
directory, so that the repo's checkpoint/ and logs/ are never touched.

Tolerances: the resumed run's parameters, BatchNorm statistics, Adam state
and step equal an uninterrupted 3-epoch run's bit for bit (the CPU is
deterministic; the augment's generator is seeded per (seed, epoch, step));
test_fp's hit rates equal ``eval_faiss`` on its fingerprint dir exactly;
generate's rows against ``FingerprintPipeline.fingerprint_track`` of each
track, max |d| <= 1e-3 on unit-norm rows (packing tracks changes the CPU
product's blocking, tests/test_torch_port_db.py) and each row nearer its
own row than any other.

The JAX package's CLIs run on the same wav dirs with the same weights (the
port's trained checkpoint saved as the JAX package's Orbax checkpoint):
generate's fingerprints.npy and test_fp's clean DBs (dummy_db.mm and
db.mm, which the frozen split and the track order decide) against the
port's, max |d| <= 1e-3 and each row nearer its own row than any other, so
that a shifted, swapped or misordered row fails. No cosine floor applies
there: the fixture tracks are stationary, so two rows of a track lie at
cosines up to 0.99997 and no floor could tell them apart. (The corrupted
query DBs differ by construction: each package draws its augmentations from
its own generator.)"""

import os

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from grafp_tpu_torch.cli import generate_main, test_fp_main, train_main  # noqa: E402
from grafp_tpu_torch.core import load_config  # noqa: E402
from grafp_tpu_torch.data.dataset import FingerprintDataset  # noqa: E402
from grafp_tpu_torch.fp import FingerprintPipeline  # noqa: E402
from grafp_tpu_torch.models import build_model  # noqa: E402
from grafp_tpu_torch.retrieval.evaluate import eval_faiss  # noqa: E402
from grafp_tpu_torch.train.checkpoint import load_ckp  # noqa: E402
from grafp_tpu_torch.retrieval.memmap_io import load_memmap_data  # noqa: E402
from tests.fixtures import make_wav_dir  # noqa: E402
from tests.torch_port_util import (  # noqa: E402
    hold_rows,
    jax_variables_from_port,
    one_torch_thread,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FS = 1000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _repo_state():
    out = {}
    for d in ("checkpoint", "logs", "runs"):
        for root, _, files in os.walk(os.path.join(REPO, d)):
            for f in files:
                p = os.path.join(root, f)
                out[p] = os.stat(p).st_mtime_ns
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The workspace and the runs: 'a' trains 2 epochs with validation and
    resumes to 3 without; 'b' trains 3 epochs in one run."""
    ws = tmp_path_factory.mktemp("ws")
    make_wav_dir(str(ws / "train_audio"), n=8, dur_s=6.0, sr=FS, seed=1)
    make_wav_dir(str(ws / "val_audio"), n=6, dur_s=12.0, sr=FS, seed=2)
    make_wav_dir(str(ws / "noise"), n=4, dur_s=3.0, sr=FS, seed=3, kind="noise")
    make_wav_dir(str(ws / "ir"), n=3, dur_s=0.25, sr=FS, seed=4, kind="ir")
    os.makedirs(ws / "data")
    cfg = {
        "data_dir": "data", "train_dir": str(ws / "train_audio"),
        "val_dir": str(ws / "val_audio"), "noise_dir": str(ws / "noise"),
        "ir_dir": str(ws / "ir"), "arch": "grafp", "fs": FS, "dur": 1.0,
        "offset": 0.05, "norm": 0.95, "win_len": 256, "hop_len": 128, "n_mels": 16,
        "n_fft": 256, "silence": 0.0005, "blur_kernel": [7, 7], "train_sz": 8,
        "val_sz": 6, "bsz_train": 4, "peak_stride": 2, "n_filters": 8, "tau": 0.05,
        "lr": 8.0e-5, "min_lr": 7.0e-7, "n_epochs": 2, "T_max": 400,
        "error_threshold": 5, "n_frames": 8, "overlap": 0.5, "tr_snr": [0, 20],
        "val_snr": [5, 5], "test_snr": [19, 21], "noise_prob": 1.0, "ir_prob": 1.0,
        "d": 128, "h": 1024, "u": 32, "n_dummy": 4, "n_query": 2,
    }
    with open(ws / "tiny.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    with open(ws / "tiny_test_config.yaml", "w") as f:
        yaml.safe_dump({"a": ["current"]}, f)
    before = _repo_state()
    cwd = os.getcwd()
    os.chdir(ws)
    try:
        common = ["--config", "tiny.yaml", "--seed", "42"]
        out = {"ws": ws, "before": before}
        out["a2"] = train_main.main(common + ["--ckp", "a", "--epochs", "2",
                                              "--validate_every", "1"], device="cpu")
        out["a2_payload"] = load_ckp("checkpoint/model_a_current.pth")
        out["a3"] = train_main.main(common + ["--ckp", "a", "--epochs", "3",
                                              "--resume", "checkpoint/model_a_current.pth",
                                              "--validate_every", "0"], device="cpu")
        out["b3"] = train_main.main(common + ["--ckp", "b", "--epochs", "3",
                                              "--validate_every", "0"], device="cpu")
        yield out
    finally:
        os.chdir(cwd)


def test_train_writes_checkpoints_and_logs(runs):
    ws, a2 = runs["ws"], runs["a2"]
    for tag in ("current", "best"):
        assert (ws / "checkpoint" / f"model_a_{tag}.pth").exists()
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(ws / "runs" / "a"))
    assert (ws / "model_summary_grafp.txt").exists()
    assert len(a2["loss"]) == 2 and all(np.isfinite(a2["loss"]))
    for hr in a2["hit_rates"]:               # validation at epochs 1 and 2
        assert hr.shape == (4, 6) and ((hr >= 0) & (hr <= 100)).all()
        assert (hr[3] >= hr[2]).all() and (hr[2] >= hr[0]).all()
    p = runs["a2_payload"]
    assert p["epoch"] == 2 and p["step"] == 4 and p["loss"] == a2["loss"]
    assert p["valid_acc"] == [h[0].tolist() for h in a2["hit_rates"]]
    resumed = load_ckp(str(ws / "checkpoint" / "model_a_current.pth"))
    assert resumed["epoch"] == 3 and resumed["step"] == 6
    assert np.isnan(resumed["valid_acc"][2]) and resumed["hit_rate"] is None


def test_resume_is_bit_identical_to_one_run(runs):
    ws = runs["ws"]
    a = load_ckp(str(ws / "checkpoint" / "model_a_current.pth"))
    b = load_ckp(str(ws / "checkpoint" / "model_b_current.pth"))
    assert runs["a2"]["loss"] + runs["a3"]["loss"] == runs["b3"]["loss"]
    assert a["loss"] == b["loss"] and a["step"] == b["step"] == 6
    assert sorted(a["state_dict"]) == sorted(b["state_dict"])
    for key, val in b["state_dict"].items():
        assert torch.equal(a["state_dict"][key], val), key
    assert a["optimizer"]["param_groups"] == b["optimizer"]["param_groups"]
    for i, s in b["optimizer"]["state"].items():
        for name, val in s.items():
            assert torch.equal(a["optimizer"]["state"][i][name], val), (i, name)
    # the resumed epoch moved the weights
    assert not all(torch.equal(runs["a2_payload"]["state_dict"][k], v)
                   for k, v in b["state_dict"].items())


@pytest.fixture(scope="module")
def test_fp_run(runs):
    ws = runs["ws"]
    cwd = os.getcwd()
    os.chdir(ws)
    try:
        np.save("data/val_audio_indices.npy", np.random.RandomState(0).permutation(6))
        results = test_fp_main.main([
            "--config", "tiny.yaml", "--test_config", "tiny_test_config.yaml",
            "--test_dir", str(ws / "val_audio"), "--n_query_db", "2", "--small_test",
            "--test_ids", "4", "--query_lens", "2,3", "--text", "e2e"], device="cpu")
        (fp_dir, hit_rates), = results.values()
        direct = eval_faiss(fp_dir, test_ids="4", test_seq_len="3 5", index_type="l2",
                            verbose=False, device="cpu")
        yield fp_dir, hit_rates, direct
    finally:
        os.chdir(cwd)


def test_test_fp_hit_rates_equal_eval_faiss(runs, test_fp_run):
    fp_dir, hit_rates, direct = test_fp_run
    assert fp_dir == os.path.join("logs", "store", "medium", "model_a_current")
    assert hit_rates.shape == (4, 2) and np.isfinite(hit_rates).all()
    np.testing.assert_array_equal(hit_rates, direct)
    saved = [np.load(os.path.join(runs["ws"], root, "hit_rates.npy"))
             for root, _, files in os.walk(os.path.join(runs["ws"], fp_dir))
             if "hit_rates.npy" in files]
    assert len(saved) == 2 and all(np.array_equal(s, direct) for s in saved)


def test_test_fp_sanir_drops_the_queries_ir(runs, test_fp_run, capsys):
    """'sanir' in --text rebuilds the query DB without IR corruption: the
    clean rows stay, the corrupted ones change."""
    fp_dir = os.path.join(runs["ws"], test_fp_run[0])
    before = {n: open(os.path.join(fp_dir, f"{n}.mm"), "rb").read() for n in ("db", "query")}
    cwd = os.getcwd()
    os.chdir(runs["ws"])
    try:
        test_fp_main.main([
            "--config", "tiny.yaml", "--test_config", "tiny_test_config.yaml",
            "--test_dir", str(runs["ws"] / "val_audio"), "--n_query_db", "2",
            "--small_test", "--test_ids", "4", "--query_lens", "2", "--text", "sanir_e2e"],
            device="cpu")
    finally:
        os.chdir(cwd)
    assert "Queries without IR augmentation!" in capsys.readouterr().out
    after = {n: open(os.path.join(fp_dir, f"{n}.mm"), "rb").read() for n in ("db", "query")}
    assert after["db"] == before["db"] and after["query"] != before["query"]


@pytest.fixture(scope="module")
def generate_run(runs):
    """The port's generate on the val dir with the resumed checkpoint, and
    fingerprint_track of each track with the same weights."""
    ws = runs["ws"]
    cwd = os.getcwd()
    os.chdir(ws)
    try:
        fp = generate_main.main([
            "--config", "tiny.yaml", "--test_dir", str(ws / "val_audio"),
            "--ckp", "checkpoint/model_a_current.pth", "--output_dir", "gen_out"],
            device="cpu")
        saved = np.load("gen_out/fingerprints.npy")
        cfg = load_config("tiny.yaml")
        model = build_model(cfg, device="cpu")
        model.load_state_dict(load_ckp("checkpoint/model_a_current.pth")["state_dict"])
        pipe = FingerprintPipeline(model, cfg, device="cpu")
        ds = FingerprintDataset(cfg, str(ws / "val_audio"), train=False)
        want = np.concatenate([pipe.fingerprint_track(ds[i]) for i in range(len(ds))])
    finally:
        os.chdir(cwd)
    return fp, saved, want


def test_generate_rows_equal_fingerprint_track(generate_run):
    fp, saved, want = generate_run
    np.testing.assert_array_equal(saved, fp)
    assert fp.shape == want.shape == (6 * 22, 128)
    np.testing.assert_allclose(fp, want, rtol=0, atol=1e-3)
    hold_rows("generate vs fingerprint_track", fp, want)


@pytest.fixture(scope="module")
def jax_cli_runs(runs, test_fp_run):
    """The JAX package's generate and test_fp (--small_test) in the same
    workspace, on the port's resumed checkpoint saved as the JAX package's
    Orbax checkpoint ``checkpoint/model_j_current``. Returns generate's
    fingerprints and test_fp's fingerprint dir."""
    import jax
    import jax.numpy as jnp

    from grafp_tpu.cli import generate_main as j_generate_main
    from grafp_tpu.cli import test_fp_main as j_test_fp_main
    from grafp_tpu.core.config import load_config as j_load_config
    from grafp_tpu.models import build_model as j_build_model
    from grafp_tpu.train.checkpoint import save_ckp as j_save_ckp

    ws = runs["ws"]
    cwd = os.getcwd()
    os.chdir(ws)
    try:
        cfg = load_config("tiny.yaml")
        model = build_model(cfg, device="cpu")
        model.load_state_dict(load_ckp("checkpoint/model_a_current.pth")["state_dict"])
        jm = j_build_model(j_load_config("tiny.yaml"))
        shapes = jax.eval_shape(lambda: jm.init(
            {"params": jax.random.key(0)}, jnp.zeros((1, cfg.n_mels, cfg.n_frames)), False))
        params, stats = jax_variables_from_port(model, shapes)
        j_save_ckp({"epoch": 3, "params": params, "batch_stats": stats}, "j",
                   str(ws / "checkpoint"), "current")
        j_generate_main.main([
            "--config", "tiny.yaml", "--test_dir", str(ws / "val_audio"),
            "--ckp", "checkpoint/model_j_current", "--output_dir", "gen_jax"])
        with open("jax_test_config.yaml", "w") as f:
            yaml.safe_dump({"j": ["current"]}, f)
        j_test_fp_main.main([
            "--config", "tiny.yaml", "--test_config", "jax_test_config.yaml",
            "--test_dir", str(ws / "val_audio"), "--n_query_db", "2", "--small_test",
            "--test_ids", "4", "--query_lens", "2,3", "--text", "e2e"])
    finally:
        os.chdir(cwd)
    return (np.load(ws / "gen_jax" / "fingerprints.npy"),
            ws / "logs" / "store" / "medium" / "model_j_current")


def test_generate_equals_the_jax_cli(generate_run, jax_cli_runs):
    fp, want = generate_run[0], jax_cli_runs[0]
    assert fp.shape == want.shape == (6 * 22, 128)
    np.testing.assert_allclose(fp, want, rtol=0, atol=1e-3)
    hold_rows("generate vs the JAX package's generate", fp, want)


@pytest.mark.parametrize("name", ["dummy_db", "db"])
def test_test_fp_clean_dbs_equal_the_jax_cli(runs, test_fp_run, jax_cli_runs, name):
    got = load_memmap_data(str(runs["ws"] / test_fp_run[0]), name, display=False)[0]
    want = load_memmap_data(str(jax_cli_runs[1]), name, display=False)[0]
    assert got.shape == want.shape and len(got) == {"dummy_db": 4, "db": 2}[name] * 22
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    hold_rows(f"test_fp {name} vs the JAX package's test_fp", got, want)


def test_runs_leave_the_repo_untouched(runs, test_fp_run):
    assert _repo_state() == runs["before"]


@pytest.mark.parametrize("cli", [train_main, test_fp_main, generate_main],
                         ids=["train", "test_fp", "generate"])
def test_entry_points_default_to_the_card(cli):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--config", os.path.join(REPO, "config", "grafp.yaml")])
