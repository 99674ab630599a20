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

from grafp_tpu_torch.cli import (  # noqa: E402
    baseline_test_fp,
    baseline_train,
    generate_main,
    test_fp_main,
    train_main,
)
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


@pytest.fixture(scope="module", autouse=True)
def port_embeds_in_batches_of_32():
    """The port's FingerprintPipeline embeds in batches of 32 here, not
    256, as the JAX CLIs of ``baseline_jax`` do: its builders embed only
    full batches (each group's last one zero-padded), a row does not depend
    on its batch (eval mode), and at 256 the tiny corpus's 22-row tracks
    would spend most of the time on padding rows."""
    defaults = FingerprintPipeline.__init__.__defaults__
    FingerprintPipeline.__init__.__defaults__ = (32,) + defaults[1:]
    yield
    FingerprintPipeline.__init__.__defaults__ = defaults
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


# --- the baseline encoders through the entry points ------------------------
#
# The baselines' drivers (python -m grafp_tpu_torch.cli.baseline_train,
# baseline_test_fp) and generate on a 16 kHz melody corpus at full width:
# the AST under config/ast.yaml (the drivers' default), NAFP under
# config/grafp.yaml with n_mels 256 (the repo has no NAFP config), each cut
# to bsz_train 8 (one step an epoch), 3 + 2 validation tracks, and f32:
# bf16 rows of the two packages part at cos 0.9999 (model level,
# tests/test_torch_port_baselines.py), nearer than two rows a hop apart of
# one track at overlap 0.9. Train 1 epoch with validation, resume to 2
# against 2 uninterrupted epochs (bit for bit), test_fp --small_test
# --model tc9 (the preset, offset 0.2 and overlap 0.5, resolved in a
# temporary directory), generate; the clean DBs and generate's rows against the JAX
# package's CLIs on the same wav dir and weights (max |d| <= 1e-3, each row
# nearest its own).

# arch: (config, its changes, seconds per validation track); validation
# needs more query rows than its longest sequence (19), so the AST's tracks,
# whose segments hop 0.5 s under config/ast.yaml, are longer
BASE = {"ast": ("ast.yaml", {}, 6.0),
        "nafp": ("grafp.yaml", {"arch": "nafp", "n_mels": 256}, 3.0)}


@pytest.fixture(scope="module", params=["ast", "nafp"])
def baseline(request, tmp_path_factory):
    arch = request.param
    ws = tmp_path_factory.mktemp(f"ws_{arch}")
    make_wav_dir(str(ws / "train_audio"), n=8, dur_s=3.0, seed=11)
    name, extra, val_s = BASE[arch]
    make_wav_dir(str(ws / "val_audio"), n=5, dur_s=val_s, seed=12)
    make_wav_dir(str(ws / "noise"), n=3, dur_s=2.0, seed=13, kind="noise")
    make_wav_dir(str(ws / "ir"), n=2, seed=14, kind="ir")
    os.makedirs(ws / "data")
    cfg = load_config(os.path.join(REPO, "config", name))
    for key, val in {"train_dir": str(ws / "train_audio"), "val_dir": str(ws / "val_audio"),
                     "noise_dir": str(ws / "noise"), "ir_dir": str(ws / "ir"),
                     "bsz_train": 8, "train_sz": 8, "val_sz": 5, "n_dummy": 3, "n_query": 2,
                     "compute_dtype": "float32", **extra}.items():
        cfg[key] = val
    cfg.save(str(ws / "base.yaml"))
    with open(ws / "tc.yaml", "w") as f:
        yaml.safe_dump({"tc9": ["current"], "tc_29": ["best"]}, f)
    enc = [] if arch == "ast" else ["--encoder", arch]        # ast: the default
    # the config that baseline_test_fp hands to test_fp, read while it exists
    seen, real_test_fp = {}, test_fp_main.main

    def spy(argv, device=None):
        path = argv[len(argv) - argv[::-1].index("--config")]
        seen.update(config=path, cfg=load_config(path))
        return real_test_fp(argv, device=device)

    common = ["--config", "base.yaml", "--seed", "42"] + enc
    cwd = os.getcwd()
    os.chdir(ws)
    try:
        out = {"arch": arch, "ws": ws, "cfg": cfg, "seen": seen}
        out["a1"] = baseline_train.main(common + ["--ckp", "tc9", "--epochs", "1",
                                                  "--validate_every", "1"], device="cpu")
        out["a1_payload"] = load_ckp("checkpoint/model_tc9_current.pth")
        out["a2"] = baseline_train.main(common + [
            "--ckp", "tc9", "--epochs", "2", "--resume", "checkpoint/model_tc9_current.pth"],
            device="cpu")
        out["b2"] = baseline_train.main(common + ["--ckp", "one", "--epochs", "2",
                                                  "--validate_every", "0"], device="cpu")
        np.save("data/val_audio_indices.npy", np.random.RandomState(0).permutation(5))
        fp_args = ["--test_config", "tc.yaml", "--test_dir", str(ws / "val_audio"),
                   "--n_query_db", "2", "--small_test", "--test_ids", "4",
                   "--query_lens", "2,3"]
        test_fp_main.main = spy
        try:
            (out["fp_dir"], out["hit_rates"]), = baseline_test_fp.main(
                ["--config", "base.yaml"] + enc + fp_args + ["--model", "tc9"],
                device="cpu").values()
        finally:
            test_fp_main.main = real_test_fp
        out["gen"] = generate_main.main([
            "--config", "base.yaml", "--test_dir", str(ws / "val_audio"),
            "--ckp", "checkpoint/model_tc9_current.pth", "--output_dir", "gen_out"],
            device="cpu")
        yield out
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def baseline_jax(baseline):
    """The JAX package's test_fp (--small_test, the tc9 preset's offset
    and overlap in a yaml written here: its baselines/test_fp.py would
    write one into the repo) and generate in the same workspace, on the
    port's resumed checkpoint saved as an Orbax checkpoint. Their
    FingerprintPipeline embeds in batches of 32 here, not 256: a row does
    not depend on its batch (eval mode), and the full-width models would
    spend most of the time on padding rows."""
    import jax
    import jax.numpy as jnp

    from grafp_tpu.cli import generate_main as j_generate_main
    from grafp_tpu.cli import test_fp_main as j_test_fp_main
    from grafp_tpu.core.config import load_config as j_load_config
    from grafp_tpu.fp.builder import FingerprintPipeline as JFingerprintPipeline
    from grafp_tpu.models import build_model as j_build_model
    from grafp_tpu.train.checkpoint import save_ckp as j_save_ckp

    ws, cfg = baseline["ws"], baseline["cfg"]
    cwd = os.getcwd()
    os.chdir(ws)
    defaults = JFingerprintPipeline.__init__.__defaults__
    JFingerprintPipeline.__init__.__defaults__ = (32,) + defaults[1:]
    try:
        model = build_model(cfg, device="cpu")
        model.load_state_dict(load_ckp("checkpoint/model_tc9_current.pth")["state_dict"])
        jm = j_build_model(j_load_config("base.yaml"))
        shapes = jax.eval_shape(lambda: jm.init(
            {"params": jax.random.key(0)}, jnp.zeros((1, cfg.n_mels, cfg.n_frames)), False))
        params, stats = jax_variables_from_port(model, shapes)
        j_save_ckp({"epoch": 2, "params": params, "batch_stats": stats}, "j",
                   str(ws / "checkpoint"), "current")
        j_generate_main.main([
            "--config", "base.yaml", "--test_dir", str(ws / "val_audio"),
            "--ckp", "checkpoint/model_j_current", "--output_dir", "gen_jax"])
        resolved = baseline_test_fp.resolved_config("base.yaml", "tc9")
        resolved.save("jax_tc9.yaml")
        with open("jax_tc.yaml", "w") as f:
            yaml.safe_dump({"j": ["current"]}, f)
        j_test_fp_main.main([
            "--config", "jax_tc9.yaml", "--encoder", baseline["arch"],
            "--test_config", "jax_tc.yaml", "--test_dir", str(ws / "val_audio"),
            "--n_query_db", "2", "--small_test", "--test_ids", "4", "--query_lens", "2,3"])
    finally:
        JFingerprintPipeline.__init__.__defaults__ = defaults
        os.chdir(cwd)
    return (np.load(ws / "gen_jax" / "fingerprints.npy"),
            ws / "logs" / "store" / "medium" / "model_j_current")


def test_baseline_drivers_keep_the_reference_defaults():
    argv = baseline_train.with_defaults(["--ckp", "x", "--encoder=nafp"])
    assert argv == ["--ckp", "x", "--encoder=nafp", "--config", "config/ast.yaml",
                    "--validate_every", "25"]
    argv = baseline_test_fp.with_defaults(["--model", "tc9"], baseline_test_fp.DEFAULTS)
    assert argv == ["--model", "tc9", "--encoder", "ast", "--config", "config/ast.yaml"]
    for model, preset in (("tc9", (0.2, 0.5)), ("tc10", (0.05, 0.9)),
                          ("tc11", (0.1, 0.8)), ("tc12", (0.125, 0.75))):
        cfg = baseline_test_fp.resolved_config(os.path.join(REPO, "config", "ast.yaml"), model)
        assert (cfg["offset"], cfg["overlap"]) == preset and cfg["arch"] == "ast"
    assert baseline_test_fp.resolved_config(os.path.join(REPO, "config", "ast.yaml"),
                                            "tc_29") is None


def test_baseline_train_writes_checkpoints_and_logs(baseline):
    ws, a1, arch = baseline["ws"], baseline["a1"], baseline["arch"]
    assert (ws / f"model_summary_{arch}.txt").exists()
    assert len(a1["loss"]) == 1 and np.isfinite(a1["loss"]).all()
    hr, = a1["hit_rates"]                          # validation at epoch 1
    assert hr.shape == (4, 6) and ((hr >= 0) & (hr <= 100)).all()
    p = baseline["a1_payload"]
    assert p["epoch"] == 1 and p["step"] == 1 and p["loss"] == a1["loss"]
    assert baseline["a2"]["hit_rates"] == [None]   # --validate_every 25
    assert not any(k.startswith("peak.") for k in p["state_dict"])


def test_baseline_resume_is_bit_identical_to_one_run(baseline):
    ws = baseline["ws"]
    a = load_ckp(str(ws / "checkpoint" / "model_tc9_current.pth"))
    b = load_ckp(str(ws / "checkpoint" / "model_one_current.pth"))
    assert baseline["a1"]["loss"] + baseline["a2"]["loss"] == baseline["b2"]["loss"]
    assert a["step"] == b["step"] == 2 and sorted(a["state_dict"]) == sorted(b["state_dict"])
    for key, val in b["state_dict"].items():
        assert torch.equal(a["state_dict"][key], val), key
    for i, s in b["optimizer"]["state"].items():
        for name, val in s.items():
            assert torch.equal(a["optimizer"]["state"][i][name], val), (i, name)


def test_baseline_test_fp_applies_the_preset_outside_the_repo(baseline):
    """test_fp ran on a config resolved with tc9's offset and overlap in a
    temporary directory, outside the repo and the working directory, and
    gone afterwards; its overlap 0.5 sets the segment hop (config/grafp.yaml
    has 0.9): the db rows are the segments of the 2 query tracks at that
    hop."""
    ws, cfg, seen = baseline["ws"], baseline["cfg"], baseline["seen"]
    path = os.path.realpath(seen["config"])
    assert (seen["cfg"]["offset"], seen["cfg"]["overlap"]) == (0.2, 0.5)
    assert seen["cfg"]["arch"] == cfg["arch"] and not os.path.exists(path)
    for root in (REPO, str(ws)):
        assert os.path.commonpath([path, os.path.realpath(root)]) != os.path.realpath(root)
    assert baseline["fp_dir"] == os.path.join("logs", "store", "medium", "model_tc9_current")
    db = load_memmap_data(str(ws / baseline["fp_dir"]), "db", display=False)[0]
    hop = int(cfg["n_frames"] * (1 - 0.5))
    frames = 1 + int(BASE[baseline["arch"]][2] * cfg["fs"]) // int(cfg["hop_len"])
    assert len(db) == 2 * ((frames - cfg["n_frames"]) // hop + 1)
    assert baseline["hit_rates"].shape == (4, 2)


def test_baseline_generate_equals_the_jax_cli_and_fingerprint_track(baseline, baseline_jax):
    ws, cfg = baseline["ws"], baseline["cfg"]
    fp, want = baseline["gen"], baseline_jax[0]
    model = build_model(cfg, device="cpu")
    model.load_state_dict(load_ckp(str(ws / "checkpoint" / "model_tc9_current.pth"))["state_dict"])
    pipe = FingerprintPipeline(model, cfg, device="cpu")
    ds = FingerprintDataset(cfg, str(ws / "val_audio"), train=False)
    by_track = np.concatenate([pipe.fingerprint_track(ds[i]) for i in range(len(ds))])
    assert fp.shape == want.shape == by_track.shape
    for what, ref in (("the JAX package's generate", want), ("fingerprint_track", by_track)):
        np.testing.assert_allclose(fp, ref, rtol=0, atol=1e-3)
        hold_rows(f"{baseline['arch']} generate vs {what}", fp, ref)


@pytest.mark.parametrize("name", ["dummy_db", "db"])
def test_baseline_test_fp_clean_dbs_equal_the_jax_cli(baseline, baseline_jax, name):
    got = load_memmap_data(str(baseline["ws"] / baseline["fp_dir"]), name, display=False)[0]
    want = load_memmap_data(str(baseline_jax[1]), name, display=False)[0]
    assert got.shape == want.shape and len(got) > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    hold_rows(f"{baseline['arch']} test_fp {name} vs the JAX package's test_fp", got, want)
