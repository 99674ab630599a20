"""The port's checkpoints and driver helpers (grafp_tpu_torch/train/checkpoint.py,
grafp_tpu_torch/utils/helpers.py, the CLI helpers) against the JAX
package's, on the CPU.

Tolerances: the reference-.pth importer is bit-equal, key for key, to the
JAX package's ``torch_state_dict_to_tree`` followed by
``convert.state_dict_from_jax``; save -> load is bit-equal (parameters,
BatchNorm statistics, Adam's moments and step counts, ``TrainState.step``);
the Orbax conversion of ``scripts/torch_port_orbax_to_pth.py`` bit-equal
to ``state_dict_from_jax`` of the saved tree; the port model on an imported
.pth against the torch replica's own forward, and on a converted Orbax
checkpoint against the JAX model: the model tolerances of
tests/test_torch_import.py, rtol/atol 2e-3 on (h, z), and on 8 rows each
row of z nearest its own reference row at cos > 0.9999, a floor above the
largest cosine between two different rows (``hold_rows``; both models are
``calibrate``d so that their fingerprints spread); the HTML table
byte-equal; the parameter counts and the query-length conversions equal."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grafp_tpu.cli.test_fp_main import create_table as j_create_table  # noqa: E402
from grafp_tpu.core.config import Config as JConfig  # noqa: E402
from grafp_tpu.models import build_model as j_build_model  # noqa: E402
from grafp_tpu.train.checkpoint import save_ckp as j_save_ckp  # noqa: E402
from grafp_tpu.train.checkpoint import torch_state_dict_to_tree as j_to_tree  # noqa: E402
from grafp_tpu.utils import helpers as jh  # noqa: E402
from grafp_tpu_torch.cli.test_fp_main import create_table, load_any_checkpoint  # noqa: E402
from grafp_tpu_torch.convert import state_dict_from_jax  # noqa: E402
from grafp_tpu_torch.core import Config  # noqa: E402
from grafp_tpu_torch.core import load_config as ck_load_config  # noqa: E402
from grafp_tpu_torch.models import build_model  # noqa: E402
from grafp_tpu_torch.train import create_train_state, make_train_step  # noqa: E402
from grafp_tpu_torch.train import checkpoint as ck  # noqa: E402
from grafp_tpu_torch.utils import helpers as th  # noqa: E402
from grafp_tpu.train.checkpoint import (  # noqa: E402
    torch_ast_state_dict_to_tree as j_ast_to_tree,
)
from grafp_tpu.train.checkpoint import (  # noqa: E402
    torch_nafp_state_dict_to_tree as j_nafp_to_tree,
)
from grafp_tpu_torch.dsp.melspec import LogMelConfig, log_mel_spectrogram  # noqa: E402
from grafp_tpu_torch.models.nafp import CHANNELS  # noqa: E402
from tests.fixtures import _melody  # noqa: E402
from tests.test_torch_import import _build_torch_model, _randomize  # noqa: E402
from tests.test_torch_import_ast import _build_torch_ast  # noqa: E402
from tests.torch_port_util import (  # noqa: E402
    calibrate,
    calibrated_jax_variables,
    hold_rows,
    one_torch_thread,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AST_YAML = os.path.join(REPO, "config", "ast.yaml")
TINY = dict(fs=1000, win_len=256, hop_len=128, n_fft=256, n_mels=16, n_frames=8)


@pytest.fixture(scope="module")
def replica():
    """The torch replica of the reference model with random weights, its
    BatchNorm scales drawn near 1 (as ``randomize_jax_variables`` draws
    them) and ``calibrate``d on 32 spectrograms (its residual branches'
    last BatchNorm is ``fc2.1``), and its state_dict as a reference .pth
    would hold it (DataParallel prefix, a dead relative_pos buffer,
    num_batches_tracked)."""
    tm = _build_torch_model()
    _randomize(tm)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.copy_(1.0 + 0.1 * torch.randn(m.weight.shape, generator=g))
    calibrate(tm, _replica_spec(100, 32), forward=tm.fwd, last_bn=("fc2.1",))
    for m in tm.modules():
        m.eval()
    sd = {"module." + k: v.clone() for k, v in tm.state_dict().items()}
    sd["module.encoder.backbone.0.0.relative_pos"] = torch.zeros(1, 4, 4)
    return tm, sd


def _replica_spec(seed, b):
    """(b, 64, 32) spectrograms, each a random spectral and a random
    temporal profile at random gains over white noise (white noise alone
    looks alike to the model after its min-max scaling)."""
    rs = np.random.RandomState(seed)
    x = (rs.randn(b, 64, 1) * rs.uniform(0.5, 3, (b, 1, 1))
         + rs.randn(b, 1, 32) * rs.uniform(0.5, 3, (b, 1, 1))
         + rs.uniform(0.1, 1, (b, 1, 1)) * rs.randn(b, 64, 32))
    return torch.tensor(x.astype(np.float32))


def _save_reference(path, sd):
    torch.save({"epoch": 42, "loss": [1.0], "valid_acc": [np.float64(0.5)],
                "hit_rate": None, "state_dict": sd}, str(path))


def test_pth_import_is_bit_equal_to_the_jax_importer(replica, tmp_path):
    _, sd = replica
    model = build_model(Config(), device="cpu")
    path = tmp_path / "model_ref_best.pth"
    _save_reference(path, sd)
    got = load_any_checkpoint(str(path), model)
    params, stats = j_to_tree({k: v.numpy() for k, v in sd.items()})
    want = state_dict_from_jax(params, stats, model)
    assert sorted(got) == sorted(want) == sorted(model.state_dict())
    for key in want:
        assert got[key].dtype == want[key].dtype == torch.float32, key
        assert torch.equal(got[key], want[key]), key


def test_port_on_imported_pth_matches_the_replica(replica, tmp_path):
    tm, sd = replica
    path = tmp_path / "model_ref_best.pth"
    _save_reference(path, sd)
    model = build_model(Config(), device="cpu")
    model.load_state_dict(load_any_checkpoint(str(path), model))
    spec = _replica_spec(1, 8)
    with torch.no_grad():
        th_, tz = tm.fwd(spec)
        h, z = model(spec)
    np.testing.assert_allclose(h.numpy(), th_.numpy(), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(z.numpy(), tz.numpy(), rtol=2e-3, atol=2e-3)
    assert ((z * tz).sum(-1) > 0.9999).all()
    hold_rows("port on the imported .pth vs the replica", z, tz, 0.9999)


def _corrupt(sd, how):
    sd = dict(sd)
    if how == "missing":
        del sd["module.encoder.backbone.3.0.fc2.1.running_var"]
    elif how == "extra":
        sd["module.encoder.backbone.3.0.fc3.weight"] = torch.zeros(3)
    elif how == "shape":
        key = "module.encoder.proj.weight"
        sd[key] = torch.zeros(1000, 512, 1, 1)
    elif how == "ast":
        sd["module.encoder.blocks.0.norm1.weight"] = torch.zeros(3)
    elif how == "nafp":
        sd["module.encoder.conv_layers.0.weight"] = torch.zeros(3, 1, 3, 3)
    return sd


@pytest.mark.parametrize("how,exc,match", [
    ("missing", KeyError, "running_var"),
    ("extra", KeyError, "does not read"),
    ("shape", ValueError, "encoder.proj.weight"),
    # one stray key of another arch makes the file that arch's, whose
    # mapping then misses its keys or leaves the grafp ones unread
    ("ast", KeyError, "patch_embed"),
    ("nafp", KeyError, "nafp mapping does not read"),
])
def test_pth_import_refuses_what_it_cannot_map(replica, how, exc, match):
    _, sd = replica
    model = build_model(Config(), device="cpu")
    with pytest.raises(exc, match=match):
        ck.import_torch_checkpoint({"state_dict": _corrupt(sd, how)}, model)


def _trained_state(cfg, steps=1, seed=0):
    model = build_model(cfg, generator=torch.Generator().manual_seed(seed), device="cpu",
                        train=True)
    state = create_train_state(model, cfg, steps_per_epoch=1)
    step = make_train_step(model, cfg, device="cpu")
    rs = np.random.RandomState(seed)
    for i in range(steps):
        x = rs.randn(4, cfg.clip_frames).astype(np.float32)
        step(state, x, x + 0.1 * rs.randn(*x.shape).astype(np.float32),
             torch.Generator().manual_seed(i))
    return state


def test_save_load_is_bit_equal(tmp_path):
    cfg = Config(**TINY)
    state = _trained_state(cfg)
    hits = np.arange(12, dtype=np.float64).reshape(4, 3)
    path = ck.save_ckp(ck.train_payload(state, 2, [3.0, 2.5], [hits[0], np.nan], hits),
                       "unit", str(tmp_path / "checkpoint"), "current")
    assert path.endswith(os.path.join("checkpoint", "model_unit_current.pth"))
    payload = ck.load_ckp(path)
    assert ck.is_native(payload) and payload["epoch"] == 2 and payload["step"] == 1
    assert payload["loss"] == [3.0, 2.5] and payload["hit_rate"] == hits.tolist()
    assert payload["valid_acc"][0] == hits[0].tolist() and np.isnan(payload["valid_acc"][1])
    fresh = create_train_state(build_model(cfg, generator=torch.Generator().manual_seed(9),
                                           device="cpu", train=True), cfg)
    ck.restore_train_state(fresh, payload)
    assert fresh.step == state.step == 1
    for (k, a), (_, b) in zip(state.model.state_dict().items(),
                              fresh.model.state_dict().items()):
        assert torch.equal(a, b), k
    want, got = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert want["param_groups"] == got["param_groups"]
    assert len(want["state"]) == len(got["state"]) == len(list(state.model.parameters()))
    for i, s in want["state"].items():
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(got["state"][i][name], s[name]), (i, name)


def test_resume_refuses_a_reference_or_weights_only_file(replica):
    state = create_train_state(build_model(Config(**TINY), device="cpu", train=True),
                               Config(**TINY))
    with pytest.raises(ValueError, match="reference"):
        ck.restore_train_state(state, {"state_dict": {}})
    with pytest.raises(ValueError, match="weights only"):
        ck.restore_train_state(state, {"format": ck.FORMAT, "optimizer": None})


@pytest.fixture(scope="module")
def jax_tree():
    """The JAX model and a (params, batch_stats) pair holding a port
    model's initial weights, BatchNorms randomised and ``calibrate``d on
    32 spectrograms drawn as ``_tiny_spec`` draws them."""
    cfg = Config(**TINY)
    jm = j_build_model(JConfig(**TINY))
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.key(0)},
                                            jnp.zeros((1, cfg.n_mels, cfg.n_frames)), False))
    model = build_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    params, stats = calibrated_jax_variables(model, shapes, torch.tensor(_tiny_spec(100, 32)))
    return jm, params, stats


def _tiny_spec(seed, b):
    return (10.0 * np.random.RandomState(seed).randn(
        b, TINY["n_mels"], TINY["n_frames"])).astype(np.float32)


def test_orbax_checkpoint_converts_and_serves(jax_tree, tmp_path):
    """A JAX state saved by save_ckp goes through the conversion script and
    serves in the port; load_any_checkpoint on the Orbax directory itself
    names the script."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import torch_port_orbax_to_pth as conv

    cfg = Config(**TINY)
    jm, params, stats = jax_tree
    ckpt = j_save_ckp({"epoch": 3, "loss": [3.0, 2.0, 1.5], "valid_acc": [np.ones(6)],
                       "params": params, "batch_stats": stats}, "orbax", str(tmp_path), "best")
    model = build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="torch_port_orbax_to_pth.py"):
        load_any_checkpoint(ckpt, model)
    out = conv.convert(ckpt, str(tmp_path / "model_orbax_best.pth"), cfg)
    payload = ck.load_ckp(out)
    assert ck.is_native(payload) and payload["optimizer"] is None and payload["epoch"] == 3
    got = load_any_checkpoint(out, model)
    want = state_dict_from_jax(params, stats, model)
    assert sorted(got) == sorted(want) == sorted(model.state_dict())
    for key in want:
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key
    model.load_state_dict(got)
    spec = _tiny_spec(2, 8)
    want_h, want_z = jax.jit(lambda v, x: jm.apply(v, x, False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(spec))
    with torch.no_grad():
        h, z = model(torch.tensor(spec))
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(z.numpy(), np.asarray(want_z), rtol=2e-3, atol=2e-3)
    assert ((z.numpy() * np.asarray(want_z)).sum(-1) > 0.9999).all()
    hold_rows("port on the converted Orbax checkpoint vs JAX", z, np.asarray(want_z), 0.9999)
    state = create_train_state(build_model(cfg, device="cpu", train=True), cfg)
    with pytest.raises(ValueError, match="weights only"):
        ck.restore_train_state(state, payload)


def test_count_parameters_equals_jax(jax_tree, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = Config(**TINY)
    _, params, _ = jax_tree
    want = jh.count_parameters(params, write_summary=False)
    got = th.count_parameters(build_model(cfg, device="cpu"), "grafp")
    assert got == want
    assert open("model_summary_grafp.txt").read().endswith(f"Total Trainable Params: {got}")


@pytest.mark.parametrize("lens,text", [((1, 3, 5, 9, 11, 19), "test_current"),
                                       ((11, 21), "sanir_e2e_3")])
def test_create_table_is_byte_equal(lens, text):
    hits = np.random.RandomState(len(lens)).rand(4, len(lens)) * 100
    for overlap in (0.5, 0.9):
        assert create_table(hits, overlap, 1.0, lens, text) == j_create_table(
            hits, overlap, 1.0, lens, text)


def test_query_length_conversions_equal_jax():
    for overlap in (0.5, 0.75, 0.8, 0.9, 0.95):
        for q in (1, 2, 3, 5, 10):
            assert (th.query_len_from_seconds(q, overlap, 1.0)
                    == jh.query_len_from_seconds(q, overlap, 1.0))
        for n in (1, 3, 19, 101):
            assert (th.seconds_from_query_len(n, overlap, 1.0)
                    == jh.seconds_from_query_len(n, overlap, 1.0))


# --- the baselines' reference .pth ----------------------------------------

def _build_torch_nafp():
    """A torch replica of the reference SimCLR(NAFPEncoder) with its keys:
    ``encoder.conv_layers`` a Sequential of conv a (6i), LayerNorm([C, H,
    W]) (6i + 1), ReLU, conv b (6i + 3), LayerNorm (6i + 4), ReLU per stage
    (neural_audio_fp.py:12-46), and the projector."""
    nn = torch.nn
    layers, c_in, h, w = [], 1, 256, 32
    for ch in CHANNELS:
        w = (w - 1) // 2 + 1
        layers += [nn.Conv2d(c_in, ch, (1, 3), stride=(1, 2), padding=(0, 1)),
                   nn.LayerNorm([ch, h, w]), nn.ReLU()]
        h = (h - 1) // 2 + 1
        layers += [nn.Conv2d(ch, ch, (3, 1), stride=(2, 1), padding=(1, 0)),
                   nn.LayerNorm([ch, h, w]), nn.ReLU()]
        c_in = ch
    model = nn.Module()
    model.encoder = nn.Module()
    model.encoder.conv_layers = nn.Sequential(*layers)
    model.projector = nn.Sequential(nn.Linear(1024, 4096), nn.ELU(), nn.Linear(4096, 128))

    def forward(spec):                       # (B, 256, 32)
        h = model.encoder.conv_layers(spec[:, None]).flatten(1)
        return h, torch.nn.functional.normalize(model.projector(h), dim=-1)

    model.fwd = forward
    return model


BASELINES = {"ast": (_build_torch_ast, j_ast_to_tree, AST_YAML),
             "nafp": (_build_torch_nafp, j_nafp_to_tree, None)}


def _baseline_cfg(arch):
    if arch == "ast":
        cfg = ck_load_config(AST_YAML)
    else:
        cfg = Config(arch="nafp", n_mels=256)
    cfg["compute_dtype"] = "float32"
    return cfg


@pytest.fixture(scope="module")
def baseline_replicas():
    """Per arch: the torch replica with random weights as
    ``calibrate_baseline`` draws them (weights N(0, 1 / fan_in), biases
    0.1 N(0, 1), LayerNorm weights 1 + 0.1 N(0, 1), cls token and
    positions 0.02 N(0, 1)) and its state_dict as a reference .pth holds it
    (DataParallel prefix)."""
    out = {}
    for arch, (build, _, _) in BASELINES.items():
        tm = build()
        g = torch.Generator().manual_seed(11)
        with torch.no_grad():
            for name, p in tm.named_parameters():
                r = torch.randn(p.shape, generator=g)
                if name.endswith(("cls_token", "pos_embed")):
                    p.copy_(0.02 * r)
                elif p.dim() >= 2:
                    p.copy_(r / p[0].numel() ** 0.5)
                else:
                    p.copy_(0.1 * r)
            for m in tm.modules():
                if isinstance(m, torch.nn.LayerNorm):
                    m.weight.add_(1.0)
        out[arch] = tm, {"module." + k: v.clone() for k, v in tm.state_dict().items()}
    return out


def _melody_spec(cfg, n, seed):
    rs = np.random.RandomState(seed)
    t = np.arange(cfg.fs) / cfg.fs
    waves = np.stack([_melody(rs, t, cfg.fs) for _ in range(n)]).astype(np.float32)
    return log_mel_spectrogram(torch.tensor(waves), LogMelConfig.from_config(cfg))


@pytest.mark.parametrize("arch", ["ast", "nafp"])
def test_baseline_pth_import_is_bit_equal_to_the_jax_importer(baseline_replicas, arch,
                                                              tmp_path):
    _, sd = baseline_replicas[arch]
    model = build_model(_baseline_cfg(arch), device="cpu")
    path = tmp_path / f"model_{arch}_best.pth"
    _save_reference(path, sd)
    assert ck.checkpoint_arch(sd) == arch
    got = load_any_checkpoint(str(path), model)
    params, stats = BASELINES[arch][1]({k: v.numpy() for k, v in sd.items()})
    want = state_dict_from_jax(params, stats, model)
    assert sorted(got) == sorted(want) == sorted(model.state_dict())
    for key in want:
        assert got[key].dtype == want[key].dtype == torch.float32, key
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("arch", ["ast", "nafp"])
def test_port_on_imported_baseline_pth_matches_the_replica(baseline_replicas, arch,
                                                           tmp_path):
    """The model tolerances of tests/test_torch_import_ast.py: h within
    rtol / atol 2e-3, each z row nearest its own replica row at cos >
    0.9999."""
    tm, sd = baseline_replicas[arch]
    cfg = _baseline_cfg(arch)
    path = tmp_path / f"model_{arch}_best.pth"
    _save_reference(path, sd)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(load_any_checkpoint(str(path), model))
    spec = _melody_spec(cfg, 6, seed=12)
    with torch.no_grad():
        th_, tz = tm.fwd(spec)
        h, z = model(spec)
    np.testing.assert_allclose(h.numpy(), th_.numpy(), rtol=2e-3, atol=2e-3)
    hold_rows(f"port on the imported {arch} .pth vs the replica", z, tz, 0.9999)


@pytest.mark.parametrize("arch", ["ast", "nafp"])
def test_baseline_pth_import_refuses_an_unread_key(baseline_replicas, arch):
    _, sd = baseline_replicas[arch]
    sd = {**sd, "module.encoder.extra.weight": torch.zeros(3)}
    model = build_model(_baseline_cfg(arch), device="cpu")
    with pytest.raises(KeyError, match=f"{arch} mapping does not read"):
        ck.import_torch_checkpoint({"state_dict": sd}, model)
    # a checkpoint of another arch than the model's fails the key checks
    other = build_model(Config(**TINY), device="cpu")
    with pytest.raises(KeyError, match="missing"):
        ck.import_torch_checkpoint({"state_dict": baseline_replicas[arch][1]}, other)
