"""The port's reference-contract smoke tools (scripts/torch_port_db_test.py,
scripts/torch_port_model_test.py) against the JAX package's
(unit_tests/db_test.py, unit_tests/model_test.py) on the same files: the
same lines, character for character.

* db_test: dummy_db memmaps in nested directories, written by both
  packages' writers (``save_memmap``), and an empty directory.
* model_test: a reference-layout .pth (the torch replica of
  tests/test_torch_import.py, as tests/test_cli_pth.py makes it) under
  config/grafp.yaml in f32 (the JAX tool applies its model eagerly, and the
  CPU's eager runtime refuses batched bf16 products, tests/test_cli_pth.py);
  and a JAX Orbax directory, which the port's tool refuses with a non-zero
  exit naming the converter (it cannot read Orbax without JAX).

Each tool runs in this process (its ``main``, or the JAX tool's module as
``__main__`` under a patched ``sys.argv``), except the Orbax refusal,
which runs the port's tool as a process to see its exit code.
"""

import contextlib
import io
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from grafp_tpu.retrieval.memmap_io import save_memmap as j_save_memmap  # noqa: E402
from grafp_tpu_torch.retrieval.memmap_io import save_memmap  # noqa: E402
from tests.test_torch_import import _build_torch_model, _randomize  # noqa: E402
from tests.torch_port_util import load_script, one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name: str, argv, monkeypatch) -> str:
    """unit_tests/<name>.py run as ``__main__`` with ``argv``: its stdout."""
    path = os.path.join(REPO, "unit_tests", f"{name}.py")
    monkeypatch.setattr(sys, "argv", [path, *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runpy.run_path(path, run_name="__main__")
    return out.getvalue()


def _port_tool(name: str, argv) -> str:
    """scripts/torch_port_<name>.py's main(argv): its stdout."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert load_script(f"torch_port_{name}").main(argv) == 0
    return out.getvalue()


def test_db_test_prints_the_jax_tools_lines(tmp_path, monkeypatch):
    rs = np.random.RandomState(0)
    root = tmp_path / "emb"
    for writer, sub, n in ((j_save_memmap, "jax/a", 7), (save_memmap, "port/b/c", 5),
                           (save_memmap, "port/d", 3)):
        writer(str(root / sub), "dummy_db", rs.rand(n, 128).astype(np.float32))
    save_memmap(str(root / "port" / "d"), "query_db", rs.rand(2, 128).astype(np.float32))
    want = _jax_tool("db_test", ["--emb_dir", str(root)], monkeypatch)
    got = _port_tool("db_test", ["--emb_dir", str(root)])
    assert got == want
    assert sorted(got.splitlines()) == sorted(
        f"{root / sub}: dummy_db shape {(np.int64(n), np.int64(128))}"
        for sub, n in (("jax/a", 7), ("port/b/c", 5), ("port/d", 3)))

    empty = tmp_path / "empty"
    empty.mkdir()
    want = _jax_tool("db_test", ["--emb_dir", str(empty)], monkeypatch)
    assert _port_tool("db_test", ["--emb_dir", str(empty)]) == want
    assert want == f"no dummy_db memmaps under {empty}\n"


@pytest.fixture(scope="module")
def reference_pth(tmp_path_factory):
    """A reference-layout .pth (tests/test_cli_pth.py:20-32) and an f32 copy
    of config/grafp.yaml."""
    tm = _build_torch_model()
    _randomize(tm)
    root = tmp_path_factory.mktemp("ckpt")
    path = root / "model_ref_best.pth"
    torch.save({"epoch": 42, "loss": [1.0], "valid_acc": [0.5], "hit_rate": None,
                "state_dict": {"module." + k: v for k, v in tm.state_dict().items()}},
               str(path))
    cfg = yaml.safe_load(open(os.path.join(REPO, "config", "grafp.yaml")))
    cfg["compute_dtype"] = "float32"
    cfg_path = root / "grafp_f32.yaml"
    yaml.safe_dump(cfg, open(cfg_path, "w"), sort_keys=False)
    return str(path), str(cfg_path)


def test_model_test_prints_the_jax_tools_line(reference_pth, monkeypatch):
    pth, cfg = reference_pth
    argv = ["--ckp", pth, "--config", cfg]
    want = _jax_tool("model_test", argv, monkeypatch)
    got = _port_tool("model_test", argv + ["--device", "cpu"])
    assert got == want == "OK: checkpoint loads and runs; h=(1, 1024) z=(1, 128)\n"


def test_model_test_refuses_an_orbax_directory(reference_pth, tmp_path):
    """A JAX Orbax checkpoint of the same weights: the port's tool exits
    non-zero, naming the converter."""
    from grafp_tpu.cli.test_fp_main import load_any_checkpoint as j_load_any
    from grafp_tpu.core.config import load_config as j_load_config
    from grafp_tpu.models import build_model as j_build_model
    from grafp_tpu.train.checkpoint import save_ckp as j_save_ckp

    pth, cfg_path = reference_pth
    jcfg = j_load_config(cfg_path)
    params, stats = j_load_any(pth, j_build_model(jcfg), jcfg)
    orbax = j_save_ckp({"epoch": 42, "params": params, "batch_stats": stats}, "ref",
                       str(tmp_path), "best")
    assert os.path.isdir(orbax)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "torch_port_model_test.py"),
         "--ckp", orbax, "--config", cfg_path, "--device", "cpu"],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "scripts/torch_port_orbax_to_pth.py" in proc.stderr, proc.stderr
    assert "Orbax" in proc.stderr


def test_model_test_defaults_to_the_card(reference_pth):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    pth, cfg = reference_pth
    with pytest.raises(RuntimeError, match="CUDA"):
        load_script("torch_port_model_test").main(["--ckp", pth, "--config", cfg])
