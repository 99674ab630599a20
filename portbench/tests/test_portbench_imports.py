"""No run loads JAX or the JAX package, and the reference imports nothing
of the program. Top-level module names are compared whole: the port's
name begins with the JAX package's."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "grafp_tpu"}


def imported_tops(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".", 1)[0]


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in PB.rglob("*.py"):
        assert not set(imported_tops(path)) & FORBIDDEN, path


def test_the_reference_and_yardstick_import_nothing_of_the_program():
    for sub in ("reference", "yardstick"):
        for path in (PB / sub).rglob("*.py"):
            assert "grafp_tpu_torch" not in set(imported_tops(path)), path


def run_python(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_a_run_loads_no_forbidden_module():
    code = (
        "import sys, torch\n"
        "sys.path.insert(0, '.')\n"
        "from portbench import run, harness\n"
        "import portbench.work.build, portbench.work.train\n"
        "import grafp_tpu_torch.fp.builder, grafp_tpu_torch.train.step\n"
        "import grafp_tpu_torch.retrieval.index\n"
        "from portbench.yardstick import traffic\n"
        "traffic.music_like_on_device(2, 0.5, 1.0, 16000, 1, 'cpu')\n"
        "print(harness.forbidden_modules())\n"
        "print(sorted({m.split('.', 1)[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'grafp_tpu'}))\n")
    assert run_python(code).split() == ["[]", "[]"]


def test_the_reference_alone_loads_nothing_of_the_program():
    code = (
        "import sys\n"
        "sys.path.insert(0, '.')\n"
        "import portbench.reference.grafp, portbench.reference.nafp\n"
        "import portbench.reference.train, portbench.reference.augment\n"
        "print(sorted({m.split('.', 1)[0] for m in sys.modules} & "
        "{'grafp_tpu_torch', 'grafp_tpu', 'jax'}))\n")
    assert run_python(code).split() == ["[]"]


def test_forbidden_modules_compares_whole_names():
    from portbench import harness
    sys.modules["grafp_tpu_fake_probe"] = sys
    try:
        assert "grafp_tpu_fake_probe" not in harness.forbidden_modules()
    finally:
        del sys.modules["grafp_tpu_fake_probe"]
