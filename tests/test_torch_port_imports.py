"""The port stands alone: no module of grafp_tpu_torch, not chip_smoke.py
and not the port's protocol drivers (scripts/torch_port_fma_large_smoke.py,
scripts/torch_port_e2e_synthetic_icassp.py) imports jax, flax or the JAX
package grafp_tpu (checked on the syntax tree, so prose that names them
does not count)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "grafp_tpu")
# the port's drivers that run on the card's machine, which has no JAX
DRIVERS = [ROOT / "scripts" / "torch_port_fma_large_smoke.py",
           ROOT / "scripts" / "torch_port_e2e_synthetic_icassp.py"]
SOURCES = (sorted((ROOT / "grafp_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
           + DRIVERS)


def _imported(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_module_imports_nothing_of_jax(path):
    bad = [n for n in _imported(ast.parse(path.read_text())) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_a_forbidden_import():
    tree = ast.parse("import jax.numpy as jnp\nfrom grafp_tpu.ops import knn\n"
                     "import grafp_tpu_torch\n")
    assert [n for n in _imported(tree) if _forbidden(n)] == [
        "jax.numpy", "grafp_tpu.ops"]


def test_package_imports_with_jax_blocked():
    """Every module imports in a process where importing jax, flax or
    grafp_tpu fails."""
    mods = sorted({".".join(p.relative_to(ROOT).with_suffix("").parts)
                   .removesuffix(".__init__")
                   for p in (ROOT / "grafp_tpu_torch").rglob("*.py")})
    code = ("import sys\n"
            + "".join(f"sys.modules[{m!r}] = None\n" for m in FORBIDDEN)
            + "import importlib\n"
            + "".join(f"importlib.import_module({m!r})\n" for m in mods))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
