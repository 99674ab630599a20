"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled by
``nvcc`` for ``sm_90a`` into ``_build/lib<name>-<hash>.so`` inside the
package, at first use, and loaded with ctypes. The hash covers the source
and the flags, so an edited source is rebuilt and a stale library is never
loaded. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _start(name: str) -> Tuple[Path, "subprocess.Popen | None"]:
    out = _lib_path(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def _finish(out: Path, proc: "subprocess.Popen | None") -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {out.name}:\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names: Iterable[str]) -> Dict[str, Tuple[float, str]]:
    """Compile the named sources in parallel, one nvcc each, all started
    together. Returns {name: (seconds, compiler log)}; a source already
    built reports 0 s and an empty log."""
    t0 = time.perf_counter()
    started = {n: _start(n) for n in names}
    done = {}
    for n, proc in started.items():
        log = _finish(*proc)
        done[n] = (time.perf_counter() - t0, log)
    return done


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The compiled ``csrc/<name>.cu``, built first when missing."""
    out, proc = _start(name)
    _finish(out, proc)
    return ctypes.CDLL(str(out))
