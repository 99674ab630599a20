"""The k-NN selection kernels of grafp_tpu_torch/csrc/mrconv_select.cuh run
on the CPU: the header's f32 path compiled by the host's g++ against
tests/cuda_host_emulation.h (each block as 256 threads with real barriers
and warp shuffles), then #3 and #4 (normalise + rows, + keys) and #1 and
#2 (rows, + keys on given keys) held against their plain versions in
ops/mrconv_concat.py and ops/max_neighbors.py.

Two builds: the header as it is, and one with the one-pass limit
(kMaxKN) cut to 64 bits and the two-block shared-memory budget
(kSmemPair) to 33,000 bytes, so that small shapes run split with the
smallest windows: one tile of keys in the row kernel, one or two row tiles
in the key kernel. Between them the cases reach round groups, key and row
windows, tie groups across windows, N under one tile, C over one channel
sweep and k = N.

The bf16 path's PTX (cp.async, ldmatrix, mma.sync) has no host
counterpart; it differs from the f32 path only in how a score is computed,
and tests/test_torch_port_cuda.py and chip_smoke.py hold it on the card.

Tolerances: chip_smoke.py's on the card. rel - x and rel within
1e-5 + 1e-5 |ref|, dx likewise (the kernels sum in key or row order, the
plain versions in a matmul's); rows whose f64 top-(k+1) scores have a gap
in (0, 1e-4), and for dx those rows' top-(k+1) rows, may differ (the
kernel's fmaf-chain scores and the plain matmul's can round a near tie
apart), at most 1 % of the rows or one. Two launches equal bit for bit."""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grafp_tpu_torch.ops.knn import l2_normalize  # noqa: E402
from grafp_tpu_torch.ops.max_neighbors import (  # noqa: E402
    max_neighbors_backward_reference,
    max_neighbors_reference,
)
from grafp_tpu_torch.ops.mrconv_concat import (  # noqa: E402
    _norm_rows_f32,
    mrconv_concat_backward_reference,
    mrconv_concat_reference,
)
from tests.torch_port_util import wide_input  # noqa: E402

HERE = Path(__file__).resolve().parent
HEADER = HERE.parent / "grafp_tpu_torch" / "csrc" / "mrconv_select.cuh"
BUILDS = {"real": {}, "tiny": {"kMaxKN = 8192": "kMaxKN = 64",
                               "kSmemPair = 115712": "kSmemPair = 33000"}}

DRIVER = r'''
#include "cuda_host_emulation.h"
#include "select.cuh"

extern "C" {
long long emu_workspace(int b, int n, int c, int k, int backward) {
  return select_workspace(b, n, c, k, 0, backward != 0);
}
int emu_concat(const float* x, float* xn, float* out, const float* g, float* grs,
               float* levels, float* dx, void* work, int b, int n, int c, int k) {
  if (bad_shape(b, n, c, k)) return 1;
  normalize<float>(x, xn, (long long)b * n, c, nullptr);
  if (g == nullptr)
    return select_rows<float, false, true>(
        make_args<float>(x, xn, out, nullptr, nullptr, nullptr, nullptr, b, n, c, k, work),
        nullptr);
  return select_rows<float, true, true>(
      make_args<float>(x, xn, nullptr, g, grs, levels, dx, b, n, c, k, work), nullptr);
}
int emu_neighbors(const float* xn, const float* x, float* out, const float* g, float* grs,
                  float* levels, float* dx, void* work, int b, int n, int c, int k) {
  if (bad_shape(b, n, c, k)) return 1;
  void* keys = const_cast<float*>(xn);
  if (g == nullptr)
    return select_rows<float, false, false>(
        make_args<float>(x, keys, out, nullptr, nullptr, nullptr, nullptr, b, n, c, k, work),
        nullptr);
  return select_rows<float, true, false>(
      make_args<float>(x, keys, nullptr, g, grs, levels, dx, b, n, c, k, work), nullptr);
}
}
'''


def _emulated_source(swaps) -> str:
    """The header with its CUDA-only lines replaced: no CUDA includes, the
    dynamic shared memory from the emulated block, launches through
    emu_launch, and the constants of ``swaps``."""
    src = HEADER.read_text()
    src = src.replace("#include <cuda_bf16.h>", "").replace("#include <cuda_runtime.h>", "")
    src = src.replace("extern __shared__ __align__(16) unsigned char smem[];",
                      "unsigned char* smem = g_block->smem.data();")
    src = re.sub(r"([\w<>]+?)<<<(.*?)>>>\(", r"emu_launch(\2, \1, ", src)
    for old, new in swaps.items():
        if old not in src:
            raise AssertionError(f"{HEADER.name} has no {old!r}")
        src = src.replace(old, new)
    return src


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels' host emulation")
    out = {}
    for name, swaps in BUILDS.items():
        d = tmp_path_factory.mktemp(f"select_{name}")
        (d / "select.cuh").write_text(_emulated_source(swaps))
        shutil.copy(HERE / "cuda_host_emulation.h", d)
        (d / "driver.cpp").write_text(DRIVER)
        so = d / "libselect.so"
        subprocess.run([gxx, "-std=c++20", "-O2", "-fPIC", "-shared", "-pthread", "-w",
                        "-o", str(so), str(d / "driver.cpp")], check=True, timeout=600)
        lib = ctypes.CDLL(str(so))
        lib.emu_workspace.restype = ctypes.c_longlong
        lib.emu_workspace.argtypes = [ctypes.c_int] * 5
        for fn in (lib.emu_concat, lib.emu_neighbors):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
        out[name] = lib
    return out


def _ptr(t):
    return None if t is None else t.data_ptr()


def _run(lib, op: str, x: torch.Tensor, g, k: int) -> torch.Tensor:
    """One call of the emulated kernels; outputs and scratch start as NaN
    (levels as 7, a level no score reaches) so that a slot the kernels
    should write and do not shows."""
    b, n, c = x.shape
    backward = g is not None
    nbytes = lib.emu_workspace(b, n, c, k, int(backward))
    assert nbytes >= 0
    work = torch.full((nbytes // 4 + 1,), float("nan")) if nbytes else None
    nan = float("nan")
    grs = torch.full((b, n, k, c), nan) if backward else None
    levels = torch.full((b, n, k), 7.0) if backward else None
    dx = torch.full((b, n, c), nan) if backward else None
    if op == "concat":
        xn = torch.empty_like(x)
        out = None if backward else torch.full((b, n, 2 * c), nan)
        err = lib.emu_concat(_ptr(x), _ptr(xn), _ptr(out), _ptr(g), _ptr(grs), _ptr(levels),
                             _ptr(dx), _ptr(work), b, n, c, k)
    else:
        xn = l2_normalize(x)
        out = None if backward else torch.full((b, n, c), nan)
        err = lib.emu_neighbors(_ptr(xn), _ptr(x), _ptr(out), _ptr(g), _ptr(grs), _ptr(levels),
                                _ptr(dx), _ptr(work), b, n, c, k)
    assert err == 0
    return dx if backward else (out[..., c:] if op == "concat" else out)


def _band(keys: torch.Tensor, k: int, backward: bool) -> torch.Tensor:
    """chip_smoke.py's near-tie band in f32 (gap in (0, 1e-4))."""
    s = torch.bmm(keys.double(), keys.double().transpose(1, 2))
    top = s.topk(min(k + 1, s.shape[-1]), dim=-1).values
    gaps = top[..., :-1] - top[..., 1:]
    near = ((gaps > 0) & (gaps < 1e-4)).any(-1)
    return ((s >= top[..., -1:]) & near[..., None]).any(1) if backward else near


CASES = {
    # build, (B, N, C, k), input kind
    "one-pass-k3": ("real", (2, 128, 16, 3), "random"),
    "one-pass-k8": ("real", (1, 256, 8, 8), "duplicates"),
    "groups-k9": ("real", (1, 256, 8, 9), "random"),
    "groups-k9-ties": ("real", (1, 256, 8, 9), "duplicates"),
    "groups-k=N=12": ("real", (1, 12, 4, 12), "scaled"),
    "windows-k3": ("tiny", (1, 300, 8, 3), "scaled"),
    "windows-identical": ("tiny", (1, 300, 8, 3), "identical"),
    "windows-groups-k9": ("tiny", (1, 300, 8, 9), "duplicates"),
    "windows-B2-k2": ("tiny", (2, 200, 12, 2), "random"),
    "windows-N-under-a-tile": ("tiny", (1, 64, 8, 5), "random"),
    "windows-C72": ("tiny", (1, 130, 72, 3), "random"),
    "windows-k=N=40": ("tiny", (1, 40, 8, 40), "duplicates"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_selection_matches_plain_versions(libs, case):
    build, (b, n, c, k), kind = CASES[case]
    lib = libs[build]
    x = torch.from_numpy(wide_input((b, n, c), k, kind, np.random.RandomState(len(case))))
    rs = np.random.RandomState(n + k)
    g_cat = torch.from_numpy(rs.randn(b, n, 2 * c).astype(np.float32))
    g_rel = torch.from_numpy(rs.randn(b, n, c).astype(np.float32))
    refs = {("concat", False): lambda: mrconv_concat_reference(x, k)[..., c:],
            ("concat", True): lambda: mrconv_concat_backward_reference(x, g_cat, k),
            ("neighbors", False): lambda: max_neighbors_reference(x, k),
            ("neighbors", True): lambda: max_neighbors_backward_reference(x, g_rel, k)}
    for (op, backward), ref in refs.items():
        g = (g_cat if op == "concat" else g_rel) if backward else None
        got, again = _run(lib, op, x, g, k), _run(lib, op, x, g, k)
        want = ref()
        assert torch.equal(got, again), (op, backward)
        assert bool(torch.isfinite(got).all()), (op, backward)
        keys = _norm_rows_f32(x) if op == "concat" else l2_normalize(x)
        bad = ~((got - want).abs() <= 1e-5 + 1e-5 * want.abs()).all(-1)
        assert not bool((bad & ~_band(keys, k, backward)).any()), (op, backward)
        assert int(bad.sum()) <= max(1, 0.01 * bad.numel()), (op, backward)


def test_workspace_follows_the_plan(libs):
    """None for the one-pass shapes; for a split call the running max and,
    in the backward, the winners and divisors (at least); the window sums
    only where the keys do not fit one window."""
    lib = libs["real"]
    assert lib.emu_workspace(128, 1024, 64, 3, 1) == 0
    assert lib.emu_workspace(128, 1024, 64, 8, 1) == 0
    assert lib.emu_workspace(128, 1024, 64, 9, 0) >= 128 * 1024 * 64 * 4
    assert lib.emu_workspace(128, 1024, 64, 9, 1) >= 128 * 1024 * (2 * 64 + 9) * 4
    assert lib.emu_workspace(1, 4, 8, 5, 0) == -1                 # N < k
    tiny = libs["tiny"]
    assert tiny.emu_workspace(1, 300, 8, 3, 0) >= 300 * 3 * 8 * 4  # window sums
