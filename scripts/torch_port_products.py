#!/usr/bin/env python3
"""The fused Grapher block's three products (#5's fc1, grouped conv and
fc2, ``csrc/grapher_gemm.cuh``) alone, against ``torch.mm``, on one card.

    python3 scripts/torch_port_products.py

At every size-t stage shape (B = 128, M = B N rows) it times each product
as the block launches it: fc1 (M, C) x (C, C) + bias, the grouped conv
(M, 2C) x (2C, 2C) + bias, relu, and fc2 (M, 2C) x (2C, C) + bias + the
residual, in bf16 (every stage) and f32 (the stages the guard admits),
with CUDA events, beside ``torch.mm`` on the same operands (bf16 with f32
outputs, as ``models/layers.py:dense_matmul_bf16grad`` calls it; f32 in
full f32) and the product's bound (bytes over 3.35 TB/s, operations over
989 / 67 TFLOP/s). The bf16 kernel is also timed in timing-only variants,
each built from a copy of ``csrc/`` in a temporary directory with parts
cut out of the source (their outputs are wrong; only their times count):

  * ``no-store``: the output tiles are never stored;
  * ``no-mma``: no wgmma (loads, hand-over, epilogue and stores remain);
  * ``loads-only``: the operands' TMA ring and its hand-over alone.

Every variant's library exports one more entry point, ``products_gemm``,
appended to its copy of ``csrc/grapher_block.cu``; the package's own
library is not touched. Prints the card's name and power limit beside
every line, and the full kernel's largest error against an f32 product
(a sanity check: the card tests hold the block against its plain
version).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from grafp_tpu_torch.ops import build  # noqa: E402
from grafp_tpu_torch.ops.grapher_block import grapher_block_supported  # noqa: E402

STAGES = ((1024, 64), (512, 128), (256, 256), (128, 512))
B, K = 128, 3
HBM_BPS, PEAK = 3.35e12, {torch.bfloat16: 989e12, torch.float32: 67e12}

_LOOP = "for (int j = 0; j < NCH * 8; ++j) {\n      const int col = n0 + 8 * j + 2 * q;"
_STORE = "tma_store(map_out, out_s + c * kOutChunk, n0 + c * kWgChunk, (int)m0 + 64 * cw);"
_MMA = ("wgmma_bf16<NCH>(acc, smem_desc(a_s + kk * 32, 16, 1024),\n"
        "                      smem_desc(b_s + kk * 16 * 128, kBChunk, 1024));")
_NO_MMA = (_MMA, "(void)a_s; (void)b_s;")
_NO_STORE = (_STORE, "(void)map_out;")
VARIANTS = {
    "full": (),
    "no-store": (_NO_STORE,),
    "no-mma": (_NO_MMA,),
    "loads-only": (_NO_MMA, _NO_STORE, (_LOOP, _LOOP.replace("j < NCH * 8", "j < 0"))),
}

_ENTRY = """
extern "C" int products_gemm(const void* a, const void* w, const void* bias, const void* res,
                             void* out, long long m, int kdim, int ncols, int epi, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fb = static_cast<const float*>(bias);
  if (dtype == 1) {
    using T = __nv_bfloat16;
    const T *ta = static_cast<const T*>(a), *tw = static_cast<const T*>(w);
    if (epi == 0) return gemm<kEpiBias>(ta, tw, fb, nullptr, static_cast<T*>(out), m, kdim, ncols, s);
    if (epi == 1) return gemm<kEpiBiasRelu>(ta, tw, fb, nullptr, static_cast<T*>(out), m, kdim, ncols, s);
    return gemm<kEpiBiasResidual>(ta, tw, fb, static_cast<const T*>(res), static_cast<T*>(out),
                                  m, kdim, ncols, s);
  }
  using T = float;
  const T *ta = static_cast<const T*>(a), *tw = static_cast<const T*>(w);
  if (epi == 0) return gemm<kEpiBias>(ta, tw, fb, nullptr, static_cast<T*>(out), m, kdim, ncols, s);
  if (epi == 1) return gemm<kEpiBiasRelu>(ta, tw, fb, nullptr, static_cast<T*>(out), m, kdim, ncols, s);
  return gemm<kEpiBiasResidual>(ta, tw, fb, static_cast<const T*>(res), static_cast<T*>(out),
                                m, kdim, ncols, s);
}
"""


def build_variants(tmp: str) -> dict:
    """One library per variant, all nvcc runs started together."""
    procs = {}
    for name, cuts in VARIANTS.items():
        src = os.path.join(tmp, name)
        shutil.copytree(build.SRC_DIR, src)
        path = os.path.join(src, "grapher_gemm.cuh")
        with open(path) as f:
            text = f.read()
        for old, new in cuts:
            if old not in text:
                raise RuntimeError(f"variant {name}: line not found: {old.strip()}")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
        with open(os.path.join(src, "grapher_block.cu"), "a") as f:
            f.write(_ENTRY)
        lib = os.path.join(src, "libproducts.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", lib, os.path.join(src, "grapher_block.cu")]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log[-4000:]}")
        lib = ctypes.CDLL(path)
        lib.products_gemm.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                                      + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.products_gemm.restype = ctypes.c_int
        libs[name] = lib
    return libs


def time_ms(fn, reps: int = 30) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(m: int, k: int, n: int, epi: int, dtype: torch.dtype):
    size = 2 if dtype == torch.bfloat16 else 4
    byts = size * (m * k + k * n + m * n * (2 if epi == 2 else 1)) + 4 * n
    t_bytes, t_ops = byts / HBM_BPS, 2 * m * k * n / PEAK[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_port_products.py needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tmp)
        for dtype in (torch.bfloat16, torch.float32):
            names = list(VARIANTS) if dtype == torch.bfloat16 else ["full"]
            code = 1 if dtype == torch.bfloat16 else 0
            for n, c in STAGES:
                if dtype == torch.float32 and not grapher_block_supported(n, c, dtype, K):
                    continue
                m = B * n
                sums = dict.fromkeys(names + ["torch.mm"], 0.0)
                for label, kdim, ncols, epi in (("fc1", c, c, 0), ("grouped conv", 2 * c, 2 * c, 1),
                                                ("fc2", 2 * c, c, 2)):
                    a = torch.randn(m, kdim, device="cuda", generator=g).to(dtype)
                    w = (torch.randn(kdim, ncols, device="cuda", generator=g)
                         * kdim ** -0.5).to(dtype)
                    bias = torch.randn(ncols, device="cuda", generator=g)
                    res = torch.randn(m, ncols, device="cuda", generator=g).to(dtype)
                    out = torch.empty(m, ncols, device="cuda", dtype=dtype)
                    cols = []
                    for name in names:
                        lib = libs[name]

                        def run(lib=lib):
                            err = lib.products_gemm(a.data_ptr(), w.data_ptr(), bias.data_ptr(),
                                                    res.data_ptr(), out.data_ptr(), m, kdim,
                                                    ncols, epi, code, stream)
                            if err != 0:
                                raise RuntimeError(f"products_gemm returned {err}")

                        t = time_ms(run)
                        sums[name] += t
                        cols.append(f"{name} {t:.4f}")
                        if name == "full":
                            run()
                            want = a.float() @ w.float() + bias
                            want = want.relu() if epi == 1 else want
                            want = want + res.float() if epi == 2 else want
                            err = (out.float() - want).abs().max().item()
                    kw = {"out_dtype": torch.float32} if dtype == torch.bfloat16 else {}
                    t_mm = time_ms(lambda: torch.mm(a, w, **kw))
                    sums["torch.mm"] += t_mm
                    b_ms, b_by = bound(m, kdim, ncols, epi, dtype)
                    print(f"product {str(dtype)[6:]} N={n} C={c} {label} ({m} x {kdim} x "
                          f"{ncols}): " + ", ".join(cols) + f"; torch.mm {t_mm:.4f}; bound "
                          f"{b_ms:.4f} ({b_by}) ms; max abs err {err:.3g} [{card}]", flush=True)
                    del a, w, bias, res, out
                print(f"products {str(dtype)[6:]} N={n} C={c}, the three: "
                      + ", ".join(f"{k} {v:.4f}" for k, v in sums.items()) + f" ms [{card}]",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
