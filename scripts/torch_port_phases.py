#!/usr/bin/env python3
"""Where the time of the MRConv selection kernels (#3 forward, #4
backward) goes, phase by phase, on one card.

    python3 scripts/torch_port_phases.py

Builds timing-only variants of ``csrc/mrconv_select.cuh``, each in a copy
of the package in a temporary directory with phases cut out of the source
(their outputs are wrong; only their times count):

  * ``full``: the kernels as they are;
  * ``no-extraction``: the row kernel without step 3 (the walk over the
    hit bitmaps, the sums and the output or G writes);
  * ``scores-only``: also without pass 1's fold into the level lists, so
    no row has a level, no tie and no hit: what is left is the score pass
    (and the normalisation launch);
  * ``no-gather``: the key kernel (pass B) without its walk and sums;
  * ``walk-only``: both kernels walk their hit bitmaps and add, but load
    no row (of x in the row kernel, of G in pass B).

Each variant runs in its own process and times, with CUDA events, the
``mrconv_concat`` forward at B = 128 (bf16 and f32) and the backward at
B = 512 (bf16) at the size-t stage shapes. Then, per shape: scores =
scores-only; selection = no-extraction - scores-only; extraction = full -
no-extraction (forward and pass A); pass B's gather = full - no-gather
(backward); the gathers' row loads = full - walk-only. Prints the card's
name and power limit beside every line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

STAGES = ((1024, 64), (512, 128), (256, 256), (128, 512))
CASES = (("forward", "bfloat16", 128), ("forward", "float32", 128),
         ("backward", "bfloat16", 512))
K = 3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the lines each variant cuts (every one must be in the source)
_EXTRACT = "  if (i >= n) return;\n  const unsigned* rbits"
_FOLD = "      while (m > -INFINITY && m >= fl[h] && m >= own[h]) {"
_GATHER = "  if (j >= n) return;\n  const unsigned* kb"
_LOAD_X = "        load_lane<W>(xb + (size_t)j * c, c0, c, full, v);"
_LOAD_G = "        load_lane<kLaneCh>(gb + ((size_t)i * k + r) * c, c0, c, full, v);"
_NO_EXTRACT = (_EXTRACT, _EXTRACT.replace("i >= n", "i >= n || rr >= 0"))
VARIANTS = {
    "full": (),
    "no-extraction": (_NO_EXTRACT,),
    "scores-only": (_NO_EXTRACT, (_FOLD, "      while (false) {")),
    "no-gather": ((_GATHER, _GATHER.replace("j >= n", "j >= n || jj >= 0")),),
    # the walks still add what they would have loaded, so they stay
    "walk-only": ((_LOAD_X, "        for (int e = 0; e < W; ++e) v[e] = (float)j;"),
                  (_LOAD_G, "        for (int e = 0; e < kLaneCh; ++e) v[e] = (float)i;")),
}


def make_variant(tmp: str, name: str) -> str:
    """A copy of the package under tmp/name with the variant's cuts."""
    dst = os.path.join(tmp, name)
    shutil.copytree(os.path.join(ROOT, "grafp_tpu_torch"),
                    os.path.join(dst, "grafp_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(dst, "grafp_tpu_torch", "csrc", "mrconv_select.cuh")
    with open(path) as f:
        text = f.read()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise RuntimeError(f"variant {name}: line not found: {old.strip()}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return dst


def worker(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    from grafp_tpu_torch.ops.mrconv_concat import mrconv_concat, mrconv_concat_backward

    out = {}
    for op, dtype, b in CASES:
        for n, c in STAGES:
            g = torch.Generator(device="cuda").manual_seed(n)
            x = torch.randn(b, n, c, device="cuda", generator=g).to(getattr(torch, dtype))
            if op == "forward":
                run = lambda: mrconv_concat(x, K)  # noqa: E731
            else:
                gy = torch.randn(b, n, 2 * c, device="cuda", generator=g).to(x.dtype)
                run = lambda: mrconv_concat_backward(x, gy, K)  # noqa: E731
            for _ in range(2):
                run()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            reps = 10
            torch.cuda.synchronize()
            start.record()
            for _ in range(reps):
                run()
            end.record()
            torch.cuda.synchronize()
            out[f"{op} {dtype} B={b} N={n} C={c}"] = start.elapsed_time(end) / reps
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", metavar="ROOT")
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker)))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    ms = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in VARIANTS:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 make_variant(tmp, name)],
                capture_output=True, text=True, timeout=1200)
            if proc.returncode != 0:
                print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
                return 1
            ms[name] = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"card: {card}")
    for key, full in ms["full"].items():
        loads = full - ms["walk-only"][key]
        if key.startswith("forward"):
            scores = ms["scores-only"][key]
            parts = (f"scores {scores:.4f}, selection "
                     f"{ms['no-extraction'][key] - scores:.4f}, extraction "
                     f"{full - ms['no-extraction'][key]:.4f} (its row loads "
                     f"{loads:.4f})")
        else:
            parts = (f"pass A's extraction {full - ms['no-extraction'][key]:.4f}, "
                     f"pass B's gather {full - ms['no-gather'][key]:.4f}, "
                     f"the row loads of both {loads:.4f}")
        print(f"phases {key}: full {full:.4f} ms: {parts} ms [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
