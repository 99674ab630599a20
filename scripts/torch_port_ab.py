#!/usr/bin/env python3
"""A/B of the port's MRConv kernel and serving forward between two
checkouts, on one card, in one call.

    python3 scripts/torch_port_ab.py OTHER_CHECKOUT

OTHER_CHECKOUT is another tree of this repository (e.g. the parent commit
unpacked with ``git archive`` into a git-ignored directory). Each side
runs in its own process, importing its own ``grafp_tpu_torch`` (and
building its own kernels), in the order other, this, this, other. Every
side gets the same seeded inputs; the script checks that both sides'
kernel outputs are bit-identical (by hash) and prints, per run, the
kernel's time at each size-t stage shape (bf16 and f32, B=128) and the
bf16 wave -> fingerprint forward at B=128, with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

STAGES = ((1024, 64), (512, 128), (256, 256), (128, 512))
B = 128


def _time_ms(fn, reps: int) -> float:
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def worker(root: str) -> dict:
    """One side: import the package under ``root`` and measure."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from grafp_tpu_torch.core import Config
    from grafp_tpu_torch.fp import FingerprintPipeline
    from grafp_tpu_torch.models import build_model
    from grafp_tpu_torch.ops.mrconv_concat import mrconv_concat

    out = {"kernel": {}, "hash": {}}
    g = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        for n, c in STAGES:
            x = torch.randn(B, n, c, device="cuda", generator=g).to(dtype)
            key = f"{str(dtype)[6:]} N={n} C={c}"
            y = mrconv_concat(x, 3)
            out["hash"][key] = hashlib.sha256(
                y.view(torch.uint8).cpu().numpy().tobytes()).hexdigest()
            out["kernel"][key] = _time_ms(lambda: mrconv_concat(x, 3), 20)
    cfg = Config(compute_dtype="bfloat16")
    pipe = FingerprintPipeline(
        build_model(cfg, generator=torch.Generator().manual_seed(0)), cfg)
    waves = torch.randn(B, cfg.clip_frames, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(1))
    out["forward_ms"] = _time_ms(lambda: pipe.fingerprint_waves(waves), 10)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", nargs="?")
    ap.add_argument("--worker", metavar="ROOT")
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker)))
        return 0
    if not args.other:
        ap.error("OTHER_CHECKOUT is required")
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    runs = []
    for name, root in (("other", args.other), ("this", here),
                       ("this", here), ("other", args.other)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--worker", root], capture_output=True,
                              text=True, check=True, timeout=1800)
        runs.append((name, json.loads(proc.stdout.strip().splitlines()[-1])))
    hashes = {json.dumps(r["hash"], sort_keys=True) for _, r in runs}
    print(f"kernel outputs bit-identical across sides: {len(hashes) == 1}")
    for key in runs[0][1]["kernel"]:
        cols = ", ".join(f"{n} {r['kernel'][key]:.4f}" for n, r in runs)
        print(f"kernel {key}: {cols} ms [{card}]")
    cols = ", ".join(f"{n} {r['forward_ms']:.3f} ({B / r['forward_ms'] * 1e3:.1f} fp/s)"
                     for n, r in runs)
    print(f"forward bf16 B={B}: {cols} ms [{card}]")
    return 0 if len(hashes) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
