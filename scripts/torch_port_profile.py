#!/usr/bin/env python3
"""Where the time goes in the port's serving forward on one NVIDIA card.

    python3 scripts/torch_port_profile.py [--batch 128] [--dtype bfloat16]
                                          [--trace PATH.json]

Builds the size-t model with seeded random weights, warms up, then runs
FingerprintPipeline.fingerprint_waves under torch.profiler for a few
iterations. Prints the card (nvidia-smi name and power limit), the wall
time per forward (host clock around synchronised work), the device time
summed over kernels, the device idle share, and the kernels by device
time. ``--trace`` also writes the Chrome trace to that path.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--trace", help="write the Chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_port_profile: no CUDA card", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from torch.profiler import ProfilerActivity, profile

    from grafp_tpu_torch.core import Config
    from grafp_tpu_torch.fp import FingerprintPipeline
    from grafp_tpu_torch.models import build_model

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    cfg = Config(compute_dtype=args.dtype)
    pipe = FingerprintPipeline(
        build_model(cfg, generator=torch.Generator().manual_seed(0)), cfg)
    waves = torch.randn(args.batch, cfg.clip_frames, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(1))
    for _ in range(3):
        pipe.fingerprint_waves(waves)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            pipe.fingerprint_waves(waves)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.iters
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    rows = sorted(((e.device_time_total / 1e3 / args.iters,
                    e.count // args.iters, e.key) for e in events), reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"card: {card}")
    print(f"forward {args.dtype} B={args.batch}: wall {wall * 1e3:.3f} ms "
          f"(profiler on), device busy {busy:.3f} ms, idle share "
          f"{1 - busy / (wall * 1e3):.3f}" if busy else
          "device time: not measured (the profiler saw no CUDA kernels)")
    for ms, count, key in rows[:25]:
        print(f"  {ms:9.3f} ms  x{count:<4d} {key[:110]}")
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
