#!/usr/bin/env python3
"""Where the time goes in the port's serving forward or train step on one
NVIDIA card.

    python3 scripts/torch_port_profile.py [--batch 128] [--dtype bfloat16]
                                          [--train | --fused] [--trace PATH.json]

Serving (default): the size-t model with seeded random weights,
FingerprintPipeline.fingerprint_waves at ``--batch`` waves; ``--fused``
serves the same weights through GraphEncoder(fuse_serving='on'). ``--train``:
one train step of the size-t model at bsz_train ``--batch`` (default
256, so one stacked 2B forward), with chip_smoke.py's seeded synthetic
noise and IR banks. Warms up, then runs a few iterations under
torch.profiler. Prints the card (nvidia-smi name and power limit), the
wall time per iteration (host clock around synchronised work), the device
time summed over kernels, the device idle share, the time of the port's
MRConv selection kernels and of the fused block's product kernels, and the
kernels by device time. ``--trace`` also writes
the Chrome trace to that path.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import time

import torch


def _kind(key: str):
    """'forward', 'backward' or 'products' for the port's selection and
    product kernels (csrc/mrconv_select.cuh, csrc/grapher_gemm.cuh), by
    demangled or mangled name; None for any other kernel.

    mrconv_rows_kernel<T, KC, kBackward, kConcat> is the forward, or pass A
    of the backward; mrconv_keys_kernel<T, KC, kConcat> is pass B; the
    fused block's products are grapher_gemm_wgmma_kernel<kEpi> (bf16) and
    grapher_gemm_f32_kernel<kEpi> (f32)."""
    if "grapher_gemm" in key:
        return "products"
    if "mrconv_keys_kernel" in key:
        return "backward"
    if "mrconv_rows_kernel" not in key:
        return None
    # demangled: mrconv_rows_kernel<T, KC, kBackward, kConcat>
    args = key.split("mrconv_rows_kernel<", 1)[-1].split(">", 1)[0].split(", ")
    flags = [a for a in args if a in ("true", "false")]
    if flags:
        return "backward" if flags[0] == "true" else "forward"
    # mangled: mrconv_rows_kernelI<T>Li<KC>ELb<kBackward>ELb<kConcat>E...
    flag = re.search(r"mrconv_rows_kernelI.*?Lb([01])E", key)
    return "backward" if flag and flag.group(1) == "1" else "forward"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, help="serving batch (128) or "
                    "bsz_train (256) with --train")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--train", action="store_true", help="profile a train step")
    ap.add_argument("--fused", action="store_true",
                    help="serve through GraphEncoder(fuse_serving='on')")
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
    gen = torch.Generator(device="cuda").manual_seed(1)
    if args.train:
        from chip_smoke import synthetic_banks
        from grafp_tpu_torch.train import create_train_state, make_train_step

        cfg = Config(compute_dtype=args.dtype, bsz_train=args.batch or 256)
        model = build_model(cfg, generator=torch.Generator().manual_seed(0),
                            train=True)
        state = create_train_state(model, cfg)
        step = make_train_step(model, cfg, synthetic_banks(cfg, seed=4))
        x = torch.randn(cfg["bsz_train"], cfg.clip_frames, device="cuda",
                        generator=gen)
        run = lambda: step(state, x, x, gen)  # noqa: E731
        what = f"train step {args.dtype} bsz_train={cfg['bsz_train']}"
    else:
        cfg = Config(compute_dtype=args.dtype)
        model = build_model(cfg, generator=torch.Generator().manual_seed(0))
        if args.fused:
            from chip_smoke import fused_model

            model = fused_model(cfg, model.state_dict())
        pipe = FingerprintPipeline(model, cfg)
        waves = torch.randn(args.batch or 128, cfg.clip_frames, device="cuda",
                            generator=gen)
        run = lambda: pipe.fingerprint_waves(waves)  # noqa: E731
        what = (f"{'fused ' if args.fused else ''}forward {args.dtype} "
                f"B={args.batch or 128}")
    for _ in range(3):
        run()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.iters
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    rows = sorted(((e.device_time_total / 1e3 / args.iters,
                    e.count // args.iters, e.key) for e in events), reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"card: {card}")
    if not busy:
        print("device time: not measured (the profiler saw no CUDA kernels)")
        return 1
    print(f"{what}: wall {wall * 1e3:.3f} ms (profiler on), device busy "
          f"{busy:.3f} ms, idle share {1 - busy / (wall * 1e3):.3f}")
    groups = {"forward": 0.0, "backward": 0.0, "products": 0.0}
    for ms, _, key in rows:
        kind = _kind(key)
        if kind:
            groups[kind] += ms
    print(f"selection kernels per iteration: forward {groups['forward']:.3f} ms, "
          f"backward {groups['backward']:.3f} ms (normalize_rows_kernel listed "
          f"apart); fused block products {groups['products']:.3f} ms")
    for ms, count, key in rows[:30]:
        print(f"  {ms:9.3f} ms  x{count:<4d} {key[:110]}")
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
