#!/usr/bin/env python3
"""A/B of the port's MRConv kernels (#3 forward, #4 backward), the
neighbour-max kernels (#1 forward, #2 backward), the fused Grapher block
(#5) and the serving forward between two checkouts, on one card, in one
call.

    python3 scripts/torch_port_ab.py OTHER_CHECKOUT

OTHER_CHECKOUT is another tree of this repository (e.g. the parent commit
unpacked with ``git archive`` into a git-ignored directory). Each side
runs in its own process, importing its own ``grafp_tpu_torch`` (and
building its own kernels), in the order other, this, this, other. Every
side gets the same seeded inputs at the size-t stage shapes:
``mrconv_concat`` at B = 128 (f32 and bf16) and B = 512 (bf16),
``mrconv_concat_backward`` at B = 128 (f32) and B = 512 (bf16),
``max_neighbors`` and ``max_neighbors_backward`` at B = 128 (f32) and
B = 512 (bf16), ``grapher_block`` at B = 128 (f32 and bf16, the stage
shapes its guard admits, seeded random folded weights), the bf16 wave
-> fingerprint forward at B = 128 of size t and of NAFP
(``Config(arch='nafp', n_mels=256)``), the size-t and the NAFP train
steps at 2B = 512 in f32 and in bf16 (``make_train_step`` on seeded
waves and augment banks, seeded weights), and the training of 'ivf' (k-means, k = 400) and 'ivfpq'
(k-means, k = 64, and the 64 PQ codebooks) on TRAIN_ROWS seeded unit rows
(``get_index``: seconds, the card's peak memory, and a hash of the
centroids and codebooks). The first run of each side saves its kernel outputs;
the script then checks that

  * f32 outputs are bit-identical across the two trees (hash-equal),
  * bf16 rows of #1-#4 that differ between the trees lie inside the
    near-tie band of chip_smoke.py (NEAR_TIE_EPS: rows whose plain
    top-(k+1) scores have a gap in (0, 1e-3); for dx, those rows'
    top-(k+1) rows), and
  * each tree's bf16 #5 rows outside chip_smoke.py's block tolerance
    against the plain version lie inside the near-tie band of the plain
    x1's scores (the rows that differ between the trees are counted),

and prints per-stage times of every run (for #5 also the time of its
product kernels, from the profiler), the train steps' and the index
trainings' times, and whether each tree trained the same centroids and
codebooks in its two runs, with the card's name and power limit. It exits
1 when a check fails (the index hashes are printed, not checked: a tree
whose k-means is not deterministic is what they show).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile

STAGES = ((1024, 64), (512, 128), (256, 256), (128, 512))
B, BT, K = 128, 512, 3
TRAIN_PAIRS = 256                          # the train step's bsz_train: 2B = 512
TRAIN_ROWS = 1 << 20                       # rows the indexes train on
ARCHS = ("grafp", "nafp")                  # size t and NAFP
ARCH_DTYPES = tuple((a, d) for a in ARCHS for d in ("float32", "bfloat16"))
# (op, dtype, batch): what each side runs at every stage shape
CASES = (("forward", "bfloat16", B), ("forward", "float32", B),
         ("forward", "bfloat16", BT), ("backward", "float32", B),
         ("backward", "bfloat16", BT), ("op_forward", "float32", B),
         ("op_forward", "bfloat16", BT), ("op_backward", "float32", B),
         ("op_backward", "bfloat16", BT), ("block", "float32", B),
         ("block", "bfloat16", B))


def _time_ms(fn, reps: int) -> float:
    import torch

    for _ in range(2):
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


def case_inputs(idx: int, op: str, dtype: str, b: int, n: int, c: int):
    """The seeded inputs of case ``idx``: x (b, n, c) and, for a
    backward, the cotangent ((b, n, 2c) for #4, (b, n, c) for #2), on the
    card."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(1000 + idx)
    dt = getattr(torch, dtype)
    x = torch.randn(b, n, c, device="cuda", generator=g).to(dt)
    width = {"backward": 2 * c, "op_backward": c}.get(op)
    gy = (torch.randn(b, n, width, device="cuda", generator=g).to(dt)
          if width else None)
    return x, gy


def block_weights(idx: int, c: int, dtype: str):
    """Seeded folded weights (w1, c1, wg, cg, w2, c2) of case ``idx``."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(2000 + idx)
    dt = getattr(torch, dtype)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, device="cuda", generator=g)

    return (rnd(c, c, scale=c ** -0.5).to(dt), rnd(1, c, scale=0.1),
            rnd(2 * c, 2 * c, scale=(2 * c) ** -0.5).to(dt), rnd(1, 2 * c, scale=0.1),
            rnd(2 * c, c, scale=(2 * c) ** -0.5).to(dt), rnd(1, c, scale=0.1))


def cases():
    import torch

    from grafp_tpu_torch.ops.grapher_block import grapher_block_supported

    for op, dtype, b in CASES:
        for n, c in STAGES:
            if op == "block" and not grapher_block_supported(n, c, getattr(torch, dtype), K):
                continue
            yield f"{op} {dtype} B={b} N={n} C={c}", (op, dtype, b, n, c)


def products_ms(run, iters: int = 5) -> float:
    """Device time per call of the kernels named grapher_gemm* (the fused
    block's products) under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if "grapher_gemm" in e.key) / 1e3 / iters


def arch_config(arch: str, dtype: str):
    """Size t ('grafp') or NAFP (the repo has no NAFP config) in ``dtype``."""
    from grafp_tpu_torch.core import Config

    if arch == "nafp":
        return Config(arch="nafp", n_mels=256, compute_dtype=dtype)
    return Config(compute_dtype=dtype)


def train_step_ms(reps: int = 5) -> dict:
    """{"ARCH DTYPE": ms} of one train step at TRAIN_PAIRS pairs, size t
    ('grafp') and NAFP, f32 and bf16."""
    import numpy as np
    import torch

    from grafp_tpu_torch.dsp.augment import AugmentBanks
    from grafp_tpu_torch.models import build_model
    from grafp_tpu_torch.train import create_train_state, make_train_step

    rs = np.random.RandomState(0)
    banks = AugmentBanks.from_arrays(
        noise_clips=[rs.randn(64000).astype(np.float32) for _ in range(8)],
        ir_clips=[np.r_[1.0, rs.randn(8000) * 0.05].astype(np.float32) for _ in range(4)],
        noise_len=64000, ir_len=8192)
    out = {}
    for arch, dtype in ARCH_DTYPES:
        cfg = arch_config(arch, dtype)
        model = build_model(cfg, generator=torch.Generator().manual_seed(0), train=True)
        state = create_train_state(model, cfg, steps_per_epoch=100)
        step = make_train_step(model, cfg, banks)
        x_i, x_j = (torch.as_tensor(rs.randn(TRAIN_PAIRS, cfg.clip_frames).astype(np.float32),
                                    device="cuda") for _ in range(2))
        gen = torch.Generator(device="cuda").manual_seed(1)
        out[f"{arch} {dtype}"] = _time_ms(lambda: step(state, x_i, x_j, gen), reps)
        del model, state, step
        torch.cuda.empty_cache()
    return out


def index_training() -> dict:
    """{index type: (train seconds, card peak GB, hash of the centroids and
    codebooks)} of 'ivf' and 'ivfpq' trained on TRAIN_ROWS seeded unit
    rows."""
    import contextlib
    import io
    import time

    import numpy as np
    import torch

    from grafp_tpu_torch.retrieval.index import get_index

    x = np.random.RandomState(3).standard_normal((TRAIN_ROWS, 128)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    out = {}
    for kind in ("ivf", "ivfpq"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            index = get_index(kind, x, x.shape)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        trained = [index.centroids] + ([index.pq.codebooks] if kind == "ivfpq" else [])
        digest = hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in trained))
        out[kind] = (secs, torch.cuda.max_memory_allocated() / 1e9, digest.hexdigest())
        del index
        torch.cuda.empty_cache()
    return out


def worker(root: str, save: str | None) -> dict:
    """One side: import the package under ``root`` and measure."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from grafp_tpu_torch.fp import FingerprintPipeline
    from grafp_tpu_torch.models import build_model
    from grafp_tpu_torch.ops.grapher_block import grapher_block
    from grafp_tpu_torch.ops.max_neighbors import max_neighbors, max_neighbors_backward
    from grafp_tpu_torch.ops.mrconv_concat import mrconv_concat, mrconv_concat_backward

    out = {"ms": {}, "hash": {}, "products_ms": {}}
    for idx, (key, (op, dtype, b, n, c)) in enumerate(cases()):
        x, gy = case_inputs(idx, op, dtype, b, n, c)
        if op == "forward":
            run = lambda: mrconv_concat(x, K)  # noqa: E731
        elif op == "backward":
            run = lambda: mrconv_concat_backward(x, gy, K)  # noqa: E731
        elif op == "op_forward":
            run = lambda: max_neighbors(x, K)  # noqa: E731
        elif op == "op_backward":
            run = lambda: max_neighbors_backward(x, gy, K)  # noqa: E731
        else:
            ws = block_weights(idx, c, dtype)
            run = lambda: grapher_block(x, K, *ws)  # noqa: E731
            out["products_ms"][key] = products_ms(run)
        y = run()
        out["hash"][key] = hashlib.sha256(
            y.view(torch.uint8).cpu().numpy().tobytes()).hexdigest()
        if save:
            torch.save(y.cpu(), os.path.join(save, f"{idx}.pt"))
        out["ms"][key] = _time_ms(run, 20 if b == B else 5)
        del x, gy, y
        torch.cuda.empty_cache()
    out["forward_ms"] = {}
    for arch in ARCHS:
        cfg = arch_config(arch, "bfloat16")
        pipe = FingerprintPipeline(
            build_model(cfg, generator=torch.Generator().manual_seed(0)), cfg)
        waves = torch.randn(B, cfg.clip_frames, device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(1))
        out["forward_ms"][arch] = _time_ms(lambda: pipe.fingerprint_waves(waves), 10)
        del pipe
        torch.cuda.empty_cache()
    out["step_ms"] = train_step_ms()
    out["index"] = index_training()
    return out


def compare(here: str, this_dir: str, other_dir: str) -> bool:
    """f32 outputs bit-identical; bf16 rows that differ inside the band."""
    import torch

    sys.path.insert(0, here)
    from chip_smoke import backward_band, block_within, concat_keys, forward_band, op_keys

    from grafp_tpu_torch.ops.grapher_block import _mm, grapher_block_reference

    ok = True
    for idx, (key, (op, dtype, b, n, c)) in enumerate(cases()):
        a = torch.load(os.path.join(this_dir, f"{idx}.pt")).cuda()
        o = torch.load(os.path.join(other_dir, f"{idx}.pt")).cuda()
        if op == "forward":
            a, o = a[..., c:], o[..., c:]
        rows = (a != o).any(-1)
        if dtype == "float32":
            same = not bool(rows.any())
            print(f"check {key}: f32 bit-identical across trees: {same}")
            ok &= same
            continue
        x, _ = case_inputs(idx, op, dtype, b, n, c)
        if op == "block":
            ws = block_weights(idx, c, dtype)
            want = grapher_block_reference(x, K, *ws)
            x1 = (_mm(x.reshape(b * n, c), ws[0]) + ws[1]).to(x.dtype).reshape(b, n, c)
            band = forward_band(concat_keys(x1), K)
            cols = []
            for name, y in (("this", a), ("other", o)):
                bad = ~block_within(y, want).all(-1)
                outside = int((bad & ~band).sum())
                cols.append(f"{name} tree vs plain: {int(bad.sum())} rows outside the "
                            f"tolerance, {outside} of them outside the near-tie band")
                ok &= outside == 0
            print(f"check {key}: bf16 rows differing between the trees "
                  f"{int(rows.sum())}/{rows.numel()}; " + "; ".join(cols))
            del a, o, x, want, x1, band
            torch.cuda.empty_cache()
            continue
        keys = op_keys(x) if op.startswith("op_") else concat_keys(x)
        band = (forward_band(keys, K) if op.endswith("forward")
                else backward_band(keys, K))
        outside = int((rows & ~band).sum())
        print(f"check {key}: bf16 rows differing {int(rows.sum())}/{rows.numel()}, "
              f"outside the near-tie band {outside}")
        ok &= outside == 0
        del a, o, x, keys, band
        torch.cuda.empty_cache()
    return ok


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", nargs="?")
    ap.add_argument("--worker", metavar="ROOT")
    ap.add_argument("--save", metavar="DIR")
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.save)))
        return 0
    if not args.other:
        ap.error("OTHER_CHECKOUT is required")
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        saved = {}
        for name, root in (("other", args.other), ("this", here),
                           ("this", here), ("other", args.other)):
            cmd = [sys.executable, os.path.abspath(__file__), "--worker", root]
            if name not in saved:
                saved[name] = os.path.join(tmp, name)
                os.makedirs(saved[name])
                cmd += ["--save", saved[name]]
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=1800)
            if proc.returncode != 0:
                print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
                return 1
            runs.append((name, json.loads(proc.stdout.strip().splitlines()[-1])))
        ok = compare(here, saved["this"], saved["other"])
    # runs: other, this, this, other
    repeat = (runs[0][1]["hash"] == runs[3][1]["hash"] and
              runs[1][1]["hash"] == runs[2][1]["hash"])
    print(f"each tree's outputs equal between its two runs: {repeat}")
    for key in runs[0][1]["ms"]:
        cols = ", ".join(f"{n} {r['ms'][key]:.4f}" for n, r in runs)
        print(f"time {key}: {cols} ms [{card}]")
        if key in runs[0][1].get("products_ms", {}):
            cols = ", ".join(f"{n} {r['products_ms'][key]:.4f}" for n, r in runs)
            print(f"time {key} products (grapher_gemm* kernels): {cols} ms [{card}]")
    for arch in ARCHS:
        cols = ", ".join(f"{n} {r['forward_ms'][arch]:.3f} "
                         f"({B / r['forward_ms'][arch] * 1e3:.1f} fp/s)" for n, r in runs)
        print(f"serving forward {arch} bf16 B={B}: {cols} ms [{card}]")
    for arch, dtype in ARCH_DTYPES:
        cols = ", ".join(f"{n} {r['step_ms'][f'{arch} {dtype}']:.3f}" for n, r in runs)
        print(f"train step {arch} {dtype}, {TRAIN_PAIRS} pairs (2B={2 * TRAIN_PAIRS}): "
              f"{cols} ms [{card}]")
    for kind in ("ivf", "ivfpq"):
        cols = ", ".join(f"{n} {r['index'][kind][0]:.3f} s (peak {r['index'][kind][1]:.2f} GB)"
                         for n, r in runs)
        same = {name: len({r["index"][kind][2] for n, r in runs if n == name}) == 1
                for name in ("other", "this")}
        print(f"index {kind} train on {TRAIN_ROWS} rows: {cols}; centroids and codebooks "
              f"equal between the tree's two runs: {same} [{card}]")
    return 0 if ok and repeat else 1


if __name__ == "__main__":
    sys.exit(main())
