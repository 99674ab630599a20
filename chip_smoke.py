#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (grafp_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit, no result line) on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from csrc/ (one nvcc per source, in parallel);
  3. each kernel against its plain PyTorch version on the card, at the
     main path's shapes (size t, B=128, f32 and bf16, random and tie-heavy
     inputs);
  4. the main path: build_model(Config(compute_dtype='bfloat16')) with
     seeded random weights, FingerprintPipeline.fingerprint_waves on
     (128, 16000) waves with every launch count set to 0 just before and
     read just after; then the same weights in f32 through the plain
     version as the reference; then fingerprint_track on one 10 s wave;
  5. times with CUDA events after warm-up: per kernel shape (kernel, plain
     version, bound) and the whole bf16 forward as fingerprints/s.

The line before the last is the card (nvidia-smi), the one before it the
kernels' JSON; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


B = 128
STAGES = ((1024, 64), (512, 128), (256, 256), (128, 512))   # (N, C), size t
BLOCKS = (2, 2, 6, 2)                                      # Graphers per stage
K = 3
# published H100 SXM peaks (NVIDIA data sheet), the bound's denominators
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
F32_OPS_S = 67e12
# near-tie band: rows of the plain version whose top-(k+1) scores have a
# gap inside (0, eps) may select differently (summation order differs
# between the kernel and cuBLAS; in bf16 a norm one ulp apart can round a
# normalised value to the other bf16 neighbour)
NEAR_TIE_EPS = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
MAX_FLIP_SHARE = 0.01
COS_MIN_FLOOR, COS_MEAN_FLOOR = 0.98, 0.995      # bf16 kernel vs f32 plain


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n: int, c: int, dtype: torch.dtype):
    """(bytes time, operations time) in ms for one call: x read once and
    [x || rel - x] written once over the memory rate; the score product at
    the dtype's peak plus one compare and one select per score and round on
    the f32 units. The bound is the larger of the two."""
    esize = torch.finfo(dtype).bits // 8
    t_bytes = 3 * B * n * c * esize / HBM_BYTES_S
    t_ops = 2 * B * n * n * c / PEAK_OPS_S[dtype] + 2 * K * B * n * n / F32_OPS_S
    return 1e3 * t_bytes, 1e3 * t_ops


def kernel_inputs(n: int, c: int, dtype: torch.dtype, g: torch.Generator):
    x = torch.randn(B, n, c, generator=g, device="cuda")
    dup = x.clone()
    dup[:, : n // 8] = dup[:, :1]                 # silent-segment-like copies
    scaled = x.clone()
    scaled[:, 1::4] = 2.0 * scaled[:, 0::4]       # exact ties, distinct rows
    return {"random": x.to(dtype), "duplicates": dup.to(dtype),
            "scaled": scaled.to(dtype)}


def compare_kernel(x: torch.Tensor, got: torch.Tensor, want: torch.Tensor):
    """(rows differing, of them outside the near-tie band, max abs error on
    the agreeing rows) for one call."""
    from grafp_tpu_torch.ops.mrconv_concat import _norm_rows_f32

    c = x.shape[-1]
    check(torch.equal(got[..., :c], want[..., :c]), "x half is not bit-equal")
    g32, w32 = got[..., c:].float(), want[..., c:].float()
    if x.dtype == torch.bfloat16:
        _, e = torch.frexp(w32)
        tol = torch.ldexp(torch.ones_like(w32), e - 8)    # one bf16 ulp
    else:
        tol = 1e-5 + 1e-5 * w32.abs()
    bad = ((g32 - w32).abs() > tol).any(-1)               # (B, N)
    xn = _norm_rows_f32(x).to(x.dtype).float()
    top = torch.bmm(xn, xn.transpose(1, 2)).topk(K + 1, dim=-1).values
    gaps = top[..., :-1] - top[..., 1:]
    near = ((gaps > 0) & (gaps < NEAR_TIE_EPS[x.dtype])).any(-1)
    err = (g32 - w32).abs().amax(-1)[~bad]
    return (int(bad.sum()), int((bad & ~near).sum()),
            float(err.max()) if err.numel() else 0.0)


def randomize(model: torch.nn.Module, g: torch.Generator) -> None:
    """Random BatchNorm statistics and affines and grouped-conv biases, so
    no BN is the identity (the checkpoint-free stand-in for trained
    weights)."""
    from grafp_tpu_torch.models.layers import BatchNorm, GroupedPointwiseConv

    def rnd(t, scale, shift=0.0, uniform=False):
        r = torch.rand(t.shape, generator=g) if uniform else torch.randn(t.shape, generator=g)
        t.copy_((shift + scale * r).to(t.device, t.dtype))

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                rnd(m.weight, 0.1, 1.0)
                rnd(m.bias, 0.1)
                rnd(m.running_mean, 0.2)
                rnd(m.running_var, 1.0, 0.5, uniform=True)
            elif isinstance(m, GroupedPointwiseConv):
                rnd(m.bias, 0.1)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from grafp_tpu_torch.core import Config
    from grafp_tpu_torch.fp import FingerprintPipeline
    from grafp_tpu_torch.models import build_model
    import grafp_tpu_torch.models.gnn as gnn
    from grafp_tpu_torch.ops.build import build_all
    from grafp_tpu_torch.ops.mrconv_concat import mrconv_concat, mrconv_concat_reference

    t_all = time.perf_counter()
    # 1. the card
    card = nvidia_smi()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}", flush=True)

    # 2. build
    for name, (secs, log) in build_all(["mrconv_concat"]).items():
        print(f"build {name}: {secs:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    # 3. kernel vs plain version at the main path's shapes
    print("tolerance: x half bit-equal; rel - x half within 1e-5 + 1e-5|ref| "
          "(f32) or one bf16 ulp, except on rows whose plain top-(k+1) "
          f"scores have a gap in (0, {NEAR_TIE_EPS[torch.float32]:g}) (f32) / "
          f"(0, {NEAR_TIE_EPS[torch.bfloat16]:g}) (bf16), at most "
          f"{MAX_FLIP_SHARE:.0%} of rows")
    g = torch.Generator(device="cuda").manual_seed(0)
    max_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for n, c in STAGES:
            for kind, x in kernel_inputs(n, c, dtype, g).items():
                got = mrconv_concat(x, K)
                want = mrconv_concat_reference(x, K)
                torch.cuda.synchronize()
                flips, outside, err = compare_kernel(x, got, want)
                max_err = max(max_err, err)
                print(f"check {str(dtype)[6:]} N={n} C={c} {kind}: rows "
                      f"differing {flips}/{B * n} (outside the near-tie band "
                      f"{outside}), max abs err elsewhere {err:.3g}")
                check(outside == 0, "a row differs that has no near tie")
                check(flips <= MAX_FLIP_SHARE * B * n, "too many near-tie flips")
                del got, want
    torch.cuda.empty_cache()

    # 4. main path: wave -> fingerprint at full width, bf16
    cfg32, cfg16 = Config(), Config(compute_dtype="bfloat16")
    model32 = build_model(cfg32, generator=torch.Generator().manual_seed(0))
    randomize(model32, torch.Generator().manual_seed(1))
    model16 = build_model(cfg16)
    model16.load_state_dict(model32.state_dict())
    pipe16 = FingerprintPipeline(model16, cfg16)
    pipe32 = FingerprintPipeline(model32, cfg32)
    waves = torch.randn(B, cfg16.clip_frames, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(2))

    mrconv_concat.launches = 0
    z16 = pipe16.fingerprint_waves(waves)
    torch.cuda.synchronize()
    launches = mrconv_concat.launches
    n_graphers = sum(BLOCKS)
    print(f"main path: mrconv_concat launches {launches} in one forward")
    check(launches == n_graphers, f"expected {n_graphers} launches")
    check(z16.shape == (B, cfg16.d) and bool(torch.isfinite(z16).all()),
          "z not finite or misshapen")
    norms = z16.norm(dim=-1)
    check(bool(((norms - 1).abs() < 1e-2).all()), f"z not unit-norm: {norms}")

    z32k = pipe32.fingerprint_waves(waves)
    before = mrconv_concat.launches
    gnn.mrconv_concat = mrconv_concat_reference
    try:
        z32p = pipe32.fingerprint_waves(waves)
    finally:
        gnn.mrconv_concat = mrconv_concat
    check(mrconv_concat.launches == before, "the plain path launched the kernel")
    cos16 = (z16 * z32p).sum(-1)
    cos32 = (z32k * z32p).sum(-1)
    print(f"cos(bf16 kernel, f32 plain): min {cos16.min().item():.6f} "
          f"mean {cos16.mean().item():.6f}; cos(f32 kernel, f32 plain): min "
          f"{cos32.min().item():.7f} mean {cos32.mean().item():.7f}")
    check(cos16.min().item() > COS_MIN_FLOOR and
          cos16.mean().item() > COS_MEAN_FLOOR, "bf16 fingerprints drift")
    check(cos32.min().item() > 0.999, "f32 kernel path differs from plain path")

    wave = torch.randn(10 * cfg16.fs, generator=torch.Generator().manual_seed(3)).numpy()
    before = mrconv_concat.launches
    zt = pipe16.fingerprint_track(wave)
    zs = pipe16.embed(pipe16.segments_for(wave)).cpu().numpy()
    print(f"track: 10 s -> {zt.shape[0]} fingerprints, launches "
          f"{mrconv_concat.launches - before}")
    check(zt.shape == (94, cfg16.d), f"track fingerprints {zt.shape}")
    check(bool(abs((zt * zs).sum(-1) - 1).max() < 1e-2), "track path differs")

    # 5. times
    kernel_ms = plain_ms = bound_total = bytes_part = 0.0
    shapes = []
    for (n, c), nb in zip(STAGES, BLOCKS):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(B, n, c, generator=g, device="cuda").to(dtype)
            t_k = time_ms(lambda: mrconv_concat(x, K), reps=20)
            t_p = time_ms(lambda: mrconv_concat_reference(x, K), reps=5)
            t_by, t_op = bound_ms(n, c, dtype)
            t_b = max(t_by, t_op)
            print(f"time {str(dtype)[6:]} N={n} C={c}: kernel {t_k:.4f} ms, "
                  f"plain {t_p:.4f} ms, bound {t_b:.4f} ms [{card}]")
            shapes.append({"dtype": str(dtype)[6:], "N": n, "C": c,
                           "ms": t_k, "plain_ms": t_p, "bound_ms": t_b})
            if dtype == torch.bfloat16:
                kernel_ms += nb * t_k
                plain_ms += nb * t_p
                bound_total += nb * t_b
                bytes_part += nb * t_by * (t_by >= t_op)
    mrconv_concat.launches = 0
    t_fwd = time_ms(lambda: pipe16.fingerprint_waves(waves), reps=10)
    t_fwd32 = time_ms(lambda: pipe32.fingerprint_waves(waves), reps=5)
    print(f"forward bf16 B={B}: {t_fwd:.3f} ms, {B / t_fwd * 1e3:.1f} fp/s; "
          f"f32: {t_fwd32:.3f} ms, {B / t_fwd32 * 1e3:.1f} fp/s; kernel share "
          f"(bf16) {kernel_ms / t_fwd:.3f} [{card}]")
    print(f"total {time.perf_counter() - t_all:.1f} s")

    print(json.dumps({"kernels": [{
        "name": "mrconv_concat", "route": "cuda",
        "source": "grafp_tpu_torch/csrc/mrconv_concat.cu",
        "replaces": "grafp_tpu/ops/pallas_knn.py:376",
        "launches": launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_total,
        "bound_by": "bytes" if 2 * bytes_part > bound_total else "operations", "library_ms": None,
        "per_shape": shapes}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
