#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (grafp_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit, no result line) on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from csrc/ (one nvcc per source, in parallel);
  3. each kernel against its plain PyTorch version on the card, at the
     main paths' widths (size t, B=128, f32 and bf16, random and tie-heavy
     inputs): the forward kernel, and the backward kernel, each with two
     launches bit-equal (phase 6 repeats this at the train path's shapes,
     2B = 512 in bf16, before it times them);
  4. the serving path: build_model(Config(compute_dtype='bfloat16')) with
     seeded random weights, FingerprintPipeline.fingerprint_waves on
     (128, 16000) waves with every launch count set to 0 just before and
     read just after; then the same weights in f32 through the plain
     versions as the reference; then fingerprint_track on one 10 s wave;
  5. the train path at full width: bsz_train = 256 (one stacked 2B = 512
     forward), bf16, seeded synthetic noise and IR banks at the JAX
     package's bank shapes (2 s rows); five steps on one fixed batch, each
     counting 12 forward and 12 backward launches, with losses finite and
     falling; one f32 step at B = 8 with the kernels against one with the
     plain versions; the trained state loaded into the bf16 serving
     pipeline;
  6. at the train path's kernel shapes (2B = 512, bf16, random inputs)
     both kernels against their plain versions as in phase 3; then times
     with CUDA events after warm-up: per kernel shape (kernel, plain
     version, bound), the bf16 serving forward as fingerprints/s, and the
     bf16 train step as ms, samples/s and peak memory.

The line before the last is the card (nvidia-smi), the one before it the
kernels' JSON; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


B = 128                                                    # serving batch
STAGES = ((1024, 64), (512, 128), (256, 256), (128, 512))   # (N, C), size t
BLOCKS = (2, 2, 6, 2)                                      # Graphers per stage
K = 3
TRAIN_STEPS = 5
PARITY_B = 8                   # f32 kernel-vs-plain train step
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
# train step, kernels vs plain versions (f32, B = 8)
LOSS_RTOL, GNORM_RTOL, GRAD_COS = 1e-5, 1e-3, 0.9999


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


def bound_ms(b: int, n: int, c: int, dtype: torch.dtype, backward: bool):
    """(bytes time, operations time) in ms for one call. Bytes: forward
    x in and [x || rel - x] out (3 B N C), backward x and g in and dx out
    (4 B N C). Operations: the score product once at the dtype's peak,
    one compare and one select per score and round on the f32 units, and
    for the backward the scatter's adds, k rows of C per row (random
    inputs have no ties). The bound is the larger of the two."""
    esize = torch.finfo(dtype).bits // 8
    t_bytes = (4 if backward else 3) * b * n * c * esize / HBM_BYTES_S
    t_ops = 2 * b * n * n * c / PEAK_OPS_S[dtype] + 2 * K * b * n * n / F32_OPS_S
    if backward:
        t_ops += 2 * K * b * n * c / F32_OPS_S
    return 1e3 * t_bytes, 1e3 * t_ops


def kernel_inputs(n: int, c: int, dtype: torch.dtype, g: torch.Generator):
    x = torch.randn(B, n, c, generator=g, device="cuda")
    dup = x.clone()
    dup[:, : n // 8] = dup[:, :1]                 # silent-segment-like copies
    scaled = x.clone()
    scaled[:, 1::4] = 2.0 * scaled[:, 0::4]       # exact ties, distinct rows
    return {"random": x.to(dtype), "duplicates": dup.to(dtype),
            "scaled": scaled.to(dtype)}


def near_ties(x: torch.Tensor):
    """Per row i of the plain version's scores: whether its top-(k+1)
    scores have a gap in the near-tie band, and the (k+1)-th score."""
    from grafp_tpu_torch.ops.mrconv_concat import _norm_rows_f32

    xn = _norm_rows_f32(x).to(x.dtype).float()
    scores = torch.bmm(xn, xn.transpose(1, 2))
    top = scores.topk(K + 1, dim=-1).values
    gaps = top[..., :-1] - top[..., 1:]
    near = ((gaps > 0) & (gaps < NEAR_TIE_EPS[x.dtype])).any(-1)
    return scores, near, top[..., -1:]


def within(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Elementwise: f32 within 1e-5 + 1e-5 |ref| (summation order), bf16
    within one bf16 ulp (+1e-6)."""
    if got.dtype == torch.bfloat16:
        g32, w32 = got.float(), want.float()
        _, e = torch.frexp(w32)
        return (g32 - w32).abs() <= torch.ldexp(torch.ones_like(w32), e - 8) + 1e-6
    return (got - want).abs() <= 1e-5 + 1e-5 * want.abs()


def compare_forward(x: torch.Tensor, got: torch.Tensor, want: torch.Tensor):
    """(rows differing, of them outside the near-tie band, max abs error on
    the agreeing rows) for one forward call."""
    c = x.shape[-1]
    check(torch.equal(got[..., :c], want[..., :c]), "x half is not bit-equal")
    bad = ~within(got[..., c:], want[..., c:]).all(-1)         # (B, N)
    _, near, _ = near_ties(x)
    err = (got[..., c:].float() - want[..., c:].float()).abs().amax(-1)[~bad]
    return (int(bad.sum()), int((bad & ~near).sum()),
            float(err.max()) if err.numel() else 0.0)


def compare_backward(x: torch.Tensor, got: torch.Tensor, want: torch.Tensor):
    """As compare_forward for dx. A near tie of row i can move row i's
    cotangent among its top-(k+1) candidates j, so the band covers those
    rows j of dx."""
    bad = ~within(got, want).all(-1)                           # (B, N)
    scores, near, kth = near_ties(x)
    band = ((scores >= kth) & near[..., None]).any(1)          # rows j
    err = (got.float() - want.float()).abs().amax(-1)[~bad]
    return (int(bad.sum()), int((bad & ~band).sum()),
            float(err.max()) if err.numel() else 0.0)


def hold_against_plain(x: torch.Tensor, gy: torch.Tensor, label: str) -> dict:
    """Both kernels on (x, gy) against their plain versions: two launches
    bit-equal, no differing row outside the near-tie band, at most
    MAX_FLIP_SHARE of rows differing. Returns each kernel's max abs error
    on the agreeing rows."""
    from grafp_tpu_torch.ops.mrconv_concat import (
        mrconv_concat,
        mrconv_concat_backward,
        mrconv_concat_backward_reference,
        mrconv_concat_reference,
    )

    rows = x.shape[0] * x.shape[1]
    errs = {}
    for what, run, ref, cmp in (
            ("forward", lambda: mrconv_concat(x, K),
             lambda: mrconv_concat_reference(x, K), compare_forward),
            ("backward", lambda: mrconv_concat_backward(x, gy, K),
             lambda: mrconv_concat_backward_reference(x, gy, K),
             compare_backward)):
        got, again, want = run(), run(), ref()
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"{what} {label}: two launches differ")
        flips, outside, errs[what] = cmp(x, got, want)
        print(f"check {what} {label}: rows differing {flips}/{rows} (outside "
              f"the near-tie band {outside}), max abs err elsewhere "
              f"{errs[what]:.3g}", flush=True)
        check(outside == 0, f"{what} {label}: a row differs that has no near tie")
        check(flips <= MAX_FLIP_SHARE * rows, f"{what} {label}: too many near-tie flips")
        del got, again, want
    return errs


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


@contextlib.contextmanager
def plain_versions():
    """Route MRConvConcat through the plain PyTorch versions (the
    yardstick; the port itself never does)."""
    import grafp_tpu_torch.ops.mrconv_concat as ops

    saved = ops.mrconv_concat, ops.mrconv_concat_backward
    ops.mrconv_concat = ops.mrconv_concat_reference
    ops.mrconv_concat_backward = ops.mrconv_concat_backward_reference
    try:
        yield
    finally:
        ops.mrconv_concat, ops.mrconv_concat_backward = saved


def synthetic_banks(cfg, seed: int):
    """Noise and IR banks at build_augment_banks' shapes (2 s rows, 512
    noise and 256 IR clips, grafp_tpu/data/dataset.py:309-346) from a
    seed: noise clips of 0.5-3 s at random gains; IRs of 0.05-2 s of
    exponentially decaying noise."""
    from grafp_tpu_torch.dsp.augment import AugmentBanks

    rs = np.random.RandomState(seed)
    fs = int(cfg["fs"])
    noise = [(rs.uniform(0.05, 1.0) * rs.randn(rs.randint(fs // 2, 3 * fs)))
             .astype(np.float32) for _ in range(512)]
    irs = []
    for _ in range(256):
        n = rs.randint(fs // 20, 2 * fs)
        decay = np.exp(-np.arange(n) / (n * rs.uniform(0.05, 0.3)))
        irs.append((rs.randn(n) * decay).astype(np.float32))
    return AugmentBanks.from_arrays(noise_clips=noise, ir_clips=irs,
                                    noise_len=2 * fs, ir_len=2 * fs)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from grafp_tpu_torch.core import Config
    from grafp_tpu_torch.fp import FingerprintPipeline
    from grafp_tpu_torch.models import build_model
    from grafp_tpu_torch.ops.build import build_all
    from grafp_tpu_torch.ops.mrconv_concat import (
        mrconv_concat,
        mrconv_concat_backward,
        mrconv_concat_backward_reference,
        mrconv_concat_reference,
    )
    from grafp_tpu_torch.train import create_train_state, make_train_step

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
            if "spill" in line and " 0 bytes spill" not in line:
                print(f"  ptxas: {line.strip()}")

    # 3. kernels vs plain versions at the main paths' widths
    print("tolerance: forward x half bit-equal; rel - x half and dx within "
          "1e-5 + 1e-5|ref| (f32) or one bf16 ulp, except on rows whose "
          "plain top-(k+1) scores have a gap in "
          f"(0, {NEAR_TIE_EPS[torch.float32]:g}) (f32) / "
          f"(0, {NEAR_TIE_EPS[torch.bfloat16]:g}) (bf16) (backward: their "
          f"top-(k+1) rows), at most {MAX_FLIP_SHARE:.0%} of rows", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    max_err = {"forward": 0.0, "backward": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for n, c in STAGES:
            for kind, x in kernel_inputs(n, c, dtype, g).items():
                gy = torch.randn(B, n, 2 * c, generator=g, device="cuda").to(dtype)
                for what, err in hold_against_plain(x, gy, f"{str(dtype)[6:]} B={B} "
                                                    f"N={n} C={c} {kind}").items():
                    max_err[what] = max(max_err[what], err)
    torch.cuda.empty_cache()

    # 4. serving path: wave -> fingerprint at full width, bf16
    cfg32, cfg16 = Config(), Config(compute_dtype="bfloat16")
    model32 = build_model(cfg32, generator=torch.Generator().manual_seed(0))
    randomize(model32, torch.Generator().manual_seed(1))
    model16 = build_model(cfg16)
    model16.load_state_dict(model32.state_dict())
    pipe16 = FingerprintPipeline(model16, cfg16)
    pipe32 = FingerprintPipeline(model32, cfg32)
    waves = torch.randn(B, cfg16.clip_frames, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(2))

    mrconv_concat.launches = mrconv_concat_backward.launches = 0
    z16 = pipe16.fingerprint_waves(waves)
    torch.cuda.synchronize()
    serve_launches = mrconv_concat.launches
    n_graphers = sum(BLOCKS)
    print(f"serving path: mrconv_concat launches {serve_launches} in one forward, "
          f"backward {mrconv_concat_backward.launches}")
    check(serve_launches == n_graphers and mrconv_concat_backward.launches == 0,
          f"expected {n_graphers} forward launches and no backward")
    check(z16.shape == (B, cfg16.d) and bool(torch.isfinite(z16).all()),
          "z not finite or misshapen")
    norms = z16.norm(dim=-1)
    check(bool(((norms - 1).abs() < 1e-2).all()), f"z not unit-norm: {norms}")

    z32k = pipe32.fingerprint_waves(waves)
    before = mrconv_concat.launches
    with plain_versions():
        z32p = pipe32.fingerprint_waves(waves)
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
    del model32, pipe32, z32k, z32p
    torch.cuda.empty_cache()

    # 5. train path at full width: bsz_train = 256, bf16
    bsz = int(cfg16["bsz_train"])
    banks = synthetic_banks(cfg16, seed=4)
    print(f"banks: noise {tuple(banks.noise.shape)}, ir {tuple(banks.ir.shape)}, "
          f"ir spectra {tuple(banks.ir_spec_re.shape)}")
    tmodel = build_model(cfg16, generator=torch.Generator().manual_seed(5), train=True)
    state = create_train_state(tmodel, cfg16, steps_per_epoch=100)
    step = make_train_step(tmodel, cfg16, banks)
    gw = torch.Generator(device="cuda").manual_seed(6)
    x_i = torch.randn(bsz, cfg16.clip_frames, device="cuda", generator=gw)
    x_j = x_i.clone()
    gen = torch.Generator(device="cuda").manual_seed(7)
    losses, train_launches = [], [0, 0]
    for i in range(TRAIN_STEPS):
        mrconv_concat.launches = mrconv_concat_backward.launches = 0
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        m = step(state, x_i, x_j, gen)
        torch.cuda.synchronize()
        fw, bw = mrconv_concat.launches, mrconv_concat_backward.launches
        train_launches[0] += fw
        train_launches[1] += bw
        losses.append(m["loss"].item())
        print(f"train step {i}: loss {losses[-1]:.6f} grad norm "
              f"{m['grad_norm'].item():.4f}, launches forward {fw} backward {bw}",
              flush=True)
        check(fw == n_graphers and bw == n_graphers,
              f"expected {n_graphers} forward and backward launches per step")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(np.isfinite(losses)), "a train loss is not finite")
    check(losses[-1] < losses[0], f"train losses do not fall: {losses}")

    # the trained state serves: bf16 pipeline, unit-norm fingerprints
    serve = build_model(cfg16)
    serve.load_state_dict(tmodel.state_dict())
    zt16 = FingerprintPipeline(serve, cfg16).fingerprint_waves(waves)
    norms = zt16.norm(dim=-1)
    print(f"trained state served: z {tuple(zt16.shape)}, |z| in "
          f"[{norms.min().item():.5f}, {norms.max().item():.5f}]")
    check(bool(torch.isfinite(zt16).all()) and bool(((norms - 1).abs() < 1e-2).all()),
          "trained state gives bad fingerprints")

    # one f32 step with the kernels against one with the plain versions
    kmodel = build_model(cfg32, generator=torch.Generator().manual_seed(8), train=True)
    pmodel = copy.deepcopy(kmodel)
    xs_i = torch.randn(PARITY_B, cfg32.clip_frames, device="cuda", generator=gw)
    xs_j = xs_i + 0.3 * torch.randn(PARITY_B, cfg32.clip_frames, device="cuda",
                                     generator=gw)
    mk = make_train_step(kmodel, cfg32)(create_train_state(kmodel, cfg32),
                                        xs_i, xs_j, gen)
    before = (mrconv_concat.launches, mrconv_concat_backward.launches)
    with plain_versions():
        mp = make_train_step(pmodel, cfg32)(create_train_state(pmodel, cfg32),
                                            xs_i, xs_j, gen)
    check((mrconv_concat.launches, mrconv_concat_backward.launches) == before,
          "the plain train step launched a kernel")
    lk, lp = mk["loss"].item(), mp["loss"].item()
    gk, gp = mk["grad_norm"].item(), mp["grad_norm"].item()
    cos_min, skipped = 1.0, 0
    for a, b in zip(kmodel.parameters(), pmodel.parameters()):
        if b.grad.abs().max().item() < 1e-4 * gp:
            skipped += 1                 # zero by construction: noise
            continue
        cos = (a.grad * b.grad).sum() / (a.grad.norm() * b.grad.norm())
        cos_min = min(cos_min, cos.item())
    print(f"train step f32 B={PARITY_B}, kernels vs plain: loss {lk:.7f} vs "
          f"{lp:.7f} (rel {abs(lk - lp) / abs(lp):.2e}), grad norm {gk:.5f} vs "
          f"{gp:.5f} (rel {abs(gk - gp) / gp:.2e}), min gradient cos "
          f"{cos_min:.7f} ({skipped} tensors under 1e-4 of the grad norm skipped)")
    check(abs(lk - lp) <= LOSS_RTOL * abs(lp), "train loss differs from plain")
    check(abs(gk - gp) <= GNORM_RTOL * gp, "grad norm differs from plain")
    check(cos_min > GRAD_COS, "a gradient differs from plain")
    del kmodel, pmodel, serve
    torch.cuda.empty_cache()

    # 6. times
    kernels = {"forward": [], "backward": []}
    fwd = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes": 0.0}
    bwd = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes": 0.0}
    fwd_train_ms = 0.0
    for (n, c), nb in zip(STAGES, BLOCKS):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(B, n, c, generator=g, device="cuda").to(dtype)
            t_k = time_ms(lambda: mrconv_concat(x, K), reps=20)
            t_p = time_ms(lambda: mrconv_concat_reference(x, K), reps=5)
            t_by, t_op = bound_ms(B, n, c, dtype, False)
            print(f"time forward {str(dtype)[6:]} B={B} N={n} C={c}: kernel "
                  f"{t_k:.4f} ms, plain {t_p:.4f} ms, bound {max(t_by, t_op):.4f} ms [{card}]")
            kernels["forward"].append({"dtype": str(dtype)[6:], "B": B, "N": n, "C": c,
                                       "ms": t_k, "plain_ms": t_p,
                                       "bound_ms": max(t_by, t_op)})
            if dtype == torch.bfloat16:
                fwd["ms"] += nb * t_k
                fwd["plain_ms"] += nb * t_p
                fwd["bound_ms"] += nb * max(t_by, t_op)
                fwd["bytes"] += nb * t_by * (t_by >= t_op)
        # the train path's shapes: 2B = 512, bf16
        bt, dtype = 2 * bsz, torch.bfloat16
        x = torch.randn(bt, n, c, generator=g, device="cuda").to(dtype)
        gy = torch.randn(bt, n, 2 * c, generator=g, device="cuda").to(dtype)
        for what, err in hold_against_plain(x, gy, f"bfloat16 B={bt} N={n} "
                                            f"C={c} random").items():
            max_err[what] = max(max_err[what], err)
        torch.cuda.empty_cache()
        t_kf = time_ms(lambda: mrconv_concat(x, K), reps=5)
        t_k = time_ms(lambda: mrconv_concat_backward(x, gy, K), reps=5)
        t_p = time_ms(lambda: mrconv_concat_backward_reference(x, gy, K), reps=2,
                      warmup=1)
        t_by, t_op = bound_ms(bt, n, c, dtype, True)
        print(f"time backward bf16 B={bt} N={n} C={c}: kernel {t_k:.4f} ms, plain "
              f"{t_p:.4f} ms, bound {max(t_by, t_op):.4f} ms; forward kernel at "
              f"this shape {t_kf:.4f} ms [{card}]", flush=True)
        kernels["backward"].append({"dtype": "bfloat16", "B": bt, "N": n, "C": c,
                                    "ms": t_k, "plain_ms": t_p,
                                    "bound_ms": max(t_by, t_op)})
        kernels["forward"].append({"dtype": "bfloat16", "B": bt, "N": n, "C": c,
                                   "ms": t_kf})
        fwd_train_ms += nb * t_kf
        bwd["ms"] += nb * t_k
        bwd["plain_ms"] += nb * t_p
        bwd["bound_ms"] += nb * max(t_by, t_op)
        bwd["bytes"] += nb * t_by * (t_by >= t_op)
        del x, gy
        torch.cuda.empty_cache()

    t_fwd = time_ms(lambda: pipe16.fingerprint_waves(waves), reps=10)
    print(f"serving forward bf16 B={B}: {t_fwd:.3f} ms, {B / t_fwd * 1e3:.1f} fp/s; "
          f"forward kernel share {fwd['ms'] / t_fwd:.3f} [{card}]")
    t_step = time_ms(lambda: step(state, x_i, x_j, gen), reps=3, warmup=1)
    print(f"train step bf16 bsz_train={bsz} (2B={2 * bsz}): {t_step:.3f} ms, "
          f"{bsz / t_step * 1e3:.1f} samples/s (a sample is one pair of views); "
          f"per step the 12 forward launches take {fwd_train_ms:.3f} ms and the 12 "
          f"backward launches {bwd['ms']:.3f} ms; peak memory {peak_gb:.2f} GB "
          f"(max_memory_allocated) [{card}]")
    print(f"total {time.perf_counter() - t_all:.1f} s")

    def entry(name, replaces, launches, by_path, sums, per_shape, err):
        return {"name": name, "route": "cuda",
                "source": "grafp_tpu_torch/csrc/mrconv_concat.cu",
                "replaces": replaces, "launches": launches,
                "launches_by_path": by_path, "max_abs_err": err,
                "ms": sums["ms"], "plain_ms": sums["plain_ms"],
                "bound_ms": sums["bound_ms"],
                "bound_by": "bytes" if 2 * sums["bytes"] > sums["bound_ms"] else "operations",
                "library_ms": None, "per_shape": per_shape}

    print(json.dumps({"kernels": [
        entry("mrconv_concat", "grafp_tpu/ops/pallas_knn.py:376",
              serve_launches + train_launches[0],
              {"serve": serve_launches, "train": train_launches[0]}, fwd,
              kernels["forward"], max_err["forward"]),
        entry("mrconv_concat_backward", "grafp_tpu/ops/pallas_knn.py:437",
              train_launches[1], {"serve": 0, "train": train_launches[1]}, bwd,
              kernels["backward"], max_err["backward"])]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
