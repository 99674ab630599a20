#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (grafp_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit, no result line) on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from csrc/ (one nvcc per source, in parallel);
  3. each kernel against its plain PyTorch version on the card, at the
     main paths' widths (size t, B=128, f32 and bf16): the MRConv forward
     and backward and the max_neighbors forward and backward on random,
     tie-heavy and scaled-copy inputs, each with two launches bit-equal;
     the fused Grapher block at every stage shape its guard admits, on
     random and duplicate-row inputs, with weights folded from a
     randomised Grapher, and on random inputs at size s's stage shapes
     (up to C = 640); phases 6 and 7 repeat the first four at the op and
     train paths' shapes, 2B = 512 in bf16;
  4. the serving path: build_model(Config(compute_dtype='bfloat16')) with
     seeded random weights, FingerprintPipeline.fingerprint_waves on
     (128, 16000) waves with every launch count set to 0 just before and
     read just after; then the same weights in f32 through the plain
     versions as the reference; then fingerprint_track on one 10 s wave;
     then the fused serving path: a SimCLRModel over
     GraphEncoder(fuse_serving='on') with the same state_dict, in bf16 (12
     fused launches, no MRConv launch) and in f32 (10 fused, 2 MRConv: the
     guard refuses stage 1), against the f32 plain path and the unfused
     bf16 path, and fingerprint_track;
  5. the train path at full width: bsz_train = 256 (one stacked 2B = 512
     forward), bf16, seeded synthetic noise and IR banks at the JAX
     package's bank shapes (2 s rows); five steps on one fixed batch, each
     counting 12 forward and 12 backward launches, with losses finite and
     falling; one f32 step at B = 8 with the kernels against one with the
     plain versions; the trained state loaded into the bf16 serving
     pipeline;
  6. the op path: max_relative_neighbors(x, 3, 'pallas') and its autograd
     backward at every stage shape, 2B = 512, bf16, with launch counts,
     against the plain versions;
  7. times with CUDA events after warm-up: per kernel shape (kernel,
     plain version, bound; for the fused block also its three products as
     cuBLAS computes them, the yardstick), the bf16 serving forward as
     fingerprints/s, unfused and fused, and the bf16 train step as ms,
     samples/s and peak memory.

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
STAGES_S = ((1024, 80), (512, 160), (256, 400), (128, 640))  # size s
BLOCKS = (2, 2, 6, 2)                                      # Graphers per stage
K = 3
TRAIN_STEPS = 5
PARITY_B = 8                   # f32 kernel-vs-plain train step
OP_B = 512                     # the op path's batch, as the train path's 2B
# published H100 SXM peaks (NVIDIA data sheet), the bound's denominators
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
F32_OPS_S = 67e12
# near-tie band: rows whose top-(k+1) scores (f64 dots of the keys) have a
# gap inside (0, eps) may select differently (summation order differs
# between the kernel and cuBLAS; in bf16 a norm one ulp apart can round a
# normalised value to the other bf16 neighbour)
NEAR_TIE_EPS = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
MAX_FLIP_SHARE = 0.01
COS_MIN_FLOOR, COS_MEAN_FLOOR = 0.98, 0.995      # bf16 kernel vs f32 plain
# train step, kernels vs plain versions (f32, B = 8)
LOSS_RTOL, GNORM_RTOL, GRAD_COS = 1e-5, 1e-3, 0.9999
# fused Grapher block vs its plain version, outside the near-tie band of
# the plain x1's scores: f32 elementwise; bf16 per row, within BLOCK_ULPS
# bf16 ulps of the row's largest output (a product summed in another order
# can round x1 or g to the other bf16 neighbour)
BLOCK_RTOL = 1e-4
BLOCK_ULPS = 3


def cosine(a, b):
    """Row cosines of two (rows, d) arrays or tensors. bf16 fingerprints
    are normalised in bf16, so their norms are 1 only to about 0.3 %."""
    return (a * b).sum(-1) / ((a * a).sum(-1) * (b * b).sum(-1)) ** 0.5


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
    """(bytes time, operations time) in ms for one call of a selection
    kernel (mrconv_concat and max_neighbors alike). Bytes: forward 3 B N C
    (mrconv_concat: x in, [x || rel - x] out; max_neighbors: keys and x in,
    rel out), backward 4 B N C (x and a 2C-wide g in, dx out; keys, x and
    g in, dx out). Operations: the score product once at the dtype's peak,
    one compare and one select per score and round on the f32 units, and
    for the backward the scatter's adds, k rows of C per row (random
    inputs have no ties). The bound is the larger of the two."""
    esize = torch.finfo(dtype).bits // 8
    t_bytes = (4 if backward else 3) * b * n * c * esize / HBM_BYTES_S
    t_ops = 2 * b * n * n * c / PEAK_OPS_S[dtype] + 2 * K * b * n * n / F32_OPS_S
    if backward:
        t_ops += 2 * K * b * n * c / F32_OPS_S
    return 1e3 * t_bytes, 1e3 * t_ops


def block_bound_ms(b: int, n: int, c: int, dtype: torch.dtype):
    """(bytes time, operations time) in ms for one fused Grapher block.
    Bytes: x in, out written, the folded weights (7 C^2 in the dtype, 4 C
    f32) read once. Operations: fc1, the grouped conv (dense 2C x 2C), fc2
    and the score product, 2 B N C (7C + N), at the dtype's peak, plus a
    compare and a select per score and round on the f32 units."""
    esize = torch.finfo(dtype).bits // 8
    t_bytes = (2 * b * n * c * esize + 7 * c * c * esize + 4 * c * 4) / HBM_BYTES_S
    t_ops = (2 * b * n * c * (7 * c + n) / PEAK_OPS_S[dtype]
             + 2 * K * b * n * n / F32_OPS_S)
    return 1e3 * t_bytes, 1e3 * t_ops


def cublas_products_ms(m: int, c: int, dtype: torch.dtype, g: torch.Generator) -> float:
    """The fused block's three products (fc1 (M, C) x (C, C), the grouped
    conv (M, 2C) x (2C, 2C), fc2 (M, 2C) x (2C, C)) as cuBLAS computes them,
    the yardstick of #5's product kernels: bf16 with f32 outputs as
    models/layers.py:dense_matmul_bf16grad calls it, f32 in full f32
    (matmul TF32 off, PyTorch's default). Timing only: the op never calls
    it, and no single call computes the block, so library_ms stays null."""
    a1 = torch.randn(m, c, generator=g, device="cuda").to(dtype)
    a2 = torch.randn(m, 2 * c, generator=g, device="cuda").to(dtype)
    w1, wg, w2 = (torch.randn(k, o, generator=g, device="cuda").to(dtype)
                  for k, o in ((c, c), (2 * c, 2 * c), (2 * c, c)))
    kw = {"out_dtype": torch.float32} if dtype == torch.bfloat16 else {}
    check(not torch.backends.cuda.matmul.allow_tf32, "f32 matmuls run in TF32")
    return time_ms(lambda: (torch.mm(a1, w1, **kw), torch.mm(a2, wg, **kw),
                            torch.mm(a2, w2, **kw)), reps=20)


def kernel_inputs(n: int, c: int, dtype: torch.dtype, g: torch.Generator, b: int = B):
    x = torch.randn(b, n, c, generator=g, device="cuda")
    dup = x.clone()
    dup[:, : n // 8] = dup[:, :1]                 # silent-segment-like copies
    scaled = x.clone()
    scaled[:, 1::4] = 2.0 * scaled[:, 0::4]       # exact ties, distinct rows
    return {"random": x.to(dtype), "duplicates": dup.to(dtype),
            "scaled": scaled.to(dtype)}


def concat_keys(x: torch.Tensor) -> torch.Tensor:
    """mrconv_concat's (and the fused block's) keys: rows normalised in
    f32, rounded to x's dtype."""
    from grafp_tpu_torch.ops.mrconv_concat import _norm_rows_f32

    return _norm_rows_f32(x).to(x.dtype)


def op_keys(x: torch.Tensor) -> torch.Tensor:
    """max_neighbors' keys: l2_normalize in x's dtype."""
    from grafp_tpu_torch.ops.knn import l2_normalize

    return l2_normalize(x)


def near_ties(keys: torch.Tensor):
    """Per row i of the scores on ``keys``: whether its top-(k+1) scores
    have a gap in the near-tie band, and the (k+1)-th score. The scores
    are taken in f64, exact for bf16 keys: an f32 product (the plain
    version's, or the kernel's) can round two scores 1e-8 apart to one
    value, a tie that the other side may not see."""
    xn = keys.double()
    scores = torch.bmm(xn, xn.transpose(1, 2))
    top = scores.topk(K + 1, dim=-1).values
    gaps = top[..., :-1] - top[..., 1:]
    near = ((gaps > 0) & (gaps < NEAR_TIE_EPS[keys.dtype])).any(-1)
    return scores, near, top[..., -1:]


def forward_band(keys: torch.Tensor) -> torch.Tensor:
    """Rows i whose own selection may flip."""
    return near_ties(keys)[1]


def backward_band(keys: torch.Tensor) -> torch.Tensor:
    """A near tie of row i can move row i's cotangent among its top-(k+1)
    candidates j, so the band covers those rows j of dx."""
    scores, near, kth = near_ties(keys)
    return ((scores >= kth) & near[..., None]).any(1)


def within(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Elementwise: f32 within 1e-5 + 1e-5 |ref| (summation order), bf16
    within one bf16 ulp (+1e-6)."""
    if got.dtype == torch.bfloat16:
        g32, w32 = got.float(), want.float()
        _, e = torch.frexp(w32)
        return (g32 - w32).abs() <= torch.ldexp(torch.ones_like(w32), e - 8) + 1e-6
    return (got - want).abs() <= 1e-5 + 1e-5 * want.abs()


def block_within(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """The fused block's tolerance (BLOCK_RTOL, BLOCK_ULPS)."""
    g32, w32 = got.float(), want.float()
    if got.dtype == torch.bfloat16:
        _, e = torch.frexp(w32.abs().amax(-1, keepdim=True))
        return (g32 - w32).abs() <= BLOCK_ULPS * torch.ldexp(torch.ones_like(w32[..., :1]), e - 8)
    return (g32 - w32).abs() <= BLOCK_RTOL + BLOCK_RTOL * w32.abs()


def hold(what: str, run, ref, band, label: str, ok=within) -> float:
    """One kernel call against its plain version: two launches bit-equal,
    no differing row outside ``band()`` (a (B, N) mask), at most
    MAX_FLIP_SHARE of rows differing. Returns the max abs error on the
    agreeing rows."""
    got, again, want = run(), run(), ref()
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"{what} {label}: two launches differ")
    bad = ~ok(got, want).all(-1)                               # (B, N)
    rows = bad.numel()
    flips, outside = int(bad.sum()), int((bad & ~band()).sum())
    errs = (got.float() - want.float()).abs().amax(-1)[~bad]
    err = float(errs.max()) if errs.numel() else 0.0
    print(f"check {what} {label}: rows differing {flips}/{rows} (outside the "
          f"near-tie band {outside}), max abs err elsewhere {err:.3g}", flush=True)
    check(outside == 0, f"{what} {label}: a row differs that has no near tie")
    check(flips <= MAX_FLIP_SHARE * rows, f"{what} {label}: too many near-tie flips")
    return err


def hold_mrconv(x: torch.Tensor, gy: torch.Tensor, label: str) -> dict:
    """The MRConv kernels (#3, #4) on (x, gy) against their plain versions;
    the forward's x half must be x bit for bit."""
    from grafp_tpu_torch.ops.mrconv_concat import (
        mrconv_concat,
        mrconv_concat_backward,
        mrconv_concat_backward_reference,
        mrconv_concat_reference,
    )

    c = x.shape[-1]

    def rel_half(out):
        check(torch.equal(out[..., :c], x), f"mrconv_concat {label}: x half differs")
        return out[..., c:]

    keys = concat_keys(x)
    return {
        "mrconv_concat": hold(
            "mrconv_concat", lambda: rel_half(mrconv_concat(x, K)),
            lambda: mrconv_concat_reference(x, K)[..., c:],
            lambda: forward_band(keys), label),
        "mrconv_concat_backward": hold(
            "mrconv_concat_backward", lambda: mrconv_concat_backward(x, gy, K),
            lambda: mrconv_concat_backward_reference(x, gy, K),
            lambda: backward_band(keys), label)}


def hold_max_neighbors(x: torch.Tensor, gy: torch.Tensor, label: str) -> dict:
    """The max_neighbors kernels (#1, #2) against their plain versions."""
    from grafp_tpu_torch.ops.max_neighbors import (
        max_neighbors,
        max_neighbors_backward,
        max_neighbors_backward_reference,
        max_neighbors_reference,
    )

    keys = op_keys(x)
    return {
        "max_neighbors": hold(
            "max_neighbors", lambda: max_neighbors(x, K),
            lambda: max_neighbors_reference(x, K), lambda: forward_band(keys), label),
        "max_neighbors_backward": hold(
            "max_neighbors_backward", lambda: max_neighbors_backward(x, gy, K),
            lambda: max_neighbors_backward_reference(x, gy, K),
            lambda: backward_band(keys), label)}


def hold_grapher_block(x: torch.Tensor, ws, label: str) -> float:
    """The fused Grapher block (#5) against its plain version, outside the
    near-tie band of the plain x1's scores."""
    from grafp_tpu_torch.ops.grapher_block import (
        _mm,
        grapher_block,
        grapher_block_reference,
    )

    b, n, c = x.shape
    x1 = (_mm(x.reshape(b * n, c), ws[0]) + ws[1]).to(x.dtype).reshape(b, n, c)
    return hold("grapher_block", lambda: grapher_block(x, K, *ws),
                lambda: grapher_block_reference(x, K, *ws),
                lambda: forward_band(concat_keys(x1)), label, ok=block_within)


def stage_weights(c: int, dtype: torch.dtype, seed: int):
    """Folded weights (w1, c1, wg, cg, w2, c2) of an eval-mode Grapher of
    width c with seeded random weights and BatchNorm statistics, on the
    card."""
    from grafp_tpu_torch.models.gnn import Grapher
    from grafp_tpu_torch.models.layers import init_parameters

    grapher = Grapher(c, k=K, dtype=dtype, fuse_serving="on")
    init_parameters(grapher, torch.Generator().manual_seed(seed))
    randomize(grapher, torch.Generator().manual_seed(seed + 1))
    with torch.no_grad():
        return grapher.cuda().eval().folded_weights(dtype)


def fused_model(cfg, state_dict):
    """The serving model of ``cfg`` over GraphEncoder(fuse_serving='on'),
    holding ``state_dict``, on the card in eval mode."""
    from grafp_tpu_torch.models.gnn import GraphEncoder
    from grafp_tpu_torch.models.simclr import SimCLRModel

    dtype = torch.bfloat16 if cfg["compute_dtype"] == "bfloat16" else None
    encoder = GraphEncoder(in_features=cfg["n_filters"], size=cfg["size"],
                           k=int(cfg["k"]), emb_dims=cfg["h"], dtype=dtype,
                           fuse_serving="on")
    model = SimCLRModel(encoder, n_filters=cfg["n_filters"],
                        blur_kernel=tuple(cfg["blur_kernel"]),
                        peak_stride=cfg["peak_stride"], h=cfg["h"], d=cfg["d"],
                        u=cfg["u"], dtype=dtype)
    model.load_state_dict(state_dict)
    return model.cuda().eval()


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
    from grafp_tpu_torch.ops.grapher_block import (
        grapher_block,
        grapher_block_reference,
        grapher_block_supported,
    )
    from grafp_tpu_torch.ops.max_neighbors import (
        max_neighbors,
        max_neighbors_backward,
        max_neighbors_backward_reference,
        max_neighbors_reference,
    )
    from grafp_tpu_torch.ops.mrconv_concat import (
        mrconv_concat,
        mrconv_concat_backward,
        mrconv_concat_backward_reference,
        mrconv_concat_reference,
    )
    from grafp_tpu_torch.ops.mrconv_neighbors import max_relative_neighbors
    from grafp_tpu_torch.train import create_train_state, make_train_step

    wrappers = {"mrconv_concat": mrconv_concat,
                "mrconv_concat_backward": mrconv_concat_backward,
                "max_neighbors": max_neighbors,
                "max_neighbors_backward": max_neighbors_backward,
                "grapher_block": grapher_block}

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in wrappers.items()}

    t_all = time.perf_counter()
    # 1. the card
    card = nvidia_smi()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}", flush=True)

    # 2. build
    for name, (secs, log) in build_all(["mrconv_concat", "max_neighbors",
                                        "grapher_block"]).items():
        print(f"build {name}: {secs:.1f} s")
        for line in log.splitlines():
            if ("spill" in line and " 0 bytes spill" not in line) or "Performance Loss" in line:
                print(f"  ptxas: {line.strip()}")

    # 3. kernels vs plain versions at the main paths' widths
    print("tolerance: mrconv_concat x half bit-equal; rel - x, rel and dx within "
          "1e-5 + 1e-5|ref| (f32) or one bf16 ulp; grapher_block within "
          f"{BLOCK_RTOL:g} + {BLOCK_RTOL:g}|ref| (f32) or {BLOCK_ULPS} bf16 ulps of "
          "the row's largest output (bf16); all except on rows whose f64 "
          "top-(k+1) scores (of x1 for grapher_block) have a gap in "
          f"(0, {NEAR_TIE_EPS[torch.float32]:g}) (f32) / "
          f"(0, {NEAR_TIE_EPS[torch.bfloat16]:g}) (bf16) (backward: their "
          f"top-(k+1) rows), at most {MAX_FLIP_SHARE:.0%} of rows", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    max_err = {name: 0.0 for name in wrappers}

    def note(errs):
        for name, err in errs.items():
            max_err[name] = max(max_err[name], err)

    for dtype in (torch.float32, torch.bfloat16):
        for n, c in STAGES:
            inputs = kernel_inputs(n, c, dtype, g)
            for kind, x in inputs.items():
                label = f"{str(dtype)[6:]} B={B} N={n} C={c} {kind}"
                gy = torch.randn(B, n, 2 * c, generator=g, device="cuda").to(dtype)
                note(hold_mrconv(x, gy, label))
                note(hold_max_neighbors(x, gy[..., :c].contiguous(), label))
            if not grapher_block_supported(n, c, dtype, K):
                print(f"grapher_block {str(dtype)[6:]} N={n} C={c}: refused by the guard")
                continue
            ws = stage_weights(c, dtype, seed=10 + c)
            for kind in ("random", "duplicates"):
                note({"grapher_block": hold_grapher_block(
                    inputs[kind], ws, f"{str(dtype)[6:]} B={B} N={n} C={c} {kind}")})
            del inputs, ws
            torch.cuda.empty_cache()
    # the fused block at size s's widths, the widest the guard admits in the
    # model's configurations (C = 640 in bf16)
    for dtype in (torch.float32, torch.bfloat16):
        for n, c in STAGES_S:
            label = f"{str(dtype)[6:]} B={B} N={n} C={c} random (size s)"
            if not grapher_block_supported(n, c, dtype, K):
                print(f"grapher_block {label}: refused by the guard")
                continue
            x = torch.randn(B, n, c, generator=g, device="cuda").to(dtype)
            note({"grapher_block": hold_grapher_block(
                x, stage_weights(c, dtype, seed=10 + c), label)})
            del x
            torch.cuda.empty_cache()

    # 4. serving path: wave -> fingerprint at full width, bf16
    n_graphers = sum(BLOCKS)
    launches = {name: {} for name in wrappers}          # path -> count
    cfg32, cfg16 = Config(), Config(compute_dtype="bfloat16")
    model32 = build_model(cfg32, generator=torch.Generator().manual_seed(0))
    randomize(model32, torch.Generator().manual_seed(1))
    model16 = build_model(cfg16)
    model16.load_state_dict(model32.state_dict())
    pipe16 = FingerprintPipeline(model16, cfg16)
    pipe32 = FingerprintPipeline(model32, cfg32)
    waves = torch.randn(B, cfg16.clip_frames, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(2))

    zero_counts()
    z16 = pipe16.fingerprint_waves(waves)
    torch.cuda.synchronize()
    serve = counts()
    launches["mrconv_concat"]["serve"] = serve["mrconv_concat"]
    print(f"serving path: launches {serve}")
    check(serve == {**{name: 0 for name in wrappers}, "mrconv_concat": n_graphers},
          f"expected {n_graphers} mrconv_concat launches and no other")
    check(z16.shape == (B, cfg16.d) and bool(torch.isfinite(z16).all()),
          "z not finite or misshapen")
    norms = z16.norm(dim=-1)
    check(bool(((norms - 1).abs() < 1e-2).all()), f"z not unit-norm: {norms}")

    z32k = pipe32.fingerprint_waves(waves)
    before = mrconv_concat.launches
    with plain_versions():
        z32p = pipe32.fingerprint_waves(waves)
    check(mrconv_concat.launches == before, "the plain path launched the kernel")
    cos16 = cosine(z16, z32p)
    cos32 = cosine(z32k, z32p)
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
    check(bool((1 - cosine(zt, zs)).max() < 1e-2), "track path differs")

    # the fused serving path: the same state_dict over
    # GraphEncoder(fuse_serving='on'), bf16 and f32
    fpipe16 = FingerprintPipeline(fused_model(cfg16, model16.state_dict()), cfg16)
    fpipe32 = FingerprintPipeline(fused_model(cfg32, model32.state_dict()), cfg32)
    for dtype, pipe in ((torch.bfloat16, fpipe16), (torch.float32, fpipe32)):
        fusing = sum(nb for (n, c), nb in zip(STAGES, BLOCKS)
                     if grapher_block_supported(n, c, dtype, K))
        zero_counts()
        zf = pipe.fingerprint_waves(waves)
        torch.cuda.synchronize()
        got = counts()
        path = f"serve_fused_{str(dtype)[6:]}"
        launches["grapher_block"][path] = got["grapher_block"]
        launches["mrconv_concat"][path] = got["mrconv_concat"]
        print(f"fused serving path {str(dtype)[6:]}: launches {got}")
        check(got == {**{name: 0 for name in wrappers}, "grapher_block": fusing,
                      "mrconv_concat": n_graphers - fusing},
              f"expected {fusing} grapher_block and {n_graphers - fusing} "
              "mrconv_concat launches and no other")
        check(zf.shape == (B, cfg16.d) and bool(torch.isfinite(zf).all()),
              "fused z not finite or misshapen")
        cos_p = cosine(zf, z32p)
        cos_u = cosine(zf, z16 if dtype == torch.bfloat16 else z32k)
        print(f"cos(fused {str(dtype)[6:]}, f32 plain unfused): min "
              f"{cos_p.min().item():.6f} mean {cos_p.mean().item():.6f}; "
              f"cos(fused {str(dtype)[6:]}, unfused {str(dtype)[6:]} kernel path): "
              f"min {cos_u.min().item():.6f} mean {cos_u.mean().item():.6f}")
        if dtype == torch.bfloat16:
            check(cos_p.min().item() > COS_MIN_FLOOR and
                  cos_p.mean().item() > COS_MEAN_FLOOR, "fused bf16 fingerprints drift")
            check(cos_u.min().item() > COS_MIN_FLOOR and
                  cos_u.mean().item() > COS_MEAN_FLOOR, "fused bf16 differs from unfused")
        else:
            check(cos_p.min().item() > 0.999, "fused f32 differs from the plain path")
    before = grapher_block.launches
    zft = fpipe16.fingerprint_track(wave)
    print(f"fused track: 10 s -> {zft.shape[0]} fingerprints, grapher_block "
          f"launches {grapher_block.launches - before}, cos to the unfused track "
          f"min {cosine(zft, zt).min():.6f}")
    check(zft.shape == zt.shape and bool(np.isfinite(zft).all()), "fused track")
    check(bool(cosine(zft, zt).min() > COS_MIN_FLOOR), "fused track differs")
    del model32, pipe32, z32k, z32p, fpipe32
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
    losses = []
    launches["mrconv_concat"]["train"] = launches["mrconv_concat_backward"]["train"] = 0
    for i in range(TRAIN_STEPS):
        zero_counts()
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        m = step(state, x_i, x_j, gen)
        torch.cuda.synchronize()
        got = counts()
        fw, bw = got["mrconv_concat"], got["mrconv_concat_backward"]
        launches["mrconv_concat"]["train"] += fw
        launches["mrconv_concat_backward"]["train"] += bw
        losses.append(m["loss"].item())
        print(f"train step {i}: loss {losses[-1]:.6f} grad norm "
              f"{m['grad_norm'].item():.4f}, launches forward {fw} backward {bw}",
              flush=True)
        check(got == {**{name: 0 for name in wrappers}, "mrconv_concat": n_graphers,
                      "mrconv_concat_backward": n_graphers},
              f"expected {n_graphers} forward and backward launches per step")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(np.isfinite(losses)), "a train loss is not finite")
    check(losses[-1] < losses[0], f"train losses do not fall: {losses}")

    # the trained state serves: bf16 pipeline, unit-norm fingerprints
    served = build_model(cfg16)
    served.load_state_dict(tmodel.state_dict())
    zt16 = FingerprintPipeline(served, cfg16).fingerprint_waves(waves)
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
    del kmodel, pmodel, served
    torch.cuda.empty_cache()

    # 6. the op path: max_relative_neighbors(x, k, 'pallas') and its
    # backward at every stage shape, 2B = 512, bf16
    launches["max_neighbors"]["op"] = launches["max_neighbors_backward"]["op"] = 0
    for n, c in STAGES:
        x = torch.randn(OP_B, n, c, generator=g, device="cuda").to(torch.bfloat16)
        gy = torch.randn(OP_B, n, c, generator=g, device="cuda").to(torch.bfloat16)
        xg = x.clone().requires_grad_()
        zero_counts()
        rel = max_relative_neighbors(xg, K, strategy="pallas")
        (dx,) = torch.autograd.grad(rel, xg, gy)
        torch.cuda.synchronize()
        got = counts()
        print(f"op path bf16 B={OP_B} N={n} C={c}: launches {got}")
        check(got == {**{name: 0 for name in wrappers}, "max_neighbors": 1,
                      "max_neighbors_backward": 1},
              "expected one max_neighbors launch and one backward launch")
        launches["max_neighbors"]["op"] += 1
        launches["max_neighbors_backward"]["op"] += 1
        check(torch.equal(rel.detach(), max_neighbors(x, K)) and
              torch.equal(dx, max_neighbors_backward(x, gy, K)),
              "the op path's outputs are not the wrappers'")
        note(hold_max_neighbors(x, gy, f"bfloat16 B={OP_B} N={n} C={c} random (op path)"))
        del x, gy, xg, rel, dx
        torch.cuda.empty_cache()

    # 7. times
    per_shape = {name: [] for name in wrappers}
    sums = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes": 0.0}
            for name in wrappers}

    def record(name, nb, dtype, b, n, c, t_k, t_p, bounds, add=True):
        t_by, t_op = bounds
        per_shape[name].append({"dtype": str(dtype)[6:], "B": b, "N": n, "C": c,
                                "ms": t_k, "plain_ms": t_p,
                                "bound_ms": max(t_by, t_op)})
        print(f"time {name} {str(dtype)[6:]} B={b} N={n} C={c}: kernel {t_k:.4f} ms, "
              f"plain {t_p:.4f} ms, bound {max(t_by, t_op):.4f} ms "
              f"({'bytes' if t_by >= t_op else 'operations'}) [{card}]", flush=True)
        if add:
            sums[name]["ms"] += nb * t_k
            sums[name]["plain_ms"] += nb * t_p
            sums[name]["bound_ms"] += nb * max(t_by, t_op)
            sums[name]["bytes"] += nb * t_by * (t_by >= t_op)

    fwd_train_ms = 0.0
    for (n, c), nb in zip(STAGES, BLOCKS):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(B, n, c, generator=g, device="cuda").to(dtype)
            t_k = time_ms(lambda: mrconv_concat(x, K), reps=20)
            t_p = time_ms(lambda: mrconv_concat_reference(x, K), reps=5)
            record("mrconv_concat", nb, dtype, B, n, c, t_k, t_p,
                   bound_ms(B, n, c, dtype, False), add=dtype == torch.bfloat16)
            t_blas = cublas_products_ms(B * n, c, dtype, g)
            if grapher_block_supported(n, c, dtype, K):
                ws = stage_weights(c, dtype, seed=10 + c)
                t_k = time_ms(lambda: grapher_block(x, K, *ws), reps=10)
                t_p = time_ms(lambda: grapher_block_reference(x, K, *ws), reps=3)
                record("grapher_block", nb, dtype, B, n, c, t_k, t_p,
                       block_bound_ms(B, n, c, dtype), add=dtype == torch.bfloat16)
                per_shape["grapher_block"][-1]["cublas_products_ms"] = t_blas
                beside = f"grapher_block {t_k:.4f} ms (the whole block)"
            else:
                beside = "grapher_block refused by the guard"
            print(f"time products cuBLAS {str(dtype)[6:]} B={B} N={n} C={c}: fc1, grouped "
                  f"conv and fc2 as three torch.mm {t_blas:.4f} ms; {beside} [{card}]",
                  flush=True)
        # the train path's shapes: 2B = 512, bf16
        bt, dtype = 2 * bsz, torch.bfloat16
        x = torch.randn(bt, n, c, generator=g, device="cuda").to(dtype)
        gy = torch.randn(bt, n, 2 * c, generator=g, device="cuda").to(dtype)
        note(hold_mrconv(x, gy, f"bfloat16 B={bt} N={n} C={c} random"))
        torch.cuda.empty_cache()
        t_kf = time_ms(lambda: mrconv_concat(x, K), reps=5)
        t_k = time_ms(lambda: mrconv_concat_backward(x, gy, K), reps=5)
        t_p = time_ms(lambda: mrconv_concat_backward_reference(x, gy, K), reps=2,
                      warmup=1)
        record("mrconv_concat_backward", nb, dtype, bt, n, c, t_k, t_p,
               bound_ms(bt, n, c, dtype, True))
        per_shape["mrconv_concat"].append({"dtype": "bfloat16", "B": bt, "N": n,
                                           "C": c, "ms": t_kf})
        fwd_train_ms += nb * t_kf
        # the op path's shapes: 2B = 512, bf16, one launch of each per stage
        gy = gy[..., :c].contiguous()
        t_k = time_ms(lambda: max_neighbors(x, K), reps=5)
        t_p = time_ms(lambda: max_neighbors_reference(x, K), reps=2, warmup=1)
        record("max_neighbors", 1, dtype, bt, n, c, t_k, t_p,
               bound_ms(bt, n, c, dtype, False))
        t_k = time_ms(lambda: max_neighbors_backward(x, gy, K), reps=5)
        t_p = time_ms(lambda: max_neighbors_backward_reference(x, gy, K), reps=2,
                      warmup=1)
        record("max_neighbors_backward", 1, dtype, bt, n, c, t_k, t_p,
               bound_ms(bt, n, c, dtype, True))
        del x, gy
        torch.cuda.empty_cache()

    t_fwd, t_fused = [], []
    for _ in range(2):                       # in turns: unfused, fused, ...
        t_fwd.append(time_ms(lambda: pipe16.fingerprint_waves(waves), reps=10))
        t_fused.append(time_ms(lambda: fpipe16.fingerprint_waves(waves), reps=10))
    t_fwd, t_fused = sum(t_fwd) / 2, sum(t_fused) / 2
    print(f"serving forward bf16 B={B}: unfused {t_fwd:.3f} ms, {B / t_fwd * 1e3:.1f} "
          f"fp/s (mrconv_concat share {sums['mrconv_concat']['ms'] / t_fwd:.3f}); "
          f"fused {t_fused:.3f} ms, {B / t_fused * 1e3:.1f} fp/s (grapher_block "
          f"share {sums['grapher_block']['ms'] / t_fused:.3f}) [{card}]")
    t_step = time_ms(lambda: step(state, x_i, x_j, gen), reps=3, warmup=1)
    print(f"train step bf16 bsz_train={bsz} (2B={2 * bsz}): {t_step:.3f} ms, "
          f"{bsz / t_step * 1e3:.1f} samples/s (a sample is one pair of views); "
          f"per step the 12 forward launches take {fwd_train_ms:.3f} ms and the 12 "
          f"backward launches {sums['mrconv_concat_backward']['ms']:.3f} ms; peak "
          f"memory {peak_gb:.2f} GB (max_memory_allocated) [{card}]")
    print(f"total {time.perf_counter() - t_all:.1f} s")

    sources = {"mrconv_concat": ("mrconv_concat.cu", "grafp_tpu/ops/pallas_knn.py:376"),
               "mrconv_concat_backward": ("mrconv_concat.cu",
                                          "grafp_tpu/ops/pallas_knn.py:437"),
               "max_neighbors": ("max_neighbors.cu", "grafp_tpu/ops/pallas_knn.py:173"),
               "max_neighbors_backward": ("max_neighbors.cu",
                                          "grafp_tpu/ops/pallas_knn.py:285"),
               "grapher_block": ("grapher_block.cu", "grafp_tpu/ops/pallas_knn.py:580")}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"grafp_tpu_torch/csrc/{src}",
         "replaces": replaces, "launches": sum(launches[name].values()),
         "launches_by_path": launches[name], "max_abs_err": max_err[name],
         "ms": sums[name]["ms"], "plain_ms": sums[name]["plain_ms"],
         "bound_ms": sums[name]["bound_ms"],
         "bound_by": ("bytes" if 2 * sums[name]["bytes"] > sums[name]["bound_ms"]
                      else "operations"),
         "library_ms": None, "per_shape": per_shape[name]}
        for name, (src, replaces) in sources.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
