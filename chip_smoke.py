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
  4. the serving path: build_model(Config(compute_dtype='bfloat16'),
     fuse_serving='off') with seeded random weights made to behave like
     trained ones (``calibrate`` of tests/torch_port_util.py, shared with the
     CPU tests), FingerprintPipeline.fingerprint_waves
     (which serves a BatchNorm-folded copy) on 128 seeded 1-s music-like
     clips with every launch count set to 0 just before and read just
     after; then the same weights in f32, unfolded, through the plain
     versions as the reference, which the folded f32 paths (plain and
     kernel) must match; then fingerprint_track on one 10 s track; then
     the fused serving path: build_model's default fuse_serving='auto',
     which fuses on the card, with the same state_dict, in bf16 (12 fused
     launches, no MRConv launch) and in f32 (10 fused, 2 MRConv: the guard
     refuses stage 1), against the f32 plain path and the unfused bf16
     path, and fingerprint_track. Every row comparison (``hold_rows``)
     also requires each row to lie nearer its own reference row than any
     other, and a cosine floor above every cosine between two different
     rows;
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
     fingerprints/s, unfused and fused, and the train step at bsz_train =
     256 as ms, samples/s and peak memory, bf16 and f32; the fused forward
     from log-mel unfolded and folded, with the profiler's share of
     elementwise and reduction kernels in each;
  8. the evaluation path at size t in bf16 with phase 4's weights and the
     'auto' (fused) model: create_dummy_db over 96 seeded music-like
     tracks of 20-40 s (launch counts set to 0 just before the three
     builders and read just after: 12 grapher_block launches per embed
     batch and no other), create_fp_db over 32 more with corruption from
     synthetic banks, create_db over 4; row counts against the segment
     counts, db and query aligned, every packed row nearer its own
     fingerprint_track row than any other track row, fingerprints/s at
     the default pack and at pack 1; then a 2^20-row catalogue (the built rows and seeded
     random unit rows) through eval_faiss with 'l2' and 'ivfpq' (64 cells,
     nprobe 20, 64 x 8-bit PQ), 500 test ids, sequence lengths 1 3 5 9 11
     19, with the hit rates held to [0, 100] and top-10 >= top-3 >=
     top-1; the clean db rows as queries, and exact queries on a twin
     catalogue of random rows, must score 100 % top-1 at every length;
     'l2' ids against a float64 numpy top-20
     on 256 queries, 'ivfpq' ids against the port's CPU path on the same
     centroids, codebooks and codes, both outside a near-tie band; index
     train and add seconds, search queries/s (and by QUERY_CHUNK), and
     rescoring ms per length on the card beside the host's, whose top ids
     must equal the card's on the twin catalogue;
  9. the user's entry points at size t through their main(argv): a wav
     corpus written by the port's save_wav (512 train tracks of 10 s, so
     that bsz_train = 256 gives two steps an epoch; 120 val tracks of
     30 s, 64 noise clips, 32 IRs) and config/grafp.yaml (bf16) pointed
     at it; train_main for 2 epochs with validation from phase 4's
     calibrated weights saved as an epoch-0 checkpoint (12 mrconv_concat
     forward and backward launches a step, 12 grapher_block launches an
     embed batch of validation), its resume to epoch 3 against two
     uninterrupted 3-epoch runs (one with --cache_decoded), which must all
     agree to RESUME_TOL, test_fp_main --small_test
     against eval_faiss on its fingerprint dir, its dummy_db and db rows
     each nearest its own fingerprint_track row in the frozen split's
     order, and its clean db rows (made unit-norm) as queries 100 % top-1
     at every length, generate_main in bf16 and
     f32 (10 grapher_block + 2 mrconv_concat launches an embed batch)
     against fingerprint_track; the epoch's wall time against phase 7's
     fixed-batch step (the loader's share), the decode-once gain, and
     generate's fp/s from files;
 10. the baseline encoders, which run no kernel of the port (every step
     counts no launch): the AST under config/ast.yaml (bf16) and NAFP under
     Config(arch='nafp', n_mels=256) (the repo has no NAFP config), each
     with seeded weights spread by ``calibrate_baseline`` of
     tests/torch_port_util.py: fingerprint_waves on 128 music-like 1-s
     clips against the same weights in f32 through the CPU path's
     attention on the card (``hold_rows``), timed as fp/s; the AST's
     fingerprint_track of a 10 s track; 5 AST train steps at bsz_train 512
     and 3 NAFP steps at 256 on a fixed batch with synthetic banks (losses
     finite and falling; ms a step, samples/s, peak memory); then on phase
     9's corpus baseline_train (AST, one epoch with validation),
     baseline_test_fp --small_test --model tc10 (its DB rows each nearest
     its own fingerprint_track row in the frozen split's order) and
     generate_main with the AST config against fingerprint_track.

The line before the last is the card (nvidia-smi), the one before it the
kernels' JSON (launches by path: the DB build's under "db_build", the
entry points' under "cli", phase 10's under "baselines"); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import json
import os
import subprocess
import sys
import tempfile
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
COS_MIN_FLOOR, COS_MEAN_FLOOR = 0.995, 0.998    # bf16 kernel vs f32 plain
F32_COS = 0.9999               # f32 folded / kernel paths vs the unfolded plain path
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


@functools.lru_cache(maxsize=None)
def shared():
    """tests/torch_port_util.py of this checkout, whose ``calibrate`` and
    ``hold_rows`` the CPU tests use too, loaded by its path: a ``tests``
    package installed on the machine would shadow the checkout's."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "torch_port_util.py")
    spec = importlib.util.spec_from_file_location("torch_port_util", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def hold_rows(what: str, got, ref, floor=None, mean_floor=None):
    """The shared row check (each row nearest its own ref row, above the
    floors, which must tell rows apart) on the card."""
    return shared().hold_rows(what, got, ref, floor, mean_floor, device="cuda")


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
    """The serving model of ``cfg`` with ``fuse_serving='auto'`` (the fused
    Grapher on the card), holding ``state_dict``, on the card in eval
    mode."""
    from grafp_tpu_torch.models import build_model

    model = build_model(cfg)
    model.load_state_dict(state_dict)
    return model


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


def clip_waves(n: int, fs: int, seed: int) -> torch.Tensor:
    """(n, fs) 1-s music-like clips on the card, each a track of its own."""
    return torch.as_tensor(np.stack(music_like_tracks(n, 1, 1, fs, seed)), device="cuda")


def clip_spec(cfg, n: int, seed: int) -> torch.Tensor:
    """The serving path's log-mel of ``clip_waves(n, fs, seed)``."""
    from grafp_tpu_torch.dsp.melspec import LogMelConfig, log_mel_spectrogram

    return log_mel_spectrogram(clip_waves(n, int(cfg["fs"]), seed),
                               LogMelConfig.from_config(cfg))


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


# --- phase 8: the evaluation path ---------------------------------------
EVAL_ROWS = 1 << 20            # catalogue rows in the retrieval phase (512 MiB f32)
EVAL_SEQ = "1 3 5 9 11 19"
EVAL_TEST_IDS = 500
SEARCH_K = 20
CHECK_QUERIES = 256
# near-tie band of the search checks: ranks whose reference distance lies
# within DIST_BAND of the next rank's may swap (the f32 distances of unit
# rows were within 6e-7 of float64 on the card)
DIST_BAND = 4e-6


def music_like_tracks(n: int, lo_s: float, hi_s: float, fs: int, seed: int):
    """n seeded tracks of lo_s..hi_s seconds: notes of 0.15-0.6 s, each
    three random partials at random gains, over a faint noise floor, so
    that segments a hop apart differ."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        t = rs.randint(int(lo_s * fs), int(hi_s * fs) + 1)
        w = 0.005 * rs.randn(t)
        i = 0
        while i < t:
            dur = rs.randint(int(0.15 * fs), int(0.6 * fs))
            tt = np.arange(min(dur, t - i)) / fs
            for f, a in zip(rs.uniform(80, 5000, 3), rs.uniform(0.02, 0.2, 3)):
                w[i:i + len(tt)] += a * np.sin(2 * np.pi * f * tt + rs.uniform(0, 6.3))
            i += dur
        out.append(w.astype(np.float32))
    return out


def embed_calls(pipe, waves, pack: int) -> int:
    """The embed batches the DB builders run for ``waves`` at ``pack``: per
    chunk of pack tracks, runs of one bucket length, each ceil(segments /
    batch_size) batches."""
    calls = 0
    for c0 in range(0, len(waves), pack):
        pads = [pipe._pad_track(w) for w in waves[c0:c0 + pack]]
        i = 0
        while i < len(pads):
            j, rows = i, 0
            while (j < len(pads) and pads[j][1] > 0
                   and pads[j][0].shape[1] == pads[i][0].shape[1]):
                rows += pads[j][1]
                j += 1
            calls += -(-rows // pipe.batch_size)
            i = max(j, i + 1)
    return calls


def ids_agree(got, want, dist):
    """(search ids equal at every rank whose reference distance is not
    within DIST_BAND of a neighbouring rank's, the share of ranks so
    compared)."""
    gaps = np.diff(dist, axis=1)
    close = (gaps >= 0) & (gaps < DIST_BAND)
    near = np.zeros(dist.shape, bool)
    near[:, 1:] |= close
    near[:, :-1] |= close
    return bool((got[~near] == want[~near]).all()), float(1 - near.mean())


def cuda_events(fn, iters: int):
    """torch.profiler's CUDA kernel averages over ``iters`` calls of ``fn``,
    after one call outside the profile."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages() if e.device_type.name == "CUDA"]


def elementwise_ms(fn, iters: int = 5):
    """(device busy ms, elementwise and reduction kernels ms) per call of
    ``fn`` under torch.profiler; the second counts PyTorch's
    elementwise_kernel / vectorized / unrolled and reduce_kernel
    launches."""
    events = cuda_events(fn, iters)
    busy = sum(e.device_time_total for e in events) / 1e3 / iters
    elem = sum(e.device_time_total for e in events
               if "elementwise" in e.key or "reduce_kernel" in e.key) / 1e3 / iters
    return busy, elem


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


def eval_phase(cfg, state_dict, zero_counts, counts, card: str, work: str) -> dict:
    """Phase 8: wave -> DB memmaps -> index -> search -> sequence rescoring
    -> hit rates at size t in bf16 with the seeded weights ``state_dict``,
    through the port's entry points on the card. Returns the DB build's
    launch counts and its first, counted build's fp/s. Every check
    raises."""
    from grafp_tpu_torch.fp.builder import (
        FingerprintPipeline,
        create_db,
        create_dummy_db,
        create_fp_db,
    )
    from grafp_tpu_torch.models import build_model
    from grafp_tpu_torch.retrieval.evaluate import (
        TID_BLOCK,
        ConcatRows,
        _score_block,
        _score_block_host,
        _unique_candidates,
        eval_faiss,
        resolve_test_ids,
    )
    from grafp_tpu_torch.retrieval.index import IndexIVFPQ, get_index
    from grafp_tpu_torch.retrieval.memmap_io import load_memmap_data, save_memmap

    model = build_model(cfg)
    model.load_state_dict(state_dict)
    pipe = FingerprintPipeline(model, cfg)
    fs, pack = int(cfg["fs"]), pipe.build_pack
    dummy_tracks = music_like_tracks(96, 20, 40, fs, seed=20)
    fp_tracks = music_like_tracks(32, 20, 40, fs, seed=21)
    gen_tracks = music_like_tracks(4, 20, 40, fs, seed=22)
    segs = [pipe._pad_track(w)[1] for w in dummy_tracks]
    banks = synthetic_banks(cfg, seed=23)
    db_build = {}

    def counted(fn):
        zero_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        for name, n in counts().items():
            db_build[name] = db_build.get(name, 0) + n
        return out, secs

    # the DB builders; the launch counts cover these three calls
    pipe.fingerprint_tracks(dummy_tracks[:2])                     # warm-up
    (n_dummy, _), t_build = counted(lambda: create_dummy_db(
        dummy_tracks, pipe, os.path.join(work, "build"), verbose=False))
    want_calls = embed_calls(pipe, dummy_tracks, pack)
    print(f"db build: create_dummy_db over {len(dummy_tracks)} tracks of 20-40 s "
          f"-> {n_dummy} rows in {t_build:.3f} s, {n_dummy / t_build:.1f} fp/s "
          f"(pack {pack}, {want_calls} embed batches of <= {pipe.batch_size}); "
          f"launches {dict(db_build)} [{card}]", flush=True)
    check(n_dummy == sum(segs), f"dummy rows {n_dummy} != segments {sum(segs)}")
    check(db_build["grapher_block"] == 12 * want_calls and
          sum(db_build.values()) == db_build["grapher_block"],
          f"expected {12 * want_calls} grapher_block launches and no other")
    (n_q, _), t_fp = counted(lambda: create_fp_db(
        fp_tracks, pipe, banks, os.path.join(work, "build"), seed=0, verbose=False))
    fp_rows = sum(pipe._pad_track(w)[1] for w in fp_tracks)
    gen, t_gen = counted(lambda: create_db(gen_tracks, pipe, os.path.join(work, "gen"),
                                           verbose=False))
    check(sum(db_build.values()) == db_build["grapher_block"],
          "the DB build launched a kernel other than grapher_block")
    print(f"db build: create_fp_db over {len(fp_tracks)} tracks (clean + corrupted) "
          f"-> {n_q} rows each in {t_fp:.3f} s; create_db over {len(gen_tracks)} tracks "
          f"-> {gen.shape} in {t_gen:.3f} s; launches {db_build}", flush=True)
    dummy, _ = load_memmap_data(os.path.join(work, "build"), "dummy_db", display=False)
    db, _ = load_memmap_data(os.path.join(work, "build"), "db", display=False)
    query, _ = load_memmap_data(os.path.join(work, "build"), "query", display=False)
    check(n_q == fp_rows == len(db) == len(query), "db and query rows not aligned")
    check(gen.shape == (sum(pipe._pad_track(w)[1] for w in gen_tracks), cfg["d"]),
          f"create_db shape {gen.shape}")
    check(all(np.isfinite(a).all() for a in (dummy, db, query, gen)), "a row is not finite")
    # row order is the eval's ground truth: every packed row must be nearer
    # its own fingerprint_track row than any other track row
    hold_rows("db build: packed rows against fingerprint_track, track by track",
              dummy, np.concatenate([pipe.fingerprint_track(w) for w in dummy_tracks]))
    times = {}
    for p in (1, pack, 1, pack):                       # in turns, after the first build
        t0 = time.perf_counter()
        create_dummy_db(dummy_tracks, pipe, os.path.join(work, f"pack{p}"),
                        verbose=False, pack=p)
        times.setdefault(p, []).append(time.perf_counter() - t0)
    print("db build fp/s by pack: " + "; ".join(
        f"pack {p}: " + ", ".join(f"{n_dummy / t:.1f}" for t in ts)
        for p, ts in sorted(times.items())) + f" [{card}]", flush=True)

    # The catalogue: the built dummy rows, then seeded random unit rows, to
    # EVAL_ROWS rows with db. The clean db rows as queries must find
    # themselves; so must a twin catalogue whose db and query rows are
    # further random unit rows, on which card and host rescoring must also
    # agree exactly (no two of its windows come near a tie).
    built = np.concatenate([np.asarray(dummy), np.asarray(db)])
    check(len(np.unique(built, axis=0)) == len(built), "two built rows are equal")
    pick = np.random.RandomState(26).choice(len(built), min(len(built), 2000), False)
    gram = cosine(built[pick][:, None], built[pick][None])
    hop = cosine(built[:segs[0] - 1], built[1:segs[0]])          # one track's rows
    norms = np.linalg.norm(built, axis=1)
    print(f"built rows: mean pairwise cosine {gram[~np.eye(len(pick), dtype=bool)].mean():.6f}"
          f" ({len(pick)} rows), cosine of rows a hop apart {hop.min():.7f}-{hop.max():.7f}, "
          f"norms {norms.min():.5f}-{norms.max():.5f}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(24)

    def unit_rows(n):
        return torch.nn.functional.normalize(
            torch.randn(n, cfg["d"], device="cuda", generator=g), dim=1).cpu().numpy()

    full_dummy = np.concatenate([np.asarray(dummy), unit_rows(EVAL_ROWS - len(built))])
    twin = unit_rows(len(db))
    dirs = {"built": (np.asarray(db), np.asarray(query)),
            "built, clean queries": (np.asarray(db), np.asarray(db)),
            "random rows, exact queries": (twin, twin)}
    save_memmap(os.path.join(work, "dummy"), "dummy_db", full_dummy)   # shared
    for name, (rows, q) in dirs.items():
        save_memmap(os.path.join(work, name), "db", rows)
        save_memmap(os.path.join(work, name), "query", q)
    hit = {}
    for name, kind in (("built", "l2"), ("built", "ivfpq"),
                       ("built, clean queries", "l2"),
                       ("random rows, exact queries", "l2")):
        t0 = time.perf_counter()
        hit[f"{kind}, {name}"] = eval_faiss(
            os.path.join(work, name), os.path.join(work, "dummy"), index_type=kind,
            test_ids=str(EVAL_TEST_IDS),
            test_seq_len=EVAL_SEQ, n_centroids=64, verbose=name == "built")
        print(f"eval_faiss {kind} on {name}: {time.perf_counter() - t0:.3f} s end to end",
              flush=True)
    sls = [int(x) for x in EVAL_SEQ.split()]
    print(f"hit rates (%), rows top-1 exact / top-1 near / top-3 / top-10, columns "
          f"sequence lengths {sls}, {EVAL_ROWS} rows, {EVAL_TEST_IDS} test ids [{card}]:")
    for name, hr in hit.items():
        print(f"  {name}: " + json.dumps(np.round(hr, 4).tolist()))
        check(hr.shape == (4, len(sls)) and bool(np.isfinite(hr).all())
              and bool(((hr >= 0) & (hr <= 100)).all()), f"{name}: hit rates malformed")
        check(bool((hr[3] >= hr[2]).all() and (hr[2] >= hr[0]).all()),
              f"{name}: top-10 >= top-3 >= top-1 does not hold")
    for name in ("l2, built, clean queries", "l2, random rows, exact queries"):
        check(bool((hit[name][0] == 100).all()), f"{name}: a query misses its own row")

    # the pieces, timed and held against their references
    tids = resolve_test_ids(str(EVAL_TEST_IDS), len(query), max(sls))
    rows = np.minimum((tids[:, None] + np.arange(max(sls))[None, :]).reshape(-1),
                      len(query) - 1)
    qrows = np.asarray(query)[rows]
    sample = qrows[np.random.RandomState(25).choice(len(qrows), CHECK_QUERIES, False)]
    t_ref = time.perf_counter()
    full = np.concatenate([full_dummy, np.asarray(db)]).astype(np.float64)
    s64 = sample.astype(np.float64)
    d64 = ((s64 * s64).sum(1)[:, None] - 2.0 * s64 @ full.T
           + (full * full).sum(1)[None, :])
    top = np.argpartition(d64, SEARCH_K, axis=1)[:, :SEARCH_K]
    order = np.argsort(np.take_along_axis(d64, top, 1), axis=1, kind="stable")
    ref_i = np.take_along_axis(top, order, 1)
    ref_d = np.take_along_axis(d64, ref_i, 1)
    del full, d64
    t_ref = time.perf_counter() - t_ref
    indexes = {}
    for kind in ("l2", "ivfpq"):
        t0 = time.perf_counter()
        idx = get_index(kind, full_dummy, full_dummy.shape, n_centroids=64)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        idx.add(full_dummy)
        idx.add(db)
        idx.search(qrows[:idx.QUERY_CHUNK], SEARCH_K)                 # warm-up
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        _, hits = idx.search(qrows, SEARCH_K)
        t3 = time.perf_counter()
        indexes[kind] = (idx, hits)
        print(f"index {kind}: train {t1 - t0:.3f} s, add {t2 - t1:.3f} s "
              f"({idx.ntotal} rows), search {len(qrows)} queries k={SEARCH_K} in "
              f"{t3 - t2:.3f} s = {len(qrows) / (t3 - t2):.1f} queries/s [{card}]",
              flush=True)
    l2 = indexes["l2"][0]
    for chunk in (256, 512, 1024):                  # 2048 would take ~45 GiB more
        l2.QUERY_CHUNK = chunk
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        l2.search(qrows, SEARCH_K)
        dt = time.perf_counter() - t0
        print(f"index l2 QUERY_CHUNK {chunk}: {len(qrows) / dt:.1f} queries/s, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]", flush=True)
    l2.QUERY_CHUNK = type(l2).QUERY_CHUNK
    got_d, got_i = l2.search(sample, SEARCH_K)
    agree, share = ids_agree(got_i, ref_i, ref_d)
    print(f"l2 search vs float64 numpy top-{SEARCH_K} on {CHECK_QUERIES} query rows: "
          f"max |d| {np.abs(got_d - ref_d).max():.3g}; ids equal outside the band "
          f"{DIST_BAND:g}: {agree}; ranks compared {share:.3f}; the reference took "
          f"{t_ref:.1f} s", flush=True)
    check(agree and share > 0.5, "l2 search ids differ from float64 numpy")
    pq = indexes["ivfpq"][0]
    cpu = IndexIVFPQ(cfg["d"], pq.nlist, torch.device("cpu"))
    cpu.centroids, cpu.pq.codebooks = pq.centroids.cpu(), pq.pq.codebooks.cpu()
    cpu._codes, cpu._cells = [torch.cat(pq._codes).cpu()], [torch.cat(pq._cells).cpu()]
    cpu.ntotal, cpu.is_trained, cpu.nprobe = pq.ntotal, True, pq.nprobe
    t_cpu = time.perf_counter()
    want_d, want_i = cpu.search(sample, SEARCH_K)
    t_cpu = time.perf_counter() - t_cpu
    got_d, got_i = pq.search(sample, SEARCH_K)
    agree, share = ids_agree(got_i, want_i, want_d)
    print(f"ivfpq search card vs CPU on the same centroids, codebooks and codes: max "
          f"|d| {np.abs(got_d - want_d).max():.3g}; ids equal outside the band: {agree}; "
          f"ranks compared {share:.3f}; the CPU search took {t_cpu:.1f} s", flush=True)
    check(agree and share > 0.5, "ivfpq search on the card differs from the CPU")

    # rescoring on the card and on the host: timed on the built catalogue;
    # identical top ids required on the twin, where no two windows tie
    twin_q = twin[rows]
    for name, rows_db, q_all, hits in (
            ("built", np.asarray(db), np.asarray(query), indexes["l2"][1]),
            ("random rows, exact queries", twin, twin, None)):
        recon = ConcatRows(full_dummy, rows_db)
        if hits is None:
            idx = get_index("l2", full_dummy, full_dummy.shape)
            idx.add(full_dummy)
            idx.add(rows_db)
            _, hits = idx.search(twin_q, SEARCH_K)
            del idx
        recon_dev = torch.as_tensor(recon.materialize(), device="cuda")
        comp = hits.reshape(len(tids), max(sls), SEARCH_K)
        comp = np.where(comp < 0, -1, comp - np.arange(max(sls))[None, :, None])
        # the host twin on the first test ids of the twin catalogue, where
        # it must agree; on the built rows the card's times alone
        host = 0 if name == "built" else min(len(tids), TID_BLOCK // 2)
        for sl in sls:
            cand, valid = _unique_candidates(comp[:, :sl].reshape(len(tids), -1))
            qs = np.stack([q_all[t:t + sl] for t in tids]).astype(np.float32)
            dev = lambda: [_score_block(  # noqa: E731
                recon_dev, torch.as_tensor(qs[b:b + TID_BLOCK], device="cuda"),
                torch.as_tensor(cand[b:b + TID_BLOCK], device="cuda"),
                torch.as_tensor(valid[b:b + TID_BLOCK], device="cuda"), sl)[1]
                for b in range(0, len(tids), TID_BLOCK)]
            t_dev = time_ms(dev, reps=3, warmup=1)
            got = torch.cat(dev()).cpu().numpy()[:host]
            differ, t_host = 0, 0.0
            if host:
                t0 = time.perf_counter()
                want = _score_block_host(recon, qs[:host], cand[:host], valid[:host],
                                         sl)[1]
                t_host = (time.perf_counter() - t0) * 1e3
                differ = int((got != want).any(1).sum())
            print(f"rescoring {name} sl={sl}: {len(tids)} test ids, {cand.shape[1]} "
                  f"candidates each: card {t_dev:.3f} ms" + (
                      f"; host {t_host:.1f} ms for the first {host}, whose top ids "
                      f"differ from the card's in {differ}" if host else "")
                  + f" [{card}]", flush=True)
            check(differ == 0, f"rescoring sl={sl}: card and host differ")
        del recon_dev
    return db_build, n_dummy / t_build


# --- phase 9: the entry points --------------------------------------------
# the corpus on disk (tracks, seconds each, seed): bsz_train = 256 gives two
# train steps per epoch; 100 + 20 validation tracks, as config/grafp.yaml's
# n_dummy and n_query
CLI_CORPUS = {"train": (512, 10.0, 40), "val": (120, 30.0, 41),
              "noise": (64, 10.0, 42), "ir": (32, 0.5, 43)}
# largest |d| allowed between the parameters and statistics of a run resumed
# after epoch 2 and of one that ran its 3 epochs uninterrupted, and between
# two uninterrupted runs: on an H100 80GB HBM3 at 700 W two uninterrupted
# 3-epoch runs of phase 9 were equal bit for bit, and so was the resumed one
RESUME_TOL = 0.0


def write_corpus(root: str, fs: int) -> dict:
    """CLI_CORPUS as 16-bit wav files under ``root``/<name>/, written by the
    port's save_wav: music-like train and val tracks, noise clips of
    filtered noise at random gains, and exponentially decaying IRs."""
    from grafp_tpu_torch.data.audio_io import save_wav

    dirs = {}
    for name, (n, secs, seed) in CLI_CORPUS.items():
        rs = np.random.RandomState(seed)
        if name in ("train", "val"):
            waves = music_like_tracks(n, secs, secs, fs, seed)
        elif name == "noise":
            waves = [np.convolve(rs.randn(int(secs * fs)), np.ones(k) / k, "same")
                     * rs.uniform(0.05, 0.5) for k in rs.randint(1, 30, n)]
        else:
            t = np.arange(int(secs * fs))
            waves = [0.8 * rs.randn(len(t)) * np.exp(-t / (len(t) * rs.uniform(0.05, 0.3)))
                     for _ in range(n)]
        dirs[name] = os.path.join(root, name)
        os.makedirs(dirs[name])
        for i, w in enumerate(waves):
            save_wav(os.path.join(dirs[name], f"{name}_{i:04d}.wav"), w, fs)
    return dirs


def run_cli(main_fn, argv, log_path, **kw):
    """One CLI main in this process, its stdout into ``log_path`` (the
    tail is printed when it raises)."""
    try:
        with open(log_path, "a") as log, contextlib.redirect_stdout(log):
            return main_fn(argv, **kw)
    except BaseException:
        with open(log_path) as log:
            print("".join(log.readlines()[-40:]), file=sys.stderr)
        raise


def max_state_diff(a: dict, b: dict) -> float:
    check(sorted(a) == sorted(b), "the two checkpoints hold other keys")
    return max((a[k].double() - b[k].double()).abs().max().item() for k in a)


def cli_phase(state_dict, zero_counts, counts, card: str, work: str,
              step_ms: float, build_fps: float) -> dict:
    """Phase 9: the user's entry points at full width on a wav corpus:
    train_main (2 epochs with validation, from ``state_dict`` as an epoch-0
    checkpoint), its resume against an uninterrupted run, test_fp_main
    --small_test against eval_faiss, generate_main in bf16 and in f32
    against fingerprint_track. Returns the launch counts of these runs.
    Every check raises."""
    import yaml

    from grafp_tpu_torch.cli import generate_main, test_fp_main, train_main
    from grafp_tpu_torch.core import load_config
    from grafp_tpu_torch.data.dataset import FingerprintDataset
    from grafp_tpu_torch.fp.builder import FingerprintPipeline
    from grafp_tpu_torch.models import build_model
    from grafp_tpu_torch.retrieval.evaluate import eval_faiss
    from grafp_tpu_torch.retrieval.memmap_io import load_memmap_data, save_memmap
    from grafp_tpu_torch.train import create_train_state
    from grafp_tpu_torch.train.checkpoint import load_ckp, save_ckp, train_payload

    repo = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(repo, "config", "grafp.yaml"))
    fs, bsz = int(cfg["fs"]), int(cfg["bsz_train"])
    t0 = time.perf_counter()
    dirs = write_corpus(work, fs)
    print(f"cli: wav corpus {', '.join(f'{k} {v[0]} x {v[1]} s' for k, v in CLI_CORPUS.items())}"
          f" written in {time.perf_counter() - t0:.1f} s", flush=True)
    cfg["train_dir"], cfg["val_dir"] = dirs["train"], dirs["val"]
    cfg["noise_dir"], cfg["ir_dir"] = dirs["noise"], dirs["ir"]
    cfg["train_sz"], cfg["val_sz"] = CLI_CORPUS["train"][0], CLI_CORPUS["val"][0]
    check(cfg["compute_dtype"] == "bfloat16", "config/grafp.yaml trains in bf16")
    cfg.save(os.path.join(work, "smoke.yaml"))
    cfg32 = load_config(os.path.join(work, "smoke.yaml"))
    cfg32["compute_dtype"] = "float32"
    cfg32.save(os.path.join(work, "smoke32.yaml"))
    with open(os.path.join(work, "test_config.yaml"), "w") as f:
        yaml.safe_dump({"smoke": ["current"]}, f)
    log = os.path.join(work, "cli.log")
    launches, got = {}, {}

    def counted(name, fn):
        zero_counts()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        got[name] = (counts(), time.perf_counter() - t)
        for k, n in got[name][0].items():
            launches[k] = launches.get(k, 0) + n
        return out

    cwd = os.getcwd()
    os.chdir(work)
    try:
        # the calibrated weights as an epoch-0 checkpoint, so that
        # validation's hit rates are those of weights that tell tracks apart
        start = build_model(cfg, train=True)
        start.load_state_dict(state_dict)
        save_ckp(train_payload(create_train_state(start, cfg), 0, [], []),
                 "start", "checkpoint", 0)
        del start
        common = ["--config", "smoke.yaml", "--seed", "42"]
        from_start = ["--resume", "checkpoint/model_start_0.pth"]

        # a. train 2 epochs with validation
        ha = counted("train", lambda: run_cli(train_main.main, common + from_start + [
            "--ckp", "smoke", "--epochs", "2", "--validate_every", "1"], log))
        ds = FingerprintDataset(cfg, dirs["val"], train=False)
        tracks = [ds[i] for i in range(len(ds))]
        pipe = FingerprintPipeline(build_model(cfg), cfg)
        split = np.arange(len(ds))
        np.random.seed(42)
        np.random.shuffle(split)
        n_dummy, n_query = int(cfg["n_dummy"]), int(cfg["n_query"])
        calls = (embed_calls(pipe, [tracks[i] for i in split[:n_dummy]], pipe.build_pack)
                 + 2 * embed_calls(pipe, [tracks[i] for i in split[n_dummy:n_dummy + n_query]],
                                   pipe.build_pack))
        steps = 2 * (CLI_CORPUS["train"][0] // bsz)
        n_val = sum(h is not None for h in ha["hit_rates"])
        c = got["train"][0]
        print(f"cli train: 2 epochs at bsz_train {bsz} ({steps} steps), losses "
              f"{ha['loss']}, validation at {n_val} epochs ({calls} embed batches each); "
              f"launches {c}", flush=True)
        check(all(np.isfinite(ha["loss"])), "a train loss is not finite")
        check(c == {**{k: 0 for k in c}, "mrconv_concat": 12 * steps,
                    "mrconv_concat_backward": 12 * steps, "grapher_block": 12 * calls * n_val},
              f"expected {12 * steps} mrconv_concat forward and backward launches and "
              f"{12 * calls * n_val} grapher_block launches")
        for tag in ("current", "best"):
            check(os.path.exists(f"checkpoint/model_smoke_{tag}.pth"), f"no {tag} checkpoint")
        for e, hr in enumerate(ha["hit_rates"], 1):
            print(f"cli validation epoch {e} hit rates (%), rows top-1 exact / near / "
                  f"top-3 / top-10: " + json.dumps(np.round(hr, 4).tolist()))
            check(hr.shape == (4, 6) and bool(((hr >= 0) & (hr <= 100)).all())
                  and bool((hr[3] >= hr[2]).all() and (hr[2] >= hr[0]).all()),
                  "validation hit rates malformed")

        # b. resume to epoch 3 against 3 uninterrupted epochs, twice: decoded
        # once (--cache_decoded) and decoded every epoch
        hb = counted("resume", lambda: run_cli(train_main.main, common + [
            "--ckp", "smoke", "--epochs", "3", "--validate_every", "0",
            "--resume", "checkpoint/model_smoke_current.pth"], log))
        hc = counted("uninterrupted", lambda: run_cli(train_main.main, common + from_start + [
            "--ckp", "smoke_one", "--epochs", "3", "--validate_every", "0",
            "--cache_decoded"], log))
        hd = counted("uninterrupted again", lambda: run_cli(
            train_main.main, common + from_start + [
                "--ckp", "smoke_two", "--epochs", "3", "--validate_every", "0"], log))
        resumed = load_ckp("checkpoint/model_smoke_current.pth")
        one = load_ckp("checkpoint/model_smoke_one_current.pth")
        diff = max_state_diff(resumed["state_dict"], one["state_dict"])
        spread = max_state_diff(one["state_dict"], load_ckp(
            "checkpoint/model_smoke_two_current.pth")["state_dict"])
        print(f"cli resume: epoch 3 losses resumed {hb['loss']} vs uninterrupted "
              f"{hc['loss'][2:]} and {hd['loss'][2:]}; steps {resumed['step']} vs "
              f"{one['step']}; largest |d| of the parameters and statistics, resumed vs "
              f"uninterrupted {diff:.3g}, two uninterrupted runs {spread:.3g} (tolerance "
              f"{RESUME_TOL:g})", flush=True)
        check(resumed["epoch"] == one["epoch"] == 3 and resumed["step"] == one["step"],
              "the resumed run did not reach the uninterrupted one's epoch and step")
        check(spread <= RESUME_TOL, f"two uninterrupted runs differ by {spread}")
        check(diff <= RESUME_TOL, f"resumed parameters differ by {diff}")

        # e. the loader's share and the decode cache
        for name, h in (("train", ha), ("uninterrupted --cache_decoded", hc),
                        ("uninterrupted", hd)):
            for e, secs in enumerate(h["epoch_seconds"], 1):
                fixed = steps // 2 * step_ms / 1e3
                print(f"cli {name} epoch {e}: {secs:.3f} s for {steps // 2} steps; "
                      f"{steps // 2} x the fixed-batch step ({step_ms:.3f} ms) = {fixed:.3f} s, "
                      f"so the loader's share is {1 - fixed / secs:.3f} [{card}]", flush=True)

        # every val track's fingerprints by fingerprint_track with the
        # resumed checkpoint, which test_fp and generate read
        model = build_model(cfg)
        model.load_state_dict(resumed["state_dict"])
        track_pipe = FingerprintPipeline(model, cfg)
        by_track = [track_pipe.fingerprint_track(w) for w in tracks]

        # c. test_fp --small_test on the trained checkpoint
        frozen = np.random.RandomState(0).permutation(len(ds))
        np.save(os.path.join("data", "val_indices.npy"), frozen)
        res = counted("test_fp", lambda: run_cli(test_fp_main.main, [
            "--config", "smoke.yaml", "--test_config", "test_config.yaml",
            "--test_dir", dirs["val"], "--n_query_db", str(n_query), "--small_test"], log))
        (fp_dir, hit_rates), = res.values()
        saved = [os.path.join(r, "hit_rates.npy") for r, _, fs_ in os.walk(fp_dir)
                 if "hit_rates.npy" in fs_]
        direct = eval_faiss(fp_dir, test_ids="2000", index_type="l2", verbose=False)
        c, secs = got["test_fp"]
        print(f"cli test_fp --small_test: {secs:.3f} s, launches {c}; hit rates " +
              json.dumps(np.round(hit_rates, 4).tolist()) + f" [{card}]", flush=True)
        check(c == {**{k: 0 for k in c}, "grapher_block": 12 * calls},
              f"expected {12 * calls} grapher_block launches and no other")
        check(len(saved) == 1, f"hit_rates.npy files: {saved}")
        saved = np.load(saved[0])
        check(saved.shape == (4, 6) and bool(((saved >= 0) & (saved <= 100)).all())
              and bool((saved[3] >= saved[2]).all() and (saved[2] >= saved[0]).all()),
              "test_fp hit rates malformed")
        check(np.array_equal(saved, hit_rates) and np.array_equal(saved, direct),
              "test_fp's hit rates differ from eval_faiss on its fingerprint dir")
        # its clean DBs hold the frozen split's tracks in its order, and its
        # clean rows as queries find themselves among its dummy rows once
        # every row is unit-norm in f32: bf16 fingerprints are normalised in
        # bf16 (norms 1 to about 0.3 %), and the rescoring's inner products
        # then prefer a longer neighbour a hop away (cos up to 0.9997 at
        # overlap 0.9) to the row itself, so the raw rows are only printed
        n_db = len(ds) - n_query
        dbs = {name: np.array(load_memmap_data(fp_dir, name, display=False)[0])
               for name in ("dummy_db", "db")}
        for name, ids in (("dummy_db", frozen[:n_db]), ("db", frozen[n_db:])):
            hold_rows(f"cli test_fp {name}.mm vs fingerprint_track of the frozen split's "
                      f"tracks in its order", dbs[name],
                      np.concatenate([by_track[i] for i in ids]))
        norms = np.linalg.norm(np.concatenate(list(dbs.values())), axis=1)
        clean = {}
        for name, unit in (("as built", False), ("unit-norm", True)):
            rows = {k: v / np.linalg.norm(v, axis=1, keepdims=True) if unit else v
                    for k, v in dbs.items()}
            out = os.path.join("clean_queries", "unit" if unit else "raw")
            save_memmap(out, "dummy_db", rows["dummy_db"])
            save_memmap(out, "db", rows["db"])
            save_memmap(out, "query", rows["db"])
            clean[name] = eval_faiss(out, test_ids="2000", index_type="l2", verbose=False)
            print(f"cli test_fp: its clean db rows {name} (norms {norms.min():.5f}-"
                  f"{norms.max():.5f}) as queries, hit rates "
                  + json.dumps(np.round(clean[name], 4).tolist()), flush=True)
        check(bool((clean["unit-norm"][0] == 100).all()),
              "test_fp: a clean db row as a query misses its own row")

        # d. generate, bf16 then f32, against fingerprint_track
        rows = sum(pipe._pad_track(w)[1] for w in tracks)
        gen_calls = embed_calls(pipe, tracks, pipe.build_pack)
        fps = {}
        for name, config, fused in (("bf16", "smoke.yaml", 12), ("f32", "smoke32.yaml", 10)):
            fp = counted(f"generate {name}", lambda: run_cli(generate_main.main, [
                "--config", config, "--test_dir", dirs["val"], "--ckp",
                "checkpoint/model_smoke_current.pth", "--output_dir", f"gen_{name}"], log))
            c, secs = got[f"generate {name}"]
            check(np.array_equal(np.load(f"gen_{name}/fingerprints.npy"), fp),
                  f"generate {name}: fingerprints.npy differs from the rows it returned")
            fps[name] = fp
            print(f"cli generate {name}: {fp.shape} in {secs:.3f} s = {len(fp) / secs:.1f} "
                  f"fp/s from wav files (phase 8's in-memory build: {build_fps:.1f} fp/s); "
                  f"launches {c} [{card}]", flush=True)
            check(fp.shape == (rows, cfg["d"]) and bool(np.isfinite(fp).all()),
                  f"generate {name}: {fp.shape} for {rows} segments")
            check(bool((np.abs(np.linalg.norm(fp, axis=1) - 1) < 1e-2).all()),
                  f"generate {name}: rows not unit-norm")
            check(c == {**{k: 0 for k in c}, "grapher_block": fused * gen_calls,
                        "mrconv_concat": (12 - fused) * gen_calls},
                  f"expected {fused * gen_calls} grapher_block and "
                  f"{(12 - fused) * gen_calls} mrconv_concat launches")
        hold_rows("cli generate bf16 vs fingerprint_track", fps["bf16"],
                  np.concatenate(by_track))
        hold_rows("cli generate f32 vs bf16", fps["f32"], fps["bf16"])
    finally:
        os.chdir(cwd)
    return launches


# --- phase 10: the baseline encoders -------------------------------------
AST_TRAIN_STEPS = 5
NAFP_TRAIN_STEPS = 3
NAFP_BSZ = 256


def device_profile(fn, iters: int = 3, top: int = 6):
    """(device busy ms per call, [(kernel, ms per call), ...] the ``top``
    kernels by device time) of ``fn`` under torch.profiler."""
    events = sorted(cuda_events(fn, iters), key=lambda e: -e.device_time_total)
    busy = sum(e.device_time_total for e in events) / 1e3 / iters
    return busy, [(e.key[:60], e.device_time_total / 1e3 / iters) for e in events[:top]]


def print_profile(what: str, wall_ms: float, fn, card: str) -> None:
    busy, kernels = device_profile(fn)
    print(f"{what}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms (share "
          f"{busy / wall_ms:.3f}); top kernels " + "; ".join(
              f"{k} {ms:.3f}" for k, ms in kernels) + f" [{card}]", flush=True)


@contextlib.contextmanager
def reference_attention():
    """Route the AST's attention through its explicit form (the CPU path)
    on the card, for the f32 reference rows."""
    import grafp_tpu_torch.models.ast as ast

    saved = ast.dot_product_attention
    ast.dot_product_attention = ast.dot_product_attention_reference
    try:
        yield
    finally:
        ast.dot_product_attention = saved


def baseline_serving(name, cfg, waves, zero_counts, counts, card: str) -> dict:
    """One baseline's serving check: ``cfg`` (bf16) with seeded weights
    spread by ``calibrate_baseline``, fingerprint_waves on ``waves`` with
    no kernel launch, held against the same weights in f32 through the
    CPU-path attention on the card, and timed as fp/s at B = len(waves).
    Returns the bf16 model and its times."""
    from grafp_tpu_torch.fp import FingerprintPipeline
    from grafp_tpu_torch.models import build_model

    model = build_model(cfg, generator=torch.Generator().manual_seed(30))
    shared().calibrate_baseline(model, seed=31)
    cfg32 = copy.deepcopy(cfg)
    cfg32["compute_dtype"] = "float32"
    model32 = build_model(cfg32)
    model32.load_state_dict(model.state_dict())
    pipe = FingerprintPipeline(model, cfg)
    zero_counts()
    z = pipe.fingerprint_waves(waves)
    torch.cuda.synchronize()
    got = counts()
    print(f"{name} serving bf16 B={len(waves)}: launches {got}", flush=True)
    check(not any(got.values()), f"{name} serving launched a kernel of the port")
    check(z.shape == (len(waves), cfg["d"]) and bool(torch.isfinite(z).all()),
          f"{name}: z not finite or misshapen")
    with reference_attention():
        z32 = FingerprintPipeline(model32, cfg32).fingerprint_waves(waves)
    hold_rows(f"{name} bf16 vs f32 (the CPU path's attention on the card)", z, z32,
              COS_MIN_FLOOR, COS_MEAN_FLOOR)
    t = time_ms(lambda: pipe.fingerprint_waves(waves), reps=10)
    print(f"{name} serving bf16 B={len(waves)}: {t:.3f} ms, {len(waves) / t * 1e3:.1f} fp/s "
          f"[{card}]", flush=True)
    print_profile(f"{name} serving bf16 B={len(waves)} profile", t,
                  lambda: pipe.fingerprint_waves(waves), card)
    return {"model": model, "pipe": pipe, "serve_ms": t}


def baseline_train(name, cfg, model, steps: int, bsz: int, zero_counts, counts,
                   card: str) -> dict:
    """``steps`` bf16 train steps of ``model``'s weights at ``bsz`` on one
    fixed batch with synthetic banks: no kernel launch, losses finite and
    falling; ms per step (after the first), samples/s and peak memory."""
    from grafp_tpu_torch.models import build_model
    from grafp_tpu_torch.train import create_train_state, make_train_step

    cfg = copy.deepcopy(cfg)
    cfg["bsz_train"] = bsz
    tmodel = build_model(cfg, train=True)
    tmodel.load_state_dict(model.state_dict())
    state = create_train_state(tmodel, cfg, steps_per_epoch=100)
    step = make_train_step(tmodel, cfg, synthetic_banks(cfg, seed=32))
    gw = torch.Generator(device="cuda").manual_seed(33)
    x_i = clip_waves(bsz, cfg.fs, seed=36)           # a music-like clip each
    x_j = x_i.clone()
    losses = []
    zero_counts()
    for i in range(steps):
        if i == 1:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
        losses.append(step(state, x_i, x_j, gw)["loss"].item())
    ms = (time.perf_counter() - t0) * 1e3 / (steps - 1)
    got = counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"{name} train bf16 bsz_train={bsz}: losses {losses}; {ms:.3f} ms a step, "
          f"{bsz / ms * 1e3:.1f} samples/s, peak memory {peak:.2f} GB "
          f"(max_memory_allocated); launches {got} [{card}]", flush=True)
    print_profile(f"{name} train step bf16 bsz_train={bsz} profile", ms,
                  lambda: step(state, x_i, x_j, gw), card)
    check(not any(got.values()), f"{name} training launched a kernel of the port")
    check(all(np.isfinite(losses)), f"{name}: a train loss is not finite")
    check(losses[-1] < losses[0], f"{name}: train losses do not fall: {losses}")
    return {"step_ms": ms, "peak_gb": peak}


def baseline_cli(work: str, zero_counts, counts, card: str) -> None:
    """The baselines' entry points on phase 9's wav corpus under ``work``:
    baseline_train (AST, config/ast.yaml, one epoch with validation),
    baseline_test_fp --small_test --model tc10 (its DB rows each nearest
    its own fingerprint_track row in the frozen split's order), and
    generate_main against fingerprint_track. No kernel launch."""
    import yaml

    from grafp_tpu_torch.cli import baseline_test_fp, baseline_train, generate_main
    from grafp_tpu_torch.core import load_config
    from grafp_tpu_torch.data.dataset import FingerprintDataset
    from grafp_tpu_torch.fp import FingerprintPipeline
    from grafp_tpu_torch.models import build_model
    from grafp_tpu_torch.retrieval.memmap_io import load_memmap_data
    from grafp_tpu_torch.train.checkpoint import load_ckp

    repo = os.path.dirname(os.path.abspath(__file__))
    dirs = {name: os.path.join(work, name) for name in CLI_CORPUS}
    cfg = load_config(os.path.join(repo, "config", "ast.yaml"))
    cfg["train_dir"], cfg["val_dir"] = dirs["train"], dirs["val"]
    cfg["noise_dir"], cfg["ir_dir"] = dirs["noise"], dirs["ir"]
    cfg["train_sz"], cfg["val_sz"] = CLI_CORPUS["train"][0], CLI_CORPUS["val"][0]
    home = os.path.join(work, "baselines")
    os.makedirs(os.path.join(home, "data"))
    cfg.save(os.path.join(home, "ast.yaml"))
    with open(os.path.join(home, "test_config.yaml"), "w") as f:
        yaml.safe_dump({"tc10": ["current"]}, f)
    log = os.path.join(home, "cli.log")
    cwd = os.getcwd()
    os.chdir(home)
    try:
        zero_counts()
        t = time.perf_counter()
        h = run_cli(baseline_train.main, ["--config", "ast.yaml", "--ckp", "tc10",
                                          "--epochs", "1", "--validate_every", "1"], log)
        t_train = time.perf_counter() - t
        hr, = h["hit_rates"]
        print(f"baselines cli baseline_train (AST): 1 epoch ({CLI_CORPUS['train'][0]} tracks, "
              f"bsz_train {cfg['bsz_train']}) loss {h['loss']}, epoch {h['epoch_seconds'][0]:.3f} s, "
              f"with validation and checkpoints {t_train:.3f} s; hit rates "
              + json.dumps(np.round(hr, 4).tolist()) + f" [{card}]", flush=True)
        check(np.isfinite(h["loss"]).all() and hr.shape == (4, 6)
              and bool(((hr >= 0) & (hr <= 100)).all()), "baseline_train's run is malformed")
        ds = FingerprintDataset(cfg, dirs["val"], train=False)
        tracks = [ds[i] for i in range(len(ds))]
        frozen = np.random.RandomState(0).permutation(len(ds))
        np.save(os.path.join("data", "val_indices.npy"), frozen)
        n_query = int(cfg["n_query"])
        t = time.perf_counter()
        res = run_cli(baseline_test_fp.main, [
            "--config", "ast.yaml", "--test_config", "test_config.yaml", "--test_dir",
            dirs["val"], "--n_query_db", str(n_query), "--small_test", "--model", "tc10"], log)
        (fp_dir, hit_rates), = res.values()
        print(f"baselines cli baseline_test_fp --small_test --model tc10: "
              f"{time.perf_counter() - t:.3f} s; hit rates "
              + json.dumps(np.round(hit_rates, 4).tolist()) + f" [{card}]", flush=True)
        tc10 = baseline_test_fp.resolved_config("ast.yaml", "tc10")
        check((tc10["offset"], tc10["overlap"]) == (0.05, 0.9), "tc10's preset")
        model = build_model(cfg)
        model.load_state_dict(load_ckp("checkpoint/model_tc10_current.pth")["state_dict"])
        by_track = [FingerprintPipeline(model, tc10).fingerprint_track(w) for w in tracks]
        n_db = len(ds) - n_query
        for name, ids in (("dummy_db", frozen[:n_db]), ("db", frozen[n_db:])):
            rows = np.array(load_memmap_data(fp_dir, name, display=False)[0])
            hold_rows(f"baselines cli test_fp {name}.mm vs fingerprint_track (tc10) of the "
                      f"frozen split's tracks in its order", rows,
                      np.concatenate([by_track[i] for i in ids]))
        t = time.perf_counter()
        fp = run_cli(generate_main.main, [
            "--config", "ast.yaml", "--test_dir", dirs["val"], "--ckp",
            "checkpoint/model_tc10_current.pth", "--output_dir", "gen"], log)
        secs = time.perf_counter() - t
        print(f"baselines cli generate (AST): {fp.shape} in {secs:.3f} s = "
              f"{len(fp) / secs:.1f} fp/s from wav files [{card}]", flush=True)
        pipe = FingerprintPipeline(model, cfg)
        hold_rows("baselines cli generate vs fingerprint_track",
                  fp, np.concatenate([pipe.fingerprint_track(w) for w in tracks]))
        got = counts()
        check(not any(got.values()), f"the baselines' entry points launched a kernel: {got}")
    finally:
        os.chdir(cwd)


def baselines_phase(work: str, zero_counts, counts, card: str) -> None:
    """Phase 10: the AST (config/ast.yaml) and NAFP (Config(arch='nafp',
    n_mels=256): the repo has no NAFP config) through serving and training
    at full width in bf16, then the baselines' entry points on phase 9's
    corpus. Every step counts no kernel launch: no TPU kernel lies on these
    paths. Every check raises."""
    from grafp_tpu_torch.core import Config, load_config

    repo = os.path.dirname(os.path.abspath(__file__))
    ast_cfg = load_config(os.path.join(repo, "config", "ast.yaml"))
    nafp_cfg = Config(arch="nafp", n_mels=256, compute_dtype="bfloat16")
    check(ast_cfg["compute_dtype"] == "bfloat16", "config/ast.yaml serves in bf16")
    waves = clip_waves(B, ast_cfg.fs, seed=34)
    for name, cfg, steps, bsz in (("AST", ast_cfg, AST_TRAIN_STEPS, int(ast_cfg["bsz_train"])),
                                  ("NAFP", nafp_cfg, NAFP_TRAIN_STEPS, NAFP_BSZ)):
        served = baseline_serving(name, cfg, waves, zero_counts, counts, card)
        if name == "AST":
            wave = music_like_tracks(1, 10, 10, cfg.fs, seed=35)[0]
            zero_counts()
            zt = served["pipe"].fingerprint_track(wave)
            zs = served["pipe"].embed(served["pipe"].segments_for(wave)).cpu().numpy()
            check(zt.shape == (18, cfg["d"]) and not any(counts().values()),
                  f"AST track fingerprints {zt.shape}")
            hold_rows("AST fingerprint_track vs embed(segments_for)", zt, zs)
        baseline_train(name, cfg, served["model"], steps, bsz, zero_counts, counts, card)
        del served
        torch.cuda.empty_cache()
    baseline_cli(work, zero_counts, counts, card)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from grafp_tpu_torch.core import Config
    from grafp_tpu_torch.dsp.melspec import log_mel_spectrogram
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
    print(f"phase 2 at {time.perf_counter() - t_all:.1f} s", flush=True)
    for name, (secs, log) in build_all(["mrconv_concat", "max_neighbors",
                                        "grapher_block"]).items():
        print(f"build {name}: {secs:.1f} s")
        for line in log.splitlines():
            if ("spill" in line and " 0 bytes spill" not in line) or "Performance Loss" in line:
                print(f"  ptxas: {line.strip()}")

    # 3. kernels vs plain versions at the main paths' widths
    print(f"phase 3 at {time.perf_counter() - t_all:.1f} s", flush=True)
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
    print(f"phase 4 at {time.perf_counter() - t_all:.1f} s", flush=True)
    n_graphers = sum(BLOCKS)
    launches = {name: {} for name in wrappers}          # path -> count
    cfg32, cfg16 = Config(), Config(compute_dtype="bfloat16")
    # the unfused path ('auto' fuses on the card)
    model32 = build_model(cfg32, generator=torch.Generator().manual_seed(0),
                          fuse_serving="off")
    randomize(model32, torch.Generator().manual_seed(1))
    shared().calibrate(model32, clip_spec(cfg32, 512, seed=9))
    model16 = build_model(cfg16, fuse_serving="off")
    model16.load_state_dict(model32.state_dict())
    pipe16 = FingerprintPipeline(model16, cfg16)
    pipe32 = FingerprintPipeline(model32, cfg32)
    waves = clip_waves(B, cfg16.fs, seed=2)

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

    # the reference: the unfolded f32 model through the plain versions
    z32k = pipe32.fingerprint_waves(waves)
    spec = log_mel_spectrogram(waves, pipe32.mcfg)
    before = mrconv_concat.launches
    with plain_versions(), torch.no_grad():
        _, z32p = model32(spec)
        z32f = pipe32.fingerprint_waves(waves)
    check(mrconv_concat.launches == before, "the plain path launched the kernel")
    hold_rows("bf16 kernel path (folded) vs f32 plain unfolded", z16, z32p,
              COS_MIN_FLOOR, COS_MEAN_FLOOR)
    hold_rows("the fold: f32 plain folded vs f32 plain unfolded", z32f, z32p, F32_COS)
    hold_rows("f32 kernel path (folded) vs f32 plain unfolded", z32k, z32p, F32_COS)

    wave = music_like_tracks(1, 10, 10, cfg16.fs, seed=3)[0]
    before = mrconv_concat.launches
    zt = pipe16.fingerprint_track(wave)
    zs = pipe16.embed(pipe16.segments_for(wave)).cpu().numpy()
    print(f"track: 10 s -> {zt.shape[0]} fingerprints, launches "
          f"{mrconv_concat.launches - before}")
    check(zt.shape == (94, cfg16.d), f"track fingerprints {zt.shape}")
    hold_rows("fingerprint_track vs embed(segments_for)", zt, zs)

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
        name = str(dtype)[6:]
        if dtype == torch.bfloat16:
            hold_rows(f"fused {name} vs f32 plain unfolded", zf, z32p,
                      COS_MIN_FLOOR, COS_MEAN_FLOOR)
            hold_rows(f"fused {name} vs unfused {name} kernel path", zf, z16,
                      COS_MIN_FLOOR, COS_MEAN_FLOOR)
        else:
            hold_rows(f"fused {name} vs f32 plain unfolded", zf, z32p, F32_COS)
    before = grapher_block.launches
    zft = fpipe16.fingerprint_track(wave)
    print(f"fused track: 10 s -> {zft.shape[0]} fingerprints, grapher_block "
          f"launches {grapher_block.launches - before}")
    check(zft.shape == zt.shape and bool(np.isfinite(zft).all()), "fused track")
    # rows a hop apart overlap by 90 %: the own row must still be the nearest
    hold_rows("fused track vs unfused track (bf16)", zft, zt)
    del model32, pipe32, z32k, z32p, z32f, fpipe32
    torch.cuda.empty_cache()

    # 5. train path at full width: bsz_train = 256, bf16
    print(f"phase 5 at {time.perf_counter() - t_all:.1f} s", flush=True)
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
    print(f"phase 6 at {time.perf_counter() - t_all:.1f} s", flush=True)
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
    print(f"phase 7 at {time.perf_counter() - t_all:.1f} s", flush=True)
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
    # the same step in f32, Config()'s default compute_dtype
    del state, step, tmodel
    torch.cuda.empty_cache()
    fmodel = build_model(cfg32, generator=torch.Generator().manual_seed(5), train=True)
    fstate = create_train_state(fmodel, cfg32, steps_per_epoch=100)
    fstep = make_train_step(fmodel, cfg32, banks)
    torch.cuda.reset_peak_memory_stats()
    t_f32 = time_ms(lambda: fstep(fstate, x_i, x_j, gen), reps=2, warmup=1)
    print(f"train step f32 bsz_train={bsz}: {t_f32:.3f} ms, {bsz / t_f32 * 1e3:.1f} "
          f"samples/s; peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"(max_memory_allocated) [{card}]", flush=True)
    del fmodel, fstate, fstep
    torch.cuda.empty_cache()
    # the fold's effect on the fused forward: the same weights unfolded,
    # and fused against unfused once both are folded, at B and 2B (the DB
    # build's batch), in turns
    variants = {"fused unfolded": fused_model(cfg16, model16.state_dict()),
                "fused folded": fpipe16.model, "unfused folded": pipe16.model}
    for b in (B, 2 * B):
        spec = log_mel_spectrogram(torch.cat([waves] * (b // B)), fpipe16.mcfg)
        with torch.inference_mode():
            ms = {name: [] for name in variants}
            for _ in range(2):
                for name, m in variants.items():
                    ms[name].append(time_ms(lambda: m(spec), reps=10))
            prof = {name: elementwise_ms(lambda: m(spec)) for name, m in variants.items()}
        print(f"bf16 forward B={b} from log-mel (two turns): " + "; ".join(
            f"{name} {ms[name][0]:.3f}, {ms[name][1]:.3f} ms, device busy "
            f"{prof[name][0]:.3f} ms, elementwise and reductions {prof[name][1]:.3f} ms "
            f"(share {prof[name][1] / prof[name][0]:.3f})" for name in variants)
            + f" [{card}]", flush=True)
    del variants, spec
    torch.cuda.empty_cache()

    # 8. the evaluation path
    print(f"phase 8 at {time.perf_counter() - t_all:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as work:
        db_build, build_fps = eval_phase(cfg16, model16.state_dict(), zero_counts, counts,
                                         card, work)
    for name in wrappers:
        launches[name]["db_build"] = db_build.get(name, 0)
    torch.cuda.empty_cache()

    # 9. the entry points
    print(f"phase 9 at {time.perf_counter() - t_all:.1f} s", flush=True)
    t9 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        cli = cli_phase(model16.state_dict(), zero_counts, counts, card, work, t_step,
                        build_fps)
        for name in wrappers:
            launches[name]["cli"] = cli.get(name, 0)
        print(f"phase 9 took {time.perf_counter() - t9:.1f} s")
        del model16, pipe16, fpipe16
        torch.cuda.empty_cache()

        # 10. the baseline encoders, on phase 9's corpus
        print(f"phase 10 at {time.perf_counter() - t_all:.1f} s", flush=True)
        t10 = time.perf_counter()
        baselines_phase(work, zero_counts, counts, card)
        for name in wrappers:
            launches[name]["baselines"] = 0           # each step checked none
        print(f"phase 10 took {time.perf_counter() - t10:.1f} s")
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
