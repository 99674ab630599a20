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
     train paths' shapes, 2B = 512 in bf16. Then the shapes past the
     one-pass kernels (WIDE_SHAPES: k = 9 and 16 at N = 1024, k = 3 at N =
     2048, 3200 and 4096, k = 32 at N = 256), where the selection runs in
     round groups and bitmap windows, #1-#4 on the same three inputs, and
     #5 at k = 9 on the stage shapes its guard admits;
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
     elementwise and reduction kernels in each; then each kernel at the
     shapes of phase 14's paths, bf16 random inputs, held to its plain
     version as in phase 3 and timed apart from the main paths' sums: #3
     at B = 128 on every stage of both (k = 9 at N = 1024 / 512 / 256 /
     128; k = 3 at N = 3200 / 1600 / 800 / 400), #5 where its guard admits
     the stage, #4 at the train steps' 2B (512 and 128) on every stage, #1
     and #2 at stage 1's 2B;
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
     generate_main with the AST config against fingerprint_track;
 11. int8 serving and the rest of the index family: on phase 4's
     calibrated weights, FingerprintPipeline.fingerprint_waves at B = 128
     in bf16 under serve_quant int8 and int8_static (calibrated lazily on
     other clips first), each counting 12 mrconv_concat launches and no
     grapher_block launch (a quantised Grapher never fuses), its rows held
     to the unfolded f32 plain path above cos 0.98 (the JAX package's own
     floor), then fp/s and device busy share beside bf16 unfused and fused;
     on phase 8's 2^20-row catalogue 'ivfpq-rr' and 'lsh' (train and add
     seconds, queries/s at k = 20, recall@1 and @10 against exact 'l2'),
     'l2' and 'ivfpq' with scan_topk='approx' at scan_recall 0.99 and 0.95
     beside the exact selection on the same index (recall against it at
     least the target less 0.02), native 'hnsw' on 20,000 rows (build
     rows/s, queries/s, recall@10); eval_faiss with 'ivfpq-rr' (the clean
     db rows as queries 100 % top-1), 'lsh' and 'hnsw' (on the built rows
     only) on phase 8's DBs;
 12. the GraphEncoder's remaining options at size t: the 'ramp' model
     (Config(dilation_schedule='ramp', drop_path_schedule='ramp',
     drop_path=0.1): dilations 1,1,1,1,2,2,2,2,3,3,3,3) on phase 4's
     weights through fingerprint_waves at B = 128, unfused bf16 (4
     mrconv_concat launches), fused bf16 (4 grapher_block) and fused f32 (2
     + 2), each held to its f32 plain unfolded rows, timed beside phase 7's
     reference model; five bf16 train steps at bsz_train = 256 (4 + 4
     launches each, losses finite and falling, ms a step, peak memory); one
     f32 step at B = 8 with the kernels against the plain versions (the
     DropPath masks from one seed); one step with remat=True against
     remat=False (equal losses, peak memory of each); knn_strategy
     'exact', 'onehot' and 'approx' serving (no launch) held to phase 4's
     kernel-path rows; EdgeConv, SAGE and GIN (no launch): a bf16 forward
     at B = 128 against its f32 unfolded rows and a bf16 train step at 2B =
     512 against the f32 step's loss (with remat); train_main of the
     'ramp' model on phase 9's corpus for one epoch, resumed to epoch 2
     against two uninterrupted epochs (bit for bit, 4 + 4 launches a
     step).
 13. several devices on the one card: (a) phase 8's 2^20-row catalogue
     split into 4 row shards on the card (a 'db' DeviceMesh of 4 cells on
     cuda:0), exact_topk_sharded ('l2') and masked_scan_search_sharded
     ('ivfpq' on phase 8's centroids and decoded cache) on 2048 query rows,
     the exact local selection's ids held to the single-card search's
     outside the near-tie band, the approximate one (0.99) by recall@20,
     queries/s of each beside the single card's; (b) fault C7:
     db_mesh_from_config(Config(mesh_db=8)) prints the JAX package's notice
     and returns None, and eval_faiss with it on phase 9's fingerprint dir
     gives phase 9's hit rates exactly; (c) the data-parallel train step on
     the NCCL backend at world size 1 (a TCP store on localhost): one f32
     step at B = 8 against the step without a process group (loss rel
     1e-5, grad norm rel 1e-3), then 3 bf16 steps at bsz_train = 256 on
     phase 5's batch and banks, 12 + 12 launches each, losses within 1 %
     of phase 5's, ms a step and peak memory beside phase 5's; (d)
     utils/profiling's scan_time_per_iter and IterTimer on the fused block
     at B = 128 against phase 7's CUDA-event time (within 10 %).
 14. the configurations past the one-pass kernels at full width (size t),
     seeded weights made to behave like trained ones as in phase 4: (a)
     Config(k=9) in bf16 through fingerprint_waves at B = 128, with the
     default fuse_serving='auto' (#3 at stage 1, #5 at stages 2-4) and
     with 'off' (#3 in all 12 blocks), and the folded f32 kernel path, each
     held to the f32 plain unfolded rows; (b) three bf16 train steps of it
     at bsz_train = 256 on phase 5's batch and banks, 12 + 12 launches
     each, losses finite and falling, ms a step and peak memory, and one
     f32 step at B = 8 with the kernels against the plain versions, as in
     phase 5; (c) the
     grafp encoder on config/ast.yaml's frontend (arch 'grafp', hop 161,
     100 frames: N = 3200 / 1600 / 800 / 400 at k = 3, which the fused
     block's guard refuses throughout) through the same serving checks and
     one bf16 train step at bsz_train = WIDE_TRAIN_BSZ.
 15. the captured serving forward: every FingerprintPipeline call above
     replays one CUDA graph per input shape (grafp_tpu_torch/fp/graphs.py),
     captured at the shape's first call. Here, at full width (size t) on
     phase 4's weights, the fused bf16, unfused bf16, f32 and int8_static
     (calibrated lazily first) models and the AST (config/ast.yaml, seeded
     as in phase 10): embed at B = 128 and 256 against the eager forward
     of the same folded model (pipeline.model called directly) on the same
     input, with equal launch counts; the rows not equal bit for bit are
     counted, with the largest |d|, and held (hold_rows) at the floors of
     phases 4 and 11; eager and captured ms in turns, each graph's pool
     bytes and its warm-up and capture seconds; fingerprint_waves at B =
     128 captured against eager (fp/s); a 37.3 s track through
     fingerprint_track (full batches) against the eager embedding of its
     segments in batches with a ragged last one (the parent's path); and
     create_dummy_db over 32 tracks of 20-40 s with the graphs and eagerly,
     in turns (rows, launches, fp/s).
 16. the protocol's scale: (a) scripts/fma_large_smoke.py's geometry through
     the port's driver (scripts/torch_port_fma_large_smoke.py), its 31.1M x
     128 memmaps (30.6M dummy, 500k db and query rows, 15.9 GB) written by
     the driver in a background process from the script's start: eval_faiss
     'ivfpq' (64 cells, nprobe 20, 1M training rows, 500 test ids, lengths 1
     11 19) with rescore='auto' (which must hold the merged DB on the card)
     and 'host' on the same index, with equal hit rates and top-10 ids and
     no kernel launch; each stage's seconds, the host's peak RSS and the
     card's peak memory; against an exact float64 search on the card over
     the merged rows for the test ids' first query rows: the index's 20
     candidates of each against a float64 recomputation from the raw rows
     and the index's centroids and codebooks alone
     (tests/torch_port_util.py:ivfpq_candidate_faults: each candidate in a
     probed cell at its decoded distance, the exact top-1 among them
     wherever its cell is probed and it is nearer than the 20th), each
     pick at length 1 the best of its candidates, and where it is not the
     exact top-1, that row not among them; then 'l2' over the
     31.1M rows, whose picks must be the exact top-1 (outside SCORE_TIE)
     and whose top-1 exact at length 1 lies within FMA_EXACT_POINTS of the
     exact search's; (b) the port's e2e driver
     (scripts/torch_port_e2e_synthetic_icassp.py) at the JAX script's
     defaults (300 tracks of 15 s, 12 epochs at bsz 64, 40 query tracks,
     bf16): the mean loss of the last epoch below the first's, 12 + 12
     launches a step, 12 grapher_block launches an embed batch of the three
     builds (SNR 10, 5, 0) and no other, every hit-rate table (the untrained
     model's SNR-10 'l2' row too) finite and within [0, 100].
 17. the protocol rehearsals through the CLIs, at config/grafp.yaml's
     width: (a) scripts/torch_port_setup_synth_icassp.py's workspace at a
     cut scale (REHEARSAL_TRACKS: 128 train and 440 eval tracks of 10 s,
     written in a background process from the script's start), then
     scripts/torch_port_e2e_cli_icassp_r5.sh for REHEARSAL_EPOCHS epochs:
     its train command and six test_fp rows, each `python -m` CLI run
     under scripts/torch_port_cli_probe.py, which prints the CLI's
     launches, train steps, embed batches, stage seconds and memory
     peaks. Exit 0, the checkpoint written, six hit-rate tables (4, 6)
     finite and within [0, 100]; 12 + 12 launches a train step, 12
     grapher_block launches an embed batch (the epoch-1 validation and the
     test_fp builds) and no other; (b) the int8_static sign-off's run()
     (scripts/torch_port_e2e_int8_retrieval_signoff.py) on (a)'s
     checkpoint and workspace, with SIGNOFF_QUERIES query tracks: the
     bf16 and int8_static dummy rows finite and as many, their cosines
     measured (the first row of each track; no floor applies to a briefly
     trained checkpoint: see rehearsal_phase); 12 mrconv_concat
     launches and no grapher_block an int8_static embed batch (and 12 for
     the lazy calibration's one forward), 12 grapher_block a bf16 one; its
     JSON line. (The mp3 input run of
     scripts/torch_port_e2e_train_input_mp3.sh is not here: the card's host
     has neither libmpg123 nor libmp3lame.)
 18. the last JAX tools, alone (phases 16a's and 17a's writers have ended):
     (a) scripts/torch_port_bf16_train_study.py at scripts/bf16_train_study.py's
     defaults (size t, 64 pairs, 60 steps in f32 and 60 in bf16 from one
     init, the script's banks and per-step generators): its five lines,
     every loss and fingerprint finite, each run's last-10-step mean loss
     below its first loss, ms a step and peak memory; 12 + 12 launches a
     step, and the eval forward's fused blocks (12 in bf16; 10 in f32, whose
     guard refuses stage 1, + 2 mrconv_concat); the f32 run again from the
     same init on the same data, its gap to the first printed as the
     yardstick of the bf16 gap (cuDNN's f32 weight gradients of the three
     convolutions are not deterministic: ROADMAP.md C11); then the f32-trained model
     served in f32, bf16 and int8_static on C10_CLIPS music-like clips, the
     bf16 rows' cosines to the f32 rows and int8_static's to bf16, measured
     with no floor; (b) scripts/torch_port_db_test.py on a dummy_db that
     create_dummy_db writes from (a)'s f32 model, and
     scripts/torch_port_model_test.py on (a)'s f32 model saved by the
     port's checkpoint writer, each as a process on the card: exit 0 and
     the line the JAX tool prints.

The line before the last is the card (nvidia-smi), the one before it the
kernels' JSON (launches by path: the DB build's under "db_build", the
entry points' under "cli", phase 10's under "baselines", phase 11's under
"serve_int8" and "serve_int8_static", phase 12's under "ramp_*", "serve_*"
and "train_*", phase 13's under "train_ddp", phase 14's under "k9_*" and
"n3200_*", phase 16's under "e2e_train" and "e2e_build", phase 17's under
"r5_train", "r5_test_fp", "signoff_bf16" and "signoff_int8_static", phase
18's under "study_f32" and "study_bf16"); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import json
import os
import shutil
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
# phase 3's shapes past the one-pass kernels (k > 8 or k N > 8192),
# (B, N, C, k): round groups, key and row windows, both
WIDE_B = 16
WIDE_SHAPES = ((WIDE_B, 1024, 64, 9), (WIDE_B, 1024, 64, 16), (WIDE_B, 2048, 64, 3),
               (WIDE_B, 3200, 64, 3), (WIDE_B, 4096, 64, 3), (WIDE_B, 256, 256, 32))
K9 = 9                         # the Vision GNN paper's k
AST_STAGES = ((3200, 64), (1600, 128), (800, 256), (400, 512))   # config/ast.yaml's frontend
WIDE_TRAIN_STEPS = 3           # phase 14's k = 9 steps
WIDE_TRAIN_BSZ = 64            # phase 14's step on the 3,200-node frontend (2B = 128)
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


def bound_ms(b: int, n: int, c: int, dtype: torch.dtype, backward: bool, k: int = K):
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
    t_ops = 2 * b * n * n * c / PEAK_OPS_S[dtype] + 2 * k * b * n * n / F32_OPS_S
    if backward:
        t_ops += 2 * k * b * n * c / F32_OPS_S
    return 1e3 * t_bytes, 1e3 * t_ops


def block_bound_ms(b: int, n: int, c: int, dtype: torch.dtype, k: int = K):
    """(bytes time, operations time) in ms for one fused Grapher block.
    Bytes: x in, out written, the folded weights (7 C^2 in the dtype, 4 C
    f32) read once. Operations: fc1, the grouped conv (dense 2C x 2C), fc2
    and the score product, 2 B N C (7C + N), at the dtype's peak, plus a
    compare and a select per score and round on the f32 units."""
    esize = torch.finfo(dtype).bits // 8
    t_bytes = (2 * b * n * c * esize + 7 * c * c * esize + 4 * c * 4) / HBM_BYTES_S
    t_ops = (2 * b * n * c * (7 * c + n) / PEAK_OPS_S[dtype]
             + 2 * k * b * n * n / F32_OPS_S)
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


def near_ties(keys: torch.Tensor, k: int):
    """Per row i of the scores on ``keys``: whether its top-(k+1) scores
    have a gap in the near-tie band, and the (k+1)-th score. The scores
    are taken in f64, exact for bf16 keys: an f32 product (the plain
    version's, or the kernel's) can round two scores 1e-8 apart to one
    value, a tie that the other side may not see. An exact tie is in the
    band where a key that differs from the candidate's scores the same:
    the equal scores are sums of different terms, which each side's f32
    sum may round apart (1 row in 524,288 at k = 9, N = 1024 in bf16);
    identical keys (duplicated or power-of-two scaled rows) score bit for
    bit alike on both sides. Keys are told apart by an f64 projection."""
    xn = keys.double()
    scores = torch.bmm(xn, xn.transpose(1, 2))
    top, idx = scores.topk(min(k + 1, scores.shape[-1]), dim=-1)
    gaps = top[..., :-1] - top[..., 1:]
    near = ((gaps > 0) & (gaps < NEAR_TIE_EPS[keys.dtype])).any(-1)
    proj = torch.randn(keys.shape[-1], generator=torch.Generator().manual_seed(0),
                       dtype=torch.float64).to(keys.device)
    h = xn @ proj                                              # (B, N)
    for m in range(top.shape[-1]):
        other = h[:, None, :] != h.gather(1, idx[..., m])[..., None]
        near |= ((scores == top[..., m:m + 1]) & other).any(-1)
    return scores, near, top[..., -1:]


def forward_band(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Rows i whose own selection may flip."""
    return near_ties(keys, k)[1]


def backward_band(keys: torch.Tensor, k: int) -> torch.Tensor:
    """A near tie of row i can move row i's cotangent among its top-(k+1)
    candidates j, so the band covers those rows j of dx."""
    scores, near, kth = near_ties(keys, k)
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


def hold(what: str, run, ref, band, label: str, ok=within, k: int = K) -> float:
    """One kernel call against its plain version: two launches bit-equal,
    no differing row outside ``band()`` (a (B, N) mask), at most
    MAX_FLIP_SHARE of rows differing, times (k + 1) / (K + 1) past K: the
    band covers each near-tie row's k + 1 candidates. Returns the max abs
    error on the agreeing rows."""
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
    check(flips <= MAX_FLIP_SHARE * max(1.0, (k + 1) / (K + 1)) * rows,
          f"{what} {label}: too many near-tie flips")
    return err


def hold_mrconv(x: torch.Tensor, gy, label: str, k: int = K, forward: bool = True) -> dict:
    """The MRConv kernels against their plain versions: #3 on x (unless not
    ``forward``), whose x half must be x bit for bit, and #4 on (x, gy)
    (unless gy is None)."""
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

    keys, errs = concat_keys(x), {}
    if forward:
        errs["mrconv_concat"] = hold(
            "mrconv_concat", lambda: rel_half(mrconv_concat(x, k)),
            lambda: mrconv_concat_reference(x, k)[..., c:],
            lambda: forward_band(keys, k), label, k=k)
    if gy is not None:
        errs["mrconv_concat_backward"] = hold(
            "mrconv_concat_backward", lambda: mrconv_concat_backward(x, gy, k),
            lambda: mrconv_concat_backward_reference(x, gy, k),
            lambda: backward_band(keys, k), label, k=k)
    return errs


def hold_max_neighbors(x: torch.Tensor, gy: torch.Tensor, label: str, k: int = K) -> dict:
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
            "max_neighbors", lambda: max_neighbors(x, k),
            lambda: max_neighbors_reference(x, k), lambda: forward_band(keys, k), label,
            k=k),
        "max_neighbors_backward": hold(
            "max_neighbors_backward", lambda: max_neighbors_backward(x, gy, k),
            lambda: max_neighbors_backward_reference(x, gy, k),
            lambda: backward_band(keys, k), label, k=k)}


def hold_grapher_block(x: torch.Tensor, ws, label: str, k: int = K) -> float:
    """The fused Grapher block (#5) against its plain version, outside the
    near-tie band of the plain x1's scores."""
    from grafp_tpu_torch.ops.grapher_block import (
        _mm,
        grapher_block,
        grapher_block_reference,
    )

    b, n, c = x.shape
    x1 = (_mm(x.reshape(b * n, c), ws[0]) + ws[1]).to(x.dtype).reshape(b, n, c)
    return hold("grapher_block", lambda: grapher_block(x, k, *ws),
                lambda: grapher_block_reference(x, k, *ws),
                lambda: forward_band(concat_keys(x1), k), label, ok=block_within, k=k)


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


def eval_phase(cfg, state_dict, zero_counts, counts, card: str, work: str):
    """Phase 8: wave -> DB memmaps -> index -> search -> sequence rescoring
    -> hit rates at size t in bf16 with the seeded weights ``state_dict``,
    through the port's entry points on the card. Returns the DB build's
    launch counts, its first, counted build's fp/s, and the catalogue for
    phase 11 (dummy rows, db, query, the searched query rows and their exact
    'l2' ids); the memmaps stay under ``work``. Every check raises."""
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
    catalogue = {"dummy": full_dummy, "db": np.asarray(db), "query": np.asarray(query),
                 "ivfpq": pq,
                 "qrows": qrows, "exact": indexes["l2"][1]}
    return db_build, n_dummy / t_build, catalogue


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
        fp9 = (os.path.abspath(fp_dir), hit_rates)
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
    return launches, fp9


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


# --- phase 11: int8 serving and the rest of the index family -------------
QUANT_FLOOR = 0.98             # int8 rows vs f32 plain, tests/test_quant.py:93,156
# recall of the approximate selection against exact: the target less the
# sampling slack of 9,500 queries x 20 neighbours on one catalogue
APPROX_SLACK = 0.02
HNSW_ROWS = 20_000             # the native HNSW subset: ~15 s of build on one host core


def int8_phase(state_dict, waves, zero_counts, counts, card: str) -> dict:
    """Phase 11a: serve_quant int8 and int8_static at size t in bf16 with
    the calibrated weights ``state_dict``, through FingerprintPipeline at
    B; int8_static calibrates lazily on other clips first. Each run counts
    12 mrconv_concat launches and no grapher_block launch (a quantised
    Grapher never fuses), and its rows are held to the unfolded f32 plain
    path. Then fp/s and the device's busy share of int8, int8_static, bf16
    unfused and bf16 fused, in turns. Returns the launch counts by path."""
    from grafp_tpu_torch.core import Config
    from grafp_tpu_torch.dsp.melspec import LogMelConfig, log_mel_spectrogram
    from grafp_tpu_torch.fp import FingerprintPipeline
    from grafp_tpu_torch.models import build_model

    n_graphers = sum(BLOCKS)
    cfg32 = Config()
    model32 = build_model(cfg32, fuse_serving="off")
    model32.load_state_dict(state_dict)
    with plain_versions(), torch.no_grad():
        _, z32p = model32(log_mel_spectrogram(waves, LogMelConfig.from_config(cfg32)))
    del model32
    pipes, by_path = {}, {}
    for serve in ("int8", "int8_static"):
        cfg = Config(compute_dtype="bfloat16", serve_quant=serve)
        model = build_model(cfg)
        model.load_state_dict(state_dict)
        pipe = FingerprintPipeline(model, cfg)
        check(pipe._needs_calibration == (serve == "int8_static"),
              f"{serve}: lazy calibration due {pipe._needs_calibration}")
        pipe.fingerprint_waves(clip_waves(B, cfg.fs, seed=31))   # warm-up, calibration
        check(not pipe._needs_calibration, f"{serve}: not calibrated")
        zero_counts()
        z = pipe.fingerprint_waves(waves)
        torch.cuda.synchronize()
        got = counts()
        print(f"int8 serving {serve} bf16 B={B}: launches {got}", flush=True)
        check(got == {**{name: 0 for name in got}, "mrconv_concat": n_graphers},
              f"{serve}: expected {n_graphers} mrconv_concat launches and no other")
        by_path[f"serve_{serve}"] = got["mrconv_concat"]
        check(z.shape == (B, cfg.d) and bool(torch.isfinite(z).all()), f"{serve}: bad z")
        hold_rows(f"{serve} bf16 (folded) vs f32 plain unfolded", z, z32p, QUANT_FLOOR)
        pipes[serve] = pipe
    cfg16 = Config(compute_dtype="bfloat16")
    for name, fuse in (("bf16 unfused", "off"), ("bf16 fused", "auto")):
        model = build_model(cfg16, fuse_serving=fuse)
        model.load_state_dict(state_dict)
        pipes[name] = FingerprintPipeline(model, cfg16)
    ms = {name: [] for name in pipes}
    for _ in range(2):                                        # in turns
        for name, pipe in pipes.items():
            ms[name].append(time_ms(lambda: pipe.fingerprint_waves(waves), reps=10))
    for name, pipe in pipes.items():
        wall = sum(ms[name]) / len(ms[name])
        print(f"serving {name} B={B}: {ms[name][0]:.3f}, {ms[name][1]:.3f} ms = "
              f"{B / wall * 1e3:.1f} fp/s [{card}]", flush=True)
        print_profile(f"serving {name} B={B}", wall,
                      lambda: pipe.fingerprint_waves(waves), card)
    return by_path


def recall_at(got: np.ndarray, want: np.ndarray, k: int) -> float:
    """Mean share of each row's first k reference ids among its first k
    ids (recall@1: the first id equal)."""
    if k == 1:
        return float((got[:, 0] == want[:, 0]).mean())
    return float(np.mean([len(set(a[:k]) & set(b[:k])) / k for a, b in zip(got, want)]))


def index_rest_phase(cat: dict, work: str, card: str) -> None:
    """Phase 11b and c: 'ivfpq-rr' and 'lsh' over phase 8's 2^20-row
    catalogue (train and add seconds, queries/s at k = 20, recall@1 and
    @10 against exact 'l2'); 'l2' and 'ivfpq' with scan_topk='approx' at
    scan_recall 0.99 and 0.95 beside the exact selection on the same index
    (recall against it >= the target less APPROX_SLACK); native 'hnsw' on
    HNSW_ROWS rows (build rows/s, queries/s, recall@10 against exact);
    then eval_faiss with each new type on phase 8's DBs."""
    from grafp_tpu_torch.retrieval.evaluate import eval_faiss
    from grafp_tpu_torch.retrieval.index import get_index

    dummy, db, qrows, exact = cat["dummy"], cat["db"], cat["qrows"], cat["exact"]

    def timed_search(idx, q):
        idx.search(q[:1024], SEARCH_K)                                  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, ids = idx.search(q, SEARCH_K)
        return ids, time.perf_counter() - t0

    for kind in ("ivfpq-rr", "lsh"):
        t0 = time.perf_counter()
        idx = get_index(kind, dummy, dummy.shape, n_centroids=64)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        idx.add(dummy)
        idx.add(db)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ids, secs = timed_search(idx, qrows)
        r1, r10 = recall_at(ids, exact, 1), recall_at(ids, exact, 10)
        print(f"index {kind}: train {t1 - t0:.3f} s, add {t2 - t1:.3f} s ({idx.ntotal} "
              f"rows), search {len(qrows)} queries k={SEARCH_K} in {secs:.3f} s = "
              f"{len(qrows) / secs:.1f} queries/s; recall@1 {r1:.4f} recall@10 {r10:.4f} "
              f"against exact l2 [{card}]", flush=True)
        check(ids.shape == (len(qrows), SEARCH_K) and (ids >= 0).all(), f"{kind}: bad ids")
        del idx
        torch.cuda.empty_cache()

    for kind in ("l2", "ivfpq"):
        idx = get_index(kind, dummy, dummy.shape, n_centroids=64)
        idx.add(dummy)
        idx.add(db)
        res = {}
        for turn in range(2):
            for scan, recall in (("exact", 0.99), ("approx", 0.99), ("approx", 0.95)):
                idx.scan_topk, idx.scan_recall = scan, recall
                ids, secs = timed_search(idx, qrows)
                res.setdefault((scan, recall), []).append(len(qrows) / secs)
                if turn == 0:
                    res[(scan, recall, "ids")] = ids
        ref = res[("exact", 0.99, "ids")]
        for scan, recall in (("exact", 0.99), ("approx", 0.99), ("approx", 0.95)):
            got = recall_at(res[(scan, recall, "ids")], ref, SEARCH_K)
            label = "exact" if scan == "exact" else f"approx scan_recall {recall}"
            print(f"index {kind} {label}: " + ", ".join(
                f"{v:.1f}" for v in res[(scan, recall)]) + f" queries/s (two turns); "
                f"recall@{SEARCH_K} against the exact selection {got:.4f} [{card}]",
                flush=True)
            if scan == "approx":
                check(got >= recall - APPROX_SLACK,
                      f"{kind} approx {recall}: recall {got:.4f}")
        del idx
        torch.cuda.empty_cache()

    sub = dummy[:HNSW_ROWS]
    hq = qrows[:2000]
    flat = get_index("l2", sub, sub.shape)
    flat.add(sub)
    _, sub_exact = flat.search(hq, SEARCH_K)
    del flat
    idx = get_index("hnsw", sub, sub.shape)
    t0 = time.perf_counter()
    idx.add(sub)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, ids = idx.search(hq, SEARCH_K)
    t_q = time.perf_counter() - t0
    r10 = recall_at(ids, sub_exact, 10)
    print(f"index hnsw (native, host): build {len(sub)} rows in {t_build:.3f} s = "
          f"{len(sub) / t_build:.1f} rows/s; search {len(hq)} queries k={SEARCH_K} in "
          f"{t_q:.3f} s = {len(hq) / t_q:.1f} queries/s; recall@10 {r10:.4f} against "
          f"exact l2 on the subset", flush=True)
    check(idx._native is not None and r10 > 0.5, "hnsw: not native or recall too low")
    del idx

    sls = [int(x) for x in EVAL_SEQ.split()]
    runs = (("built", "ivfpq-rr", "dummy"), ("built, clean queries", "ivfpq-rr", "dummy"),
            ("built", "lsh", "dummy"), ("build", "hnsw", "build"))
    for name, kind, dummy_dir in runs:
        t0 = time.perf_counter()
        hr = eval_faiss(os.path.join(work, name), os.path.join(work, dummy_dir),
                        index_type=kind, test_ids=str(EVAL_TEST_IDS), test_seq_len=EVAL_SEQ,
                        n_centroids=64, verbose=False)
        print(f"eval_faiss {kind} on {name} (dummy rows from {dummy_dir!r}): "
              f"{time.perf_counter() - t0:.3f} s; hit rates (%), rows top-1 exact / "
              f"top-1 near / top-3 / top-10, columns {sls}: "
              + json.dumps(np.round(hr, 4).tolist()) + f" [{card}]", flush=True)
        check(hr.shape == (4, len(sls)) and bool(np.isfinite(hr).all())
              and bool(((hr >= 0) & (hr <= 100)).all())
              and bool((hr[3] >= hr[2]).all() and (hr[2] >= hr[0]).all()),
              f"eval_faiss {kind} on {name}: hit rates malformed")
        if name == "built, clean queries":
            check(bool((hr[0] == 100).all()), f"{kind}: a clean db row misses itself")


# --- phase 12: the GraphEncoder's remaining options ------------------------
# the 'ramp' model: dilations 1,1,1,1,2,2,2,2,3,3,3,3, DropPath rising to 0.1
RAMP = dict(dilation_schedule="ramp", drop_path_schedule="ramp", drop_path=0.1, k=K)
RAMP_KERNEL_BLOCKS = 4                 # its dilation-1 blocks, stages 1 and 2
# a conv's bf16 train step against the same step in f32 (2B = 512): the
# loss within this relative difference (bf16 rows lie near cos 0.998 of the
# f32 rows, and NT-Xent at tau 0.05 scales cosines by 20)
CONV_LOSS_RTOL = 0.02


def ramp_fusing(dtype: torch.dtype) -> int:
    """How many of the 'ramp' model's kernel-path blocks (stages 1 and 2)
    the fused block's guard admits in ``dtype``."""
    from grafp_tpu_torch.ops.grapher_block import grapher_block_supported

    return sum(nb for (n, c), nb in zip(STAGES[:2], BLOCKS[:2])
               if grapher_block_supported(n, c, dtype, K))


def expect(got: dict, want: dict, what: str) -> None:
    """The launch counts ``got`` equal ``want``, every kernel not named 0."""
    full = {**{name: 0 for name in got}, **want}
    check(got == full, f"{what}: launches {got}, expected {full}")


def conv_model(cfg, conv: str, train: bool = False):
    """build_model(cfg)'s model on the card with its GraphEncoder built
    with ``conv`` ('edge', 'sage', 'gin'), seeded: Config has no conv
    option, as in the JAX package."""
    from grafp_tpu_torch.models import build_model
    from grafp_tpu_torch.models.gnn import GraphEncoder
    from grafp_tpu_torch.models.layers import init_parameters

    model = build_model(cfg, train=train)
    dtype = torch.bfloat16 if cfg["compute_dtype"] == "bfloat16" else None
    model.encoder = GraphEncoder(in_features=cfg["n_filters"], k=K, conv=conv,
                                 emb_dims=cfg["h"], dtype=dtype)
    init_parameters(model.encoder, torch.Generator().manual_seed(20))
    return model.cuda().train(train)


def train_once(model, cfg, banks, x_i, x_j, seed: int):
    """One train step of ``model`` on (x_i, x_j) from a fresh state, its
    generator from ``seed``; returns (metrics, the step's peak GB)."""
    from grafp_tpu_torch.train import create_train_state, make_train_step

    state = create_train_state(model, cfg, steps_per_epoch=100)
    step = make_train_step(model, cfg, banks)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m = step(state, x_i, x_j, torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    return m, torch.cuda.max_memory_allocated() / 1e9


def hold_train_step(cfg32, what: str, model_seed: int, data_seed: int, counts) -> None:
    """One f32 train step at B = PARITY_B with the kernels against one with
    the plain versions, the model from ``model_seed``, the inputs and then
    the step's generator (the same DropPath masks) from ``data_seed``: loss
    within LOSS_RTOL, grad norm within GNORM_RTOL, every gradient at a
    cosine above GRAD_COS (tensors under 1e-4 of the grad norm, zero by
    construction, skipped)."""
    from grafp_tpu_torch.models import build_model

    kmodel = build_model(cfg32, generator=torch.Generator().manual_seed(model_seed),
                         train=True)
    pmodel = copy.deepcopy(kmodel)
    gs = torch.Generator(device="cuda").manual_seed(data_seed)
    xs_i = torch.randn(PARITY_B, cfg32.clip_frames, device="cuda", generator=gs)
    xs_j = xs_i + 0.3 * torch.randn(PARITY_B, cfg32.clip_frames, device="cuda", generator=gs)
    before = counts()
    mk, _ = train_once(kmodel, cfg32, None, xs_i, xs_j, seed=data_seed + 1)
    check(counts() != before, f"the {what} kernel step launched no kernel")
    before = counts()
    with plain_versions():
        mp, _ = train_once(pmodel, cfg32, None, xs_i, xs_j, seed=data_seed + 1)
    check(counts() == before, f"the plain {what} step launched a kernel")
    lk, lp = mk["loss"].item(), mp["loss"].item()
    gk, gp = mk["grad_norm"].item(), mp["grad_norm"].item()
    cos, skipped = [], 0
    for a, b in zip(kmodel.parameters(), pmodel.parameters()):
        if b.grad.abs().max().item() < 1e-4 * gp:
            skipped += 1
            continue
        cos.append(((a.grad * b.grad).sum() / (a.grad.norm() * b.grad.norm())).item())
    print(f"{what} train step f32 B={PARITY_B}, kernels vs plain: loss {lk:.7f} vs "
          f"{lp:.7f} (rel {abs(lk - lp) / abs(lp):.2e}), grad norm {gk:.5f} vs {gp:.5f} "
          f"(rel {abs(gk - gp) / gp:.2e}), min gradient cos {min(cos):.7f} ({skipped} "
          "tensors under 1e-4 of the grad norm skipped)", flush=True)
    check(abs(lk - lp) <= LOSS_RTOL * abs(lp), f"{what} train loss differs from plain")
    check(abs(gk - gp) <= GNORM_RTOL * gp, f"{what} grad norm differs from plain")
    check(min(cos) > GRAD_COS, f"a {what} gradient differs from plain")


def graph_options_phase(state_dict, waves, z16, banks, x_i, x_j, ref_ms: dict,
                        work: str, zero_counts, counts, card: str) -> dict:
    """Phase 12: the 'ramp' model (serving fused and unfused against its
    f32 plain path, training, kernels vs plain versions, remat, a
    train_main epoch and its resume on phase 9's corpus under ``work``),
    the pair-layout strategies, and EdgeConv / SAGE / GIN, at full width.
    ``state_dict`` is phase 4's calibrated weights, ``z16`` phase 4's
    bf16 kernel-path rows of ``waves``, ``ref_ms`` phase 7's serving ms of
    the reference model ('unfused', 'fused'). Returns the launch counts by
    path."""
    from grafp_tpu_torch.cli import train_main
    from grafp_tpu_torch.core import Config, load_config
    from grafp_tpu_torch.dsp.melspec import LogMelConfig, log_mel_spectrogram
    from grafp_tpu_torch.fp import FingerprintPipeline
    from grafp_tpu_torch.models import build_model
    from grafp_tpu_torch.train import create_train_state, make_train_step
    from grafp_tpu_torch.train.checkpoint import load_ckp

    by_path = {}
    cfg16, cfg32 = Config(compute_dtype="bfloat16", **RAMP), Config(**RAMP)
    spec = log_mel_spectrogram(waves, LogMelConfig.from_config(cfg32))

    # a. 'ramp' serving, folded, unfused and fused, against the f32 plain path
    ref = build_model(cfg32, fuse_serving="off")
    ref.load_state_dict(state_dict)
    with plain_versions(), torch.no_grad():
        _, z32p = ref(spec)
    del ref
    pipes = {}
    for name, cfg, fuse in (("unfused bfloat16", cfg16, "off"),
                            ("fused bfloat16", cfg16, "auto"),
                            ("fused float32", cfg32, "auto")):
        model = build_model(cfg, fuse_serving=fuse)
        model.load_state_dict(state_dict)
        pipe = FingerprintPipeline(model, cfg)
        dtype = torch.bfloat16 if name.endswith("bfloat16") else torch.float32
        fusing = ramp_fusing(dtype) if fuse == "auto" else 0
        zero_counts()
        z = pipe.fingerprint_waves(waves)
        torch.cuda.synchronize()
        got = counts()
        path = "ramp_serve" + (f"_fused_{name.split()[1]}" if fuse == "auto" else "")
        by_path[path] = got
        print(f"ramp serving {name} B={B}: launches {got}", flush=True)
        expect(got, {"grapher_block": fusing,
                     "mrconv_concat": RAMP_KERNEL_BLOCKS - fusing}, f"ramp serving {name}")
        check(z.shape == (B, cfg.d) and bool(torch.isfinite(z).all()), f"ramp {name}: bad z")
        if dtype == torch.bfloat16:
            hold_rows(f"ramp {name} (folded) vs f32 plain unfolded", z, z32p,
                      COS_MIN_FLOOR, COS_MEAN_FLOOR)
            pipes[name.split()[0]] = pipe
        else:
            hold_rows(f"ramp {name} (folded) vs f32 plain unfolded", z, z32p, F32_COS)
    ms = {name: [] for name in pipes}
    for _ in range(2):                                        # in turns
        for name, pipe in pipes.items():
            ms[name].append(time_ms(lambda: pipe.fingerprint_waves(waves), reps=10))
    for name, pipe in pipes.items():
        wall = sum(ms[name]) / 2
        print(f"ramp serving {name} bf16 B={B}: {ms[name][0]:.3f}, {ms[name][1]:.3f} ms = "
              f"{B / wall * 1e3:.1f} fp/s; the reference model, phase 7: "
              f"{ref_ms[name]:.3f} ms = {B / ref_ms[name] * 1e3:.1f} fp/s [{card}]",
              flush=True)
        print_profile(f"ramp serving {name} bf16 B={B}", wall,
                      lambda: pipe.fingerprint_waves(waves), card)
    del pipes
    torch.cuda.empty_cache()

    # b. the pair layout: 'exact', 'onehot', 'approx' launch no kernel
    for strategy in ("exact", "onehot", "approx"):
        cfg = Config(compute_dtype="bfloat16", knn_strategy=strategy)
        model = build_model(cfg)
        model.load_state_dict(state_dict)
        pipe = FingerprintPipeline(model, cfg)
        zero_counts()
        z = pipe.fingerprint_waves(waves)
        torch.cuda.synchronize()
        got = counts()
        by_path[f"serve_{strategy}"] = got
        expect(got, {}, f"knn_strategy {strategy}")
        hold_rows(f"knn_strategy {strategy} bf16 vs the kernel path (phase 4)", z, z16,
                  COS_MIN_FLOOR, COS_MEAN_FLOOR)
        t = time_ms(lambda: pipe.fingerprint_waves(waves), reps=3, warmup=1)
        print(f"serving knn_strategy {strategy} bf16 B={B}: launches {got}; {t:.3f} ms = "
              f"{B / t * 1e3:.1f} fp/s [{card}]", flush=True)
        del model, pipe
    torch.cuda.empty_cache()

    # c. 'ramp' training: five bf16 steps at bsz_train on one fixed batch
    bsz = x_i.shape[0]
    tmodel = build_model(cfg16, generator=torch.Generator().manual_seed(5), train=True)
    state = create_train_state(tmodel, cfg16, steps_per_epoch=100)
    step = make_train_step(tmodel, cfg16, banks)
    gen = torch.Generator(device="cuda").manual_seed(12)
    losses, total = [], {}
    for i in range(TRAIN_STEPS):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        zero_counts()
        m = step(state, x_i, x_j, gen)
        torch.cuda.synchronize()
        got = counts()
        expect(got, {"mrconv_concat": RAMP_KERNEL_BLOCKS,
                     "mrconv_concat_backward": RAMP_KERNEL_BLOCKS}, f"ramp train step {i}")
        total = {k: total.get(k, 0) + n for k, n in got.items()}
        losses.append(m["loss"].item())
        print(f"ramp train step {i}: loss {losses[-1]:.6f} grad norm "
              f"{m['grad_norm'].item():.4f}, launches {got}", flush=True)
    by_path["ramp_train"] = total
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(all(np.isfinite(losses)), "a ramp train loss is not finite")
    check(losses[-1] < losses[0], f"ramp train losses do not fall: {losses}")
    t_step = time_ms(lambda: step(state, x_i, x_j, gen), reps=3, warmup=1)
    print(f"ramp train step bf16 bsz_train={bsz}: {t_step:.3f} ms, "
          f"{bsz / t_step * 1e3:.1f} samples/s; peak memory {peak:.2f} GB "
          f"(max_memory_allocated) [{card}]", flush=True)
    del tmodel, state, step
    torch.cuda.empty_cache()

    # d. one f32 step at B = 8 with the kernels against the plain versions,
    # the DropPath masks drawn from one seed on both sides
    hold_train_step(cfg32, "ramp", 8, 13, counts)

    # e. remat against no remat: one bf16 step at bsz_train each, one seed
    res = {}
    for remat in (False, True):
        cfg = Config(compute_dtype="bfloat16", remat=remat, **RAMP)
        model = build_model(cfg, generator=torch.Generator().manual_seed(15), train=True)
        res[remat] = train_once(model, cfg, banks, x_i, x_j, seed=16)
        del model
        torch.cuda.empty_cache()
    (m0, p0), (m1, p1) = res[False], res[True]
    print(f"ramp remat bf16 bsz_train={bsz}: loss {m0['loss'].item():.7f} without, "
          f"{m1['loss'].item():.7f} with; grad norm {m0['grad_norm'].item():.5f} / "
          f"{m1['grad_norm'].item():.5f}; peak memory of the step {p0:.2f} GB without, "
          f"{p1:.2f} GB with remat [{card}]", flush=True)
    check(torch.equal(m0["loss"], m1["loss"]), "remat changed the loss")

    # f. EdgeConv, SAGE, GIN: a bf16 forward at B and a bf16 step at 2B, each
    # against its f32 plain path; EdgeConv's tree is the MRConv's, so it
    # takes phase 4's weights, SAGE and GIN seeded, calibrated ones. The f32
    # step runs with remat, which changes no loss (e.): without it
    # EdgeConv's f32 step at 512 pairs comes close to the card's 80 GB
    cfg16c, cfg32c = Config(compute_dtype="bfloat16"), Config()
    for conv in ("edge", "sage", "gin"):
        m32 = conv_model(cfg32c, conv)
        if conv == "edge":
            m32.load_state_dict(state_dict)
        else:
            randomize(m32, torch.Generator().manual_seed(21))
            shared().calibrate(m32, clip_spec(cfg32c, 256, seed=22))
        weights = {k: v.detach().clone() for k, v in m32.state_dict().items()}
        m16 = conv_model(cfg16c, conv)
        m16.load_state_dict(weights)
        pipe = FingerprintPipeline(m16, cfg16c)
        zero_counts()
        z = pipe.fingerprint_waves(waves)
        torch.cuda.synchronize()
        got = counts()
        with torch.no_grad():
            _, zp = m32(spec)
        expect(got, {}, f"{conv} serving")
        by_path[f"serve_{conv}"] = got
        hold_rows(f"{conv} bf16 (folded) vs f32 unfolded", z, zp,
                  COS_MIN_FLOOR, COS_MEAN_FLOOR)
        t = time_ms(lambda: pipe.fingerprint_waves(waves), reps=3, warmup=1)
        del m16, m32, pipe
        torch.cuda.empty_cache()
        steps = {}
        for name, cfg in (("bf16", cfg16c), ("f32 remat", cfg32c)):
            model = conv_model(cfg, conv, train=True)
            model.encoder.remat = name == "f32 remat"
            model.load_state_dict(weights)
            zero_counts()
            steps[name] = train_once(model, cfg, banks, x_i, x_j, seed=23)
            expect(counts(), {}, f"{conv} train step {name}")
            del model
            torch.cuda.empty_cache()
        by_path[f"train_{conv}"] = counts()
        (ms16, p16), (ms32, p32) = steps["bf16"], steps["f32 remat"]
        l16, l32 = ms16["loss"].item(), ms32["loss"].item()
        print(f"conv {conv}: serving bf16 B={B} {t:.3f} ms = {B / t * 1e3:.1f} fp/s; train "
              f"step 2B={2 * bsz}: loss bf16 {l16:.6f} vs f32 {l32:.6f} (rel "
              f"{abs(l16 - l32) / abs(l32):.2e}), grad norm {ms16['grad_norm'].item():.4f} "
              f"vs {ms32['grad_norm'].item():.4f}, peak {p16:.2f} GB (bf16) / {p32:.2f} GB "
              f"(f32 with remat) [{card}]",
              flush=True)
        check(np.isfinite(l16) and abs(l16 - l32) <= CONV_LOSS_RTOL * abs(l32),
              f"{conv}: the bf16 step's loss is not the f32 step's")

    # g. train_main of the 'ramp' model on phase 9's corpus: one epoch, its
    # resume to epoch 2 against two uninterrupted epochs
    cfg = load_config(os.path.join(work, "smoke.yaml"))
    for key, val in RAMP.items():
        cfg[key] = val
    cfg.save(os.path.join(work, "ramp.yaml"))
    steps = CLI_CORPUS["train"][0] // int(cfg["bsz_train"])
    log = os.path.join(work, "cli.log")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        common = ["--config", "ramp.yaml", "--seed", "42", "--validate_every", "0"]
        runs = {}
        for name, argv, epochs in (
                ("one epoch", ["--ckp", "ramp", "--epochs", "1"], 1),
                ("resumed", ["--ckp", "ramp", "--epochs", "2", "--resume",
                             "checkpoint/model_ramp_current.pth"], 1),
                ("uninterrupted", ["--ckp", "ramp_two", "--epochs", "2"], 2)):
            zero_counts()
            t0 = time.perf_counter()
            runs[name] = run_cli(train_main.main, common + argv, log)
            torch.cuda.synchronize()
            got = counts()
            print(f"cli ramp train {name}: {time.perf_counter() - t0:.3f} s, losses "
                  f"{runs[name]['loss']}, launches {got} [{card}]", flush=True)
            check(all(np.isfinite(runs[name]["loss"])), f"cli ramp {name}: a loss is not finite")
            expect(got, {"mrconv_concat": RAMP_KERNEL_BLOCKS * steps * epochs,
                         "mrconv_concat_backward": RAMP_KERNEL_BLOCKS * steps * epochs},
                   f"cli ramp {name}")
            by_path[f"ramp_cli_{name.replace(' ', '_')}"] = got
        resumed = load_ckp("checkpoint/model_ramp_current.pth")
        two = load_ckp("checkpoint/model_ramp_two_current.pth")
        diff = max_state_diff(resumed["state_dict"], two["state_dict"])
        print(f"cli ramp resume: epoch 2 loss resumed {runs['resumed']['loss']} vs "
              f"uninterrupted {runs['uninterrupted']['loss'][1:]}; largest |d| of the "
              f"parameters and statistics {diff:.3g} (tolerance {RESUME_TOL:g})", flush=True)
        check(resumed["step"] == two["step"] and diff <= RESUME_TOL,
              f"the resumed ramp run differs by {diff}")
    finally:
        os.chdir(cwd)
    return by_path


# --- phase 13: several devices ---------------------------------------------
SHARDS = 4                     # 'db' shards of the catalogue, all on the one card
MESH_QUERIES = 2048            # query rows of the sharded search (two QUERY_CHUNKs)
DDP_STEPS = 3
DDP_LOSS_RTOL = 0.01           # bf16 steps at world size 1 vs phase 5's steps
TIMER_RTOL = 0.10              # utils/profiling against phase 7's CUDA events


def multi_device_phase(cat: dict, fp9, banks, x_i, x_j, ref: dict, zero_counts,
                       counts, card: str) -> dict:
    """Phase 13: (a) the sharded search on phase 8's catalogue, split into
    SHARDS row shards on the one card, 'l2' and 'ivfpq' (phase 8's
    centroids, codebooks and cache), exact and approximate local selection,
    against the single-card search; (b) fault C7: db_mesh_from_config with
    mesh_db 8 on one card and eval_faiss with its mesh on phase 9's
    fingerprint dir ``fp9`` = (dir, hit rates); (c) the data-parallel train
    step on NCCL at world size 1 (f32 B = 8 against the step without a
    process group; DDP_STEPS bf16 steps at bsz_train on phase 5's batch and
    banks against phase 5's losses ``ref["losses"]``); (d) utils/profiling
    on the fused block against phase 7's time ``ref["block"]``. Returns
    the launches of (c)."""
    import io
    import socket

    import torch.distributed as dist

    from grafp_tpu_torch.core import Config
    from grafp_tpu_torch.core.mesh import db_mesh_from_config, make_mesh, shard_rows
    from grafp_tpu_torch.models import build_model
    from grafp_tpu_torch.ops.grapher_block import grapher_block
    from grafp_tpu_torch.retrieval.evaluate import eval_faiss
    from grafp_tpu_torch.retrieval.search import (
        DB_BLOCK_ROWS,
        exact_topk,
        exact_topk_sharded,
        masked_scan_search,
        masked_scan_search_sharded,
    )
    from grafp_tpu_torch.train import create_train_state, make_train_step
    from grafp_tpu_torch.utils.profiling import IterTimer, scan_time_per_iter

    # a. the sharded search, SHARDS row shards on the one card
    t0 = time.perf_counter()
    mesh = make_mesh(n_data=1, n_db=SHARDS, devices=["cuda"] * SHARDS)
    full = np.concatenate([cat["dummy"], cat["db"]])
    n = len(full)
    q = torch.as_tensor(cat["qrows"][:MESH_QUERIES], device="cuda")
    chunks = [q[i:i + 1024] for i in range(0, len(q), 1024)]
    rows = torch.as_tensor(full, device="cuda")
    shards = shard_rows(rows, mesh)
    check(len(shards) == SHARDS and all(s.device.type == "cuda" for s in shards),
          "the shards are not on the card")

    def run(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = [fn(c) for c in chunks]
        torch.cuda.synchronize()
        t = time.perf_counter() - t
        return (torch.cat([o[0] for o in out]).cpu().numpy(),
                torch.cat([o[1] for o in out]).cpu().numpy(), len(q) / t)

    pq = cat["ivfpq"]
    decoded, _, cells = pq._payload()
    check(decoded.dtype == torch.bfloat16, "phase 8's ivfpq index holds no decoded cache")
    block = -(-n // SHARDS)
    row_shards = shard_rows(decoded, mesh, multiple=block)
    cell_shards = shard_rows(cells, mesh, multiple=block, fill=-1)
    searches = {
        "l2": (lambda c: exact_topk(c, rows, SEARCH_K),
               lambda c, sel: exact_topk_sharded(c, shards, SEARCH_K, m_valid=n,
                                                 scan_topk=sel, recall_target=0.99)),
        "ivfpq": (lambda c: masked_scan_search(
                      c, decoded, None, cells, pq._coarse_membership(c), n, SEARCH_K,
                      min(DB_BLOCK_ROWS, n)),
                  lambda c, sel: masked_scan_search_sharded(
                      c, row_shards, None, cell_shards, pq._coarse_membership(c), n,
                      SEARCH_K, block, sel, 0.99)),
    }
    for kind, (single, sharded) in searches.items():
        run(single)                                                   # warm-up
        run(lambda c: sharded(c, "exact"))
        want_d, want_i, qps_one = run(single)
        got_d, got_i, qps_exact = run(lambda c: sharded(c, "exact"))
        _, approx_i, qps_approx = run(lambda c: sharded(c, "approx"))
        agree, share = ids_agree(got_i, want_i, want_d)
        recall = recall_at(approx_i, want_i, SEARCH_K)
        print(f"sharded {kind}, {SHARDS} shards of {block} rows on one card, "
              f"{len(q)} queries k={SEARCH_K}: exact selection ids vs one card equal "
              f"outside the band {DIST_BAND:g}: {agree} (ranks compared {share:.3f}, max "
              f"|d| {np.abs(got_d - want_d).max():.3g}); approx local selection at 0.99 "
              f"recall@{SEARCH_K} {recall:.4f}; queries/s one card {qps_one:.1f}, "
              f"sharded exact {qps_exact:.1f}, sharded approx {qps_approx:.1f} [{card}]",
              flush=True)
        check(agree and share > 0.5, f"sharded {kind} ids differ from one card's")
        check(recall >= 0.99 - APPROX_SLACK, f"sharded {kind} approx recall {recall}")
    del rows, shards, row_shards, cell_shards, q, chunks
    torch.cuda.empty_cache()
    print(f"phase 13a took {time.perf_counter() - t0:.1f} s", flush=True)

    # b. C7: mesh_db 8 on one card
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        none = db_mesh_from_config(Config(mesh_db=8))
    notice = (f"[mesh] mesh_db=8 requested but only {torch.cuda.device_count()} "
              "device(s) visible; falling back to single-chip retrieval\n")
    print(f"C7: db_mesh_from_config(mesh_db=8) -> {none}; printed {out.getvalue()!r}")
    check(none is None and out.getvalue() == notice, "mesh_db=8: no notice or a mesh")
    fp_dir, hit9 = fp9
    hit = eval_faiss(fp_dir, test_ids="2000", index_type="l2", verbose=False, mesh=none)
    print("C7: eval_faiss with that mesh on phase 9's fingerprint dir: "
          + json.dumps(np.round(hit, 4).tolist()), flush=True)
    check(np.array_equal(hit, hit9), "C7: hit rates differ from phase 9's")

    # c. the data-parallel step on NCCL at world size 1
    t0 = time.perf_counter()
    cfg32, cfg16 = Config(), Config(compute_dtype="bfloat16")
    gw = torch.Generator(device="cuda").manual_seed(30)
    xs_i = torch.randn(PARITY_B, cfg32.clip_frames, device="cuda", generator=gw)
    xs_j = xs_i + 0.3 * torch.randn(PARITY_B, cfg32.clip_frames, device="cuda", generator=gw)
    plain = build_model(cfg32, generator=torch.Generator().manual_seed(31), train=True)
    ddp = copy.deepcopy(plain)
    m_plain = make_train_step(plain, cfg32)(create_train_state(plain, cfg32), xs_i, xs_j,
                                            torch.Generator(device="cuda").manual_seed(32))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", store=dist.TCPStore("localhost", port, 1, True),
                            rank=0, world_size=1)
    check(dist.get_backend() == "nccl", "the process group is not NCCL")
    m_ddp = make_train_step(ddp, cfg32)(create_train_state(ddp, cfg32), xs_i, xs_j,
                                        torch.Generator(device="cuda").manual_seed(32))
    lp, ld = m_plain["loss"].item(), m_ddp["loss"].item()
    gp, gd = m_plain["grad_norm"].item(), m_ddp["grad_norm"].item()
    print(f"train step f32 B={PARITY_B}, NCCL world size 1 vs no process group: loss "
          f"{ld:.7f} vs {lp:.7f} (rel {abs(ld - lp) / abs(lp):.2e}), grad norm {gd:.5f} vs "
          f"{gp:.5f} (rel {abs(gd - gp) / gp:.2e})", flush=True)
    check(abs(ld - lp) <= LOSS_RTOL * abs(lp), "the NCCL step's loss differs")
    check(abs(gd - gp) <= GNORM_RTOL * gp, "the NCCL step's grad norm differs")
    del plain, ddp
    tmodel = build_model(cfg16, generator=torch.Generator().manual_seed(5), train=True)
    state = create_train_state(tmodel, cfg16, steps_per_epoch=100)
    step = make_train_step(tmodel, cfg16, banks)
    gen = torch.Generator(device="cuda").manual_seed(7)
    n_graphers = sum(BLOCKS)
    launches = {"mrconv_concat": 0, "mrconv_concat_backward": 0}
    losses, secs = [], []
    for i in range(DDP_STEPS):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t = time.perf_counter()
        m = step(state, x_i, x_j, gen)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        got = counts()
        losses.append(m["loss"].item())
        for name in launches:
            launches[name] += got[name]
        print(f"train_ddp step {i}: loss {losses[-1]:.6f} (phase 5: {ref['losses'][i]:.6f}), "
              f"launches {got}", flush=True)
        check(got == {**{k: 0 for k in got}, "mrconv_concat": n_graphers,
                      "mrconv_concat_backward": n_graphers},
              f"expected {n_graphers} forward and backward launches per step")
        check(np.isfinite(losses[-1]) and abs(losses[-1] - ref["losses"][i])
              <= DDP_LOSS_RTOL * abs(ref["losses"][i]), "train_ddp loss off phase 5's")
    peak = torch.cuda.max_memory_allocated() / 1e9
    ms = 1e3 * sum(secs[1:]) / len(secs[1:])
    print(f"train_ddp bf16 bsz_train={x_i.shape[0]}, NCCL world size 1: {ms:.3f} ms a step "
          f"(host clock, steps 2-{DDP_STEPS}; phase 7's step without a process group "
          f"{ref['step_ms']:.3f} ms), peak memory {peak:.2f} GB (phase 5: "
          f"{ref['peak_gb']:.2f} GB) [{card}]", flush=True)
    dist.destroy_process_group()
    del tmodel, state, step
    torch.cuda.empty_cache()
    print(f"phase 13c took {time.perf_counter() - t0:.1f} s", flush=True)

    # d. utils/profiling on the fused block, against phase 7's CUDA events
    shape = max((r for r in ref["block"] if r["dtype"] == "bfloat16" and r["k"] == K),
                key=lambda r: r["ms"])
    c = shape["C"]
    x = torch.randn(B, shape["N"], c, generator=torch.Generator(device="cuda").manual_seed(33),
                    device="cuda").to(torch.bfloat16)
    ws = stage_weights(c, torch.bfloat16, seed=10 + c)
    body = lambda a: grapher_block(a, K, *ws)  # noqa: E731
    fit = scan_time_per_iter(body, x, iters_lo=5, iters_hi=25, reps=3)
    loop = IterTimer(body, x)
    loop_ms = 1e3 * loop.run(20) / 20
    fit_ms = 1e3 * fit["per_iter_s"]
    print(f"utils/profiling, grapher_block bf16 B={B} N={shape['N']} C={c}: "
          f"scan_time_per_iter {fit_ms:.4f} ms (fixed {1e3 * fit['fixed_overhead_s']:.4f} "
          f"ms), IterTimer {loop_ms:.4f} ms a call, phase 7's CUDA events "
          f"{shape['ms']:.4f} ms [{card}]", flush=True)
    for name, got_ms in (("scan_time_per_iter", fit_ms), ("IterTimer", loop_ms)):
        check(abs(got_ms - shape["ms"]) <= TIMER_RTOL * shape["ms"],
              f"{name} {got_ms:.4f} ms vs phase 7's {shape['ms']:.4f} ms")
    return launches


# --- phase 14: the configurations past the one-pass kernels ---------------
def wide_phase(waves, banks, x_i, x_j, zero_counts, counts, card: str) -> dict:
    """Phase 14 (see the module docstring): Config(k=9) and the grafp
    encoder on config/ast.yaml's frontend through the serving and train
    paths, with launch counts set to 0 just before each path and read just
    after. Returns {path: {kernel: launches}}."""
    from grafp_tpu_torch.core import Config, load_config
    from grafp_tpu_torch.dsp.melspec import LogMelConfig, log_mel_spectrogram
    from grafp_tpu_torch.fp import FingerprintPipeline
    from grafp_tpu_torch.models import build_model
    from grafp_tpu_torch.ops.grapher_block import grapher_block_supported
    from grafp_tpu_torch.train import create_train_state, make_train_step

    ast = load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)), "config",
                                   "ast.yaml"))
    ast["arch"] = "grafp"
    out = {}
    for tag, base, stages, k, bsz, steps in (
            ("k9", Config(k=K9), STAGES, K9, len(x_i), WIDE_TRAIN_STEPS),
            ("n3200", ast, AST_STAGES, K, WIDE_TRAIN_BSZ, 1)):
        cfg32, cfg16 = copy.deepcopy(base), copy.deepcopy(base)
        cfg32["compute_dtype"], cfg16["compute_dtype"] = "float32", "bfloat16"
        check((cfg16.n_mels // cfg16.peak_stride) * cfg16.n_frames == stages[0][0],
              f"{tag}: stage 1 is not {stages[0][0]} nodes")
        none = {name: 0 for name in counts()}
        # seeded weights made to behave like trained ones (phase 4's way),
        # and the reference: the unfolded f32 model through the plain versions
        model32 = build_model(cfg32, generator=torch.Generator().manual_seed(20),
                              fuse_serving="off")
        randomize(model32, torch.Generator().manual_seed(21))
        shared().calibrate(model32, clip_spec(cfg32, 256, seed=22))
        spec = log_mel_spectrogram(waves, LogMelConfig.from_config(cfg32))
        zero_counts()
        with plain_versions(), torch.no_grad():
            _, z32p = model32(spec)
        check(counts() == none, f"{tag}: the plain path launched a kernel")
        del spec
        torch.cuda.empty_cache()
        paths = [("f32", cfg32, "off", model32)]
        for fuse in ("auto", "off"):
            model16 = build_model(cfg16, fuse_serving=fuse)
            model16.load_state_dict(model32.state_dict())
            paths.append((f"bf16_{fuse}", cfg16, fuse, model16))
        for what, cfg, fuse, model in paths:
            dtype = torch.float32 if what == "f32" else torch.bfloat16
            fused = sum(nb for (n, c), nb in zip(stages, BLOCKS)
                        if fuse == "auto" and grapher_block_supported(n, c, dtype, k))
            pipe = FingerprintPipeline(model, cfg)
            zero_counts()
            z = pipe.fingerprint_waves(waves)
            torch.cuda.synchronize()
            got = counts()
            path = f"{tag}_serve" + {"bf16_auto": "", "bf16_off": "_off", "f32": "_f32"}[what]
            out[path] = got
            print(f"{tag} serving path {what}: launches {got}", flush=True)
            check(got == {**none, "grapher_block": fused, "mrconv_concat": sum(BLOCKS) - fused},
                  f"{tag} {what}: expected {fused} grapher_block and "
                  f"{sum(BLOCKS) - fused} mrconv_concat launches and no other")
            check(z.shape == (len(waves), cfg.d) and bool(torch.isfinite(z).all()),
                  f"{tag} {what}: z not finite or misshapen")
            if what == "f32":
                hold_rows(f"{tag} f32 kernel path (folded) vs f32 plain unfolded", z, z32p,
                          F32_COS)
            else:
                hold_rows(f"{tag} {what} kernel path (folded) vs f32 plain unfolded", z, z32p,
                          COS_MIN_FLOOR, COS_MEAN_FLOOR)
            ms = time_ms(lambda: pipe.fingerprint_waves(waves), reps=3, warmup=1)
            print(f"{tag} serving {what} B={len(waves)}: {ms:.3f} ms, "
                  f"{len(waves) / ms * 1e3:.1f} fp/s [{card}]", flush=True)
            del pipe, z
        del paths, model16, model32, z32p
        torch.cuda.empty_cache()

        tmodel = build_model(cfg16, generator=torch.Generator().manual_seed(23), train=True)
        state = create_train_state(tmodel, cfg16, steps_per_epoch=100)
        step = make_train_step(tmodel, cfg16, banks)
        gen = torch.Generator(device="cuda").manual_seed(24)
        xi, xj = x_i[:bsz], x_j[:bsz]
        losses, total = [], {name: 0 for name in none}
        torch.cuda.reset_peak_memory_stats()
        for i in range(steps):
            zero_counts()
            m = step(state, xi, xj, gen)
            torch.cuda.synchronize()
            got = counts()
            losses.append(m["loss"].item())
            print(f"{tag} train step {i} bsz_train={bsz}: loss {losses[-1]:.6f} grad norm "
                  f"{m['grad_norm'].item():.4f}, launches {got}", flush=True)
            check(got == {**none, "mrconv_concat": sum(BLOCKS),
                          "mrconv_concat_backward": sum(BLOCKS)},
                  f"{tag}: expected {sum(BLOCKS)} forward and backward launches per step")
            total = {name: total[name] + got[name] for name in total}
        peak = torch.cuda.max_memory_allocated() / 1e9
        out[f"{tag}_train"] = total
        check(all(np.isfinite(losses)), f"{tag}: a train loss is not finite")
        check(steps == 1 or losses[-1] < losses[0], f"{tag}: train losses do not fall")
        ms = time_ms(lambda: step(state, xi, xj, gen), reps=2, warmup=1)
        print(f"{tag} train step bf16 bsz_train={bsz} (2B={2 * bsz}): {ms:.3f} ms, "
              f"{bsz / ms * 1e3:.1f} samples/s; peak memory {peak:.2f} GB "
              f"(max_memory_allocated) [{card}]", flush=True)
        del tmodel, state, step
        torch.cuda.empty_cache()
        if tag == "k9":
            hold_train_step(cfg32, tag, 25, 26, counts)
            torch.cuda.empty_cache()
    return out


# --- phase 15: the captured serving forward --------------------------------
GRAPH_TRACK_S = 37.3           # the ragged track: 379 segments, a last batch of 123
GRAPH_DB_TRACKS = 32           # tracks of 20-40 s in the DB build's A/B


def graph_rows(what: str, got, want, floor, mean_floor=None) -> None:
    """The captured rows ``got`` against the eager ``want``: the count of
    rows not equal bit for bit and the largest |d| are printed; if any
    differ, all are held by ``hold_rows`` at the floors."""
    differ = (got != want).any(-1)
    n = int(differ.sum())
    print(f"{what}: {n} of {len(got)} rows differ from the eager forward, max |d| "
          f"{float((got - want).abs().max()):.3g}", flush=True)
    if n:
        hold_rows(what, got, want, floor, mean_floor)


def in_turns(eager, captured, reps: int) -> dict:
    """ms a call of ``eager`` and ``captured``, timed in turns (eager,
    captured, captured, eager): {"eager": [t, t], "captured": [t, t]}."""
    ms = {"eager": [], "captured": []}
    for turn in ("eager", "captured", "captured", "eager"):
        ms[turn].append(time_ms(eager if turn == "eager" else captured, reps=reps))
    return ms


def graph_phase(state_dict, zero_counts, counts, card: str) -> None:
    """Phase 15 (see the module docstring): each serving model of phase 4
    (fused bf16, unfused bf16, f32, int8_static) and the AST, captured
    against eager at B and 2B; a ragged track against the parent's eager
    embedding; a DB build with and without graphs. Every check raises."""
    from grafp_tpu_torch.core import Config, load_config
    from grafp_tpu_torch.dsp.melspec import LogMelConfig, log_mel_spectrogram
    from grafp_tpu_torch.fp import FingerprintPipeline
    from grafp_tpu_torch.fp.builder import _serve
    from grafp_tpu_torch.models import build_model

    ast_cfg = load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                       "config", "ast.yaml"))
    bf16 = (COS_MIN_FLOOR, COS_MEAN_FLOOR)
    variants = (("fused bf16", Config(compute_dtype="bfloat16"), "auto", bf16),
                ("unfused bf16", Config(compute_dtype="bfloat16"), "off", bf16),
                ("f32", Config(), "auto", (F32_COS, None)),
                ("int8_static bf16", Config(compute_dtype="bfloat16",
                                            serve_quant="int8_static"), "auto",
                 (QUANT_FLOOR, None)),
                ("AST bf16", ast_cfg, None, bf16))
    for name, cfg, fuse, floors in variants:
        if fuse is None:
            model = build_model(cfg, generator=torch.Generator().manual_seed(30))
            shared().calibrate_baseline(model, seed=31)
        else:
            model = build_model(cfg, fuse_serving=fuse)
            model.load_state_dict(state_dict)
        pipe = FingerprintPipeline(model, cfg)
        del model
        if pipe._needs_calibration:             # lazily, before the first capture
            pipe.fingerprint_waves(clip_waves(B, cfg.fs, seed=31))
            check(not pipe._needs_calibration, f"{name}: not calibrated")
        spec = log_mel_spectrogram(clip_waves(2 * B, cfg.fs, seed=50),
                                   LogMelConfig.from_config(cfg))
        for b in (B, 2 * B):
            x = spec[:b]
            new = (tuple(x.shape), x.dtype, x.device) not in pipe.graphs.entries
            zero_counts()
            zg = pipe.embed(x)
            torch.cuda.synchronize()
            got = counts()
            zero_counts()
            with torch.inference_mode():
                ze = _serve(pipe.model, x)
            torch.cuda.synchronize()
            check(got == counts(), f"{name} B={b}: captured launches {got}, eager {counts()}")
            check(zg.shape == (b, cfg.d) and bool(torch.isfinite(zg).all()),
                  f"{name} B={b}: captured z not finite or misshapen")
            graph_rows(f"{name} B={b} captured vs eager", zg, ze, *floors)
            entry = pipe.graphs.entries[(tuple(x.shape), x.dtype, x.device)]
            reps = 5 if name.startswith(("f32", "int8")) else 10

            def eager():
                with torch.inference_mode():
                    _serve(pipe.model, x)

            ms = in_turns(eager, lambda: pipe.embed(x), reps)
            print(f"graph {name} B={b}: launches {got}; eager {ms['eager'][0]:.3f}, "
                  f"{ms['eager'][1]:.3f} ms; captured {ms['captured'][0]:.3f}, "
                  f"{ms['captured'][1]:.3f} ms ({b / min(ms['captured']) * 1e3:.1f} fp/s); "
                  f"pool {entry.pool_bytes / 2**20:.1f} MiB, "
                  f"{'captured here' if new else 'captured earlier'} in "
                  f"{entry.capture_s:.3f} s (warm-up included) [{card}]", flush=True)
        if name == "fused bf16":
            # wave -> fingerprint (bench.py's path): the log-mel eager, the
            # model a replay, against the whole call eager
            waves = clip_waves(B, cfg.fs, seed=2)
            mcfg = LogMelConfig.from_config(cfg)

            def eager_waves():
                with torch.inference_mode():
                    _serve(pipe.model, log_mel_spectrogram(waves, mcfg))

            ms = in_turns(eager_waves, lambda: pipe.fingerprint_waves(waves), 10)
            print(f"graph fingerprint_waves fused bf16 B={B}: eager {ms['eager'][0]:.3f}, "
                  f"{ms['eager'][1]:.3f} ms; captured {ms['captured'][0]:.3f}, "
                  f"{ms['captured'][1]:.3f} ms = {B / min(ms['captured']) * 1e3:.1f} fp/s "
                  f"(eager {B / min(ms['eager']) * 1e3:.1f}) [{card}]", flush=True)
            graph_track_and_build(pipe, zero_counts, counts, card)
        print(f"graph {name}: {len(pipe.graphs.entries)} graphs, pools "
              f"{pipe.graphs.pool_bytes / 2**20:.1f} MiB [{card}]", flush=True)
        del pipe, spec
        torch.cuda.empty_cache()


def graph_track_and_build(pipe, zero_counts, counts, card: str) -> None:
    """Phase 15b: a GRAPH_TRACK_S track through fingerprint_track (full
    batches, replayed) against the parent's eager embedding of its
    segments (batch_size batches, the last one ragged); then
    create_dummy_db over GRAPH_DB_TRACKS tracks with graphs and eagerly
    (the same full batches), in turns: rows, launches and fp/s."""
    from grafp_tpu_torch.fp.builder import _serve, create_dummy_db
    from grafp_tpu_torch.retrieval.memmap_io import load_memmap_data

    wave = music_like_tracks(1, GRAPH_TRACK_S, GRAPH_TRACK_S, pipe.fs, seed=52)[0]
    zero_counts()
    zt = pipe.fingerprint_track(wave)
    torch.cuda.synchronize()
    got = counts()
    segs = torch.as_tensor(pipe.segments_for(wave), device="cuda")
    bs = pipe.batch_size
    zero_counts()
    with torch.inference_mode():
        want = torch.cat([_serve(pipe.model, segs[i:i + bs])
                          for i in range(0, len(segs), bs)]).cpu().numpy()
    torch.cuda.synchronize()
    check(got == counts(), f"track: launches {got}, the parent's eager path {counts()}")
    check(zt.shape == want.shape == (len(segs), pipe.d), f"track fingerprints {zt.shape}")
    full = len(segs) // bs * bs
    print(f"graph track {GRAPH_TRACK_S} s: {len(segs)} rows in {-(-len(segs) // bs)} "
          f"batches of {bs}; launches {got}; rows of the full batches "
          f"{'equal' if np.array_equal(zt[:full], want[:full]) else 'NOT equal'} bit for "
          f"bit", flush=True)
    graph_rows(f"graph track {GRAPH_TRACK_S} s (padded) vs the parent's eager path "
               "(ragged last batch)", torch.as_tensor(zt), torch.as_tensor(want),
               COS_MIN_FLOOR, COS_MEAN_FLOOR)

    tracks = music_like_tracks(GRAPH_DB_TRACKS, 20, 40, pipe.fs, seed=53)
    graphs = pipe.graphs
    rows, secs, launches = {}, {"eager": [], "captured": []}, {}
    with tempfile.TemporaryDirectory() as work:
        for turn in ("eager", "captured", "captured", "eager"):
            pipe.graphs = None if turn == "eager" else graphs
            zero_counts()
            t0 = time.perf_counter()
            n, _ = create_dummy_db(tracks, pipe, os.path.join(work, turn), verbose=False)
            torch.cuda.synchronize()
            secs[turn].append(time.perf_counter() - t0)
            launches[turn] = counts()
            rows[turn] = load_memmap_data(os.path.join(work, turn), "dummy_db",
                                          display=False)[0][:n].copy()
    pipe.graphs = graphs
    check(launches["eager"] == launches["captured"],
          f"DB build launches: eager {launches['eager']}, captured {launches['captured']}")
    n = len(rows["eager"])
    print(f"graph DB build: create_dummy_db over {GRAPH_DB_TRACKS} tracks of 20-40 s "
          f"(pack {pipe.build_pack}) -> {n} rows; launches {launches['captured']}; eager "
          f"{n / secs['eager'][0]:.1f}, {n / secs['eager'][1]:.1f} fp/s; captured "
          f"{n / secs['captured'][0]:.1f}, {n / secs['captured'][1]:.1f} fp/s [{card}]",
          flush=True)
    graph_rows("graph DB build captured vs eager", torch.as_tensor(rows["captured"]),
               torch.as_tensor(rows["eager"]), COS_MIN_FLOOR, COS_MEAN_FLOOR)


# --- phase 16: the protocol's scale ----------------------------------------
# 16a: scripts/fma_large_smoke.py's geometry, 30.6M dummy + 500k db and
# query rows (31.1M x 128 f32, 15.9 GB of memmaps)
FMA_DUMMY, FMA_QUERY = 30_600_000, 500_000
# 'l2' top-1 exact at length 1 against an exact float64 search on the card
# over the merged rows, for the same test ids: within this many points
FMA_EXACT_POINTS = 0.5
# two rows' float64 scores closer than this may rank either way in f32
# (unit rows: the f32 distances lay within 6.25e-7 of float64, phase 8)
SCORE_TIE = 2e-6
EXACT_CHUNK = 1 << 22          # rows per upload of the float64 search


def script_path(name: str) -> str:
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return path


@functools.lru_cache(maxsize=None)
def script(name: str):
    """scripts/<name>.py of this checkout, loaded by its path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, script_path(name))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def start_fma_data(root: str):
    """The port's fma_large driver writing its memmaps under ``root``
    (--data-only, one numpy thread) while the earlier phases run: (the
    process, its log's path)."""
    log_path = os.path.join(root, "data.log")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, script_path("torch_port_fma_large_smoke"), "--data-only",
             "--dummy", str(FMA_DUMMY), "--nq", str(FMA_QUERY), "--root", root],
            stdout=log, stderr=subprocess.STDOUT)
    return proc, log_path


def fma_rows(path: str, name: str) -> np.ndarray:
    shape = tuple(np.load(os.path.join(path, f"{name}_shape.npy")))
    return np.memmap(os.path.join(path, f"{name}.mm"), np.float32, mode="r", shape=shape)


def exact_search(path: str, q: np.ndarray):
    """The exact float64 inner-product top-1 of query rows ``q`` on the card
    over dummy_db ++ db (unit rows: the L2 order): (ids, scores)."""
    qd = torch.as_tensor(q, device="cuda").double()
    best = torch.full((len(q),), -float("inf"), dtype=torch.float64, device="cuda")
    arg = torch.zeros(len(q), dtype=torch.int64, device="cuda")
    offset = 0
    for name in ("dummy_db", "db"):
        mm = fma_rows(path, name)
        for s in range(0, len(mm), EXACT_CHUNK):
            x = torch.from_numpy(np.array(mm[s:s + EXACT_CHUNK])).to("cuda").double()
            v, i = (qd @ x.T).max(1)
            take = v > best
            best = torch.where(take, v, best)
            arg = torch.where(take, i + offset + s, arg)
        offset += len(mm)
    return arg.cpu().numpy(), best.cpu().numpy()


def fma_phase(data, root: str, zero_counts, counts, card: str) -> None:
    """Phase 16a (see the module docstring). Every check raises."""
    from grafp_tpu_torch.retrieval.evaluate import ConcatRows, eval_faiss

    proc, log_path = data
    t0 = time.perf_counter()
    rc = proc.wait()
    with open(log_path) as f:
        for line in f.read().splitlines()[-3:]:
            print(f"fma_large data: {line}")
    print(f"fma_large data: waited {time.perf_counter() - t0:.1f} s for the writer")
    check(rc == 0, f"the fma_large data writer exited with {rc}")
    fma = script("torch_port_fma_large_smoke")
    path = fma.data_dir(root, FMA_DUMMY, FMA_QUERY)
    torch.cuda.empty_cache()
    zero_counts()
    out = fma.run(path, device="cuda")          # raises if the tiers differ
    torch.cuda.synchronize()
    got = counts()
    print(f"fma_large eval: launches {got}")
    check(all(n == 0 for n in got.values()), "the evaluation path launched a kernel")
    check(out["auto"]["rescore"] == "device" and out["host"]["rescore"] == "host",
          "rescore='auto' did not hold the merged DB on the card")
    hr = out["auto"]["hit_rates"]
    check(hr.shape == (4, 3) and bool(np.isfinite(hr).all())
          and bool(((hr >= 0) & (hr <= 100)).all())
          and bool((hr[3] >= hr[2]).all() and (hr[2] >= hr[0]).all()),
          f"fma_large hit rates {hr}")
    for tier in ("auto", "host"):
        r = out[tier]
        print(f"fma_large {FMA_DUMMY + FMA_QUERY:,} rows, ivfpq, rescore={tier} "
              f"({r['rescore']}): load {r['load_s']:.2f} s, train {r['train_s']:.2f} s, "
              f"add {r['add_s']:.2f} s, search {r['search_s']:.2f} s (9,500 query rows, "
              f"k=20), rescoring {r['rescore_s']:.2f} s, total {r['total_s']:.2f} s; "
              f"peak RSS {r['peak_rss_gb']:.2f} GB, card peak {r['card_peak_gb']:.2f} GB "
              f"(max_memory_allocated) [{card}]", flush=True)

    # the exact float64 search over the merged rows for the test ids' first
    # query rows (length 1), against which the searches are held
    tids = np.load(os.path.join(path, "test_ids.npy"))
    q = np.asarray(fma_rows(path, "query")[tids])
    gt = tids + FMA_DUMMY
    t0 = time.perf_counter()
    exact, exact_s = exact_search(path, q)
    merged = ConcatRows(fma_rows(path, "dummy_db"), fma_rows(path, "db"))

    def score(ids):                         # float64 q . row, ids (n, m)
        rows = merged.gather(ids.reshape(-1)).reshape(*ids.shape, -1)
        return np.einsum("nmd,nd->nm", rows.astype(np.float64), q.astype(np.float64))

    exact_hit = 100.0 * float((exact == gt).mean())
    print(f"fma_large exact float64 search on the card: top-1 exact at length 1 "
          f"{exact_hit:.2f} % ({len(tids)} test ids, {time.perf_counter() - t0:.1f} s)")
    # ivfpq: the index's 20 candidates for each row against a float64
    # recomputation from the raw rows and the index's centroids and
    # codebooks alone: each in a probed cell at its decoded distance, and
    # the exact top-1 among them wherever its cell is probed and its
    # decoded distance beats the 20th candidate's
    pick = out["auto"]["top_ids"][:, 0, 0]
    index = out.pop("index")
    t0 = time.perf_counter()
    dist, cand = index.search(q, 20)
    faults, held = shared().ivfpq_candidate_faults(
        q, dist, cand, exact, merged.gather, index.centroids.cpu().numpy(),
        index.pq.codebooks.cpu().numpy(), index.nprobe)
    print(f"fma_large ivfpq candidates against the float64 recomputation: faults "
          f"{faults}; the exact top-1 held to them for {held} of {len(tids)} test ids "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(not any(faults.values()) and held > 0,
          f"the ivfpq search disagrees with its recomputation: {faults}, {held} held")
    del out, index
    torch.cuda.empty_cache()
    # the eval's pick at length 1 is the best of those candidates (the
    # rescoring), and wherever it is not the exact top-1, the exact top-1
    # was not among them (the index's recall, not a fault)
    s_pick = score(pick[:, None])[:, 0]
    s_cand = np.where(cand >= 0, score(np.maximum(cand, 0)), -np.inf)
    check(bool((pick[:, None] == cand).any(1).all())
          and bool((s_pick >= s_cand.max(1) - SCORE_TIE).all()),
          "an ivfpq pick at length 1 is not the best of its candidates")
    miss = pick != exact
    outside = ~(cand == exact[:, None]).any(1)
    tie = np.abs(s_pick - exact_s) <= SCORE_TIE
    print(f"fma_large ivfpq at length 1: top-1 exact {hr[0, 0]:.2f} %; the pick differs "
          f"from the exact top-1 for {int(miss.sum())} of {len(tids)} test ids, whose "
          f"exact top-1 lay outside the index's 20 candidates for "
          f"{int((miss & outside).sum())} (near ties {int((miss & tie).sum())})",
          flush=True)
    check(bool((~miss | outside | tie).all()),
          "the exact top-1 was among the index's candidates but not picked")

    # 'l2' at full size (the JAX smoke runs only 'ivfpq'): exact search
    torch.cuda.reset_peak_memory_stats()
    stats, t0 = {}, time.perf_counter()
    hr_l2 = eval_faiss(path, index_type="l2", test_ids="500", test_seq_len="1 11 19",
                       k_probe=20, verbose=False, device="cuda", stats=stats)
    secs = time.perf_counter() - t0
    pick = stats.pop("top_ids")[:, 0, 0]
    del stats["index"]
    torch.cuda.empty_cache()
    s_pick = score(pick[:, None])[:, 0]
    differ = pick != exact
    print(f"fma_large {FMA_DUMMY + FMA_QUERY:,} rows, l2, rescore=auto "
          f"({stats['rescore']}): add {stats['add_s']:.2f} s, search {stats['search_s']:.2f} "
          f"s, rescoring {stats['rescore_s']:.2f} s, total {secs:.2f} s; card peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; top-1 exact {hr_l2[0]}, "
          f"top-3 {hr_l2[2]}; at length 1 the pick differs from the exact top-1 for "
          f"{int(differ.sum())} test ids (near ties "
          f"{int((differ & (np.abs(s_pick - exact_s) <= SCORE_TIE)).sum())}) [{card}]",
          flush=True)
    check(bool((~differ | (np.abs(s_pick - exact_s) <= SCORE_TIE)).all()),
          "an 'l2' pick at length 1 is not the exact top-1")
    check(abs(hr_l2[0, 0] - exact_hit) <= FMA_EXACT_POINTS,
          f"'l2' top-1 exact at length 1 is {hr_l2[0, 0]}, the exact search's {exact_hit}")


def e2e_phase(work: str, zero_counts, counts, card: str) -> dict:
    """Phase 16b (see the module docstring): the port's e2e driver at the JAX
    script's defaults; returns its launches by path. Every check raises."""
    e2e = script("torch_port_e2e_synthetic_icassp")
    zero_counts()
    t0 = time.perf_counter()
    out = e2e.run(os.path.join(work, "e2e"), device="cuda")
    secs = time.perf_counter() - t0
    n_graphers, steps, batches = sum(BLOCKS), out["steps"], out["embed_batches"]
    got = {path: {**{name: 0 for name in counts()}, **out["launches"][path]}
           for path in ("e2e_train", "e2e_build")}
    rest = {name: n for name, n in counts().items()
            if name not in out["launches"]["e2e_build"]}
    print(f"e2e: {steps} steps, {batches} embed batches in the three builds; launches "
          f"{got}, others {rest}")
    check(all(n == 0 for n in rest.values()), "the e2e run launched an op-path kernel")
    check(got["e2e_train"] == {**{name: 0 for name in counts()},
                               "mrconv_concat": n_graphers * steps,
                               "mrconv_concat_backward": n_graphers * steps},
          f"expected {n_graphers} forward and backward launches per step")
    check(got["e2e_build"] == {**{name: 0 for name in counts()},
                               "grapher_block": n_graphers * batches},
          f"expected {n_graphers} grapher_block launches per embed batch")
    losses = out["epoch_loss"]
    check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
          f"the e2e loss does not fall: {losses}")
    tables = [out["baseline"]] + [hr for snr in out["hit_rates"].values()
                                  for hr in snr.values()]
    check(all(t.shape == (4, 5) and bool(np.isfinite(t).all())
              and bool(((t >= 0) & (t <= 100)).all()) for t in tables),
          "an e2e hit-rate table is misshapen or out of range")
    fps = {snr: rows / s for snr, (s, rows) in out["build"].items()}
    print(f"e2e at the JAX script's defaults: {secs:.1f} s; epoch losses "
          f"{[round(x, 4) for x in losses]}; epoch seconds "
          f"{[round(x, 2) for x in out['epoch_s']]}; DB builds "
          + ", ".join(f"SNR {snr} {fp:.0f} fp/s" for snr, fp in fps.items())
          + f" [{card}]", flush=True)
    return got

# --- phase 17: the protocol rehearsals through the CLIs ---------------------
# 17a's workspace: train tracks, eval tracks (more than the r5 sweep's
# --n_query_db 400), seconds each (r5: 20); the sweep's epochs (bsz_train
# 128: one step an epoch)
REHEARSAL_TRACKS = (128, 440, 10.0)
REHEARSAL_EPOCHS = 2
SIGNOFF_QUERIES = 40           # 17b's --n_query_db (the sign-off's default: 200)


def start_rehearsal_data(root: str):
    """The port's setup script writing 17a's workspace under ROOT/ws while
    the earlier phases run: (the process, its log's path)."""
    train, evals, dur = REHEARSAL_TRACKS
    log_path = os.path.join(root, "setup.log")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, script_path("torch_port_setup_synth_icassp"),
             "--root", os.path.join(root, "ws"), "--train_tracks", str(train),
             "--eval_tracks", str(evals), "--dur", str(dur)],
            stdout=log, stderr=subprocess.STDOUT)
    return proc, log_path


def row_cosines(got: np.ndarray, ref: np.ndarray):
    """Each row of ``got``'s cosine to the same row of ``ref``, and its
    largest cosine to any other row of ``ref`` (float64)."""
    g = got / np.linalg.norm(got, axis=1, keepdims=True).astype(np.float64)
    r = ref / np.linalg.norm(ref, axis=1, keepdims=True).astype(np.float64)
    c = g @ r.T
    own = np.diag(c).copy()
    np.fill_diagonal(c, -2.0)
    return own, c.max(1)


def kernel_counts(**n) -> dict:
    """Every kernel wrapper's name with ``n``'s launches, 0 elsewhere."""
    return {**{name: 0 for name in ("mrconv_concat", "mrconv_concat_backward",
                                    "max_neighbors", "max_neighbors_backward",
                                    "grapher_block")}, **n}


def rehearsal_phase(data, root: str, zero_counts, counts, card: str) -> dict:
    """Phase 17 (see the module docstring); returns its launches by path.
    Every check raises."""
    n_graphers = sum(BLOCKS)
    proc, log_path = data
    t0 = time.perf_counter()
    rc = proc.wait()
    with open(log_path) as f:
        tail = f.read().splitlines()[-3:]
    print(f"17a workspace (rc {rc}; waited {time.perf_counter() - t0:.1f} s): "
          + " | ".join(tail), flush=True)
    check(rc == 0, "the rehearsal workspace's setup failed")
    ws = os.path.join(root, "ws")
    sweep_log = os.path.join(ws, "r5.log")
    env = {**os.environ, "PYTHON": f"{sys.executable} {script_path('torch_port_cli_probe')}"}
    t0 = time.perf_counter()
    with open(sweep_log, "w") as log:
        rc = subprocess.run(
            ["bash", os.path.join(os.path.dirname(script_path("torch_port_cli_probe")),
                                  "torch_port_e2e_cli_icassp_r5.sh"), ws,
             str(REHEARSAL_EPOCHS)], cwd=ws, env=env, stdout=log,
            stderr=subprocess.STDOUT, timeout=1200).returncode
    secs = time.perf_counter() - t0
    with open(sweep_log) as f:
        lines = f.read().splitlines()
    if rc != 0:
        print("\n".join(lines[-40:]), flush=True)
    check(rc == 0, f"torch_port_e2e_cli_icassp_r5.sh exited {rc}")
    probes = [json.loads(x[len("[probe] "):]) for x in lines if x.startswith("[probe] ")]
    check([p["module"] for p in probes] == ["grafp_tpu_torch.cli.train"]
          + ["grafp_tpu_torch.cli.test_fp"] * 6,
          f"the sweep ran {[p['module'] for p in probes]}")
    train, rows = probes[0], probes[1:]
    steps = train["train_steps"]
    check(steps == REHEARSAL_EPOCHS * (REHEARSAL_TRACKS[0] // 128),
          f"the sweep's training ran {steps} steps")
    check(train["launches"] == kernel_counts(
        mrconv_concat=n_graphers * steps, mrconv_concat_backward=n_graphers * steps,
        grapher_block=n_graphers * train["embed_batches"]),
        f"r5 train launches {train['launches']} for {steps} steps and "
        f"{train['embed_batches']} embed batches")
    for p in rows:
        check(p["embed_batches"] > 0 and p["launches"] == kernel_counts(
            grapher_block=n_graphers * p["embed_batches"]),
            f"a test_fp row launched {p['launches']} for {p['embed_batches']} batches")
    run = os.path.join(ws, "run")
    check(os.path.isfile(os.path.join(run, "checkpoint", "model_tc29r5_best.pth")),
          "the sweep wrote no checkpoint")
    store = os.path.join(run, "logs", "store", "medium", "model_tc29r5_best")
    tables = [np.load(os.path.join(d, "hit_rates.npy"))
              for d, _, files in os.walk(store) if "hit_rates.npy" in files]
    check(len(tables) == 6 and all(
        t.shape == (4, 6) and bool(np.isfinite(t).all()) and bool(((t >= 0) & (t <= 100)).all())
        for t in tables), "the sweep's hit-rate tables are not six finite (4, 6) in [0, 100]")
    print(f"17a r5 sweep ({REHEARSAL_EPOCHS} epochs, {REHEARSAL_TRACKS[0]} + "
          f"{REHEARSAL_TRACKS[1]} tracks of {REHEARSAL_TRACKS[2]:g} s): {secs:.1f} s; "
          f"train CLI {train['seconds']:.1f} s ({steps} steps, "
          f"{train['embed_batches']} embed batches, host peak {train['host_peak_gb']:.2f} GB, "
          f"card peak {train.get('card_peak_gb')}) [{card}]", flush=True)
    for i, p in enumerate(rows):
        st = p["stages"]
        print(f"17a test_fp row {i}: {p['seconds']:.1f} s (dummy "
              f"{st.get('create_dummy_db', 0):.1f}, fp {st.get('create_fp_db', 0):.1f}, "
              f"eval {st.get('eval_faiss', 0):.1f}); {p['embed_batches']} embed batches; "
              f"host peak {p['host_peak_gb']:.2f} GB, card peak {p.get('card_peak_gb')}",
              flush=True)
    for line in lines:
        if line.startswith("Top-1 exact hit rate"):
            print(f"17a {line}")
    out = {"r5_train": train["launches"],
           "r5_test_fp": {name: sum(p["launches"][name] for p in rows)
                          for name in train["launches"]}}

    # 17b: the int8_static sign-off on 17a's checkpoint
    t0 = time.perf_counter()
    zero_counts()
    so = script("torch_port_e2e_int8_retrieval_signoff").run(
        ws, n_query_db=SIGNOFF_QUERIES, device="cuda")
    eb = so["embed_batches"]
    check(so["launches"]["bf16"] == kernel_counts(grapher_block=n_graphers * eb["bf16"]),
          f"sign-off bf16 launches {so['launches']['bf16']} for {eb['bf16']} batches")
    # int8_static: one more forward, the lazy calibration's (unfolded, eager)
    check(so["launches"]["int8_static"] == kernel_counts(
        mrconv_concat=n_graphers * (eb["int8_static"] + 1)),
        f"sign-off int8_static launches {so['launches']['int8_static']} for "
        f"{eb['int8_static']} batches")
    # the rows are measured, not held to a floor: after two steps the model
    # is its seeded initialisation, whose rows of any two inputs lie within
    # cos 0.99999; and after 116 steps (512 tracks, 29 epochs; on an H100)
    # the first rows of 400 tracks lay at min cos 0.961 (mean 0.985) in
    # bf16 from the same checkpoint's f32 rows, and its
    # int8_static rows at 0.819 (0.954) from the bf16 rows, 0.786 (0.946)
    # with maxima from 256 tracks instead of one: near-tie k-NN selections
    # of a briefly trained model, not the lazy calibration
    z = {q: np.array(fma_rows(so["dummy_dirs"][q], "dummy_db"))
         for q in ("bf16", "int8_static")}
    n_dummy = REHEARSAL_TRACKS[1] - SIGNOFF_QUERIES
    check(len(z["bf16"]) == len(z["int8_static"]) and len(z["bf16"]) % n_dummy == 0
          and all(bool(np.isfinite(v).all()) for v in z.values()),
          f"the dummy DBs hold {len(z['bf16'])} and {len(z['int8_static'])} rows for "
          f"{n_dummy} tracks of equal length, or a row that is not finite")
    per_track = len(z["bf16"]) // n_dummy
    own, other = row_cosines(z["int8_static"][::per_track], z["bf16"][::per_track])
    print(f"17b int8_static vs bf16 dummy rows, the first of each of {n_dummy} tracks: cos "
          f"to the own row min {own.min():.5f} mean {own.mean():.5f}; largest cosine "
          f"between two different rows {other.max():.5f}; nearest its own row "
          f"{int((own > other).sum())} of {n_dummy}", flush=True)
    summary = so["summary"]
    check(summary["signoff"] == "int8_static_vs_bf16" and np.isfinite(summary["worst_delta_pp"])
          and sorted(summary["per_snr"]) == ["0", "10", "5"],
          f"the sign-off's line: {summary}")
    check(all(bool(((hr >= 0) & (hr <= 100)).all()) for hr in so["hit_rates"].values()),
          "a sign-off hit-rate table lies outside [0, 100]")
    print(f"17b sign-off ({SIGNOFF_QUERIES} query tracks): {time.perf_counter() - t0:.1f} s; "
          f"builds (s) {({f'{q}/{k}': round(v, 2) for (q, k), v in so['build_s'].items()})}; "
          f"worst delta {summary['worst_delta_pp']:.2f} pp [{card}]", flush=True)
    out.update({f"signoff_{q}": so["launches"][q] for q in ("bf16", "int8_static")})
    return out

# --- phase 18: the bf16-vs-f32 training study and the smoke tools ---------
# 18a: scripts/bf16_train_study.py's defaults (steps, pairs, held-out rows)
STUDY_STEPS, STUDY_PAIRS, STUDY_EVAL = 60, 64, 32
C10_CLIPS = 128                # music-like clips served by 18a's f32-trained model
SMOKE_TRACKS = 4               # 18b's dummy_db: tracks of 4-8 s


def study_phase(zero_counts, counts, card: str, work: str) -> dict:
    """Phase 18 (see the module docstring); returns its launches by path.
    Every check raises."""
    from grafp_tpu_torch.core import Config
    from grafp_tpu_torch.fp import FingerprintPipeline
    from grafp_tpu_torch.fp.builder import create_dummy_db
    from grafp_tpu_torch.models import build_model
    from grafp_tpu_torch.ops.grapher_block import grapher_block_supported
    from grafp_tpu_torch.train.checkpoint import save_ckp, train_payload

    st = script("torch_port_bf16_train_study")
    cfg = Config()
    n_graphers = sum(BLOCKS)
    banks, x_i, x_j, x_eval = st.study_data(STUDY_PAIRS, STUDY_EVAL, cfg.clip_frames)
    init = st.initial_state_dict(cfg)
    print(f"device={card} steps={STUDY_STEPS}", flush=True)
    out, runs = {}, {}
    for dtype, tag in (("float32", "f32 "), ("bfloat16", "bf16")):
        path = f"study_{tag.strip()}"
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        step_s = []
        state, losses, secs = st.train(dtype, STUDY_STEPS, banks, x_i, x_j, cfg, init, "cuda",
                                       step_seconds=step_s)
        z = st.fingerprints(state.model, cfg, x_eval)
        out[path] = counts()
        runs[dtype] = (state, losses, z)
        print(st.run_line(tag, losses, secs), flush=True)
        rest = np.array(step_s[1:]) * 1e3
        print(f"18a {path}: {secs / STUDY_STEPS * 1e3:.1f} ms a step over {STUDY_STEPS} steps "
              f"of {STUDY_PAIRS} pairs (host clock, synchronised each step); the first "
              f"{step_s[0] * 1e3:.1f} ms, the rest median {np.median(rest):.1f} "
              f"(min {rest.min():.1f}, max {rest.max():.1f}); peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{card}]", flush=True)
        check(bool(np.isfinite(losses).all()) and bool(np.isfinite(z).all()),
              f"18a {path}: a loss or fingerprint is not finite")
        check(losses[-10:].mean() < losses[0],
              f"18a {path}: the last ten steps' mean loss {losses[-10:].mean():.4f} is not "
              f"below the first {losses[0]:.4f}")
        # the eval forward fuses every stage the guard admits (the f32 guard
        # refuses stage 1); every train step runs each Grapher's kernels
        tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        fused = sum(nb for (n, c), nb in zip(STAGES, BLOCKS)
                    if grapher_block_supported(n, c, tdt, K))
        expect(out[path], {"mrconv_concat": n_graphers * STUDY_STEPS + n_graphers - fused,
                           "mrconv_concat_backward": n_graphers * STUDY_STEPS,
                           "grapher_block": fused}, f"18a {path}")
    (s32, l32, z32), (_, l16, z16) = runs["float32"], runs["bfloat16"]
    for line in st.summary_lines(l32, z32, l16, z16):
        print(line, flush=True)
    # the yardstick of the gap: the f32 run again, from the same init on
    # the same data, against the first
    again, l32b, _ = st.train("float32", STUDY_STEPS, banks, x_i, x_j, cfg, init, "cuda")
    z32b = st.fingerprints(again.model, cfg, x_eval)
    rel = np.abs(l32b - l32) / np.maximum(np.abs(l32), 1e-6)
    cos = st.row_cosines(z32b, z32)
    print(f"18a f32 run again: losses bit-equal {bool(np.array_equal(l32b, l32))}, "
          f"first unequal step {int(np.argmax(l32b != l32)) if (l32b != l32).any() else None}; "
          f"loss |rel diff| mean {rel.mean():.4f} max {rel.max():.4f} final {rel[-1]:.4f}; "
          f"trained-fingerprint cosine min {cos.min():.4f} mean {cos.mean():.4f}", flush=True)

    # C10 on the card: the f32-trained model served in f32, bf16 and
    # int8_static (maxima calibrated lazily on the first batch), rows of
    # music-like clips, measured with no floor (a train-mode step is
    # chaotic at near ties, PERF.md section 7)
    trained = {k: v.detach().clone() for k, v in s32.model.state_dict().items()}
    waves = clip_waves(C10_CLIPS, cfg["fs"], seed=18)
    rows = {}
    for name, fields in (("f32", {}), ("bf16", {"compute_dtype": "bfloat16"}),
                         ("int8_static", {"compute_dtype": "bfloat16",
                                          "serve_quant": "int8_static"})):
        scfg = Config(**fields)
        model = build_model(scfg)
        model.load_state_dict(trained)
        rows[name] = FingerprintPipeline(model, scfg).fingerprint_waves(waves).cpu().numpy()
        check(bool(np.isfinite(rows[name]).all()), f"18a C10: {name} rows not finite")
    for a, b in (("bf16", "f32"), ("int8_static", "bf16")):
        own, other = row_cosines(rows[a], rows[b])
        print(f"18a C10, the f32-trained model's {a} serving rows against its {b} rows "
              f"({C10_CLIPS} music-like clips): cos min {own.min():.5f} mean "
              f"{own.mean():.5f}; largest cosine between two different rows "
              f"{other.max():.5f}; nearest their own row {int((own > other).sum())} of "
              f"{C10_CLIPS}", flush=True)

    # 18b: the reference-contract smoke tools as processes on the card
    t0 = time.perf_counter()
    db = os.path.join(work, "emb", "study")
    pipe = FingerprintPipeline(s32.model, cfg)
    n_rows, _ = create_dummy_db(music_like_tracks(SMOKE_TRACKS, 4.0, 8.0, cfg["fs"], seed=19),
                                pipe, db, verbose=False)
    ckp = save_ckp(train_payload(s32, 1, [float(l32.mean())], []), "study", work, "f32")
    root = os.path.dirname(os.path.abspath(__file__))
    for name, argv, want in (
            ("db_test", ["--emb_dir", os.path.join(work, "emb")],
             f"{db}: dummy_db shape {(np.int64(n_rows), np.int64(cfg['d']))}"),
            ("model_test", ["--ckp", ckp],
             f"OK: checkpoint loads and runs; h=(1, {cfg['h']}) z=(1, {cfg['d']})")):
        proc = subprocess.run([sys.executable, script_path(f"torch_port_{name}"), *argv],
                              cwd=root, capture_output=True, text=True, timeout=300)
        print(f"18b torch_port_{name}.py (rc {proc.returncode}): {proc.stdout.strip()}",
              flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], flush=True)
        check(proc.returncode == 0 and proc.stdout.splitlines() == [want],
              f"18b torch_port_{name}.py printed {proc.stdout!r}, expected {want!r}")
    print(f"18b took {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    # phase 16a's memmaps and phase 17a's workspace are written while
    # phases 2-15 run
    fma_root = tempfile.mkdtemp(prefix="fma_large_")
    rh_root = tempfile.mkdtemp(prefix="rehearsals_")
    fma_data = start_fma_data(fma_root)
    rh_data = start_rehearsal_data(rh_root)
    try:
        return phases(fma_data, fma_root, rh_data, rh_root)
    finally:
        for proc, _ in (fma_data, rh_data):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(fma_root, ignore_errors=True)
        shutil.rmtree(rh_root, ignore_errors=True)


def phases(fma_data, fma_root: str, rh_data, rh_root: str) -> int:
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
    # past the one-pass kernels: round groups of 3 and bitmap windows
    for dtype in (torch.float32, torch.bfloat16):
        for b, n, c, k in WIDE_SHAPES:
            for kind, x in kernel_inputs(n, c, dtype, g, b=b).items():
                label = f"{str(dtype)[6:]} B={b} N={n} C={c} k={k} {kind}"
                gy = torch.randn(b, n, 2 * c, generator=g, device="cuda").to(dtype)
                note(hold_mrconv(x, gy, label, k))
                note(hold_max_neighbors(x, gy[..., :c].contiguous(), label, k))
            torch.cuda.empty_cache()
        for n, c in STAGES:
            label = f"{str(dtype)[6:]} B={WIDE_B} N={n} C={c} k={K9}"
            if not grapher_block_supported(n, c, dtype, K9):
                print(f"grapher_block {label}: refused by the guard")
                continue
            ws = stage_weights(c, dtype, seed=10 + c)
            for kind, x in kernel_inputs(n, c, dtype, g, b=WIDE_B).items():
                note({"grapher_block": hold_grapher_block(x, ws, f"{label} {kind}", K9)})
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
        # the folded model itself: pipe32 replays a graph of the kernels
        _, z32f = pipe32.model(spec)
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
    phase5_losses = list(losses)

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
    hold_train_step(cfg32, "size t", 8, 40, counts)
    del served
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

    def record(name, nb, dtype, b, n, c, t_k, t_p, bounds, add=True, k=K):
        t_by, t_op = bounds
        per_shape[name].append({"dtype": str(dtype)[6:], "B": b, "N": n, "C": c, "k": k,
                                "ms": t_k, "plain_ms": t_p,
                                "bound_ms": max(t_by, t_op)})
        print(f"time {name} {str(dtype)[6:]} B={b} N={n} C={c} k={k}: kernel {t_k:.4f} ms, "
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
    # each kernel at the shapes of phase 14's paths (bf16), held to its plain
    # version there, then timed apart from the main paths' sums: on every
    # stage #3 (and #5 where its guard admits the stage) at the serving
    # batch and #4 at the train step's 2B; #1 and #2 at stage 1's 2B
    bf16 = torch.bfloat16
    for tag, stages, k, bt in (("k9", STAGES, K9, 2 * bsz),
                               ("n3200", AST_STAGES, K, 2 * WIDE_TRAIN_BSZ)):
        for n, c in stages:
            x = torch.randn(B, n, c, generator=g, device="cuda").to(bf16)
            label = f"bfloat16 B={B} N={n} C={c} k={k} random ({tag} serving)"
            note(hold_mrconv(x, None, label, k))
            t_k = time_ms(lambda: mrconv_concat(x, k), reps=10)
            t_p = time_ms(lambda: mrconv_concat_reference(x, k), reps=2, warmup=1)
            record("mrconv_concat", 0, bf16, B, n, c, t_k, t_p,
                   bound_ms(B, n, c, bf16, False, k), add=False, k=k)
            if grapher_block_supported(n, c, bf16, k):
                ws = stage_weights(c, bf16, seed=10 + c)
                note({"grapher_block": hold_grapher_block(x, ws, label, k)})
                t_k = time_ms(lambda: grapher_block(x, k, *ws), reps=10)
                t_p = time_ms(lambda: grapher_block_reference(x, k, *ws), reps=2, warmup=1)
                record("grapher_block", 0, bf16, B, n, c, t_k, t_p,
                       block_bound_ms(B, n, c, bf16, k), add=False, k=k)
                del ws
            del x
            torch.cuda.empty_cache()
            x = torch.randn(bt, n, c, generator=g, device="cuda").to(bf16)
            gy = torch.randn(bt, n, 2 * c, generator=g, device="cuda").to(bf16)
            label = f"bfloat16 B={bt} N={n} C={c} k={k} random ({tag} train)"
            note(hold_mrconv(x, gy, label, k, forward=False))
            torch.cuda.empty_cache()
            t_k = time_ms(lambda: mrconv_concat_backward(x, gy, k), reps=5)
            t_p = time_ms(lambda: mrconv_concat_backward_reference(x, gy, k), reps=1,
                          warmup=1)
            record("mrconv_concat_backward", 0, bf16, bt, n, c, t_k, t_p,
                   bound_ms(bt, n, c, bf16, True, k), add=False, k=k)
            if n == stages[0][0]:
                gy = gy[..., :c].contiguous()
                note(hold_max_neighbors(x, gy, label, k))
                for name, run, ref, bwd in (
                        ("max_neighbors", lambda: max_neighbors(x, k),
                         lambda: max_neighbors_reference(x, k), False),
                        ("max_neighbors_backward", lambda: max_neighbors_backward(x, gy, k),
                         lambda: max_neighbors_backward_reference(x, gy, k), True)):
                    torch.cuda.empty_cache()
                    t_k = time_ms(run, reps=5)
                    t_p = time_ms(ref, reps=1, warmup=1)
                    record(name, 0, bf16, bt, n, c, t_k, t_p, bound_ms(bt, n, c, bf16, bwd, k),
                           add=False, k=k)
            del x, gy
            torch.cuda.empty_cache()

    # 8. the evaluation path; its memmaps stay for phase 11
    print(f"phase 8 at {time.perf_counter() - t_all:.1f} s", flush=True)
    serve_state = {k: v.detach().clone() for k, v in model16.state_dict().items()}
    with tempfile.TemporaryDirectory() as eval_work:
        db_build, build_fps, catalogue = eval_phase(cfg16, serve_state, zero_counts,
                                                    counts, card, eval_work)
        for name in wrappers:
            launches[name]["db_build"] = db_build.get(name, 0)
        torch.cuda.empty_cache()

        # 9. the entry points
        print(f"phase 9 at {time.perf_counter() - t_all:.1f} s", flush=True)
        t9 = time.perf_counter()
        with tempfile.TemporaryDirectory() as work:
            cli, fp9 = cli_phase(serve_state, zero_counts, counts, card, work, t_step,
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

            # 11. int8 serving, then the rest of the index family on phase
            # 8's catalogue
            print(f"phase 11 at {time.perf_counter() - t_all:.1f} s", flush=True)
            t11 = time.perf_counter()
            for path, n in int8_phase(serve_state, waves, zero_counts, counts, card).items():
                launches["mrconv_concat"][path] = n
                launches["grapher_block"][path] = 0               # checked none
            torch.cuda.empty_cache()
            index_rest_phase(catalogue, eval_work, card)
            torch.cuda.empty_cache()
            print(f"phase 11 took {time.perf_counter() - t11:.1f} s")

            # 12. the GraphEncoder's remaining options; the CLI on phase 9's
            # corpus
            print(f"phase 12 at {time.perf_counter() - t_all:.1f} s", flush=True)
            t12 = time.perf_counter()
            for path, got in graph_options_phase(
                    serve_state, waves, z16, banks, x_i, x_j,
                    {"unfused": t_fwd, "fused": t_fused}, work, zero_counts, counts,
                    card).items():
                for name in wrappers:
                    launches[name][path] = got[name]
            print(f"phase 12 took {time.perf_counter() - t12:.1f} s")

            # 13. several devices: the sharded search on phase 8's
            # catalogue, C7 on phase 9's fingerprint dir, the data-parallel
            # step on NCCL at world size 1, the profiling timers
            print(f"phase 13 at {time.perf_counter() - t_all:.1f} s", flush=True)
            t13 = time.perf_counter()
            ddp = multi_device_phase(
                catalogue, fp9, banks, x_i, x_j,
                {"losses": phase5_losses, "step_ms": t_step, "peak_gb": peak_gb,
                 "block": per_shape["grapher_block"]}, zero_counts, counts, card)
            for name, n in ddp.items():
                launches[name]["train_ddp"] = n
            del catalogue
            torch.cuda.empty_cache()
            print(f"phase 13 took {time.perf_counter() - t13:.1f} s")
    # 14. the configurations past the one-pass kernels: k = 9, and the
    # grafp encoder on config/ast.yaml's 3,200-node frontend
    print(f"phase 14 at {time.perf_counter() - t_all:.1f} s", flush=True)
    t14 = time.perf_counter()
    for path, got in wide_phase(waves, banks, x_i, x_j, zero_counts, counts,
                                card).items():
        for name in wrappers:
            launches[name][path] = got[name]
    print(f"phase 14 took {time.perf_counter() - t14:.1f} s")
    # 15. the captured serving forward against the eager one
    print(f"phase 15 at {time.perf_counter() - t_all:.1f} s", flush=True)
    t15 = time.perf_counter()
    graph_phase(serve_state, zero_counts, counts, card)
    print(f"phase 15 took {time.perf_counter() - t15:.1f} s")
    # 16. the protocol's scale: the fma_large geometry, then the e2e driver
    print(f"phase 16 at {time.perf_counter() - t_all:.1f} s", flush=True)
    t16 = time.perf_counter()
    fma_phase(fma_data, fma_root, zero_counts, counts, card)
    print(f"phase 16a took {time.perf_counter() - t16:.1f} s")
    t16b = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        for path, got in e2e_phase(work, zero_counts, counts, card).items():
            for name in wrappers:
                launches[name][path] = got[name]
    print(f"phase 16b took {time.perf_counter() - t16b:.1f} s")
    # 17. the protocol rehearsals through the CLIs: the r5 sweep, then the
    # int8_static sign-off on its checkpoint
    print(f"phase 17 at {time.perf_counter() - t_all:.1f} s", flush=True)
    t17 = time.perf_counter()
    for path, got in rehearsal_phase(rh_data, rh_root, zero_counts, counts, card).items():
        for name in wrappers:
            launches[name][path] = got[name]
    print(f"phase 17 took {time.perf_counter() - t17:.1f} s")
    # 18. the bf16-vs-f32 training study at its defaults, C10's serving rows,
    # then the reference-contract smoke tools
    print(f"phase 18 at {time.perf_counter() - t_all:.1f} s", flush=True)
    t18 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        for path, got in study_phase(zero_counts, counts, card, work).items():
            for name in wrappers:
                launches[name][path] = got[name]
    print(f"phase 18 took {time.perf_counter() - t18:.1f} s")
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
