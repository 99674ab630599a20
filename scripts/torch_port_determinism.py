#!/usr/bin/env python3
"""One answer for one input: every training path and every index trainer
of the port, run twice from one state on one input and compared tensor by
tensor (ROADMAP.md queue C: C11, C12). The JAX package's jitted programs
give one answer for one input; a path here that prints a differing tensor
shows that the port's does not.

    python scripts/torch_port_determinism.py [--device cuda|cpu]
        [--paths NAME,...] [--pairs N] [--deterministic-algorithms]

The paths (``--paths``, default all of them):

* the train steps (``train/step.py:make_train_step``), each in f32 and in
  bf16 from one seeded init on one seeded batch with the augment banks of
  scripts/torch_port_bf16_train_study.py and one step generator: 'size t'
  at 256 pairs (2B = 512, chip_smoke.py phase 7's shape), 'ramp' (phase
  12's dilations and DropPath) and 'k9' (phase 14's k = 9) at 256 pairs,
  the graph options 'pair' (the pair-layout MRConv of knn_strategy
  'exact'), 'edge', 'sage' and 'gin' at 64 pairs, 'ast'
  (config/ast.yaml) at 512 and 'nafp' (Config(arch='nafp', n_mels=256))
  at 256 (phase 10's batches). Compared: every parameter, BatchNorm
  statistic and Adam moment after the step, the loss and the grad norm;
* 'attention': the AST step's attention (``models.ast.
  dot_product_attention``, the library's fused attention on the card)
  forward and backward at its shape, f32 and bf16, ATTENTION_RUNS times.
  Compared: the output and the three input gradients;
* 'ivf' (k-means, k = 400), 'ivfpq' (k-means, k = 64, and 64 PQ
  codebooks) and 'ivfpq-rr' (and the refine codebooks), each built by
  ``get_index`` on the same 2^20 seeded unit rows (the size of
  chip_smoke.py phase 8's catalogue) and searched for the top 20 of 1,000
  rows near them. Compared: centroids, codebooks, codes, each row's cell,
  the ids found;
* 'cli': ``python -m grafp_tpu_torch.cli.train`` at config/grafp.yaml's
  width in f32, two epochs of one step (256 music-like wav tracks of 2 s,
  written under a temporary directory), in two directories. Compared: the
  checkpoint files byte for byte, and each tensor they hold.

Each path prints one line: the count of tensors that differ between its
two runs, the largest |d| of each (the worst first), and its seconds.
The script exits 1 when a tensor or the CLI's checkpoint file differs
(``differs``).

``--deterministic-algorithms`` runs every path a third time under
``torch.use_deterministic_algorithms(True, warn_only=True)`` (with
``CUBLAS_WORKSPACE_CONFIG=:4096:8``, set before the card is touched) and
prints the warnings of any op without a deterministic implementation.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import io
import os
import sys
import tempfile
import time
import warnings

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = ("float32", "bfloat16")
# step path -> (Config fields over the base config, pairs, graph conv);
# 'ast' and 'nafp' start from their own configs
STEP_PATHS = {
    "size t": ({}, 256, "mr"),
    "ramp": (dict(dilation_schedule="ramp", drop_path_schedule="ramp", drop_path=0.1),
             256, "mr"),
    "k9": (dict(k=9), 256, "mr"),
    "pair": (dict(knn_strategy="exact"), 64, "mr"),
    "edge": ({}, 64, "edge"),
    "sage": ({}, 64, "sage"),
    "gin": ({}, 64, "gin"),
    "ast": ({}, 512, "mr"),
    "nafp": ({}, 256, "mr"),
}
INDEX_PATHS = ("ivf", "ivfpq", "ivfpq-rr")
PATHS = (*STEP_PATHS, "attention", *INDEX_PATHS, "cli")
# AST's attention in its train step: 2B = 1024 rows, 10 heads, 11 tokens
# (10 patches and the class token), 64 a head
ATTENTION_SHAPE = (1024, 10, 11, 64)
ATTENTION_RUNS = 10
SEARCH_K = 20
CLI_TRACKS, CLI_SECONDS = 256, 2.0


def path_config(name: str, base=None):
    """The Config of step path ``name``: ``base`` (None: ``Config()``)
    with the path's fields; 'ast' is config/ast.yaml, 'nafp'
    ``Config(arch='nafp', n_mels=256)``."""
    import dataclasses

    from grafp_tpu_torch.core import Config, load_config

    if name == "ast":
        return load_config(os.path.join(REPO, "config", "ast.yaml"))
    if name == "nafp":
        return Config(arch="nafp", n_mels=256)
    return dataclasses.replace(base if base is not None else Config(), **STEP_PATHS[name][0])


def build(cfg, conv: str, device):
    """The train-mode model of ``cfg`` from ``torch.Generator().manual_seed(0)``;
    with ``conv`` 'edge' / 'sage' / 'gin' its GraphEncoder is rebuilt with
    that graph conv (Config has no conv option, as in the JAX package) and
    initialised from seed 20."""
    import torch

    from grafp_tpu_torch.models import build_model
    from grafp_tpu_torch.models.gnn import GraphEncoder
    from grafp_tpu_torch.models.layers import init_parameters

    model = build_model(cfg, generator=torch.Generator().manual_seed(0), device=device,
                        train=True)
    if conv != "mr":
        dtype = torch.bfloat16 if cfg["compute_dtype"] == "bfloat16" else None
        model.encoder = GraphEncoder(in_features=cfg["n_filters"], k=int(cfg["k"]),
                                     conv=conv, emb_dims=cfg["h"], dtype=dtype)
        init_parameters(model.encoder, torch.Generator().manual_seed(20))
        model = model.to(device).train()
    return model


def snapshot(state, metrics) -> dict:
    """Every tensor a step leaves: the state_dict (parameters, BatchNorm
    statistics), each Adam moment and count by its parameter's name, the
    loss and the grad norm; copies."""
    import torch

    names = {id(p): n for n, p in state.model.named_parameters()}
    out = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    for p, st in state.optimizer.state.items():
        for key, v in st.items():
            if torch.is_tensor(v):
                out[f"adam {key} {names[id(p)]}"] = v.detach().clone()
    out.update({k: v.detach().clone() for k, v in metrics.items()})
    return out


def differing(a: dict, b: dict) -> dict:
    """{name: largest |d|} of the tensors of ``a`` whose bits differ from
    ``b``'s (NaN where either holds a NaN)."""
    import torch

    diff = {}
    for k, x in a.items():
        y = b[k]
        if x.shape == y.shape and torch.equal(x.reshape(-1).view(torch.uint8),
                                              y.reshape(-1).view(torch.uint8)):
            continue
        if x.shape != y.shape:
            diff[k] = float("inf")
        else:
            diff[k] = float((x.double() - y.double()).abs().max())
    return diff


def step_data(cfg, pairs: int):
    """The study's banks and a (pairs, clip) batch of x_i, x_j from
    ``RandomState(0)`` at ``cfg``'s clip length."""
    import torch_port_bf16_train_study as study

    banks, x_i, x_j, _ = study.study_data(pairs, 1, cfg.clip_frames)
    return banks, x_i, x_j


def step_twice(cfg, pairs: int, conv: str = "mr", device=None) -> dict:
    """One train step of path config ``cfg``, twice from the same init on
    the same batch and step generator: {"differ": {name: |d|}, "tensors",
    "loss": (a, b), "seconds"}."""
    import torch

    from grafp_tpu_torch.core.device import resolve_device
    from grafp_tpu_torch.train import create_train_state, make_train_step

    dev = resolve_device(device)
    t0 = time.perf_counter()
    banks, x_i, x_j = step_data(cfg, pairs)
    x_i, x_j = (torch.as_tensor(x, device=dev) for x in (x_i, x_j))
    model = build(cfg, conv, dev)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    snaps = []
    for _ in range(2):
        model.load_state_dict(init)
        state = create_train_state(model, cfg, steps_per_epoch=1)
        step = make_train_step(model, cfg, banks, device=dev)
        m = step(state, x_i, x_j, torch.Generator(device=dev).manual_seed(7))
        snaps.append(snapshot(state, m))
        del state, step
    a, b = snaps
    out = {"differ": differing(a, b), "tensors": len(a),
           "loss": (float(a["loss"]), float(b["loss"])),
           "seconds": time.perf_counter() - t0}
    del model, snaps, a, b
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def attention_runs(dtype: str, device=None, runs: int = ATTENTION_RUNS,
                   shape=ATTENTION_SHAPE) -> dict:
    """``models.ast.dot_product_attention`` forward and backward at AST's
    training shape, ``runs`` times on the same seeded q, k, v and cotangent:
    {"differ": {"run i out|dq|dk|dv": |d|} against the first run,
    "tensors", "seconds"}. PyTorch names the backwards of its fused
    attention (cuDNN's, memory-efficient) non-deterministic."""
    import torch

    from grafp_tpu_torch.core.device import resolve_device
    from grafp_tpu_torch.models.ast import dot_product_attention

    dev = resolve_device(device)
    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(8)
    q, k, v, gy = (torch.randn(*shape, generator=g).to(dev, getattr(torch, dtype))
                   for _ in range(4))
    first, diff = None, {}
    for i in range(runs):
        qi, ki, vi = (t.clone().requires_grad_(True) for t in (q, k, v))
        out = dot_product_attention(qi, ki, vi)
        out.backward(gy)
        got = {"out": out.detach(), "dq": qi.grad, "dk": ki.grad, "dv": vi.grad}
        if first is None:
            first = got
            continue
        diff.update({f"run {i} {name}": d for name, d in
                     differing(got, first).items()})
    return {"differ": diff, "tensors": 4 * (runs - 1), "seconds": time.perf_counter() - t0}


def index_rows(rows: int, queries: int, d: int = 128, seed: int = 0):
    """``rows`` seeded unit rows (rows, d) f32 and ``queries`` query rows,
    each a row of the catalogue plus noise, renormalised; numpy."""
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((rows, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    pick = rs.choice(rows, queries, replace=False)
    q = x[pick] + 0.05 * rs.standard_normal((queries, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return x, q


def index_tensors(index, ids) -> dict:
    """What a trained, filled index holds, and the ids it found."""
    import torch

    out = {"ids": torch.as_tensor(ids), "centroids": index.centroids.detach().cpu(),
           "cells": torch.cat(index._cells).cpu()}
    if hasattr(index, "pq"):
        out["pq codebooks"] = index.pq.codebooks.detach().cpu()
        out["pq codes"] = torch.cat(index._codes).cpu()
    if hasattr(index, "refine"):
        out["refine codebooks"] = index.refine.codebooks.detach().cpu()
        out["refine codes"] = torch.as_tensor(np.concatenate(index._rcodes))
    return out


def index_twice(index_type: str, x: np.ndarray, q: np.ndarray, device=None) -> dict:
    """``get_index(index_type)`` trained and filled on ``x`` and searched
    for the top SEARCH_K of ``q``, twice: {"differ", "tensors", "seconds",
    "train_s": (a, b)}."""
    import torch

    from grafp_tpu_torch.core.device import resolve_device
    from grafp_tpu_torch.retrieval.index import get_index

    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    runs, train_s = [], []
    for _ in range(2):
        sync()
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            index = get_index(index_type, x, x.shape, device=dev)
        sync()
        train_s.append(time.perf_counter() - t)
        index.add(x)
        _, ids = index.search(q, SEARCH_K)
        runs.append(index_tensors(index, ids))
        del index
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    a, b = runs
    return {"differ": differing(a, b), "tensors": len(a), "train_s": tuple(train_s),
            "seconds": time.perf_counter() - t0}


def flat_tensors(payload, prefix: str = "") -> dict:
    """Every tensor of a nested checkpoint payload by its key path."""
    import torch

    out = {}
    if torch.is_tensor(payload):
        out[prefix or "."] = payload
    elif isinstance(payload, dict):
        for k, v in payload.items():
            out.update(flat_tensors(v, f"{prefix}/{k}"))
    elif isinstance(payload, (list, tuple)):
        for i, v in enumerate(payload):
            out.update(flat_tensors(v, f"{prefix}/{i}"))
    elif isinstance(payload, (float, int, np.floating, np.integer)):
        out[prefix] = torch.as_tensor(float(payload), dtype=torch.float64)
    return out


def cli_twice(work: str, cfg=None, device=None, dtype: str = "float32",
              tracks: int = CLI_TRACKS, seconds: float = CLI_SECONDS) -> dict:
    """The train CLI (``cli/train_main.main``) for two epochs of one step
    (``tracks`` = bsz_train music-like tracks of ``seconds``) in ``dtype``,
    from the config ``cfg`` (None: config/grafp.yaml), in two directories
    under ``work``: {"differ", "tensors", "files_equal", "seconds"}."""
    import torch

    from grafp_tpu_torch.cli import train_main
    from grafp_tpu_torch.core import load_config
    from grafp_tpu_torch.data.synthetic import make_wav_dir

    t0 = time.perf_counter()
    cfg = (load_config(os.path.join(REPO, "config", "grafp.yaml")) if cfg is None
           else copy.deepcopy(cfg))
    fs = int(cfg["fs"])
    dirs = {name: os.path.join(work, name) for name in ("train", "noise", "ir")}
    make_wav_dir(dirs["train"], tracks, seconds, fs, seed=50, kind="music")
    make_wav_dir(dirs["noise"], 16, 4.0, fs, seed=51, kind="noise")
    make_wav_dir(dirs["ir"], 8, 0.25, fs, seed=52, kind="ir")
    cfg["train_dir"] = cfg["val_dir"] = dirs["train"]
    cfg["noise_dir"], cfg["ir_dir"] = dirs["noise"], dirs["ir"]
    cfg["train_sz"] = cfg["val_sz"] = cfg["bsz_train"] = tracks
    cfg["compute_dtype"] = dtype
    path = os.path.join(work, "determinism.yaml")
    cfg.save(path)
    files, payloads = [], []
    cwd = os.getcwd()
    try:
        for run in ("a", "b"):
            os.makedirs(os.path.join(work, run))
            os.chdir(os.path.join(work, run))
            with open(os.path.join(work, f"cli_{run}.log"), "w") as log, \
                    contextlib.redirect_stdout(log):
                train_main.main(["--config", path, "--ckp", "determinism", "--epochs", "2",
                                 "--validate_every", "0", "--seed", "42"], device=device)
            ckp = os.path.join(work, run, "checkpoint", "model_determinism_current.pth")
            with open(ckp, "rb") as f:
                files.append(f.read())
            payloads.append(flat_tensors(torch.load(ckp, map_location="cpu",
                                                    weights_only=False)))
    finally:
        os.chdir(cwd)
    a, b = payloads
    return {"differ": differing(a, b), "tensors": len(a), "files_equal": files[0] == files[1],
            "seconds": time.perf_counter() - t0}


def differs(res: dict) -> bool:
    """Whether a path's two runs differ: a tensor, or the checkpoint file."""
    return bool(res["differ"]) or not res.get("files_equal", True)


def worst(diff: dict, n: int = 8) -> list:
    """The ``n`` largest differences, largest first, |d| to 3 digits."""
    return [(k, float(f"{v:.3g}")) for k, v in sorted(diff.items(), key=lambda kv: -kv[1])[:n]]


def line(name: str, res: dict) -> str:
    """The path's printed line."""
    extra = ""
    if "loss" in res:
        extra = f"losses {res['loss'][0]!r} {res['loss'][1]!r}; "
    if "train_s" in res:
        extra = f"train {res['train_s'][0]:.3f} s, {res['train_s'][1]:.3f} s; "
    if "files_equal" in res:
        extra = f"checkpoint files byte-equal {res['files_equal']}; "
    return (f"{name}: {extra}{len(res['differ'])} of {res['tensors']} tensors differ "
            f"{worst(res['differ'])}; {res['seconds']:.1f} s")


def say(text: str) -> None:
    print(text, flush=True)


def run(paths=PATHS, device=None, cfg=None, rows: int = 1 << 20, queries: int = 1000,
        report=say, pairs=None) -> dict:
    """Every path of ``paths`` twice on ``device``; ``cfg`` (None:
    ``Config()``) is the base of the grafp step paths, ``pairs`` (None:
    each path's own) their batch. Reports each path's line through
    ``report`` and returns {label: result}."""
    import dataclasses

    results = {}
    for name in paths:
        if name in STEP_PATHS:
            pcfg = path_config(name, cfg)
            n = pairs or STEP_PATHS[name][1]
            for dtype in DTYPES:
                label = f"{name} {dtype} step ({n} pairs)"
                results[label] = step_twice(dataclasses.replace(pcfg, compute_dtype=dtype), n,
                                            STEP_PATHS[name][2], device)
                report(line(label, results[label]))
    if "attention" in paths:
        for dtype in DTYPES:
            label = f"attention {dtype} {'x'.join(map(str, ATTENTION_SHAPE))}, "\
                    f"{ATTENTION_RUNS} runs"
            results[label] = attention_runs(dtype, device)
            report(line(label, results[label]))
    index_paths = [p for p in paths if p in INDEX_PATHS]
    if index_paths:
        x, q = index_rows(rows, queries)
        for name in index_paths:
            label = f"{name} on {rows} rows, top {SEARCH_K} of {queries} queries"
            results[label] = index_twice(name, x, q, device)
            report(line(label, results[label]))
    if "cli" in paths:
        with tempfile.TemporaryDirectory() as tmp:
            label = "train CLI float32, 2 epochs of one step"
            results[label] = cli_twice(tmp, device=device)
            report(line(label, results[label]))
    return results


def main(argv=None, cfg=None) -> int:
    """``cfg`` (None: ``Config()``) is the base config of the grafp step
    paths."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--paths", default=",".join(PATHS),
                    help=f"comma-separated, of {', '.join(PATHS)}")
    ap.add_argument("--pairs", type=int, default=None,
                    help="pairs of every step path (default: each path's own)")
    ap.add_argument("--deterministic-algorithms", action="store_true")
    args = ap.parse_args(argv)
    paths = [p.strip() for p in args.paths.split(",") if p.strip()]
    unknown = sorted(set(paths) - set(PATHS))
    if unknown:
        ap.error(f"unknown paths {unknown}")
    if args.deterministic_algorithms:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    import torch_port_bf16_train_study as study
    from grafp_tpu_torch.core.device import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        from grafp_tpu_torch.ops.build import build_all

        build_all(["mrconv_concat", "max_neighbors", "grapher_block"])
    print(f"device={study.device_name(dev)}", flush=True)
    results = run(paths, dev, cfg, pairs=args.pairs)
    if args.deterministic_algorithms:
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                run(paths, dev, cfg, pairs=args.pairs,
                    report=lambda s: print(f"deterministic algorithms, {s}", flush=True))
        finally:
            torch.use_deterministic_algorithms(False)
        print(f"deterministic algorithms, warnings {sorted({str(w.message) for w in caught})}",
              flush=True)
    bad = [k for k, r in results.items() if differs(r)]
    print(f"paths with a differing tensor: {len(bad)} of {len(results)} {bad}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
