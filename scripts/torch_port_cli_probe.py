#!/usr/bin/env python3
"""Run one of the port's CLIs as ``python -m MODULE ARGS...`` would, and at
its exit print one line ``[probe] {...}`` (JSON) of what it did:

  seconds          wall time of the CLI's main
  stages           seconds in create_dummy_db, create_fp_db and eval_faiss
                   (summed over calls)
  train_steps      train steps run
  embed_batches    model calls of every FingerprintPipeline (each a
                   full ``batch_size`` batch)
  launches         each kernel wrapper's launch count (a CUDA graph replay
                   counts its capture's launches, fp/graphs.py)
  host_peak_gb     the process's peak resident memory
  card_peak_gb     the card's peak allocated and reserved memory (torch's
                   allocator), when the CLI ran on the card

The sweeps take it as their interpreter:

    PYTHON="python scripts/torch_port_cli_probe.py" \\
        bash scripts/torch_port_e2e_cli_icassp_r5.sh ROOT EPOCHS

It changes nothing the CLI computes: it only wraps functions to count
and time their calls.
"""

from __future__ import annotations

import functools
import json
import os
import resource
import runpy
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def _wrap(owner, name: str, before=None, after=None):
    fn = getattr(owner, name)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if before:
            before(*args, **kwargs)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if after:
            after(out, time.perf_counter() - t0, *args, **kwargs)
        return out

    setattr(owner, name, wrapped)


def main(argv) -> int:
    if len(argv) < 2 or argv[0] != "-m":
        raise SystemExit("usage: torch_port_cli_probe.py -m MODULE [ARGS...]")
    import torch

    import grafp_tpu_torch.train as train_pkg
    from grafp_tpu_torch.fp import builder
    from grafp_tpu_torch.fp.graphs import KERNEL_WRAPPERS
    from grafp_tpu_torch.retrieval import evaluate

    report = {"module": argv[1], "stages": {}, "train_steps": 0, "embed_batches": 0}

    def timed(name):
        def after(_out, secs, *args, **kwargs):
            report["stages"][name] = report["stages"].get(name, 0.0) + secs
        return after

    for owner, name in ((builder, "create_dummy_db"), (builder, "create_fp_db"),
                        (evaluate, "eval_faiss")):
        _wrap(owner, name, after=timed(name))

    def count_batch(*_args, **_kw):
        report["embed_batches"] += 1

    _wrap(builder.FingerprintPipeline, "embed", before=count_batch)
    make_step = train_pkg.make_train_step

    @functools.wraps(make_step)
    def counted_make_step(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def counted(*a, **kw):
            report["train_steps"] += 1
            return step(*a, **kw)

        return counted

    train_pkg.make_train_step = counted_make_step
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    sys.argv = [argv[1]] + list(argv[2:])
    t0 = time.perf_counter()
    try:
        runpy.run_module(argv[1], run_name="__main__", alter_sys=True)
    finally:
        report["seconds"] = time.perf_counter() - t0
        report["launches"] = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
        report["host_peak_gb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            report["card_peak_gb"] = {
                "allocated": torch.cuda.max_memory_allocated() / 1e9,
                "reserved": torch.cuda.max_memory_reserved() / 1e9}
        print("[probe] " + json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
