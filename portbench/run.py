"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's configuration, traffic mix and
limits are files found by the names in BENCHMARK.json. Set-up builds the
program's objects from the seed and warms every shape the traffic uses;
the window then runs units of work for ``--seconds`` (from the start of
the first unit to the end of the last unit begun in time); with
``--trace 1`` torch.profiler records a steady stretch of it and the
per-layer metrics are printed instead of the end-to-end ones. After the
window the program's state is freed and what it produced is compared
with the plain reference; ``correct`` says whether every number compared
is within its limit.

Exits 3 without a result when CUDA is missing or the card count is short
of the cell's, and 4 when a module of JAX or the JAX package is loaded
after the window.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = str(Path(__file__).resolve().parent.parent)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

TRACE_AFTER = 1 / 3      # the trace starts at the first unit past this share of the window
TRACE_S = 2.0            # ... and covers units until this many seconds have passed


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="judge the correctness control (the configuration's lower-"
                         "precision path) in place of the program's output")
    ap.add_argument("--fault", default=None,
                    help="plant a named fault under the timed path (the work module's list), "
                         "to read what the comparison gives for it")
    return ap.parse_args(argv)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             control: bool = False, fault=None, traffic_changes=None):
    """One run of cell ``name`` on ``device``. Returns (result line dict,
    numbers compared). ``traffic_changes`` and ``fault`` serve the tests:
    a smaller traffic mix, and a fault planted under the timed path."""
    import torch

    bench = harness.benchmark()
    cell, conf_entry, conf, traffic = harness.cell_files(bench, name)
    traffic = {**traffic, **(traffic_changes or {})}
    limits = harness.cell_limits(name)
    spans = harness.Spans()
    workdir = tempfile.mkdtemp(prefix="portbench_")
    print(f"setup process and imports: {harness.process_age_s():.3f} s", file=sys.stderr)
    try:
        work_cls = getattr(importlib.import_module(f"portbench.work.{traffic['kind']}"),
                             traffic["kind"].capitalize())
        work = work_cls(conf, traffic, seed, device, spans, workdir, fault, control)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        work.setup()
        setup_s = harness.process_age_s()
        for phase, t_a, t_b in spans.done:
            print(f"setup {phase}: {t_b - t_a:.3f} s", file=sys.stderr)
        tracer = harness.Tracer(spans, workdir) if trace else None
        if tracer:
            tracer.warm()
        stretch = None      # (counters at the trace's start, at its end, its host seconds)
        traced = before = None
        t0 = time.perf_counter()
        while True:
            now = time.perf_counter() - t0
            traced_none = before is not None and before["units"] == work.units
            if now >= seconds and work.units > 0 and not traced_none:
                break
            if tracer and before is None and now >= seconds * TRACE_AFTER:
                # the profiler's first unit pays its start-up: traced, kept
                # out of the traced range
                start_counters, trace_h0 = work.counters(), time.perf_counter()
                tracer.start()
                with spans("pb.trace_start"):
                    work.unit()
                before, trace_t0 = work.counters(), time.perf_counter()
                continue
            with spans(work.unit_span):
                work.unit()
            if before is not None and stretch is None and (
                    time.perf_counter() - trace_t0 >= TRACE_S
                    or time.perf_counter() - t0 >= seconds):
                tracer.stop()
                after = work.counters()
                traced = {k: after[k] - before[k] for k in after}
                stretch = (start_counters, after, time.perf_counter() - trace_h0)
        window_s = time.perf_counter() - t0
        if tracer and before is not None and stretch is None:
            tracer.stop()
            after = work.counters()
            traced = {k: after[k] - before[k] for k in after}
            stretch = (start_counters, after, time.perf_counter() - trace_h0)
        peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
        e2e = work.end_to_end(window_s)
        result = {"correct": False, "attempted": work.units, "failed": 0}
        total = work.counters()
        tr = tracer.reduce(work.unit_span) if trace else None
        work.release()
        checks = work.check()
        if trace:
            # counts that need the check's reference join the others
            units = (0, total["units"]), (before["units"], stretch[1]["units"]), \
                (stretch[0]["units"], stretch[1]["units"])
            late_total, late_traced, late_stretch = (work.late_counters(*u) for u in units)
            total.update(late_total)
            traced.update(late_traced)
            untraced = {k: total[k] - (stretch[1][k] - stretch[0][k]) for k in stretch[1]}
            untraced.update({k: total[k] - late_stretch[k] for k in late_stretch})
            ctx = Context(conf["config"], traffic, total, traced, window_s, tr, e2e,
                          untraced, window_s - stretch[2])
            metrics = {}
            for m in bench["per_layer"]:
                if name not in m.get("workloads", [name]):
                    continue
                value = harness.metric_reader(m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
            for m in bench["end_to_end"]:
                if m["name"] in e2e and name in m.get("workloads", [name]):
                    metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
        result["metrics"] = metrics
        result["device"] = device_entry(device, peak, tr)
        if trace:
            result["breakdown"] = {"device_ops": tr.by_name(), "idle_gaps": tr.idle_gaps()}
        for c in checks:
            c["limit"] = limits[c["name"]]["limit"]
        result["correct"] = all(c["value"] <= c["limit"] for c in checks)
        limit = harness.card_power_limit() if device.type == "cuda" else None
        result["card"] = {"name": result["device"]["kind"], "power_limit": limit}
        return result, checks
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


class Context:
    """What a per-layer reader reads: the configuration (``cfg``) and the
    traffic mix, the work's counters over the whole window
    (``counters``), over the traced units (``traced``) and over the units
    the profiler did not slow (``untraced``, in ``untraced_s`` of the
    host's clock), the window's length, the reduced trace (``trace``: busy
    time, kernel time by name) and the end-to-end values of this run."""

    def __init__(self, cfg, traffic, counters, traced, window_s, trace, e2e,
                 untraced=None, untraced_s=None):
        self.cfg, self.traffic = cfg, traffic
        self.counters, self.traced = counters, traced
        self.window_s, self.trace, self.e2e = window_s, trace, e2e
        self.untraced, self.untraced_s = untraced, untraced_s


def device_entry(device, peak: int, trace) -> dict:
    import torch
    if device.type == "cuda":
        entry = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                 "count": 1, "memory_peak_bytes": int(peak)}
    else:
        entry = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if trace is not None:
        entry["busy_s"] = trace.busy_s
        entry["window_s"] = trace.window_s
    return entry


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    bench = harness.benchmark()
    cell = harness.cell_files(bench, args.workload)[0]
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), control=args.control,
                              fault=args.fault)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 4
    harness.print_result(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
