"""What every cell shares: finding a cell's files by name, the set-up
clock, spans around the calls into the program's layers, the device's
trace and its reduction, and the result line.

Nothing here imports the program; the work modules under ``work/`` do.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "grafp_tpu")
ELEMENTWISE_MARKS = ("elementwise_kernel", "reduce_kernel")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    path = ROOT / "BENCHMARK.json"
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing: run from a checkout of the repository")
    return load_json(path)


def cell_files(bench: dict, name: str) -> Tuple[dict, dict, dict, dict]:
    """(workload entry, configuration entry, configuration file, traffic
    file) of the cell ``name``, each found by the name BENCHMARK.json
    gives; the cell's own file (its limits) is ``cell_limits``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return cell, conf, load_json(ROOT / conf["file"]), traffic


def cell_limits(name: str) -> Dict[str, dict]:
    """{number: {"limit": ...}} of the cell ``name`` (cells/<name>.json)."""
    return load_json(HERE / "cells" / f"{name}.json")["limits"]


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``'s
    ``read(ctx) -> float | None``."""
    return load_module(HERE / "metrics" / f"{name}.py", f"portbench_metric_{name}").read


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's record of
    its start (clock ticks since boot) and the time since boot."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def card_power_limit() -> Optional[str]:
    """The card's power limit as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


class Spans:
    """Host spans around calls into the program's layers, kept in memory
    as (name, start, end) on the host clock; while a trace runs each span
    is also a ``record_function`` range, so the trace can say what the host
    was doing when the device was idle."""

    def __init__(self):
        self.done: List[Tuple[str, float, float]] = []
        self.tracing = False

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        if self.tracing:
            import torch
            with torch.profiler.record_function(name):
                yield
        else:
            yield
        self.done.append((name, t0, time.perf_counter()))


# -- the device trace ----------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def read_trace(path: str) -> Tuple[list, list]:
    """(device events, host spans) of a chrome trace that torch.profiler
    exported: each a list of (name, start us, end us), sorted by start."""
    events = load_json(Path(path)).get("traceEvents", [])
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        item = (e.get("name", ""), float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append(item)
        elif cat == "user_annotation":
            host.append(item)
    return sorted(dev, key=lambda x: x[1]), sorted(host, key=lambda x: x[1])


def merge(intervals) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    """The reduction of one traced window: device busy time, kernel time by
    name, and idle gaps named by the innermost host span around them.
    The window is the first to the last ``unit_span`` range in the trace,
    on the trace's own clock."""

    def __init__(self, dev: list, host: list, unit_span: str):
        units = [h for h in host if h[0] == unit_span]
        if not units:
            raise RuntimeError(f"the trace holds no {unit_span!r} range")
        self.t0, self.t1 = units[0][1], max(u[2] for u in units)
        self.kernels = [(n, max(a, self.t0), min(b, self.t1)) for n, a, b in dev
                        if b > self.t0 and a < self.t1]
        self.host = [h for h in host if h[2] > self.t0 and h[1] < self.t1]
        self.busy_iv = merge((a, b) for _, a, b in self.kernels)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_iv) / 1e6

    def time_s(self, match) -> float:
        """Device seconds of the kernels whose name ``match`` accepts."""
        return sum(b - a for n, a, b in self.kernels if match(n)) / 1e6

    def by_name(self, top: int = 10) -> List[list]:
        sums: Dict[str, float] = {}
        for n, a, b in self.kernels:
            key = short_name(n)
            sums[key] = sums.get(key, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle device time inside the window, summed by the innermost host
        span open at each gap's middle ('no span' where none is)."""
        edges = [self.t0] + [x for iv in self.busy_iv for x in iv] + [self.t1]
        sums: Dict[str, float] = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            inner = [h for h in self.host if h[1] <= mid <= h[2]]
            name = min(inner, key=lambda h: h[2] - h[1])[0] if inner else "no span"
            sums[name] = sums.get(name, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:top]]


def short_name(kernel: str, width: int = 120) -> str:
    """A kernel's name without ``void``, ``(anonymous namespace)::`` and its
    argument list, at most ``width`` characters."""
    name = kernel[5:] if kernel.startswith("void ") else kernel
    name = name.replace("(anonymous namespace)::", "").split("(", 1)[0]
    return name[:width]


def is_elementwise(name: str) -> bool:
    return any(m in name for m in ELEMENTWISE_MARKS)


class Tracer:
    """torch.profiler over a range of units: ``start`` at a unit boundary,
    ``stop`` at another; ``reduce`` exports the chrome trace under
    ``workdir``, reads it and deletes it."""

    def __init__(self, spans: Spans, workdir: str):
        self.spans, self.workdir, self.prof = spans, workdir, None

    def warm(self) -> None:
        """Profile one small operation, so that the profiler's own start-up
        (seconds on an H100's host) falls in set-up and not in the
        window."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self.spans.tracing = True

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.prof.stop()
        self.spans.tracing = False

    def reduce(self, unit_span: str) -> Trace:
        path = os.path.join(self.workdir, "portbench_trace.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        try:
            return Trace(*read_trace(path), unit_span)
        finally:
            os.remove(path)


def print_result(result: dict, checks: List[dict]) -> None:
    """The numbers compared, each beside its limit, as the last lines of
    standard error; then the result line, with them last under
    ``checks``, as the last line of standard output."""
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    out = dict(result)
    out["checks"] = {c["name"]: [c["value"], c["limit"]] for c in checks}
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
