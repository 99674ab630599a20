"""Timing and tracing hooks (port of ``grafp_tpu.utils.profiling``).

* ``fence``: wait for the device work of a tree of tensors, then read the
  clock.
* ``StepTimer``: rolling host-side step times, fenced on the step's
  outputs.
* ``IterTimer`` / ``scan_time_per_iter``: the device time of a body per
  call, from the times of two loop lengths, so that the fixed cost of a
  timed run (launch latency, the fence) drops out.
* ``trace``: a ``torch.profiler`` trace written for TensorBoard when a
  directory is given, a no-op otherwise.
* ``ThroughputMeter``: items per second, host-side.

On a card the loops are timed with CUDA events; on the CPU with the host's
clock.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import numpy as np
import torch


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _cuda_devices(tree):
    return {t.device for t in _tensors(tree) if t.is_cuda}


def fence(tree=None) -> float:
    """Wait until the work that produces the tensors of ``tree`` (nested
    dicts, lists and tuples; None = every card's work) is done, and return
    ``time.perf_counter()``."""
    devices = (_cuda_devices(tree) if tree is not None
               else ({torch.device("cuda")} if torch.cuda.is_available() else set()))
    for d in devices:
        torch.cuda.synchronize(d)
    return time.perf_counter()


class StepTimer:
    """Rolling step timing: ``with timer.step(outputs): ...`` then
    ``stats()``; the last ``window`` steps are kept."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times = []

    @contextlib.contextmanager
    def step(self, outputs=None):
        t0 = time.perf_counter()
        yield
        t1 = fence(outputs) if outputs is not None else time.perf_counter()
        self.record(t1 - t0)

    def record(self, seconds: float) -> None:
        self.times.append(seconds)
        if len(self.times) > self.window:
            self.times.pop(0)

    def stats(self) -> Dict[str, float]:
        if not self.times:
            return {}
        a = np.asarray(self.times)
        return {"mean_s": float(a.mean()), "p50_s": float(np.percentile(a, 50)),
                "p90_s": float(np.percentile(a, 90)), "last_s": float(a[-1])}


class IterTimer:
    """Loop timer for ``body(x)``: ``run(iters)`` calls the body ``iters``
    times back to back and returns the seconds from the first launch to
    the end of the last call's device work. The first ``run`` is preceded
    by one untimed warm-up call (compilation, allocator growth). On a card
    the loop is timed with CUDA events on the current stream of ``x``'s
    device, after a fence, so the time is the device's; on the CPU with
    the host's clock. ``calls`` counts the body's calls."""

    def __init__(self, body, x):
        self._body = body
        self._x = x
        self.calls = 0
        devices = _cuda_devices(x)
        self._device = next(iter(devices)) if devices else None
        self._warm = False

    def _call(self):
        self.calls += 1
        return self._body(self._x)

    def run(self, iters: int) -> float:
        if not self._warm:
            self._call()
            self._warm = True
        if self._device is None:
            t0 = time.perf_counter()
            for _ in range(iters):
                self._call()
            return time.perf_counter() - t0
        with torch.cuda.device(self._device):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(iters):
                self._call()
            end.record()
            end.synchronize()
        return start.elapsed_time(end) / 1e3


def scan_time_per_iter(body, x, iters_lo: int = 8, iters_hi: int = 40,
                       reps: int = 3) -> Dict[str, float]:
    """Steady-state seconds per call of ``body(x)``: the IterTimer loop at
    two lengths, each the least of ``reps`` runs, and (t_hi - t_lo) /
    (iters_hi - iters_lo), which cancels every fixed cost of a run.
    Returns per_iter_s, fixed_overhead_s (t_lo less iters_lo calls) and
    compile_s (the first run at iters_hi, warm-up included)."""
    timer = IterTimer(body, x)
    t0 = time.perf_counter()
    timer.run(iters_hi)
    compile_s = time.perf_counter() - t0
    times = {n: min(timer.run(n) for _ in range(reps)) for n in (iters_lo, iters_hi)}
    per_iter = (times[iters_hi] - times[iters_lo]) / (iters_hi - iters_lo)
    return {"per_iter_s": per_iter,
            "fixed_overhead_s": times[iters_lo] - per_iter * iters_lo,
            "compile_s": compile_s}


@contextlib.contextmanager
def trace(profile_dir: Optional[str] = None):
    """A ``torch.profiler`` trace of the block (the CPU, and the cards
    when CUDA is available) written under ``profile_dir`` for TensorBoard;
    a no-op without a directory."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(profile_dir)):
        yield


class ThroughputMeter:
    """Items per second since construction, host-side."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.items = 0

    def add(self, n: int) -> None:
        self.items += n

    def rate(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.items / dt if dt > 0 else 0.0
