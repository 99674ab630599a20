"""The port's profiling hooks on the CPU (``grafp_tpu_torch.utils.profiling``,
mirroring tests/test_profiling.py): the loop timer's warm-up and call
count, the two-length fit's keys, the rolling step timer, the fence, the
throughput meter and the trace, a no-op without a directory and a written
trace with one."""

import os
import time

import numpy as np
import torch

from grafp_tpu_torch.utils.profiling import (
    IterTimer,
    StepTimer,
    ThroughputMeter,
    fence,
    scan_time_per_iter,
    trace,
)


def test_iter_timer_warms_up_once_and_counts_calls():
    calls = []

    def body(x):
        calls.append(1)
        return x * 2.0 + 1.0

    t = IterTimer(body, torch.ones(4, 4))
    total = 0
    for iters in (1, 3, 7, 3):
        assert t.run(iters) > 0
        total += iters
    assert sum(calls) == t.calls == total + 1       # one warm-up call


def test_scan_time_per_iter_structure():
    # on a contended CPU the difference of two short loops can come out
    # negative, so assert the structure and finiteness, not the ordering
    r = scan_time_per_iter(lambda x: x @ x, torch.ones(64, 64), iters_lo=1,
                           iters_hi=5, reps=2)
    assert set(r) == {"per_iter_s", "fixed_overhead_s", "compile_s"}
    assert np.isfinite(r["per_iter_s"]) and np.isfinite(r["fixed_overhead_s"])
    assert r["compile_s"] > 0


def test_scan_time_per_iter_finds_the_body_time():
    """A body that sleeps 20 ms: the fit recovers it, and the fixed cost
    drops out."""
    r = scan_time_per_iter(lambda x: time.sleep(0.02), torch.ones(1), iters_lo=1,
                           iters_hi=4, reps=1)
    assert 0.015 < r["per_iter_s"] < 0.1


def test_step_timer():
    t = StepTimer(window=3)
    for _ in range(5):
        with t.step(outputs={"a": torch.ones(3)}):
            time.sleep(0.01)
    s = t.stats()
    assert 0.005 < s["p50_s"] < 1.0
    assert len(t.times) == 3                         # window respected
    assert StepTimer().stats() == {}


def test_fence_and_meter():
    t0 = time.perf_counter()
    assert fence({"a": torch.ones(2, 2), "b": [torch.zeros(1)]}) >= t0
    assert fence() >= t0
    m = ThroughputMeter()
    m.add(100)
    assert m.rate() > 0


def test_trace_noop_and_written(tmp_path):
    with trace(None):
        pass
    with trace(str(tmp_path)):
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert any(f.endswith(".json") for f in os.listdir(tmp_path))
