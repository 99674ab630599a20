"""The captured serving forward: one CUDA graph per input shape.

The JAX pipeline never runs its model eagerly: it jits ``_embed``, one
compiled program per input shape (``grafp_tpu/fp/builder.py:88-93``), and
maps it over whole ``batch_size`` batches (``:113-150``). Eager PyTorch
launches the same forward from Python kernel by kernel, and at the
serving batch the card then waits on the host. ``CapturedForward`` is the
port's ``jax.jit`` of ``_embed``: per (shape, dtype, device) of its input
it warms the function up, captures it into one ``torch.cuda.CUDAGraph``
with a memory pool of its own, and from then on copies each input into
the graph's static input, replays the graph and returns a copy of its
output, so that nothing outside keeps a reference into the pool.

What a graph bakes in, and why it stays valid:

* every device address the capture saw: the static input, the pool's
  scratch (the kernels' workspaces, ``ops/grapher_block.py`` and
  ``ops/mrconv_concat.py``, come from the pool under capture), and the
  weights. The fused Grapher's TMA descriptors are encoded on the host
  from those addresses at launch and passed by value
  (``csrc/grapher_gemm.cuh``), so the graph replays them as they were.
  ``FingerprintPipeline`` serves a BatchNorm-folded copy whose weights are
  frozen buffers (``models/fold_bn.py``) that nothing moves or replaces;
  int8_static's activation maxima are buffers updated in place
  (``FingerprintPipeline._set_scales``), so a replay reads new scales.
* nothing of the host: a function captured here must not read device data
  on the host (``.item()``, a copy to the CPU) or upload host data. Such a
  call fails the capture, and the failure raises: nothing falls back to
  the eager forward.

The warm-up runs first, on a side stream, because the first call of a
shape may build and load a kernel library (``ops/build.py:load_library``)
and the kernels set their shared-memory limits at their first launch;
none of that may happen inside a capture.

Launch counts: a kernel's wrapper adds to its ``.launches`` only when
Python calls it, which a replay does not. So each entry keeps the
launches its capture made and adds them to the counters at every replay;
the warm-up's and the capture's own are set-up and leave the counters as
they were, so a path counts what its eager forward counted.

The CUDA calls sit behind one seam (``CudaGraphs``: warm-up, capture,
replay), which the CPU tests replace with a stand-in that records and
replays on the CPU (``tests/test_torch_port_graphs.py``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from grafp_tpu_torch.ops.grapher_block import grapher_block
from grafp_tpu_torch.ops.max_neighbors import max_neighbors, max_neighbors_backward
from grafp_tpu_torch.ops.mrconv_concat import mrconv_concat, mrconv_concat_backward

# every kernel wrapper of the port, each with its launch count ``.launches``
KERNEL_WRAPPERS = (mrconv_concat, mrconv_concat_backward, max_neighbors,
                   max_neighbors_backward, grapher_block)
# eager calls of a new shape before its capture
WARMUP_RUNS = 2


class CudaGraphs:
    """The CUDA side of ``CapturedForward``: warm-up and capture on one
    side stream, and the graph, whose ``replay()`` launches it on the
    current stream."""

    def __init__(self):
        self._stream: Optional[torch.cuda.Stream] = None

    def _side(self, device: torch.device) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=device)
        return self._stream

    def warm_up(self, fn: Callable, x: torch.Tensor) -> None:
        side, current = self._side(x.device), torch.cuda.current_stream(x.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                fn(x)
        current.wait_stream(side)

    def capture(self, fn: Callable, x: torch.Tensor):
        """(graph, its output, the bytes its private pool reserved)."""
        # torch.cuda.graph empties the cache too on entry; doing it first
        # makes the reserved bytes' growth the new pool's alone
        torch.cuda.synchronize(x.device)
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(x.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self._side(x.device)):
            out = fn(x)
        torch.cuda.synchronize(x.device)
        return graph, out, torch.cuda.memory_reserved(x.device) - before


@dataclass
class Captured:
    """One input shape's graph: its static input and output, the launches
    one replay makes, the pool's bytes and the seconds the warm-up and
    capture took."""
    graph: object
    static_in: torch.Tensor
    out: torch.Tensor
    launches: Dict[int, int]          # counter index -> launches a replay makes
    pool_bytes: int
    capture_s: float


class CapturedForward:
    """``fn(x) -> tensor`` replayed from one graph per (shape, dtype,
    device) of x, captured at the first call of each (see the module).
    ``counters``: objects whose ``.launches`` the replays advance (every
    kernel wrapper of the port by default); ``graphs``: the CUDA seam."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor],
                 counters: Sequence = KERNEL_WRAPPERS,
                 graphs: Optional[CudaGraphs] = None):
        self.fn = fn
        self.counters = tuple(counters)
        self.graphs = CudaGraphs() if graphs is None else graphs
        self.entries: Dict[Tuple, Captured] = {}

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        key = (tuple(x.shape), x.dtype, x.device)
        entry = self.entries.get(key)
        if entry is None:
            entry = self.entries[key] = self._capture(x)
        entry.static_in.copy_(x)
        entry.graph.replay()
        for i, n in entry.launches.items():
            self.counters[i].launches += n
        return entry.out.clone()

    def _capture(self, x: torch.Tensor) -> Captured:
        t0 = time.perf_counter()
        saved = [c.launches for c in self.counters]
        static_in = torch.empty_like(x, memory_format=torch.contiguous_format).copy_(x)
        try:
            self.graphs.warm_up(self.fn, static_in)
            start = [c.launches for c in self.counters]
            graph, out, pool = self.graphs.capture(self.fn, static_in)
            made = {i: c.launches - s for i, (c, s) in enumerate(zip(self.counters, start))
                    if c.launches != s}
        finally:
            for c, n in zip(self.counters, saved):
                c.launches = n
        return Captured(graph, static_in, out, made, pool, time.perf_counter() - t0)

    @property
    def pool_bytes(self) -> int:
        """The bytes the graphs' private pools reserved."""
        return sum(e.pool_bytes for e in self.entries.values())
