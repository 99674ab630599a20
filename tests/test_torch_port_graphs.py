"""The captured serving forward's bookkeeping (grafp_tpu_torch/fp/graphs.py)
on the CPU, with its CUDA calls behind the ``CudaGraphs`` seam replaced by
``CpuGraphs``: a capture runs the function once and keeps it, and a
replay runs it again on the static input without touching the launch
counters, as a real replay runs no Python. What only the card can show
(bit equality with the eager forward, TMA descriptors and workspaces
inside a graph, a real capture failing) is in tests/test_torch_port_cuda.py
and chip_smoke.py.

The pipeline tests run a tiny model (fs 1 kHz, 16 mels, 8-frame segments,
64 graph nodes) through ``FingerprintPipeline`` with the seam put in its
``graphs``: one graph per DB build, however ragged the tracks; the rows
equal the eager pipeline's bit for bit (the same arithmetic on the same
batches); int8_static calibrates before the first capture."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grafp_tpu_torch.core import Config  # noqa: E402
from grafp_tpu_torch.fp import builder as tb  # noqa: E402
from grafp_tpu_torch.fp.graphs import (  # noqa: E402
    KERNEL_WRAPPERS,
    WARMUP_RUNS,
    CapturedForward,
)
from grafp_tpu_torch.models import build_model  # noqa: E402
from grafp_tpu_torch.retrieval import memmap_io as tmm  # noqa: E402
from tests.torch_port_util import one_torch_thread  # noqa: E402, F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TINY = dict(fs=1000, win_len=256, hop_len=128, n_fft=256, n_mels=16, n_frames=8)
# ragged tracks over three length buckets, one too short for a segment
LENGTHS = (1900, 3500, 1500, 2600, 500, 3500, 1900, 4100)


class _Replay:
    """A recorded capture: ``replay`` recomputes the output in place from
    the static input and leaves every counter as it was."""

    def __init__(self, fn, x, out, counters):
        self.fn, self.x, self.out, self.counters = fn, x, out, counters
        self.replays = 0

    def replay(self):
        saved = [c.launches for c in self.counters]
        self.out.copy_(self.fn(self.x))
        for c, n in zip(self.counters, saved):
            c.launches = n
        self.replays += 1


class CpuGraphs:
    """``CudaGraphs``' stand-in on the CPU; ``fail`` makes every capture
    raise, as a capture on the card does when the function reads device
    data on the host."""

    def __init__(self, counters=KERNEL_WRAPPERS, fail=False, on_warm_up=None):
        self.counters, self.fail, self.on_warm_up = counters, fail, on_warm_up
        self.warm_ups, self.captured = [], []

    def warm_up(self, fn, x):
        self.warm_ups.append(tuple(x.shape))
        if self.on_warm_up is not None:
            self.on_warm_up()
        for _ in range(WARMUP_RUNS):
            fn(x)

    def capture(self, fn, x):
        if self.fail:
            raise RuntimeError("operation not permitted when stream is capturing")
        graph = _Replay(fn, x, fn(x), self.counters)
        self.captured.append(graph)
        return graph, graph.out, 1000


class Counter:
    def __init__(self):
        self.launches = 0


def _counted(counters, adds):
    """x -> 2x + 1, adding adds[i] to counters[i] per call, as a forward
    adds one per kernel launch; also counts its own calls."""
    calls = []

    def fn(x):
        calls.append(tuple(x.shape))
        for c, n in zip(counters, adds):
            c.launches += n
        return 2 * x + 1
    return fn, calls


def test_one_graph_per_shape_and_dtype():
    counters = (Counter(),)
    fn, _ = _counted(counters, (1,))
    seam = CpuGraphs(counters)
    fwd = CapturedForward(fn, counters, seam)
    for shape, dtype in (((4, 3), torch.float32), ((4, 3), torch.float32),
                         ((5, 3), torch.float32), ((4, 3), torch.float64),
                         ((5, 3), torch.float32)):
        x = torch.randn(shape, dtype=dtype)
        torch.testing.assert_close(fwd(x), 2 * x + 1, rtol=0, atol=0)
    assert [(k[0], k[1]) for k in fwd.entries] == [
        ((4, 3), torch.float32), ((5, 3), torch.float32), ((4, 3), torch.float64)]
    assert seam.warm_ups == [(4, 3), (5, 3), (4, 3)]
    assert [g.replays for g in seam.captured] == [2, 2, 1]
    assert fwd.pool_bytes == 3000


def test_replays_advance_the_counters_by_the_captures_launches():
    """The warm-up's and capture's launches are set-up; each replay adds
    what the capture launched, so n calls count what n eager calls did."""
    a, b, c = Counter(), Counter(), Counter()
    c.launches = 7
    fn, calls = _counted((a, b), (12, 2))
    fwd = CapturedForward(fn, (a, b, c), CpuGraphs((a, b, c)))
    x = torch.ones(8, 2)
    fwd(x)
    assert (a.launches, b.launches, c.launches) == (12, 2, 7)
    assert len(calls) == WARMUP_RUNS + 2          # warm-up, capture, one replay
    for i in range(3):
        fwd(x)
        assert (a.launches, b.launches, c.launches) == (12 * (i + 2), 2 * (i + 2), 7)
    (entry,) = fwd.entries.values()
    assert entry.launches == {0: 12, 1: 2}
    a.launches = b.launches = 0                   # a path zeroes the counts
    fwd(x)
    assert (a.launches, b.launches) == (12, 2)


def test_each_call_copies_its_input_in_and_its_output_out():
    fn, _ = _counted((), ())
    fwd = CapturedForward(fn, (), CpuGraphs(()))
    x1, x2 = torch.randn(6, 4), torch.randn(6, 4)
    y1 = fwd(x1)
    x1_copy = x1.clone()
    y2 = fwd(x2)
    torch.testing.assert_close(y1, 2 * x1_copy + 1, rtol=0, atol=0)
    torch.testing.assert_close(y2, 2 * x2 + 1, rtol=0, atol=0)
    (entry,) = fwd.entries.values()
    assert y2.data_ptr() != entry.out.data_ptr() and y1.data_ptr() != y2.data_ptr()
    assert x2.data_ptr() != entry.static_in.data_ptr()
    y2.zero_()                                    # the caller's copy is its own
    torch.testing.assert_close(fwd(x2), 2 * x2 + 1, rtol=0, atol=0)
    # a non-contiguous input of the same shape takes the same graph
    fwd(torch.randn(4, 6).t())
    assert len(fwd.entries) == 1


def test_a_failed_capture_raises_and_runs_nothing_eagerly():
    a = Counter()
    fn, calls = _counted((a,), (3,))
    fwd = CapturedForward(fn, (a,), CpuGraphs((a,), fail=True))
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capturing"):
            fwd(torch.ones(2, 2))
    assert a.launches == 0 and fwd.entries == {}
    assert len(calls) == 2 * WARMUP_RUNS          # the warm-ups only


def _tiny_pipeline(graphs=None, **cfg_kw):
    cfg = Config(**TINY, **cfg_kw)
    model = build_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    pipe = tb.FingerprintPipeline(model, cfg, batch_size=16, bucket_s=2.0, device="cpu")
    if graphs is not None:
        pipe.graphs = CapturedForward(functools.partial(tb._serve, pipe.model),
                                      graphs=graphs)
    return pipe


def _waves(seed=0):
    rs = np.random.RandomState(seed)
    return [(0.2 * rs.randn(n)).astype(np.float32) for n in LENGTHS]


def test_the_cpu_pipeline_runs_eagerly():
    assert _tiny_pipeline().graphs is None


@pytest.mark.parametrize("pack", [1, 3])
def test_a_db_build_captures_one_graph_and_keeps_every_row(pack, tmp_path):
    seam = CpuGraphs()
    eager, graphed = _tiny_pipeline(), _tiny_pipeline(seam)
    waves = _waves()
    want = np.concatenate(eager.fingerprint_tracks(waves, pack=pack))
    n, d = tb.create_dummy_db(waves, graphed, str(tmp_path), verbose=False, pack=pack)
    got, _ = tmm.load_memmap_data(str(tmp_path), "dummy_db", display=False)
    assert (n, d) == got.shape
    np.testing.assert_array_equal(got, want)
    assert list(graphed.graphs.entries) == [((16, 16, 8), torch.float32,
                                             torch.device("cpu"))]
    assert len(seam.captured) == 1 and seam.captured[0].replays > 1


def test_int8_static_calibrates_before_the_first_capture():
    state = {}
    pipe = _tiny_pipeline(serve_quant="int8_static")
    seam = CpuGraphs(on_warm_up=lambda: state.setdefault("amax", [
        float(b) for n, b in pipe.model.named_buffers() if n.endswith("amax")]))
    pipe.graphs = CapturedForward(functools.partial(tb._serve, pipe.model), graphs=seam)
    assert pipe._needs_calibration
    pipe.fingerprint_tracks(_waves(1)[:3])
    assert not pipe._needs_calibration
    assert state["amax"] and all(a > 0 for a in state["amax"])
