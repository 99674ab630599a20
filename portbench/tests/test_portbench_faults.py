"""The harness on the CPU, past its look for a card, at a small size, with
the timed path broken underneath: each fault a cell can have must turn
``correct`` false. And the correctness controls, which must fail too."""

import pytest
import torch

from portbench.tests.cells_small import run_small

torch.set_num_threads(4)

FAULTS = [("grafp-t.build", "alter_answer"), ("grafp-t.build", "roll_rows"),
          ("nafp.build", "alter_answer"), ("grafp-t.train", "state_unchanged"),
          ("grafp-t.train", "half_batch"), ("grafp-t.search", "alter_answer")]


@pytest.mark.parametrize("cell, fault", FAULTS, ids=[f"{c}-{f}" for c, f in FAULTS])
def test_a_fault_under_the_timed_path_is_not_correct(cell, fault):
    result, checks = run_small(cell, torch.device("cpu"), fault=fault)
    assert result["correct"] is False, checks


@pytest.mark.parametrize("cell", ["grafp-t.build", "nafp.build", "grafp-t.search"])
def test_the_control_is_not_correct(cell):
    result, checks = run_small(cell, torch.device("cpu"), control=True)
    assert result["correct"] is False, checks


def test_the_build_counts_the_batches_the_program_runs(tmp_path):
    """Over one pass of the pool the rows through ``embed`` are the frozen
    ``embed_batches`` count times the batch: padded_share.build reads the
    program's real batches."""
    from portbench import harness
    from portbench.work.build import Build
    from portbench.tests.cells_small import SMALL, SMALL_CALIBRATION
    from portbench.yardstick.traffic import embed_batches

    _, _, conf, traffic = harness.cell_files(harness.benchmark(), "grafp-t.build")
    conf = dict(conf, calibration_rows=SMALL_CALIBRATION)
    traffic = {**traffic, **SMALL["build"]}
    work = Build(conf, traffic, 7, torch.device("cpu"), harness.Spans(), str(tmp_path))
    work.setup()
    for _ in work.chunks:
        work.unit()
    lengths = [len(w) for w in work.pool]
    want = embed_batches(lengths, conf["config"], traffic["pack"], traffic["batch_size"],
                         traffic["bucket_s"])
    assert work.counters()["embedded_rows"] == want * traffic["batch_size"]
    work.release()


def test_the_search_bound_counts_the_reference_cells(tmp_path):
    """``bound_s`` of the search's units is counted after the check from
    the reference's cells: per request, its rows' nprobe nearest cells'
    sizes, summed."""
    import numpy as np
    from portbench import harness
    from portbench.reference import ivfpq
    from portbench.work.search import Search
    from portbench.tests.cells_small import SMALL, SMALL_CONFIG
    from portbench.yardstick.flops import BF16_OPS_S, HBM_BYTES_S

    _, _, conf, traffic = harness.cell_files(harness.benchmark(), "grafp-t.search")
    conf = dict(conf, config={**conf["config"], **SMALL_CONFIG["search"]})
    traffic = {**traffic, **SMALL["search"]}
    work = Search(conf, traffic, 5, torch.device("cpu"), harness.Spans(), str(tmp_path))
    work.setup()
    for _ in range(6):
        work.unit()
    work.release()
    work.check()
    train = torch.cat([rows for _, rows in work.chunks()])[torch.as_tensor(work.train_ids())]
    ref = ivfpq.Index(train, int(conf["config"]["n_centroids"]))
    ref.add(torch.cat([rows for _, rows in work.chunks()]))
    sizes = np.bincount(ref.cells.numpy(), minlength=ref.centroids.shape[0])
    d, want = int(conf["config"]["d"]), 0.0
    for j in work.order[2:5]:
        rows = len(work.requests[j])
        useful = sum(sizes[ref.probed(q, work.nprobe).numpy()].sum()
                     for q in torch.as_tensor(work.requests[j]))
        read = useful / rows * 64 + rows * d * 4 + rows * work.k * 12
        want += max(2 * d * useful / BF16_OPS_S, read / HBM_BYTES_S)
    assert work.late_counters(2, 5)["bound_s"] == pytest.approx(want, rel=1e-9)
    assert work.late_counters(0, 0)["bound_s"] == 0.0
