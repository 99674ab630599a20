"""Small traffic for the tests: each cell's mix cut to a size a test run
holds, the model and its widths unchanged."""

SMALL = {
    "build": {"tracks": 4, "lo_s": 2, "hi_s": 4, "batch_size": 16, "pack": 2, "check_tracks": 3},
    "train": {"pairs": 4, "pool_batches": 4, "tracks": 3, "lo_s": 2, "hi_s": 3,
              "noise_clips": 8, "irs": 4},
    "search": {"rows": 20000, "requests": 32, "check_requests": 4},
}
# the index trains on fewer rows than the configuration's at this size,
# and the weights calibrate on fewer segments
SMALL_CONFIG = {"search": {"max_nitem_train": 4096}}
SMALL_CALIBRATION = 32


def run_small(cell: str, device, seed: int = 20260918, **kw):
    """One harness run of ``cell`` at the small size on ``device``, past
    the harness's look for a card. Returns (result, checks)."""
    import portbench.work.base as base
    from portbench import harness, run

    kind = harness.cell_files(harness.benchmark(), cell)[3]["kind"]
    init = base.Work.__init__
    changes = SMALL_CONFIG.get(kind, {})

    def small_init(self, conf, *a, **k):
        conf = dict(conf, config={**conf["config"], **changes},
                    calibration_rows=SMALL_CALIBRATION)
        init(self, conf, *a, **k)

    base.Work.__init__ = small_init
    try:
        return run.run_cell(cell, seed, 0.5, False, device, traffic_changes=SMALL[kind], **kw)
    finally:
        base.Work.__init__ = init
