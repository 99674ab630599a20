"""Operation, roofline and share arithmetic against counts worked by hand
at small shapes, and the trace reduction on a made-up trace."""

import types

import pytest

from portbench import harness, metrics_common
from portbench.yardstick import flops

TINY = {"arch": "grafp", "size": "t", "n_mels": 4, "peak_stride": 2, "n_frames": 4,
        "n_filters": 2, "blur_kernel": [3, 3], "k": 2, "h": 8, "d": 2, "u": 2,
        "compute_dtype": "bfloat16"}


def test_grafp_model_flops_by_hand():
    # N0 = 4 / 2 * 4 = 8 nodes; stages (8, 64), (4, 128), (2, 256), (1, 512)
    n0, f = 8, 2
    total = 2 * n0 * f * 3 * 3 * 3 + 2 * n0 * f * 64
    stages = [(8, 64, 2), (4, 128, 2), (2, 256, 6), (1, 512, 2)]
    prev = None
    for n, c, nb in stages:
        if prev:
            total += 2 * n * 3 * prev * c
        g = 2 * n * c * c + 2 * n * n * c + 2 * n * 2 * c * 2 * c // 4 + 2 * n * 2 * c * c
        total += nb * (g + 16 * n * c * c)
        prev = c
    total += 2 * 1 * 512 * 8 + 2 * (8 * 4 + 4 * 2)
    assert flops.grafp_model_flops(TINY) == total


def test_grafp_size_t_account():
    cfg = dict(TINY, n_mels=64, n_frames=32, n_filters=8, blur_kernel=[7, 7], k=3,
               h=1024, d=128, u=32)
    # scripts/flops_model.py's 7.573 GFLOP less "extract" (1.913) and the
    # log-mel (0.0672 + 0.0021)
    assert flops.grafp_model_flops(cfg) == pytest.approx(5.5913e9, rel=1e-4)


def test_nafp_model_flops_by_hand():
    cfg = {"arch": "nafp", "n_mels": 4, "n_frames": 4, "d": 2, "u": 2}
    old = flops.NAFP_CHANNELS
    flops.NAFP_CHANNELS = (3, 5)
    try:
        # stage 0: a -> (3, 4, 2) from 1 channel; b -> (3, 2, 2) from 3
        # stage 1: a -> (5, 2, 1) from 3; b -> (5, 1, 1) from 5; h = 5
        want = (2 * 3 * 4 * 2 * 1 * 3 + 2 * 3 * 2 * 2 * 3 * 3
                + 2 * 5 * 2 * 1 * 3 * 3 + 2 * 5 * 1 * 1 * 5 * 3
                + 2 * (5 * 2 * 2 + 4 * 2))
        assert flops.nafp_model_flops(cfg) == want
    finally:
        flops.NAFP_CHANNELS = old


def test_bounds_by_hand():
    # #3 forward, B=2, N=4, C=8, bf16, k=2: bytes 3*2*4*8*2 = 384 B;
    # ops 2*2*16*8 = 512 at 989e12 and 2*2*2*16 = 128 at 67e12
    b = flops.bound_ms(2, 4, 8, "bfloat16", False, 2)
    assert b == pytest.approx(1e3 * max(384 / 3.35e12, 512 / 989e12 + 128 / 67e12))
    bwd = flops.bound_ms(2, 4, 8, "bfloat16", True, 2)
    assert bwd == pytest.approx(1e3 * max(512 / 3.35e12, 512 / 989e12 + 128 / 67e12
                                          + 2 * 2 * 2 * 4 * 8 / 67e12))
    # #5: bytes 2*2*4*8*2 + 7*64*2 + 4*8*4 = 1,280; ops 2*2*4*8*(56+4) = 7,680
    blk = flops.block_bound_ms(2, 4, 8, "bfloat16", 2)
    assert blk == pytest.approx(1e3 * max(1280 / 3.35e12, 7680 / 989e12 + 128 / 67e12))


def test_known_bounds_of_the_kernel_table():
    cfg = dict(TINY, n_mels=64, n_frames=32, k=3)
    assert flops.forward_block_bounds_ms(cfg, 128) == pytest.approx(0.467, abs=5e-4)
    assert flops.step_select_bounds_ms(cfg, 512, True) == pytest.approx(1.042, abs=5e-4)


def ctx(**kw):
    base = dict(cfg=TINY, traffic={"batch_size": 4, "pairs": 2}, counters={}, traced={},
                window_s=3.0, trace=None, e2e={}, untraced={}, untraced_s=2.0)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_share_readers_by_hand():
    pad = harness.metric_reader("padded_share.build")
    assert pad(ctx(counters={"embedded_rows": 400, "rows": 300})) == pytest.approx(25.0)
    assert pad(ctx(counters={"embedded_rows": 0, "rows": 0})) is None
    # MFU: over the units the profiler did not slow (untraced, 2 s here)
    mfu = harness.metric_reader("mfu.build")
    want = 100 * flops.grafp_model_flops(TINY) * 1000 / 2.0 / 989e12
    assert mfu(ctx(untraced={"rows": 1000})) == pytest.approx(want)
    mfu_t = harness.metric_reader("mfu.train")
    assert mfu_t(ctx(untraced={"pairs": 10})) == pytest.approx(
        100 * 3 * flops.grafp_model_flops(TINY) * 20 / 2.0 / 989e12)


def made_up_trace():
    k_fwd = "void (anonymous namespace)::mrconv_rows_kernel<__nv_bfloat16, 4, false, true, false>(x)"
    k_bwd = "void (anonymous namespace)::mrconv_rows_kernel<__nv_bfloat16, 4, true, true, false>(x)"
    norm = "void (anonymous namespace)::normalize_rows_kernel<__nv_bfloat16>(x)"
    dev = [(norm, 10.0, 12.0), (k_fwd, 12.0, 20.0), ("at::vectorized_elementwise_kernel<4>", 30.0, 40.0),
           (norm, 50.0, 51.0), (k_bwd, 51.0, 60.0), ("void (anonymous namespace)::mrconv_keys_kernel<f>", 60.0, 70.0),
           ("gemm", 100.0, 110.0)]
    host = [("pb.unit", 0.0, 50.0), ("pb.unit", 50.0, 100.0), ("train_step", 20.0, 30.0)]
    return harness.Trace(dev, host, "pb.unit")


def test_trace_reduction_by_hand():
    tr = made_up_trace()
    assert tr.window_s == pytest.approx(100e-6)
    # the gemm starts at the window's end and is left out
    assert tr.busy_s == pytest.approx((10 + 10 + 20) * 1e-6)
    assert tr.time_s(harness.is_elementwise) == pytest.approx(10e-6)
    gaps = dict(tr.idle_gaps())
    assert gaps["pb.unit"] == pytest.approx((10 + 10 + 30) * 1e-6)
    assert gaps["train_step"] == pytest.approx(10e-6)
    assert metrics_common.selection_time_s(tr, backward=False) == pytest.approx(10e-6)
    assert metrics_common.selection_time_s(tr, backward=True) == pytest.approx(20e-6)


def test_roofline_readers_on_the_made_up_trace():
    tr = made_up_trace()
    fwd = harness.metric_reader("mrconv_concat_fwd_roofline")
    want = 100 * 3 * flops.step_select_bounds_ms(TINY, 4, False) / 1e3 / 10e-6
    assert fwd(ctx(trace=tr, traced={"units": 3})) == pytest.approx(want)
    assert fwd(ctx(trace=tr, traced={"units": 0})) is None
    idle = harness.metric_reader("device_idle.train")
    assert idle(ctx(trace=tr)) == pytest.approx(60.0)


@pytest.mark.parametrize("raw, want", [
    ("void (anonymous namespace)::mrconv_rows_kernel<float, 4, false>(float const*, int)",
     "mrconv_rows_kernel<float, 4, false>"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_bias_TNT", "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_bias_TNT"),
    ("void at::native::vectorized_elementwise_kernel<4, F>(int, F)", "at::native::vectorized_elementwise_kernel<4, F>"),
])
def test_short_names(raw, want):
    assert harness.short_name(raw) == want


def test_selection_kind_reads_the_backward_template_argument():
    assert metrics_common.selection_kind(
        "void (anonymous namespace)::mrconv_rows_kernel<__nv_bfloat16, 4, true, false, true>(x)") == "bwd"
    assert metrics_common.selection_kind(
        "void (anonymous namespace)::mrconv_rows_kernel<float, 8, false, true, false>(x)") == "fwd"
    assert metrics_common.selection_kind("void (anonymous namespace)::mrconv_keys_kernel<float>(x)") == "bwd"
    assert metrics_common.selection_kind("gemm") is None


def test_scan_readers_by_hand():
    roof = harness.metric_reader("scan_roofline")
    tr = made_up_trace()
    assert roof(ctx(trace=tr, traced={"bound_s": 4e-6})) == pytest.approx(10.0)
    assert roof(ctx(trace=tr, traced={"bound_s": 0.0})) is None
