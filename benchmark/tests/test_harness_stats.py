"""The benchmark's arithmetic on fixed inputs: percentiles, rates, the
union of device intervals, idle gaps, spreads and the sweep's roofline."""

import pytest
import torch

from benchmark import accounting, stats, views
from benchmark.harness import Window


def test_percentile_interpolates_between_ranks():
    assert stats.percentile([1, 2, 3, 4], 50) == 2.5
    assert stats.percentile(list(range(101)), 99) == 99.0
    assert stats.percentile([5.0], 99) == 5.0
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_rate():
    assert stats.rate(700, 2.0) == 350.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_union_and_gaps_clip_and_merge():
    iv = [(0, 10), (5, 12), (20, 25), (24, 30), (40, 50)]
    assert stats.merged(iv) == [(0, 12), (20, 30), (40, 50)]
    assert stats.union_length(iv, 2, 45) == 10 + 10 + 5
    assert stats.gaps(iv, 2, 45) == [(12, 20), (30, 40)]
    assert stats.gaps([], 0, 5) == [(0, 5)]
    assert stats.union_length(iv, 60, 70) == 0


def test_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([10.0] * 6) == 0.0
    q1, q2, q3 = __import__("statistics").quantiles([1, 2, 3, 4, 5, 6], n=4)
    assert stats.spread([1, 2, 3, 4, 5, 6]) == pytest.approx((q3 - q1) / q2)


def test_window_series():
    w = Window(start=10, fed=4, refs=[10, 12], due=[0.0, 1.0, 2.0, 3.0],
               call=[0.0, 1.0, 2.0, 3.0], ret=[0.001, 1.002, 2.0005, 3.004],
               done=[0.002, 1.003, 2.010, 3.005])
    assert views.latencies_ms(w) == pytest.approx([2.0, 3.0, 10.0, 5.0])
    assert views.enqueue_ms(w) == pytest.approx([1.0, 2.0, 0.5, 4.0])
    assert views.switch_frames(w) == [0, 1, 2, 3]


def test_bound_takes_the_larger_of_bytes_and_operations():
    t, by = accounting.bound_ms(3.35e9, 0.0)
    assert (t, by) == (pytest.approx(1.0), "bytes")
    t, by = accounting.bound_ms(0.0, 67e9)
    assert (t, by) == (pytest.approx(1.0), "operations")


def test_call_work_counts_the_band_pairs_under_the_footprint():
    h, w, pad, planes, side = 8, 16, 8, 7, 3
    ref = torch.arange(h * w, dtype=torch.float32).reshape(h, w).sin()
    valid = torch.ones(h, w)
    xlim = torch.tensor([[-100.0, 100.0]] * h)
    lo = torch.full((h, w), 1.0)
    hi = torch.full((h, w), 3.0)
    out = accounting.call_work(torch.zeros(h, w + 2 * pad), xlim, ref, valid, lo, hi, 0.5,
                               planes, pad, side, True)
    # the guard needs a full valid patch: zero-padded box sums drop the
    # one-pixel ring; planes 1..3 of the band [0.5, 3.5]
    assert out["pairs"] == (h - 2) * (w - 2) * 3
    assert out["flops"] == out["pairs"] * (12 * 1 + 11)
    assert out["bytes"] == 4 * ((h * (w + 2 * pad)) + 2 * h + 6 * h * w) + h * w
    # a footprint that admits x - k >= 10 cuts the pairs of columns x < 13
    cut = accounting.call_work(torch.zeros(h, w + 2 * pad), torch.tensor([[10.0, 100.0]] * h),
                               ref, valid, lo, hi, 0.5, planes, pad, side, True)
    assert cut["pairs"] < out["pairs"]


def test_roofline_share_is_bound_over_device_time():
    from benchmark.profiling import Trace

    reader = __import__("benchmark.harness", fromlist=["reader"]).reader
    tr = Trace(device=[("void sweep_kernel<5>(float const*)", 0.0, 100.0),
                       ("void at::elementwise_kernel<4>()", 100.0, 400.0),
                       ("Memcpy HtoD (Pinned -> Device)", 400.0, 410.0),
                       ("void (anonymous namespace)::seed_update_kernel<true>(int const*)",
                        410.0, 440.0)],
               host=[], window=(0.0, 500.0), frames=2)
    w = Window(start=0, fed=700, t0=0.0, t1=1.0)
    ctx = {"trace": tr, "sweep_bound_ms": 0.005, "window": w}
    assert reader("sweep_roofline_pct.offline")(ctx) == pytest.approx(5.0)
    # the hand kernels (the sweep, the fused tail) and the copy are not plain
    assert reader("plain_kernel_ms_per_frame.offline")(ctx) == pytest.approx(0.15)
    assert reader("device_ops_per_frame.offline")(ctx) == pytest.approx(2.0)
    assert reader("sweep_roofline_pct.offline")({"trace": None}) is None
    assert reader("sweep_roofline_pct.offline")(dict(ctx, sweep_bound_ms=None)) is None
