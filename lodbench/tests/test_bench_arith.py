"""The metric arithmetic: window rates, the 95th percentile over all
frames, idle shares, the roofline bytes, and each reader on a record."""
import pytest

from lodbench import arith
from lodbench import run as R


def test_p95_is_the_nearest_rank():
    assert arith.p95(range(1, 101)) == 95
    assert arith.p95([5.0]) == 5.0
    assert arith.p95([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
                      16, 17, 18, 19, 100]) == 19
    assert arith.p95([3, 1, 2]) == 3


def test_rates_and_shares():
    assert arith.rate(36e6, 2.0) == 18e6
    assert arith.idle_pct(0.25, 1.0) == pytest.approx(75.0)
    # a 1080p frame of 5M drawn samples: 80 MB + 16.6 MB
    assert arith.splat_bytes(5_000_000, 1920 * 1080) == 96_588_800
    # 3.35 GB at 3.35 TB/s is 1 ms: 1 ms of device time is the roofline
    assert arith.roofline_pct(3.35e9, 1e-3) == pytest.approx(100.0)


def rec():
    loads = [dict(points=36e6, seconds=1.2, host_syncs=120, t_decode=0.3),
             dict(points=36e6, seconds=1.3, host_syncs=124, t_decode=0.5)]
    return dict(setup_s=30.0, settings=dict(use_high_quality_shading=True),
                window=dict(loads=loads, window_s=2.5, points=73e6,
                            frame_s=[0.001] * 19 + [0.01], steps=60,
                            frames=40, captures=2),
                stretch=dict(frames=10, drawn=50_000_000,
                             pixels=10 * 1920 * 1080),
                trace=dict(busy_s=0.4, window_s=1.0, kernels=dict(
                    raster=dict(seconds=0.005, launches=40))))


@pytest.mark.parametrize("name,value", [
    ("setup_s", 30.0), ("load_mps", 72 / 2.5), ("frame_ms", 2.5 / 20 * 1e3),
    ("stream_mps", 73 / 2.5), ("stream_frame_p95_ms", 1.0),
    ("streaming.decode_ms_per_mp", 800 / 72),
    ("build.host_syncs_per_load", 122.0), ("loop.batches_per_frame", 1.5),
    ("graph.captures_per_kframe", 100.0), ("render.frame_p95_ms", 1.0),
    ("splat.roofline_pct", 100 * (965_888_000 / 3.35e12) / 0.005),
    ("device.idle_pct.load", 60.0), ("device.idle_pct.frame", 60.0),
    ("device.idle_pct.stream", 60.0)])
def test_reader(name, value):
    assert R.metric_module(name).read(rec()) == pytest.approx(value)


def test_roofline_is_silent_when_the_trace_lacks_launches():
    r = rec()
    r["trace"]["kernels"]["raster"]["launches"] = 39
    assert R.metric_module("splat.roofline_pct").read(r) is None
