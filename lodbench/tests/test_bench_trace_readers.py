"""The readers of the load's phases: each on a hand-made record and span
totals, silent on a program without spans, and each reading the program's
own totals after a load cell's run shrunk to the CPU."""
import sys

import pytest

import small
from lodbench import run as R
from lodbench import spans

READERS = ("streaming.wait_pct.load", "streaming.stage_ms_per_mp",
           "build.sync_wait_pct.load", "build.host_ms_per_step",
           "engine.open_ms")


def totals():
    """Two loads of 36M points: 0.1 s of open and 2.9 s of load_all in all,
    0.6 s of it waiting on the stream and 0.45 s in device reads; 36 build
    steps of 0.06 s, 0.012 s of it in reads; 1.8 s of uploader staging."""
    t = lambda c, s, y=0.0: dict(count=c, seconds=s, sync_s=y)
    return {"engine.open": t(2, 0.1), "engine.load_all": t(2, 2.9, 0.45),
            "stream.wait": t(40, 0.6), "stream.stage": t(100, 1.8),
            "build.step": t(36, 2.16, 0.432),
            "sync.build.vox_used": t(36, 0.2, 0.2)}


def rec():
    return dict(window=dict(loads=[dict(points=36e6, seconds=1.5)] * 3,
                            window_s=4.5))


@pytest.mark.parametrize("name,value", [
    ("streaming.wait_pct.load", 100 * 0.6 / 3.0),
    ("streaming.stage_ms_per_mp", 1800 / 72),
    ("build.sync_wait_pct.load", 100 * 0.45 / 3.0),
    ("build.host_ms_per_step", 1e3 * (2.16 - 0.432) / 36),
    ("engine.open_ms", 50.0)])
def test_reader(monkeypatch, name, value):
    monkeypatch.setattr(spans, "totals", totals)
    assert R.metric_module(name).read(rec()) == pytest.approx(value)


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_spans_reads_nothing(monkeypatch, name):
    """The parent of the program's spans has no trace module."""
    import simlod_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "simlod_tpu_torch.utils.trace", None)
    assert spans.totals() is None
    assert R.metric_module(name).read(rec()) is None


def test_the_readers_read_a_runs_own_spans():
    """A load cell's run on the CPU: every reader finds its spans, and the
    loads' phases lie within the loads."""
    from simlod_tpu_torch.utils import trace
    snap = trace.snapshot()
    out = small.small_run("simlod36m.load", seconds=0.3)
    assert out["correct"]
    d = trace.since(snap)
    r = dict(window=dict(loads=[dict(points=150_000)]))
    values = {}
    for name in READERS:
        values[name] = R.metric_module(name).read(r)
        assert values[name] is not None and values[name] > 0, name
    # the process's totals hold this run's loads
    assert d["engine.load_all"]["count"] >= 2
    assert values["streaming.wait_pct.load"] < 100
    assert values["build.sync_wait_pct.load"] < 100
