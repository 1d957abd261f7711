"""The reader of build.replayed_pct.load: on hand-made span totals, silent
on a program without spans or without the build's stretch spans, and
reading a load cell's run shrunk to the CPU (where no stretch replays)."""
import sys

import pytest

import small
from lodbench import run as R
from lodbench import spans

NAME = "build.replayed_pct.load"


def totals(**counts):
    t = lambda c: dict(count=c, seconds=0.001 * c, sync_s=0.0)
    out = {"engine.open": t(2), "engine.load_all": t(2)}
    out.update({k.replace("_", "."): t(c) for k, c in counts.items()})
    return out


@pytest.mark.parametrize("counts,value", [
    (dict(build_replay=380, build_capture=8, build_eager=12), 95.0),
    (dict(build_replay=400), 100.0),
    (dict(build_eager=50), 0.0),
    (dict(build_capture=8, build_replay=24), 75.0)])
def test_reader(monkeypatch, counts, value):
    monkeypatch.setattr(spans, "totals", lambda: totals(**counts))
    assert R.metric_module(NAME).read({}) == pytest.approx(value)


def test_a_program_without_stretch_spans_reads_nothing(monkeypatch):
    """The parent: spans, but none of the build's stretches."""
    monkeypatch.setattr(spans, "totals", lambda: totals())
    assert R.metric_module(NAME).read({}) is None


def test_a_program_without_spans_reads_nothing(monkeypatch):
    import simlod_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "simlod_tpu_torch.utils.trace", None)
    assert R.metric_module(NAME).read({}) is None


def test_the_reader_reads_a_runs_own_spans():
    """A load cell on the CPU: every stretch runs eagerly."""
    out = small.small_run("simlod36m.load", seconds=0.3)
    assert out["correct"]
    assert R.metric_module(NAME).read({}) == 0.0
