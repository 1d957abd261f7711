"""The reader of build.overlapped_pct.load: on hand-made span totals,
silent on a program without spans or without the `load.item` spans, and
reading a load cell's run shrunk to the CPU."""
import sys

import pytest

import small
from lodbench import run as R
from lodbench import spans

NAME = "build.overlapped_pct.load"


def totals(**counts):
    t = lambda c: dict(count=c, seconds=0.001 * c, sync_s=0.0)
    out = {"engine.open": t(2), "engine.load_all": t(2)}
    out.update({k.replace("_", ".", 1): t(c) for k, c in counts.items()})
    return out


@pytest.mark.parametrize("counts,value", [
    (dict(load_item=10, load_item_overlapped=6), 60.0),
    (dict(load_item=5, load_item_overlapped=4), 80.0),
    (dict(load_item=12), 0.0),
    (dict(load_item=1, load_item_overlapped=0), 0.0)])
def test_reader(monkeypatch, counts, value):
    monkeypatch.setattr(spans, "totals", lambda: totals(**counts))
    assert R.metric_module(NAME).read({}) == pytest.approx(value)


def test_a_program_without_load_item_spans_reads_nothing(monkeypatch):
    """A program whose bulk load drains the stream before it builds:
    spans, but no `load.item`."""
    monkeypatch.setattr(spans, "totals", lambda: totals(load_drain=2))
    assert R.metric_module(NAME).read({}) is None


def test_a_program_without_spans_reads_nothing(monkeypatch):
    import simlod_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "simlod_tpu_torch.utils.trace", None)
    assert R.metric_module(NAME).read({}) is None


def test_the_reader_reads_a_runs_own_spans():
    """A load cell on the CPU: a share of the items, the last of each load
    never among them."""
    out = small.small_run("simlod36m.load", seconds=0.3)
    assert out["correct"]
    t = spans.totals()
    assert t["load.item"]["count"] >= 2
    assert 0.0 <= R.metric_module(NAME).read({}) < 100.0
