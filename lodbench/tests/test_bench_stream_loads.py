"""The simultaneous loads (traffic/stream_loads.py) and the readers of
their frames: each reader on hand-made per-load records, silent on a
program without frame spans or counters, and each reading the loads of a
run of las73m.stream shrunk to the CPU."""
import pytest
import torch

import small
from lodbench import data
from lodbench import reference as ref
from lodbench import run as R
from lodbench.loops import loop_class

READERS = ("frame.fused_ms.stream", "frame.redrawn_pct.stream",
           "frame.tail_rows_per_frame.stream")


def spans(fused, fused_s, redraws, frames):
    t = lambda c, s: dict(count=c, seconds=s, sync_s=0.0)
    out = {"engine.frame": t(frames, 1.0), "frame.fused": t(fused, fused_s)}
    if redraws:
        out["frame.redraw"] = t(redraws, 0.001 * redraws)
    return out


def rec():
    """Two loads: 12 frames (10 fused, 0.6 s of them, 1 redraw, 2.0M tail
    rows drawn) and 14 frames (12 fused, 0.9 s, no redraw, 4.6M rows)."""
    load = lambda frames, fused, s, redraws, rows: dict(
        points=73e6, seconds=1.0, frames=frames, steps=37, host_syncs=300,
        fused_frames=fused, redraws=redraws, tail_rows=rows,
        frame_s=[0.05] * frames, spans=spans(fused, s, redraws, frames))
    return dict(window=dict(loads=[load(12, 10, 0.6, 1, 2.0e6),
                                   load(14, 12, 0.9, 0, 4.6e6)],
                            window_s=2.0, points=146e6))


@pytest.mark.parametrize("name,value", [
    ("frame.fused_ms.stream", 1e3 * 1.5 / 22),
    ("frame.redrawn_pct.stream", 100 * 1 / 26),
    ("frame.tail_rows_per_frame.stream", 6.6e6 / 22),
    ("load_mps", 73.0)])
def test_reader(name, value):
    assert R.metric_module(name).read(rec()) == pytest.approx(value)


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_frame_spans_or_counters_reads_nothing(name):
    """The parent of the frame spans: span totals of its own, but none of
    the frame's, and no redraw or tail counters."""
    r = rec()
    for x in r["window"]["loads"]:
        x["spans"] = {"build.step": dict(count=37, seconds=0.5, sync_s=0.1)}
        x["redraws"] = x["tail_rows"] = None
    assert R.metric_module(name).read(r) is None
    for x in r["window"]["loads"]:
        x["spans"] = None
    assert R.metric_module(name).read(r) is None


def test_each_load_reports_its_frames_counters_and_spans():
    """A run of the cell on the CPU: it is correct, each load of the window
    returns its own counters and span totals, and every reader finds what
    it reads in them."""
    out = small.small_run("las73m.stream", seconds=0.3)
    assert out["correct"] is True, out["checks"]
    assert loop_class("stream_loads").__name__ == "StreamLoadsLoop"
    cell = small.small_cell("las73m.stream", trace=True)
    assert {m["name"] for m in cell.metrics} == set(READERS)


def _loop(tmp_path):
    """The cell's loop on the CPU over a 150,000-point scan, set up."""
    cell = small.small_cell("las73m.stream")
    device = torch.device("cpu")
    path = data.make_scan(cell.config, 7, device, str(tmp_path), 150_000)
    ctx = R.Ctx(device=device, path=path,
                extent=ref.scan_extent(path, cell.config["format"]),
                traffic=cell.traffic, seed=7, width=320, height=180,
                settings=R.settings_of(cell.config), points=150_000,
                engine_cfg=small.small_cfg())
    loop = loop_class(cell.traffic["loop"])(ctx)
    loop.setup()
    return loop


def test_a_load_that_keeps_no_frame_moves_the_frame_kept_next(tmp_path):
    """Where no frame at or after the one drawn from the seed could be
    checked in a load, the next load keeps one from the frames that could
    be: the run is never left with no fused frame checked."""
    loop = _loop(tmp_path)
    try:
        loop.copy_at = 10 ** 6
        loop.window(0.0)
        assert loop.kept is None and loop.copy_at < 10 ** 6
        loop.window(0.0)
        assert loop.kept is not None
    finally:
        loop.eng.stream.stop()


def test_the_window_holds_per_load_records(tmp_path):
    """The loop's window on the CPU: a list of loads, each with its spans
    taken around that load alone."""
    loop = _loop(tmp_path)
    try:
        w = loop.window(0.0)
    finally:
        loop.eng.stream.stop()
    (x,) = w["loads"]
    assert x["points"] == w["points"] == 150_000
    s = x["spans"]
    assert s["engine.frame"]["count"] == x["frames"] == len(x["frame_s"])
    assert s["frame.fused"]["count"] == x["fused_frames"] > 0
    assert s["engine.open"]["count"] == 1
    assert x["tail_rows"] > 0 and x["redraws"] >= 0
    for name in READERS:
        assert R.metric_module(name).read(dict(window=w)) is not None, name
