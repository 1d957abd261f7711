"""The port's spans and device reads (simlod_tpu_torch/utils/trace.py), and
where the load path places them (PyTorch port, on the CPU)."""
import sys
import threading
import time

import pytest
import torch

from simlod_tpu_torch.config import EngineConfig, Settings
from simlod_tpu_torch.engine import Engine
from simlod_tpu_torch.formats import simlod, synthetic
from simlod_tpu_torch.utils import trace

torch.set_num_threads(1)

# the golden fixture's config (tests/test_torch_syncs.py)
KW = dict(candidate_factor=21, cand_multi_rows=1 << 13,
          node_capacity=1 << 12, point_capacity=1 << 17, voxel_capacity=1 << 19,
          segment_capacity=1 << 14, step_points=1 << 13, spill_capacity=1 << 13,
          max_splits_per_round=64, seg_select_cap=1 << 10,
          max_points_per_node=256, max_render_points=1 << 17,
          max_render_voxels=1 << 17)


def test_span_totals_nest_and_sync_s_counts_only_reads():
    snap = trace.snapshot()
    with trace.span("t1.outer"):
        with trace.span("t1.inner"):
            time.sleep(0.01)
            assert trace.sync("t1.read", torch.arange(4).sum()) == 6
        with trace.span("t1.inner"):
            pass
        assert trace.open_spans()[-1] == "t1.outer"
    d = trace.since(snap)
    outer, inner, read = d["t1.outer"], d["t1.inner"], d["sync.t1.read"]
    assert (outer["count"], inner["count"], read["count"]) == (1, 2, 1)
    assert outer["seconds"] >= inner["seconds"] >= 0.01
    assert inner["seconds"] > read["seconds"] > 0
    # a read is all sync; its time counts in every span around it
    assert read["sync_s"] == pytest.approx(read["seconds"])
    assert outer["sync_s"] == pytest.approx(read["seconds"])
    assert inner["sync_s"] == pytest.approx(read["seconds"])
    assert trace.since(trace.snapshot()) == {}


def test_reads_counts_every_sync():
    n = trace.reads()
    assert trace.sync("t2.read", torch.tensor([1, 2])) == [1, 2]
    assert trace.sync("t2.read", torch.tensor(True)) is True
    assert trace.reads() == n + 2


def test_an_exception_closes_the_spans_and_keeps_the_totals():
    snap = trace.snapshot()
    with pytest.raises(ValueError):
        with trace.span("t3.outer"):
            # a span entered but never left closes with the one around it
            trace.span("t3.left_open").__enter__()
            with trace.span("t3.inner"):
                trace.sync("t3.read", torch.tensor(1))
                raise ValueError("inside")
    assert trace.open_spans() == ()
    d = trace.since(snap)
    assert d["t3.outer"]["count"] == d["t3.inner"]["count"] == 1
    assert "t3.left_open" not in d
    assert d["t3.outer"]["sync_s"] == pytest.approx(
        d["sync.t3.read"]["seconds"])
    with trace.span("t3.after"):
        assert trace.open_spans() == ("t3.after",)


def test_span_stacks_are_per_thread_and_totals_add_from_threads():
    """More threads than cores add to one total with a short switch
    interval: no add is lost, and no thread sees another's spans."""
    n_threads, n_spans = 16, 300
    seen, errors = set(), []
    interval = sys.getswitchinterval()
    snap = trace.snapshot()

    def work(i):
        try:
            for _ in range(n_spans):
                with trace.span("t4.span"):
                    with trace.span(f"t4.thread{i}"):
                        seen.add(trace.open_spans())
        except Exception as e:      # reported below, in the test's thread
            errors.append(e)

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    d = trace.since(snap)
    assert d["t4.span"]["count"] == n_threads * n_spans
    assert seen == {("t4.span", f"t4.thread{i}") for i in range(n_threads)}
    assert trace.open_spans() == ()


def test_add_puts_an_interval_of_another_thread_on_the_totals():
    """`add` takes an interval measured across threads (the stream's time
    to its first item) into the same totals and an `into` Timings, and
    leaves every thread's span stack alone."""
    snap = trace.snapshot()
    into = trace.Timings()
    t0 = time.perf_counter()
    th = threading.Thread(target=lambda: trace.add(
        "t7.interval", time.perf_counter() - t0, into=into))
    th.start()
    th.join(timeout=10)
    assert not th.is_alive()
    trace.add("t7.interval", 0.5, sync=0.25)
    d = trace.since(snap)["t7.interval"]
    assert d["count"] == 2 and d["sync_s"] == pytest.approx(0.25)
    assert d["seconds"] == pytest.approx(0.5 + into.total)
    assert into.count == 1 and trace.open_spans() == ()


def test_no_record_function_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with trace.span("t5.span"):
        trace.sync("t5.read", torch.tensor(2))


def test_spans_are_user_annotations_under_the_profiler():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("t6.outer"):
            trace.sync("t6.read", torch.arange(3).sum())
    names = {e.name() for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()}
    assert {"t6.outer", "sync.t6.read"} <= names


@pytest.fixture(scope="module")
def cloud(tmp_path_factory):
    xyz, rgba = synthetic.terrain(60_000, seed=23, extent=1.0, z_scale=0.4)
    path = str(tmp_path_factory.mktemp("trace") / "golden.simlod")
    simlod.write(path, xyz, rgba)
    return path


LOAD_SPANS = {"engine.open", "open.config", "open.stream", "open.state",
              "engine.load_all", "stream.wait", "stream.stage",
              "stream.first_item",
              "build.many", "build.step", "build.route", "build.split",
              "build.voxels", "build.insert", "build.finish"}


@pytest.mark.parametrize("bulk", [True, False])
def test_a_load_is_traced(monkeypatch, cloud, bulk):
    """Engine.open (sizing its config, as the app's engine does) +
    load_all: every device read is a `sync.<site>` and they add up to
    host_syncs; one build.step span per step; the phases of the load are
    there, with one load.item span per streamed item on either path (the
    bulk path drains and concatenates nothing)."""
    monkeypatch.setattr(EngineConfig, "auto",
                        classmethod(lambda cls, **kw: cls(**KW)))
    eng = Engine(None, Settings(), device="cpu")
    snap = trace.snapshot()
    eng.open([cloud])
    eng.load_all(bulk=bulk)
    d = trace.since(snap)
    syncs = {k: v["count"] for k, v in d.items() if k.startswith("sync.")}
    assert sum(syncs.values()) == eng.host_syncs > 0
    assert {"sync.build.spill", "sync.build.split_round",
            "sync.build.cand_rounds", "sync.build.vox_used",
            "sync.engine.overfull", "sync.engine.capacity"} <= set(syncs)
    assert d["build.step"]["count"] == eng.steps == -(-60_000 // (1 << 13))
    assert LOAD_SPANS <= set(d)
    assert d["load.item"]["count"] == eng._consumed_chunks > 1
    assert not {"load.drain", "load.concat"} & set(d)
    # the stream's last item is never built before its own plane set queued
    overlapped = d.get("load.item_overlapped", dict(count=0))["count"]
    assert overlapped < eng._consumed_chunks
    assert d["stream.wait"]["count"] >= eng._consumed_chunks
    parts = sum(d[n]["seconds"] for n in ("open.config", "open.stream",
                                          "open.state"))
    assert parts <= d["engine.open"]["seconds"]
    st = eng.stream.stats()
    assert set(st) == {"points_loaded", "bytes_read", "laz_chunks",
                       "staged_rows", "t_decode", "stage_s", "wait_s"}
    assert st["points_loaded"] == 60_000 and st["laz_chunks"] == 0
    assert st["staged_rows"] == 0
    assert st["stage_s"] == pytest.approx(d["stream.stage"]["seconds"],
                                          abs=1e-3)
    assert st["wait_s"] == pytest.approx(d["stream.wait"]["seconds"],
                                         abs=1e-3)
