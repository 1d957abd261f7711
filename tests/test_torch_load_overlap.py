"""Engine.load_all builds each streamed item as it arrives (PyTorch port).

The bulk path hands every item to build_many (`ingest_chunk`) as the stream
yields it, before it takes the next: the card builds while the file still
streams. These tests hold it to the load it replaces, written here as the
reference: drain the whole stream, concatenate the items, one build_many.
Every state tensor, the device reads and the capacity flag are equal, over
one-, two- and four-step items, with the voxel store compacted mid-load.
They count the `load.item` spans against the items consumed, and the
`load.item_overlapped` spans against a stream held back before its last
plane set and against a consumer held back until the stream queued it.

The card's case (the `cuda` marker; `pytest tests/test_torch_load_overlap.py
-m cuda --noconftest`) runs the same equality with the pinned ring, the
side-stream copies and the build graphs.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from simlod_tpu_torch.config import EngineConfig, Settings
from simlod_tpu_torch.engine import Engine
from simlod_tpu_torch.formats import simlod, synthetic
from simlod_tpu_torch.io.streaming import PointStream
from simlod_tpu_torch.octree import build
from simlod_tpu_torch.octree.structures import OctreeState
from simlod_tpu_torch.utils import trace

torch.set_num_threads(1)

B = 1 << 13
N = 40_000          # 5 steps of B points
KW = dict(cand_multi_rows=1 << 12, node_capacity=1 << 12,
          point_capacity=1 << 17, voxel_capacity=1 << 16,
          segment_capacity=1 << 14, step_points=B, spill_capacity=1 << 13,
          max_splits_per_round=64, cascade_splits_per_round=16,
          seg_select_cap=1 << 10, max_points_per_node=256,
          max_render_points=1 << 17, max_render_voxels=1 << 17)
# low enough that build_many compacts the voxel store mid-load
LOW_WATERMARK = dict(voxel_compact_watermark=0.25)
WAIT_S = 60.0


@pytest.fixture(scope="module")
def scan(tmp_path_factory):
    """Tight clusters on a sparse terrain: deep splits in a few places."""
    xyz, rgba = synthetic.clustered(N, seed=5, extent=1.0)
    path = str(tmp_path_factory.mktemp("overlap") / "clusters.simlod")
    simlod.write(path, xyz.astype(np.float32), rgba)
    return path


def _items(chunk_steps: int) -> int:
    steps = -(-N // B)
    return -(-steps // chunk_steps)


def _drained_load(eng: Engine) -> None:
    """The bulk load_all this port had before items were built as they
    arrive: the whole stream drained, its items concatenated, one
    build_many, then the end-of-load splits and the capacity read."""
    items = list(eng._stream_iter)
    eng._consumed_chunks += len(items)
    eng.last_batch_finished = True
    planes = [torch.cat([it[i] for it in items]) for i in range(4)]
    counts = np.concatenate([it[4] for it in items])
    del items
    eng.ingest_chunk((*planes, counts), sync=False)
    eng._splits_finished = True
    eng.finish_splits()
    eng._capacity_flag = bool(eng._read(
        "engine.capacity", [eng.state.mem_capacity_reached])[0])
    eng._steps_since_poll = 0


def _load(device, path, kw, chunk_steps, load):
    eng = Engine(EngineConfig(**kw), Settings(), device=device)
    eng.open([path], chunk_steps=chunk_steps)
    load(eng)
    eng.stream.stop()
    return eng


def _assert_states_equal(a: OctreeState, b: OctreeState):
    for f in dataclasses.fields(OctreeState):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.shape == y.shape and x.dtype == y.dtype, f.name
        assert torch.equal(x.cpu(), y.cpu()), f.name


@pytest.fixture
def device(request):
    if request.param == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device (pinned ring, side-stream "
                        "copies and build graphs)")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(request.param)


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)], indirect=True)
@pytest.mark.parametrize("chunk_steps,kw", [
    (1, KW), (2, dict(KW, **LOW_WATERMARK)), (4, dict(KW, **LOW_WATERMARK))],
    ids=["one-step", "two-step-compacting", "four-step-compacting"])
def test_the_bulk_load_equals_one_build_over_the_drained_stream(
        scan, device, chunk_steps, kw):
    got = _load(device, scan, kw, chunk_steps, lambda e: e.load_all())
    want = _load(device, scan, kw, chunk_steps, _drained_load)
    _assert_states_equal(got.state, want.state)
    assert got._consumed_chunks == want._consumed_chunks \
        == _items(chunk_steps)
    assert (got.steps, got.host_syncs, got._capacity_flag) == (
        want.steps, want.host_syncs, want._capacity_flag)
    assert got.last_batch_finished and got._splits_finished
    if kw is not KW:
        assert int(want.state.vox_compacted) > 0


@pytest.mark.parametrize("chunk_steps", [1, 2])
def test_the_bulk_load_builds_each_item_before_taking_the_next(
        monkeypatch, scan, chunk_steps):
    """One build_many call per item, one-step items too (never build_step
    alone, which does not compact at the watermark), each made before the
    stream's iterator is exhausted."""
    real = build.build_many
    calls = []      # (steps in the call, the stream exhausted at the call)
    seen = dict(exhausted=False)

    def build_many(cfg, state, bx, *args, **kw):
        calls.append((bx.shape[0], seen["exhausted"]))
        return real(cfg, state, bx, *args, **kw)

    def ingest(*args, **kw):
        raise AssertionError("a bulk load built a step outside build_many")

    monkeypatch.setattr(build, "build_many", build_many)
    eng = Engine(EngineConfig(**KW), Settings(), device="cpu")
    monkeypatch.setattr(eng, "ingest", ingest)
    eng.open([scan], chunk_steps=chunk_steps)
    inner = eng._stream_iter

    def tracked():
        yield from inner
        seen["exhausted"] = True

    eng._stream_iter = tracked()
    eng.load_all()
    eng.stream.stop()
    assert seen["exhausted"]
    assert len(calls) == eng._consumed_chunks == _items(chunk_steps) > 1
    assert calls == [(chunk_steps, False)] * len(calls)


@pytest.mark.parametrize("bulk", [True, False])
def test_a_load_item_span_for_each_item_consumed(scan, bulk):
    snap = trace.snapshot()
    eng = _load("cpu", scan, KW, 2, lambda e: e.load_all(bulk=bulk))
    d = trace.since(snap)
    assert d["load.item"]["count"] == eng._consumed_chunks == _items(2)
    assert d["load.item"]["seconds"] <= d["engine.load_all"]["seconds"]
    assert eng.stream.t_last_queued is not None


def test_items_built_while_the_stream_holds_its_last_plane_set_overlap(
        monkeypatch, scan):
    """The uploader holds the last plane set back until the item before it
    is built: every item but the last was dispatched before the last set
    was queued."""
    n = _items(2)
    built = threading.Event()
    placed = []
    real_place = PointStream._place

    def place(self, planes):
        placed.append(len(placed))
        if len(placed) == n:
            assert built.wait(WAIT_S), "the consumer never built item n-2"
        return real_place(self, planes)

    real_ingest = Engine.ingest_chunk
    done = []

    def ingest_chunk(self, item, sync=True):
        real_ingest(self, item, sync=sync)
        done.append(1)
        if len(done) == n - 1:
            built.set()

    monkeypatch.setattr(PointStream, "_place", place)
    monkeypatch.setattr(Engine, "ingest_chunk", ingest_chunk)
    snap = trace.snapshot()
    eng = _load("cpu", scan, KW, 2, lambda e: e.load_all())
    d = trace.since(snap)
    assert len(placed) == len(done) == n > 2
    assert d["load.item"]["count"] == n
    assert d["load.item_overlapped"]["count"] == n - 1


def test_items_taken_after_the_last_plane_set_queued_do_not_overlap(scan):
    """The consumer takes its first item only once the uploader has queued
    the stream's last plane set: no item overlapped the stream."""
    eng = Engine(EngineConfig(**KW), Settings(), device="cpu")
    eng.open([scan], chunk_steps=2)
    inner = eng._stream_iter

    def late():
        deadline = time.monotonic() + WAIT_S
        while eng.stream.t_last_queued is None:
            assert time.monotonic() < deadline, "the stream never ended"
            time.sleep(0.001)
        yield from inner

    eng._stream_iter = late()
    snap = trace.snapshot()
    eng.load_all()
    eng.stream.stop()
    d = trace.since(snap)
    assert d["load.item"]["count"] == eng._consumed_chunks == _items(2)
    assert "load.item_overlapped" not in d
