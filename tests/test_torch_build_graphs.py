"""The build step's stretches as CUDA graphs (graphs.BuildGraphs).

On the CPU (no card, no graph): the cache with the injected recorder of
tests/graph_fakes.py, whose "graph" runs the recorded stretch again at each
replay, so a replayed build
reads and writes exactly the tensors a real graph would have frozen (the
state's, the input columns and the slots). It holds the replayed build_many
equal to the eager one on every state column, over clustered points whose
steps take several cascade and candidate rounds, a step with no spill, a
count-0 padding step and an in-loop compaction; counts one capture per key
and replays after it; a replaced state column and the two spill variants
give keys of their own; every stretch passes exactly one of the spans
build.eager / build.capture / build.replay; the in-place reset keeps every
tensor and equals init_state; and an Engine's second open + load_all
captures nothing and builds a fresh engine's octree.

On the card (the `cuda` marker; `pytest tests/test_torch_build_graphs.py -m
cuda --noconftest`): the same equalities with real graphs.
"""
import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from simlod_tpu_torch.config import EngineConfig, Settings
from simlod_tpu_torch.engine import Engine
from simlod_tpu_torch.formats import simlod, synthetic
from simlod_tpu_torch.graphs import BuildGraphs
from simlod_tpu_torch.octree import build
from simlod_tpu_torch.octree.structures import (OctreeState, init_state,
                                                reset_state)
from simlod_tpu_torch.utils import trace

from graph_fakes import FakeRecord

# six test processes share the machine in the tier-1 run; these small tensors
# gain nothing from intra-op threads, which would oversubscribe the cores
torch.set_num_threads(1)

B = 1 << 13
KW = dict(cand_multi_rows=1 << 12, node_capacity=1 << 12,
          point_capacity=1 << 17, voxel_capacity=1 << 16,
          segment_capacity=1 << 14, step_points=B, spill_capacity=1 << 13,
          max_splits_per_round=64, cascade_splits_per_round=16,
          seg_select_cap=1 << 10, max_points_per_node=256,
          max_render_points=1 << 17, max_render_voxels=1 << 17)
# low enough that build_many compacts the voxel store mid-load
LOW_WATERMARK = dict(voxel_compact_watermark=0.25)
STRETCHES = ("route", "gather", "round", "leaves", "cand_round", "insert")


def _cloud(n=40_000, seed=5):
    """Tight clusters on a sparse terrain: deep splits in a few places."""
    xyz, rgba = synthetic.clustered(n, seed=seed, extent=1.0)
    return xyz.astype(np.float32), rgba


def _planes(xyz, rgba, device, pad_steps=1):
    """[K, B] planes of the cloud, then `pad_steps` steps of count 0."""
    K = -(-len(xyz) // B) + pad_steps
    cols = np.zeros((4, K, B), np.float32)
    cc = np.zeros((K, B), np.uint32)
    counts = np.zeros(K, np.int32)
    for k in range(K):
        chunk = xyz[k * B:(k + 1) * B]
        cols[:3, k, :len(chunk)] = chunk.T
        cc[k, :len(chunk)] = rgba[k * B:(k + 1) * B]
        counts[k] = len(chunk)
    t = lambda a: torch.from_numpy(a).to(device)
    return (t(cols[0]), t(cols[1]), t(cols[2]),
            t(cc.view(np.int32)), counts)


def _box(xyz):
    return np.zeros(3, np.float32), np.maximum(xyz.max(0), 1e-3)


def _assert_states_equal(a: OctreeState, b: OctreeState):
    for f in dataclasses.fields(OctreeState):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.shape == y.shape and x.dtype == y.dtype, f.name
        assert torch.equal(x.cpu(), y.cpu()), f.name


def _build(cfg, xyz, rgba, device, graphs=None, state=None):
    lo, hi = _box(xyz)
    if state is None:
        state = init_state(cfg, lo, hi, device=device)
    else:
        assert reset_state(state, cfg, lo, hi)
    snap = trace.snapshot()
    state = build.build_many(cfg, state, *_planes(xyz, rgba, device),
                             graphs=graphs)
    return state, trace.since(snap)


@pytest.fixture(scope="module")
def cloud():
    return _cloud()


@pytest.fixture(scope="module")
def replayed(cloud):
    """The eager build, and two builds through one fake-captured cache over
    the same state tensors (reset in place between them)."""
    cfg = EngineConfig(**KW, **LOW_WATERMARK)
    xyz, rgba = cloud
    eager, eager_spans = _build(cfg, xyz, rgba, "cpu")
    graphs = BuildGraphs(record=FakeRecord(), device_type="cpu")
    first, first_spans = _build(cfg, xyz, rgba, "cpu", graphs)
    captures = dict(graphs.captures)
    second, second_spans = _build(cfg, xyz, rgba, "cpu", graphs, state=first)
    return dict(cfg=cfg, eager=eager, graphs=graphs, first=first,
                captures=captures, second=second, spans=(
                    eager_spans, first_spans, second_spans))


def test_replayed_build_equals_the_eager_build(replayed):
    _assert_states_equal(replayed["first"], replayed["eager"])
    _assert_states_equal(replayed["second"], replayed["eager"])


def test_the_cloud_takes_every_stretch_and_a_compaction(replayed):
    """Several cascade and candidate rounds a step, steps with and without
    a spill, a count-0 step and an in-loop compaction."""
    eager_spans = replayed["spans"][0]
    steps = eager_spans["build.step"]["count"]
    assert eager_spans["sync.build.split_round"]["count"] >= 3 * steps
    assert eager_spans["sync.build.cand_rounds"]["count"] == steps
    assert replayed["graphs"].replays["cand_round"] >= 3 * steps
    assert int(replayed["eager"].vox_compacted) > 0
    assert set(replayed["captures"]) == set(STRETCHES)


def test_the_cache_captures_once_per_key_and_replays_after(replayed):
    graphs, captures = replayed["graphs"], replayed["captures"]
    # one capture per key: the spill variants of two stretches, one key for
    # each other stretch
    assert captures == {"route": 1, "gather": 2, "round": 1, "leaves": 2,
                        "cand_round": 1, "insert": 1}
    assert dict(graphs.captures) == captures      # the second build: none
    assert len(graphs) == 8
    assert graphs.replays["route"] == 2 * replayed["spans"][0][
        "build.step"]["count"] - 1


def test_the_spill_variants_get_their_own_keys(replayed):
    (slots,) = replayed["graphs"]._steps.values()
    assert set(slots.graphs) == {
        ("route", None), ("gather", False), ("gather", True),
        ("round", None), ("leaves", False), ("leaves", True),
        ("cand_round", None), ("insert", None)}


def test_every_stretch_passes_one_span(replayed):
    eager_spans, first, second = replayed["spans"]
    runs = lambda d: sum(d.get(n, {}).get("count", 0) for n in
                         ("build.eager", "build.capture", "build.replay"))
    n = runs(eager_spans)
    assert n > 6 * eager_spans["build.step"]["count"]
    assert n == runs(first) == runs(second)
    assert set(eager_spans) & {"build.capture", "build.replay"} == set()
    assert "build.eager" not in first and "build.eager" not in second
    assert first["build.capture"]["count"] == 8
    assert "build.capture" not in second
    graphs = replayed["graphs"]
    assert sum(graphs.captures.values()) + sum(graphs.replays.values()) \
        == 2 * n


def test_a_replaced_state_column_changes_the_key(cloud):
    cfg = EngineConfig(**KW)
    xyz, rgba = cloud
    graphs = BuildGraphs(record=FakeRecord(), device_type="cpu")
    state, _ = _build(cfg, xyz[:B], rgba[:B], "cpu", graphs)
    before = sum(graphs.captures.values())
    state.level = state.level.clone()
    x, y, z, c, counts = _planes(xyz[B:2 * B], rgba[B:2 * B], "cpu", 0)
    build.build_step(cfg, state, x[0], y[0], z[0], c[0], int(counts[0]),
                     graphs)
    assert len(graphs._steps) == 2
    assert sum(graphs.captures.values()) > before


def test_a_dropped_cache_is_freed_at_once(cloud):
    """No reference cycle holds a cache: its graphs go when its owner drops
    it, not in a cyclic collection, which could come while another graph
    records."""
    cfg = EngineConfig(**KW)
    xyz, rgba = cloud
    graphs = BuildGraphs(record=FakeRecord(), device_type="cpu")
    _build(cfg, xyz[:B], rgba[:B], "cpu", graphs)
    assert len(graphs) > 0
    ref = weakref.ref(graphs)
    collecting = gc.isenabled()
    gc.disable()
    try:
        del graphs
        assert ref() is None
    finally:
        if collecting:
            gc.enable()


def test_a_cache_takes_only_states_of_its_device_type(cloud):
    """The engine's cache (the card's) runs a CPU state's stretches
    eagerly and captures nothing."""
    cfg = EngineConfig(**KW)
    xyz, rgba = cloud
    graphs = BuildGraphs()
    state, spans = _build(cfg, xyz[:2 * B], rgba[:2 * B], "cpu", graphs)
    eager, _ = _build(cfg, xyz[:2 * B], rgba[:2 * B], "cpu")
    assert len(graphs) == 0 and not graphs.captures
    assert "build.eager" in spans and "build.replay" not in spans
    _assert_states_equal(state, eager)


@pytest.mark.parametrize("kw", [KW, dict(KW, node_capacity=1 << 13,
                                         segment_capacity=1 << 12)],
                         ids=["small", "wider"])
def test_reset_state_keeps_every_tensor_and_equals_init_state(cloud, kw):
    cfg = EngineConfig(**kw)
    xyz, rgba = cloud
    state, _ = _build(cfg, xyz[:2 * B], rgba[:2 * B], "cpu")
    ptrs = [getattr(state, f.name).data_ptr()
            for f in dataclasses.fields(OctreeState)]
    lo, hi = np.zeros(3, np.float32), np.array([2.0, 3.0, 1.5], np.float32)
    assert reset_state(state, cfg, lo, hi)
    assert ptrs == [getattr(state, f.name).data_ptr()
                    for f in dataclasses.fields(OctreeState)]
    _assert_states_equal(state, init_state(cfg, lo, hi, device="cpu"))
    # another config's shapes: nothing is written
    other = EngineConfig(**dict(kw, segment_capacity=kw["segment_capacity"]
                                * 2))
    snap = {f.name: getattr(state, f.name).clone()
            for f in dataclasses.fields(OctreeState)}
    assert not reset_state(state, other, lo, 2 * hi)
    for name, t in snap.items():
        assert torch.equal(getattr(state, name), t), name


def _scan(tmp_path_factory, cloud):
    xyz, rgba = cloud
    path = str(tmp_path_factory.mktemp("build_graphs") / "clusters.simlod")
    simlod.write(path, xyz, rgba)
    return path


def _engine_load(eng, path):
    eng.open([path])
    eng.load_all()
    eng.stream.stop()
    return eng.state


def test_an_engine_reopen_captures_nothing(tmp_path_factory, cloud):
    """Two open + load_all cycles through one (fake-captured) cache: the
    state keeps its tensors, the second load captures nothing, and its
    octree is a fresh eager engine's."""
    path = _scan(tmp_path_factory, cloud)
    cfg = EngineConfig(**KW, **LOW_WATERMARK)
    eng = Engine(cfg, Settings(), device="cpu")
    eng.build_graphs = BuildGraphs(record=FakeRecord(), device_type="cpu")
    state = _engine_load(eng, path)
    ptrs = [t.data_ptr() for t in vars(state).values()]
    captures = sum(eng.build_graphs.captures.values())
    assert captures == 8
    again = _engine_load(eng, path)
    assert again is state
    assert ptrs == [t.data_ptr() for t in vars(again).values()]
    assert sum(eng.build_graphs.captures.values()) == captures
    fresh = _engine_load(Engine(cfg, Settings(), device="cpu"), path)
    _assert_states_equal(again, fresh)


def test_an_engine_with_new_shapes_drops_its_build_graphs(tmp_path_factory,
                                                          cloud):
    path = _scan(tmp_path_factory, cloud)
    eng = Engine(EngineConfig(**KW), Settings(), device="cpu")
    eng.build_graphs = BuildGraphs(record=FakeRecord(), device_type="cpu")
    old = _engine_load(eng, path)
    assert len(eng.build_graphs) > 0
    eng.cfg = EngineConfig(**dict(KW, segment_capacity=1 << 15))
    new = _engine_load(eng, path)
    assert new is not old
    assert len(eng.build_graphs._steps) == 1


def test_a_run_of_bricks_captures_once(tmp_path_factory, cloud):
    """OutOfCoreEngine builds its bricks through one Engine of a fixed
    config: the in-place reset keeps the keys, so the bricks after the
    first capture nothing, and each brick equals an eager engine's."""
    from simlod_tpu_torch.outofcore import OutOfCoreEngine
    xyz, rgba = cloud
    tmp = tmp_path_factory.mktemp("graph_bricks")
    paths = []
    for i in range(3):
        m = (xyz[:, 0] >= i / 3) & (xyz[:, 0] < (i + 1) / 3 + (i == 2))
        paths.append(str(tmp / f"brick_{i}.simlod"))
        simlod.write(paths[-1], xyz[m], rgba[m])
    # a multi-level candidate block that drops nothing: the engine keeps
    # its config (it widens the block under drops, a config of its own)
    cfg = EngineConfig(**dict(KW, cand_multi_rows=1 << 14))
    graphed = OutOfCoreEngine(cfg, Settings(), device="cpu")
    graphed.engine.build_graphs = BuildGraphs(record=FakeRecord(),
                                              device_type="cpu")
    eager = OutOfCoreEngine(cfg, Settings(), device="cpu")
    for e in (graphed, eager):
        e.open(paths)
    captures = []
    for p in paths:
        graphed.build_brick(p)
        eager.build_brick(p)
        captures.append(sum(graphed.engine.build_graphs.captures.values()))
    assert graphed.engine.cfg == cfg
    assert captures[0] > 0 and captures == [captures[0]] * 3
    assert graphed.engine.build_graphs.replays["route"] > 0
    for g, e in zip(graphed.bricks, eager.bricks):
        for part in ("nodes", "voxels", "points", "segs"):
            a, b = getattr(g, part), getattr(e, part)
            assert a.keys() == b.keys()
            assert all(np.array_equal(a[k], b[k]) for k in a), part


# --- on the card ---

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_graph_build_is_bit_equal_to_the_eager_build_on_the_card(card,
                                                                 cloud):
    cfg = EngineConfig(**KW, **LOW_WATERMARK)
    xyz, rgba = cloud
    eager, spans = _build(cfg, xyz, rgba, card)
    graphs = BuildGraphs()
    first, _ = _build(cfg, xyz, rgba, card, graphs)
    captures = dict(graphs.captures)
    second, _ = _build(cfg, xyz, rgba, card, graphs, state=first)
    torch.cuda.synchronize()
    assert set(captures) == set(STRETCHES) and len(graphs) == 8
    assert dict(graphs.captures) == captures
    assert spans["sync.build.split_round"]["count"] >= 3 * spans[
        "build.step"]["count"]
    assert int(eager.vox_compacted) > 0
    _assert_states_equal(first, eager)
    _assert_states_equal(second, eager)


@pytest.mark.cuda
def test_an_engine_reopen_on_the_card_captures_nothing(card, tmp_path_factory,
                                                       cloud):
    path = _scan(tmp_path_factory, cloud)
    cfg = EngineConfig(**KW, **LOW_WATERMARK)
    eng = Engine(cfg, Settings(), device=card)
    state = _engine_load(eng, path)
    captures = sum(eng.build_graphs.captures.values())
    assert captures == 8
    again = _engine_load(eng, path)
    assert again is state
    assert sum(eng.build_graphs.captures.values()) == captures
    assert eng.build_graphs.replays["route"] > 0
    fresh = Engine(cfg, Settings(), device=card)
    # a cache that takes no card state: every stretch runs eagerly
    fresh.build_graphs = BuildGraphs(device_type="cpu")
    _assert_states_equal(again, _engine_load(fresh, path))


@pytest.mark.cuda
def test_a_collection_while_recording_frees_no_graph(card, cloud):
    """Cyclic garbage that holds another cache's graphs, and a collection
    at almost every allocation: the recordings still succeed (the collector
    waits while a graph records), and the build equals the eager one."""
    cfg = EngineConfig(**KW)
    xyz, rgba = cloud
    old = BuildGraphs()
    _build(cfg, xyz[:2 * B], rgba[:2 * B], card, old)
    assert len(old) > 0
    junk = [old]
    junk.append(junk)
    del old, junk
    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        graphs = BuildGraphs()
        built, _ = _build(cfg, xyz, rgba, card, graphs)
        torch.cuda.synchronize()
    finally:
        gc.set_threshold(*threshold)
    assert len(graphs) == 8
    _assert_states_equal(built, _build(cfg, xyz, rgba, card)[0])
