"""The simultaneous loop's frames on the port (CPU): fused frames draw the
voxels stored since the last compaction (the voxel tail), no frame is
returned truncated, EngineConfig.auto's render window caps, and the spans
and counters of the frame path.

The plain reference is lodbench/reference.py (plain torch, nothing of the
program): its `render` draws every stored voxel of a drawn node, compacted
or not, as SimLOD's insertVoxels makes each voxel drawable at once. Images
are compared per channel within 1 (high-quality shading averages, as in
tests/test_torch_loop.py) and exactly in plain mode.
"""
import dataclasses

import numpy as np
import pytest
import torch

from lodbench import reference as ref
from simlod_tpu_torch import constants as C
from simlod_tpu_torch import engine as engine_mod
from simlod_tpu_torch.config import (EngineConfig, Settings,
                                     render_window_cap)
from simlod_tpu_torch.engine import Engine
from simlod_tpu_torch.formats import simlod, synthetic
from simlod_tpu_torch.octree import build
from simlod_tpu_torch.octree.structures import OctreeState
from simlod_tpu_torch.ops import ragged
from simlod_tpu_torch.render import raster, visibility
from simlod_tpu_torch.render.render import image_to_rgba8, render_frame
from simlod_tpu_torch.utils import trace

torch.set_num_threads(1)

W, H = 160, 120
# the golden fixture's config (tests/test_torch_loop.py)
KW = dict(candidate_factor=21, cand_multi_rows=1 << 13,
          node_capacity=1 << 12, point_capacity=1 << 17, voxel_capacity=1 << 19,
          segment_capacity=1 << 14, step_points=1 << 13, spill_capacity=1 << 13,
          max_splits_per_round=64, seg_select_cap=1 << 10,
          max_points_per_node=256, max_render_points=1 << 17,
          max_render_voxels=1 << 17)


@pytest.fixture(scope="module")
def cloud_file(tmp_path_factory):
    xyz, rgba = synthetic.terrain(60_000, seed=31, extent=100.0, z_scale=15.0)
    path = str(tmp_path_factory.mktemp("tail") / "t.simlod")
    simlod.write(path, xyz, rgba)
    return path


def _rgb(img):
    return image_to_rgba8(np.asarray(img))[..., :3].astype(int)


def _record_draws(monkeypatch):
    """[(state copy, uniforms, tail, windows)] of every frame the engine
    draws, as render_frame is given them."""
    seen = []
    draw = engine_mod.render_frame

    def recording(cfg, state, width, height, uniforms, *windows):
        seen.append((OctreeState(**{f.name: getattr(state, f.name).clone()
                                    for f in dataclasses.fields(state)}),
                     uniforms, windows))
        return draw(cfg, state, width, height, uniforms, *windows)
    monkeypatch.setattr(engine_mod, "render_frame", recording)
    return seen


def _reference(state: OctreeState, uniforms, settings: Settings):
    st = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
    return _rgb(ref.render(
        ref.Tree(st), state.cube_size, uniforms.transform, W, H,
        min_node_size=settings.min_node_size,
        hqs=settings.use_high_quality_shading,
        edl_strength=settings.edl_strength if settings.enable_edl else None))


def _tail_of(state: OctreeState):
    return raster.voxel_tail(state, int(state.vox_compacted),
                             int(state.vox_used))


def _ample(cfg, state, uniforms):
    """The frame of a recorded state at windows that hold every sample."""
    big = 1 << 20
    return render_frame(cfg, state, W, H, uniforms, big, big, None, None,
                        _tail_of(state), big)


@pytest.mark.parametrize("hqs", [False, True], ids=["plain", "hqs"])
@pytest.mark.parametrize("chunk_steps", [1, 4])
def test_fused_frames_with_a_tail_match_the_reference(monkeypatch, cloud_file,
                                                      chunk_steps, hqs):
    """Each fused frame whose octree holds voxels not yet compacted equals
    the plain reference's frame of the same octree: the build_step path
    (one step an item) and the build_many path (four)."""
    settings = Settings(min_node_size=16.0, frame_budget_ms=0.0,
                        use_high_quality_shading=hqs, enable_edl=hqs)
    drawn = _record_draws(monkeypatch)
    eng = Engine(EngineConfig(**KW), settings, device="cpu")
    eng.open([cloud_file], chunk_steps=chunk_steps)
    checked = 0
    while not eng.last_batch_finished:
        eng.orbit.yaw += 0.2
        eng.camera.world = eng.orbit.world()
        fused = eng.t_fused.count
        img, stats = eng.frame(W, H)
        state, u, _ = drawn[-1]
        if eng.t_fused.count > fused and state.vox_used > state.vox_compacted:
            assert not stats.render_truncated
            diff = np.abs(_rgb(img) - _reference(state, u, settings))
            assert diff.max() <= (1 if hqs else 0), len(drawn)
            checked += 1
    assert checked >= 2 and eng.tail_rows > 0


def test_fused_draws_replay_one_graph_over_every_load(monkeypatch,
                                                      cloud_file):
    """Where frames are graphed (the card; here a recorder that replays
    the span), a fused frame's draw runs at the windows' caps over the
    whole directories and the tail's buffers: one key for every fused frame
    of two loads, and each image equal to the frame drawn eagerly at
    windows that hold every sample."""
    from graph_fakes import FakeRecord
    from simlod_tpu_torch.graphs import FrameGraphs
    drawn = _record_draws(monkeypatch)
    eng = Engine(EngineConfig(**KW), Settings(min_node_size=16.0,
                                              frame_budget_ms=0.0),
                 device="cpu")
    eng.fused_graphs = FrameGraphs(record=FakeRecord(), device_type="cpu")
    fused = 0
    for _ in range(2):
        eng.open([cloud_file], chunk_steps=1)
        while not eng.last_batch_finished:
            eng.orbit.yaw += 0.1
            eng.camera.world = eng.orbit.world()
            before = eng.t_fused.count
            img, stats = eng.frame(W, H)
            if eng.t_fused.count > before:
                state, u, windows = drawn[-1]
                assert windows[:4] == (KW["max_render_points"],
                                       KW["max_render_voxels"], None, None)
                assert not stats.render_truncated
                np.testing.assert_array_equal(
                    img.numpy(), _ample(eng.cfg, state, u)[0].numpy())
        fused += eng.t_fused.count
    g = eng.fused_graphs
    assert (g.captures, g.replays) == (1, fused - 1) and fused > 4


def test_the_tail_groups_each_row_under_the_node_compaction_gives_it(
        cloud_file):
    """voxel_tail: every tail row once, each in the range of the node the
    compaction resolves its key to (the ancestor of its emitting leaf at
    its level)."""
    eng = Engine(EngineConfig(**KW), Settings(), device="cpu")
    eng.open([cloud_file], chunk_steps=1)
    for _ in range(3):
        eng.ingest_next()
    s = eng.state
    c, u = int(s.vox_compacted), int(s.vox_used)
    assert u - c > 1000
    tail = raster.voxel_tail(s, c, u)
    rows = lambda k0, k1, k2l, rgba: sorted(zip(k0.tolist(), k1.tolist(),
                                                k2l.tolist(), rgba.tolist()))
    assert rows(tail.k0, tail.k1, tail.k2l, tail.rgba) == rows(
        s.vox_k0[c:u], s.vox_k1[c:u], s.vox_k2l[c:u], s.vox_rgba[c:u])
    node_of = {}
    for n in torch.nonzero(tail.vcnt).flatten().tolist():
        a, b = int(tail.voff[n]), int(tail.voff[n] + tail.vcnt[n])
        for key in zip(tail.k0[a:b].tolist(), tail.k1[a:b].tolist(),
                       tail.k2l[a:b].tolist()):
            node_of.setdefault(key, n)
    assert int(tail.vcnt.sum()) == u - c
    cs = build.compact_voxels_auto(eng.cfg, s)
    n = int(cs.vox_used)
    resolved = dict(zip(zip(cs.vox_k0[:n].tolist(), cs.vox_k1[:n].tolist(),
                            cs.vox_k2l[:n].tolist()),
                        cs.vox_node[:n].tolist()))
    assert node_of and all(resolved[k] == v for k, v in node_of.items())
    assert raster.voxel_tail(cs, n, n) is None
    eng.stream.stop()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_window_need_is_the_window_a_plan_fills(seed):
    """A plan at the window ragged.window_need gives draws every selected
    row; one block less drops some."""
    g = torch.Generator().manual_seed(seed)
    S = 300
    cnt = torch.randint(0, 400, (S,), generator=g, dtype=torch.int32)
    off = torch.randint(0, 1 << 16, (S,), generator=g, dtype=torch.int32)
    node = torch.randint(-1, 50, (S,), generator=g, dtype=torch.int32)
    mask = torch.rand(50, generator=g) < 0.5
    need = int(ragged.window_need(off, cnt, mask, node))
    want = int(torch.where((cnt > 0) & (node >= 0)
                           & mask[node.clamp(min=0).long()], cnt, 0).sum())
    assert need % 128 == 0 and need >= want > 0
    drawn = lambda w: int(ragged.expand(ragged.plan_blocks(
        off, cnt, w, mask, node)).valid.sum())
    assert drawn(need) == want
    assert drawn(need - 128) < want


def _floorless(monkeypatch):
    """Sample windows without the JAX package's 2^18-row floor, so that a
    small cloud outgrows them; the engine's held windows start at 1,024."""
    def sample_window(n, prev, cap):
        return min(max(int(n * 1.25) + 1024, prev >> 1), cap)
    monkeypatch.setattr(engine_mod, "sample_window", sample_window)


@pytest.mark.parametrize("mode", ["fused", "render"])
def test_no_frame_is_returned_truncated(monkeypatch, cloud_file, mode):
    """Windows held from the frame before (1,024 rows at first, then grown;
    a zoom step in the middle): a frame that truncates is drawn again at
    the windows its read asks for, and the image returned equals the frame
    drawn at windows that hold every sample."""
    _floorless(monkeypatch)
    drawn = _record_draws(monkeypatch)
    settings = Settings(min_node_size=16.0, frame_budget_ms=0.0)
    eng = Engine(EngineConfig(**KW), settings, device="cpu")
    eng._last_visible, eng._last_windows = (0, 0), (1024, 1024)
    eng._last_tail_need, eng._tail_window = 0, 1024
    eng.open([cloud_file], chunk_steps=1)
    if mode == "render":
        eng.load_all()
    frames = 0
    for k in range(6 if mode == "render" else 100):
        if mode == "fused" and eng.last_batch_finished:
            break
        if k == 3:
            eng.orbit.radius /= 2.5       # a zoom step
        eng.orbit.yaw += 0.1
        eng.camera.world = eng.orbit.world()
        before = len(drawn)
        img, stats = eng.frame(W, H) if mode == "fused" else eng.render(W, H)
        assert not stats.render_truncated, k
        state, u, windows = drawn[-1]
        if len(drawn) - before > 1:
            assert windows[0] >= drawn[before][2][0]
        ample, fstats = _ample(eng.cfg, state, u)
        assert not bool(fstats.truncated)
        np.testing.assert_array_equal(img.numpy(), ample.numpy())
        frames += 1
    assert frames >= 4 and eng.redraws >= 2
    assert len(drawn) == frames + eng.redraws


def test_frame_spans_and_counters_count_what_they_should(monkeypatch,
                                                         cloud_file):
    """engine.frame a call; frame.fused, frame.build, frame.tail and
    frame.draw a fused frame; engine.render a render-only frame;
    frame.redraw a redraw; the tail rows drawn carried in the frame's one
    read, equal to the tail rows of the nodes the frame drew."""
    _floorless(monkeypatch)
    drawn = _record_draws(monkeypatch)
    eng = Engine(EngineConfig(**KW), Settings(min_node_size=16.0,
                                              frame_budget_ms=0.0),
                 device="cpu")
    eng._last_visible, eng._last_windows = (0, 0), (1024, 1024)
    eng.open([cloud_file], chunk_steps=1)
    snap = trace.snapshot()
    calls = render_only = 0
    tail_rows = []
    while not eng.last_batch_finished or render_only < 2:
        fused = eng.t_fused.count
        rows = eng.tail_rows
        reads = eng.host_syncs
        eng.frame(W, H)
        calls += 1
        if eng.t_fused.count == fused:
            render_only += 1
            continue
        state, u, _ = drawn[-1]
        tail = _tail_of(state)
        if tail is None:
            assert eng.tail_rows == rows
            continue
        em = visibility.compute_visibility(state, u).emitted
        n = state.child_base.shape[0]
        node = state.anc[(state.vox_node.long() * (C.MAX_DEPTH + 1)
                          + (state.vox_k2l & 31).long())[
            int(state.vox_compacted):int(state.vox_used)]]
        assert eng.tail_rows - rows == int(em[node.clamp(0, n - 1).long()]
                                           .sum())
        tail_rows.append(eng.tail_rows - rows)
        assert eng.host_syncs > reads
    d = trace.since(snap)
    fused = eng.t_fused.count
    assert d["engine.frame"]["count"] == calls
    assert fused == calls - render_only
    for name in ("frame.fused", "frame.build", "frame.tail", "frame.draw",
                 "sync.engine.tail"):
        assert d[name]["count"] == fused, name
    assert d["engine.render"]["count"] == render_only
    assert eng.redraws >= 1 and d["frame.redraw"]["count"] == eng.redraws
    assert d["frame.fused"]["seconds"] >= d["frame.draw"]["seconds"]
    assert sum(tail_rows) == eng.tail_rows > 0


def test_auto_sizes_the_render_windows_from_the_pools():
    """EngineConfig.auto: each sample window's cap is the power of two at
    or above twice its pool (a view of every stored sample fits with its
    phase padding), its plan within 1/256 of the memory budget, and never
    below the JAX package's 4M; overrides win."""
    gb = 1 << 30
    cfg = EngineConfig.auto(total_points=73_000_000, memory_bytes=80 * gb)
    assert cfg.max_render_points >= 2 * cfg.point_capacity
    assert cfg.max_render_voxels >= 2 * cfg.voxel_capacity
    assert cfg.max_render_points == 1 << 28
    for cap in (cfg.max_render_points, cfg.max_render_voxels):
        assert cap // 128 * 17 <= 80 * gb // 256
    small = EngineConfig.auto(total_points=73_000_000, memory_bytes=gb)
    assert 4 << 20 <= small.max_render_points < cfg.max_render_points
    assert small.max_render_points // 128 * 17 <= gb // 256
    assert render_window_cap(10, gb) == 4 << 20
    over = EngineConfig.auto(total_points=1 << 20, memory_bytes=8 * gb,
                             max_render_voxels=1 << 21)
    assert over.max_render_voxels == 1 << 21
    assert over.max_render_points >= 2 * over.point_capacity
