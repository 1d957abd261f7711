"""Engine.render's frames as CUDA graphs (graphs.FrameGraphs), the port's
counterpart of the JAX package's jitted render_frame / render_frame_pooled.

On the CPU (no card, no graph): the graph cache with the injected recorder
of tests/graph_fakes.py, whose replays run the span (a key's first sight
runs the span once and records it, later sights replay; one capture per
key; a change of each key field captures again; the LRU evicts; a capture
error raises), frame_key over a real state, pool
and uniform buffer, Uniforms written into the persistent UniformBuffer
against Uniforms.make value for value (the buffer never moves), the
visibility kernel's floats read from that buffer feeding the plain version
against JAX's compute_visibility, and a CPU Engine.render that builds no
graph and still draws JAX's images and Stats. JAX is imported inside the
tests that compare with it, so that the card tests run without it.

On the card (the `cuda` marker; `pytest tests/test_torch_graph.py -m cuda
--noconftest`): graph frames bit-equal to eager frames of the same key over
an orbit and across each switch, the tile route, a compaction and a pool
rebuild; returned images that do not alias; launch counters that count
replays; a recording error that raises.
"""
import dataclasses

import numpy as np
import pytest
import torch

from simlod_tpu_torch.config import (EngineConfig, RenderFlags, Settings,
                                     UniformBuffer, Uniforms)
from simlod_tpu_torch.engine import (_STATS, WINDOW_SHRINK_FRAMES, Engine,
                                     _frame_stack, _to_stats, held_window,
                                     sample_window)
from simlod_tpu_torch.formats import simlod, synthetic
from simlod_tpu_torch.graphs import (MAX_GRAPHS, CapturedFrame, FrameGraphs,
                                     record_cuda_graph)
from simlod_tpu_torch.octree.structures import init_state
from simlod_tpu_torch.render import drawpool, raster
from simlod_tpu_torch.render.camera import Camera, OrbitControls
from simlod_tpu_torch.render.render import (frame_key, render_frame,
                                            render_frame_pooled)

from graph_fakes import FakeGraph, FakeRecord

# six test processes share the machine in the tier-1 run; these small tensors
# gain nothing from intra-op threads, which would oversubscribe the cores
torch.set_num_threads(1)

W, H = 96, 64
# the golden fixture's config (tests/test_golden.py, test_torch_engine.py)
KW = dict(candidate_factor=21, cand_multi_rows=1 << 13,
          node_capacity=1 << 12, point_capacity=1 << 17, voxel_capacity=1 << 19,
          segment_capacity=1 << 14, step_points=1 << 13, spill_capacity=1 << 13,
          max_splits_per_round=64, seg_select_cap=1 << 10,
          max_points_per_node=256, max_render_points=1 << 17,
          max_render_voxels=1 << 17)


def _transform(yaw):
    c = Camera(width=W, height=H)
    o = OrbitControls()
    o.focus_box([0, 0, 0], [1, 1, 1])
    o.yaw = yaw
    c.world = o.world()
    return c.transform()


@pytest.fixture(scope="module")
def small():
    """A fresh CPU state, a draw pool of its columns and a uniform buffer."""
    cfg = EngineConfig(**KW)
    state = init_state(cfg, [0, 0, 0], [1, 1, 1], device="cpu")
    n = state.child_base.shape[0]
    zeros = lambda: torch.zeros(n, dtype=torch.int32)
    cols = lambda: torch.zeros(256, dtype=torch.int32)
    pool = drawpool.DrawPool(zeros(), zeros(), cols(), cols(), cols(), cols(),
                             zeros(), zeros(), cols(), cols(), cols(), cols())
    buf = UniformBuffer("cpu")
    return cfg, state, pool, buf


def _cpu_graphs(rec=None):
    return FrameGraphs(record=rec or FakeRecord(), device_type="cpu")


def test_graph_cache_captures_once_per_key():
    cap = FakeRecord()
    graphs = _cpu_graphs(cap)
    calls = []
    span = lambda: calls.append(1) or torch.ones(3)
    graphs.run("k", span, "cpu")
    graphs.run("k", span, "cpu")
    again = graphs.run("k", span, "cpu")
    # the first sight's eager run, then one run per (fake) replay
    assert graphs.captures == 1 and len(cap.spans) == 1 and len(calls) == 3
    (graph,) = graphs._graphs.values()
    assert graphs.replays == 2 and again is graph.outputs
    assert len(graphs) == 1 and graphs.capture_seconds >= 0.0


def test_a_first_sight_runs_the_span_once_and_records_it():
    """A key's first sight runs the frame once, as the frame's work, and
    returns its result; the recording runs nothing; the second sight
    replays the graph without running the span eagerly again."""
    cap = FakeRecord()
    graphs = _cpu_graphs(cap)
    calls = []
    span = lambda: calls.append(1) or torch.full((1,), float(len(calls)))
    first = graphs.run("k", span, "cpu")
    (graph,) = graphs._graphs.values()
    assert len(calls) == 1 and first.item() == 1.0
    assert len(cap.spans) == 1 and graph.replays == 0
    assert graphs.captures == 1 and graphs.replays == 0
    second = graphs.run("k", span, "cpu")
    assert len(calls) == 2 and graph.replays == 1
    assert second is graph.outputs and second.item() == 2.0
    assert graphs.captures == 1 and graphs.replays == 1


def _key_changes(cfg, state, pool, u):
    """(name, frame_key args) for each field of the key, changed."""
    ws = (1 << 18, 1 << 18, 4096, 4096)
    new_u = Uniforms.make(W, H, _transform(0.0), device="cpu")
    grown = dataclasses.replace(state, level=state.level.clone())
    moved = pool._replace(pt_cnt=pool.pt_cnt.clone())
    return {
        "windows": (cfg, W, H, (1 << 19,) + ws[1:], u, state, None),
        "width": (cfg, W + 8, H, ws, u, state, None),
        "height": (cfg, W, H + 8, ws, u, state, None),
        "flags": (cfg, W, H, ws, dataclasses.replace(
            u, flags=RenderFlags(enable_edl=False)), state, None),
        "cfg": (dataclasses.replace(cfg, use_tile_raster=True), W, H, ws, u,
                state, None),
        "pooled": (cfg, W, H, ws, u, state, pool),
        "state tensor": (cfg, W, H, ws, u, grown, None),
        "pool tensor": (cfg, W, H, ws, u, state, moved),
        "uniform tensors": (cfg, W, H, ws, new_u, state, None),
    }


@pytest.mark.parametrize("field", ["windows", "width", "height", "flags",
                                   "cfg", "pooled", "state tensor",
                                   "pool tensor", "uniform tensors"])
def test_graph_cache_recaptures_on_each_key_field(small, field):
    cfg, state, pool, buf = small
    u = buf.write(W, H, _transform(0.3))
    base = (cfg, W, H, (1 << 18, 1 << 18, 4096, 4096), u, state, None)
    changed = _key_changes(cfg, state, pool, u)[field]
    if field == "pool tensor":
        base = base[:6] + (pool,)
    graphs = _cpu_graphs()
    span = lambda: torch.zeros(1)
    graphs.run(frame_key(*base), span, "cpu")
    graphs.run(frame_key(*base), span, "cpu")
    assert graphs.captures == 1
    assert frame_key(*changed) != frame_key(*base)
    graphs.run(frame_key(*changed), span, "cpu")
    assert graphs.captures == 2 and graphs.replays == 1


def test_a_new_frame_keeps_its_key(small):
    """The camera and the settings' values ride the uniform buffer, not the
    key: frames of an orbit, a new HQS mode or point size replay one
    graph."""
    cfg, state, pool, buf = small
    ws = (1 << 18, 1 << 18, 4096, 4096)
    keys = set()
    for k, s in enumerate((Settings(), Settings(use_high_quality_shading=False),
                           Settings(point_size=2, edl_strength=1.5))):
        u = buf.write(W, H, _transform(0.2 * k), settings=s)
        keys.add(frame_key(cfg, W, H, ws, u, state, pool))
    assert len(keys) == 1


def test_graph_cache_lru_evicts_the_least_recently_used():
    graphs = _cpu_graphs()
    span = lambda: torch.zeros(1)
    keys = list(range(MAX_GRAPHS + 1))
    # key 1 is the least recently used when the last key comes in
    for key in keys[:-1] + [0, keys[-1]]:
        graphs.run(key, span, "cpu")
    assert graphs.captures == MAX_GRAPHS + 1 and len(graphs) == MAX_GRAPHS
    graphs.run(0, span, "cpu")
    assert graphs.captures == MAX_GRAPHS + 1
    graphs.run(1, span, "cpu")
    assert graphs.captures == MAX_GRAPHS + 2 and len(graphs) == MAX_GRAPHS
    graphs.clear()
    assert len(graphs) == 0


def _jax_windows(counts, cap):
    """The JAX package's windows over a run of visible counts."""
    from simlod_tpu.engine import sample_window as jax_window
    w, out = 1 << 20, []
    for n in counts:
        w = jax_window(n, w, cap)
        out.append(w)
    return out


def _held_windows(counts, cap):
    w, low, out = 1 << 20, 0, []
    for n in counts:
        w, low = held_window(n, w, low, cap)
        out.append(w)
    return out


@pytest.mark.parametrize("seed,cap", [(0, 1 << 22), (1, 1 << 22),
                                      (2, 3 << 20), (3, 1 << 17)])
def test_held_windows_never_fall_below_the_jax_windows(seed, cap):
    """A held window is a power of two (or the cap) no smaller than the
    JAX package's window after the same visible counts, so the port
    truncates no frame that JAX draws whole: random walks, jumps and
    drops of the visible counts."""
    rng = np.random.default_rng(seed)
    steps = np.exp(rng.normal(0.0, 0.3, 400))
    steps[rng.random(400) < 0.05] *= 8.0            # jumps
    steps[rng.random(400) < 0.05] /= 16.0           # drops
    counts = np.clip(np.cumprod(steps) * 4e5, 0, 1 << 23).astype(int)
    held, jax = _held_windows(counts, cap), _jax_windows(counts, cap)
    assert all(h >= j for h, j in zip(held, jax))
    assert all(h == cap or h & (h - 1) == 0 for h in held)
    # the windows moved, unless the cap sits under the floor of 2^18 rows
    assert len(set(held)) > 1 or set(held) == {cap} == set(jax)


def test_held_windows_grow_at_once_and_shrink_late():
    cap = 1 << 22
    w, low = held_window(900_000, 1 << 20, 0, cap)
    assert (w, low) == (1 << 21, 0)          # 1.25 x 900k > 2^20: grows
    for k in range(WINDOW_SHRINK_FRAMES - 1):
        w, low = held_window(300_000, w, low, cap)
        assert (w, low) == (1 << 21, k + 1)  # needs 2^19: held
    w, low = held_window(300_000, w, low, cap)
    assert (w, low) == (1 << 20, 0)          # one octave down
    w, low = held_window(700_000, w, low, cap)
    assert (w, low) == (1 << 20, 0)          # within half again: the count resets
    assert held_window(10, 1 << 18, 0, cap) == (1 << 18, 0)   # the floor
    assert held_window(1 << 30, 1 << 20, 0, cap) == (cap, 0)  # the cap


def test_held_windows_take_fewer_values_than_per_frame_windows():
    """The visible counts of an orbit swing by a third around 10^6: the
    JAX package's windows follow them bucket by bucket, the held windows
    take two values, which the graph cache holds both of."""
    t = np.arange(120)
    counts = (1e6 * (1.0 + 0.33 * np.sin(2 * np.pi * t / 60))).astype(int)
    changes = lambda ws: sum(a != b for a, b in zip(ws, ws[1:]))
    held, jax = _held_windows(counts, 1 << 22), _jax_windows(counts, 1 << 22)
    assert len(set(held)) == 2 <= MAX_GRAPHS < len(set(jax))
    assert 2 * changes(held) < changes(jax)


def test_a_capture_error_propagates():
    err = RuntimeError("operation not permitted when stream is capturing")
    graphs = _cpu_graphs(FakeRecord(fail=err))
    with pytest.raises(RuntimeError) as got:
        graphs.run("k", lambda: torch.zeros(1), "cpu")
    assert got.value is err
    assert len(graphs) == 0 and graphs.captures == 0 and graphs.replays == 0


def test_a_replay_counts_the_launches_of_its_capture():
    def wrapper():
        pass
    wrapper.launches = 5
    frame = CapturedFrame(FakeGraph(lambda: None), None, ((wrapper, 3),))
    frame.replay()
    frame.replay()
    assert wrapper.launches == 11 and frame.graph.replays == 2


CASES = {"default": (0.3, Settings()),
         "switches": (1.1, Settings(use_high_quality_shading=False,
                                    show_bounding_box=True, color_by_lod=True,
                                    enable_edl=False, point_size=2,
                                    min_node_size=8.0, point_budget=0.05)),
         "frozen": (2.0, Settings(do_update_visibility=False, lod=0.7,
                                  edl_strength=1.2, color_white=True))}


@pytest.mark.parametrize("case", list(CASES))
def test_uniform_buffer_writes_equal_uniforms_make(case):
    yaw, s = CASES[case]
    buf = UniformBuffer("cpu")
    ptr = buf.buf.data_ptr()
    t, tub = _transform(yaw), _transform(yaw - 0.5)
    before = buf.write(W, H, _transform(0.0))
    got = buf.write(W, H, t, tub, settings=s)
    want = Uniforms.make(W, H, t, tub, settings=s, device="cpu")
    for f in dataclasses.fields(Uniforms):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert torch.equal(a.view(-1).view(torch.uint8),
                               b.view(-1).view(torch.uint8)), f.name
            assert a.data_ptr() == getattr(before, f.name).data_ptr(), f.name
        else:
            assert a == b, f.name
    assert buf.buf.data_ptr() == ptr
    np.testing.assert_array_equal(
        got.vis.numpy(), np.frombuffer(got.host.vis_floats, np.float32))


@pytest.fixture(scope="module")
def scene():
    """(JAX state, the same state in the port), as in
    tests/test_torch_frame_kernels.py."""
    from simlod_tpu_torch.octree.structures import state_from_numpy
    from test_render import build_state
    rng = np.random.default_rng(1234)
    xyz = rng.random((6000, 3), dtype=np.float32) * 0.9 + 0.05
    rgba = (rng.integers(0, 1 << 24, 6000, dtype=np.uint32)
            | np.uint32(0xFF000000))
    js = build_state(xyz, rgba)
    ts = state_from_numpy({k: np.asarray(v) for k, v in vars(js).items()},
                          device="cpu")
    return js, ts


@pytest.mark.parametrize("yaw", [0.0, 0.9, 2.5])
def test_visibility_from_the_uniform_buffer_matches_jax(scene, yaw):
    """The plain version fed the buffer's Uniforms (the values the kernel
    reads from the device) equals JAX's compute_visibility."""
    from simlod_tpu.config import Settings as JSet, Uniforms as JUni
    from simlod_tpu.render import visibility as jvis
    from simlod_tpu_torch.render import visibility as tvis
    from test_render import H as RH, W as RW
    js, ts = scene
    c = Camera(width=RW, height=RH)
    o = OrbitControls()
    o.focus_box([0, 0, 0], [1, 1, 1])
    o.yaw = yaw
    c.world = o.world()
    t = c.transform()
    buf = UniformBuffer("cpu")
    buf.write(RW, RH, _transform(1.7))      # the last frame's values
    tu = buf.write(RW, RH, t, settings=Settings(min_node_size=8.0))
    ju = JUni.make(RW, RH, t, settings=JSet(min_node_size=8.0))
    jv = jvis.compute_visibility(js, ju)
    tv = tvis.compute_visibility_reference(ts, tu)
    for f in ("emitted", "visible", "is_large", "dx", "dy",
              "num_visible_nodes", "num_visible_inner", "num_visible_leaves",
              "num_visible_points", "num_visible_voxels"):
        np.testing.assert_array_equal(np.asarray(getattr(jv, f)),
                                      getattr(tv, f).numpy(), err_msg=f)
    assert tv.emitted.any()
    vis = tu.vis.numpy()
    np.testing.assert_array_equal(vis[:16], np.asarray(
        ju.transform_update_bound).reshape(16))
    np.testing.assert_array_equal(vis[40:], np.float32([RW, RH, 8.0, 0.0]))


@pytest.fixture(scope="module")
def cloud_file(tmp_path_factory):
    xyz, rgba = synthetic.terrain(20_000, seed=23, extent=1.0, z_scale=0.4)
    path = str(tmp_path_factory.mktemp("graph") / "cloud.simlod")
    simlod.write(path, xyz, rgba)
    return path


STAT_KEYS = ("num_nodes", "num_points", "num_voxels", "num_visible_nodes",
             "num_visible_points", "num_visible_voxels", "render_truncated")


@pytest.mark.parametrize("budget", [0.0, 1.0])
def test_cpu_engine_render_builds_no_graph_and_matches_jax(cloud_file,
                                                           budget):
    """The caller chose the CPU: the frame runs eagerly, no graph is made,
    and images (EDL off: bit-equal) and Stats equal the JAX engine's."""
    from simlod_tpu.config import EngineConfig as JCfg, Settings as JSet
    from simlod_tpu.engine import Engine as JEngine
    kw = dict(min_node_size=8.0, enable_edl=False,
              use_high_quality_shading=False, point_budget=budget)
    jeng = JEngine(JCfg(**KW), JSet(**kw))
    teng = Engine(EngineConfig(**KW), Settings(**kw), device="cpu")
    for eng in (jeng, teng):
        eng.open([cloud_file])
        eng.load_all()
    try:
        for yaw in (0.4, 1.4):
            for eng in (jeng, teng):
                eng.orbit.yaw, eng.orbit.pitch = yaw, -0.5
                eng.camera.world = eng.orbit.world()
            jimg, jst = jeng.render(W, H)
            timg, tst = teng.render(W, H)
            np.testing.assert_array_equal(
                np.asarray(jimg).view(np.uint32), timg.numpy().view(np.uint32))
            for k in STAT_KEYS:
                assert getattr(tst, k) == getattr(jst, k), k
            assert tst.num_visible_points + tst.num_visible_voxels > 0
        assert teng.graphs.captures == 0 and len(teng.graphs) == 0
        assert teng.graphs.replays == 0
    finally:
        jeng.stream.stop()
        teng.stream.stop()


def test_cpu_engine_held_windows_draw_the_jax_frames(cloud_file):
    """Over ten orbit frames the port's held windows stay at least the JAX
    engine's (the first eight hold 2^20 rows while JAX's shrink) and the
    images and Stats stay equal."""
    from simlod_tpu.config import EngineConfig as JCfg, Settings as JSet
    from simlod_tpu.engine import Engine as JEngine
    kw = dict(min_node_size=8.0, enable_edl=False,
              use_high_quality_shading=False)
    big = {**KW, "max_render_points": 1 << 20, "max_render_voxels": 1 << 20}
    jeng = JEngine(JCfg(**big), JSet(**kw))
    teng = Engine(EngineConfig(**big), Settings(**kw), device="cpu")
    for eng in (jeng, teng):
        eng.open([cloud_file])
        eng.load_all()
    try:
        seen = set()
        for k in range(10):
            for eng in (jeng, teng):
                eng.orbit.yaw, eng.orbit.pitch = 0.3 * k, -0.5
                eng.camera.world = eng.orbit.world()
            jimg, jst = jeng.render(W, H)
            timg, tst = teng.render(W, H)
            np.testing.assert_array_equal(
                np.asarray(jimg).view(np.uint32), timg.numpy().view(np.uint32))
            for key in STAT_KEYS:
                assert getattr(tst, key) == getattr(jst, key), key
            assert all(t >= j for t, j in zip(teng._last_windows,
                                               jeng._last_windows))
            seen.add((tuple(teng._last_windows), tuple(jeng._last_windows)))
        assert len({t for t, _ in seen}) < len({j for _, j in seen})
    finally:
        jeng.stream.stop()
        teng.stream.stop()


def test_the_frame_a_stream_ends_on_is_drawn_eagerly(cloud_file):
    """The render-only frame in which Engine.frame finds the stream drained
    is drawn once (a compaction just moved the voxel directory): no graph is
    recorded for it. The frames after it, with a still octree, are."""
    eng = Engine(EngineConfig(**KW), Settings(min_node_size=8.0,
                                              frame_budget_ms=0.0),
                 device="cpu")
    eng.graphs = _cpu_graphs()
    eng.open([cloud_file], chunk_steps=1)
    while not eng.last_batch_finished:
        img, _ = eng.frame(W, H)
    assert eng.graphs.captures == 0 and eng.t_render.count == 1
    want, _ = _eager(eng)
    assert torch.equal(img, want)
    eng.frame(W, H)
    eng.frame(W, H)
    assert (eng.graphs.captures, eng.graphs.replays) == (1, 1)
    eng.stream.stop()


# --- on the card ---

CARD_CFG = EngineConfig(**{**KW, "max_render_points": 1 << 20,
                           "max_render_voxels": 1 << 20}, max_point_size=2)

@pytest.fixture(scope="module")
def card(tmp_path_factory):
    """A 60k-point terrain loaded by Engine on the card (the golden
    fixture's config, max_point_size 2, sample windows up to 2^20 rows so
    that they can move)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    xyz, rgba = synthetic.terrain(60_000, seed=23, extent=1.0, z_scale=0.4)
    path = str(tmp_path_factory.mktemp("graph_card") / "terrain.simlod")
    simlod.write(path, xyz, rgba)
    eng = Engine(CARD_CFG, Settings(min_node_size=8.0), device="cuda")
    eng.open([path])
    eng.load_all()
    yield eng
    eng.stream.stop()


def _look(eng, yaw, pitch=-0.6):
    eng.orbit.yaw, eng.orbit.pitch = yaw, pitch
    eng.camera.world = eng.orbit.world()


def _eager(eng):
    """The eager frame of the key of eng's last render: the same state,
    windows and values through render_frame(_pooled) -> (image, stack)."""
    u = eng.uniforms(W, H)
    if eng.settings.point_budget > 0:
        img, fs = render_frame_pooled(eng.cfg, eng.state, eng._draw_pool, W,
                                      H, u, *eng.last_pooled_windows)
    else:
        img, fs = render_frame(eng.cfg, eng.state, W, H, u, *eng.last_windows)
    return img, _frame_stack(eng.state, fs)


def _settle(eng):
    """Still frames until the windows have held for WINDOW_SHRINK_FRAMES + 1
    frames in a row, after which a still camera's windows hold for good."""
    ws, same = None, 0
    for _ in range(8 * (WINDOW_SHRINK_FRAMES + 1)):
        eng.render(W, H)
        now = eng.last_pooled_windows if eng.settings.point_budget > 0 \
            else eng.last_windows
        same, ws = (same + 1 if now == ws else 0), now
        if same >= WINDOW_SHRINK_FRAMES + 1:
            return
    raise AssertionError(f"the windows of a still camera did not settle: {ws}")


def _held_to_eager(eng):
    """eng.render (a graph's replay) against the eager frame of its key:
    the image bit for bit, every Stats counter equal."""
    img, stats = eng.render(W, H)
    want, stack = _eager(eng)
    assert torch.equal(img, want), int((img != want).sum())
    assert stats == _to_stats(dict(zip(_STATS, stack.tolist())))
    return img


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [0.0, 1.0])
def test_graph_frames_equal_eager_frames_over_an_orbit(card, budget):
    eng = card
    eng.settings = Settings(min_node_size=8.0, point_budget=budget)
    captures, replays = eng.graphs.captures, eng.graphs.replays
    for k in range(12):
        _look(eng, 0.25 * k)
        _held_to_eager(eng)
    assert eng.graphs.captures > captures
    # each frame is a first sight of its key or a replay
    assert eng.graphs.captures + eng.graphs.replays == captures + replays + 12
    assert eng.graphs.replays > replays


TOGGLES = {"edl off": dict(enable_edl=False),
           "hqs off": dict(use_high_quality_shading=False),
           "boxes": dict(show_bounding_box=True),
           "by node": dict(color_by_node=True),
           "by lod": dict(color_by_lod=True),
           "white": dict(color_white=True),
           "point size 2": dict(point_size=2)}


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [False, True], ids=["splat", "tile"])
@pytest.mark.parametrize("budget", [0.0, 1.0])
@pytest.mark.parametrize("toggle", list(TOGGLES))
def test_graph_frames_equal_eager_frames_across_switches(card, toggle, budget,
                                                         tile):
    eng = card
    base = CARD_CFG
    eng.cfg = dataclasses.replace(base, use_tile_raster=tile)
    try:
        eng.settings = Settings(min_node_size=8.0, point_budget=budget,
                                **TOGGLES[toggle])
        _look(eng, 0.7)
        for _ in range(3):
            _held_to_eager(eng)
    finally:
        eng.cfg = base


@pytest.mark.cuda
def test_a_window_change_recaptures(card):
    """A new key's first frame captures, runs the frame once (one launch of
    each kernel) and equals the eager frame."""
    from simlod_tpu_torch.ops import ragged
    eng = card
    eng.settings = Settings(min_node_size=8.0)
    _look(eng, 0.2)
    _held_to_eager(eng)
    _held_to_eager(eng)
    captures, windows = eng.graphs.captures, eng.last_windows
    eng._last_windows = (1 << 18, 1 << 18)
    eng._last_visible = (1 << 19, 1 << 19)      # larger sample windows
    fns = (ragged.plan_blocks_cuda, raster.edl_cuda, raster.splat_samples)
    before = [f.launches for f in fns]
    img, stats = eng.render(W, H)
    assert [f.launches - b for f, b in zip(fns, before)] == [1, 1, 1]
    want, stack = _eager(eng)
    assert torch.equal(img, want)
    assert stats == _to_stats(dict(zip(_STATS, stack.tolist())))
    assert eng.last_windows != windows
    assert eng.graphs.captures == captures + 1


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [0.0, 1.0])
def test_graph_frames_after_a_compaction_and_a_pool_rebuild(card, budget):
    eng = card
    eng.settings = Settings(min_node_size=8.0, point_budget=budget)
    _look(eng, 1.3)
    _held_to_eager(eng)
    eng._maybe_compact(force=True)
    _held_to_eager(eng)
    if budget:
        pool = eng._draw_pool
        eng._draw_pool, eng._pool_key = None, None    # rebuilt by the frame
        captures = eng.graphs.captures
        _held_to_eager(eng)
        assert eng._draw_pool is not pool
        assert eng.graphs.captures == captures + 1


@pytest.mark.cuda
def test_returned_images_do_not_alias(card):
    eng = card
    eng.settings = Settings(min_node_size=8.0)
    _look(eng, 0.5)
    a, _ = eng.render(W, H)
    keep = a.clone()
    _look(eng, 2.5)
    b, _ = eng.render(W, H)
    torch.cuda.synchronize()
    assert a.data_ptr() != b.data_ptr()
    assert torch.equal(a, keep) and not torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [0.0, 1.0])
def test_launch_counters_count_replays(card, budget):
    from simlod_tpu_torch.ops import ragged
    from simlod_tpu_torch.render import visibility
    eng = card
    eng.settings = Settings(min_node_size=8.0, point_budget=budget)
    _look(eng, 0.9)
    _settle(eng)                # captured and replayed by now
    fns = (visibility.compute_visibility_cuda, ragged.plan_blocks_cuda,
           raster.edl_cuda, raster.splat_samples)
    before = [f.launches for f in fns]
    captures, replays = eng.graphs.captures, eng.graphs.replays
    for _ in range(5):
        eng.render(W, H)
    assert eng.graphs.captures == captures
    assert eng.graphs.replays == replays + 5
    made = [f.launches - b for f, b in zip(fns, before)]
    # one launch of each a replay; a pooled frame's window re-probe launches
    # visibility outside the graph
    assert made[1:] == [5, 5, 5]
    assert made[0] == 5 if not budget else made[0] >= 5


@pytest.mark.cuda
def test_a_capture_error_raises_on_the_card(card):
    """The recorder raises the span's error (a copy from pageable memory
    cannot be recorded), a cache keeps no graph of it, and the next span
    records and replays."""
    dev = torch.device("cuda", torch.cuda.current_device())
    host = torch.arange(4, dtype=torch.float32)     # pageable memory
    span = lambda: host.to(dev) * 2
    with pytest.raises(RuntimeError):
        record_cuda_graph(span, dev)
    graphs = FrameGraphs()
    with pytest.raises(RuntimeError):
        graphs.run("pageable copy", span, dev)
    assert len(graphs) == 0
    two = lambda: torch.ones(4, device=dev) * 2
    two()
    out = record_cuda_graph(two, dev)
    out.replay()
    torch.cuda.synchronize()
    assert torch.equal(out.outputs, torch.full((4,), 2.0, device=dev))
