"""The port's simultaneous loop (Engine.frame / ingest / ingest_next) on the
CPU: frame by frame against the JAX engine, and the JAX package's own loop
invariants (tests/test_engine.py), on the port.

Tolerances: per-frame Stats equal; images bit-equal in plain mode (EDL off:
XLA and torch round its log2/exp differently, which moves a channel by at most
1, test_torch_raster.py) and within 1 per channel with HQS and EDL (the port's
tile resolve averages as floor(f32 sum / f32 count), the JAX CPU path divides
integers). The sequences are compared at
frame_budget_ms=0, which pins one streamed item per frame: the budget and the
draw-pool rebuild cadence follow the wall clock, so pooled streamed frames are
held to invariants (the load_all tree) instead of JAX images.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from simlod_tpu.config import EngineConfig as JCfg, Settings as JSet
from simlod_tpu.engine import Engine as JEngine
from simlod_tpu_torch import constants as C
from simlod_tpu_torch.config import EngineConfig as TCfg, Settings as TSet
from simlod_tpu_torch.engine import Engine as TEngine
from simlod_tpu_torch.formats import simlod, synthetic
from simlod_tpu_torch.io.streaming import PointStream
from simlod_tpu_torch.render.render import image_to_rgba8

# six test processes share the machine in the tier-1 run; these small tensors
# gain nothing from intra-op threads, which would oversubscribe the cores
torch.set_num_threads(1)

W, H = 160, 120
# the golden fixture's config (tests/test_golden.py, test_torch_engine.py)
KW = dict(candidate_factor=21, cand_multi_rows=1 << 13,
          node_capacity=1 << 12, point_capacity=1 << 17, voxel_capacity=1 << 19,
          segment_capacity=1 << 14, step_points=1 << 13, spill_capacity=1 << 13,
          max_splits_per_round=64, seg_select_cap=1 << 10,
          max_points_per_node=256, max_render_points=1 << 17,
          max_render_voxels=1 << 17)
# tests/test_engine.py's config and cloud
ENGINE_KW = dict(KW, node_capacity=1 << 13, point_capacity=1 << 18,
                 voxel_capacity=1 << 20)


def _within(seconds, fn):
    """Run fn in a thread; fail unless it returns within `seconds`."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:   # re-raised in the test's thread
            out["error"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"did not return within {seconds} s"
    if "error" in out:
        raise out["error"]
    return out.get("value")


@pytest.fixture(scope="module")
def golden_file(tmp_path_factory):
    xyz, rgba = synthetic.terrain(60_000, seed=23, extent=1.0, z_scale=0.4)
    path = str(tmp_path_factory.mktemp("loop") / "golden.simlod")
    simlod.write(path, xyz, rgba)
    return path


@pytest.fixture(scope="module")
def engine_file(tmp_path_factory):
    xyz, rgba = synthetic.terrain(60_000, seed=5, extent=100.0, z_scale=12.0)
    path = str(tmp_path_factory.mktemp("loop") / "t.simlod")
    simlod.write(path, xyz, rgba)
    return path


def _frame_loop(eng, path, chunk_steps, yaw_step=0.0):
    """open -> frame until last_batch_finished; [(rgb, Stats dict)]."""
    eng.open([path], chunk_steps=chunk_steps)
    out = []
    while not eng.last_batch_finished:
        eng.orbit.yaw += yaw_step
        eng.camera.world = eng.orbit.world()
        img, st = eng.frame(W, H)
        out.append((_rgb(img),
                    {k: int(v) for k, v in dataclasses.asdict(st).items()}))
    return out


def _rgb(img):
    return image_to_rgba8(np.asarray(img))[..., :3].astype(int)


def drawn_states(monkeypatch):
    """Record, for each frame an engine draws, a copy of the octree and the
    transform it was drawn with: [(state dict, transform)]."""
    from simlod_tpu_torch import engine as engine_mod
    seen = []
    draw = engine_mod.render_frame

    def recording(cfg, state, width, height, uniforms, *a, **k):
        seen.append(({f.name: getattr(state, f.name).clone()
                      for f in dataclasses.fields(state)},
                     uniforms.transform.clone()))
        return draw(cfg, state, width, height, uniforms, *a, **k)
    monkeypatch.setattr(engine_mod, "render_frame", recording)
    return seen


def reference_image(state: dict, transform, settings: dict):
    """The plain reference's frame (lodbench/reference.py) of a recorded
    octree: every stored voxel drawable, compacted or not."""
    from lodbench import reference as ref
    s = TSet(**settings)
    return _rgb(ref.render(
        ref.Tree(state), state["cube_size"], transform, W, H,
        min_node_size=s.min_node_size, hqs=s.use_high_quality_shading,
        edl_strength=s.edl_strength if s.enable_edl else None))


@pytest.mark.parametrize("chunk_steps,hqs", [(1, False), (1, True),
                                             (4, False), (4, True)])
def test_frame_sequence_matches_jax(monkeypatch, golden_file, chunk_steps,
                                    hqs):
    """Frame by frame against the JAX engine: the Stats equal on every
    frame. A frame whose octree has no voxel tail (every stored voxel
    compacted) equals JAX's image. A fused frame with a tail draws the
    tail's voxels of its drawn nodes, which the JAX package leaves out (the
    port's deliberate deviation, as the reference's insertVoxels makes each
    voxel drawable at once): it is held to the plain reference's frame of
    the same octree instead, within 1 per channel."""
    # EDL's log2/exp round differently in XLA and torch (within 1 per
    # channel, test_torch_raster.py): plain mode is compared without it
    kw = dict(min_node_size=8.0, frame_budget_ms=0.0,
              use_high_quality_shading=hqs, enable_edl=hqs)
    jf = _frame_loop(JEngine(JCfg(**KW), JSet(**kw)), golden_file,
                     chunk_steps, 0.05)
    drawn = drawn_states(monkeypatch)
    teng = TEngine(TCfg(**KW), TSet(**kw), device="cpu")
    tf = _frame_loop(teng, golden_file, chunk_steps, 0.05)
    steps = -(-60_000 // KW["step_points"])
    assert len(tf) == len(jf) == len(drawn) == -(-steps // chunk_steps) + 1
    tails = 0
    for i, ((ji, js), (ti, ts), (state, t)) in enumerate(zip(jf, tf, drawn)):
        assert ts == js, i
        if state["vox_used"] > state["vox_compacted"]:
            tails += 1
            ri = reference_image(state, t, kw)
            assert np.abs(ri - ti).max() <= 1, i
        else:
            assert np.abs(ji - ti).max() <= (1 if hqs else 0), i
    assert tails >= len(tf) // 2 and teng.tail_rows > 0
    assert tf[-1][1]["num_points"] == 60_000
    assert (tf[-1][0] != 0).any()


def _no_overfull_leaves(eng):
    s = eng.state
    ids = torch.arange(s.child_base.shape[0])
    over = ((s.child_base < 0) & (ids < s.num_nodes)
            & (s.level < eng.cfg.max_depth)
            & (s.counter > eng.cfg.max_points_per_node))
    return not bool(over.any())


TREE = ("num_nodes", "num_points", "num_points_processed")


def _load_all_tree(path, **settings):
    eng = TEngine(TCfg(**ENGINE_KW), TSet(**settings), device="cpu")
    eng.open([path])
    eng.load_all()
    return {k: eng.report()[k] for k in TREE}


def test_ingest_next_drains_and_converges_splits(engine_file):
    eng = TEngine(TCfg(**ENGINE_KW), TSet(), device="cpu")
    eng.open([engine_file])
    while eng.ingest_next():
        pass
    rep = eng.report()
    assert rep["num_points_processed"] == rep["num_points"] == 60_000
    assert rep["num_nodes"] > 8
    assert not rep["mem_capacity_reached"]
    assert rep["stream"]["points_loaded"] == 60_000
    assert eng.last_batch_finished and eng._splits_finished
    assert _no_overfull_leaves(eng)
    assert {k: rep[k] for k in TREE} == _load_all_tree(engine_file)
    assert not eng.ingest_next()


@pytest.mark.parametrize("consume", ["ingest_next", "frame"])
def test_capacity_watermark_ends_the_stream(tmp_path, consume):
    cfg = TCfg(**dict(ENGINE_KW, point_capacity=1 << 12))
    xyz, rgba = synthetic.terrain(30_000, seed=2, extent=50.0)
    p = str(tmp_path / "small.simlod")
    simlod.write(p, xyz, rgba)
    eng = TEngine(cfg, TSet(min_node_size=8.0), device="cpu")
    eng.open([p])
    if consume == "ingest_next":
        while eng.ingest_next():
            pass
    else:
        while not eng.last_batch_finished:
            eng.frame(64, 48)
    rep = eng.report()
    assert eng.last_batch_finished
    assert rep["mem_capacity_reached"]
    assert rep["num_points"] <= 1 << 12
    assert rep["num_points_dropped"] > 0


def test_pooled_stream_ends_with_the_load_all_tree(engine_file):
    """The simultaneous loop drawing through the draw pool, with the
    wall-clock budget on (several items per frame once frames are fast)."""
    settings = dict(min_node_size=8.0, point_budget=1.0, frame_budget_ms=50.0)
    eng = TEngine(TCfg(**ENGINE_KW), TSet(**settings), device="cpu")
    frames = _frame_loop(eng, engine_file, 1, 0.03)
    rep = eng.report()
    assert {k: rep[k] for k in TREE} == _load_all_tree(engine_file, **settings)
    assert rep["timings"]["pool"]["count"] >= 1
    assert eng._draw_pool is not None
    assert rep["frames"] == len(frames) >= 2
    rgb = frames[-1][0]
    assert (rgb != (C.BACKGROUND_COLOR & 0xFFFFFF)).any()


def test_adapt_budget_steps_like_jax():
    """Batches per frame move one step at a time toward budget / per-batch ms,
    capped at max_batches_per_frame; a budget of 0 pins one."""
    seq = [(10.0, 1), (10.0, 2), (10.0, 3), (100.0, 4), (100.0, 3), (1.0, 2)] \
        + [(0.5, 1)] * 25
    for budget in (50.0, 0.0):
        jeng = JEngine(JCfg(**KW), JSet(frame_budget_ms=budget))
        teng = TEngine(TCfg(**KW), TSet(frame_budget_ms=budget),
                       device="cpu")
        got = []
        for ms, consumed in seq:
            jeng._adapt_budget(ms, consumed)
            teng._adapt_budget(ms, consumed)
            got.append(teng._batches_per_frame)
            assert teng._batches_per_frame == jeng._batches_per_frame
        if budget > 0:
            assert got[:3] == [2, 3, 4] and max(got) == 20
        else:
            assert set(got) == {1}


def test_stopped_stream_ends_its_iteration(golden_file):
    s = PointStream([golden_file], step_points=4096, device="cpu",
                    batch_points=5000, ring_slots=1, num_loaders=1)
    it = iter(s)
    assert next(it)[4].sum() > 0
    s.stop()
    _within(2.0, lambda: list(it))
    _within(2.0, lambda: list(s))


def test_reset_engine_does_not_hang(golden_file):
    eng = TEngine(TCfg(**KW), TSet(min_node_size=8.0), device="cpu")
    eng.open([golden_file], chunk_steps=1)
    assert eng.ingest_next()
    eng.reset(np.zeros(3, np.float32), np.ones(3, np.float32))
    assert _within(2.0, eng.ingest_next) is False
    img, st = _within(2.0, lambda: eng.frame(32, 24))
    assert st.num_points == 0 and tuple(img.shape) == (24, 32)
    eng.open([golden_file], chunk_steps=4)     # open is the reload path
    while eng.ingest_next():
        pass
    assert eng.report()["num_points"] == 60_000
