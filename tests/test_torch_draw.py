"""The frame's drawing stage from sample sources (render/raster.py:
SampleSource, materialize, splat_samples and its plain version
splat_samples_reference; ops/ragged.py: plan_blocks) on the CPU, against the
JAX package.

  - ragged.plan_blocks, expanded, against the JAX ragged.plan: valid rows,
    their elements, segments and pool rows bit-equal, and the per-block
    src_row / r_ok equal, over random segment sets with empty segments, a
    window that truncates mid-segment, all-empty and exactly-fitting sets;
  - sources materialized against the JAX package's gathered Samples of the
    same frame (exact and pooled four-set frames): positions, colours,
    validity, nodes and levels bit-equal on valid rows;
  - whole frames through the sources (render_components /
    render_components_pooled, EDL off) against the JAX package's, op by op
    (its un-jitted *_impl: under jit XLA rounds the projection differently,
    1 ulp of depth on ~1% of pixels), in both
    shading modes: exact and pooled, point size 1 and 2, each debug colour
    mode, show_points off, a truncating window: colour and depth bit-equal
    (EDL is off because XLA and torch round its log2/exp differently);
  - splat_samples (the CUDA kernel's wrapper) raises on CPU tensors and
    counts no launch; raster.rasterize takes the plain version there.

On a machine with a card, tests/test_torch_port.py (`-m cuda`) holds the
kernel bit-equal to its plain version in the same cases.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simlod_tpu import constants as C
from simlod_tpu.config import EngineConfig as JCfg, Settings as JSet, Uniforms as JUni
from simlod_tpu.octree.structures import OctreeState as JState
from simlod_tpu.ops import ragged as jragged
from simlod_tpu.render import drawpool as jdp
from simlod_tpu.render import raster as jr
from simlod_tpu.render import render as jrender
from simlod_tpu.render import visibility as jv
from simlod_tpu.render.camera import Camera, OrbitControls
from simlod_tpu_torch.config import EngineConfig as TCfg, Settings as TSet, Uniforms as TUni
from simlod_tpu_torch.formats import synthetic
from simlod_tpu_torch.octree import build as tb
from simlod_tpu_torch.octree.structures import init_state, state_to_numpy
from simlod_tpu_torch.ops import ragged as tragged
from simlod_tpu_torch.render import drawpool as tdp
from simlod_tpu_torch.render import raster as tr
from simlod_tpu_torch.render import render as trender

# six test processes share the machine in the tier-1 run; these small tensors
# gain nothing from intra-op threads, which would oversubscribe the cores
torch.set_num_threads(1)

W, H = 160, 120
KW = dict(candidate_factor=21, cand_multi_rows=1 << 13,
          node_capacity=1 << 12, point_capacity=1 << 17, voxel_capacity=1 << 19,
          segment_capacity=1 << 14, step_points=1 << 13, spill_capacity=1 << 13,
          max_splits_per_round=64, seg_select_cap=1 << 10,
          max_points_per_node=256, max_render_points=1 << 17,
          max_render_voxels=1 << 17)
WIN = 1 << 17          # clears every set of these frames
TRUNC = 128 * 40       # cuts the exact frame's sets mid-segment


def _np(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


# --- ragged.plan_blocks ------------------------------------------------------

def _segments(case, rng):
    S, P = 300, 1 << 14
    cnt = rng.integers(1, 200, S).astype(np.int32)
    off = rng.integers(0, P - 200, S).astype(np.int32)
    if case in ("empty_segments", "truncating"):
        cnt[rng.random(S) < 0.3] = 0
    if case == "all_empty":
        cnt[:] = 0
    if case == "exact_fit":     # one segment per aligned 128-row block
        off = (np.arange(S) * 256).astype(np.int32)
        cnt[:] = 128
    out_len = {"truncating": 128 * 333, "exact_fit": 128 * S}.get(case,
                                                                  128 * 1024)
    return off, cnt, out_len


@pytest.mark.parametrize("case", ["empty_segments", "truncating",
                                  "all_empty", "exact_fit"])
def test_plan_blocks_matches_jax_plan(case):
    off, cnt, out_len = _segments(case, np.random.default_rng(17))
    jp = jragged.plan(jnp.asarray(off), jnp.asarray(cnt), out_len)
    bp = tragged.plan_blocks(torch.from_numpy(off), torch.from_numpy(cnt),
                             out_len)
    tp = tragged.expand(bp)
    v = np.asarray(jp.valid)
    np.testing.assert_array_equal(v, tp.valid.numpy())
    np.testing.assert_array_equal(np.asarray(jp.mpos), tp.mpos.numpy())
    for a, b in ((jp.elem, tp.elem), (jp.seg_of, tp.seg_of)):
        np.testing.assert_array_equal(np.asarray(a)[v], b.numpy()[v])
    pool = np.arange(1 << 17, dtype=np.int32) * 7 - 5
    np.testing.assert_array_equal(
        np.asarray(jragged.gather_column(jp, jnp.asarray(pool)))[v],
        tragged.gather_column(tp, torch.from_numpy(pool)).numpy()[v])
    ok = np.asarray(jp.r_ok)
    np.testing.assert_array_equal(ok, bp.r_ok.numpy())
    np.testing.assert_array_equal(np.asarray(jp.src_row)[ok],
                                  bp.src_row.numpy()[ok])
    # a block's valid rows are one aligned run of the pool
    rows = tp.src.numpy().reshape(-1, 128)
    np.testing.assert_array_equal(rows[:, 0] % 128, 0)
    if case == "truncating":
        assert 0 < v.sum() < cnt.sum()
    if case == "all_empty":
        assert not v.any()
    if case == "exact_fit":
        assert v.all()
    for got, want in zip(tragged.plan(torch.from_numpy(off),
                                      torch.from_numpy(cnt), out_len), tp):
        assert got == want if isinstance(want, int) else torch.equal(got, want)


# --- frames from sources -----------------------------------------------------

@pytest.fixture(scope="module")
def scene():
    """(port state, JAX state, port pool, JAX pool, box_max)."""
    xyz, rgba = synthetic.terrain(60_000, seed=23, extent=1.0, z_scale=0.4)
    box_max = np.maximum(xyz.max(0), 1e-3)
    cfg = TCfg(**KW)
    B = cfg.step_points
    K = (len(xyz) + B - 1) // B
    planes = np.zeros((3, K, B), np.float32)
    cc = np.zeros((K, B), np.uint32)
    counts = np.zeros(K, np.int32)
    for k in range(K):
        part = xyz[k * B:(k + 1) * B]
        planes[:, k, :len(part)] = part.T
        cc[k, :len(part)] = rgba[k * B:(k + 1) * B]
        counts[k] = len(part)
    ts = tb.build_many(cfg, init_state(cfg, np.zeros(3, np.float32), box_max,
                                       device="cpu"),
                       *map(torch.from_numpy, planes),
                       torch.from_numpy(cc.view(np.int32)), counts)
    ts = tb.compact_voxels(cfg, ts)
    js = JState(**{k: jnp.asarray(v) for k, v in state_to_numpy(ts).items()})
    n = int(ts.num_nodes)
    windows = (1 << 17, 1 << 19, 1 << max(n, 64).bit_length())
    tpool = tdp.build_draw_pool(cfg, ts, *windows, cfg.draw_cap)
    jpool = jdp.DrawPool(**{k: jnp.asarray(v) for k, v in
                            tdp.pool_to_numpy(tpool).items()})
    return ts, js, tpool, jpool, box_max


# name: (Settings overrides, max_point_size, pooled, sample window)
CASES = {
    "exact": ({}, 1, False, WIN),
    "pooled": (dict(point_budget=1.0), 1, True, WIN),
    "point_size_2": (dict(point_size=2), 2, False, WIN),
    "pooled_point_size_2": (dict(point_budget=1.0, point_size=2), 2, True,
                            WIN),
    "color_by_node": (dict(color_by_node=True), 1, False, WIN),
    "color_by_lod": (dict(color_by_lod=True), 1, False, WIN),
    "pooled_color_by_lod": (dict(point_budget=1.0, color_by_lod=True), 1,
                            True, WIN),
    "color_white": (dict(color_white=True), 1, False, WIN),
    "show_points_off": (dict(show_points=False), 1, False, WIN),
    "truncating": ({}, 1, False, TRUNC),
}


def _uniforms(box_max, settings):
    c = Camera(width=W, height=H)
    orbit = OrbitControls()
    orbit.focus_box([0, 0, 0], box_max)
    orbit.yaw, orbit.pitch = 0.3, -0.6
    c.world = orbit.world()
    kw = dict(min_node_size=8.0, enable_edl=False, **settings)
    return (JUni.make(W, H, c.transform(), settings=JSet(**kw)),
            TUni.make(W, H, c.transform(), settings=TSet(**kw), device="cpu"))


def _jax_sets(cfg, js, jpool, ju, pooled, win):
    """The JAX package's gathered Samples of the frame, as its render does."""
    vis = jv.compute_visibility(js, ju)
    if not pooled:
        sets = [jr.gather_point_samples(cfg, js, vis.emitted, win),
                jr.gather_voxel_samples(cfg, js, vis.emitted, win)]
    else:
        budgets = jdp.node_budgets(cfg, vis, ju)
        m_pp, m_ep, m_pv, m_ev = jdp.split_masks(cfg, js, vis, jpool)
        sets = [jdp.gather_pool_points(
                    cfg, js, jpool, jdp._pool_take(m_pp, jpool.pt_cnt, budgets),
                    win),
                jdp.gather_pool_voxels(
                    cfg, js, jpool, jdp._pool_take(m_pv, jpool.vx_cnt, budgets),
                    win),
                jr.gather_point_samples(cfg, js, m_ep, win),
                jr.gather_voxel_samples(cfg, js, m_ev, win)]
    return [s._replace(valid=s.valid & ju.show_points) for s in sets]


def _sources(cfg, ts, tpool, tu, pooled, win):
    if pooled:
        return trender.pooled_frame_samples(cfg, ts, tpool, tu, win, win,
                                            win, win)[1]
    return trender.frame_samples(cfg, ts, tu, win, win)[1]


@pytest.mark.parametrize("case", ["pooled_color_by_lod", "color_by_node"])
def test_sources_materialize_to_the_jax_samples(scene, case):
    ts, js, tpool, jpool, box_max = scene
    settings, mps, pooled, win = CASES[case]
    ju, tu = _uniforms(box_max, settings)
    jcfg, tcfg = JCfg(**KW, max_point_size=mps), TCfg(**KW, max_point_size=mps)
    jsets = _jax_sets(jcfg, js, jpool, ju, pooled, win)
    tsets = _sources(tcfg, ts, tpool, tu, pooled, win)
    assert len(tsets) == len(jsets) == (4 if pooled else 2)
    assert all(isinstance(s, tr.SampleSource) for s in tsets)
    drawn = []
    for k, (j, s) in enumerate(zip(jsets, tsets)):
        m = tr.materialize(s)
        v = np.asarray(j.valid)
        np.testing.assert_array_equal(v, m.valid.numpy(), err_msg=str(k))
        drawn.append(int(v.sum()))
        for f in ("x", "y", "z", "rgba"):
            np.testing.assert_array_equal(_np(getattr(j, f)).view(np.int32)[v],
                                          getattr(m, f).numpy().view(np.int32)[v],
                                          err_msg=f"{k} {f}")
        np.testing.assert_array_equal(_np(j.node_fn())[v], m.node_fn().numpy()[v])
        np.testing.assert_array_equal(_np(j.level_fn())[v],
                                      m.level_fn().numpy()[v])
        assert int(j.count) == int(s.count)
    assert drawn[0] > 0 and drawn[1] > 0, drawn


@pytest.mark.parametrize("hqs", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_frame_from_sources_matches_jax(scene, case, hqs):
    ts, js, tpool, jpool, box_max = scene
    settings, mps, pooled, win = CASES[case]
    ju, tu = _uniforms(box_max, dict(settings, use_high_quality_shading=hqs))
    jcfg, tcfg = JCfg(**KW, max_point_size=mps), TCfg(**KW, max_point_size=mps)
    if pooled:
        jc, jd, jst = jrender.render_components_pooled_impl(
            jcfg, js, jpool, W, H, ju, win, win, win, win)
        tc, td, tst = trender.render_components_pooled(
            tcfg, ts, tpool, W, H, tu, win, win, win, win)
    else:
        jc, jd, jst = jrender.render_components_impl(jcfg, js, W, H, ju, win,
                                                     win)
        tc, td, tst = trender.render_components(tcfg, ts, W, H, tu, win, win)
    np.testing.assert_array_equal(_np(jd), td.numpy())
    np.testing.assert_array_equal(_np(jc), tc.numpy())
    for f in jst._fields:
        assert int(getattr(jst, f)) == int(getattr(tst, f)), f
    drawn = (td.numpy() != C.DEPTH_INF_BITS).mean()
    if case == "show_points_off":
        assert drawn == 0
    else:       # the truncating window draws part of the frame
        assert drawn > (0.01 if case == "truncating" else 0.05)
    assert bool(tst.truncated) == (case == "truncating")
    # the frame's sets through rasterize are the plain version's frame
    sets = _sources(tcfg, ts, tpool, tu, pooled, win)
    want = tr.splat_samples_reference(tcfg, tu, W, H, sets)
    got = tr.rasterize(tcfg, tu, W, H, sets)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_splat_samples_rejects_cpu_tensors(scene):
    ts, _, _, _, box_max = scene
    _, tu = _uniforms(box_max, {})
    cfg = TCfg(**KW)
    sets = _sources(cfg, ts, None, tu, False, WIN)
    before = tr.splat_samples.launches
    with pytest.raises(ValueError, match="CUDA"):
        tr.splat_samples(cfg, tu, W, H, sets)
    with pytest.raises(ValueError, match="SampleSource"):
        tr.splat_samples(cfg, tu, W, H, [tr.materialize(s) for s in sets])
    assert tr.splat_samples.launches == before


def test_splat_samples_reference_takes_sources_and_samples(scene):
    """Sources and their materialized Samples draw the same frame, and the
    tile route draws it too."""
    from simlod_tpu_torch.render import raster_tiles
    ts, _, _, _, box_max = scene
    _, tu = _uniforms(box_max, {})
    cfg = TCfg(**KW)
    sets = _sources(cfg, ts, None, tu, False, WIN)
    a = tr.splat_samples_reference(cfg, tu, W, H, sets)
    b = tr.splat_samples_reference(cfg, tu, W, H, [tr.materialize(s)
                                                   for s in sets])
    c = raster_tiles.rasterize_tiles(cfg, tu, W, H, sets)
    for x, y in ((a, b), (a, c)):
        assert torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])
