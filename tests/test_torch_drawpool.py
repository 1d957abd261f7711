"""The port's draw pool (render/drawpool.py) and pooled render against the JAX
package's, on the CPU.

The octree is built by the JAX package with tests/test_render.py's helpers and
carried across with state_from_numpy; pools cross with pool_from_numpy /
pool_to_numpy. Tolerances:
  - _hash2, ragged.plan(...).mpos, node_budgets, split_masks,
    probe_pooled_counts, pool offsets and counts: bit-equal;
  - pool rows: equal per node as multisets, and in equal hash order (the JAX
    sort is unstable, the port's stable: rows whose (node, hash) tie may swap);
  - render_frame_pooled: bit-equal in plain mode, within 1 per channel with
    HQS (the port's tile resolve averages as floor(f32 sum / f32 count), the
    JAX CPU path divides integers; see test_torch_engine.py);
  - the pooled path's own invariants (pooled == exact under a clearing
    budget, at budget 0, and with draw_cap=128): bit-equal.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simlod_tpu import constants as C
from simlod_tpu.config import EngineConfig as JCfg, Settings as JSet, Uniforms as JUni
from simlod_tpu.ops import ragged as jragged
from simlod_tpu.render import drawpool as jdp
from simlod_tpu.render import render as jrender
from simlod_tpu.render import visibility as jvis
from simlod_tpu_torch.config import EngineConfig as TCfg, Settings as TSet, Uniforms as TUni
from simlod_tpu_torch.engine import Engine as TEngine
from simlod_tpu_torch.ops import ragged as tragged
from simlod_tpu_torch.octree.structures import state_from_numpy
from simlod_tpu_torch.render import drawpool as tdp
from simlod_tpu_torch.render import render as trender
from simlod_tpu_torch.render.camera import OrbitControls
from simlod_tpu_torch.render import visibility as tvis

from test_render import CFG, W, H, build_state, look_at_cloud

# six test processes share the machine in the tier-1 run; these small tensors
# gain nothing from intra-op threads, which would oversubscribe the cores
torch.set_num_threads(1)

TCFG = TCfg(**dataclasses.asdict(CFG))
BUDGETS = [0.0, 0.05, 1.0, 1e6]
WIN = 1 << 18   # clears the plans' per-segment padding in every path


def _cloud(n=6000, seed=1234):
    rng = np.random.default_rng(seed)
    xyz = rng.random((n, 3), dtype=np.float32) * 0.9 + 0.05
    rgba = (rng.integers(0, 1 << 24, n, dtype=np.uint32)
            | np.uint32(0xFF000000))
    return xyz, rgba


def _windows(js):
    """The windows tests/test_drawpool.py builds its pools with."""
    pool_w = 1 << max(jragged.window_for(
        int(js.pool_used), max(int(js.num_segments), 1)) - 1, 1).bit_length()
    vox_w = 1 << max(int(js.vox_compacted), 128).bit_length()
    node_w = 1 << max(int(js.num_nodes), 64).bit_length()
    return pool_w, vox_w, node_w


def _uniforms(budget, hqs=True, edl=True):
    t = look_at_cloud().transform()
    kw = dict(point_budget=budget, use_high_quality_shading=hqs,
              enable_edl=edl, min_node_size=8.0)
    return (JUni.make(W, H, t, settings=JSet(**kw)),
            TUni.make(W, H, t, settings=TSet(**kw), device="cpu"))


def _np(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


@pytest.fixture(scope="module")
def scene():
    """(JAX state, port state, JAX pool, port pool built on the carried state)."""
    xyz, rgba = _cloud()
    js = build_state(xyz, rgba)
    ts = state_from_numpy({k: np.asarray(v) for k, v in vars(js).items()},
                          device="cpu")
    ws = _windows(js)
    jpool = jdp.build_draw_pool(CFG, js, *ws, CFG.draw_cap)
    tpool = tdp.build_draw_pool(TCFG, ts, *ws, TCFG.draw_cap)
    return js, ts, jpool, tpool


def test_hash2_bit_equal():
    rng = np.random.default_rng(3)
    extreme = np.array([0, 1, -1, 2**31 - 1, -2**31, 0x55555555, -0x55555556],
                       np.int32)
    a = np.concatenate([rng.integers(-2**31, 2**31, 4000).astype(np.int32),
                        np.repeat(extreme, len(extreme))])
    b = np.concatenate([rng.integers(-2**31, 2**31, 4000).astype(np.int32),
                        np.tile(extreme, len(extreme))])
    want = np.asarray(jdp._hash2(jnp.asarray(a), jnp.asarray(b)))
    got = tdp._hash2(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_mpos_matches_jax(seed):
    rng = np.random.default_rng(seed)
    S = 300
    cnt = rng.integers(0, 200, S).astype(np.int32)
    cnt[rng.random(S) < 0.3] = 0             # empty segments
    off = rng.integers(0, 50_000, S).astype(np.int32)
    out_len = 128 * 400                       # cuts the later segments off
    jp = jragged.plan(jnp.asarray(off), jnp.asarray(cnt), out_len)
    tp = tragged.plan(torch.from_numpy(off), torch.from_numpy(cnt), out_len)
    np.testing.assert_array_equal(np.asarray(jp.mpos), tp.mpos.numpy())
    assert (cnt == 0).any() and (np.asarray(jp.mpos) == out_len).any()


def test_build_draw_pool_matches_jax(scene):
    js, ts, jpool, tpool = scene
    for f in ("pt_off", "pt_cnt", "vx_off", "vx_cnt"):
        np.testing.assert_array_equal(_np(getattr(jpool, f)),
                                      getattr(tpool, f).numpy(), err_msg=f)
    assert int(jnp.sum(jpool.pt_cnt)) > 0 and int(jnp.sum(jpool.vx_cnt)) > 0
    for off, cnt, cols in (("pt_off", "pt_cnt", ("p_w0", "p_w2", "p_w1", "p_rgba")),
                           ("vx_off", "vx_cnt", ("v_k0", "v_k2l", "v_k1", "v_rgba"))):
        o = tpool._asdict()[off].numpy()
        c = tpool._asdict()[cnt].numpy()
        jcols = [_np(getattr(jpool, f)) for f in cols]
        tcols = [getattr(tpool, f).numpy() for f in cols]
        for node in np.nonzero(c)[0]:
            sl = slice(o[node], o[node] + c[node])
            jr = np.stack([a[sl] for a in jcols], 1)
            tr = np.stack([a[sl] for a in tcols], 1)
            # hash order (h = hash(w0 ^ w2, w1), the same for voxel keys):
            # the sort key sequence is the same in both pools
            jh = tdp._hash2(torch.from_numpy(jr[:, 0] ^ jr[:, 1]),
                            torch.from_numpy(jr[:, 2]))
            th = tdp._hash2(torch.from_numpy(tr[:, 0] ^ tr[:, 1]),
                            torch.from_numpy(tr[:, 2]))
            assert torch.equal(jh, th), node
            assert (np.sort(th.numpy()) == th.numpy()).all()
            np.testing.assert_array_equal(
                jr[np.lexsort(jr.T[::-1])], tr[np.lexsort(tr.T[::-1])])


def test_pool_is_a_copy(scene):
    _, ts, _, tpool = scene
    for f in tpool._fields:
        for g in ("pt_w0", "pt_w1", "pt_w2", "pt_rgba", "vox_k0", "vox_k1",
                  "vox_k2l", "vox_rgba", "vox_node"):
            assert getattr(tpool, f).untyped_storage().data_ptr() != \
                getattr(ts, g).untyped_storage().data_ptr()


@pytest.mark.parametrize("budget", BUDGETS)
def test_budgets_masks_and_probe_match_jax(scene, budget):
    js, ts, jpool, _ = scene
    tpool = tdp.pool_from_numpy({k: np.asarray(v)
                                 for k, v in jpool._asdict().items()},
                                device="cpu")
    ju, tu = _uniforms(budget)
    jv, tv = jvis.compute_visibility(js, ju), tvis.compute_visibility(ts, tu)
    np.testing.assert_array_equal(
        np.asarray(jdp.node_budgets(CFG, jv, ju)),
        tdp.node_budgets(TCFG, tv, tu).numpy())
    for a, b in zip(jdp.split_masks(CFG, js, jv, jpool),
                    tdp.split_masks(TCFG, ts, tv, tpool)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    want = [int(v) for v in jrender.probe_pooled_counts(CFG, js, jpool, ju)]
    got = [int(v) for v in trender.probe_pooled_counts(TCFG, ts, tpool, tu)]
    assert want == got
    assert got[0] + got[1] > 0


def test_budget_decimates(scene):
    _, ts, _, tpool = scene
    full = [int(v) for v in trender.probe_pooled_counts(
        TCFG, ts, tpool, _uniforms(1e6)[1])]
    thin = [int(v) for v in trender.probe_pooled_counts(
        TCFG, ts, tpool, _uniforms(0.05)[1])]
    assert thin[2:] == full[2:] and thin[0] < full[0]


def _rgb(img):
    return trender.image_to_rgba8(np.asarray(img)).astype(int)


@pytest.mark.parametrize("hqs", [False, True])
@pytest.mark.parametrize("budget", [0.05, 1.0, 1e6])
def test_render_frame_pooled_matches_jax(scene, budget, hqs):
    """Each package renders the other's pool; both agree with the JAX frame."""
    js, ts, jpool, tpool = scene
    ju, tu = _uniforms(budget, hqs)
    tol = 1 if hqs else 0
    jimg, jst = jrender.render_frame_pooled(CFG, js, jpool, W, H, ju,
                                            WIN, WIN, WIN, WIN)
    carried = tdp.pool_from_numpy({k: np.asarray(v)
                                   for k, v in jpool._asdict().items()},
                                device="cpu")
    timg, tst = trender.render_frame_pooled(TCFG, ts, carried, W, H, tu,
                                            WIN, WIN, WIN, WIN)
    for f in jst._fields:
        assert int(getattr(jst, f)) == int(getattr(tst, f)), f
    assert np.abs(_rgb(jimg) - _rgb(timg)).max() <= tol
    back = jdp.DrawPool(**{k: jnp.asarray(v) for k, v in
                           tdp.pool_to_numpy(tpool).items()})
    jimg2, _ = jrender.render_frame_pooled(CFG, js, back, W, H, ju,
                                           WIN, WIN, WIN, WIN)
    assert np.abs(_rgb(jimg) - _rgb(jimg2)).max() == 0
    timg2, _ = trender.render_frame_pooled(TCFG, ts, tpool, W, H, tu,
                                           WIN, WIN, WIN, WIN)
    assert np.abs(_rgb(timg) - _rgb(timg2)).max() == 0
    assert (np.asarray(timg) != C.BACKGROUND_COLOR).sum() > 50


def _exact_and_pooled(cfg, ts, budget, hqs):
    _, tu = _uniforms(budget, hqs, edl=False)
    exact, _ = trender.render_frame(cfg, ts, W, H, tu, WIN, WIN)
    pool = tdp.build_draw_pool(cfg, ts, *_windows_t(ts), cfg.draw_cap)
    pooled, st = trender.render_frame_pooled(cfg, ts, pool, W, H, tu,
                                             WIN, WIN, WIN, WIN)
    return exact, pooled, st


def _windows_t(ts):
    pool_w = 1 << max(tragged.window_for(
        int(ts.pool_used), max(int(ts.num_segments), 1)) - 1, 1).bit_length()
    return (pool_w, 1 << max(int(ts.vox_compacted), 128).bit_length(),
            1 << max(int(ts.num_nodes), 64).bit_length())


@pytest.mark.parametrize("case", ["clearing_budget", "budget_zero",
                                  "draw_cap_128"])
def test_pooled_equals_exact(scene, case):
    """tests/test_drawpool.py's invariants, on the port."""
    _, ts, _, _ = scene
    cfg = dataclasses.replace(TCFG, draw_cap=128) if case == "draw_cap_128" \
        else TCFG
    budget = 0.0 if case == "budget_zero" else 1e6
    exact, pooled, st = _exact_and_pooled(cfg, ts, budget,
                                          hqs=case != "budget_zero")
    assert torch.equal(exact, pooled)
    assert not bool(st.truncated)


def test_render_frames_pooled_equals_single_frames(scene):
    js, ts, _, tpool = scene
    us = []
    for yaw in (0.0, 0.7, 1.4):
        c = look_at_cloud()
        o = OrbitControls()
        o.focus_box([0, 0, 0], [1, 1, 1])
        o.yaw = yaw
        c.world = o.world()
        us.append(TUni.make(W, H, c.transform(),
                            settings=TSet(point_budget=1.0, min_node_size=8.0),
                            device="cpu"))
    singles = [trender.render_frame_pooled(TCFG, ts, tpool, W, H, u,
                                           WIN, WIN, WIN, WIN) for u in us]
    img, st = trender.render_frames_pooled(TCFG, ts, tpool, W, H, us,
                                           WIN, WIN, WIN, WIN)
    assert torch.equal(img, singles[-1][0])
    assert int(st.num_visible_nodes) == int(singles[-1][1].num_visible_nodes)
    assert not bool(st.truncated)
    # a window the first frame outgrows: the OR carries its flag to the end
    small = 128 * 4
    _, st = trender.render_frames_pooled(TCFG, ts, tpool, W, H, us,
                                         small, small, small, small)
    assert bool(st.truncated)
    img_e, st_e = trender.render_frames(TCFG, ts, W, H, us, WIN, WIN)
    assert torch.equal(img_e, trender.render_frame(TCFG, ts, W, H, us[-1],
                                                   WIN, WIN)[0])


def _loaded_engine(xyz, rgba):
    cfg = dataclasses.replace(TCFG, max_render_points=1 << 18,
                              max_render_voxels=1 << 18)
    eng = TEngine(cfg, TSet(enable_edl=False, min_node_size=8.0), device="cpu")
    eng.reset([0, 0, 0], [1, 1, 1])
    B = cfg.step_points
    for s0 in range(0, len(xyz), B):
        part = np.zeros((B, 3), np.float32)
        col = np.zeros(B, np.uint32)
        n = len(xyz[s0:s0 + B])
        part[:n], col[:n] = xyz[s0:s0 + B], rgba[s0:s0 + B]
        eng.ingest(*(torch.from_numpy(np.ascontiguousarray(part[:, i]))
                     for i in range(3)),
                   torch.from_numpy(col.view(np.int32)), n)
    return eng


def test_engine_pooled_render_matches_exact():
    """Engine.render with point_budget > 0 after a load (test_drawpool.py's
    engine test, on the port): a clearing budget reproduces the exact frame,
    a decimating one renders."""
    eng = _loaded_engine(*_cloud(4000, seed=5))
    img0, _ = eng.render(W, H)
    eng.settings.point_budget = 1e6
    img1, st1 = eng.render(W, H)
    assert torch.equal(img0, img1)
    assert eng._draw_pool is not None and not st1.render_truncated
    eng.settings.point_budget = 0.05
    img2, _ = eng.render(W, H)
    assert img2.shape == img0.shape
    assert (img2.numpy() != C.BACKGROUND_COLOR).sum() > 50


def test_engine_pooled_frame_follows_filter_colors():
    """filter_colors drops the draw pool, which holds its own copy of the
    voxel colours: a pooled frame after the filter equals the exact frame
    under a clearing budget (bit-equal), not the pooled frame before it. The
    points sit in 216 tight clusters, so that a voxel's filtered colour (the
    average of its points) differs from its sampled one."""
    rng = np.random.default_rng(7)
    xyz = (rng.integers(0, 6, (4000, 3)) / 6 + 0.08
           + rng.random((4000, 3)) * 0.01).astype(np.float32)
    rgba = (rng.integers(0, 1 << 24, 4000, dtype=np.uint32)
            | np.uint32(0xFF000000))
    eng = _loaded_engine(xyz, rgba)
    eng.settings.min_node_size = 20.0               # coarse enough for voxels
    eng.settings.point_budget = 1e6
    before, _ = eng.render(W, H)
    assert eng._draw_pool is not None
    eng.filter_colors()
    pooled, _ = eng.render(W, H)
    eng.settings.point_budget = 0.0
    exact, _ = eng.render(W, H)
    assert not torch.equal(before, exact)            # the filter shows
    assert torch.equal(pooled, exact)
