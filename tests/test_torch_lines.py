"""The port's line overlays (render/lines.py) and overlay frames against the
JAX package's on the CPU. The octree is built by the JAX package with
tests/test_render.py's helpers and carried across with state_from_numpy.

Tolerances:
  - node_box_lines, _clip_t_range and rasterize_lines (on the same line set):
    bit-equal. The clip-space product is summed in the order of XLA's CPU dot,
    (x m0 + y m1) + (z m2 + m3);
  - frustum_lines: the JAX package inverts and unprojects in float32, the
    port in float64. Near corners agree within 2e-6 relative (a few float32
    ulps); the far quad, where unprojecting amplifies the inverse's rounding,
    within 1e-2 relative (the port within 1e-6 of the float64 corners);
  - frames with show_bounding_box=True, EDL off, exact and pooled: plain mode
    bit-equal except at most 8 frustum-line pixels (the inverse above), HQS
    within 1 per channel elsewhere (test_torch_engine.py's tolerance).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simlod_tpu.config import Settings as JSet, Uniforms as JUni
from simlod_tpu.render import drawpool as jdp
from simlod_tpu.render import lines as jl
from simlod_tpu.render import render as jrender
from simlod_tpu.render import visibility as jvis
from simlod_tpu_torch.config import EngineConfig as TCfg, Settings as TSet, \
    Uniforms as TUni
from simlod_tpu_torch.octree.structures import state_from_numpy
from simlod_tpu_torch.render import drawpool as tdp
from simlod_tpu_torch.render import lines as tl
from simlod_tpu_torch.render import render as trender
from simlod_tpu_torch.render import visibility as tvis
from simlod_tpu_torch.render.render import image_to_rgba8

from test_render import CFG, W, H, build_state, look_at_cloud

# six test processes share the machine in the tier-1 run; these small tensors
# gain nothing from intra-op threads, which would oversubscribe the cores
torch.set_num_threads(1)

TCFG = TCfg(**dataclasses.asdict(CFG))
WIN = 1 << 18
FRUSTUM_PIXELS = 8


def _t(a):
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _uniforms(hqs=False, boxes=True, budget=0.0, yaw=0.0):
    cam = look_at_cloud()
    t = cam.transform()
    # a frozen visibility camera turned away from the view camera, so the
    # frustum wireframe lies inside the frame
    orbit = dataclasses.replace(_orbit(), yaw=yaw - 0.5, radius=2.2)
    cam.world = orbit.world()
    frozen = cam.transform()
    kw = dict(show_bounding_box=boxes, use_high_quality_shading=hqs,
              enable_edl=False, min_node_size=8.0, point_budget=budget)
    return (JUni.make(W, H, t, frozen, settings=JSet(**kw)),
            TUni.make(W, H, t, frozen, settings=TSet(**kw), device="cpu"))


def _orbit():
    from simlod_tpu_torch.render.camera import OrbitControls
    o = OrbitControls()
    o.focus_box([0, 0, 0], [1, 1, 1])
    return o


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(77)
    xyz = rng.random((6000, 3), dtype=np.float32) * 0.9 + 0.05
    rgba = rng.integers(0, 1 << 24, 6000, dtype=np.uint32) | np.uint32(0xFF << 24)
    js = build_state(xyz, rgba)
    ts = state_from_numpy({k: np.asarray(v) for k, v in vars(js).items()},
                          device="cpu")
    return js, ts


def _lines(js, ts):
    ju, tu = _uniforms()
    jv = jvis.compute_visibility(js, ju)
    tv = tvis.compute_visibility(ts, tu)
    np.testing.assert_array_equal(np.asarray(jv.emitted), tv.emitted.numpy())
    return (ju, tu, jl.node_box_lines(js, jv.emitted, CFG.max_render_lines),
            tl.node_box_lines(ts, tv.emitted, TCFG.max_render_lines))


def test_node_box_lines_bit_equal(scene):
    js, ts = scene
    _, _, jb, tb = _lines(js, ts)
    assert int(np.asarray(jb[3]).sum()) >= 12 * 8
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(_t(a).numpy(), b.numpy())


def test_frustum_lines_within_rounding():
    """Near corners (NDC z = -1) agree to float32 ulps. The far quad sits at
    NDC z = 0.99995, where unprojecting divides by a w close to 0 and
    amplifies the inverse's rounding ~1e4 times: the JAX package's float32
    corners land 1.5e-3 relative from the float64 corners on this camera, the
    port's (float64 inverse, rounded once) within 1e-6, so the two are held
    to 1e-2 of each other and the port to 1e-6 of float64."""
    ju, tu = _uniforms()
    ja, jb, jc, jv = (np.asarray(x) for x in jl.frustum_lines(ju))
    ta, tb, tc, tv = (x.numpy() for x in tl.frustum_lines(tu))
    rel = lambda x, y: (np.linalg.norm(x - y, axis=1)
                        / np.linalg.norm(y, axis=1)).max()
    assert rel(ta[:4], ja[:4]) <= 2e-6                 # the near corners
    m = np.linalg.inv(np.asarray(ju.transform_update_bound, np.float64))
    for pts_j, pts_t in ((ja[4:], ta[4:]), (jb, tb)):
        assert rel(pts_t, pts_j) <= 1e-2
    far = np.array([(m @ [x, y, 0.99995, 1.0])[:3] / (m @ [x, y, 0.99995, 1.0])[3]
                    for x, y in ((1, 1), (1, -1), (-1, 1), (-1, -1))])
    assert rel(tb[:4], far) <= 1e-6 and rel(jb[:4], far) <= 1e-2
    np.testing.assert_array_equal(_t(jc).numpy(), tc)
    np.testing.assert_array_equal(jv, tv)


def test_clip_t_range_bit_equal():
    rng = np.random.default_rng(3)
    ca, cb = (rng.normal(0, 1, 4000).astype(np.float32) for _ in range(2))
    ca[:50] = cb[:50]                                  # parallel to the plane
    lo = rng.random(4000).astype(np.float32) * 0.5
    hi = lo + 0.5
    j = jl._clip_t_range(*map(jnp.asarray, (ca, cb, lo, hi)))
    t = tl._clip_t_range(*map(torch.from_numpy, (ca, cb, lo, hi)))
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_rasterize_lines_bit_equal(scene):
    """The same line set (boxes + the JAX frustum) into the same framebuffer."""
    js, ts = scene
    ju, tu, jb, _ = _lines(js, ts)
    jf = jl.frustum_lines(ju)
    a, b, c, v = (jnp.concatenate([p, q]) for p, q in zip(jb, jf))
    rng = np.random.default_rng(5)
    npx = W * H
    depth = np.where(rng.random(npx) < 0.5, np.float32(np.inf),
                     rng.uniform(0.5, 3.0, npx).astype(np.float32))
    color = rng.integers(0, 2**32, npx, dtype=np.uint64).astype(np.uint32)
    jcol, jdep = jl.rasterize_lines(CFG, ju, W, H, jnp.asarray(color),
                                    jnp.asarray(depth.view(np.int32)),
                                    a, b, c, v)
    tcol, tdep = tl.rasterize_lines(TCFG, tu, W, H, _t(color),
                                    _t(depth.view(np.int32)), _t(a), _t(b),
                                    _t(c), _t(v))
    np.testing.assert_array_equal(_t(jcol).numpy(), tcol.numpy())
    np.testing.assert_array_equal(np.asarray(jdep), tdep.numpy())
    assert (tcol.numpy() != color.view(np.int32)).sum() > 100


def _rgb(img):
    return image_to_rgba8(np.asarray(img))[..., :3].astype(int)


def _check_overlay_frame(jimg, timg, plain_img, hqs):
    d = np.abs(_rgb(jimg) - _rgb(timg)).max(-1)
    boxes = (_rgb(timg) != _rgb(plain_img)).any(-1)
    assert boxes.sum() > 50                      # the overlay drew lines
    # outside a few frustum pixels the frames agree (plain: bit-equal)
    assert (d > (1 if hqs else 0)).sum() <= FRUSTUM_PIXELS, (d > 0).sum()


@pytest.mark.parametrize("hqs", [False, True])
def test_exact_frame_with_boxes_matches_jax(scene, hqs):
    js, ts = scene
    ju, tu = _uniforms(hqs)
    jimg, jst = jrender.render_frame(CFG, js, W, H, ju, WIN, WIN)
    timg, tst = trender.render_frame(TCFG, ts, W, H, tu, WIN, WIN)
    for f in jst._fields:
        assert int(getattr(jst, f)) == int(getattr(tst, f)), f
    plain, _ = trender.render_frame(TCFG, ts, W, H, _uniforms(hqs, False)[1],
                                    WIN, WIN)
    _check_overlay_frame(jimg, timg, plain, hqs)


@pytest.mark.parametrize("hqs", [False, True])
def test_pooled_frame_with_boxes_matches_jax(scene, hqs):
    js, ts = scene
    ju, tu = _uniforms(hqs, budget=1.0)
    ws = (1 << 16, 1 << 17, 1 << 13)
    jpool = jdp.build_draw_pool(CFG, js, *ws, CFG.draw_cap)
    tpool = tdp.pool_from_numpy({k: np.asarray(v)
                                 for k, v in jpool._asdict().items()},
                                device="cpu")
    jimg, _ = jrender.render_frame_pooled(CFG, js, jpool, W, H, ju,
                                          WIN, WIN, WIN, WIN)
    timg, _ = trender.render_frame_pooled(TCFG, ts, tpool, W, H, tu,
                                          WIN, WIN, WIN, WIN)
    plain, _ = trender.render_frame_pooled(
        TCFG, ts, tpool, W, H, _uniforms(hqs, False, 1.0)[1], WIN, WIN, WIN,
        WIN)
    _check_overlay_frame(jimg, timg, plain, hqs)
