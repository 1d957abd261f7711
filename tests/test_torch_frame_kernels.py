"""The frame kernels' plain versions against the JAX package on the CPU, and
what their CUDA wrappers do without a card.

csrc/frame.cu holds three kernels for the stages XLA fuses in the JAX
package's jitted frame; each has a plain PyTorch version that the CPU runs:
  - compute_visibility_reference (render/visibility.py) against JAX
    visibility.compute_visibility, and with a draw pool its takes and exact
    masks against JAX drawpool.node_budgets / split_masks / _pool_take:
    bit-equal (extents compared as values, NaN where JAX has NaN), with a
    camera whose eye plane cuts the root's box (NaN extents) and one inside
    the cloud (nodes behind the eye);
  - plan_blocks_reference (ops/ragged.py) with the fused selection against
    JAX ragged.plan on inputs masked as the JAX gathers mask them, with empty
    segments and a truncating window: bit-equal on the rows the plan draws;
    and against the plain version on pre-masked inputs: bit-equal on every
    field, junk rows included;
  - edl_reference (render/raster.py) against JAX raster.edl at sizes from
    1 x 1 up (the neighbours wrap, the card kernel's tiles are partial):
    within 1 per channel (XLA and torch round log2 / exp differently), and
    against the formula it had before it became a kernel's plain version:
    bit-equal;
  - frustum.frustum_planes_host (the planes the visibility kernel takes by
    value) against frustum.frustum_planes and JAX's: bit-equal; and the
    planes and packed arguments Uniforms.make computes once per frame;
  - plan_blocks_many (a frame's sets in one call) against JAX ragged.plan
    set by set, 1 to 8 sets; the arena layout of its CUDA wrapper as a pure
    function; a CPU frame plans its sets in one call.
The card-only comparisons (kernel against plain version, bit-equal) are in
tests/test_torch_port.py under the `cuda` marker.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simlod_tpu.config import Settings as JSet, Uniforms as JUni
from simlod_tpu.ops import ragged as jragged
from simlod_tpu.render import drawpool as jdp
from simlod_tpu.render import frustum as jfrustum
from simlod_tpu.render import raster as jr
from simlod_tpu.render import visibility as jvis
from simlod_tpu_torch import kernels
from simlod_tpu_torch.config import (EngineConfig as TCfg, Settings as TSet,
                                     Uniforms as TUni)
from simlod_tpu_torch.engine import Engine
from simlod_tpu_torch.formats import simlod, synthetic
from simlod_tpu_torch.octree.structures import state_from_numpy
from simlod_tpu_torch.ops import ragged as tragged
from simlod_tpu_torch.render import drawpool as tdp
from simlod_tpu_torch.render import frustum as tfrustum
from simlod_tpu_torch.render import raster as tr
from simlod_tpu_torch.render import visibility as tvis
from simlod_tpu_torch.render.camera import Camera, OrbitControls

from test_render import CFG, W, H, build_state, look_at_cloud

# six test processes share the machine in the tier-1 run; these small tensors
# gain nothing from intra-op threads, which would oversubscribe the cores
torch.set_num_threads(1)

TCFG = TCfg(**dataclasses.asdict(CFG))


def _inside_transform():
    """An eye inside the unit cloud: nodes behind it and nodes cut by the
    eye plane."""
    c = Camera(width=W, height=H)
    orbit = OrbitControls()
    orbit.focus_box([0, 0, 0], [1, 1, 1])
    orbit.radius = 0.1
    c.world = orbit.world()
    return c.transform()


# w = z: the root's corners at z = 0 project to 0/0 and x/0, so its screen
# extent is NaN, as in every version
EYE_PLANE = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, -0.1],
                      [0, 0, 1, 0]], np.float32)
CAMERAS = {"orbit": lambda: look_at_cloud().transform(),
           "inside": _inside_transform, "eye_plane": lambda: EYE_PLANE}


def _uniforms(t, budget=0.0, edl_strength=0.4):
    kw = dict(point_budget=budget, min_node_size=8.0,
              edl_strength=edl_strength)
    return (JUni.make(W, H, t, settings=JSet(**kw)),
            TUni.make(W, H, t, settings=TSet(**kw), device="cpu"))


@pytest.fixture(scope="module")
def scene():
    """(JAX state, port state, JAX pool, the same pool in the port)."""
    rng = np.random.default_rng(1234)
    xyz = rng.random((6000, 3), dtype=np.float32) * 0.9 + 0.05
    rgba = (rng.integers(0, 1 << 24, 6000, dtype=np.uint32)
            | np.uint32(0xFF000000))
    js = build_state(xyz, rgba)
    ts = state_from_numpy({k: np.asarray(v) for k, v in vars(js).items()},
                          device="cpu")
    pool_w = 1 << max(jragged.window_for(
        int(js.pool_used), max(int(js.num_segments), 1)) - 1, 1).bit_length()
    vox_w = 1 << max(int(js.vox_compacted), 128).bit_length()
    node_w = 1 << max(int(js.num_nodes), 64).bit_length()
    jpool = jdp.build_draw_pool(CFG, js, pool_w, vox_w, node_w, CFG.draw_cap)
    tpool = tdp.pool_from_numpy({k: np.asarray(v)
                                 for k, v in jpool._asdict().items()},
                                device="cpu")
    return js, ts, jpool, tpool


@pytest.mark.parametrize("budget", [0.0, 0.05, 1.0])
@pytest.mark.parametrize("camera", list(CAMERAS))
def test_visibility_reference_matches_jax(scene, camera, budget):
    js, ts, jpool, tpool = scene
    ju, tu = _uniforms(CAMERAS[camera](), budget)
    jv = jvis.compute_visibility(js, ju)
    tv = tvis.compute_visibility(ts, tu, tpool, TCFG)
    for f in ("emitted", "visible", "is_large", "dx", "dy",
              "num_visible_nodes", "num_visible_inner", "num_visible_leaves",
              "num_visible_points", "num_visible_voxels"):
        np.testing.assert_array_equal(np.asarray(getattr(jv, f)),
                                      getattr(tv, f).numpy(), err_msg=f)
    budgets = jdp.node_budgets(CFG, jv, ju)
    m_pp, m_ep, m_pv, m_ev = jdp.split_masks(CFG, js, jv, jpool)
    for got, want in ((tv.take_p, jdp._pool_take(m_pp, jpool.pt_cnt, budgets)),
                      (tv.take_v, jdp._pool_take(m_pv, jpool.vx_cnt, budgets)),
                      (tv.exact_p, m_ep), (tv.exact_v, m_ev)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # without a pool: the same selection, no pooled fields
    plain = tvis.compute_visibility(ts, tu)
    assert torch.equal(plain.emitted, tv.emitted) and plain.take_p is None
    dx = tv.dx.numpy()
    if camera == "eye_plane":
        assert np.isnan(dx).any()
    else:
        assert tv.emitted.any() and np.isfinite(dx[tv.emitted.numpy()]).all()
    if camera == "inside":
        assert (~tv.visible[:int(ts.num_nodes)]).any()


@pytest.mark.parametrize("camera", list(CAMERAS))
def test_host_frustum_planes_match(camera):
    t = CAMERAS[camera]()
    host = tfrustum.frustum_planes_host(t)
    dev = tfrustum.frustum_planes(torch.as_tensor(t, dtype=torch.float32))
    np.testing.assert_array_equal(host.view(np.int32),
                                  dev.numpy().view(np.int32))
    jax_planes = np.asarray(jfrustum.frustum_planes(
        jnp.asarray(np.asarray(t, np.float32))))
    np.testing.assert_array_equal(host, jax_planes)


def _segments(rng, S, nodes):
    """Ragged segments over a pool: a quarter empty, some long (several
    128-row blocks), and each segment's node (-1 for some)."""
    cnt = rng.integers(1, 300, S).astype(np.int32)
    cnt[rng.random(S) < 0.25] = 0
    cnt[rng.random(S) < 0.05] = 900
    off = np.concatenate([[0], np.cumsum(cnt + rng.integers(0, 40, S))[:-1]])
    node = rng.integers(0, nodes, S).astype(np.int32)
    node[rng.random(S) < 0.1] = -1
    return off.astype(np.int32), cnt, node


# name: (segments, node mask entries or None for a per-segment mask or None
# for no mask, window rows)
PLAN_CASES = {
    "by_node": (400, 64, 1 << 16),
    "by_node_truncating": (400, 64, 128 * 60),
    "per_segment": (300, None, 1 << 16),
    "per_segment_truncating": (300, None, 128 * 40),
    "unmasked": (200, 0, 1 << 16),
    "unmasked_truncating": (200, 0, 128 * 30),
}


def _select_case(rng, S, nodes, off, cnt, node):
    """(mask, index, selected) of a PLAN_CASES selection kind."""
    if nodes == 0:             # no mask: every segment as it is
        return None, None, np.ones(S, bool)
    if nodes is None:          # one entry per segment (voxel sets, per node)
        mask = rng.random(S) < 0.6
        return mask, None, mask
    mask = rng.random(nodes) < 0.6   # a node mask through seg_node (points)
    sel = (cnt > 0) & (node >= 0) & mask[np.clip(node, 0, nodes - 1)]
    return mask, node, sel


def _check_plan(bp, off, cnt, sel, out_len, truncating=None):
    """A block plan of the selected segments against the plain version on
    inputs masked beforehand (every field bit-equal) and against JAX
    ragged.plan on them (the rows the plan draws)."""
    t = torch.from_numpy
    counts = np.where(sel, cnt, 0).astype(np.int32)
    offs = np.where(sel, off, 0).astype(np.int32)
    pre = tragged.plan_blocks_reference(t(offs), t(counts), out_len)
    for f in ("src_row", "pstart_r", "pend_r", "r_ok", "sr", "mpos", "count"):
        assert torch.equal(getattr(bp, f), getattr(pre, f)), f
    jp = jragged.plan(jnp.asarray(offs), jnp.asarray(counts), out_len)
    ok = np.asarray(jp.r_ok)
    np.testing.assert_array_equal(bp.r_ok.numpy(), ok)
    np.testing.assert_array_equal(bp.src_row.numpy()[ok],
                                  np.asarray(jp.src_row)[ok])
    np.testing.assert_array_equal(bp.mpos.numpy(), np.asarray(jp.mpos))
    el = tragged.expand(bp)
    valid = np.asarray(jp.valid)
    np.testing.assert_array_equal(el.valid.numpy(), valid)
    np.testing.assert_array_equal(el.elem.numpy()[valid],
                                  np.asarray(jp.elem)[valid])
    np.testing.assert_array_equal(el.seg_of.numpy()[valid],
                                  np.asarray(jp.seg_of)[valid])
    assert int(bp.count) == min(int(counts.sum()), out_len)
    if truncating is not None:
        assert (int(counts.sum()) > out_len) == truncating
        assert ok.all() == truncating


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_blocks_selection_matches_jax_plan(case):
    S, nodes, out_len = PLAN_CASES[case]
    rng = np.random.default_rng(len(case))
    off, cnt, node = _segments(rng, S, nodes or 8)
    mask, index, sel = _select_case(rng, S, nodes, off, cnt, node)
    t = lambda a: None if a is None else torch.from_numpy(a)
    bp = tragged.plan_blocks(t(off), t(cnt), out_len, t(mask), t(index))
    _check_plan(bp, off, cnt, sel, out_len, case.endswith("truncating"))


# sets planned in one plan_blocks_many call: (segments, node mask entries as
# in PLAN_CASES or "none" for a mask that selects nothing, window rows)
MANY_SETS = {
    "tiles": (2500, 64, 1 << 19),          # several 1024-segment tiles
    "one_segment": (1, None, 1 << 10),
    "none_selected": (700, "none", 1 << 14),
    "truncating": (1500, 64, 128 * 60),    # a window under the selection
    "unmasked": (3000, 0, 1 << 20),
}
MANY_CASES = {
    "1_set": ["tiles"],
    "2_sets": ["tiles", "one_segment"],
    "4_sets": ["truncating", "none_selected", "unmasked", "one_segment"],
    "8_sets": ["tiles", "one_segment", "none_selected", "truncating",
               "unmasked", "one_segment", "tiles", "truncating"],
}


@pytest.mark.parametrize("case", list(MANY_CASES))
def test_plan_blocks_many_matches_jax_plan_set_by_set(case):
    rng = np.random.default_rng(len(case))
    t = lambda a: None if a is None else torch.from_numpy(a)
    specs, want = [], []
    for name in MANY_CASES[case]:
        S, nodes, out_len = MANY_SETS[name]
        off, cnt, node = _segments(rng, S, 64)
        if nodes == "none":
            mask, index, sel = np.zeros(S, bool), None, np.zeros(S, bool)
        else:
            mask, index, sel = _select_case(rng, S, nodes, off, cnt, node)
        specs.append((t(off), t(cnt), out_len, t(mask), t(index)))
        want.append((off, cnt, sel, out_len, name == "truncating"))
    plans = tragged.plan_blocks_many(specs)
    assert len(plans) == len(specs)
    for bp, w in zip(plans, want):
        _check_plan(bp, *w)
    assert sum(int(bp.count) for bp in plans) > 0


@pytest.mark.parametrize("nsets", range(1, tragged.MAX_PLANS + 1))
def test_plan_arena_views_are_aligned_and_disjoint(nsets):
    """The layout of plan_blocks_many_cuda's arena (one chunk per output and
    scratch array), as a pure function and carved on the CPU: every view on
    an ALIGN-byte boundary, of its chunk's size and dtype, none overlapping,
    all inside the arena."""
    rng = np.random.default_rng(nsets)
    sizes = [(int(rng.integers(1, 5000)), int(rng.integers(0, 3000)))
             for _ in range(nsets)]
    chunks = tragged.plan_chunks(sizes)
    assert len(chunks) == 8 * nsets + 1
    nbytes = [n * dt.itemsize for n, dt in chunks]
    offs, total = kernels.arena_layout(nbytes)
    spans = sorted(zip(offs, nbytes))
    assert all(o % kernels.ALIGN == 0 for o in offs)
    assert all(a + n <= b for (a, n), (b, _) in zip(spans, spans[1:]))
    assert spans[-1][0] + spans[-1][1] <= total and total % kernels.ALIGN == 0
    # the outputs become tensors, the scratch only pointers
    nviews = 6 * nsets + 1
    views, ptrs = kernels.carve(torch.device("cpu"), chunks, nviews)
    assert len(views) == nviews and len(ptrs) == len(chunks)
    base = ptrs[0] - offs[0]
    assert [p - base for p in ptrs] == offs
    ranges = []
    for v, p, (n, dt) in zip(views, ptrs, chunks):
        assert v.dtype == dt and tuple(v.shape) == (n,) and v.is_contiguous()
        assert v.data_ptr() == p or n == 0
        ranges.append((p, p + n * dt.itemsize))
    ranges += [(p, p + n * dt.itemsize)
               for p, (n, dt) in zip(ptrs[nviews:], chunks[nviews:])]
    ranges.sort()
    assert all(a[1] <= b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(p % kernels.ALIGN == 0 for p in ptrs)
    assert ranges[-1][1] - base <= total


def test_arena_layout_pads_each_chunk_to_the_alignment():
    assert kernels.arena_layout([5, 16, 0, 3]) == ([0, 16, 32, 32], 48)
    assert kernels.arena_layout([]) == ([], kernels.ALIGN)
    assert kernels.arena_layout([1, 1], align=256) == ([0, 256], 512)


def test_a_failed_launch_raises():
    kernels.check_launch(0, "plan_blocks_many_cuda")
    with pytest.raises(RuntimeError, match="CooperativeLaunchTooLarge"):
        kernels.check_launch(kernels.COOPERATIVE_LAUNCH_TOO_LARGE,
                             "plan_blocks_many_cuda")
    with pytest.raises(RuntimeError, match="cudaError 1"):
        kernels.check_launch(1, "compute_visibility_cuda")


@pytest.mark.parametrize("camera", list(CAMERAS))
def test_uniforms_host_planes_match_the_device_planes(camera):
    """The planes and the visibility kernel's packed arguments that
    Uniforms.make computes once per frame: the planes bit-equal to
    frustum.frustum_planes of the frozen transform."""
    t = CAMERAS[camera]()
    _, tu = _uniforms(t, 0.5)
    want = tfrustum.frustum_planes(tu.transform_update_bound).numpy()
    host = np.array(tu.host.planes, np.float32)
    np.testing.assert_array_equal(host.view(np.int32),
                                  want.reshape(-1).view(np.int32))
    packed = np.frombuffer(tu.host.vis_floats, np.float32)
    assert packed.shape == (44,)
    np.testing.assert_array_equal(
        packed[:16].view(np.int32),
        tu.transform_update_bound.numpy().reshape(-1).view(np.int32))
    np.testing.assert_array_equal(packed[16:40].view(np.int32),
                                  host.view(np.int32))
    np.testing.assert_array_equal(packed[40:], np.float32([W, H, 8.0, 0.5]))


def _old_edl(color, depth_bits, uniforms, width, height):
    """raster.edl as it was before it became the kernel's plain version."""
    d = depth_bits.view(torch.float32).reshape(height, width)
    logd = torch.log2(d)
    resp = torch.zeros_like(logd)
    for dx, dy in ((0, 1), (1, 0), (0, -1), (-1, 0)):
        shifted = torch.roll(logd, shifts=(-dy, -dx), dims=(0, 1))
        diff = logd - shifted
        diff = torch.where(torch.isnan(diff), 0.0, torch.clamp(diff, min=0.0))
        resp = resp + diff
    resp = resp / 50.0
    shade = torch.exp(-resp * 300.0 * uniforms.edl_strength).reshape(-1)
    c = color.to(torch.int64) & 0xFFFFFFFF
    ch = lambda k: ((((c >> (8 * k)) & 0xFF).to(torch.float32) * shade)
                    .to(torch.int64))
    return tr.u32_bits(ch(0) | (ch(1) << 8) | (ch(2) << 16) | 0xFF000000)


def _edl_inputs(seed, w=W, h=H):
    """Colours and depth bits with background (+inf) patches, drawn pixels
    on the image edges (the neighbours wrap) and depth steps, cut to w x h."""
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.5, 50.0, (H, W)).astype(np.float32)
    depth[rng.random((H, W)) < 0.3] = np.inf
    depth[10:30, 20:60] = np.inf
    color = rng.integers(0, 2**32, (H, W), dtype=np.uint64).astype(np.uint32)
    depth, color = depth[:h, :w].copy(), color[:h, :w].copy()
    depth[:, 0] = depth[:, -1] = 2.0
    depth[0, :] = 0.75
    return color.reshape(-1).view(np.int32), depth.reshape(-1).view(np.int32)


# the sizes wrap onto the pixel itself (1 x 1), wrap within one tile of the
# card kernel (3 x 2), leave partial 128 x 8 tiles and a partial group of a
# thread's 4 pixels (33 x 9), and the test size
@pytest.mark.parametrize("size", [(1, 1), (3, 2), (33, 9), (W, H)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("strength", [0.4, 1.5])
@pytest.mark.parametrize("seed", [0, 1])
def test_edl_reference_matches_jax_and_the_old_formula(seed, strength, size):
    w, h = size
    color, depth = _edl_inputs(seed, w, h)
    ju, tu = _uniforms(np.eye(4, dtype=np.float32), edl_strength=strength)
    got = tr.edl_reference(torch.from_numpy(color), torch.from_numpy(depth),
                           tu, w, h)
    assert torch.equal(got, _old_edl(torch.from_numpy(color),
                                     torch.from_numpy(depth), tu, w, h))
    assert torch.equal(got, tr.edl(torch.from_numpy(color),
                                   torch.from_numpy(depth), tu, w, h))
    want = np.asarray(jr.edl(jnp.asarray(color.view(np.uint32)),
                             jnp.asarray(depth), ju, w, h)).view(np.uint32)
    g = got.numpy().view(np.uint32)
    for k in range(4):
        d = np.abs(((want >> 8 * k) & 0xFF).astype(int)
                   - ((g >> 8 * k) & 0xFF).astype(int))
        assert d.max() <= 1, k
    shaded = (g & 0xFF) < (color.view(np.uint32) & 0xFF)
    if w * h == 1:
        # every neighbour of the one pixel is the pixel itself: no shade
        assert np.array_equal(g, color.view(np.uint32) | 0xFF000000)
    elif (w, h) == (W, H):
        assert shaded.mean() > 0.05
    else:
        assert shaded.any()


def _wrapper_calls(ts, tu, tpool):
    col = torch.zeros(W * H, dtype=torch.int32)
    return {
        "visibility": (tvis.compute_visibility_cuda,
                       lambda: tvis.compute_visibility_cuda(ts, tu)),
        "visibility_pooled": (tvis.compute_visibility_cuda,
                              lambda: tvis.compute_visibility_cuda(
                                  ts, tu, tpool, TCFG)),
        "plan_blocks": (tragged.plan_blocks_cuda,
                        lambda: tragged.plan_blocks_cuda(
                            ts.seg_off, ts.seg_cnt, 1 << 12)),
        "plan_blocks_many": (tragged.plan_blocks_cuda,
                             lambda: tragged.plan_blocks_many_cuda([
                                 (ts.seg_off, ts.seg_cnt, 1 << 12),
                                 (ts.vox_voff, ts.vox_vcnt, 1 << 12)])),
        "edl": (tr.edl_cuda, lambda: tr.edl_cuda(col, col, tu, W, H)),
    }


@pytest.mark.parametrize("kernel", ["visibility", "visibility_pooled",
                                    "plan_blocks", "plan_blocks_many", "edl"])
def test_kernel_wrappers_raise_on_cpu_tensors(scene, kernel):
    _, ts, _, tpool = scene
    _, tu = _uniforms(look_at_cloud().transform(), 1.0)
    fn, call = _wrapper_calls(ts, tu, tpool)[kernel]
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA"):
        call()
    assert fn.launches == before


WRAPPERS = (tvis.compute_visibility_cuda, tragged.plan_blocks_cuda,
            tr.edl_cuda, tr.splat_samples)


@pytest.fixture(scope="module")
def cloud(tmp_path_factory):
    xyz, rgba = synthetic.terrain(30_000, seed=5, extent=1.0, z_scale=0.4)
    path = str(tmp_path_factory.mktemp("frame_kernels") / "t.simlod")
    simlod.write(path, xyz, rgba)
    return path


@pytest.mark.parametrize("budget", [0.0, 1.0])
def test_cpu_frames_take_the_plain_versions(monkeypatch, cloud, budget):
    """Streamed and render-only CPU frames, exact and pooled, go through the
    plain versions of the frame kernels and count no kernel launch."""
    calls = {}
    for mod, name in ((tvis, "compute_visibility_reference"),
                      (tragged, "plan_blocks_reference"),
                      (tr, "edl_reference")):
        def counted(*a, _f=getattr(mod, name), _n=name, **k):
            calls[_n] = calls.get(_n, 0) + 1
            return _f(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    before = [f.launches for f in WRAPPERS]
    eng = Engine(TCfg(**dict(dataclasses.asdict(CFG), point_capacity=1 << 17,
                             voxel_capacity=1 << 19, step_points=1 << 13,
                             spill_capacity=1 << 13)),
                 TSet(min_node_size=8.0, point_budget=budget,
                      frame_budget_ms=0.0), device="cpu")
    eng.open([cloud], chunk_steps=1)
    frames = 0
    while not eng.last_batch_finished:
        img, st = eng.frame(W, H)
        frames += 1
    img, st = eng.render(W, H)
    assert [f.launches for f in WRAPPERS] == before
    assert calls["compute_visibility_reference"] >= frames + 1
    assert calls["plan_blocks_reference"] >= 2 * (frames + 1)
    assert calls["edl_reference"] >= frames + 1
    assert st.num_visible_points + st.num_visible_voxels > 0
    assert eng.report()["num_points"] == 30_000
    eng.stream.stop()


@pytest.mark.parametrize("budget", [0.0, 1.0])
def test_cpu_frame_plans_its_sets_in_one_call(monkeypatch, cloud, budget):
    """A render frame, exact (2 sets) and pooled (4 sets), plans its sample
    sets in one plan_blocks_many call."""
    eng = Engine(TCfg(**dict(dataclasses.asdict(CFG), point_capacity=1 << 17,
                             voxel_capacity=1 << 19, step_points=1 << 13,
                             spill_capacity=1 << 13)),
                 TSet(min_node_size=8.0, point_budget=budget), device="cpu")
    eng.open([cloud])
    eng.load_all()
    eng.render(W, H)          # builds the pool, sizes the windows
    calls = []
    orig = tragged.plan_blocks_many
    monkeypatch.setattr(tragged, "plan_blocks_many",
                        lambda specs: calls.append(len(specs)) or orig(specs))
    img, st = eng.render(W, H)
    assert calls == [4 if budget else 2]
    assert st.num_visible_points + st.num_visible_voxels > 0
    eng.stream.stop()
