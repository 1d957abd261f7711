"""The port's helper functions against their simlod_tpu counterparts on the
CPU, on inputs made from a seed with numpy:

  - ops/segments.py carry_last, next_start_pos: bit-equal, int32, with the
    empty and one-row cases;
  - ops/morton.py quantize (box edges, the exact max boundary, coordinates
    on cell boundaries, outside the box, NaN and inf), octant_at_level,
    cell_at_level, cell_to_xyz, prefix_at_level at every level: bit-equal;
  - octree/structures.py OctreeState.pt_positions / pt_xyz, node_min_size,
    is_leaf, active_mask on a JAX state with random levels 0-20 carried
    across with state_from_numpy(..., device="cpu"): bit-equal, except
    node_min_size at the levels where XLA's exp2 misses 2^L, where the
    port's exact sizes are held to numpy's;
  - render/frustum.py intersects_frustum on random boxes and on boxes whose
    p-vertex is placed on a plane from its equation: equal masks;
  - config.Stats.zeros: equal values and dtypes;
  - render/raster.py gather_point_samples / gather_voxel_samples and
    render/drawpool.py gather_pool_points / gather_pool_voxels on the scene
    of tests/test_torch_draw.py: equal validity and count, columns equal on
    valid rows;
  - native.available / cols_available / laz_available, formats.laz.available:
    True here (a C compiler is present) and equal to the JAX probes;
  - every state-making function called without a device where there is no
    card raises (torch.cuda.is_available patched to False).

No helper reaches a kernel; chip_smoke.py runs them on the card against
their CPU results and the visibility kernel.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simlod_tpu import config as jconfig
from simlod_tpu import native as jnative
from simlod_tpu.formats import laz as jlaz
from simlod_tpu.octree import structures as jst
from simlod_tpu.ops import morton as jm
from simlod_tpu.ops import segments as jseg
from simlod_tpu.render import drawpool as jdp
from simlod_tpu.render import frustum as jfr
from simlod_tpu.render import raster as jr
from simlod_tpu.render import visibility as jv
from simlod_tpu.render.camera import Camera, OrbitControls
from simlod_tpu_torch import config as tconfig
from simlod_tpu_torch import native as tnative
from simlod_tpu_torch.formats import laz as tlaz
from simlod_tpu_torch.formats import simlod, synthetic
from simlod_tpu_torch.io.streaming import PointStream
from simlod_tpu_torch.octree import structures as tst
from simlod_tpu_torch.ops import morton as tm
from simlod_tpu_torch.ops import segments as tseg
from simlod_tpu_torch.render import drawpool as tdp
from simlod_tpu_torch.render import frustum as tfr
from simlod_tpu_torch.render import raster as tr

from test_torch_draw import KW, TRUNC, WIN, _np, _uniforms, scene  # noqa: F401

# six test processes share the machine in the tier-1 run; these small tensors
# gain nothing from intra-op threads, which would oversubscribe the cores
torch.set_num_threads(1)


def _eq(j, t):
    """Bit-equal values, and the same dtype (u32 as its int32 pattern)."""
    j = _np(j)
    t = t.numpy()
    assert j.dtype == t.dtype, (j.dtype, t.dtype)
    np.testing.assert_array_equal(j.view(np.int32) if j.dtype == np.float32
                                  else j, t.view(np.int32)
                                  if t.dtype == np.float32 else t)


# --- ops/segments.py ---------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 2, 1000])
def test_carry_last_matches_jax(n):
    rng = np.random.default_rng(n)
    marked = rng.random(n) < 0.1
    if n:
        marked[rng.integers(n)] = True
    # non-decreasing values at marked rows (positions, with repeats)
    vals = np.sort(rng.integers(0, 50, n)).astype(np.int32)
    markers = np.where(marked, vals, -1).astype(np.int32)
    _eq(jseg.carry_last(jnp.asarray(markers)),
        tseg.carry_last(torch.from_numpy(markers)))


@pytest.mark.parametrize("n", [0, 1, 2, 1000])
@pytest.mark.parametrize("density", [0.0, 0.05, 1.0])
def test_next_start_pos_matches_jax(n, density):
    starts = np.random.default_rng(n).random(n) < density
    _eq(jseg.next_start_pos(jnp.asarray(starts)),
        tseg.next_start_pos(torch.from_numpy(starts)))


# --- ops/morton.py -----------------------------------------------------------

def _quantize_inputs(rng, box_min, cube, bits):
    g = np.float32(1 << bits)
    inside = box_min + rng.random((500, 3)).astype(np.float32) * cube
    edges = np.stack([box_min, box_min + cube,                # min, max corner
                      np.nextafter(box_min + cube, np.float32(np.inf)),
                      np.nextafter(box_min + cube, np.float32(-np.inf)),
                      box_min - np.float32(1.0)]).astype(np.float32)
    # coordinates on cell boundaries: box_min + k * cube / 2^bits
    k = rng.integers(0, 1 << bits, (200, 3)).astype(np.float32)
    cells = (box_min + k * (cube / g)).astype(np.float32)
    odd = np.array([[1e12, -1e12, np.nan], [np.inf, -np.inf, 0.0]],
                   np.float32) + box_min
    return np.concatenate([inside, edges, cells, odd]).astype(np.float32)


@pytest.mark.parametrize("bits", [28, 7])
@pytest.mark.parametrize("box", ["unit", "offset"])
def test_quantize_matches_jax(bits, box):
    rng = np.random.default_rng(bits)
    box_min, cube = ((np.zeros(3, np.float32), np.float32(1.0)) if box == "unit"
                     else (np.array([-3.7, 12.25, 1e3], np.float32),
                           np.float32(317.3)))
    xyz = _quantize_inputs(rng, box_min, cube, bits)
    j = jm.quantize(jnp.asarray(xyz), jnp.asarray(box_min), jnp.asarray(cube),
                    bits)
    t = tm.quantize(torch.from_numpy(xyz), torch.from_numpy(box_min),
                    torch.tensor(cube), bits)
    assert tuple(t.shape) == xyz.shape
    _eq(j, t)
    # the max corner lands in the last cell, not past it
    assert (t[501] == (1 << bits) - 1).all()


def _coords(n=2000, seed=5):
    q = np.random.default_rng(seed).integers(0, 1 << 28, (3, n)).astype(np.int32)
    q[:, :3] = [[0, (1 << 28) - 1, 1 << 27]] * 3
    return q


@pytest.mark.parametrize("level", ["per_row", *range(0, 21, 4), 20])
@pytest.mark.parametrize("fn", ["octant_at_level", "cell_at_level",
                                "prefix_at_level"])
def test_level_helpers_match_jax(fn, level):
    q = _coords()
    if level == "per_row":
        lv = np.random.default_rng(9).integers(0, 21, q.shape[1]).astype(
            np.int32)
        jl, tl = jnp.asarray(lv), torch.from_numpy(lv)
    else:
        jl = tl = level
    j = getattr(jm, fn)(*map(jnp.asarray, q), jl)
    t = getattr(tm, fn)(*map(torch.from_numpy, q), tl)
    for a, b in (zip(j, t) if isinstance(j, tuple) else [(j, t)]):
        _eq(a, b)
    if fn == "cell_at_level":
        for a, b in zip(jm.cell_to_xyz(j), tm.cell_to_xyz(t)):
            _eq(a, b)


# --- octree/structures.py ----------------------------------------------------

@pytest.fixture(scope="module")
def states():
    """(JAX state, port state): a JAX init_state with seeded random node and
    point columns, carried across with state_from_numpy(..., device="cpu")."""
    rng = np.random.default_rng(3)
    cfg = jconfig.EngineConfig(**KW)
    js = jst.init_state(cfg, np.array([-2.5, 0.125, 40.0], np.float32),
                        np.array([7.0, 3.0, 41.0], np.float32))
    n = js.child_base.shape[0]
    p = js.pt_w0.shape[0]
    level = rng.integers(0, 21, n).astype(np.int32)
    at = lambda: (rng.random(n) * np.exp2(level)).astype(np.int32)
    words = lambda bits: rng.integers(0, 1 << bits, p).astype(np.int32)
    js = dataclasses.replace(
        js, level=jnp.asarray(level), nx=jnp.asarray(at()),
        ny=jnp.asarray(at()), nz=jnp.asarray(at()),
        child_base=jnp.asarray(np.where(rng.random(n) < 0.3, -1,
                                        rng.integers(1, n, n)).astype(np.int32)),
        num_nodes=jnp.int32(n // 3), pt_w0=jnp.asarray(words(30)),
        pt_w1=jnp.asarray(words(30)), pt_w2=jnp.asarray(words(24)))
    ts = tst.state_from_numpy({k: np.asarray(v) for k, v in vars(js).items()},
                              device="cpu")
    return js, ts


def test_pt_positions_and_pt_xyz_match_jax(states):
    js, ts = states
    for a, b in zip(js.pt_positions(), ts.pt_positions()):
        _eq(a, b)
    _eq(js.pt_xyz, ts.pt_xyz)


@pytest.mark.parametrize("ids", ["all", "some"])
def test_node_min_size_matches_jax(states, ids):
    """Bit-equal where XLA's exp2 is exact. XLA lowers exp2(x) as
    exp(x * f32(ln 2)), which misses 2^L by a few ulp at L = 13, 15, 17, 19;
    the port's exp2, like its kernels' exp2f, is exact, so at those levels
    the port's sizes and corners are held to numpy's exact ones instead."""
    js, ts = states
    sel = np.arange(ts.child_base.shape[0]) if ids == "all" else \
        np.random.default_rng(4).integers(0, ts.child_base.shape[0], 300)
    jmn, jsize = jst.node_min_size(
        js, None if ids == "all" else jnp.asarray(sel.astype(np.int32)))
    tmn, tsize = tst.node_min_size(
        ts, None if ids == "all" else torch.from_numpy(sel.astype(np.int32)))
    level = ts.level.numpy()[sel]
    two_l = np.exp2(level.astype(np.float32))
    xla = np.asarray(jnp.exp2(jnp.asarray(level.astype(np.float32)))) == two_l
    assert xla.any() and (~xla).any()
    for a, b in ((jmn, tmn), (jsize, tsize)):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a[xla].view(np.int32),
                                      b[xla].view(np.int32))
    size = np.float32(ts.cube_size) / two_l
    n = np.stack([ts.nx.numpy(), ts.ny.numpy(), ts.nz.numpy()], -1)[sel]
    mn = ts.box_min.numpy()[None, :] + size[:, None] * n.astype(np.float32)
    np.testing.assert_array_equal(tsize.numpy().view(np.int32),
                                  size.view(np.int32))
    np.testing.assert_array_equal(tmn.numpy().view(np.int32),
                                  mn.view(np.int32))
    ulp = np.abs(np.asarray(jsize).view(np.int32) - size.view(np.int32))
    assert ulp[~xla].max() <= 8


@pytest.mark.parametrize("fn", ["is_leaf", "active_mask"])
def test_node_masks_match_jax(states, fn):
    js, ts = states
    j, t = getattr(jst, fn)(js), getattr(tst, fn)(ts)
    _eq(j, t)
    assert 0 < int(t.sum()) < t.shape[0]


# --- render/frustum.py -------------------------------------------------------

def _planes(yaw):
    c = Camera(width=160, height=120)
    o = OrbitControls()
    o.focus_box([0, 0, 0], [3, 2, 1])
    o.yaw, o.pitch = yaw, -0.5
    c.world = o.world()
    return np.array(jfr.frustum_planes(jnp.asarray(c.transform())))


@pytest.mark.parametrize("yaw", [0.3, 2.1])
@pytest.mark.parametrize("boxes", ["random", "on_a_plane"])
def test_intersects_frustum_matches_jax(yaw, boxes):
    rng = np.random.default_rng(int(yaw * 10))
    planes = _planes(yaw)
    n = 6000
    ext = rng.uniform(0.01, 2.0, (n, 3)).astype(np.float32)
    if boxes == "random":
        mn = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
        mx = (mn + ext).astype(np.float32)
    else:
        # p-vertices on plane i: pick x, y, solve the plane equation for z,
        # then grow the box away from the normal so that the p-vertex is p
        i = rng.integers(0, 6, n)
        nrm, d = planes[i, :3], planes[i, 3]
        p = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
        p[:, 2] = ((-d - p[:, 0] * nrm[:, 0] - p[:, 1] * nrm[:, 1])
                   / nrm[:, 2]).astype(np.float32)
        mx = np.where(nrm > 0, p, p + ext)
        mn = np.where(nrm > 0, p - ext, p)
        mx, mn = mx.astype(np.float32), mn.astype(np.float32)
    j = np.asarray(jfr.intersects_frustum(jnp.asarray(planes), jnp.asarray(mn),
                                          jnp.asarray(mx)))
    t = tfr.intersects_frustum(torch.from_numpy(planes), torch.from_numpy(mn),
                               torch.from_numpy(mx))
    np.testing.assert_array_equal(j, t.numpy())
    assert 0 < j.sum() < n
    if boxes == "on_a_plane":
        # the boxes sit where rounding decides: the column-wise test, which
        # rounds each product, disagrees with XLA's fused order on some
        cols = tfr.intersects_frustum_cols(
            torch.from_numpy(planes), *torch.from_numpy(mn.T.copy()),
            *torch.from_numpy(mx.T.copy()))
        assert (cols.numpy() != j).any()


# --- config.Stats.zeros ------------------------------------------------------

def test_stats_zeros_matches_jax():
    j = jconfig.Stats.zeros()
    t = tconfig.Stats.zeros(device="cpu")
    for f in dataclasses.fields(jconfig.Stats):
        a, b = getattr(j, f.name), getattr(t, f.name)
        assert b.shape == () and b.device.type == "cpu", f.name
        _eq(a, b)
    t.num_nodes += 1        # no field aliases another
    assert int(t.num_leaves) == 1


# --- the four sample gathers -------------------------------------------------

def _assert_same_samples(j, t):
    v = np.asarray(j.valid)
    np.testing.assert_array_equal(v, t.valid.numpy())
    for f in ("x", "y", "z", "rgba"):
        np.testing.assert_array_equal(
            _np(getattr(j, f)).view(np.int32)[v],
            getattr(t, f).numpy().view(np.int32)[v], err_msg=f)
    np.testing.assert_array_equal(_np(j.node_fn())[v], t.node_fn().numpy()[v])
    np.testing.assert_array_equal(_np(j.level_fn())[v], t.level_fn().numpy()[v])
    assert int(j.count) == int(t.count)
    return int(v.sum())


@pytest.mark.parametrize("win", [WIN, TRUNC])
@pytest.mark.parametrize("fn", ["gather_point_samples", "gather_voxel_samples"])
def test_state_gathers_match_jax(scene, fn, win):  # noqa: F811
    ts, js, _, _, box_max = scene
    ju, _ = _uniforms(box_max, {})
    cfg_j, cfg_t = jconfig.EngineConfig(**KW), tconfig.EngineConfig(**KW)
    emitted = jv.compute_visibility(js, ju).emitted
    j = getattr(jr, fn)(cfg_j, js, emitted, win)
    t = getattr(tr, fn)(cfg_t, ts, torch.from_numpy(np.array(emitted)), win)
    assert isinstance(t, tr.Samples)
    assert _assert_same_samples(j, t) > 0


@pytest.mark.parametrize("win", [WIN, TRUNC])
@pytest.mark.parametrize("kind", ["points", "voxels"])
def test_pool_gathers_match_jax(scene, kind, win):  # noqa: F811
    ts, js, tpool, jpool, box_max = scene
    ju, _ = _uniforms(box_max, dict(point_budget=1.0))
    cfg_j, cfg_t = jconfig.EngineConfig(**KW), tconfig.EngineConfig(**KW)
    vis = jv.compute_visibility(js, ju)
    budgets = jdp.node_budgets(cfg_j, vis, ju)
    m_pp, _, m_pv, _ = jdp.split_masks(cfg_j, js, vis, jpool)
    mask, cnt = (m_pp, jpool.pt_cnt) if kind == "points" \
        else (m_pv, jpool.vx_cnt)
    take = jdp._pool_take(mask, cnt, budgets)
    name = f"gather_pool_{kind}"
    j = getattr(jdp, name)(cfg_j, js, jpool, take, win)
    t = getattr(tdp, name)(cfg_t, ts, tpool, torch.from_numpy(np.array(take)),
                           win)
    assert _assert_same_samples(j, t) > 0


# --- codec probes ------------------------------------------------------------

@pytest.mark.parametrize("port, jax_probe", [
    (tnative.available, jnative.available),
    (tnative.cols_available, jnative.cols_available),
    (tnative.laz_available, jnative.laz_available),
    (tlaz.available, jlaz.available)], ids=["available", "cols_available",
                                            "laz_available", "laz.available"])
def test_codec_probes_match_jax(port, jax_probe):
    assert port() is True
    assert port() == jax_probe()


def test_codec_probe_is_false_when_the_build_fails(monkeypatch):
    def no_compiler(src_name):
        raise RuntimeError(f"no C compiler (cc) to build {src_name}")
    monkeypatch.setattr(tnative, "_libs", {})
    monkeypatch.setattr(tnative, "build", no_compiler)
    assert not tnative.available() and not tnative.laz_available()
    assert not tlaz.available()


# --- state-making functions default to the card -----------------------------

def _small_file(tmp_path):
    xyz, rgba = synthetic.terrain(1000, seed=1)
    path = str(tmp_path / "t.simlod")
    simlod.write(path, xyz, rgba)
    return path


STATE_MAKERS = {
    "EngineConfig.auto": lambda tmp: tconfig.EngineConfig.auto(
        total_points=1 << 20),
    "Uniforms.make": lambda tmp: tconfig.Uniforms.make(
        64, 48, np.eye(4, dtype=np.float32)),
    "init_state": lambda tmp: tst.init_state(
        tconfig.EngineConfig(**KW), np.zeros(3), np.ones(3)),
    "state_from_numpy": lambda tmp: tst.state_from_numpy(tst.state_to_numpy(
        tst.init_state(tconfig.EngineConfig(**KW), np.zeros(3), np.ones(3),
                       device="cpu"))),
    "pool_from_numpy": lambda tmp: tdp.pool_from_numpy(
        {f: np.zeros(4, np.int32) for f in tdp.DrawPool._fields}),
    "PointStream": lambda tmp: PointStream([_small_file(tmp)], 1 << 10),
    "Stats.zeros": lambda tmp: tconfig.Stats.zeros(),
}


@pytest.mark.parametrize("name", list(STATE_MAKERS))
def test_state_makers_default_to_the_card(monkeypatch, tmp_path, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=f"{name}\\(device=cuda\\): no CUDA"):
        STATE_MAKERS[name](tmp_path)
