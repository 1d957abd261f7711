"""The port's render stages against simlod_tpu.render on the CPU.

  - frustum, visibility, sample gathering, raster.rasterize: bit-equal;
  - rasterize_tiles (the port's tile path; on the CPU its tile resolve is the
    plain PyTorch version) against the JAX rasterize_tiles with the Pallas kernel
    in interpret mode: bit-equal colour and depth in both shading modes;
  - edl: within 1 per channel (XLA and torch round log2/exp differently in the
    last place, which can move floor(channel * shade) by one).

The octree these stages read is built by the port and carried to the JAX
package through state_to_numpy (the builder itself is held against JAX in
test_torch_build.py).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from simlod_tpu import constants as C
from simlod_tpu.config import EngineConfig as JCfg, Settings as JSet, Uniforms as JUni
from simlod_tpu.octree.structures import OctreeState as JState
from simlod_tpu.render import frustum as jf
from simlod_tpu.render import raster as jr
from simlod_tpu.render import raster_tiles as jt
from simlod_tpu.render import visibility as jv
from simlod_tpu.render.camera import Camera, OrbitControls
from simlod_tpu_torch.config import EngineConfig as TCfg, Settings as TSet, Uniforms as TUni
from simlod_tpu_torch.formats import synthetic
from simlod_tpu_torch.octree import build as tb
from simlod_tpu_torch.octree.structures import init_state, state_to_numpy
from simlod_tpu_torch.render import frustum as tf
from simlod_tpu_torch.render import raster as tr
from simlod_tpu_torch.render import raster_tiles as tt
from simlod_tpu_torch.render import visibility as tv

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


def _eq(j, t):
    np.testing.assert_array_equal(np.asarray(j).view(np.int32)
                                  if np.asarray(j).dtype == np.uint32
                                  else np.asarray(j), t.numpy())


def _uniforms(box_max, yaw, pitch, hqs, min_node_size=8.0):
    cam = Camera(width=W, height=H)
    orbit = OrbitControls()
    orbit.focus_box([0, 0, 0], box_max)
    orbit.yaw, orbit.pitch = yaw, pitch
    cam.world = orbit.world()
    kw = dict(use_high_quality_shading=hqs, min_node_size=min_node_size)
    return (JUni.make(W, H, cam.transform(), settings=JSet(**kw)),
            TUni.make(W, H, cam.transform(), settings=TSet(**kw)))


@pytest.fixture(scope="module")
def states():
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
    ts = tb.build_many(cfg, init_state(cfg, np.zeros(3, np.float32), box_max),
                       *map(torch.from_numpy, planes),
                       torch.from_numpy(cc.view(np.int32)), counts)
    ts = tb.compact_voxels(cfg, ts)
    js = JState(**{k: jnp.asarray(v) for k, v in state_to_numpy(ts).items()})
    return box_max, js, ts


def test_frustum_planes_and_test():
    rng = np.random.default_rng(0)
    _, tu = _uniforms(np.ones(3), 0.3, -0.5, True)
    m = tu.transform.numpy()
    jp, tp = jf.frustum_planes(jnp.asarray(m)), tf.frustum_planes(tu.transform)
    _eq(jp, tp)
    box = rng.uniform(-1, 2, (6, 2000)).astype(np.float32)
    box[3:] = box[:3] + np.abs(box[3:]) * 0.2
    _eq(jf.intersects_frustum_cols(jp, *map(jnp.asarray, box)),
        tf.intersects_frustum_cols(tp, *map(torch.from_numpy, box)))


@pytest.mark.parametrize("yaw,pitch", [(0.0, -0.6), (1.2, -0.3)])
def test_visibility_and_gather(states, yaw, pitch):
    box_max, js, ts = states
    ju, tu = _uniforms(box_max, yaw, pitch, True)
    a, b = jv.compute_visibility(js, ju), tv.compute_visibility(ts, tu)
    for f in a._fields:
        _eq(getattr(a, f), getattr(b, f))
    assert int(a.num_visible_points) + int(a.num_visible_voxels) > 0
    for jg, tg in ((jr.gather_point_samples, tr.gather_point_samples),
                   (jr.gather_voxel_samples, tr.gather_voxel_samples)):
        js_, ts_ = (jg(JCfg(**KW), js, a.emitted),
                    tr.materialize(tg(TCfg(**KW), ts, b.emitted)))
        v = np.asarray(js_.valid)
        np.testing.assert_array_equal(v, ts_.valid.numpy())
        for f in ("x", "y", "z", "rgba"):
            np.testing.assert_array_equal(
                np.asarray(getattr(js_, f)).view(np.int32)[v],
                getattr(ts_, f).numpy().view(np.int32)[v], err_msg=f)
        assert int(js_.count) == int(ts_.count)


def _samples(rng, n, spread=0.8):
    """Seeded samples as in tests/test_raster_tiles.py, for both packages."""
    x = rng.uniform(-spread, spread, n).astype(np.float32)
    y = rng.uniform(-spread, spread, n).astype(np.float32)
    z = rng.uniform(1.0, 5.0, n).astype(np.float32)
    rgba = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    # exact (pixel, depth) ties with other colours exercise the colour tiebreak
    x[100:200], y[100:200], z[100:200] = x[:100], y[:100], z[:100]
    valid = np.ones(n, bool)
    valid[-3:] = False
    js = jr.Samples(x=jnp.asarray(x), y=jnp.asarray(y), z=jnp.asarray(z),
                    rgba=jnp.asarray(rgba),
                    node_fn=lambda: jnp.zeros(n, jnp.int32),
                    level_fn=lambda: jnp.zeros(n, jnp.int32),
                    valid=jnp.asarray(valid), count=jnp.int32(n - 3))
    ts = tr.Samples(x=torch.from_numpy(x), y=torch.from_numpy(y),
                    z=torch.from_numpy(z),
                    rgba=torch.from_numpy(rgba.view(np.int32)),
                    node_fn=lambda: torch.zeros(n, dtype=torch.int32),
                    level_fn=lambda: torch.zeros(n, dtype=torch.int32),
                    valid=torch.from_numpy(valid), count=torch.tensor(n - 3))
    return js, ts


def _ortho(hqs):
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = m[1, 1] = m[3, 2] = 1.0
    kw = dict(use_high_quality_shading=hqs, enable_edl=False)
    return JUni.make(W, H, m, settings=JSet(**kw)), TUni.make(W, H, m, settings=TSet(**kw))


@pytest.mark.parametrize("hqs", [True, False])
def test_rasterize_tiles_matches_pallas_kernel(hqs):
    js, ts = _samples(np.random.default_rng(7), 4096)
    ju, tu = _ortho(hqs)
    jc, jd = jt.rasterize_tiles(JCfg(), ju, W, H, [js], interpret=True)
    tc, td = tt.rasterize_tiles(TCfg(), tu, W, H, [ts])
    _eq(jd, td)
    _eq(jc, tc)
    assert (tc.numpy() != C.BACKGROUND_COLOR).mean() > 0.05


@pytest.mark.parametrize("hqs", [True, False])
def test_rasterize_scatter_path_bit_equal(hqs):
    js, ts = _samples(np.random.default_rng(9), 4096)
    ju, tu = _ortho(hqs)
    jc, jd = jr.rasterize(JCfg(), ju, W, H, [js])
    tc, td = tr.rasterize(TCfg(), tu, W, H, [ts])
    _eq(jd, td)
    _eq(jc, tc)


def test_tile_resolve_reference_empty_frame():
    js, ts = _samples(np.random.default_rng(3), 256)
    ts = ts._replace(valid=torch.zeros(256, dtype=torch.bool))
    _, tu = _ortho(True)
    c, d = tt.rasterize_tiles(TCfg(), tu, 128, 64, [ts])
    assert (c.numpy() == C.BACKGROUND_COLOR).all()
    assert (d.numpy() == C.DEPTH_INF_BITS).all()


@pytest.mark.parametrize("yaw,pitch", [(0.0, -0.6), (1.2, -0.3)])
def test_edl_within_one(states, yaw, pitch):
    box_max, js, ts = states
    ju, tu = _uniforms(box_max, yaw, pitch, True)
    a, b = jv.compute_visibility(js, ju), tv.compute_visibility(ts, tu)
    jsets = [jr.gather_point_samples(JCfg(**KW), js, a.emitted),
             jr.gather_voxel_samples(JCfg(**KW), js, a.emitted)]
    jc, jd = jr.rasterize(JCfg(**KW), ju, W, H, jsets)
    out_j = np.asarray(jr.edl(jc, jd, ju, W, H)).view(np.uint32)
    out_t = tr.edl(torch.from_numpy(np.array(jc).view(np.int32)),
                   torch.from_numpy(np.array(jd)), tu, W, H).numpy().view(np.uint32)
    for k in range(4):
        d = np.abs(((out_j >> 8 * k) & 0xFF).astype(int)
                   - ((out_t >> 8 * k) & 0xFF).astype(int))
        assert d.max() <= 1, k
    assert (np.asarray(jd) != C.DEPTH_INF_BITS).mean() > 0.05
