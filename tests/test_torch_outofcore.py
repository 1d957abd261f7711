"""The port's out-of-core brick engine (simlod_tpu_torch.outofcore) against
simlod_tpu.outofcore on the CPU, on tests/test_outofcore.py's fixture: 2 LAS
bricks of 40k seeded points in disjoint x ranges, a 65,536-point device pool
(the union does not fit), EDL off.

Tolerances: report(), visible_bricks, page_in and auto_page decisions equal;
composited frames bit-equal; each brick's voxel keys equal as sets; the
composite equal to a host depth-min select over the per-brick planes.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from simlod_tpu.config import EngineConfig as JCfg, Settings as JSet
from simlod_tpu.outofcore import OutOfCoreEngine as JOoc
from simlod_tpu_torch import constants as C
from simlod_tpu_torch.config import EngineConfig as TCfg, Settings as TSet
from simlod_tpu_torch.formats import las
from simlod_tpu_torch.outofcore import OutOfCoreEngine as TOoc
from simlod_tpu_torch.render import raster

# six test processes share the machine in the tier-1 run; these small tensors
# gain nothing from intra-op threads, which would oversubscribe the cores
torch.set_num_threads(1)

N_PER_BRICK = 40_000
KW = dict(candidate_factor=21, node_capacity=1 << 12, point_capacity=1 << 16,
          voxel_capacity=1 << 18, segment_capacity=1 << 14,
          step_points=1 << 12, spill_capacity=1 << 12, max_splits_per_round=64,
          seg_select_cap=1 << 10, max_points_per_node=1024,
          max_render_points=1 << 17, max_render_voxels=1 << 18)
W, H = 320, 200


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    rng = np.random.default_rng(5)
    tmp = tmp_path_factory.mktemp("bricks")
    paths = []
    for i in range(2):
        xyz = rng.random((N_PER_BRICK, 3)).astype(np.float32)
        xyz[:, 0] = xyz[:, 0] * 0.9 + i * 1.0
        rgba = rng.integers(0, 2**32, N_PER_BRICK,
                            dtype=np.uint64).astype(np.uint32)
        paths.append(str(tmp / f"brick_{i}.las"))
        las.write(paths[-1], xyz, rgba)
    j = JOoc(JCfg(**KW), JSet(enable_edl=False))
    t = TOoc(TCfg(**KW), TSet(enable_edl=False), device="cpu")
    for e in (j, t):
        e.open(paths)
        e.build_all()
    return j, t


def _img(img):
    a = np.asarray(img)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _camera(e, target, yaw, pitch, radius):
    o = e.orbit
    o.target = np.asarray(target, np.float64)
    o.yaw, o.pitch, o.radius = yaw, pitch, radius
    e.camera.world = o.world()


@pytest.fixture
def views(engines):
    """Restore both cameras after a test moves them."""
    saved = [(e.orbit.yaw, e.orbit.pitch, e.orbit.radius,
              e.orbit.target.copy(), e.camera.world.copy()) for e in engines]
    yield engines
    for e, s in zip(engines, saved):
        e.orbit.yaw, e.orbit.pitch, e.orbit.radius, e.orbit.target, \
            e.camera.world = s
        if e._paged_in is not None:
            e._resident.pop(e._paged_in, None)
            e._paged_in = None


def test_reports_equal_and_exceed_the_pool(engines):
    j, t = engines
    assert t.report() == j.report()
    r = t.report()
    assert r["bricks"] == 2 and r["total_points"] == 2 * N_PER_BRICK \
        > r["device_point_capacity"]
    assert r["evicted_point_rows"] >= r["total_points"]


def test_brick_voxel_keys_equal_as_sets(engines):
    j, t = engines
    for jb, tb in zip(j.bricks, t.bricks):
        keys = lambda b: sorted(zip(*(b.voxels[c].tolist()
                                      for c in ("vox_k0", "vox_k1", "vox_k2l"))))
        assert keys(jb) == keys(tb)
        np.testing.assert_array_equal(jb.box_min, tb.box_min)
        np.testing.assert_array_equal(jb.box_max, tb.box_max)


def test_composite_matches_jax_and_the_host_depth_min(engines):
    j, t = engines
    jimg, _ = j.render(W, H)
    timg, tstats = t.render(W, H)
    np.testing.assert_array_equal(_img(jimg), timg.numpy())
    planes, _ = t.render_planes(W, H)
    d = np.stack([p[2].numpy() for p in planes])
    c = np.stack([p[1].numpy() for p in planes])
    pick = np.argmin(d, axis=0)
    np.testing.assert_array_equal(timg.numpy().reshape(-1),
                                  c[pick, np.arange(c.shape[1])])
    covered = d.min(axis=0) != C.DEPTH_INF_BITS
    assert (pick[covered] == 0).any() and (pick[covered] == 1).any()
    assert sorted(tstats) == [0, 1]


def test_composite_frames_runs_edl_once(engines):
    """With EDL on, the composite shades the depth-min planes once."""
    from simlod_tpu_torch.render.render import composite_frames
    _, t = engines
    planes, u = t.render_planes(W, H)
    # the render path branches on the host flag; the tensor stays in step
    u.enable_edl = torch.tensor(True)
    u.flags = dataclasses.replace(u.flags, enable_edl=True)
    img, depth = composite_frames(torch.stack([p[1] for p in planes]),
                                  torch.stack([p[2] for p in planes]), u, W, H)
    k = torch.argmin(torch.stack([p[2] for p in planes]), 0)
    col = torch.stack([p[1] for p in planes]).gather(0, k[None])[0]
    np.testing.assert_array_equal(
        img.reshape(-1).numpy(), raster.edl(col, depth, u, W, H).numpy())


def test_visible_bricks_cull_matches_jax(views):
    j, t = views
    for e in views:
        _camera(e, [0.2, 0.45, 0.45], np.pi / 2, 0.0, 0.3)   # looking along -x
    assert t.visible_bricks(W, H) == j.visible_bricks(W, H)
    assert 1 not in t.visible_bricks(W, H)
    jimg, _ = j.render(W, H)
    timg, stats = t.render(W, H)
    assert t.last_drawn_bricks == j.last_drawn_bricks and 1 not in stats
    np.testing.assert_array_equal(_img(jimg), timg.numpy())


def test_page_in_matches_jax(views):
    j, t = views
    js, ts = j.page_in(0), t.page_in(0)
    assert int(ts.num_segments) == int(js.num_segments) \
        == t.bricks[0].num_segments
    assert int(ts.pool_used) == int(js.pool_used) == t.bricks[0].pool_used
    for e in views:
        _camera(e, [0.45, 0.45, 0.45], 0.0, -0.3, 0.6)
    jimg, _ = j.render(W, H)
    timg, _ = t.render(W, H)
    np.testing.assert_array_equal(_img(jimg), timg.numpy())
    t.page_in(1)
    assert t._paged_in == 1 and 0 not in t._resident


def test_auto_page_decisions_match_jax(views):
    j, t = views
    for radius, want in ((0.2, 0), (50.0, None)):
        for e in views:
            _camera(e, [0.45, 0.45, 0.45], 0.0, -0.3, radius)
        assert t.auto_page(W, H) == j.auto_page(W, H) == want
        assert t._paged_in == j._paged_in == want
