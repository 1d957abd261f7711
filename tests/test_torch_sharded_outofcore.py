"""The port's sharded out-of-core engine (simlod_tpu_torch.parallel.outofcore)
against simlod_tpu.parallel.outofcore on the CPU, on the fixture of
tests/test_sharded_outofcore.py: two slabs of 40k points (pure red, pure
green) whose 80k points do not fit the 8 shards' combined 8k-point pools, the
JAX package on the conftest's 8 virtual CPU devices, the port on 8 CPU shards,
160 x 64, EDL off.

Tolerances: report() equal; each brick's per-shard watermarks equal and its
compacted voxel keys equal per shard as sets; composited image bit-equal
(and with EDL on within 1 per channel); composited depth within 1 ulp (XLA
rounds the sharded program's projection differently, see
tests/test_torch_sharding.py); the composite equal to a host depth-min
select over the port's brick planes.
"""
import dataclasses

import numpy as np
import pytest
import torch

from simlod_tpu.config import Settings as JSet
from simlod_tpu.parallel.outofcore import ShardedOutOfCoreEngine as JOoc
from simlod_tpu_torch import constants as C
from simlod_tpu_torch.config import EngineConfig as TCfg, Settings as TSet
from simlod_tpu_torch.formats import simlod
from simlod_tpu_torch.parallel import shard as tshard
from simlod_tpu_torch.parallel.outofcore import ShardedOutOfCoreEngine as TOoc
from simlod_tpu_torch.render.render import image_to_rgba8
from test_sharded_outofcore import CFG, _brick

# six test processes share the machine in the tier-1 run; these small tensors
# gain nothing from intra-op threads, which would oversubscribe the cores
torch.set_num_threads(1)

N_PER_BRICK = 40_000
W, H = 160, 64


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    rng = np.random.default_rng(21)
    tmp = tmp_path_factory.mktemp("slabs")
    paths = []
    for i, (x0, col) in enumerate(zip((0.0, 4.0), (0xFF0000FF, 0xFF00FF00))):
        xyz, rgba = _brick(rng, N_PER_BRICK, x0, col)
        paths.append(str(tmp / f"brick{i}.simlod"))
        simlod.write(paths[-1], xyz, rgba)
    settings = dict(min_node_size=8.0, enable_edl=False)
    j = JOoc(CFG, width=W, height=H, settings=JSet(**settings),
             slot_factor=8)
    t = TOoc(TCfg(**dataclasses.asdict(CFG)),
             mesh=tshard.make_mesh(["cpu"] * 8), width=W, height=H,
             settings=TSet(**settings), slot_factor=8)
    for e in (j, t):
        e.open(paths)
        e.build_all()
    return j, t


def test_reports_equal_and_exceed_the_mesh(engines):
    j, t = engines
    rep = t.report()
    assert rep == j.report()
    assert rep["bricks"] == 2 and rep["n_chips"] == 8
    assert rep["total_points"] == 2 * N_PER_BRICK \
        > rep["n_chips"] * rep["per_chip_point_capacity"]
    assert rep["total_voxels"] > 0 and rep["host_bytes"] > 0


def test_brick_voxels_equal_per_shard(engines):
    j, t = engines
    for jb, tb in zip(j.bricks, t.bricks):
        np.testing.assert_array_equal(tb.num_nodes, jb.num_nodes)
        np.testing.assert_array_equal(tb.vox_used, jb.vox_used)
        for s, vu in enumerate(tb.vox_used):
            keys = lambda b: sorted(zip(*(b.voxels[c][s, :vu].tolist()
                                          for c in ("vox_k0", "vox_k1",
                                                    "vox_k2l"))))
            assert keys(tb) == keys(jb), s


def test_composite_matches_jax_and_shows_both_slabs(engines):
    j, t = engines
    jimg, jdep = j.render()
    timg, tdep = t.render()
    assert timg.shape == (H, W) and tdep.shape == (H, W)
    np.testing.assert_array_equal(timg.numpy(),
                                  np.asarray(jimg).view(np.int32))
    ulps = np.abs(tdep.numpy().astype(np.int64) - np.asarray(jdep))
    assert ulps.max() <= 1
    img = timg.numpy().view(np.uint32)
    drawn = img != np.uint32(C.BACKGROUND_COLOR)
    reds, greens = (img & 0xFF) > 0, ((img >> 8) & 0xFF) > 0
    assert (drawn & reds & ~greens).any(), "red slab missing"
    assert (drawn & greens & ~reds).any(), "green slab missing"
    assert (tdep.numpy()[drawn] != C.DEPTH_INF_BITS).all()


def test_composite_is_the_host_depth_min_of_the_brick_planes(engines):
    _, t = engines
    planes, _ = t.render_planes()
    c = np.stack([p[0].numpy() for p in planes])
    d = np.stack([p[1].numpy() for p in planes])
    pick = np.argmin(d, axis=0)
    img, depth = t.render()
    cols = np.arange(c.shape[1])
    np.testing.assert_array_equal(depth.numpy().reshape(-1), d[pick, cols])
    np.testing.assert_array_equal(img.numpy().reshape(-1), c[pick, cols])
    covered = d.min(axis=0) != C.DEPTH_INF_BITS
    assert (pick[covered] == 0).any() and (pick[covered] == 1).any()


def test_edl_composite_within_one(engines):
    j, t = engines
    for e in engines:
        e.settings.enable_edl = True
    try:
        jimg, _ = j.render()
        timg, _ = t.render()
    finally:
        for e in engines:
            e.settings.enable_edl = False
    rgb = lambda a: image_to_rgba8(np.asarray(a))[..., :3].astype(int)
    assert np.abs(rgb(timg.numpy()) - rgb(jimg)).max() <= 1
