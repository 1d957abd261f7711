"""The port's main path end to end on the CPU: .simlod -> Engine.open ->
load_all -> render, against the JAX engine on the same file and against the
golden images of tests/test_golden.py (same cloud, cameras and config).

Tolerances: report() counters equal; images bit-equal in plain mode and within
1 per channel in HQS mode (the port's HQS average is floor(f32 sum / f32 count)
in the tile resolve, the JAX CPU path divides integers); the goldens at
test_golden.py's tolerance.
"""
import os

import numpy as np
import pytest
import torch

from simlod_tpu.config import EngineConfig as JCfg, Settings as JSet
from simlod_tpu.engine import Engine as JEngine
from simlod_tpu.render.render import render_frame as j_render_frame
from simlod_tpu_torch.config import EngineConfig as TCfg, Settings as TSet
from simlod_tpu_torch.engine import Engine as TEngine
from simlod_tpu_torch.formats import las, laz, simlod, synthetic
from simlod_tpu_torch.io.streaming import PointStream, scan_paths
from simlod_tpu_torch.octree.structures import state_from_numpy
from simlod_tpu_torch.render.render import image_to_rgba8, render_frame

# six test processes share the machine in the tier-1 run; these small tensors
# gain nothing from intra-op threads, which would oversubscribe the cores
torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
W, H = 160, 120
KW = dict(candidate_factor=21, cand_multi_rows=1 << 13,
          node_capacity=1 << 12, point_capacity=1 << 17, voxel_capacity=1 << 19,
          segment_capacity=1 << 14, step_points=1 << 13, spill_capacity=1 << 13,
          max_splits_per_round=64, seg_select_cap=1 << 10,
          max_points_per_node=256, max_render_points=1 << 17,
          max_render_voxels=1 << 17)
FIXTURES = [("front_hqs", 0.0, -0.6, True), ("front_plain", 0.0, -0.6, False),
            ("side_hqs", 1.2, -0.3, True)]
STATS = ("num_nodes", "num_inner", "num_leaves", "num_nonempty_leaves",
         "num_points", "num_voxels", "num_voxels_stored", "num_visible_nodes",
         "num_visible_inner", "num_visible_leaves", "num_visible_points",
         "num_visible_voxels", "num_points_processed", "num_points_dropped",
         "num_candidates_dropped", "pool_used", "num_segments",
         "mem_capacity_reached", "render_truncated")


def read_ppm(path):
    with open(path, "rb") as f:
        assert f.readline().strip() == b"P6"
        w, h = map(int, f.readline().split())
        f.readline()
        return np.frombuffer(f.read(), np.uint8).reshape(h, w, 3)


def _drive(engine, path):
    """open -> load_all -> one render per golden fixture; (images, reports)."""
    engine.open([path])
    engine.load_all()
    imgs, reps = {}, {}
    for name, yaw, pitch, hqs in FIXTURES:
        engine.settings.use_high_quality_shading = hqs
        engine.orbit.yaw, engine.orbit.pitch = yaw, pitch
        engine.camera.world = engine.orbit.world()
        img, _ = engine.render(W, H)
        imgs[name] = image_to_rgba8(np.asarray(img))[..., :3].astype(int)
        reps[name] = {k: engine.report()[k] for k in STATS}
    engine.stream.stop()
    return imgs, reps


@pytest.fixture(scope="module")
def cloud_file(tmp_path_factory):
    xyz, rgba = synthetic.terrain(60_000, seed=23, extent=1.0, z_scale=0.4)
    path = str(tmp_path_factory.mktemp("slice") / "golden.simlod")
    simlod.write(path, xyz, rgba)
    return path


@pytest.fixture(scope="module")
def slices(cloud_file):
    jeng = JEngine(JCfg(**KW), JSet(min_node_size=8.0))
    teng = TEngine(TCfg(**KW), TSet(min_node_size=8.0), device="cpu")
    return (jeng, _drive(jeng, cloud_file)), (teng, _drive(teng, cloud_file))


@pytest.mark.parametrize("name,yaw,pitch,hqs", FIXTURES)
def test_slice_matches_jax_engine(slices, name, yaw, pitch, hqs):
    (_, (jimg, jrep)), (_, (timg, trep)) = slices
    assert trep[name] == jrep[name]
    assert trep[name]["num_points"] + trep[name]["num_points_dropped"] == 60_000
    d = np.abs(jimg[name] - timg[name])
    assert d.max() <= (1 if hqs else 0), d.max()


@pytest.mark.parametrize("name,yaw,pitch,hqs", FIXTURES)
def test_slice_matches_golden(slices, name, yaw, pitch, hqs):
    _, (_, (timg, _)) = slices
    diff = np.abs(timg[name] - read_ppm(os.path.join(GOLDEN_DIR, f"{name}.ppm")))
    if hqs:
        assert diff.max() <= 4 and (diff > 1).mean() < 0.01, diff.max()
    else:
        assert diff.max() == 0


@pytest.mark.parametrize("hqs", [True, False])
def test_jax_state_renders_the_same_in_both(slices, hqs):
    """A state built (and compacted) by the JAX engine, carried across with
    state_from_numpy, renders through the port like through the JAX package."""
    (jeng, _), _ = slices
    jstate = jeng.state
    tstate = state_from_numpy(
        {k: np.asarray(v) for k, v in vars(jstate).items()}, device="cpu")
    jeng.settings.use_high_quality_shading = hqs
    ju = jeng.uniforms(W, H)
    tu = TEngine(TCfg(**KW), TSet(min_node_size=8.0,
                                  use_high_quality_shading=hqs),
                 device="cpu").uniforms(W, H)
    tu.transform = torch.from_numpy(np.array(ju.transform))
    tu.transform_update_bound = tu.transform
    jimg, jst = j_render_frame(JCfg(**KW), jstate, W, H, ju)
    timg, tst = render_frame(TCfg(**KW), tstate, W, H, tu)
    for f in jst._fields:
        assert int(getattr(jst, f)) == int(getattr(tst, f)), f
    d = np.abs(image_to_rgba8(np.asarray(jimg)).astype(int)
               - image_to_rgba8(timg).astype(int))
    assert d.max() <= (1 if hqs else 0)
    assert int(jst.num_visible_points) + int(jst.num_visible_voxels) > 0


def test_point_stream_delivers_the_file_in_order(cloud_file):
    xyz, rgba = simlod.read_points(cloud_file)
    s = PointStream([cloud_file], step_points=7000, device="cpu",
                    batch_points=5000, chunk_steps=3, num_loaders=3)
    items = list(s)
    s.stop()
    x = torch.cat([it[0] for it in items])
    c = np.concatenate([it[4] for it in items])
    rows = np.concatenate([np.arange(k * 7000, k * 7000 + n)
                           for k, n in enumerate(c) if n])
    assert c.sum() == len(xyz)
    np.testing.assert_array_equal(x.reshape(-1).numpy()[rows], xyz[:, 0])
    rg = torch.cat([it[3] for it in items]).reshape(-1).numpy()[rows]
    np.testing.assert_array_equal(rg.view(np.uint32), rgba)


def test_las_input_not_ported_yet(tmp_path):
    """LAS and LAZ input are ported now: scan_paths accepts both (a file that
    is not LAS still raises, as it does in the JAX package)."""
    xyz, rgba = synthetic.terrain(1000, seed=4)
    las.write(str(tmp_path / "a.las"), xyz, rgba)
    laz.write(str(tmp_path / "b.laz"), xyz, rgba)
    entries = scan_paths([str(tmp_path)])
    assert [(e.kind, e.num_points) for e in entries] == [("las", 1000),
                                                         ("laz", 1000)]
    (tmp_path / "c.las").write_bytes(b"")
    with pytest.raises(ValueError):
        scan_paths([str(tmp_path / "c.las")])
