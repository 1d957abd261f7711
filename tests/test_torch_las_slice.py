"""This slice of the port end to end on the CPU, against the JAX engine: a
directory of LAS tiles -> Engine.open -> load_all -> filter_colors -> render
with bounding boxes (EDL off), on the golden fixture's 60k-point terrain split
into two x-halves.

Tolerances: report() counters equal; filtered voxel colours equal per (node
identity, cell) (node ids are order-defined, test_torch_build.py); frames
inside the one-pixel frame border bit-equal in plain mode and within 1 per
channel with HQS (test_torch_engine.py). The border is exempt: the engine's
frozen visibility camera is the view camera, so the frustum wireframe's edges
lie on the frame's edges, and whether an edge pixel lands inside depends on
the last float32 ulp of the inverse transform, which jnp.linalg.inv and
torch.linalg.inv round differently (test_torch_lines.py).
"""
import functools

import numpy as np
import pytest
import torch

from simlod_tpu import engine as jengine
from simlod_tpu.config import EngineConfig as JCfg, Settings as JSet
from simlod_tpu.engine import Engine as JEngine
from simlod_tpu.octree import inspect as jin
from simlod_tpu_torch.config import EngineConfig as TCfg, Settings as TSet
from simlod_tpu_torch.engine import Engine as TEngine
from simlod_tpu_torch.formats import las, synthetic
from simlod_tpu_torch.octree import inspect as tin
from simlod_tpu_torch.render.render import image_to_rgba8

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
STATS = ("num_nodes", "num_inner", "num_leaves", "num_points", "num_voxels",
         "num_voxels_stored", "num_visible_nodes", "num_visible_points",
         "num_visible_voxels", "num_points_processed", "num_points_dropped",
         "pool_used", "num_segments", "mem_capacity_reached",
         "render_truncated")


def _drive(engine, d):
    engine.open([d])
    engine.load_all()
    engine.filter_colors()
    engine.orbit.yaw, engine.orbit.pitch = 0.4, -0.7
    engine.camera.world = engine.orbit.world()
    imgs = {}
    for hqs in (False, True):
        engine.settings.use_high_quality_shading = hqs
        img, _ = engine.render(W, H)
        imgs[hqs] = image_to_rgba8(np.asarray(img))[..., :3].astype(int)
    engine.settings.show_bounding_box = False
    plain, _ = engine.render(W, H)
    rep = engine.report()
    engine.stream.stop()
    vox = {k: v["voxels"] for k, v in tin.node_table(engine.state).items()} \
        if isinstance(engine, TEngine) else \
        {k: v["voxels"] for k, v in jin.node_table(engine.state).items()}
    return imgs, image_to_rgba8(np.asarray(plain))[..., :3].astype(int), \
        {k: rep[k] for k in STATS}, vox


@pytest.fixture(scope="module")
def slices(tmp_path_factory):
    xyz, rgba = synthetic.terrain(60_000, seed=23, extent=1.0, z_scale=0.4)
    d = tmp_path_factory.mktemp("tiles")
    half = xyz[:, 0] < 0.5
    for i, sel in enumerate((half, ~half)):
        las.write(str(d / f"tile_{i}.las"), xyz[sel], rgba[sel])
    kw = dict(min_node_size=8.0, show_bounding_box=True, enable_edl=False)
    # the JAX stream packs batches in the order its loader threads finish them,
    # so on a busy machine tile 1 can come first and build another tree; the
    # port packs in file order. One loader makes the JAX order the file order.
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine, "PointStream",
                   functools.partial(jengine.PointStream, num_loaders=1))
        jres = _drive(JEngine(JCfg(**KW), JSet(**kw)), str(d))
    return jres, _drive(TEngine(TCfg(**KW), TSet(**kw), device="cpu"), str(d))


def test_las_slice_counters_match_jax(slices):
    (_, _, jrep, _), (_, _, trep, _) = slices
    assert trep == jrep
    assert trep["num_points"] + trep["num_points_dropped"] == 60_000


def test_las_slice_filtered_voxels_match_jax(slices):
    (_, _, _, jv), (_, _, _, tv) = slices
    assert jv.keys() == tv.keys() and sum(map(len, tv.values())) > 1000
    assert jv == tv


@pytest.mark.parametrize("hqs", [False, True])
def test_las_slice_frame_with_boxes_matches_jax(slices, hqs):
    (jimgs, _, _, _), (timgs, tplain, _, _) = slices
    d = np.abs(jimgs[hqs] - timgs[hqs]).max(-1)
    assert d[1:-1, 1:-1].max() <= (1 if hqs else 0)
    assert (timgs[hqs] != tplain)[1:-1, 1:-1].any(-1).sum() > 50
