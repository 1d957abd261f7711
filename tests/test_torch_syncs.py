"""Every device read of a frame is counted (PyTorch port, on the CPU).

`Engine.host_syncs` / `ShardedEngine.host_syncs` are the metric "host syncs
per frame": each read of a tensor's value on the host waits for the device.
Here every such read on a tensor (`__bool__`, `item`, `tolist`, `__int__`,
`__float__`, `__index__`) is counted over one frame and must equal the
engine's delta. The Settings switches ride `Uniforms.flags` as host values, so
no frame reads them back. The plain version of the splat kernel reads its
shading mode on the host; on the card the kernel reads it on the device, so
reads inside it are not the frame's.
"""
import numpy as np
import pytest
import torch

from simlod_tpu_torch.config import EngineConfig, Settings
from simlod_tpu_torch.engine import Engine
from simlod_tpu_torch.formats import simlod, synthetic
from simlod_tpu_torch.parallel import shard
from simlod_tpu_torch.parallel.engine import ShardedEngine
from simlod_tpu_torch.render import raster

# six test processes share the machine in the tier-1 run; these small tensors
# gain nothing from intra-op threads, which would oversubscribe the cores
torch.set_num_threads(1)

W, H = 96, 64
# the golden fixture's config (tests/test_golden.py, test_torch_engine.py)
KW = dict(candidate_factor=21, cand_multi_rows=1 << 13,
          node_capacity=1 << 12, point_capacity=1 << 17, voxel_capacity=1 << 19,
          segment_capacity=1 << 14, step_points=1 << 13, spill_capacity=1 << 13,
          max_splits_per_round=64, seg_select_cap=1 << 10,
          max_points_per_node=256, max_render_points=1 << 17,
          max_render_voxels=1 << 17)
READS = ("__bool__", "item", "tolist", "__int__", "__float__", "__index__")


class Reads:
    """Counts host reads of tensor values while installed."""

    def __init__(self, monkeypatch):
        self.n = 0
        self.paused = 0
        for name in READS:
            orig = getattr(torch.Tensor, name)

            def counted(t, *a, _orig=orig, **k):
                if not self.paused:
                    self.n += 1
                return _orig(t, *a, **k)
            monkeypatch.setattr(torch.Tensor, name, counted)
        plain = raster.splat_resolve_reference

        def kernel_stand_in(*a, **k):
            self.paused += 1
            try:
                return plain(*a, **k)
            finally:
                self.paused -= 1
        monkeypatch.setattr(raster, "splat_resolve_reference", kernel_stand_in)

    def over(self, fn):
        """(reads made by fn(), fn's result)."""
        before = self.n
        out = fn()
        return self.n - before, out


@pytest.fixture(scope="module")
def cloud(tmp_path_factory):
    xyz, rgba = synthetic.terrain(60_000, seed=23, extent=1.0, z_scale=0.4)
    path = str(tmp_path_factory.mktemp("syncs") / "golden.simlod")
    simlod.write(path, xyz, rgba)
    return path


def _look(eng):
    eng.orbit.yaw, eng.orbit.pitch = 0.3, -0.6
    eng.camera.world = eng.orbit.world()


@pytest.mark.parametrize("budget,overlays", [(0.0, False), (0.0, True),
                                             (1.0, False), (1.0, True)])
def test_render_reads_are_counted(monkeypatch, cloud, budget, overlays):
    """A post-load exact or pooled frame, with and without the switches the
    port used to read back (boxes, a debug colour mode)."""
    eng = Engine(EngineConfig(**KW),
                 Settings(min_node_size=8.0, point_budget=budget,
                          show_bounding_box=overlays, color_by_lod=overlays),
                 device="cpu")
    eng.open([cloud])
    eng.load_all()
    _look(eng)
    reads = Reads(monkeypatch)
    for _ in range(2):      # the first builds the pool / sizes the windows
        syncs = eng.host_syncs
        n, (img, st) = reads.over(lambda: eng.render(W, H))
        assert n == eng.host_syncs - syncs > 0
    assert st.num_visible_points + st.num_visible_voxels > 0


@pytest.mark.parametrize("budget", [0.0, 1.0])
def test_streamed_frame_reads_are_counted(monkeypatch, cloud, budget):
    """Every frame of the simultaneous loop, one step per item."""
    eng = Engine(EngineConfig(**KW),
                 Settings(min_node_size=8.0, point_budget=budget,
                          frame_budget_ms=0.0),
                 device="cpu")
    eng.open([cloud], chunk_steps=1)
    _look(eng)
    reads = Reads(monkeypatch)
    frames = 0
    while not eng.last_batch_finished:
        syncs = eng.host_syncs
        n, _ = reads.over(lambda: eng.frame(W, H))
        assert n == eng.host_syncs - syncs > 0, frames
        frames += 1
    assert frames == -(-60_000 // KW["step_points"]) + 1
    assert eng.report()["num_points"] == 60_000


def test_sharded_frame_reads_are_counted(monkeypatch, cloud):
    eng = ShardedEngine(EngineConfig(**dict(KW, max_points_per_node=128)),
                        mesh=shard.make_mesh(["cpu"] * 4), width=W, height=H,
                        settings=Settings(min_node_size=8.0), slot_factor=4)
    eng.open([cloud])
    eng.load_all()
    _look(eng)
    reads = Reads(monkeypatch)
    for _ in range(2):      # the first compacts the shards' stores
        syncs = eng.host_syncs
        n, img = reads.over(eng.render)
        assert n == eng.host_syncs - syncs > 0
    assert tuple(img.shape) == (H, W)
    assert eng.report()["num_points"] == 60_000


@pytest.mark.parametrize("budget", [0.0, 1.0])
def test_render_frame_reads(monkeypatch, cloud, budget):
    """A render-only frame reads the device twice: the watermarks before it,
    the counters after it (a pooled frame once more when it re-probes its
    windows, every 8 frames)."""
    eng = Engine(EngineConfig(**KW),
                 Settings(min_node_size=8.0, point_budget=budget),
                 device="cpu")
    eng.open([cloud])
    eng.load_all()
    _look(eng)
    eng.render(W, H)        # compacts, builds the pool, sizes the windows
    reads = Reads(monkeypatch)
    counts = []
    for _ in range(8):
        syncs = eng.host_syncs
        n, _ = reads.over(lambda: eng.render(W, H))
        assert n == eng.host_syncs - syncs
        counts.append(n)
    assert counts.count(2) >= 7 and max(counts) <= 2 + (budget > 0), counts
