"""A run of a cell shrunk to the CPU: a few hundred thousand points, a
small EngineConfig, a 320 x 180 frame."""
import torch

from lodbench import run as R


def small_cfg():
    from simlod_tpu_torch.config import EngineConfig
    return EngineConfig(
        node_capacity=1 << 14, point_capacity=1 << 19,
        voxel_capacity=1 << 20, segment_capacity=1 << 15,
        step_points=1 << 15, spill_capacity=1 << 15,
        max_points_per_node=2000, seg_select_cap=1 << 10,
        max_render_points=1 << 18, max_render_voxels=1 << 18)


# cells of the loops that BENCHMARK.json holds no cell of (PERF.md, Open
# questions): (configuration file, traffic mix)
LOOP_CELLS = {"simlod36m.orbit": ("lodbench/configs/morro36m-simlod.json",
                                  "orbit"),
              "las73m.stream": ("lodbench/configs/morro73m-las.json",
                                "stream")}


def small_cell(name: str, trace: bool = False):
    try:
        cell = R.load_cell(name, trace=trace)
    except KeyError:
        cell = R.make_cell(name, *LOOP_CELLS[name])
    cell.config = dict(cell.config, width=320, height=180)
    return cell


def small_run(name: str, seed: int = 2 ** 31 + 11, points: int = 150_000,
              seconds: float = 0.5, **kw):
    return R.run(small_cell(name), seed, seconds, False, torch.device("cpu"),
                 points=points, engine_cfg=small_cfg(), **kw)
