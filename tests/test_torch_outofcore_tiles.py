"""The out-of-core survey build on the CPU, held to the benchmark's plain
reference (lodbench/tiles_reference.py): a terrain of 160,000 points cut by
lodbench/formats/las_tiles.py into 8 LAS tiles, opened as a folder by
simlod_tpu_torch.outofcore.OutOfCoreEngine whose point pool holds one tile
(32,768 points) and not the survey, every tile built and evicted as one
brick.

Tolerances: every number exact (0), voxel_cells_missing_pct too at this
size; the limits the faults have to pass are those of the cell's
configuration (lodbench/configs/survey144m-las-tiles.json). Tile positions
round-trip within the LAS scale (0.001) and half an ulp of float32.
"""
import copy
import json
import os
import types

import numpy as np
import pytest
import torch

from lodbench import data, found
from lodbench import reference as ref
from lodbench import tiles_reference as tiles
from simlod_tpu_torch.config import EngineConfig, Settings
from simlod_tpu_torch.outofcore import OutOfCoreEngine
from simlod_tpu_torch.utils import trace

# six test processes share the machine in the tier-1 run
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = json.load(open(os.path.join(
    ROOT, "lodbench", "configs", "survey144m-las-tiles.json")))
LIMITS = CONFIG["limits"]
N = 160_000
SEED = 2 ** 31 + 23
CFG = dict(node_capacity=1 << 12, point_capacity=1 << 15,
           voxel_capacity=1 << 17, segment_capacity=1 << 13,
           step_points=1 << 13, spill_capacity=1 << 13,
           max_points_per_node=1000, seg_select_cap=1 << 10,
           max_render_points=1 << 17, max_render_voxels=1 << 17)
TILES = found.module("formats", "las_tiles")


@pytest.fixture(scope="module")
def survey(tmp_path_factory):
    """(scan xyz, rgba, the folder, the engine after build_all, the span
    totals of its open and build_all, the survey read by the reference)."""
    gen = CONFIG["generator"]
    xyz, rgba = data.terrain(N, SEED, torch.device("cpu"),
                             extent=gen["extent"], z_scale=gen["z_scale"],
                             scan_order=gen["scan_order"])
    folder = str(tmp_path_factory.mktemp("survey")
                 / ("scan" + TILES.SUFFIX))
    TILES.write(folder, xyz, rgba)
    ooc = OutOfCoreEngine(EngineConfig(**CFG), Settings(), device="cpu")
    snap = trace.snapshot()
    ooc.open([folder])
    ooc.build_all()
    spans = trace.since(snap)
    scan = ref.Scan(*TILES.read(folder, torch.device("cpu")))
    return types.SimpleNamespace(xyz=xyz, rgba=rgba, folder=folder, ooc=ooc,
                                 spans=spans, scan=scan)


def numbers(s, bricks, control=False) -> dict:
    ctx = types.SimpleNamespace(control=control,
                                leaf_cap=CFG["max_points_per_node"])
    return tiles.survey_numbers(bricks, s.folder, s.scan, ctx)


@pytest.fixture(scope="module")
def program_numbers(survey):
    return numbers(survey, survey.ooc.bricks)


def test_the_survey_does_not_fit_the_pool(survey):
    counts = tiles.tile_counts(tiles.tile_paths(survey.folder))
    assert len(counts) == CONFIG["tiles"] == 8
    assert max(counts) <= CFG["point_capacity"] < sum(counts) == N


@pytest.mark.parametrize("name", sorted(LIMITS))
def test_every_number_of_the_bricks_is_zero(program_numbers, name):
    assert program_numbers[name] == 0, program_numbers


def test_the_bricks_points_sum_to_the_survey(survey):
    rep = survey.ooc.report()
    assert rep["bricks"] == 8
    assert rep["total_points"] == N
    # the points the bricks' live segments hold (the pool keeps the rows
    # that splits left behind besides)
    held = sum(int(b.segs["seg_cnt"][(b.segs["seg_cnt"] > 0)
                                     & (b.segs["seg_node"] >= 0)].sum())
               for b in survey.ooc.bricks)
    assert held == N


def _live_last(b):
    """The brick's last live segment and the pool row of its last point."""
    cnt, node = b.segs["seg_cnt"], b.segs["seg_node"]
    i = np.flatnonzero((cnt > 0) & (node >= 0))[-1]
    return i, int(b.segs["seg_off"][i] + cnt[i] - 1)


def _drop(b) -> int:
    """Leave out the brick's last stored point -> its pool row."""
    i, row = _live_last(b)
    b.segs["seg_cnt"] = b.segs["seg_cnt"].copy()
    b.segs["seg_cnt"][i] -= 1
    return row


def _move(a, b) -> None:
    """Move a's last stored point into brick b, into a leaf of b."""
    row = _drop(a)
    for c, v in a.points.items():
        b.points[c] = np.append(b.points[c], v[row]).astype(v.dtype)
    leaf = b.segs["seg_node"][_live_last(b)[0]]
    for c, v in (("seg_node", leaf), ("seg_off", b.pool_used),
                 ("seg_cnt", 1)):
        b.segs[c] = np.append(b.segs[c], v).astype(b.segs[c].dtype)
    b.pool_used += 1
    b.num_segments += 1


@pytest.mark.parametrize("fault", ["dropped", "moved", "control"])
def test_a_fault_reads_above_its_limit(survey, fault):
    bricks = copy.deepcopy(survey.ooc.bricks)
    by_name = {os.path.basename(b.path): b for b in bricks}
    if fault == "dropped":
        _drop(by_name["tile_0_1.las"])
    elif fault == "moved":
        # into the next tile of the row
        _move(by_name["tile_0_1.las"], by_name["tile_0_2.las"])
    out = numbers(survey, bricks, control=fault == "control")
    over = {k for k, v in out.items() if v > LIMITS[k]}
    assert over, out
    if fault == "moved":
        # every point is still stored once, in the wrong brick
        assert out["tiles_points_mismatched"] == 0
        assert out["points_mismatched"] > 0
    if fault == "control":
        assert out["tiles_points_mismatched"] > 0, out


@pytest.mark.parametrize("what", ["brick_spans", "evict_spans",
                                  "evicted_bytes"])
def test_spans_and_counters(survey, what):
    ooc, spans = survey.ooc, survey.spans
    if what == "brick_spans":
        assert spans["ooc.brick"]["count"] == 8 == ooc.bricks_built
        assert spans["ooc.open"]["count"] == 1
        assert spans["ooc.compact"]["count"] == 8
        # a brick holds its engine's open and load
        assert spans["ooc.brick"]["seconds"] \
            >= spans["engine.load_all"]["seconds"]
    elif what == "evict_spans":
        assert spans["ooc.evict"]["count"] == 8
        assert spans["sync.outofcore.evict"]["count"] == 8
    else:
        for b in ooc.bricks:
            assert {len(a) for a in b.nodes.values()} == {b.num_nodes}
            assert {len(a) for a in b.voxels.values()} == {b.vox_used}
            assert {len(a) for a in b.points.values()} == {b.pool_used}
            assert {len(a) for a in b.segs.values()} == {b.num_segments}
        assert ooc.evicted_bytes == tiles.evicted_bytes(ooc.bricks) > 0
        assert ooc.evicted_bytes == ooc.report()["host_bytes"]


@pytest.mark.parametrize("what", ["union", "partition"])
def test_the_tile_format_round_trips(survey, what):
    xyz, rgba = survey.xyz.double(), survey.rgba
    paths = tiles.tile_paths(survey.folder)
    assert [os.path.basename(p) for p in paths] == [
        f"tile_{r}_{c}.las" for r in range(TILES.GRID[1])
        for c in range(TILES.GRID[0])]
    assert CONFIG["tile_grid"] == list(TILES.GRID)
    if what == "union":
        # the survey is the scan's points, tile after tile, each tile in
        # scan order
        order = torch.sort(TILES.cells(survey.xyz), stable=True).indices
        want = xyz[order] - xyz.min(0).values
        got = survey.scan.xyz.double()
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= 0.0005 + 1e-4
        assert torch.equal(survey.scan.rgba, rgba[order])
    else:
        mn, mx = xyz.min(0).values, xyz.max(0).values
        edge = [(mx[a] - mn[a]) / TILES.GRID[a] for a in range(2)]
        for p in paths:
            row, col = (int(v) for v in os.path.basename(p)[5:-4].split("_"))
            lo, hi = tiles.union_box([p])
            for a, k in ((0, col), (1, row)):
                assert float(mn[a] + k * edge[a]) - 1e-9 <= lo[a]
                assert hi[a] <= float(mn[a] + (k + 1) * edge[a]) + 1e-9
        assert sum(tiles.tile_counts(paths)) == N
        lo, hi = tiles.union_box(paths)
        assert np.allclose(lo, mn.numpy()) and np.allclose(hi, mx.numpy())


READERS = ("outofcore.evict_pct.tiles", "outofcore.evict_link_pct.tiles",
           "outofcore.brick_cycle_pct.tiles")


def _record(spans):
    """Two passes of 4 s, each with 3.2 GB evicted in 2 s and 8 bricks of
    3.5 s, 1 s of them building."""
    t = lambda c, s: dict(count=c, seconds=s, sync_s=0.0)
    s = {"ooc.evict": t(8, 2.0), "ooc.brick": t(8, 3.5),
         "engine.load_all": t(8, 1.0)} if spans else None
    return dict(window=dict(loads=[dict(points=144e6, seconds=4.0,
                                        evicted_bytes=3.2e9, spans=s)] * 2,
                            window_s=8.0))


@pytest.mark.parametrize("name,value", [
    ("outofcore.evict_pct.tiles", 50.0),
    ("outofcore.evict_link_pct.tiles", 100 * 1.6e9 / 64e9),
    ("outofcore.brick_cycle_pct.tiles", 100 * 2.5 / 3.5)])
def test_a_reader_reads_the_passes_spans(name, value):
    from lodbench import run as R
    assert R.metric_module(name).read(_record(True)) == pytest.approx(value)
    # the parent of these spans reads nothing
    assert R.metric_module(name).read(_record(False)) is None


def test_a_small_run_of_the_cell_is_correct():
    """The cell's run (lodbench/run.py) shrunk to the CPU: the loop, the
    tile format and the check end to end, and every reader reads."""
    from lodbench import run as R
    cell = R.load_cell("tiles144m.ooc", trace=True)
    cell.config = dict(cell.config, width=320, height=180)
    out = R.run(cell, SEED, 0.1, False, torch.device("cpu"), points=N,
                engine_cfg=EngineConfig(**CFG))
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == set(READERS)
    assert out["info"]["bricks"] == 8
    assert out["info"]["evicted_bytes"] > 0
