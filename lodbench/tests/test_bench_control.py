"""The control (the reference, computed in bfloat16, in the program's
place) comes out not correct in every cell, and the program's own runs
pass: at a small size on the CPU, and on the card at a size a test run
holds (the readings at the cells' own sizes are control.py's, PERF.md).
On the card at that size the program's exact counts are 0 and its frames
match; the share of voxel cells missing depends on the scan's size (9.7%
at 4M points, 0.0 at 36M), so it is held to the cell's limit only at the
cell's own size."""
import json
from pathlib import Path

import pytest
import torch

import small
from lodbench import control
from lodbench import run as R


CELLS = [w["name"] for w in json.loads(
    (Path(R.ROOT) / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS + list(small.LOOP_CELLS))
def test_the_control_fails_on_the_cpu(cell):
    out = small.small_run(cell, seconds=0.3, control=True)
    assert out["correct"] is False, out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS + list(small.LOOP_CELLS))
def test_the_control_fails_on_the_card(cell):
    """The control fails; the program's octree passes. In the benchmark's
    cells every number of the program passes; the loops that it holds no
    cell of fail by the program's own faults (PERF.md, Open questions), so
    only their octree is held here."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = small.small_cell(cell)
    c.config = dict(c.config, width=1920, height=1080)
    r = control.readings(c, [2 ** 31 + 3], [2 ** 31 + 4], 1.0,
                         torch.device("cuda", 0), points=4_000_000)
    exact = [k for k, v in r.items() if v["limit"] == 0
             and (cell in CELLS or not k.startswith("frame"))]
    assert exact and all(r[k]["lower"] == 0 for k in exact), r
    if cell in CELLS and "frame_pixels_off_pct" in r:
        v = r["frame_pixels_off_pct"]
        assert v["lower"] <= v["limit"] < v["upper"], r
    assert any(v["upper"] is not None and v["upper"] > v["limit"]
               for v in r.values()), r
