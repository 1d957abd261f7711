"""BENCHMARK.json against the contract's shape, and every cell resolving to
its configuration, traffic and metric files, found by name."""
import json
import re
import shutil
from pathlib import Path

import pytest

from lodbench import found
from lodbench import run as R
from lodbench.loops import loop_class

ROOT = Path(R.ROOT)
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][1] == "lodbench/run.py"
    assert BENCH["paths"] == ["lodbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(w):
    cell = R.load_cell(w["name"])
    assert cell.config["name"] == w["config"]
    assert callable(loop_class(cell.traffic["loop"]).check)
    for trace in (False, True):
        for m in R.load_cell(w["name"], trace=trace).metrics:
            assert callable(R.metric_module(m["name"]).read)
    assert w["chips"] == 1 and len(w["why"]) <= 200
    names = {m["name"] for m in cell.metrics}
    assert "setup_s" in names and len(names) >= 2
    assert R.load_cell(w["name"], trace=True).metrics


def test_names_units_and_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    seen = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] not in seen
        seen.add(m["name"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        target = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in target.get("workloads", [w])
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] \
            == c["reduced"]


def test_every_number_compared_has_a_limit():
    keys = {"points_mismatched", "points_misplaced", "leaves_overfull",
            "nodes_malformed", "voxels_misplaced", "voxels_duplicated",
            "voxel_cells_empty", "voxel_colors_foreign",
            "voxel_cells_missing_pct", "frame_pixels_off_pct",
            "fused_frame_pixels_off_pct", "frames_truncated",
            "frames_unchecked"}
    for c in BENCH["configs"]:
        assert set(json.loads((ROOT / c["file"]).read_text())["limits"]) \
            == keys


@pytest.mark.parametrize("mix", sorted(
    p.stem for p in (ROOT / "lodbench/traffic").glob("*.json")))
def test_every_traffic_mix_names_a_loop_module(mix):
    traffic = json.loads((ROOT / f"lodbench/traffic/{mix}.json").read_text())
    loop = loop_class(traffic["loop"])
    for part in ("setup", "window", "stretch", "check", "info"):
        assert callable(getattr(loop, part))


@pytest.mark.parametrize("config", sorted(
    p.name for p in (ROOT / "lodbench/configs").glob("*.json")))
def test_every_configuration_names_a_format_module(config):
    cfg = json.loads((ROOT / "lodbench/configs" / config).read_text())
    fmt = found.module("formats", cfg["format"])
    assert fmt.SUFFIX.startswith(".")
    assert all(callable(f) for f in (fmt.write, fmt.read, fmt.extent))


def test_a_cell_is_added_by_data_files_alone(tmp_path):
    """A copy of the benchmark with a new configuration file, a new traffic
    file and a new BENCHMARK.json entry: the cell resolves, with no code
    changed."""
    shutil.copytree(ROOT / "lodbench", tmp_path / "lodbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((ROOT / "lodbench/configs/morro36m-simlod.json")
                     .read_text())
    cfg.update(name="tiny-las", format="las", points=1000)
    (tmp_path / "lodbench/configs/tiny-las.json").write_text(json.dumps(cfg))
    (tmp_path / "lodbench/traffic/orbit_slow.json").write_text(json.dumps(
        dict(loop="orbit", yaw_step=0.01, check_frames=1, trace_seconds=1)))
    bench["configs"].append(dict(name="tiny-las", source="x",
                                 file="lodbench/configs/tiny-las.json",
                                 reduced=[], why="x"))
    bench["workloads"].append(dict(name="tiny.orbit", config="tiny-las",
                                   traffic="orbit_slow", chips=1, why="x"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = R.load_cell("tiny.orbit", root=tmp_path)
    assert cell.config["points"] == 1000 and cell.traffic["yaw_step"] == 0.01
    assert [m["name"] for m in cell.metrics] == ["setup_s"]
