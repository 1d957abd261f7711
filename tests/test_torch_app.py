"""The port's headless app (`python -m simlod_tpu_torch.app`) on the CPU,
against the JAX app (simlod_tpu/app.py) on the same file and flags.

Both run with explicit capacity flags, so neither sizes its pools from memory.
The cloud has 100k points, so that the tree splits (a leaf holds 50k); 32k-
point steps put the whole file in one streamed item (4 steps per item), so the
frame loop's wall-clock pacing (frame_budget_ms) cannot change which frame
draws what. EDL is off: XLA and torch round its log2/exp differently (within
1 per channel, test_torch_raster.py). Tolerances: report counters equal,
frames bit-equal.

The JAX `frame` never ends a load (no end-of-load split convergence; ROADMAP
queue 3), the port's does: the port's frame-loop tree is held to the JAX
`--frames 0` tree, which converges its splits.
"""
import contextlib
import io
import json
import os
import tempfile
import zlib

import numpy as np
import pytest
import torch

from simlod_tpu import app as japp
from simlod_tpu.utils import cache as jcache
from simlod_tpu_torch import app
from simlod_tpu_torch import constants as C
from simlod_tpu_torch.formats import simlod, synthetic

# six test processes share the machine in the tier-1 run; these small tensors
# gain nothing from intra-op threads, which would oversubscribe the cores
torch.set_num_threads(1)

W, H = 160, 120
FLAGS = ["--step-points", "32768", "--node-capacity", "4096",
         "--point-capacity", "262144", "--voxel-capacity", "524288",
         "--min-node-size", "8", "--width", str(W), "--height", str(H),
         "--no-edl"]
FRAMES = 3
# wall-clock keys (and the stream's loader stats) differ run to run
NOT_COUNTERS = {"timings", "wall_seconds", "ingest_mps", "stream"}
TREE = ("num_nodes", "num_points", "num_points_processed")


def _main(main, argv):
    """(exit code, stdout) of an app's main."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _report(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


def read_ppm(path):
    with open(path, "rb") as f:
        assert f.readline().strip() == b"P6"
        w, h = map(int, f.readline().split())
        f.readline()
        return np.frombuffer(f.read(), np.uint8).reshape(h, w, 3)


def decode_png(data: bytes) -> np.ndarray:
    """An 8-bit RGB, filter-0 PNG (what viewer.encode_png writes) -> [H, W, 3]."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    i, idat, w, h = 8, b"", None, None
    while i < len(data):
        n = int.from_bytes(data[i:i + 4], "big")
        tag, body = data[i + 4:i + 8], data[i + 8:i + 8 + n]
        if tag == b"IHDR":
            w, h = int.from_bytes(body[:4], "big"), int.from_bytes(body[4:8], "big")
            assert body[8:10] == b"\x08\x02"        # 8 bits, RGB
        elif tag == b"IDAT":
            idat += body
        i += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()                  # filter 0 on every row
    return rows[:, 1:].reshape(h, w, 3)


@pytest.fixture(scope="module")
def cloud(tmp_path_factory):
    xyz, rgba = synthetic.terrain(100_000, seed=3, extent=1.0, z_scale=0.4)
    path = str(tmp_path_factory.mktemp("app") / "cloud.simlod")
    simlod.write(path, xyz, rgba)
    return path


@pytest.fixture(scope="module")
def jax_runs(cloud, tmp_path_factory):
    """The JAX app on the cloud: (--frames 0 report, --frames K report, the
    K-frame run's frame directory). Its XLA cache is not written."""
    out = str(tmp_path_factory.mktemp("jax_frames"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcache, "enable", lambda *a, **k: None)
        rc0, load = _main(japp.main, [cloud, "--frames", "0", "--json", *FLAGS])
        rc1, frames = _main(japp.main, [cloud, "--frames", str(FRAMES), "--out",
                                        out, "--json", *FLAGS])
    assert rc0 == rc1 == 0
    return _report(load), _report(frames), out


@pytest.fixture(scope="module")
def port_frames(cloud, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("port_frames"))
    rc, stdout = _main(app.main, [cloud, "--frames", str(FRAMES), "--out", out,
                                  "--json", *FLAGS, "--device", "cpu"])
    assert rc == 0
    return _report(stdout), out


def test_json_report_matches_jax(cloud, jax_runs):
    rc, stdout = _main(app.main, [cloud, "--frames", "0", "--json", *FLAGS,
                                  "--device", "cpu"])
    assert rc == 0
    rep, want = _report(stdout), jax_runs[0]
    shared = set(want) - NOT_COUNTERS
    assert shared <= set(rep)
    assert {k: rep[k] for k in shared} == {k: want[k] for k in shared}
    assert rep["num_points_processed"] == rep["num_points"] == 100_000
    assert rep["num_nodes"] > 1 and rep["num_voxels_stored"] > 0
    # the port's own counters
    assert rep["frames"] == 0 and rep["steps"] == 4 and rep["host_syncs"] > 0
    assert set(rep["timings"]) == {"build", "render", "fused", "pool"}
    assert rep["wall_seconds"] > 0 and rep["stream"]["points_loaded"] == 100_000


def test_frames_match_jax(jax_runs, port_frames):
    jload, jrep, jdir = jax_runs
    rep, tdir = port_frames
    assert rep["stream"]["points_loaded"] == 100_000 and rep["steps"] == 4
    assert rep["frames"] == jrep["timings"]["fused"]["count"] \
        + jrep["timings"]["render"]["count"] == FRAMES
    assert {k: rep[k] for k in TREE} == {k: jload[k] for k in TREE}
    names = sorted(os.listdir(tdir))
    assert names == sorted(os.listdir(jdir)) \
        == [f"frame_{i:04d}.ppm" for i in range(FRAMES)]
    bg = np.frombuffer(np.uint32(C.BACKGROUND_COLOR).tobytes()[:3], np.uint8)
    for name in names:
        got, want = read_ppm(os.path.join(tdir, name)), \
            read_ppm(os.path.join(jdir, name))
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert (got != bg).any(-1).mean() > 0.01, name


def test_png_frames_decode_to_the_ppm_frames(cloud, port_frames, tmp_path):
    rc, _ = _main(app.main, [cloud, "--frames", str(FRAMES), "--out",
                             str(tmp_path), "--png", *FLAGS, "--device", "cpu"])
    assert rc == 0
    _, ppm_dir = port_frames
    for i in range(FRAMES):
        with open(tmp_path / f"frame_{i:04d}.png", "rb") as f:
            img = decode_png(f.read())
        assert img.shape == (H, W, 3)
        np.testing.assert_array_equal(
            img, read_ppm(os.path.join(ppm_dir, f"frame_{i:04d}.ppm")))


def test_synthetic_input_leaves_no_file(monkeypatch, tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    rc, stdout = _main(app.main, ["--synthetic", "20000", "--json", *FLAGS,
                                  "--device", "cpu"])
    assert rc == 0
    rep = _report(stdout)
    assert rep["num_points_processed"] == rep["num_points"] == 20_000
    assert os.listdir(tmp_path) == []


def test_text_report_and_benchmark_table(cloud):
    rc, stdout = _main(app.main, [cloud, "--frames", "2", "--benchmark",
                                  "--filter-colors", *FLAGS, "--device", "cpu"])
    assert rc == 0
    lines = stdout.splitlines()
    assert lines[0].startswith("loaded 100,000 points in ")
    assert lines[1].startswith("nodes ") and lines[2].startswith("points 100,000")
    rows = {ln.split()[0]: ln for ln in lines if ln.startswith("  ")}
    assert set(rows) == {"render", "fused"}
    assert rows["fused"].split()[1] == "x1" and rows["render"].split()[1] == "x1"


def test_flags_reach_the_engine():
    """The JAX app's flags, and --device, as the engine's config and Settings."""
    jargs = japp.parse_args(["f", "--show-boxes", "--color-by-lod", "--no-hqs"])
    args = app.parse_args(["f", "--show-boxes", "--color-by-lod", "--no-hqs",
                           "--device", "cpu"])
    assert vars(args) == dict(vars(jargs), device="cpu")
    eng = app.build_engine(args)
    s = eng.settings
    assert eng.device.type == "cpu" and eng._auto_cfg
    assert s.show_bounding_box and s.color_by_lod and not s.color_by_node
    assert not s.use_high_quality_shading and s.enable_edl
    eng = app.build_engine(app.parse_args(["f", *FLAGS, "--device", "cpu"]))
    assert not eng._auto_cfg and not eng.settings.enable_edl
    assert (eng.cfg.step_points, eng.cfg.node_capacity, eng.cfg.point_capacity,
            eng.cfg.voxel_capacity, eng.cfg.spill_capacity) \
        == (32768, 4096, 262144, 524288, 32768)
    assert eng.settings.min_node_size == 8.0


def test_no_input_returns_2():
    assert _main(app.main, ["--device", "cpu"])[0] == 2


def test_default_device_is_the_card(cloud):
    """Without --device the engine is on CUDA: with no card, main raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        app.main([cloud, "--json"])
