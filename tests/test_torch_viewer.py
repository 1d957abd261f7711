"""The port's live viewer (simlod_tpu_torch/viewer.py) on the CPU: a port of
tests/test_viewer.py against a bound ephemeral port, plus parity with the JAX
viewer (simlod_tpu/viewer.py): `encode_png` byte-equal, `/stats` equal on the
same state (render_ms excepted), and "Reset + Benchmark" re-opening the
engine's last file set."""
import json
import threading
import urllib.request
import zlib

import numpy as np
import pytest
import torch

from simlod_tpu import viewer as jviewer
from simlod_tpu.config import EngineConfig as JCfg, Settings as JSet
from simlod_tpu.engine import Engine as JEngine
from simlod_tpu_torch.config import EngineConfig, Settings
from simlod_tpu_torch.engine import Engine
from simlod_tpu_torch.formats import simlod, synthetic
from simlod_tpu_torch.viewer import ViewerServer, encode_png

# six test processes share the machine in the tier-1 run; these small tensors
# gain nothing from intra-op threads, which would oversubscribe the cores
torch.set_num_threads(1)

# tests/test_viewer.py's config
KW = dict(candidate_factor=21, node_capacity=1 << 12, point_capacity=1 << 16,
          voxel_capacity=1 << 18, segment_capacity=1 << 14, step_points=1 << 12,
          spill_capacity=1 << 12, max_splits_per_round=64, seg_select_cap=1 << 10,
          max_render_points=1 << 17, max_render_voxels=1 << 18)
# min_node_size 8: at a 256x128 test frame the root leaf projects smaller than
# the default 2*64 px isLarge threshold and would never be emitted (reference
# selection, render.cu:918-932)
SETTINGS = dict(enable_edl=False, min_node_size=8.0)
QUERY = "yaw=0.5&pitch=-0.4&radius=2.5"


def _get(base, path, timeout=120):
    with urllib.request.urlopen(base + path, timeout=timeout) as r:
        assert r.status == 200, path
        return r.read()


def _png_size(png: bytes):
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    return int.from_bytes(png[16:20], "big"), int.from_bytes(png[20:24], "big")


@pytest.fixture
def serve():
    """serve(viewer) -> base URL of the viewer, bound to a free port and
    serving in a thread; shut down after the test."""
    started = []

    def start(v):
        port = v.bind()
        assert port == v.port > 0
        threading.Thread(target=v.serve_forever, daemon=True).start()
        started.append(v)
        return f"http://127.0.0.1:{port}"
    try:
        yield start
    finally:
        for v in started:
            v.shutdown()


def _batch():
    """tests/test_viewer.py's batch: one step of seeded uniform points."""
    rng = np.random.default_rng(2)
    B = KW["step_points"]
    xyz = rng.random((B, 3), dtype=np.float32)
    rgba = rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.uint32)
    return xyz, rgba


def _port_engine():
    xyz, rgba = _batch()
    eng = Engine(EngineConfig(**KW), Settings(**SETTINGS), device="cpu")
    eng.reset(np.zeros(3, np.float32), np.ones(3, np.float32))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    eng.ingest(t(xyz[:, 0]), t(xyz[:, 1]), t(xyz[:, 2]),
               t(rgba.view(np.int32)), len(rgba))
    eng.orbit.focus_box(np.zeros(3), np.ones(3))
    eng.camera.world = eng.orbit.world()
    return eng


def test_encode_png_roundtrip():
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (13, 7, 3), dtype=np.uint8)
    png = encode_png(np.ascontiguousarray(rgb))
    assert png[12:16] == b"IHDR" and _png_size(png) == (7, 13)
    i = png.index(b"IDAT")
    n = int.from_bytes(png[i - 4:i], "big")
    raw = zlib.decompress(png[i + 4:i + 4 + n])
    got = np.frombuffer(raw, np.uint8).reshape(13, 7 * 3 + 1)[:, 1:] \
        .reshape(13, 7, 3)
    np.testing.assert_array_equal(got, rgb)


@pytest.mark.parametrize("shape", [(1, 1), (13, 7), (64, 96), (120, 160)])
def test_encode_png_matches_jax(shape):
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    rgb = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    rgb[: shape[0] // 2] = 7       # runs that compress, beside noise
    assert encode_png(rgb) == jviewer.encode_png(rgb)


def test_page_matches_jax():
    eng = Engine(EngineConfig(**KW), Settings(**SETTINGS), device="cpu")
    jeng = JEngine(JCfg(**KW), JSet(**SETTINGS))
    for e in (eng, jeng):
        e.orbit.focus_box(np.zeros(3), np.ones(3))
    assert ViewerServer(eng, 256, 128).page() \
        == jviewer.ViewerServer(jeng, 256, 128).page()


def test_viewer_serves_frames(serve):
    eng = _port_engine()
    base = serve(ViewerServer(eng, width=256, height=128, port=0))
    page = _get(base, "/")
    assert b"canvas" in page and b"yaw" in page

    png = _get(base, "/frame?" + QUERY)
    assert _png_size(png) == (256, 128)

    stats = json.loads(_get(base, "/stats"))
    assert stats["num_nodes"] >= 1
    assert stats["num_visible_points"] + stats["num_visible_voxels"] > 0
    assert stats["streaming"] is False
    assert stats["render_ms"] > 0

    # /bench: timed frames + the reference-style copyable stats table
    # (main_progressive_octree.cpp:1505-1556)
    bench = json.loads(_get(base, "/bench?frames=3"))
    assert bench["frames"] == 3
    assert bench["timings"]["frame"]["count"] == 3
    assert bench["timings"]["frame"]["min_ms"] > 0
    assert "kernel" in bench["table"] and "nodes" in bench["table"]

    with pytest.raises(urllib.error.HTTPError) as e:
        _get(base, "/nothing")
    assert e.value.code == 404


def test_stats_match_jax():
    """The same state and camera through both viewers' `_render`: the same
    /stats keys and values (render_ms is a wall time)."""
    xyz, rgba = _batch()
    jeng = JEngine(JCfg(**KW), JSet(**SETTINGS))
    jeng.reset(np.zeros(3, np.float32), np.ones(3, np.float32))
    import jax.numpy as jnp
    jeng.ingest(jnp.asarray(xyz[:, 0]), jnp.asarray(xyz[:, 1]),
                jnp.asarray(xyz[:, 2]), jnp.asarray(rgba), len(rgba))
    jeng.orbit.focus_box(np.zeros(3), np.ones(3))
    jeng.camera.world = jeng.orbit.world()
    q = {k: [v] for k, v in (kv.split("=") for kv in QUERY.split("&"))}
    jv = jviewer.ViewerServer(jeng, 256, 128)
    tv = ViewerServer(_port_engine(), 256, 128)
    jpng, tpng = jv._render(q), tv._render(q)
    js, ts = dict(jv._last_stats), dict(tv._last_stats)
    assert js.pop("render_ms") > 0 and ts.pop("render_ms") > 0
    assert ts == js
    assert ts["num_visible_points"] + ts["num_visible_voxels"] > 0
    assert tpng == jpng               # EDL off: the same image, the same bytes


def test_reset_bench_reopens_the_last_paths(serve, tmp_path):
    """A streaming engine: /stats shows the load, /bench?reset=1 re-opens
    `_last_paths` and frames until the reload has drained."""
    xyz, rgba = synthetic.terrain(40_000, seed=4, extent=1.0, z_scale=0.4)
    path = str(tmp_path / "t.simlod")
    simlod.write(path, xyz, rgba)
    eng = Engine(EngineConfig(**dict(KW, max_points_per_node=4096)),
                 Settings(**SETTINGS), device="cpu")
    eng.open([path])
    assert eng._last_paths == [path]
    base = serve(ViewerServer(eng, width=96, height=64, port=0))
    assert _png_size(_get(base, "/frame?" + QUERY)) == (96, 64)
    assert json.loads(_get(base, "/stats"))["streaming"] is True
    for _ in range(10):
        _get(base, "/frame?" + QUERY)
        stats = json.loads(_get(base, "/stats"))
        if not stats["streaming"]:
            break
    assert stats["streaming"] is False and stats["num_points"] == 40_000
    steps = eng.steps
    bench = json.loads(_get(base, "/bench?frames=1&reset=1"))
    assert eng._last_paths == [path] and eng.last_batch_finished
    assert eng.report()["num_points"] == 40_000
    # the reset zeroed the counters: the reload ran the first load's steps,
    # one frame per streamed item of 4 steps at least
    assert eng.steps == steps == 4 * -(-40_000 // (4 * KW["step_points"]))
    assert bench["frames"] >= steps // 4
    assert "points 40000" in bench["table"]
