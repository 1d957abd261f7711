"""Properties of the port itself: it never imports jax, its kernel wrappers have
no CPU fallback, and (on a card, marker `cuda`) the CUDA tile, splat,
splat_samples, visibility, plan_blocks and edl kernels are bit-equal to their
plain PyTorch versions. On a machine with a card, run the card tests with
`python -m pytest tests/test_torch_port.py -m cuda --noconftest`;
chip_smoke.py runs the same comparisons at the main path's shapes."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import simlod_tpu_torch
from simlod_tpu_torch import constants as C
from simlod_tpu_torch import kernels
from simlod_tpu_torch.config import EngineConfig, Settings, Uniforms
from simlod_tpu_torch.engine import Engine
from simlod_tpu_torch.render import raster, raster_tiles

# six test processes share the machine in the tier-1 run; these small tensors
# gain nothing from intra-op threads, which would oversubscribe the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = ["simlod_tpu_torch", "simlod_tpu_torch.app", "simlod_tpu_torch.config",
           "simlod_tpu_torch.constants", "simlod_tpu_torch.engine",
           "simlod_tpu_torch.graphs",
           "simlod_tpu_torch.kernels", "simlod_tpu_torch.native",
           "simlod_tpu_torch.outofcore", "simlod_tpu_torch.formats.las",
           "simlod_tpu_torch.formats.laz", "simlod_tpu_torch.formats.simlod",
           "simlod_tpu_torch.formats.synthetic", "simlod_tpu_torch.io.streaming",
           "simlod_tpu_torch.octree.build",
           "simlod_tpu_torch.octree.colorfilter",
           "simlod_tpu_torch.octree.inspect",
           "simlod_tpu_torch.octree.structures",
           "simlod_tpu_torch.ops.morton", "simlod_tpu_torch.ops.ragged",
           "simlod_tpu_torch.ops.segments",
           "simlod_tpu_torch.parallel.engine",
           "simlod_tpu_torch.parallel.outofcore",
           "simlod_tpu_torch.parallel.shard", "simlod_tpu_torch.render.camera",
           "simlod_tpu_torch.render.drawpool",
           "simlod_tpu_torch.render.frustum", "simlod_tpu_torch.render.lines",
           "simlod_tpu_torch.render.raster",
           "simlod_tpu_torch.render.raster_tiles",
           "simlod_tpu_torch.render.render",
           "simlod_tpu_torch.render.visibility",
           "simlod_tpu_torch.tools.las2simlod",
           "simlod_tpu_torch.utils.debugprint",
           "simlod_tpu_torch.utils.hostutils",
           "simlod_tpu_torch.utils.hotreload", "simlod_tpu_torch.utils.trace",
           "simlod_tpu_torch.viewer"]


def test_port_never_imports_jax():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] == 'jax'"
            " or m.startswith('simlod_tpu.') or m == 'simlod_tpu'))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_every_port_module_is_listed():
    pkg = os.path.dirname(simlod_tpu_torch.__file__)
    found = set()
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, f), os.path.dirname(pkg))
                mod = rel[:-3].replace(os.sep, ".")
                found.add(mod[:-len(".__init__")] if mod.endswith("__init__")
                          else mod)
    assert found - {"simlod_tpu_torch.formats", "simlod_tpu_torch.io",
                    "simlod_tpu_torch.octree", "simlod_tpu_torch.ops",
                    "simlod_tpu_torch.parallel", "simlod_tpu_torch.render",
                    "simlod_tpu_torch.tools",
                    "simlod_tpu_torch.utils"} == set(MODULES)


# the layers below the renderer: neither they nor graphs.py import render/
LOWER = ("octree", "ops", "io", "formats", "kernels", "utils")


def _imports(mod: str) -> set:
    """Every module that `mod`'s source imports, function-level imports
    included, as absolute names (and each imported name as mod.name)."""
    path = os.path.join(ROOT, *mod.split("."))
    is_pkg = os.path.isdir(path)
    path = os.path.join(path, "__init__.py") if is_pkg else path + ".py"
    with open(path) as f:
        tree = ast.parse(f.read())
    pkg = mod.split(".") if is_pkg else mod.split(".")[:-1]
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                base = ".".join(pkg[:len(pkg) - node.level + 1]
                                + ([node.module] if node.module else []))
            out.add(base)
            out.update(f"{base}.{a.name}" for a in node.names)
    return out


def _imports_render(mod: str) -> bool:
    return any(m == "simlod_tpu_torch.render"
               or m.startswith("simlod_tpu_torch.render.")
               for m in _imports(mod))


def test_lower_layers_never_import_render():
    lower = [m for m in MODULES
             if m.partition(".")[2].split(".")[0] in (*LOWER, "graphs")]
    assert len(lower) >= 18
    assert [m for m in lower if _imports_render(m)] == []
    # the scan resolves relative imports at module level and in functions
    assert _imports_render("simlod_tpu_torch.parallel.shard")
    assert "simlod_tpu_torch.ops.ragged" in _imports(
        "simlod_tpu_torch.octree.structures")
    assert "simlod_tpu_torch.octree.structures._cand_capacity" in _imports(
        "simlod_tpu_torch.config")


def _stream(n_tiles=4):
    cols = torch.zeros((8, 4), dtype=torch.int32)
    offs = torch.zeros(n_tiles + 1, dtype=torch.int32)
    return cols, offs, torch.ones(1, dtype=torch.int32), n_tiles


def test_tile_resolve_rejects_cpu_tensors():
    before = raster_tiles.tile_resolve.launches
    with pytest.raises(ValueError, match="CUDA"):
        raster_tiles.tile_resolve(*_stream())
    assert raster_tiles.tile_resolve.launches == before


def test_cpu_frames_use_the_plain_version_and_count_no_launch():
    before = raster_tiles.tile_resolve.launches
    rng = np.random.default_rng(0)
    n = 512
    s = raster.Samples(
        x=torch.from_numpy(rng.uniform(-.5, .5, n).astype(np.float32)),
        y=torch.from_numpy(rng.uniform(-.5, .5, n).astype(np.float32)),
        z=torch.from_numpy(rng.uniform(1, 3, n).astype(np.float32)),
        rgba=torch.from_numpy(rng.integers(0, 2**31, n).astype(np.int32)),
        node_fn=None, level_fn=None, valid=torch.ones(n, dtype=torch.bool),
        count=torch.tensor(n))
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = m[1, 1] = m[3, 2] = 1.0
    u = Uniforms.make(64, 48, m, device="cpu")
    color, depth = raster_tiles.rasterize_tiles(EngineConfig(), u, 64, 48, [s])
    _, ref_d = raster.rasterize(EngineConfig(), u, 64, 48, [s])
    np.testing.assert_array_equal(depth.numpy(), ref_d.numpy())
    assert raster_tiles.tile_resolve.launches == before


def test_engine_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(device="cuda")


def test_native_build_has_no_fallback(monkeypatch, tmp_path):
    """Without a C compiler the host codecs' build raises; the LAS decode has
    no numpy fallback on its main path."""
    from simlod_tpu_torch import native
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CC", raising=False)
    with pytest.raises(RuntimeError, match="compiler"):
        native.load()


def test_kernel_build_has_no_fallback(monkeypatch, tmp_path):
    """Without nvcc the build raises; nothing falls back to the plain version."""
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build()


# a stand-in for nvcc: logs its call, fails on a source named bad.cu, else
# writes its -o file
FAKE_NVCC = """#!/bin/sh
echo "$@" >> "${0%/*}/calls.log"
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in -o) out="$2"; shift;; -c) src="$2"; shift;; esac
  shift
done
case "$src" in *bad.cu) echo "bad.cu: error"; exit 2;; esac
echo built > "$out"
"""


def _fake_toolchain(monkeypatch, tmp_path, sources):
    src, bin_ = tmp_path / "csrc", tmp_path / "bin"
    src.mkdir()
    bin_.mkdir()
    for name in sources:
        (src / name).write_text(f"// {name}\n")
    nvcc = bin_ / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setattr(kernels, "SRC_DIR", src)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(bin_))
    return bin_ / "calls.log"


def test_kernel_build_compiles_each_source_then_links_once(monkeypatch, tmp_path):
    """One nvcc -c per source, one link of their objects into the library,
    which a second build reuses; no object file is left behind."""
    calls = _fake_toolchain(monkeypatch, tmp_path, ["a.cu", "b.cu"])
    out = kernels.build()
    assert out == kernels.library_path() and out.read_text() == "built\n"
    lines = calls.read_text().splitlines()
    assert sorted(ln.split(" -c ")[1].split()[0].rsplit("/", 1)[1]
                  for ln in lines[:2]) == ["a.cu", "b.cu"]
    assert "-shared" in lines[2].split() and lines[2].count(".o") == 2
    assert [p.name for p in out.parent.iterdir()] == [out.name]
    assert kernels.build() == out and kernels.build_seconds == 0.0
    assert len(calls.read_text().splitlines()) == 3


def test_kernel_build_raises_on_a_failed_source(monkeypatch, tmp_path):
    """A source that does not compile fails the build with nvcc's output; no
    library or object file is left behind."""
    _fake_toolchain(monkeypatch, tmp_path, ["a.cu", "bad.cu"])
    with pytest.raises(RuntimeError, match="bad.cu: error"):
        kernels.build()
    assert list((tmp_path / "build").iterdir()) == []


@pytest.mark.cuda
@pytest.mark.parametrize("hqs", [True, False])
def test_tile_kernel_matches_plain_version(hqs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no interpret mode)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    n = 200_000
    f = lambda a: torch.from_numpy(a).to(dev)
    s = raster.Samples(
        x=f(rng.uniform(-.8, .8, n).astype(np.float32)),
        y=f(rng.uniform(-.8, .8, n).astype(np.float32)),
        z=f(rng.uniform(1, 5, n).astype(np.float32)),
        rgba=f(rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)),
        node_fn=None, level_fn=None,
        valid=torch.ones(n, dtype=torch.bool, device=dev),
        count=torch.tensor(n, device=dev))
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = m[1, 1] = m[3, 2] = 1.0
    u = Uniforms.make(640, 480, m, settings=Settings(use_high_quality_shading=hqs),
                      device=dev)
    packed = raster_tiles.pack_samples(EngineConfig(), u, 640, 480, [s])
    kc, kd = raster_tiles.tile_resolve(*packed)
    rc, rd = raster_tiles.tile_resolve_reference(*packed)
    torch.cuda.synchronize()
    assert torch.equal(kc, rc) and torch.equal(kd, rd)


@pytest.mark.cuda
@pytest.mark.parametrize("hqs", [True, False])
def test_splat_kernel_matches_plain_version(hqs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no interpret mode)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    n = 200_000
    f = lambda a: torch.from_numpy(a).to(dev)
    x = rng.uniform(-.8, .8, n).astype(np.float32)
    y = rng.uniform(-.8, .8, n).astype(np.float32)
    z = rng.uniform(1, 5, n).astype(np.float32)
    # exact (pixel, depth) ties with other colours, and a crowded pixel
    x[1000:2000], y[1000:2000], z[1000:2000] = x[:1000], y[:1000], z[:1000]
    x[5000:6000], y[5000:6000] = 0.1, 0.1
    s = raster.Samples(
        x=f(x), y=f(y), z=f(z),
        rgba=f(rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)),
        node_fn=None, level_fn=None,
        valid=torch.ones(n, dtype=torch.bool, device=dev),
        count=torch.tensor(n, device=dev))
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = m[1, 1] = m[3, 2] = 1.0
    u = Uniforms.make(640, 480, m, settings=Settings(use_high_quality_shading=hqs),
                      device=dev)
    npx = 640 * 480
    cols = raster.splat_columns(EngineConfig(), u, 640, 480, [s], npx)
    mode = torch.tensor([int(hqs)], dtype=torch.int32, device=dev)
    before = raster.splat_resolve.launches
    kc, kd = raster.splat_resolve(*cols, mode, npx)
    rc, rd = raster.splat_resolve_reference(*cols, mode, npx)
    torch.cuda.synchronize()
    assert raster.splat_resolve.launches == before + 1
    assert torch.equal(kc, rc) and torch.equal(kd, rd)
    assert (kc != C.BACKGROUND_COLOR).float().mean() > 0.05


# name: (Settings overrides, max_point_size, pooled, sample window or None
# for the engine's own windows); tests/test_torch_draw.py holds the plain
# version to the JAX package in the same cases
DRAW_CASES = {
    "exact": ({}, 1, False, None),
    "pooled": (dict(point_budget=1.0), 1, True, None),
    "point_size_2": (dict(point_size=2), 2, False, None),
    "pooled_point_size_2": (dict(point_budget=1.0, point_size=2), 2, True,
                            None),
    "color_by_node": (dict(color_by_node=True), 1, False, None),
    "color_by_lod": (dict(color_by_lod=True), 1, False, None),
    "pooled_color_by_lod": (dict(point_budget=1.0, color_by_lod=True), 1,
                            True, None),
    "color_white": (dict(color_white=True), 1, False, None),
    "show_points_off": (dict(show_points=False), 1, False, None),
    "truncating": ({}, 1, False, 128 * 40),
}


@pytest.fixture(scope="module")
def card_engine(tmp_path_factory):
    """A 60k-point terrain loaded by Engine on the card (the golden fixture's
    config, max_point_size 2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no interpret mode)")
    from simlod_tpu_torch.formats import simlod, synthetic
    xyz, rgba = synthetic.terrain(60_000, seed=23, extent=1.0, z_scale=0.4)
    path = str(tmp_path_factory.mktemp("draw") / "terrain.simlod")
    simlod.write(path, xyz, rgba)
    cfg = EngineConfig(
        candidate_factor=21, cand_multi_rows=1 << 13, node_capacity=1 << 12,
        point_capacity=1 << 17, voxel_capacity=1 << 19,
        segment_capacity=1 << 14, step_points=1 << 13, spill_capacity=1 << 13,
        max_splits_per_round=64, seg_select_cap=1 << 10,
        max_points_per_node=256, max_render_points=1 << 17,
        max_render_voxels=1 << 17, max_point_size=2)
    eng = Engine(cfg, Settings(min_node_size=8.0), device="cuda")
    eng.open([path])
    eng.load_all()
    eng.orbit.yaw, eng.orbit.pitch = 0.3, -0.6
    eng.camera.world = eng.orbit.world()
    yield eng
    eng.stream.stop()


@pytest.mark.cuda
@pytest.mark.parametrize("hqs", [True, False])
@pytest.mark.parametrize("case", list(DRAW_CASES))
def test_splat_samples_matches_plain_version(card_engine, case, hqs):
    import dataclasses
    from simlod_tpu_torch.render.render import (frame_samples,
                                                pooled_frame_samples)
    eng = card_engine
    settings, mps, pooled, win = DRAW_CASES[case]
    eng.settings = Settings(min_node_size=8.0, use_high_quality_shading=hqs,
                            **settings)
    W, H = 160, 120
    eng.render(W, H)        # builds the pool, sizes the windows
    u = eng.uniforms(W, H)
    cfg = dataclasses.replace(eng.cfg, max_point_size=mps)
    if pooled:
        _, sets, _ = pooled_frame_samples(cfg, eng.state, eng._draw_pool, u,
                                          *eng.last_pooled_windows)
        assert len(sets) == 4
    else:
        wins = (win, win) if win else eng.last_windows
        _, sets, _ = frame_samples(cfg, eng.state, u, *wins)
    before = raster.splat_samples.launches
    kc, kd = raster.splat_samples(cfg, u, W, H, sets)
    rc, rd = raster.splat_samples_reference(cfg, u, W, H, sets)
    torch.cuda.synchronize()
    assert raster.splat_samples.launches == before + 1
    assert torch.equal(kd, rd) and torch.equal(kc, rc)
    drawn = (kd != C.DEPTH_INF_BITS).float().mean()
    assert drawn == 0 if case == "show_points_off" else drawn > 0.01


# the frame kernels (csrc/frame.cu) against their plain versions on the card

def _eye_plane():
    """w = z: the root's corners at z = 0 project to 0/0 and x/0 (NaN
    extents), nodes at z < 0 lie behind the eye."""
    return np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, -0.1],
                     [0, 0, 1, 0]], np.float32)


def _bits_equal(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("pooled", [False, True])
@pytest.mark.parametrize("camera", ["orbit", "close", "eye_plane"])
def test_visibility_kernel_matches_plain_version(card_engine, camera, pooled):
    from simlod_tpu_torch.render import visibility
    eng = card_engine
    eng.settings = Settings(min_node_size=8.0,
                            point_budget=1.0 if pooled else 0.0)
    W, H = 160, 120
    eng.render(W, H)          # builds the pool
    o = eng.orbit
    saved = o.radius
    if camera == "close":
        o.radius = 0.05 * o.radius
        eng.camera.world = o.world()
    u = eng.uniforms(W, H)
    if camera == "eye_plane":
        u = Uniforms.make(W, H, _eye_plane(), settings=eng.settings,
                          device="cuda")
    o.radius = saved
    eng.camera.world = o.world()
    pool = eng._draw_pool if pooled else None
    before = visibility.compute_visibility_cuda.launches
    got = visibility.compute_visibility_cuda(eng.state, u, pool, eng.cfg)
    want = visibility.compute_visibility_reference(eng.state, u, pool, eng.cfg)
    torch.cuda.synchronize()
    assert visibility.compute_visibility_cuda.launches == before + 1
    for f in want._fields:
        if getattr(want, f) is None:
            assert getattr(got, f) is None, f
            continue
        assert _bits_equal(getattr(got, f), getattr(want, f)), f
    if camera == "eye_plane":
        assert torch.isnan(got.dx).any()
    else:
        assert got.emitted.any()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_frustum_planes_match_the_card(seed):
    """The planes the visibility kernel takes by value equal the ones its
    plain version computes on the card, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from simlod_tpu_torch.render import frustum
    from simlod_tpu_torch.render.camera import Camera, OrbitControls
    rng = np.random.default_rng(seed)
    c = Camera(width=1920, height=1080)
    o = OrbitControls()
    o.focus_box([0, 0, 0], rng.uniform(0.5, 100.0, 3))
    o.yaw, o.pitch = rng.uniform(-3, 3), rng.uniform(-1.4, 1.4)
    c.world = o.world()
    for t in (c.transform(), _eye_plane()):
        host = frustum.frustum_planes_host(t)
        card = frustum.frustum_planes(torch.from_numpy(t).cuda()).cpu()
        assert np.array_equal(host.view(np.int32), card.numpy().view(np.int32))


def _segments(rng, S, nodes):
    cnt = rng.integers(1, 300, S).astype(np.int32)
    cnt[rng.random(S) < 0.25] = 0
    cnt[rng.random(S) < 0.05] = 900
    cnt[-3:] = 0                         # the last segments are empty
    off = np.concatenate([[0], np.cumsum(cnt + rng.integers(0, 40, S))[:-1]])
    node = rng.integers(0, nodes, S).astype(np.int32)
    node[rng.random(S) < 0.1] = -1
    return off.astype(np.int32), cnt, node


@pytest.mark.cuda
@pytest.mark.parametrize("select", ["by_node", "per_segment", "none"])
@pytest.mark.parametrize("S,out_len", [(100, 1 << 16), (5000, 1 << 20),
                                       (5000, 128 * 900), (1, 128)])
def test_plan_blocks_kernel_matches_plain_version(select, S, out_len):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no interpret mode)")
    from simlod_tpu_torch.ops import ragged
    rng = np.random.default_rng(S)
    off, cnt, node = _segments(rng, S, 64)
    f = lambda a: torch.from_numpy(a).cuda()
    mask = index = None
    if select == "by_node":
        mask, index = f(rng.random(64) < 0.6), f(node)
    elif select == "per_segment":
        mask = f(rng.random(S) < 0.6)
    before = ragged.plan_blocks_cuda.launches
    got = ragged.plan_blocks_cuda(f(off), f(cnt), out_len, mask, index)
    want = ragged.plan_blocks_reference(f(off), f(cnt), out_len, mask, index)
    torch.cuda.synchronize()
    assert ragged.plan_blocks_cuda.launches == before + 1
    for name in ("src_row", "pstart_r", "pend_r", "r_ok", "sr", "mpos",
                 "count"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("nsets", [1, 2, 4, 8])
@pytest.mark.parametrize("S", [8192, 327680])
def test_plan_blocks_many_kernel_matches_plain_version(S, nsets):
    """One cooperative launch plans every set, bit-equal to the plain
    version on every field: at a frame's 8,192 segments and at shard 0's
    327,680 (320 tiles a set), selections by node, per segment, none and
    nothing selected, windows that hold the selection and ones that
    truncate it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no interpret mode)")
    from simlod_tpu_torch.ops import ragged
    rng = np.random.default_rng(S + nsets)
    f = lambda a: torch.from_numpy(a).cuda()
    specs = []
    for k in range(nsets):
        off, cnt, node = _segments(rng, S, 4096)
        kind = k % 4
        if kind == 0:
            mask, index = f(rng.random(4096) < 0.6), f(node)
        elif kind == 1:
            mask, index = f(rng.random(S) < 0.6), None
        elif kind == 2:
            mask = index = None
        else:
            mask, index = torch.zeros(S, dtype=torch.bool, device="cuda"), None
        total = int(cnt.sum()) + 256 * S
        out_len = 128 * (total // 128 // (3 if k % 3 == 1 else 1) + 1)
        specs.append((f(off), f(cnt), out_len, mask, index))
    before = ragged.plan_blocks_cuda.launches
    got = ragged.plan_blocks_many_cuda(specs)
    want = ragged.plan_blocks_many_reference(specs)
    torch.cuda.synchronize()
    assert ragged.plan_blocks_cuda.launches == before + 1
    dev = specs[0][0].device
    assert 1 <= kernels.last_grid("plan_blocks") \
        <= kernels.coop_grid("plan_blocks", dev)
    for g, w in zip(got, want):
        for name in ("src_row", "pstart_r", "pend_r", "r_ok", "sr", "mpos",
                     "count"):
            assert torch.equal(getattr(g, name), getattr(w, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("pooled", [False, True])
def test_visibility_kernel_twice_back_to_back(card_engine, pooled):
    """No state carries over between calls (no memset, no counter left on
    the card): two calls in a row give equal counts, equal to the plain
    version's."""
    from simlod_tpu_torch.render import visibility
    eng = card_engine
    eng.settings = Settings(min_node_size=8.0,
                            point_budget=1.0 if pooled else 0.0)
    eng.render(160, 120)
    u = eng.uniforms(160, 120)
    pool = eng._draw_pool if pooled else None
    a = visibility.compute_visibility_cuda(eng.state, u, pool, eng.cfg)
    b = visibility.compute_visibility_cuda(eng.state, u, pool, eng.cfg)
    want = visibility.compute_visibility_reference(eng.state, u, pool,
                                                   eng.cfg)
    torch.cuda.synchronize()
    for f in ("num_visible_nodes", "num_visible_inner", "num_visible_leaves",
              "num_visible_points", "num_visible_voxels"):
        assert int(getattr(a, f)) == int(getattr(b, f)) \
            == int(getattr(want, f)), f
    assert int(a.num_visible_nodes) > 0
    assert (a.take_p is None) == (not pooled)
    n = eng.state.child_base.shape[0]
    assert kernels.last_grid("visibility") == min(
        kernels.coop_grid("visibility", eng.state.child_base.device),
        -(-n // 256))


@pytest.mark.cuda
def test_cooperative_grids_and_the_launch_floor():
    """The co-resident grids are positive and the empty kernel launches
    plainly and cooperatively through the ctypes path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, threads in (("plan_blocks", 1024), ("visibility", 256)):
        g = kernels.coop_grid(name, dev)
        assert sms <= g <= sms * 2048 // threads, (name, g)
    before = kernels.noop.launches
    kernels.noop(dev)
    kernels.noop(dev, cooperative=True)
    torch.cuda.synchronize()
    assert kernels.noop.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("strength", [0.4, 1.5])
def test_edl_kernel_matches_plain_version(card_engine, strength):
    import dataclasses
    from simlod_tpu_torch.render.render import render_components
    eng = card_engine
    eng.settings = Settings(min_node_size=8.0, edl_strength=strength)
    W, H = 160, 120
    eng.render(W, H)
    u = eng.uniforms(W, H)
    color, depth, _ = render_components(eng.cfg, eng.state, W, H, u,
                                        *eng.last_windows)
    rng = np.random.default_rng(3)
    d = rng.uniform(0.5, 50.0, (H, W)).astype(np.float32)
    d[rng.random((H, W)) < 0.3] = np.inf
    d[:, 0] = d[:, -1] = 2.0
    cases = [(color, depth), (torch.from_numpy(rng.integers(
        -2**31, 2**31 - 1, W * H).astype(np.int32)).cuda(),
        torch.from_numpy(d.reshape(-1).view(np.int32)).cuda())]
    for c, dep in cases:
        before = raster.edl_cuda.launches
        got = raster.edl_cuda(c, dep, u, W, H)
        want = raster.edl_reference(c, dep, u, W, H)
        torch.cuda.synchronize()
        assert raster.edl_cuda.launches == before + 1
        assert torch.equal(got, want)
    off = dataclasses.replace(u, flags=dataclasses.replace(u.flags,
                                                           enable_edl=False))
    assert raster.edl(color, depth, off, W, H) is color


def _edl_case(w, h, background, device):
    """Colours and depth bits at w x h: every pixel background (+inf), or
    background patches, drawn edge rows and columns (the neighbours wrap)
    and depth steps."""
    rng = np.random.default_rng(w * 7919 + h)
    depth = np.full((h, w), np.inf, np.float32)
    if not background:
        depth = rng.uniform(0.5, 50.0, (h, w)).astype(np.float32)
        depth[rng.random((h, w)) < 0.3] = np.inf
        depth[h // 4:h // 2, w // 4:w // 2] = np.inf
        depth[:, 0] = depth[:, -1] = 2.0
        depth[0, :] = 0.75
        depth[-1, :] = 4.0
    color = rng.integers(-2**31, 2**31 - 1, w * h).astype(np.int32)
    f = lambda a: torch.from_numpy(a.reshape(-1)).to(device)
    return f(color), f(depth.view(np.int32))


def _offset(t):
    """t's values in a tensor that starts 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:].copy_(t)
    return buf[1:]


@pytest.mark.cuda
@pytest.mark.parametrize("strength", [0.4, 1.5])
@pytest.mark.parametrize("size", [(1, 1), (1, 9), (4, 3), (31, 7), (33, 9),
                                  (132, 9), (1920, 1080), (1921, 1081),
                                  (3840, 2160)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_edl_kernel_matches_plain_version_at_every_size(size, strength):
    """The 128 x 8-tile kernel: images smaller than a tile (the halo wraps
    onto the tile itself), partial tiles at the right and bottom edges and a
    thread's 4 pixels cut by the right edge (widths not a multiple of 4: the
    scalar path), 16-byte loads and stores (widths a multiple of 4) and the
    same widths from planes that are not 16-byte aligned (the scalar path
    again), 1080p, 1080p plus one and 4K; bit-equal, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no interpret mode)")
    w, h = size
    u = Uniforms.make(w, h, np.eye(4, dtype=np.float32),
                      settings=Settings(edl_strength=strength), device="cuda")
    for case in ("background", "drawn", "drawn, not aligned"):
        c, dep = _edl_case(w, h, case == "background", "cuda")
        if case == "drawn, not aligned":
            c, dep = _offset(c), _offset(dep)
        before = raster.edl_cuda.launches
        got = raster.edl_cuda(c, dep, u, w, h)
        want = raster.edl_reference(c, dep, u, w, h)
        torch.cuda.synchronize()
        assert raster.edl_cuda.launches == before + 1
        assert torch.equal(got, want), (case, int((got != want).sum()))


@pytest.mark.cuda
def test_edl_kernel_reads_its_strength_on_the_device():
    """Changing uniforms.edl_strength on the device changes the kernel's
    result; the host copies of the uniforms stay as they were."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no interpret mode)")
    w, h = 160, 120
    u = Uniforms.make(w, h, np.eye(4, dtype=np.float32),
                      settings=Settings(edl_strength=0.4), device="cuda")
    host = u.host
    c, dep = _edl_case(w, h, False, "cuda")
    weak = raster.edl_cuda(c, dep, u, w, h)
    u.edl_strength.fill_(1.5)
    strong = raster.edl_cuda(c, dep, u, w, h)
    torch.cuda.synchronize()
    assert u.host is host and u.host == host
    assert not torch.equal(weak, strong)
    assert torch.equal(strong, raster.edl_reference(c, dep, u, w, h))
    u.edl_strength.fill_(0.4)
    assert torch.equal(raster.edl_cuda(c, dep, u, w, h), weak)


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [0.0, 1.0])
def test_card_frames_launch_the_frame_kernels(card_engine, budget):
    from simlod_tpu_torch.ops import ragged
    from simlod_tpu_torch.render import visibility
    eng = card_engine
    eng.settings = Settings(min_node_size=8.0, point_budget=budget)
    eng.render(160, 120)
    fns = (visibility.compute_visibility_cuda, ragged.plan_blocks_cuda,
           raster.edl_cuda, raster.splat_samples)
    before = [f.launches for f in fns]
    syncs = eng.host_syncs
    img, st = eng.render(160, 120)
    torch.cuda.synchronize()
    n = [f.launches - b for f, b in zip(fns, before)]
    # one plan launch for the frame's 2 or 4 sets; a pooled frame may re-probe
    # its windows (one more visibility launch and one more read)
    assert n[1:] == [1, 1, 1] and 1 <= n[0] <= 1 + budget
    assert 2 <= eng.host_syncs - syncs <= 2 + budget
    assert st.num_visible_points + st.num_visible_voxels > 0
