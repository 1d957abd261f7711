"""Properties of the port itself: it never imports jax, its kernel wrappers have
no CPU fallback, and (on a card, marker `cuda`) the CUDA tile and splat kernels
are bit-equal to their plain PyTorch versions. On a machine with a card, run the card
tests with `python -m pytest tests/test_torch_port.py -m cuda`;
chip_smoke.py runs the same comparison at the main path's shapes."""
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
           "simlod_tpu_torch.utils.hotreload", "simlod_tpu_torch.viewer"]


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
    u = Uniforms.make(64, 48, m)
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
