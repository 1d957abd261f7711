#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--points N]

Phases (every one must pass; a failure raises and exits non-zero):
  1. card and build: print the card's name and power limit (nvidia-smi), build
     the CUDA kernels from simlod_tpu_torch/csrc with nvcc, print the seconds;
  2. small reference: a 60k-point terrain through Engine on the GPU and on the
     CPU (plain PyTorch versions of the kernels): equal counters, images within
     1 per channel of each other and of the goldens in tests/golden/;
  3. main path: a seeded synthetic terrain of N points (default 36M, the size of
     the Morro Bay file) written as .simlod, then Engine(cfg=None).open ->
     load_all -> render(1920, 1080); every kernel launch counter is zeroed
     before and read after;
  4. kernel against plain version: the packed, sorted sample stream of that
     frame through the CUDA tile kernel and its plain PyTorch version, in both
     shading modes, bit-equal, timed with CUDA events after a warm-up.

It prints a JSON line with the kernels' launches, errors and times, and as its
last line {"ok": true, "device": {...}}. Without a CUDA device it exits 1.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
W, H = 1920, 1080


def say(*a):
    print(*a, flush=True)


def check(cond, what: str):
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


# the golden fixture of tests/test_golden.py (60k points, 160x120)
GOLDEN_CFG = dict(
    candidate_factor=21, cand_multi_rows=1 << 13,
    node_capacity=1 << 12, point_capacity=1 << 17, voxel_capacity=1 << 19,
    segment_capacity=1 << 14, step_points=1 << 13, spill_capacity=1 << 13,
    max_splits_per_round=64, seg_select_cap=1 << 10, max_points_per_node=256,
    max_render_points=1 << 17, max_render_voxels=1 << 17)
GOLDEN = (("front_hqs", 0.0, -0.6, True), ("front_plain", 0.0, -0.6, False),
          ("side_hqs", 1.2, -0.3, True))


def read_ppm(path):
    import numpy as np
    with open(path, "rb") as f:
        check(f.readline().strip() == b"P6", f"{path} is not a P6 ppm")
        w, h = map(int, f.readline().split())
        f.readline()
        return np.frombuffer(f.read(), np.uint8).reshape(h, w, 3)


def golden_frames(path, device):
    """Render the golden fixtures through Engine on `device`; (images, reports)."""
    from simlod_tpu_torch.config import EngineConfig, Settings
    from simlod_tpu_torch.engine import Engine
    from simlod_tpu_torch.render.render import image_to_rgba8
    imgs, reps = {}, {}
    for name, yaw, pitch, hqs in GOLDEN:
        eng = Engine(EngineConfig(**GOLDEN_CFG),
                     Settings(use_high_quality_shading=hqs, min_node_size=8.0),
                     device=device)
        eng.open([path])
        eng.load_all()
        eng.orbit.yaw, eng.orbit.pitch = yaw, pitch
        eng.camera.world = eng.orbit.world()
        img, _ = eng.render(160, 120)
        eng.stream.stop()
        imgs[name] = image_to_rgba8(img)[..., :3].astype(int)
        rep = eng.report()
        reps[name] = {k: v for k, v in rep.items()
                      if k not in ("timings", "stream")}
    return imgs, reps


def phase_small_reference(tmp, device):
    import numpy as np
    from simlod_tpu_torch.formats import simlod, synthetic
    xyz, rgba = synthetic.terrain(60_000, seed=23, extent=1.0, z_scale=0.4)
    path = os.path.join(tmp, "golden.simlod")
    simlod.write(path, xyz, rgba)
    gpu_imgs, gpu_reps = golden_frames(path, device)
    cpu_imgs, cpu_reps = golden_frames(path, "cpu")
    for name, _, _, hqs in GOLDEN:
        check(gpu_reps[name] == cpu_reps[name],
              f"{name}: GPU counters {gpu_reps[name]} != CPU {cpu_reps[name]}")
        # EDL's log2/exp may round differently on the GPU and the CPU: a shade
        # one ulp apart can move a channel by 1
        d = np.abs(gpu_imgs[name] - cpu_imgs[name])
        check(d.max() <= 1, f"{name}: GPU vs CPU image max diff {d.max()}")
        want = read_ppm(os.path.join(ROOT, "tests", "golden", f"{name}.ppm"))
        g = np.abs(gpu_imgs[name] - want)
        # tests/test_golden.py tolerance (HQS), plus the EDL ulp above (plain)
        ok = (g.max() <= 4 and (g > 1).mean() < 0.01) if hqs else g.max() <= 1
        check(ok, f"{name}: GPU image vs golden max diff {g.max()}")
        say(f"small reference {name}: counters equal, GPU-CPU max diff "
            f"{d.max()}, GPU-golden max diff {g.max()}")


def time_ms(fn, reps: int = 20) -> float:
    import torch
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--points", type=int, default=36_000_000)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from simlod_tpu_torch import constants as C
    from simlod_tpu_torch import kernels
    from simlod_tpu_torch.config import Settings
    from simlod_tpu_torch.engine import Engine
    from simlod_tpu_torch.formats import simlod, synthetic
    from simlod_tpu_torch.render import raster_tiles
    from simlod_tpu_torch.render.render import frame_samples

    dev = torch.device("cuda")
    # --- phase 1: card and build ---
    card = card_line()
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device {torch.cuda.get_device_name(0)}")
    kernels.build()
    say(f"kernel build: {kernels.build_seconds:.2f} s ({kernels.library_path().name})")

    with tempfile.TemporaryDirectory() as tmp:
        # --- phase 2: small reference ---
        phase_small_reference(tmp, dev)

        # --- phase 3: main path ---
        n = args.points
        t0 = time.perf_counter()
        xyz, rgba = synthetic.terrain(n, seed=0)
        path = os.path.join(tmp, "terrain.simlod")
        simlod.write(path, xyz, rgba)
        del xyz, rgba
        say(f"terrain {n} points written in {time.perf_counter() - t0:.1f} s "
            f"({os.path.getsize(path) / 1e6:.0f} MB)")

        raster_tiles.tile_resolve.launches = 0
        eng = Engine(cfg=None, settings=Settings(), device=dev)
        eng.open([path])
        t0 = time.perf_counter()
        eng.load_all()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        img, stats = eng.render(W, H)
        first_ms = eng.t_render.max * 1e3
        frame_ms = []
        for _ in range(5):
            t1 = time.perf_counter()
            img, stats = eng.render(W, H)
            frame_ms.append((time.perf_counter() - t1) * 1e3)
        launches = raster_tiles.tile_resolve.launches
        rep = eng.report()
        eng.stream.stop()

        check(rep["num_points"] + rep["num_points_dropped"] == n,
              f"points {rep['num_points']} + dropped "
              f"{rep['num_points_dropped']} != {n}")
        check(not rep["mem_capacity_reached"], "mem_capacity_reached")
        check(stats.num_visible_points + stats.num_visible_voxels > 0,
              "nothing visible")
        check(tuple(img.shape) == (H, W), f"image shape {tuple(img.shape)}")
        rgb = img.cpu().numpy().view(np.uint32) & 0xFFFFFF
        cover = float((rgb != (C.BACKGROUND_COLOR & 0xFFFFFF)).mean())
        check(cover > 0.05, f"only {cover:.3%} of pixels drawn")
        check(launches > 0, "the frame did not go through the tile kernel")
        per_step = rep["host_syncs"] / max(rep["steps"], 1)
        say(f"load_all: {load_s:.2f} s = {n / load_s / 1e6:.2f} MP/s; "
            f"nodes {rep['num_nodes']}, voxels {rep['num_voxels']}, "
            f"candidates_dropped {rep['num_candidates_dropped']}, "
            f"host syncs {rep['host_syncs']} over {rep['steps']} steps "
            f"({per_step:.2f}/step)")
        say(f"render 1920x1080: first {first_ms:.2f} ms, then median "
            f"{float(np.median(frame_ms)):.2f} ms ({', '.join(f'{t:.2f}' for t in frame_ms)}); "
            f"visible points {stats.num_visible_points}, voxels "
            f"{stats.num_visible_voxels}; {cover:.1%} of pixels drawn; "
            f"tile kernel launches {launches}; card: {card}")

        # --- phase 4: kernel against plain version on this frame's stream ---
        rows = {}
        for hqs in (True, False):
            eng.settings.use_high_quality_shading = hqs
            u = eng.uniforms(W, H)
            _, sets, _ = frame_samples(eng.cfg, eng.state, u, *eng.last_windows)
            packed = raster_tiles.pack_samples(eng.cfg, u, W, H, sets)
            kc, kd = raster_tiles.tile_resolve(*packed)
            rc, rd = raster_tiles.tile_resolve_reference(*packed)
            torch.cuda.synchronize()
            err = max(int((kc.long() - rc.long()).abs().max()),
                      int((kd.long() - rd.long()).abs().max()))
            check(torch.equal(kc, rc) and torch.equal(kd, rd),
                  f"tile kernel != plain version (hqs={hqs}, max err {err})")
            ms = time_ms(lambda: raster_tiles.tile_resolve(*packed))
            plain_ms = time_ms(lambda: raster_tiles.tile_resolve_reference(*packed))
            rows[hqs] = (err, ms, plain_ms)
            say(f"tile_resolve hqs={hqs}: {packed[0].shape[0]} samples, "
                f"{packed[3]} tiles: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bit-equal; card: {card}")
        del eng

    err, ms, plain_ms = rows[True]
    say(json.dumps({"kernels": [{
        "name": "tile_resolve", "route": "cuda",
        "source": "simlod_tpu_torch/csrc/raster_tiles.cu",
        "replaces": "simlod_tpu/render/raster_tiles.py:237",
        "launches": launches, "max_abs_err": max(err, rows[False][0]),
        "ms": ms, "plain_ms": plain_ms}]}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
