"""Headless application entry point — the reference's main() + GUI loop
(C1/C14/C15; port of simlod_tpu/app.py).

The reference is an interactive GLFW/ImGui desktop app; this environment is headless,
so the app streams files (or a synthetic cloud), runs the simultaneous build+render
loop along an orbit camera path, writes frames to disk, and prints the stats table the
reference shows in its ImGui windows (main_progressive_octree.cpp:1484-1583).

It runs on the card unless --device names another (`--device cpu` runs the
kernels' plain PyTorch versions); without a card the default raises.

Usage:
  python -m simlod_tpu_torch.app cloud.simlod --frames 60 --out frames/
  python -m simlod_tpu_torch.app --synthetic 10000000 --benchmark
  python -m simlod_tpu_torch.app --serve cloud.las
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np

from .config import EngineConfig, Settings
from .engine import Engine
from .formats import synthetic, simlod
from .render.render import image_to_rgba8, write_ppm


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m simlod_tpu_torch.app",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*", help=".las/.laz/.simlod files or directories")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="generate N synthetic terrain points instead of files")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=0,
                    help="render N frames along an orbit path (0 = build only)")
    ap.add_argument("--out", default=None, help="directory for output frames")
    ap.add_argument("--png", action="store_true",
                    help="write PNG (stdlib encoder, viewer.encode_png) not PPM")
    ap.add_argument("--benchmark", action="store_true",
                    help="print the min/max/avg timing table at the end")
    ap.add_argument("--step-points", type=int, default=EngineConfig.step_points)
    ap.add_argument("--node-capacity", type=int, default=EngineConfig.node_capacity)
    ap.add_argument("--point-capacity", type=int, default=EngineConfig.point_capacity)
    ap.add_argument("--voxel-capacity", type=int, default=EngineConfig.voxel_capacity)
    ap.add_argument("--min-node-size", type=float, default=Settings.min_node_size)
    ap.add_argument("--point-size", type=int, default=Settings.point_size)
    ap.add_argument("--no-edl", action="store_true")
    ap.add_argument("--no-hqs", action="store_true")
    ap.add_argument("--color-by-lod", action="store_true")
    ap.add_argument("--color-by-node", action="store_true")
    ap.add_argument("--show-boxes", action="store_true")
    ap.add_argument("--filter-colors", action="store_true",
                    help="run the bottom-up voxel color filter after loading "
                         "(the reference's disabled colorfilter pass, enabled here)")
    ap.add_argument("--json", action="store_true", help="print stats as JSON")
    ap.add_argument("--serve", action="store_true",
                    help="serve an interactive viewer over HTTP (browser orbit "
                         "controls; the headless stand-in for the reference's "
                         "GLFW window, see viewer.py)")
    ap.add_argument("--port", type=int, default=8642)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default cuda: raises "
                         "without a card; cpu runs the kernels' plain versions)")
    return ap.parse_args(argv)


def build_engine(args) -> Engine:
    defaults = (args.node_capacity == EngineConfig.node_capacity
                and args.point_capacity == EngineConfig.point_capacity
                and args.voxel_capacity == EngineConfig.voxel_capacity
                and args.step_points == EngineConfig.step_points)
    if defaults:
        # no capacity flags given: auto-size pools from device memory and the
        # stream (EngineConfig.auto) — a file needs no hand tuning
        cfg = None
    else:
        cfg = EngineConfig(
            step_points=args.step_points, node_capacity=args.node_capacity,
            point_capacity=args.point_capacity,
            voxel_capacity=args.voxel_capacity,
            spill_capacity=min(args.step_points, 4 << 20),
        )
    settings = Settings(
        min_node_size=args.min_node_size, point_size=args.point_size,
        enable_edl=not args.no_edl, use_high_quality_shading=not args.no_hqs,
        color_by_lod=args.color_by_lod, color_by_node=args.color_by_node,
        show_bounding_box=args.show_boxes,
    )
    return Engine(cfg, settings, device=args.device)


def main(argv=None) -> int:
    args = parse_args(argv)
    eng = build_engine(args)
    with contextlib.ExitStack() as cleanup:
        if args.synthetic:
            xyz, rgba = synthetic.terrain(args.synthetic, seed=1)
            tmp = cleanup.enter_context(
                tempfile.TemporaryDirectory(prefix="simlod_synthetic_"))
            paths = [os.path.join(tmp, "synthetic.simlod")]
            simlod.write(paths[0], xyz, rgba)
            del xyz, rgba
        elif args.paths:
            paths = args.paths
        else:
            print("no input: pass files or --synthetic N", file=sys.stderr)
            return 2
        try:
            return _run(args, eng, paths)
        finally:
            if eng.stream is not None:   # before a synthetic file is removed
                eng.stream.stop()


def _run(args, eng: Engine, paths) -> int:
    t0 = time.perf_counter()
    eng.open(paths)
    print(f"streaming {eng.stream.total_points:,} points from "
          f"{len(eng.stream.entries)} file(s)", file=sys.stderr)

    if args.out:
        os.makedirs(args.out, exist_ok=True)

    frame_idx = 0
    n_frames = max(args.frames, 0)

    def emit(img):
        nonlocal frame_idx
        if not args.out:
            return
        if args.png:
            from .viewer import encode_png
            rgb = np.ascontiguousarray(image_to_rgba8(img)[::-1, :, :3])
            with open(os.path.join(args.out, f"frame_{frame_idx:04d}.png"),
                      "wb") as f:
                f.write(encode_png(rgb))
        else:
            write_ppm(os.path.join(args.out, f"frame_{frame_idx:04d}.ppm"), img)
        frame_idx += 1

    if args.serve:
        from .viewer import ViewerServer
        ViewerServer(eng, args.width, args.height, args.port).serve_forever()
        return 0

    if n_frames == 0:
        while eng.ingest_next():
            pass
        if args.filter_colors:
            eng.filter_colors()
    else:
        # simultaneous build+render along an orbit path; keep rendering after the
        # stream drains so the user sees the finished cloud
        i = 0
        filtered = False
        while not eng.last_batch_finished or i < n_frames:
            if args.filter_colors and eng.last_batch_finished and not filtered:
                eng.filter_colors()
                filtered = True
            eng.orbit.yaw += 2.0 * np.pi / max(n_frames, 60)
            eng.camera.world = eng.orbit.world()
            img, stats = eng.frame(args.width, args.height)
            emit(img)
            i += 1
            if eng.last_batch_finished and i >= n_frames:
                break

    elapsed = time.perf_counter() - t0
    rep = eng.report()
    rep["wall_seconds"] = elapsed
    rep["ingest_mps"] = rep["num_points_processed"] / elapsed / 1e6
    if args.json:
        print(json.dumps(rep, default=float))
    else:
        print(f"loaded {rep['num_points_processed']:,} points in {elapsed:.2f}s "
              f"({rep['ingest_mps']:.1f} MP/s)")
        print(f"nodes {rep['num_nodes']:,} (inner {rep['num_inner']:,}, leaves "
              f"{rep['num_leaves']:,}, nonempty {rep['num_nonempty_leaves']:,})")
        print(f"points {rep['num_points']:,}  voxels {rep['num_voxels']:,} "
              f"(stored {rep['num_voxels_stored']:,})  segments "
              f"{rep['num_segments']:,}")
        if rep["mem_capacity_reached"]:
            print("WARNING: memory capacity reached; ingestion stopped early "
                  f"(dropped {rep['num_points_dropped']:,})")
        if rep.get("num_candidates_dropped"):
            print(f"note: {rep['num_candidates_dropped']:,} voxel candidates hit "
                  "the per-step window (transient; raise cand_multi_rows to "
                  "tighten LOD colors)")
        if rep.get("render_truncated"):
            print("WARNING: last frame dropped visible samples (sample window "
                  "truncation; raise max_render_points/voxels)")
        if args.benchmark:
            # JAX's rows (build, render, fused) plus the draw-pool rebuilds
            for k, row in rep["timings"].items():
                if row["count"]:
                    print(f"  {k:7s} x{row['count']:<5d} avg {row['avg_ms']:8.2f} ms"
                          f"  min {row['min_ms']:8.2f}  max {row['max_ms']:8.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
