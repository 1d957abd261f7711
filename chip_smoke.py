#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--points N]

Phases (every one must pass; a failure raises and exits non-zero):
  1. card and build: print the card's name and power limit (nvidia-smi), build
     the CUDA kernels from simlod_tpu_torch/csrc with nvcc, print the seconds;
  2. small reference: a 60k-point terrain through Engine on the GPU and on the
     CPU (plain PyTorch versions of the kernels): equal counters, images within
     1 per channel of each other and of the goldens in tests/golden/; then
     point size 2 and each debug colour mode (by node, by LOD, white), GPU
     against CPU: within 1 per channel with EDL, bit-equal without;
  3. bulk path: a seeded synthetic terrain of N points (default 36M, the size
     of the Morro Bay file) written as .simlod, then Engine(cfg=None).open ->
     load_all -> render(1920, 1080) (exact, through the splat_samples
     kernel); the same frame then through both routes in turn (the default
     route and the tile route, use_tile_raster=True), timed alike and
     bit-equal; torch.profiler over the frame (device ms, idle share, kernels
     per frame);
  4. kernels against plain versions, in both shading modes, bit-equal, timed
     with CUDA events after a warm-up: that frame's sample sources through
     the CUDA splat_samples kernel and its plain PyTorch version
     (`samples_vs_plain`, which also times the previous design's stage,
     materialize + columns + splat_resolve, against splat_samples, in
     turns); its columns through splat_resolve and its plain version; its
     packed, sorted stream through the CUDA tile kernel and its plain
     version; the stage time of the column routes (columns + splat_resolve,
     pack_samples + tile resolve) on the same sample sets;
  5. small streamed reference: the 60k file through Engine.frame(160, 120)
     until the stream drains (one step per item, frame_budget_ms 0) on the GPU
     and the CPU: with point_budget 0 equal Stats and images within 1 per
     channel frame by frame; with point_budget 1e6 (a budget that clears every
     node) each GPU frame within 1 per channel of the CPU's pooled render of
     the same state and pool; after the load, pooled == exact bit for bit;
  6. streamed main path: the N-point file through the simultaneous loop,
     open(chunk_steps=1) -> frame(1920, 1080) until the stream drains, with
     point_budget 1.0 and frame_budget_ms 50 and the orbit yaw advanced 0.03
     rad per frame; the tree must equal phase 3's;
  7. post-load pooled vs exact 1080p frame on that loaded state, each also
     through both routes in turn (bit-equal images, both routes timed), and
     profiled at the auto-focus view;
  8. kernels against plain versions on the pooled frame's four sample sets
     (pool points, pool voxels, exact points, exact voxels), both modes;
  9. small references with the new modules, GPU against CPU: the 60k file with
     show_bounding_box on (exact and pooled frames within 1 per channel),
     filter_colors on its state (voxel colours equal per node and cell), and
     the out-of-core fixture of tests/test_outofcore.py (2 LAS bricks of 40k
     points, a 65,536-point pool: equal report(), composites within 1 per
     channel);
 10. LAS bulk path: phase 3's terrain split stably into 4 x-quadrant tiles,
     written as .las (and the same records as .laz), the .las directory through
     Engine(cfg=None).open -> load_all -> render(1920, 1080), then through
     both routes in turn; kernels against plain versions on that frame's
     sample sets;
 11. LAZ streamed path: the .laz directory through the simultaneous loop
     (open(chunk_steps=1) -> frame(1920, 1080) until drained, point_budget 1.0,
     frame_budget_ms 50, yaw +0.03 rad per frame); the tree must equal phase
     10's and each LAZ file must be decoded exactly once;
 12. colour filter and overlays on phase 10's state: filter_colors (seconds,
     host syncs, unchanged node and voxel counts), exact and pooled 1080p frames
     with show_bounding_box off and on, those with boxes also through both
     routes in turn;
 13. out-of-core on the 4 LAS tiles with a device point pool sized for one
     tile: build_all, the composited 1080p frame held against a depth-min
     composite of the per-brick planes computed on the host, a closeup
     auto_page and one frame, each frame also through both routes in turn;
     kernels against plain versions on the paged brick's sample sets;
 14. small sharded references, GPU against CPU, on a mesh of 4 shards
     (make_mesh([cuda] * 4) against make_mesh(["cpu"] * 4)): the 30k terrain
     of tests/test_sharded_engine.py through ShardedEngine (equal report(),
     per-shard trees equal by node identity, point multisets and voxel sets,
     images bit-equal with EDL off and within 1 per channel with EDL on) and
     the two slabs of tests/test_sharded_outofcore.py through
     ShardedOutOfCoreEngine (16,384-point pools per shard, which together do
     not hold the 80k points: equal report(), bit-equal composite);
 15. sharded bulk path: phase 3's file through ShardedEngine on 4 shards of
     the card at 1920x1080 (slot_factor 4, default Settings, per-shard
     EngineConfig.auto sized for the largest shard's share): load_all, then
     composited frames; the composite equal to a host depth-min of the four
     shard planes, its silhouette within IoU 0.8 of phase 3's frame; kernel
     against plain version on shard 0's stream;
 16. sharded out-of-core: phase 10's 4 LAS tiles as bricks through
     ShardedOutOfCoreEngine on the same mesh, with per-shard pools too small
     for the dataset (4 x point_capacity < N) but large enough for every
     shard's share of a tile: build, composited frames, the composite equal
     to a host depth-min of the brick planes;
 17. the app and the viewer, as a user starts them: simlod_tpu_torch.app's
     main in process on phase 3's file (--frames 30 at 1920x1080, PPM frames,
     --json report) and on phase 10's LAS tiles (--benchmark --filter-colors
     --show-boxes --png: the timing table, PNGs that decode to 1920x1080);
     `python -m simlod_tpu_torch.app <file> --json` as a subprocess (no
     --device: on the card by default); the viewer serving a fresh Engine
     that streams phase 3's file (/, 20 orbit /frame PNGs, /stats while
     streaming and after, /bench?frames=20, /bench?frames=5&reset=1, which
     re-opens the file and times the whole load); then every tensor read of
     an exact, a pooled and a streamed 1080p frame counted and held equal to
     the engine's host_syncs.
Phases 10, 13 and 15 hold splat_samples and splat_resolve to their plain
versions on their frames' sample sets as phase 4 does. Every kernel launch
counter is zeroed just before each main path (phases 3, 6, 7, 10, 11, 12, 13,
15, 16 and the app and viewer runs of 17) and read just after: splat_samples
must have run on every one, the tile kernel on the tile-route frames of
phases 3, 7, 10, 12 and 13; splat_resolve, off the frame path, on none
(launches made to compare a kernel with its plain version are not counted).
Phases 15-16 run 4 shards on one card: they show the sharded path works
there, not how it scales over cards.

It prints a JSON line with the kernels' launches, errors, times and bounds,
the card line, and as its last line {"ok": true, "device": {...}}. Without a
CUDA device it exits 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
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


# phase 2's draw modes: (name, max_point_size, Settings overrides)
MODES = (("point_size 2", 2, dict(point_size=2)),
         ("color_by_node", 1, dict(color_by_node=True)),
         ("color_by_lod", 1, dict(color_by_lod=True)),
         ("color_white", 1, dict(color_white=True)))


def mode_frames(path, device):
    """The 60k file's frame in each of MODES, with EDL on and off, through
    Engine on `device` -> {(mode, edl): rgb}."""
    from simlod_tpu_torch.config import EngineConfig, Settings
    from simlod_tpu_torch.engine import Engine
    from simlod_tpu_torch.render.render import image_to_rgba8
    out = {}
    for name, mps, kw in MODES:
        eng = Engine(EngineConfig(**GOLDEN_CFG, max_point_size=mps),
                     Settings(min_node_size=8.0, **kw), device=device)
        eng.open([path])
        eng.load_all()
        eng.orbit.yaw, eng.orbit.pitch = 0.3, -0.6
        eng.camera.world = eng.orbit.world()
        for edl in (True, False):
            eng.settings.enable_edl = edl
            out[(name, edl)] = image_to_rgba8(
                eng.render(160, 120)[0])[..., :3].astype(int)
        eng.stream.stop()
    return out


def phase_small_modes(tmp, device):
    """Phase 2's draw modes: point size 2 and the three debug colour modes,
    GPU (splat_samples) against CPU (its plain version)."""
    import numpy as np
    from simlod_tpu_torch.render import raster
    path = os.path.join(tmp, "golden.simlod")
    raster.splat_samples.launches = 0
    gpu = mode_frames(path, device)
    n = raster.splat_samples.launches
    cpu = mode_frames(path, "cpu")
    check(n >= 2 * len(MODES), f"draw modes: {n} splat_samples launches")
    diffs = {}
    for key in gpu:
        d = int(np.abs(gpu[key] - cpu[key]).max())
        # EDL's log2/exp may round differently on the GPU and the CPU
        check(d <= (1 if key[1] else 0),
              f"{key[0]}, EDL {key[1]}: GPU vs CPU max diff {d}")
        diffs[f"{key[0]}{', EDL' if key[1] else ''}"] = d
    plain = {k[0]: gpu[k] for k in gpu if not k[1]}
    check(all((plain[m] != plain["point_size 2"]).any() for m in plain
              if m != "point_size 2"), "a draw mode drew the same frame")
    say(f"small draw modes, GPU vs CPU max diff per channel (bit-equal with "
        f"EDL off): {diffs}; {n} splat_samples launches")


def streamed_frames(path, device, point_budget, on_frame=None):
    """The 60k file through Engine.frame(160, 120) until the stream drains,
    one step per item, one item per frame; (engine, [(rgb, Stats dict)])."""
    import dataclasses
    from simlod_tpu_torch.config import EngineConfig, Settings
    from simlod_tpu_torch.engine import Engine
    from simlod_tpu_torch.render.render import image_to_rgba8
    eng = Engine(EngineConfig(**GOLDEN_CFG),
                 Settings(min_node_size=8.0, frame_budget_ms=0.0,
                          point_budget=point_budget), device=device)
    eng.open([path], chunk_steps=1)
    out = []
    while not eng.last_batch_finished:
        eng.orbit.yaw += 0.05
        eng.camera.world = eng.orbit.world()
        img, st = eng.frame(160, 120)
        rgb = image_to_rgba8(img)[..., :3].astype(int)
        out.append((rgb, dataclasses.asdict(st)))
        if on_frame is not None:
            on_frame(eng, rgb, st)
    return eng, out


def phase_small_stream(tmp, device):
    """Phase 5 (see the module docstring)."""
    import numpy as np
    import torch
    from simlod_tpu_torch.config import Uniforms
    from simlod_tpu_torch.octree.structures import (state_from_numpy,
                                                    state_to_numpy)
    from simlod_tpu_torch.render import drawpool
    from simlod_tpu_torch.render.render import (image_to_rgba8,
                                                render_frame_pooled)
    path = os.path.join(tmp, "golden.simlod")
    _, gpu = streamed_frames(path, device, 0.0)
    _, cpu = streamed_frames(path, "cpu", 0.0)
    check(len(gpu) == len(cpu) > 2, f"frames {len(gpu)} vs {len(cpu)}")
    worst = 0
    for i, ((gi, gs), (ci, cs)) in enumerate(zip(gpu, cpu)):
        check(gs == cs, f"streamed frame {i}: GPU Stats {gs} != CPU {cs}")
        worst = max(worst, int(np.abs(gi - ci).max()))
    check(worst <= 1, f"streamed exact frames: GPU vs CPU max diff {worst}")
    say(f"small stream, exact: {len(gpu)} frames, Stats equal, GPU-CPU max "
        f"diff {worst}")

    # pooled: the rebuild cadence follows the wall clock, so each GPU frame is
    # held against the CPU render of the same state and pool
    diffs = []

    def on_frame(eng, rgb, st):
        s = state_from_numpy(state_to_numpy(eng.state), "cpu")
        pool = drawpool.pool_from_numpy(drawpool.pool_to_numpy(eng._draw_pool))
        u = Uniforms.make(160, 120, eng.camera.transform(),
                          eng._transform_update_bound, eng.settings)
        img, fs = render_frame_pooled(eng.cfg, s, pool, 160, 120, u,
                                      *eng.last_pooled_windows)
        check(int(fs.num_visible_points) == st.num_visible_points
              and int(fs.num_visible_voxels) == st.num_visible_voxels,
              "pooled frame: GPU and CPU visible counts differ")
        diffs.append(int(np.abs(image_to_rgba8(img)[..., :3].astype(int)
                                - rgb).max()))
    eng, pooled = streamed_frames(path, device, 1e6, on_frame)
    check(max(diffs) <= 1, f"streamed pooled frames: GPU vs CPU diffs {diffs}")
    check(pooled[-1][1]["num_points"] == gpu[-1][1]["num_points"]
          and pooled[-1][1]["num_nodes"] == gpu[-1][1]["num_nodes"],
          "pooled and exact streams built different trees")
    img_pool, _ = eng.render(160, 120)
    eng.settings.point_budget = 0.0
    img_exact, _ = eng.render(160, 120)
    check(torch.equal(img_pool, img_exact),
          "post-load render: point_budget 1e6 != point_budget 0")
    say(f"small stream, pooled: {len(pooled)} frames, GPU vs CPU render of "
        f"the same state and pool max diff {max(diffs)}, "
        f"{eng.t_pool.count} pool rebuilds; post-load pooled == exact")

# the out-of-core fixture of tests/test_outofcore.py (2 LAS bricks of 40k)
OOC_CFG = dict(
    candidate_factor=21, node_capacity=1 << 12, point_capacity=1 << 16,
    voxel_capacity=1 << 18, segment_capacity=1 << 14, step_points=1 << 12,
    spill_capacity=1 << 12, max_splits_per_round=64, seg_select_cap=1 << 10,
    max_points_per_node=1024, max_render_points=1 << 17,
    max_render_voxels=1 << 18)


def write_ooc_bricks(tmp):
    """Disjoint-box LAS bricks along x, seeded like tests/test_outofcore.py."""
    import numpy as np
    from simlod_tpu_torch.formats import las
    rng = np.random.default_rng(5)
    d = os.path.join(tmp, "ooc_small")
    os.makedirs(d, exist_ok=True)
    paths = []
    for i in range(2):
        xyz = rng.random((40_000, 3)).astype(np.float32)
        xyz[:, 0] = xyz[:, 0] * 0.9 + i * 1.0
        rgba = rng.integers(0, 2**32, 40_000, dtype=np.uint64).astype(np.uint32)
        paths.append(os.path.join(d, f"brick_{i}.las"))
        las.write(paths[-1], xyz, rgba)
    return paths


def phase_small_new(tmp, device):
    """Phase 9 (see the module docstring)."""
    import numpy as np
    from simlod_tpu_torch.config import EngineConfig, Settings
    from simlod_tpu_torch.engine import Engine
    from simlod_tpu_torch.octree import inspect
    from simlod_tpu_torch.outofcore import OutOfCoreEngine
    from simlod_tpu_torch.render.render import image_to_rgba8
    path = os.path.join(tmp, "golden.simlod")
    rgb = lambda img: image_to_rgba8(img)[..., :3].astype(int)

    def slice_run(dev):
        eng = Engine(EngineConfig(**GOLDEN_CFG),
                     Settings(min_node_size=8.0, show_bounding_box=True),
                     device=dev)
        eng.open([path])
        eng.load_all()
        eng.orbit.yaw, eng.orbit.pitch = 0.3, -0.6
        eng.camera.world = eng.orbit.world()
        eng.render(160, 120)
        # freeze the visibility camera and step back: the frozen frustum's
        # wireframe then lies inside the frame
        eng.settings.do_update_visibility = False
        eng.orbit.yaw, eng.orbit.radius = -0.2, eng.orbit.radius * 1.6
        eng.camera.world = eng.orbit.world()
        imgs = {}
        for budget in (0.0, 1.0):
            eng.settings.point_budget = budget
            imgs[budget] = rgb(eng.render(160, 120)[0])
        eng.settings.show_bounding_box = False
        eng.settings.point_budget = 0.0
        imgs["plain"] = rgb(eng.render(160, 120)[0])
        eng.filter_colors()
        vox = {k: v["voxels"] for k, v in inspect.node_table(eng.state).items()}
        eng.stream.stop()
        return imgs, vox

    (gi, gv), (ci, cv) = slice_run(device), slice_run("cpu")
    for key in (0.0, 1.0, "plain"):
        d = np.abs(gi[key] - ci[key])
        check(d.max() <= 1, f"overlay frame {key}: GPU vs CPU max diff {d.max()}")
    boxes = int((gi[0.0] != gi["plain"]).any(-1).sum())
    check(boxes > 0, "show_bounding_box drew nothing")
    check(gv == cv, "filter_colors: GPU and CPU voxel colours differ")
    say(f"small overlays: exact and pooled frames with boxes GPU-CPU max diff "
        f"<= 1, {boxes} pixels differ from the frame without boxes; "
        f"filter_colors: {sum(map(len, gv.values()))} voxels in {len(gv)} "
        f"nodes equal per (node, cell) on GPU and CPU")

    paths = write_ooc_bricks(tmp)

    def ooc_run(dev):
        o = OutOfCoreEngine(EngineConfig(**OOC_CFG), Settings(), device=dev)
        o.open(paths)
        o.build_all()
        return o.report(), rgb(o.render(320, 200)[0])

    (gr, gimg), (cr, cimg) = ooc_run(device), ooc_run("cpu")
    check(gr == cr, f"out-of-core report: GPU {gr} != CPU {cr}")
    d = np.abs(gimg - cimg)
    check(d.max() <= 1, f"out-of-core composite: GPU vs CPU max diff {d.max()}")
    check(gr["total_points"] == 80_000 > gr["device_point_capacity"],
          f"out-of-core fixture: {gr}")
    say(f"small out-of-core: reports equal ({gr['bricks']} bricks, "
        f"{gr['total_points']} points over a {gr['device_point_capacity']}-"
        f"point pool), composite GPU-CPU max diff {d.max()}")


def write_tiles(tmp, xyz, rgba):
    """Phase 3's terrain split stably into 4 x-quadrant tiles, each written as
    .las into las/ and as .laz (the same records) into laz/; the LAZ tiles are
    encoded in parallel threads (the codec releases the GIL)."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor
    from simlod_tpu_torch.formats import las, laz
    x = xyz[:, 0]
    q = np.clip(((x - x.min()) / max(float(np.ptp(x)), 1e-9) * 4).astype(int),
                0, 3)
    order = np.argsort(q, kind="stable")
    bounds = np.searchsorted(q[order], np.arange(5))
    tiles = [order[bounds[i]:bounds[i + 1]] for i in range(4)]
    dirs = {k: os.path.join(tmp, k) for k in ("las", "laz")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    t0 = time.perf_counter()
    for i, t in enumerate(tiles):
        las.write(os.path.join(dirs["las"], f"tile_{i}.las"), xyz[t], rgba[t])
    t_las = time.perf_counter() - t0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as ex:
        list(ex.map(lambda it: laz.write(
            os.path.join(dirs["laz"], f"tile_{it[0]}.laz"), xyz[it[1]],
            rgba[it[1]]), enumerate(tiles)))
    t_laz = time.perf_counter() - t0
    size = lambda d: sum(os.path.getsize(os.path.join(d, f))
                         for f in os.listdir(d))
    say(f"tiles: {[len(t) for t in tiles]} points; LAS written in "
        f"{t_las:.2f} s ({size(dirs['las']) / 1e6:.0f} MB), LAZ in "
        f"{t_laz:.2f} s ({size(dirs['laz']) / 1e6:.0f} MB) on the host CPU")
    return dirs, [len(t) for t in tiles]


def median_ms(fn, reps: int = 5):
    """Wall ms of fn (which ends in a device sync): one warm-up, then the
    median and the list of `reps` calls."""
    import numpy as np
    out = fn()
    ms = []
    for _ in range(reps):
        t1 = time.perf_counter()
        out = fn()
        ms.append((time.perf_counter() - t1) * 1e3)
    return float(np.median(ms)), out


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


TREE = ("num_nodes", "num_points", "num_points_processed")


def drawn_mask(img, C):
    """Pixels that are not background."""
    rgb = img.cpu().numpy().view("uint32") & 0xFFFFFF
    return rgb != (C.BACKGROUND_COLOR & 0xFFFFFF)


def coverage(img, C) -> float:
    """Share of pixels that are not background."""
    return float(drawn_mask(img, C).mean())


def host_depth_min(planes, u, dev):
    """The depth-min composite of (colour, depth) planes ([H*W] each) computed
    on the host (ties to the lower plane), then one EDL pass on the card ->
    (image i32 [H*W] on the card, depth i32 [H*W] numpy)."""
    import numpy as np
    import torch
    from simlod_tpu_torch.render import raster
    hc = np.stack([c.cpu().numpy() for c, _ in planes])
    hd = np.stack([d.cpu().numpy() for _, d in planes])
    k = np.argmin(hd, axis=0)
    cols = np.arange(hd.shape[1])
    host_c, host_d = hc[k, cols], hd[k, cols]
    img = raster.edl(torch.from_numpy(host_c).to(dev),
                     torch.from_numpy(host_d).to(dev), u, W, H)
    return img, host_d


HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA's data sheet)


def bound_ms(nbytes: int) -> float:
    """Least time to move `nbytes` through device memory."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def kernel_vs_plain(packed, what: str, card: str):
    """The tile kernel and its plain version on one packed stream: bit-equal,
    then both timed with CUDA events; (max abs err, ms, plain ms)."""
    import torch
    from simlod_tpu_torch.render import raster_tiles
    kc, kd = raster_tiles.tile_resolve(*packed)
    rc, rd = raster_tiles.tile_resolve_reference(*packed)
    torch.cuda.synchronize()
    err = max(int((kc.long() - rc.long()).abs().max()),
              int((kd.long() - rd.long()).abs().max()))
    check(torch.equal(kc, rc) and torch.equal(kd, rd),
          f"tile kernel != plain version ({what}, max err {err})")
    ms = time_ms(lambda: raster_tiles.tile_resolve(*packed))
    plain_ms = time_ms(lambda: raster_tiles.tile_resolve_reference(*packed))
    S, n_tiles = packed[0].shape[0], packed[3]
    # the 12 B a sample the function needs (flags|pixel, depth bits, colour;
    # not the pad word of the kernel's 16-byte loads), the tile offsets and
    # the mode read once, each pixel's colour and depth written once
    bound = bound_ms(S * 12 + (n_tiles + 1) * 4 + 4 + n_tiles * 512 * 8)
    say(f"tile_resolve, {what}: {S} samples, {n_tiles} "
        f"tiles: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound:.4f} ms, bit-equal; card: {card}")
    return err, ms, plain_ms, bound


def route_pair(eng, img, key: str, tile_launches: dict, card: str,
               render=None, reps: int = 5):
    """Render the current frame of `eng` (an Engine or an OutOfCoreEngine)
    through both routes on the same state, timed the same way: the splat
    route (default) and the tile route (use_tile_raster=True: sort, prepass,
    tile kernel), one warm-up each, then `reps` rounds that alternate which
    route goes first. Every image must equal `img` bit for bit. Adds the tile
    kernel's launches to tile_launches[key]; returns the median wall ms of
    (splat route, tile route). `render` draws one frame (default: eng.render
    at W x H)."""
    import numpy as np
    import torch
    from simlod_tpu_torch.render import raster_tiles
    render = render or (lambda: eng.render(W, H))
    cfgs = {False: eng.cfg, True: dataclasses.replace(eng.cfg,
                                                      use_tile_raster=True)}
    ms = {False: [], True: []}
    raster_tiles.tile_resolve.launches = 0
    for i in range(reps + 1):
        for tile in ((False, True) if i % 2 else (True, False)):
            eng.cfg = cfgs[tile]
            t1 = time.perf_counter()
            out, _ = render()
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t1) * 1e3
            if i:
                ms[tile].append(dt)
            route = "tile" if tile else "splat"
            check(torch.equal(out, img), f"{key}: the {route} route's frame "
                  "differs from the splat route's first frame")
    eng.cfg = cfgs[False]
    n = raster_tiles.tile_resolve.launches
    tile_launches[key] = tile_launches.get(key, 0) + n
    check(n >= reps + 1,
          f"{key}: the tile route did not go through the tile kernel")
    med = float(np.median(ms[False])), float(np.median(ms[True]))
    say(f"{key}: frame median, routes interleaved: splat {med[0]:.2f} ms "
        f"({', '.join(f'{t:.2f}' for t in ms[False])}), tile {med[1]:.2f} ms "
        f"({', '.join(f'{t:.2f}' for t in ms[True])}); bit-equal; {n} tile "
        f"kernel launches; card: {card}")
    return med


def device_profile(render, what: str, card: str, reps: int = 3):
    """torch.profiler over `reps` frames after a warm-up: device busy time
    per frame (the union of kernel and copy intervals), the device's idle
    share of the profiled wall time, and kernels per frame. Profiled wall
    times are inflated by the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    render()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            render()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    if not spans:
        say(f"profile, {what}: torch.profiler recorded no device time (not "
            f"measured); card: {card}")
        return None
    say(f"profile, {what}: device busy {busy / reps / 1e3:.2f} ms per frame, "
        f"idle {1 - busy / wall_us:.1%} of {wall_us / reps / 1e3:.2f} ms "
        f"profiled wall per frame, {len(spans) / reps:.0f} device kernels and "
        f"copies per frame; card: {card}")
    return busy / reps / 1e3, 1 - busy / wall_us, len(spans) / reps


def splat_vs_plain(cfg, u, sets, what: str, card: str):
    """The splat_resolve kernel and its plain version on one frame's columns:
    bit-equal, both timed with CUDA events. Then the stage time of each route
    on the same sample sets: columns + splat kernel, and pack_samples (sort +
    prepass) + tile kernel.
    Returns (max abs err, ms, plain ms, bound ms, stage ms, tile stage ms)."""
    import torch
    from simlod_tpu_torch.render import raster, raster_tiles
    npx = W * H
    cols = raster.splat_columns(cfg, u, W, H, sets, npx)
    mode = u.use_high_quality_shading.to(torch.int32).reshape(1)
    with uncounted():
        return _splat_vs_plain(cfg, u, sets, what, card, cols, mode, npx)


def _splat_vs_plain(cfg, u, sets, what, card, cols, mode, npx):
    import torch
    from simlod_tpu_torch.render import raster, raster_tiles
    kc, kd = raster.splat_resolve(*cols, mode, npx)
    rc, rd = raster.splat_resolve_reference(*cols, mode, npx)
    torch.cuda.synchronize()
    err = max(int((kc.long() - rc.long()).abs().max()),
              int((kd.long() - rd.long()).abs().max()))
    check(torch.equal(kc, rc) and torch.equal(kd, rd),
          f"splat_resolve != plain version ({what}, max err {err})")
    ms = time_ms(lambda: raster.splat_resolve(*cols, mode, npx))
    dev_ms = kernel_device_ms(lambda: raster.splat_resolve(*cols, mode, npx),
                              "splat_")
    plain_ms = time_ms(lambda: raster.splat_resolve_reference(*cols, mode,
                                                              npx))
    stage = time_ms(lambda: raster.splat_resolve(
        *raster.splat_columns(cfg, u, W, H, sets, npx), mode, npx))
    tile_stage = time_ms(lambda: raster_tiles.tile_resolve(
        *raster_tiles.pack_samples(cfg, u, W, H, sets)))
    S = cols[0].shape[0]
    hqs = bool(mode.item())
    # the columns and the mode read once, each pixel's colour and depth
    # written once; `traffic` is what this design moves (its clear, the
    # second pass over the rows with HQS, the resolve's reads)
    bound = bound_ms(S * 12 + 4 + npx * 8)
    traffic = bound_ms((S * 24 + npx * 56) if hqs else (S * 12 + npx * 24))
    dev = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
    say(f"splat_resolve, {what}: {S} rows: kernel {ms:.4f} ms ({dev} on "
        f"the device); plain {plain_ms:.4f} ms; "
        f"bound {bound:.4f} ms (design traffic {traffic:.4f} ms); stage: "
        f"materialize + columns + splat {stage:.4f} ms vs pack_samples + tile "
        f"resolve {tile_stage:.4f} ms; bit-equal; card: {card}")
    return err, ms, plain_ms, bound, stage, tile_stage, dev_ms


def kernel_device_ms(fn, name: str, reps: int = 10):
    """Device ms per call of fn spent in the kernels whose name contains
    `name` (torch.profiler, after a warm-up): a kernel's own time, where
    CUDA events around back-to-back calls time its wrapper's host work when
    that is longer. None where the profiler recorded no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and name in e.name)
    return us / reps / 1e3 if us > 0 else None


def interleaved_ms(fns, reps: int = 10, rounds: int = 4) -> list:
    """CUDA-event ms per call of each of `fns`, timed in turns (ABBA...):
    the mean over `rounds` runs of time_ms(fn, reps)."""
    out = [0.0] * len(fns)
    for r in range(rounds):
        order = range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))
        for i in order:
            out[i] += time_ms(fns[i], reps) / rounds
    return out


class uncounted:
    """Keeps the launch counters of the splat kernels as they were: launches
    made to compare a kernel with its plain version are not the path's."""

    def __enter__(self):
        from simlod_tpu_torch.render import raster
        self.saved = [(f, f.launches) for f in (raster.splat_samples,
                                                raster.splat_resolve)]

    def __exit__(self, *exc):
        for f, n in self.saved:
            f.launches = n


def samples_vs_plain(cfg, u, sets, what: str, card: str):
    """The splat_samples kernel and its plain version (materialize +
    splat_columns + splat_resolve_reference) on one frame's sample sources:
    bit-equal, both timed with CUDA events after a warm-up. Then the stage
    of the two designs on the same sources, timed in turns: "materialize +
    columns + splat_resolve" (the previous frame path) against
    "splat_samples". ms is the kernel's device time (its four launches, by
    torch.profiler), call ms the CUDA-event time per call (wrapper
    included). Returns (max abs err, ms, plain ms, bound ms, previous stage
    ms, stage ms, drawn rows, call ms)."""
    import torch
    from simlod_tpu_torch.render import raster
    npx = W * H
    with uncounted():
        kc, kd = raster.splat_samples(cfg, u, W, H, sets)
        rc, rd = raster.splat_samples_reference(cfg, u, W, H, sets)
        torch.cuda.synchronize()
        err = max(int((kc.long() - rc.long()).abs().max()),
                  int((kd.long() - rd.long()).abs().max()))
        check(torch.equal(kc, rc) and torch.equal(kd, rd),
              f"splat_samples != plain version ({what}, max err {err})")
        call_ms = time_ms(lambda: raster.splat_samples(cfg, u, W, H, sets))
        ms = kernel_device_ms(lambda: raster.splat_samples(cfg, u, W, H, sets),
                              "splat_")
        plain_ms = time_ms(lambda: raster.splat_samples_reference(
            cfg, u, W, H, sets))
        mode = u.use_high_quality_shading.to(torch.int32).reshape(1)
        prev, stage = interleaved_ms([
            lambda: raster.splat_resolve(
                *raster.splat_columns(cfg, u, W, H, sets, npx), mode, npx),
            lambda: raster.splat_samples(cfg, u, W, H, sets)])
    # what the function must move: the 16 B of every drawn row, r_ok of every
    # plan block and the other 16 B of a block that holds rows, the colour
    # and depth of every pixel written once
    rows = sum(int(raster.materialize(s).valid.sum()) for s in sets)
    blocks = sum(s.plan.out_len // 128 for s in sets)
    full = sum(int(s.plan.r_ok.sum()) for s in sets)
    bound = bound_ms(16 * rows + blocks + 16 * full + 8 * npx)
    if ms is None:
        say(f"splat_samples, {what}: torch.profiler recorded no kernel time "
            f"(not measured); the CUDA-event time per call stands for it")
        ms = call_ms
    say(f"splat_samples, {what}: {len(sets)} sets, {rows} drawn rows in "
        f"{full} of {blocks} plan blocks: kernel {ms:.4f} ms on the device "
        f"({call_ms:.4f} ms per call by CUDA events, wrapper included); plain "
        f"{plain_ms:.4f} ms; bound {bound:.4f} ms; stage, timed in turns: "
        f"materialize + columns + splat_resolve {prev:.4f} ms vs "
        f"splat_samples {stage:.4f} ms; bit-equal; card: {card}")
    return err, ms, plain_ms, bound, prev, stage, rows, call_ms


N_SHARDS = 4
# the fixtures of tests/test_sharded_engine.py and test_sharded_outofcore.py;
# on 4 shards each slab puts ~10k points on every shard, so the out-of-core
# pools hold 16,384 points (there 8,192 on 8 shards): still 4 x 16,384 < 80k
SHARD_CFG = dict(
    candidate_factor=21, cand_multi_rows=1 << 13,
    node_capacity=1 << 12, point_capacity=1 << 16, voxel_capacity=1 << 18,
    segment_capacity=1 << 14, step_points=1 << 13, spill_capacity=1 << 13,
    max_splits_per_round=64, seg_select_cap=1 << 10, max_points_per_node=128,
    max_render_points=1 << 16, max_render_voxels=1 << 16)
SHARD_OOC_CFG = dict(SHARD_CFG, point_capacity=1 << 14,
                     segment_capacity=1 << 13, step_points=1 << 12,
                     spill_capacity=1 << 12, max_render_points=1 << 15)


def tree_view(state):
    """A state's tree by node identity (level, nx, ny, nz): leaf flag,
    counters, its points as a sorted multiset, its voxels by cell."""
    from simlod_tpu_torch.octree import inspect
    out = {}
    for key, v in inspect.node_table(state).items():
        pts = sorted(zip(*(v["points_xyz"][:, a].tolist() for a in range(3)),
                         v["points_rgba"].tolist()))
        out[key] = (v["is_leaf"], v["counter"], v["num_points"],
                    v["num_voxels"], pts, v["voxels"])
    return out


def phase_small_sharded(tmp, device):
    """Phase 14 (see the module docstring)."""
    t_phase = time.perf_counter()
    import numpy as np
    from simlod_tpu_torch.config import EngineConfig, Settings
    from simlod_tpu_torch.formats import simlod, synthetic
    from simlod_tpu_torch.parallel import shard
    from simlod_tpu_torch.parallel.engine import ShardedEngine
    from simlod_tpu_torch.parallel.outofcore import ShardedOutOfCoreEngine
    from simlod_tpu_torch.render.render import image_to_rgba8
    xyz, rgba = synthetic.terrain(30_000, seed=9, extent=1.0, z_scale=0.5)
    path = os.path.join(tmp, "sharded_small.simlod")
    simlod.write(path, xyz, rgba)
    rng = np.random.default_rng(21)
    slabs = []
    for i, (x0, col) in enumerate(zip((0.0, 4.0), (0xFF0000FF, 0xFF00FF00))):
        sxyz = rng.random((40_000, 3)).astype(np.float32)
        sxyz[:, 0] += x0
        slabs.append(os.path.join(tmp, f"slab_{i}.simlod"))
        simlod.write(slabs[-1], sxyz, np.full(40_000, col, np.uint32))

    def run(dev):
        mesh = shard.make_mesh([dev] * N_SHARDS)
        eng = ShardedEngine(EngineConfig(**SHARD_CFG), mesh=mesh, width=96,
                            height=64, settings=Settings(min_node_size=8.0,
                                                         enable_edl=False),
                            slot_factor=N_SHARDS)
        eng.open([path])
        eng.load_all()
        eng.stream.stop()
        plain = eng.render().cpu().numpy()
        eng.settings.enable_edl = True
        edl = image_to_rgba8(eng.render())[..., :3].astype(int)
        trees = [tree_view(st) for st in eng.state]
        ooc = ShardedOutOfCoreEngine(
            EngineConfig(**SHARD_OOC_CFG), mesh=mesh, width=160, height=64,
            settings=Settings(min_node_size=8.0, enable_edl=False),
            slot_factor=N_SHARDS)
        ooc.open(slabs)
        ooc.build_all()
        comp = ooc.render()[0].cpu().numpy()
        return eng.report(), trees, plain, edl, ooc.report(), comp

    g, c = run(device), run("cpu")
    check(g[0] == c[0], f"sharded report: GPU {g[0]} != CPU {c[0]}")
    check(g[0]["num_points"] == 30_000 and g[0]["num_points_dropped"] == 0,
          f"sharded small: {g[0]}")
    for s, (gt, ct) in enumerate(zip(g[1], c[1])):
        check(gt == ct, f"shard {s}: GPU and CPU trees differ")
    check(np.array_equal(g[2], c[2]), "sharded frame, EDL off: GPU != CPU")
    d = np.abs(g[3] - c[3]).max()
    check(d <= 1, f"sharded frame, EDL on: GPU vs CPU max diff {d}")
    check(g[4] == c[4], f"sharded out-of-core report: GPU {g[4]} != CPU {c[4]}")
    check(g[4]["total_points"] == 80_000
          > N_SHARDS * g[4]["per_chip_point_capacity"],
          f"sharded out-of-core fixture: {g[4]}")
    check(np.array_equal(g[5], c[5]),
          "sharded out-of-core composite: GPU != CPU")
    say(f"small sharded ({N_SHARDS} shards): report equal {g[0]}, trees "
        f"equal per shard ({[len(t) for t in g[1]]} nodes), frame bit-equal "
        f"with EDL off, max diff {d} with EDL on; out-of-core slabs: report "
        f"equal, composite bit-equal; phase "
        f"{time.perf_counter() - t_phase:.1f} s")


def shard_shares(xyz, cube: float, n: int) -> list:
    """Points of xyz (rebased into the octree cube) each of n shards owns:
    the port's _brick_owner on the host."""
    import numpy as np
    import torch
    from simlod_tpu_torch.ops import morton
    from simlod_tpu_torch.parallel import shard
    t = torch.from_numpy(np.ascontiguousarray(xyz))
    q = morton.quantize_cols(t[:, 0], t[:, 1], t[:, 2], torch.zeros(3),
                             torch.tensor(float(cube)))
    own = shard._brick_owner(*q, shard.brick_level_for(n), n)
    return torch.bincount(own.long(), minlength=n).tolist()


def phase_sharded_bulk(path, n, cov3, dev, card, launches, srows, xrows):
    """Phase 15 (see the module docstring)."""
    t_phase = time.perf_counter()
    import numpy as np
    import torch
    from simlod_tpu_torch import constants as C
    from simlod_tpu_torch.config import EngineConfig, Settings
    from simlod_tpu_torch.formats import simlod
    from simlod_tpu_torch.parallel import shard
    from simlod_tpu_torch.parallel.engine import ShardedEngine
    from simlod_tpu_torch.render import raster
    from simlod_tpu_torch.render.render import frame_samples
    info = simlod.load_info(path)
    xyz, _ = simlod.read_points(path)
    shares = shard_shares(xyz, float((info.box_max - info.box_min).max()),
                          N_SHARDS)
    del xyz
    mesh = shard.make_mesh([dev] * N_SHARDS)
    free = torch.cuda.mem_get_info(dev)[0]
    cfg = EngineConfig.auto(total_points=max(shares),
                            memory_bytes=free // N_SHARDS)
    torch.cuda.reset_peak_memory_stats()
    raster.splat_samples.launches = 0
    eng = ShardedEngine(cfg, mesh=mesh, width=W, height=H,
                        settings=Settings(), slot_factor=N_SHARDS)
    eng.open([path])
    t0 = time.perf_counter()
    eng.load_all()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    load_syncs = eng.host_syncs
    rep = eng.report()

    def frame():
        img = eng.render()
        torch.cuda.synchronize()
        return img
    t1 = time.perf_counter()
    frame()
    first_ms = (time.perf_counter() - t1) * 1e3
    med_ms, img = median_ms(frame)
    launches["sharded"] = raster.splat_samples.launches
    peak = torch.cuda.max_memory_allocated()
    per_shard = [[int(v) for v in (
        torch.where(st.child_base < 0, st.num_points, 0).sum(),
        st.num_nodes, st.vox_used)] for st in eng.state]
    check(rep["num_points"] + rep["num_points_dropped"] == n
          and rep["num_points_dropped"] == 0,
          f"sharded: points {rep['num_points']} + dropped "
          f"{rep['num_points_dropped']} != {n} (or some dropped)")
    check(not rep["mem_capacity_reached"], "sharded: mem_capacity_reached")
    cover = coverage(img, C)
    check(cover > 0.05, f"sharded: only {cover:.3%} of pixels drawn")
    check(launches["sharded"] >= 6 * N_SHARDS,
          f"sharded: {launches['sharded']} kernel launches for 6 frames of "
          f"{N_SHARDS} shards")
    # the check: each shard's plane drawn alone, composited on the host
    u = eng.uniforms()
    planes = []
    for st in eng.state:
        _, sets, _ = frame_samples(cfg, st, u)
        planes.append(raster.rasterize(cfg, u, W, H, sets))
    host_img, host_d = host_depth_min(planes, u, dev)
    check(np.array_equal(eng.last_depth.cpu().numpy().reshape(-1), host_d)
          and torch.equal(img.reshape(-1), host_img),
          "sharded composite != host depth-min composite of the shard planes")
    cov = drawn_mask(img, C)
    iou = float((cov & cov3).sum() / max((cov | cov3).sum(), 1))
    check(iou > 0.8, f"sharded silhouette IoU {iou:.3f} vs phase 3's frame")
    say(f"sharded bulk ({N_SHARDS} shards on one card, slot_factor "
        f"{N_SHARDS}, point pool {cfg.point_capacity} per shard for shares "
        f"{shares}): load_all {load_s:.2f} s = {n / load_s / 1e6:.2f} MP/s; "
        f"per shard [points, nodes, voxels] {per_shard}; exchange rows "
        f"dropped {rep['num_points_dropped']}; host syncs {load_syncs}; "
        f"peak device memory {peak / 2**30:.2f} GiB; composited 1920x1080 "
        f"frame first {first_ms:.2f} ms, then median {med_ms:.2f} ms; "
        f"{cover:.1%} of pixels drawn, silhouette IoU {iou:.3f} vs the "
        f"single engine's frame; composite equals the host depth-min of the "
        f"shard planes; splat_samples launches {launches['sharded']}; card: "
        f"{card}")
    for hqs in (True, False):
        eng.settings.use_high_quality_shading = hqs
        u = eng.uniforms()
        _, sets, _ = frame_samples(cfg, eng.state[0], u)
        srows[("sharded shard 0", hqs)] = splat_vs_plain(
            cfg, u, sets, f"sharded shard 0's frame, hqs={hqs}", card)
        xrows[("sharded shard 0", hqs)] = samples_vs_plain(
            cfg, u, sets, f"sharded shard 0's frame, hqs={hqs}", card)
    eng.stream.stop()
    say(f"phase 15: {time.perf_counter() - t_phase:.1f} s")


def phase_sharded_ooc(las_dir, n, dev, card, launches):
    """Phase 16 (see the module docstring)."""
    t_phase = time.perf_counter()
    import numpy as np
    import torch
    from simlod_tpu_torch import constants as C
    from simlod_tpu_torch.config import EngineConfig, Settings
    from simlod_tpu_torch.formats import las
    from simlod_tpu_torch.io.streaming import scan_paths
    from simlod_tpu_torch.parallel import shard
    from simlod_tpu_torch.parallel.outofcore import ShardedOutOfCoreEngine
    from simlod_tpu_torch.render import raster
    entries = scan_paths([las_dir])
    gmin = np.min([e.box_min for e in entries], axis=0)
    cube = float((np.max([e.box_max for e in entries], axis=0) - gmin).max())
    shares = [shard_shares(las.read_points(e.path, translation=-gmin)[0],
                           cube, N_SHARDS) for e in entries]
    mesh = shard.make_mesh([dev] * N_SHARDS)
    free = torch.cuda.mem_get_info(dev)[0]
    cfg = EngineConfig.auto(total_points=max(max(s) for s in shares),
                            memory_bytes=free // N_SHARDS)
    check(N_SHARDS * cfg.point_capacity < n,
          f"sharded out-of-core: {N_SHARDS} x {cfg.point_capacity} points "
          f"hold the whole {n}")
    raster.splat_samples.launches = 0
    ooc = ShardedOutOfCoreEngine(cfg, mesh=mesh, width=W, height=H,
                                 settings=Settings(), slot_factor=N_SHARDS)
    ooc.open([las_dir])
    brick_s = []
    for p in ooc.brick_paths:
        t0 = time.perf_counter()
        ooc.build_brick(p)
        torch.cuda.synchronize()
        brick_s.append(time.perf_counter() - t0)
    rep = ooc.report()

    def frame():
        out = ooc.render()
        torch.cuda.synchronize()
        return out
    med_ms, (img, depth) = median_ms(frame)
    launches["sharded_ooc"] = raster.splat_samples.launches
    check(rep["total_points"] == n,
          f"sharded out-of-core: {rep['total_points']} points of {n}")
    check(launches["sharded_ooc"] >= 6 * len(brick_s) * N_SHARDS,
          f"sharded out-of-core: {launches['sharded_ooc']} kernel launches")
    planes, u = ooc.render_planes()
    host_img, host_d = host_depth_min(planes, u, dev)
    check(np.array_equal(depth.cpu().numpy().reshape(-1), host_d)
          and torch.equal(img.reshape(-1), host_img),
          "sharded out-of-core composite != host depth-min of the brick "
          "planes")
    cover = coverage(img, C)
    check(cover > 0, "sharded out-of-core: nothing drawn")
    say(f"sharded out-of-core ({N_SHARDS} shards on one card): bricks built "
        f"in {', '.join(f'{t:.2f}' for t in brick_s)} s; total_points "
        f"{rep['total_points']} == {n} over pools of {cfg.point_capacity} "
        f"points per shard (shares per tile {shares}); {rep['total_voxels']} "
        f"voxels, {rep['total_nodes']} nodes, host bytes {rep['host_bytes']}; "
        f"composited 1920x1080 frame median {med_ms:.2f} ms, {cover:.1%} of "
        f"pixels drawn, equal to the host depth-min of the brick planes; "
        f"splat_samples launches {launches['sharded_ooc']}; phase "
        f"{time.perf_counter() - t_phase:.1f} s; card: {card}")


# host reads of a tensor's value: each one waits for the device
READS = ("__bool__", "item", "tolist", "__int__", "__float__", "__index__")


class ReadCounter:
    """Counts every host read of a tensor value (READS) while installed on
    torch.Tensor."""

    def __enter__(self):
        import torch
        self.n = 0
        self._saved = {name: vars(torch.Tensor).get(name) for name in READS}
        for name in READS:
            def counted(t, *a, _orig=getattr(torch.Tensor, name), **k):
                self.n += 1
                return _orig(t, *a, **k)
            setattr(torch.Tensor, name, counted)
        return self

    def __exit__(self, *exc):
        import torch
        for name, orig in self._saved.items():
            if orig is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, orig)


def counted_syncs(eng, frame, what: str) -> int:
    """Run frame(); its tensor reads must equal the engine's host_syncs
    delta. Returns that delta."""
    before = eng.host_syncs
    with ReadCounter() as rc:
        frame()
    d = eng.host_syncs - before
    check(rc.n == d > 0, f"{what}: {rc.n} tensor reads, host_syncs counted {d}")
    return d


def run_app(argv):
    """simlod_tpu_torch.app.main(argv) in this process -> (rc, stdout)."""
    import contextlib
    import io
    from simlod_tpu_torch import app
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = app.main(argv)
    return rc, out.getvalue()


def png_size(png: bytes):
    check(png[:8] == b"\x89PNG\r\n\x1a\n" and png[12:16] == b"IHDR",
          "not a PNG")
    return int.from_bytes(png[16:20], "big"), int.from_bytes(png[20:24], "big")


def decode_png(png: bytes):
    """An 8-bit RGB, filter-0 PNG (viewer.encode_png's) -> [H, W, 3] uint8."""
    import zlib
    import numpy as np
    w, h = png_size(png)
    i, idat = 8, b""
    while i < len(png):
        n = int.from_bytes(png[i:i + 4], "big")
        if png[i + 4:i + 8] == b"IDAT":
            idat += png[i + 8:i + 8 + n]
        i += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    check((rows[:, 0] == 0).all(), "PNG rows not filter 0")
    return rows[:, 1:].reshape(h, w, 3)


def rgb_coverage(rgb, C) -> float:
    """Share of pixels of an [H, W, 3] image that are not background."""
    import numpy as np
    bg = np.array([(C.BACKGROUND_COLOR >> (8 * k)) & 0xFF for k in range(3)],
                  np.uint8)
    return float((rgb != bg).any(-1).mean())


def http_get(base: str, path: str, timeout: float = 600):
    """(body, wall ms) of GET base+path; a status other than 200 raises."""
    import urllib.request
    t0 = time.perf_counter()
    with urllib.request.urlopen(base + path, timeout=timeout) as r:
        body = r.read()
        check(r.status == 200, f"GET {path}: status {r.status}")
    return body, (time.perf_counter() - t0) * 1e3


def phase_app_viewer(tmp, path, las_dir, n, dev, card, launches):
    """Phase 17 (see the module docstring)."""
    t_phase = time.perf_counter()
    import shutil
    import threading
    import numpy as np
    import torch
    from simlod_tpu_torch import constants as C
    from simlod_tpu_torch.engine import Engine
    from simlod_tpu_torch.render import raster
    from simlod_tpu_torch.render.render import image_to_rgba8
    from simlod_tpu_torch.viewer import ViewerServer, encode_png
    splat = raster.splat_samples
    report = lambda stdout: json.loads(stdout.strip().splitlines()[-1])
    kept = lambda r: r["num_points"] + r["num_points_dropped"]

    # the app in process: 30 orbit frames while phase 3's file streams
    out = os.path.join(tmp, "app_frames")
    splat.launches = 0
    rc, stdout = run_app([path, "--frames", "30", "--width", str(W),
                          "--height", str(H), "--out", out, "--json"])
    launches["app"] = splat.launches
    rep = report(stdout)
    files = sorted(os.listdir(out))
    check(rc == 0, f"app: exit code {rc}")
    check(kept(rep) == n, f"app: points {rep['num_points']} + dropped "
          f"{rep['num_points_dropped']} != {n}")
    check(not rep["mem_capacity_reached"], "app: mem_capacity_reached")
    check(len(files) == rep["frames"] >= 30,
          f"app: {len(files)} frames written, report says {rep['frames']}")
    cover = rgb_coverage(read_ppm(os.path.join(out, files[-1])), C)
    check(cover > 0.05, f"app: only {cover:.3%} of the last frame drawn")
    check(launches["app"] >= rep["frames"],
          f"app: {launches['app']} splat_samples launches for {rep['frames']} frames")
    shutil.rmtree(out)
    say(f"app in process (phase 3's file, --frames 30, 1920x1080, PPM, "
        f"--json): {rep['frames']} frames in {rep['wall_seconds']:.2f} s wall "
        f"= {rep['ingest_mps']:.2f} MP/s (load and frames); steps "
        f"{rep['steps']}; host syncs {rep['host_syncs']} = "
        f"{rep['host_syncs'] / rep['frames']:.1f}/frame; fused frames "
        f"{rep['timings']['fused']['count']} avg "
        f"{rep['timings']['fused']['avg_ms']:.2f} ms, render-only "
        f"{rep['timings']['render']['count']} avg "
        f"{rep['timings']['render']['avg_ms']:.2f} ms; {cover:.1%} of the last "
        f"frame drawn; splat_samples launches {launches['app']}; card: {card}")

    # the app on the LAS tiles: filter, boxes, PNG frames, the timing table
    out = os.path.join(tmp, "app_png")
    splat.launches = 0
    rc, stdout = run_app([las_dir, "--frames", "8", "--width", str(W),
                          "--height", str(H), "--benchmark", "--filter-colors",
                          "--show-boxes", "--png", "--out", out])
    launches["app"] += splat.launches
    lines = stdout.splitlines()
    rows = {ln.split()[0]: ln.strip() for ln in lines if ln.startswith("  ")}
    check(rc == 0 and lines[0].startswith(f"loaded {n:,} points in "),
          f"app --benchmark: rc {rc}, first line {lines[:1]}")
    check({"fused", "render"} <= set(rows),
          f"app --benchmark: timing rows {sorted(rows)}")
    pngs = sorted(os.listdir(out))
    check(len(pngs) >= 8 and all(p.endswith(".png") for p in pngs),
          f"app --png: {pngs}")
    for p in pngs:
        with open(os.path.join(out, p), "rb") as f:
            png = f.read()
        check(png_size(png) == (W, H), f"{p}: {png_size(png)}")
    last = decode_png(png)
    check(last.shape == (H, W, 3) and rgb_coverage(last, C) > 0.05,
          f"app --png: last frame {last.shape}, "
          f"{rgb_coverage(last, C):.3%} drawn")
    shutil.rmtree(out)
    say(f"app in process (LAS tiles, --frames 8 --benchmark --filter-colors "
        f"--show-boxes --png): {lines[0]}; {len(pngs)} PNGs of 1920x1080, the "
        f"last decoded ({rgb_coverage(last, C):.1%} drawn); table: "
        f"{' | '.join(rows.values())}; card: {card}")

    # the app as a user starts it: a subprocess, on the card by default
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "simlod_tpu_torch.app", path,
                          "--json"], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    sub_s = time.perf_counter() - t0
    check(res.returncode == 0, f"python -m simlod_tpu_torch.app: rc "
          f"{res.returncode}\n{res.stderr[-3000:]}")
    srep = report(res.stdout)
    check(kept(srep) == n and not srep["mem_capacity_reached"],
          f"python -m simlod_tpu_torch.app: {srep['num_points']} points")
    say(f"python -m simlod_tpu_torch.app <file> --json (subprocess, no "
        f"--device): rc 0, {srep['num_points_processed']} points, command "
        f"{sub_s:.2f} s, its own wall {srep['wall_seconds']:.2f} s = "
        f"{srep['ingest_mps']:.2f} MP/s; card: {card}")

    # the viewer, serving a fresh engine while it streams phase 3's file
    splat.launches = 0
    eng = Engine(device=dev)
    eng.open([path])
    v = ViewerServer(eng, W, H, port=0)
    base = f"http://127.0.0.1:{v.bind()}"
    threading.Thread(target=v.serve_forever, daemon=True).start()
    try:
        page, _ = http_get(base, "/")
        check(b"canvas" in page, "viewer: / is not the page")
        o = eng.orbit
        yaw0, pitch, radius = o.yaw, o.pitch, o.radius
        frames = []
        for i in range(20):
            png, ms = http_get(base, f"/frame?yaw={yaw0 + 0.05 * i}"
                               f"&pitch={pitch}&radius={radius}")
            check(png_size(png) == (W, H), f"viewer frame {i}: "
                  f"{png_size(png)}")
            st = json.loads(http_get(base, "/stats")[0])
            frames.append((ms, st["render_ms"], st["streaming"]))
        check(frames[0][2] and not frames[-1][2],
              f"viewer: streaming {[f[2] for f in frames]}")
        check(kept(st) == n, f"viewer: {st['num_points']} points")
        bench, bench_ms = http_get(base, "/bench?frames=20")
        bench = json.loads(bench)
        check(bench["frames"] == 20, f"viewer /bench: {bench['frames']}")
        reset, reset_ms = http_get(base, "/bench?frames=5&reset=1")
        reset = json.loads(reset)
        rep = eng.report()
        check(eng._last_paths == [path] and eng.last_batch_finished
              and kept(rep) == n and rep["num_points_processed"] == n,
              f"viewer reset: {rep['num_points']} points")
        check(reset["frames"] >= 5, f"viewer reset: {reset['frames']} frames")
        launches["viewer"] = splat.launches
        check(launches["viewer"] >= 40 + reset["frames"],
              f"viewer: {launches['viewer']} splat_samples launches")
        img, _ = eng.render(W, H)
        rgb = np.ascontiguousarray(image_to_rgba8(img)[::-1, :, :3])
        enc = []
        for _ in range(3):
            t0 = time.perf_counter()
            png = encode_png(rgb)
            enc.append((time.perf_counter() - t0) * 1e3)
    finally:
        v.shutdown()
    post = [f for f in frames if not f[2]]
    med = lambda xs: float(np.median(xs))
    say(f"viewer (fresh Engine streaming phase 3's file, 1920x1080): "
        f"{sum(f[2] for f in frames)} of 20 /frame requests while streaming "
        f"(request ms {', '.join(f'{f[0]:.1f}' for f in frames if f[2])}; "
        f"render_ms {', '.join(f'{f[1]:.1f}' for f in frames if f[2])}); "
        f"post-load /frame request median {med([f[0] for f in post]):.2f} ms "
        f"vs render_ms median {med([f[1] for f in post]):.2f} ms vs "
        f"encode_png alone {med(enc):.2f} ms ({len(png) / 1e6:.2f} MB PNG); "
        f"/bench?frames=20 {bench_ms:.1f} ms (frame avg "
        f"{bench['timings']['frame']['avg_ms']:.2f} ms); "
        f"/bench?frames=5&reset=1 {reset_ms:.1f} ms = {n / reset_ms / 1e3:.2f}"
        f" MP/s over {reset['frames']} frames, {rep['num_points']} points "
        f"again; splat_samples launches {launches['viewer']}; card: {card}")

    # every tensor read of a frame is a counted host sync
    eng.settings.point_budget = 0.0
    eng.render(W, H)
    exact = counted_syncs(eng, lambda: eng.render(W, H), "exact 1080p frame")
    eng.settings.point_budget = 1.0
    eng.render(W, H)         # builds the draw pool
    pooled = counted_syncs(eng, lambda: eng.render(W, H), "pooled 1080p frame")
    eng.settings.frame_budget_ms = 50.0
    eng.open([path], chunk_steps=1)        # phase 6's loop
    streamed = [counted_syncs(eng, lambda: eng.frame(W, H),
                              f"streamed frame {i}") for i in range(3)]
    eng.stream.stop()
    say(f"host syncs per 1080p frame, every tensor read counted (__bool__, "
        f"item, tolist, __int__, __float__, __index__) and equal to host_syncs:"
        f" exact {exact}, pooled {pooled}, streamed pooled {streamed}; "
        f"phase 17 {time.perf_counter() - t_phase:.1f} s; card: {card}")
    del eng, img
    gc.collect()
    torch.cuda.empty_cache()


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
    from simlod_tpu_torch.render import raster, raster_tiles
    from simlod_tpu_torch.render.render import (frame_samples,
                                                pooled_frame_samples)
    splat, tile = raster.splat_samples, raster_tiles.tile_resolve
    resolve = raster.splat_resolve

    dev = torch.device("cuda")
    # --- phase 1: card and build ---
    card = card_line()
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device {torch.cuda.get_device_name(0)}")
    lib = kernels.build()
    say(f"kernel build, one nvcc per source in parallel, then one link: "
        f"{kernels.build_seconds:.2f} s ({lib.name})")

    with tempfile.TemporaryDirectory() as tmp:
        # --- phase 2: small reference ---
        phase_small_reference(tmp, dev)
        phase_small_modes(tmp, dev)

        # --- phase 3: bulk path ---
        n = args.points
        t0 = time.perf_counter()
        xyz, rgba = synthetic.terrain(n, seed=0)
        path = os.path.join(tmp, "terrain.simlod")
        simlod.write(path, xyz, rgba)     # xyz, rgba stay for phase 10
        say(f"terrain {n} points written in {time.perf_counter() - t0:.1f} s "
            f"({os.path.getsize(path) / 1e6:.0f} MB)")

        launches, tile_launches = {}, {}
        splat.launches = tile.launches = resolve.launches = 0
        eng = Engine(cfg=None, settings=Settings(), device=dev)
        eng.open([path])
        t0 = time.perf_counter()
        eng.load_all()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        load_syncs = eng.host_syncs
        img, stats = eng.render(W, H)
        first_ms = eng.t_render.max * 1e3
        frame_ms = []
        for _ in range(5):
            t1 = time.perf_counter()
            img, stats = eng.render(W, H)
            frame_ms.append((time.perf_counter() - t1) * 1e3)
        launches["bulk_exact"] = splat.launches
        check(tile.launches == resolve.launches == 0,
              "the default route launched the tile kernel or splat_resolve")
        rep = eng.report()
        bulk_tree = {k: rep[k] for k in TREE}

        check(rep["num_points"] + rep["num_points_dropped"] == n,
              f"points {rep['num_points']} + dropped "
              f"{rep['num_points_dropped']} != {n}")
        check(not rep["mem_capacity_reached"], "mem_capacity_reached")
        check(stats.num_visible_points + stats.num_visible_voxels > 0,
              "nothing visible")
        check(tuple(img.shape) == (H, W), f"image shape {tuple(img.shape)}")
        cover = coverage(img, C)
        cov3 = drawn_mask(img, C)     # phase 15's silhouette reference
        check(cover > 0.05, f"only {cover:.3%} of pixels drawn")
        check(launches["bulk_exact"] > 0,
              "the frame did not go through the splat_samples kernel")
        per_step = load_syncs / max(rep["steps"], 1)
        say(f"load_all: {load_s:.2f} s = {n / load_s / 1e6:.2f} MP/s; "
            f"nodes {rep['num_nodes']}, voxels {rep['num_voxels']}, "
            f"candidates_dropped {rep['num_candidates_dropped']}, "
            f"host syncs {load_syncs} over {rep['steps']} steps "
            f"({per_step:.2f}/step); card: {card}")
        say(f"render 1920x1080: first {first_ms:.2f} ms, then median "
            f"{float(np.median(frame_ms)):.2f} ms ({', '.join(f'{t:.2f}' for t in frame_ms)}); "
            f"visible points {stats.num_visible_points}, voxels "
            f"{stats.num_visible_voxels}; truncated {stats.render_truncated}; "
            f"{cover:.1%} of pixels drawn; splat_samples launches "
            f"{launches['bulk_exact']}; card: {card}")
        route_ms = {"exact 36M": route_pair(eng, img, "bulk_exact",
                                            tile_launches, card)}
        device_profile(lambda: eng.render(W, H),
                       "exact 1080p frame, splat route", card)
        eng.cfg = dataclasses.replace(eng.cfg, use_tile_raster=True)
        device_profile(lambda: eng.render(W, H),
                       "exact 1080p frame, tile route", card)
        eng.cfg = dataclasses.replace(eng.cfg, use_tile_raster=False)

        # --- phase 4: kernels against plain versions on this frame ---
        rows, srows, xrows = {}, {}, {}
        for hqs in (True, False):
            eng.settings.use_high_quality_shading = hqs
            u = eng.uniforms(W, H)
            _, sets, _ = frame_samples(eng.cfg, eng.state, u, *eng.last_windows)
            rows[("exact", hqs)] = kernel_vs_plain(
                raster_tiles.pack_samples(eng.cfg, u, W, H, sets),
                f"exact frame, hqs={hqs}", card)
            srows[("exact", hqs)] = splat_vs_plain(
                eng.cfg, u, sets, f"exact frame, hqs={hqs}", card)
            xrows[("exact", hqs)] = samples_vs_plain(
                eng.cfg, u, sets, f"exact frame, hqs={hqs}", card)
        eng.settings.use_high_quality_shading = True
        eng.stream.stop()
        del eng, img, stats
        gc.collect()
        torch.cuda.empty_cache()

        # --- phase 5: small streamed reference ---
        phase_small_stream(tmp, dev)

        # --- phase 6: streamed main path (simultaneous loop, pooled) ---
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        splat.launches = 0
        eng = Engine(cfg=None, settings=Settings(point_budget=1.0,
                                                 frame_budget_ms=50.0),
                     device=dev)
        t0 = time.perf_counter()
        eng.open([path], chunk_steps=1)
        yaw0 = eng.orbit.yaw     # the auto-focus view of phase 3
        frame_ms = []
        while not eng.last_batch_finished:
            eng.orbit.yaw += 0.03   # orbiting the scan while it loads
            eng.camera.world = eng.orbit.world()
            t1 = time.perf_counter()
            img, stats = eng.frame(W, H)
            frame_ms.append((time.perf_counter() - t1) * 1e3)
        loop_s = time.perf_counter() - t0
        launches["streamed_pooled"] = splat.launches
        peak = torch.cuda.max_memory_allocated()
        rep = eng.report()
        frames = len(frame_ms)
        cover = coverage(img, C)
        check(eng.last_batch_finished and eng._splits_finished,
              "the stream did not drain")
        check(rep["num_points"] + rep["num_points_dropped"] == n,
              f"streamed: points {rep['num_points']} + dropped "
              f"{rep['num_points_dropped']} != {n}")
        check(not rep["mem_capacity_reached"], "streamed: mem_capacity_reached")
        tree = {k: rep[k] for k in TREE}
        check(tree == bulk_tree, f"streamed tree {tree} != bulk {bulk_tree}")
        check(cover > 0.05, f"streamed: only {cover:.3%} of pixels drawn")
        check(launches["streamed_pooled"] >= frames,
              f"{launches['streamed_pooled']} kernel launches for {frames} frames")
        pool = rep["timings"]["pool"]
        say(f"streamed loop (point_budget 1.0, frame_budget_ms 50, 1920x1080): "
            f"{frames} frames in {loop_s:.2f} s = {n / loop_s / 1e6:.2f} MP/s "
            f"concurrent; frame ms median {float(np.median(frame_ms)):.2f}, "
            f"max {max(frame_ms):.2f}; pool rebuilds {pool['count']} taking "
            f"{pool['count'] * pool['avg_ms'] / 1e3:.3f} s; host syncs "
            f"{rep['host_syncs']} = {rep['host_syncs'] / frames:.1f}/frame; "
            f"splat_samples launches {launches['streamed_pooled']}; peak device "
            f"memory {peak / 2**30:.2f} GiB; last frame truncated "
            f"{stats.render_truncated}, {cover:.1%} of pixels drawn; tree "
            f"{tree} equals the bulk load's; card: {card}")
        say("frame ms: " + ", ".join(f"{t:.1f}" for t in frame_ms))

        # --- phase 7: post-load pooled vs exact frame, same camera ---
        # at phase 3's auto-focus view, then at the loop's last view
        launches["post_load_pooled"] = launches["post_load_exact"] = 0
        for view, yaw in (("auto-focus", yaw0), ("orbit end", eng.orbit.yaw)):
            eng.orbit.yaw = yaw
            eng.camera.world = eng.orbit.world()
            post = {}
            for budget in (1.0, 0.0):
                eng.settings.point_budget = budget
                key = "post_load_pooled" if budget else "post_load_exact"
                splat.launches = 0
                eng.render(W, H)     # builds the pool / sizes the windows
                ms = []
                for _ in range(5):
                    t1 = time.perf_counter()
                    img, stats = eng.render(W, H)
                    ms.append((time.perf_counter() - t1) * 1e3)
                launches[key] += splat.launches
                check(splat.launches >= 6, f"{key}: not through the splat_samples kernel")
                check(coverage(img, C) > 0.05, f"{key}: too few pixels drawn")
                post[budget] = (float(np.median(ms)), stats.render_truncated,
                                stats.num_visible_points,
                                stats.num_visible_voxels)
                route_ms[f"{key[10:]} {view}"] = route_pair(
                    eng, img, key, tile_launches, card)
                if view == "auto-focus":
                    device_profile(lambda: eng.render(W, H),
                                   f"post-load {key[10:]} 1080p frame", card)
            say(f"post-load 1920x1080, {view} view: pooled (point_budget 1.0) "
                f"median {post[1.0][0]:.2f} ms, truncated {post[1.0][1]}, "
                f"windows {eng.last_pooled_windows[:4]}; exact median "
                f"{post[0.0][0]:.2f} ms, truncated {post[0.0][1]}, windows "
                f"{eng.last_windows[:2]} (visible points {post[0.0][2]}, "
                f"voxels {post[0.0][3]}); card: {card}")

        # --- phase 8: kernel against plain version on the pooled stream ---
        eng.settings.point_budget = 1.0
        eng.render(W, H)
        for hqs in (True, False):
            eng.settings.use_high_quality_shading = hqs
            u = eng.uniforms(W, H)
            _, sets, _ = pooled_frame_samples(eng.cfg, eng.state,
                                              eng._draw_pool, u,
                                              *eng.last_pooled_windows)
            check(len(sets) == 4, "the pooled frame has four sample sets")
            rows[("pooled", hqs)] = kernel_vs_plain(
                raster_tiles.pack_samples(eng.cfg, u, W, H, sets),
                f"pooled frame, hqs={hqs}", card)
            srows[("pooled", hqs)] = splat_vs_plain(
                eng.cfg, u, sets, f"pooled frame, hqs={hqs}", card)
            xrows[("pooled", hqs)] = samples_vs_plain(
                eng.cfg, u, sets, f"pooled frame, hqs={hqs}", card)
        eng.stream.stop()
        del eng
        gc.collect()
        torch.cuda.empty_cache()

        # --- phase 9: small references of the new modules, GPU vs CPU ---
        phase_small_new(tmp, dev)

        # --- phase 10: LAS bulk path ---
        dirs, tile_sizes = write_tiles(tmp, xyz, rgba)
        del xyz, rgba
        splat.launches = 0
        eng10 = Engine(cfg=None, settings=Settings(), device=dev)
        eng10.open([dirs["las"]])
        t0 = time.perf_counter()
        eng10.load_all()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        load_syncs = eng10.host_syncs
        rep = eng10.report()
        las_ms, (img, stats) = median_ms(lambda: eng10.render(W, H))
        launches["las_bulk"] = splat.launches
        las_tree = {k: rep[k] for k in TREE}
        cover = coverage(img, C)
        check(rep["num_points"] + rep["num_points_dropped"] == n,
              f"LAS: points {rep['num_points']} + dropped "
              f"{rep['num_points_dropped']} != {n}")
        check(not rep["mem_capacity_reached"], "LAS: mem_capacity_reached")
        check(cover > 0.05, f"LAS: only {cover:.3%} of pixels drawn")
        check(launches["las_bulk"] > 0, "LAS frames not through the splat_samples kernel")
        route_ms["LAS exact"] = route_pair(eng10, img, "las_bulk",
                                           tile_launches, card)
        say(f"LAS bulk load of {len(tile_sizes)} tiles: {load_s:.2f} s = "
            f"{n / load_s / 1e6:.2f} MP/s; stream t_decode "
            f"{rep['stream']['t_decode']} s (summed over loader threads); host "
            f"syncs {load_syncs}; tree {las_tree}; 1920x1080 exact frame median "
            f"{las_ms:.2f} ms, truncated {stats.render_truncated}, {cover:.1%} "
            f"of pixels drawn; splat_samples launches {launches['las_bulk']}; "
            f"card: {card}")
        for hqs in (True, False):
            eng10.settings.use_high_quality_shading = hqs
            u = eng10.uniforms(W, H)
            _, sets, _ = frame_samples(eng10.cfg, eng10.state, u,
                                       *eng10.last_windows)
            if hqs:
                rows[("las", True)] = kernel_vs_plain(
                    raster_tiles.pack_samples(eng10.cfg, u, W, H, sets),
                    "LAS exact frame, hqs=True", card)
            srows[("las", hqs)] = splat_vs_plain(
                eng10.cfg, u, sets, f"LAS exact frame, hqs={hqs}", card)
            xrows[("las", hqs)] = samples_vs_plain(
                eng10.cfg, u, sets, f"LAS exact frame, hqs={hqs}", card)
        eng10.settings.use_high_quality_shading = True

        # --- phase 11: LAZ streamed path (simultaneous loop, pooled) ---
        from simlod_tpu_torch.formats import laz
        decodes, decode_s = laz.decode_count, laz.decode_seconds
        splat.launches = 0
        eng = Engine(cfg=None, settings=Settings(point_budget=1.0,
                                                 frame_budget_ms=50.0),
                     device=dev)
        t0 = time.perf_counter()
        eng.open([dirs["laz"]], chunk_steps=1)
        frame_ms = []
        while not eng.last_batch_finished:
            eng.orbit.yaw += 0.03
            eng.camera.world = eng.orbit.world()
            t1 = time.perf_counter()
            img, stats = eng.frame(W, H)
            frame_ms.append((time.perf_counter() - t1) * 1e3)
        loop_s = time.perf_counter() - t0
        launches["laz_streamed"] = splat.launches
        rep = eng.report()
        tree = {k: rep[k] for k in TREE}
        n_dec = laz.decode_count - decodes
        check(tree == las_tree, f"LAZ streamed tree {tree} != LAS bulk "
              f"{las_tree}")
        check(n_dec == len(tile_sizes), f"{n_dec} LAZ file decodes for "
              f"{len(tile_sizes)} files")
        check(launches["laz_streamed"] >= len(frame_ms),
              f"{launches['laz_streamed']} kernel launches for "
              f"{len(frame_ms)} frames")
        check(coverage(img, C) > 0.05, "LAZ: too few pixels drawn")
        say(f"LAZ streamed loop (point_budget 1.0, frame_budget_ms 50, "
            f"1920x1080): {len(frame_ms)} frames in {loop_s:.2f} s = "
            f"{n / loop_s / 1e6:.2f} MP/s concurrent; frame ms median "
            f"{float(np.median(frame_ms)):.2f}, max {max(frame_ms):.2f}; "
            f"{n_dec} whole-file LAZ decodes (one per file) taking "
            f"{laz.decode_seconds - decode_s:.2f} s on the host CPU; host syncs "
            f"{rep['host_syncs']}; splat_samples launches "
            f"{launches['laz_streamed']}; tree {tree} equals the LAS bulk "
            f"load's; card: {card}")
        u = eng.uniforms(W, H)
        eng.render(W, H)
        _, sets, _ = pooled_frame_samples(eng.cfg, eng.state, eng._draw_pool,
                                          u, *eng.last_pooled_windows)
        rows[("laz", True)] = kernel_vs_plain(
            raster_tiles.pack_samples(eng.cfg, u, W, H, sets),
            "LAZ pooled frame, hqs=True", card)
        eng.stream.stop()
        del eng
        gc.collect()
        torch.cuda.empty_cache()

        # --- phase 12: colour filter and overlays on phase 10's state ---
        before = eng10.report()
        syncs = eng10.host_syncs
        t0 = time.perf_counter()
        eng10.filter_colors()
        torch.cuda.synchronize()
        filter_s = time.perf_counter() - t0
        after = eng10.report()
        for k in ("num_nodes", "num_voxels", "num_voxels_stored",
                  "num_points"):
            check(after[k] == before[k], f"filter_colors changed {k}: "
                  f"{before[k]} -> {after[k]}")
        say(f"filter_colors: {filter_s:.3f} s, {eng10.host_syncs - syncs} host "
            f"syncs, {after['num_voxels']} voxels in {after['num_nodes']} "
            f"nodes (counts unchanged); card: {card}")
        overlay = {}
        launches["overlay"] = 0
        for budget in (0.0, 1.0):
            eng10.settings.point_budget = budget
            for boxes in (False, True):
                eng10.settings.show_bounding_box = boxes
                splat.launches = 0
                ms, (img, stats) = median_ms(lambda: eng10.render(W, H))
                if boxes:
                    launches["overlay"] += splat.launches
                    check(splat.launches >= 6,
                          "overlay frames not through the splat_samples kernel")
                    route_ms[f"overlay {'pooled' if budget else 'exact'}"] = \
                        route_pair(eng10, img, "overlay", tile_launches, card)
                overlay[(budget, boxes)] = (ms, img)
            drawn = int((overlay[(budget, True)][1]
                         != overlay[(budget, False)][1]).sum())
            check(drawn > 0, f"point_budget {budget}: boxes drew nothing")
            kind = "pooled" if budget else "exact"
            say(f"{kind} 1920x1080 after filter_colors: without boxes median "
                f"{overlay[(budget, False)][0]:.2f} ms, with boxes "
                f"{overlay[(budget, True)][0]:.2f} ms ({drawn} pixels differ); "
                f"card: {card}")
        eng10.settings.show_bounding_box = False
        eng10.stream.stop()
        del eng10, img, stats
        gc.collect()
        torch.cuda.empty_cache()

        # --- phase 13: out-of-core on the 4 LAS tiles ---
        from simlod_tpu_torch.config import EngineConfig
        from simlod_tpu_torch.outofcore import OutOfCoreEngine
        from simlod_tpu_torch.render.render import composite_frames
        splat.launches = 0
        ooc = OutOfCoreEngine(EngineConfig.auto(total_points=max(tile_sizes),
                                                device=dev),
                              Settings(), device=dev)
        ooc.open([dirs["las"]])
        brick_s = []
        for p in ooc.brick_paths:
            t0 = time.perf_counter()
            ooc.build_brick(p)
            torch.cuda.synchronize()
            brick_s.append(time.perf_counter() - t0)
        rep = ooc.report()
        check(rep["total_points"] == n > ooc.cfg.point_capacity,
              f"out-of-core: {rep['total_points']} points, pool "
              f"{ooc.cfg.point_capacity}")
        say(f"out-of-core build: {len(brick_s)} bricks in "
            f"{', '.join(f'{t:.2f}' for t in brick_s)} s; {rep['total_points']} "
            f"points over a {ooc.cfg.point_capacity}-point device pool; host "
            f"bytes {rep['host_bytes']}; {rep['total_voxels']} voxels, "
            f"{rep['total_nodes']} nodes; card: {card}")

        def ooc_frame():
            img, st = ooc.render(W, H)
            torch.cuda.synchronize()
            return img, st
        splat.launches = 0
        ooc_ms, (img, _) = median_ms(ooc_frame)
        visible = len(ooc.last_drawn_bricks)
        frame_launches = splat.launches
        check(frame_launches >= 6 * visible > 0,
              f"{frame_launches} kernel launches for {visible} visible bricks "
              "over 6 frames")
        route_ms["out-of-core composite"] = route_pair(
            ooc, img, "ooc_composite", tile_launches, card, ooc_frame)
        planes, u = ooc.render_planes(W, H)
        comp, depth = composite_frames(torch.stack([p[1] for p in planes]),
                                       torch.stack([p[2] for p in planes]),
                                       u, W, H)
        host_img, host_d = host_depth_min([p[1:3] for p in planes], u, dev)
        check(np.array_equal(depth.cpu().numpy(), host_d),
              "composite depth != host depth-min of the brick planes")
        check(torch.equal(comp.reshape(-1), host_img)
              and torch.equal(img, comp),
              "composite != host depth-min composite of the brick planes")
        # evicted leaves draw nothing: the composite shows the bricks' voxel
        # LOD, so only drawing at all is required of it
        ooc_cover = coverage(img, C)
        check(ooc_cover > 0, "out-of-core: nothing drawn")
        b = ooc.bricks[0]
        ooc.orbit.target = 0.5 * (b.box_min + b.box_max).astype(np.float64)
        ooc.orbit.radius = 0.3 * float(np.linalg.norm(b.box_max - b.box_min))
        ooc.camera.world = ooc.orbit.world()
        # the check's render_planes above is not part of the path's count
        splat.launches = 0
        paged = ooc.auto_page(W, H)
        check(paged is not None, "closeup: no brick paged in")
        t1 = time.perf_counter()
        img, close_stats = ooc_frame()
        close_ms = (time.perf_counter() - t1) * 1e3
        launches["ooc_bricks"] = frame_launches + splat.launches
        check(coverage(img, C) > 0.05, "closeup: too few pixels drawn")
        close_med, (img, _) = median_ms(ooc_frame)
        route_ms["out-of-core closeup"] = route_pair(
            ooc, img, "ooc_closeup", tile_launches, card, ooc_frame)
        close_trunc = {i: bool(fs.truncated) for i, fs in close_stats.items()}
        say(f"out-of-core 1920x1080 composite of {visible} visible bricks: "
            f"median {ooc_ms:.2f} ms, {ooc_cover:.1%} of pixels drawn, equal to "
            f"the host depth-min composite of the brick planes; closeup paged in brick {paged} "
            f"({ooc.bricks[paged].pool_used} point rows), first frame "
            f"{close_ms:.2f} ms, then median {close_med:.2f} ms, truncated by "
            f"brick {close_trunc}; splat kernel "
            f"launches {launches['ooc_bricks']}; card: {card}")
        st = ooc.resident_state(paged)
        rcfg = ooc._render_cfg()
        u = ooc.uniforms(W, H)
        for hqs in (True, False):
            ooc.settings.use_high_quality_shading = hqs
            u = ooc.uniforms(W, H)
            _, sets, _ = frame_samples(rcfg, st, u, rcfg.max_render_points,
                                       rcfg.max_render_voxels)
            if hqs:
                rows[("ooc", True)] = kernel_vs_plain(
                    raster_tiles.pack_samples(rcfg, u, W, H, sets),
                    "out-of-core paged brick frame, hqs=True", card)
            srows[("ooc", hqs)] = splat_vs_plain(
                rcfg, u, sets, f"out-of-core paged brick frame, hqs={hqs}",
                card)
            xrows[("ooc", hqs)] = samples_vs_plain(
                rcfg, u, sets, f"out-of-core paged brick frame, hqs={hqs}",
                card)
        del ooc, st
        gc.collect()
        torch.cuda.empty_cache()

        # --- phases 14-16: the sharded engine on 4 shards of the card ---
        phase_small_sharded(tmp, dev)
        phase_sharded_bulk(path, n, cov3, dev, card, launches, srows, xrows)
        gc.collect()
        torch.cuda.empty_cache()
        phase_sharded_ooc(dirs["las"], n, dev, card, launches)
        gc.collect()
        torch.cuda.empty_cache()

        # --- phase 17: the app and the viewer on the card ---
        phase_app_viewer(tmp, path, dirs["las"], n, dev, card, launches)

    say("frame median ms, splat route vs tile route, interleaved: " + json.dumps(
        {k: [round(v[0], 2), round(v[1], 2)] for k, v in route_ms.items()}))
    ex, sx = rows[("exact", True)], srows[("exact", True)]
    xx = xrows[("exact", True)]
    by_stream = lambda rs: {f"{k[0]} {'hqs' if k[1] else 'plain'}":
                            [round(v, 4) for v in r[1:4]]
                            for k, r in rs.items()}
    say("splat_samples stage vs the previous design's (materialize + columns"
        " + splat_resolve), ms, timed in turns: " + json.dumps(
            {f"{k[0]} {'hqs' if k[1] else 'plain'}": [round(r[4], 4),
                                                       round(r[5], 4)]
             for k, r in xrows.items()}))
    say(json.dumps({"kernels": [{
        "name": "splat_samples", "route": "cuda",
        "source": "simlod_tpu_torch/csrc/raster_splat.cu",
        "replaces": "simlod_tpu/render/raster_tiles.py:237",
        "launches": sum(launches.values()), "launches_by_path": launches,
        "max_abs_err": max(r[0] for r in xrows.values()),
        "ms": xx[1], "plain_ms": xx[2], "bound_ms": xx[3], "bound_by": "bytes",
        "library_ms": None, "stage_ms": xx[5], "previous_stage_ms": xx[4],
        "call_ms": xx[7],
        "ms_plain_ms_bound_ms_by_stream": by_stream(xrows),
    }, {
        "name": "splat_resolve", "route": "cuda",
        "source": "simlod_tpu_torch/csrc/raster_splat.cu",
        "replaces": "simlod_tpu/render/raster_tiles.py:237",
        # off the frame path since splat_samples: its comparisons above are
        # not counted, so this is what the main paths launched
        "launches": resolve.launches,
        "max_abs_err": max(r[0] for r in srows.values()),
        "ms": sx[1], "plain_ms": sx[2], "bound_ms": sx[3], "bound_by": "bytes",
        "library_ms": None, "stage_ms": sx[4], "device_ms": sx[6],
        "ms_plain_ms_bound_ms_by_stream": by_stream(srows),
    }, {
        "name": "tile_resolve", "route": "cuda",
        "source": "simlod_tpu_torch/csrc/raster_tiles.cu",
        "replaces": "simlod_tpu/render/raster_tiles.py:237",
        "launches": sum(tile_launches.values()),
        "launches_by_path": tile_launches,
        "max_abs_err": max(r[0] for r in rows.values()),
        "ms": ex[1], "plain_ms": ex[2], "bound_ms": ex[3], "bound_by": "bytes",
        "library_ms": None, "stage_ms": sx[5],
        "ms_plain_ms_bound_ms_by_stream": by_stream(rows),
    }]}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
