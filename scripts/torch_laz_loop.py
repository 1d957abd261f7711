"""Times the LAZ streamed loop of chip_smoke.py's phase 11 for any tree's
package: 4 LAZ tiles of the 36M terrain (seed 0) through the simultaneous
loop (open(chunk_steps=1), then frame(1920, 1080) until the last batch is
built; point_budget 1.0, frame_budget_ms 50, yaw +0.03 rad a frame). One
JSON line a loop: frames, concurrent MP/s, median and largest frame ms,
the loader threads, the LAZ chunks decoded and the tree's counts.

    python3 scripts/torch_laz_loop.py --make --tiles DIR
    python3 scripts/torch_laz_loop.py --root TREE --tag NAME --tiles DIR

The first writes the tiles (chip_smoke.write_tiles, with this tree's
package); the second runs one warm-up loop over the first tile, then
`--loops` loops over all four, with TREE's package (the repo itself, or a
parent unpacked with `git archive` into _archive/). `--loaders N` gives
the stream N loader threads; `--batch-chunks N` sets the package's
LAZ_BATCH_CHUNKS where it has one. Run parent, change, change, parent in
one call to compare two trees on the same card."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TREE = ("num_nodes", "num_points", "num_points_processed")


def make(tiles: str, n: int):
    sys.path.insert(0, os.path.dirname(HERE))
    import chip_smoke
    from simlod_tpu_torch.formats import synthetic
    xyz, rgba = synthetic.terrain(n, seed=0)
    chip_smoke.write_tiles(tiles, xyz, rgba)


def loop(eng, paths, W=1920, H=1080):
    import numpy as np
    import torch
    t0 = time.perf_counter()
    stream = eng.open(paths, chunk_steps=1)
    frame_ms = []
    while not eng.last_batch_finished:
        eng.orbit.yaw += 0.03
        eng.camera.world = eng.orbit.world()
        t1 = time.perf_counter()
        eng.frame(W, H)
        frame_ms.append((time.perf_counter() - t1) * 1e3)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    loop_s = time.perf_counter() - t0
    rep = eng.report()
    return dict(frames=len(frame_ms), loop_s=round(loop_s, 4),
                mps=round(stream.total_points / loop_s / 1e6, 3),
                frame_ms_median=round(float(np.median(frame_ms)), 2),
                frame_ms_max=round(max(frame_ms), 2),
                loaders=len(stream._loaders),
                batches=stream._n_batches,
                laz_chunks=getattr(stream, "laz_chunks", None),
                tree={k: rep[k] for k in TREE})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tiles", required=True)
    ap.add_argument("--make", action="store_true")
    ap.add_argument("--points", type=int, default=36_000_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=os.path.dirname(HERE))
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--loops", type=int, default=2)
    ap.add_argument("--loaders", type=int, default=None)
    ap.add_argument("--batch-chunks", type=int, default=None)
    args = ap.parse_args(argv)
    if args.make:
        make(args.tiles, args.points)
        return 0
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    from simlod_tpu_torch import engine as engine_mod
    from simlod_tpu_torch.config import Settings
    from simlod_tpu_torch.engine import Engine
    from simlod_tpu_torch.io import streaming
    assert engine_mod.__file__.startswith(os.path.abspath(args.root))
    if args.batch_chunks is not None:
        streaming.LAZ_BATCH_CHUNKS = args.batch_chunks
    if args.loaders is not None:
        init = streaming.PointStream.__init__

        def fixed(self, *a, **k):
            k["num_loaders"] = args.loaders
            init(self, *a, **k)
        streaming.PointStream.__init__ = fixed
    laz_dir = os.path.join(args.tiles, "laz")
    tiles = sorted(os.path.join(laz_dir, f) for f in os.listdir(laz_dir))
    dev = torch.device(args.device)
    settings = Settings(point_budget=1.0, frame_budget_ms=50.0)
    eng = Engine(cfg=None, settings=settings, device=dev)
    loop(eng, tiles[:1])                                # warm-up
    for i in range(args.loops):
        eng = Engine(cfg=None, settings=settings, device=dev)
        out = loop(eng, [laz_dir])
        print(json.dumps(dict(tag=args.tag, loop=i,
                              loaders_arg=args.loaders,
                              batch_chunks=args.batch_chunks, **out)),
              flush=True)
        eng.stream.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
