#!/usr/bin/env python3
"""Time the PyTorch port's EDL kernel, and the host cost of the edl_cuda and
splat_samples wrappers, on one CUDA card, for the simlod_tpu_torch package of
a given tree, so that two trees can be compared on one card in one command
(in turns: parent, change, change, parent):

    python3 scripts/torch_edl_timing.py [--root TREE] [--tag NAME]

At 1920x1080 and 3840x2160, on planes made on the device from a seed
(chip_smoke.edl_planes): raster.edl_cuda against raster.edl_reference
(bit-equal), then ms a call back to back with the host out of the way
(chip_smoke.queued_ms), ms a call by CUDA events as the host issues them
(chip_smoke.time_ms), the bound (12 B a pixel at 3.35 TB/s) and the
wrapper's host µs a call (host clock around back-to-back calls: the median
of 5 runs of 200). Then splat_samples on the exact 1080p frame of a
2M-point terrain: host µs a call (5 runs of 50 calls), ms by CUDA events
and back to back. Prints the card line and one JSON line; exits 1 without
a card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POINTS = 2_000_000   # the terrain whose exact 1080p frame splat_samples draws


def smoke_helpers():
    """This repository's chip_smoke.py as a module (its timing helpers)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_us(fn, reps: int, blocks: int = 5) -> float:
    """Host µs a call of fn: the median over `blocks` runs of `reps`
    back-to-back calls (no sync between the calls of a run), after one
    warm-up call."""
    import statistics
    import torch
    fn()
    out = []
    for _ in range(blocks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out.append((time.perf_counter() - t0) / reps * 1e6)
    torch.cuda.synchronize()
    return statistics.median(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=REPO,
                    help="the tree whose simlod_tpu_torch is timed")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_edl_timing: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    smoke = smoke_helpers()
    import simlod_tpu_torch
    from simlod_tpu_torch import kernels
    from simlod_tpu_torch.config import Settings
    from simlod_tpu_torch.engine import Engine
    from simlod_tpu_torch.formats import simlod, synthetic
    from simlod_tpu_torch.render import raster
    from simlod_tpu_torch.render.render import frame_samples

    card = smoke.card_line()
    print(card, flush=True)
    kernels.build()
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"tag": args.tag, "package": simlod_tpu_torch.__file__,
           "card": card, "edl": {}}
    for w, h in ((1920, 1080), (3840, 2160)):
        color, depth, u = smoke.edl_planes(w, h, dev)
        fn = lambda: raster.edl_cuda(color, depth, u, w, h)
        got, want = fn(), raster.edl_reference(color, depth, u, w, h)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise SystemExit(f"edl kernel != plain version at {w}x{h}")
        out["edl"][f"{w}x{h}"] = {
            "ms": smoke.queued_ms(fn), "call_ms": smoke.time_ms(fn),
            "bound_ms": smoke.bound_ms(12 * w * h),
            "host_us": host_us(fn, 200), "bit_equal": True}
    with tempfile.TemporaryDirectory() as tmp:
        xyz, rgba = synthetic.terrain(POINTS, seed=0)
        path = os.path.join(tmp, "terrain.simlod")
        simlod.write(path, xyz, rgba)
        eng = Engine(cfg=None, settings=Settings(), device=dev)
        eng.open([path])
        eng.load_all()
        eng.render(1920, 1080)
        u = eng.uniforms(1920, 1080)
        _, sets, _ = frame_samples(eng.cfg, eng.state, u, *eng.last_windows)
        fn = lambda: raster.splat_samples(eng.cfg, u, 1920, 1080, sets)
        out["splat_samples"] = {"points": POINTS,
                                "host_us": host_us(fn, 50),
                                "call_ms": smoke.time_ms(fn),
                                "ms": smoke.queued_ms(fn)}
        eng.stream.stop()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
