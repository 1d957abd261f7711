#!/usr/bin/env python3
"""Engine.render of the PyTorch port under a moving camera on one CUDA
card: the graph cache's policies against the eager frame, in turns, in one
process.

    python3 scripts/torch_graph_orbit.py [--points N] [--frames 60]

On a terrain of N points (36M by default, as in chip_smoke.py) loaded by
Engine, each policy draws `frames` frames of 1920x1080 along an orbit,
every frame a new view: the exact frame, and the pooled one
(Settings.point_budget 1), at the app's step (2 pi / 60 rad a frame,
app.py) and at the viewer's (0.05 rad a request, chip_smoke.py phase 17).
The policies:

- eager: the frame's span runs eagerly (no graph);
- held: the engine as it is (one graph per key in FrameGraphs; the exact
  frame's sample windows held by engine.held_window);
- per-frame: the exact frame's windows as the JAX package sizes them
  (engine.sample_window from the last frame's visible counts, every
  frame), a graph captured on the first sight of its key;
- per-frame, 2nd sight / 3rd sight: the same windows; a frame of a key
  seen fewer times runs eagerly, the 2nd (3rd) sight captures.

The pooled frame's windows are re-probed every 8 frames whatever the
policy, so it runs eager and held only. Each run starts from the same
windows, yaw and an empty graph cache; the policies run in the order
above, then in reverse. Prints, per run, the mean, median and max wall ms
of Engine.render (host clock), the captures and the distinct sample
windows; then the card line and one JSON line. Exits 1 without a card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time
import types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 1920, 1080
STEPS = {"app": None, "viewer": 0.05}    # None: 2 pi / 60 (app.py)


def smoke_helpers():
    """This repository's chip_smoke.py as a module (card_line,
    eager_frames)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sight_graphs(sight: int):
    """A FrameGraphs that runs a key's frame eagerly until the key's
    `sight`-th frame, which runs it and records the graph."""
    from simlod_tpu_torch.graphs import FrameGraphs

    class SightGraphs(FrameGraphs):
        def __init__(self):
            super().__init__()
            self.seen = {}

        def run(self, key, span, device):
            if key not in self._graphs:
                self.seen[key] = self.seen.get(key, 0) + 1
                if self.seen[key] < sight:
                    return span()
            return super().run(key, span, device)
    return SightGraphs()


def per_frame_windows(self):
    """Engine._windows with the JAX package's sample windows."""
    from simlod_tpu_torch.engine import directory_window, sample_window
    pv, vv = self._last_visible
    ppw, pvw = self._last_windows
    pw = sample_window(pv, ppw, self.cfg.max_render_points)
    vw = sample_window(vv, pvw, self.cfg.max_render_voxels)
    self._last_windows = (pw, vw)
    nn, ns = self._last_counts
    self.last_windows = (pw, vw, directory_window(nn, self.cfg.node_capacity),
                         directory_window(ns, self.cfg.segment_capacity))
    return self.last_windows


POLICIES = {"eager": (lambda: smoke_helpers().eager_frames(), False),
            "held": (None, False),
            "per-frame": (None, True),
            "per-frame, 2nd sight": (lambda: sight_graphs(2), True),
            "per-frame, 3rd sight": (lambda: sight_graphs(3), True)}


def run(eng, policy: str, step: float, frames: int, start: dict) -> dict:
    import numpy as np
    import torch
    from simlod_tpu_torch.graphs import FrameGraphs
    make, per_frame = POLICIES[policy]
    for k, v in start.items():
        setattr(eng, k, v)
    eng.graphs = None
    torch.cuda.empty_cache()
    eng.graphs = (make or FrameGraphs)()
    if per_frame:
        eng._windows = types.MethodType(per_frame_windows, eng)
    ms, windows = [], set()
    try:
        for _ in range(frames):
            eng.orbit.yaw += step
            eng.camera.world = eng.orbit.world()
            t0 = time.perf_counter()
            eng.render(W, H)
            ms.append((time.perf_counter() - t0) * 1e3)
            windows.add(eng.last_pooled_windows[:4]
                        if eng.settings.point_budget > 0
                        else eng.last_windows[:2])
    finally:
        eng.__dict__.pop("_windows", None)
    return {"mean_ms": float(np.mean(ms)), "median_ms": float(np.median(ms)),
            "max_ms": max(ms), "captures": eng.graphs.captures,
            "windows": len(windows)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--points", type=int, default=36_000_000)
    ap.add_argument("--frames", type=int, default=60)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_graph_orbit: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from simlod_tpu_torch.config import Settings
    from simlod_tpu_torch.engine import Engine
    from simlod_tpu_torch.formats import simlod, synthetic
    card = smoke_helpers().card_line()
    out = {"card": card, "points": args.points, "frames": args.frames,
           "runs": []}
    with tempfile.TemporaryDirectory() as tmp:
        xyz, rgba = synthetic.terrain(args.points, seed=0)
        path = os.path.join(tmp, "terrain.simlod")
        simlod.write(path, xyz, rgba)
        del xyz, rgba
        eng = Engine(settings=Settings(), device="cuda")
        eng.open([path])
        eng.load_all()
        for budget, frame in ((0.0, "exact"), (1.0, "pooled")):
            eng.settings.point_budget = budget
            for _ in range(3):
                eng.render(W, H)
            start = {k: getattr(eng, k) for k in (
                "_last_windows", "_low_frames", "_last_visible",
                "_cached_pool_ws", "_pool_ws_age")}
            yaw0 = eng.orbit.yaw
            names = list(POLICIES) if budget == 0 else ["eager", "held"]
            for step_name, step in STEPS.items():
                step = step or 2.0 * np.pi / 60
                for name in names + names[::-1]:
                    eng.orbit.yaw = yaw0
                    row = {"frame": frame, "step": step_name,
                           "policy": name,
                           **run(eng, name, step, args.frames, start)}
                    out["runs"].append(row)
                    print(json.dumps(row), flush=True)
        eng.stream.stop()
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
