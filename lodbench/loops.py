"""What the traffic loops share. A traffic mix is a data file
(traffic/<name>.json) whose "loop" names a loop module (traffic/<loop>.py,
its class LOOP) and whose other keys are that loop's parameters. A loop
drives the program's Engine exactly as the app and the viewer do, times it
on the host clock, keeps the answers that the reference checks once the
window has closed, runs that check, and says what else its run records
(`info`). A new kind of traffic is a new loop module; a new mix of a loop
is a new data file.
"""
from __future__ import annotations

import dataclasses
import math
import random

import numpy as np
import torch

from . import found
from . import reference as ref


def loop_class(name: str):
    """The loop of traffic/<name>.py."""
    return found.module("traffic", name).LOOP


def state_tensors(state) -> dict:
    """The program's octree as the dict of tensors the reference reads."""
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}


def percentiles_ms(frame_s) -> dict:
    """Nearest-rank percentiles of a window's frame times, in ms."""
    s = sorted(frame_s)
    if not s:
        return {}
    return {f"p{q}": 1e3 * s[min(int(q / 100 * len(s)), len(s) - 1)]
            for q in (50, 90, 95, 99, 100)}


class Pose:
    """The app's orbit camera from the scan's box: target at the box's
    centre, radius 1.2 times its diagonal, yaw -0.6 and pitch -0.8 (the
    auto-focus), then a turn of `yaw_step` a frame from a yaw offset drawn
    from the seed. With `zoom_every`, a scroll-wheel zoom too: every
    `zoom_every` frames the radius is divided (in) or multiplied (out) by
    `zoom_factor`, `zoom_steps` in and then as many out, from a phase of
    that cycle drawn from the seed."""

    def __init__(self, extent, traffic: dict, seed: int):
        rng = random.Random(seed)
        self.target = [0.5 * e for e in extent]
        self.radius = math.sqrt(sum(e * e for e in extent)) * 1.2 + 1e-6
        self.pitch = -0.8
        self.yaw0 = -0.6 + rng.uniform(0.0, 2.0 * math.pi)
        self.step = traffic["yaw_step"]
        self.every = traffic.get("zoom_every", 0)
        self.zsteps = traffic.get("zoom_steps", 0)
        self.factor = traffic.get("zoom_factor", 1.0)
        # the frames of one zoom cycle, or else of one turn
        self.cycle = self.every * 2 * self.zsteps \
            or math.ceil(2 * math.pi / abs(self.step))
        self.phase = rng.randrange(self.cycle)

    def at(self, k: int) -> dict:
        level = 0
        if self.every:
            s = ((self.phase + k) // self.every) % (2 * self.zsteps)
            level = s if s <= self.zsteps else 2 * self.zsteps - s
        return dict(yaw=self.yaw0 + k * self.step, pitch=self.pitch,
                    radius=self.radius / self.factor ** level,
                    target=self.target)

    def apply(self, eng, k: int) -> dict:
        p = self.at(k)
        o = eng.orbit
        o.yaw, o.pitch, o.radius = p["yaw"], p["pitch"], p["radius"]
        o.target = np.asarray(p["target"], np.float64)
        eng.camera.world = o.world()
        return p


def redraw(tree, scan, pose, ctx, dtype=torch.float32):
    """The reference's frame of the octree from `pose`: every voxel it
    stores is drawable, compacted or not (SimLOD draws voxels as they
    come)."""
    s = ctx.settings
    t = ref.view_projection(pose["yaw"], pose["pitch"], pose["radius"],
                            pose["target"], s["fovy"], ctx.width, ctx.height)
    return ref.render(tree, scan.cube, t, ctx.width, ctx.height,
                      min_node_size=s["min_node_size"],
                      hqs=s["use_high_quality_shading"],
                      edl_strength=s["edl_strength"] if s["enable_edl"]
                      else None, dtype=dtype)


def pixels_off(tree, scan, frames, ctx) -> float:
    """The widest share of pixels off over the checked (pose, image)
    frames; the control's images are the reference's own in bfloat16."""
    worst = 0.0
    for pose, img in frames:
        if ctx.control:
            img = redraw(tree, scan, pose, ctx, torch.bfloat16)
        worst = max(worst, ref.pixels_off_pct(img, redraw(tree, scan, pose,
                                                          ctx)))
    return worst


def control_tree(tree, scan) -> dict:
    """The file's points decoded in bfloat16, in the place of the tree's
    points and of the cells its voxels take."""
    low, q = scan.quantized(torch.bfloat16), scan.quantized()
    return {"points_mismatched": ref.points_mismatched(low, scan.rgba, q,
                                                       scan.rgba),
            "voxel_cells_missing_pct": ref.voxel_cells_missing_pct(tree, q,
                                                                   low)}


def tree_numbers(tree, scan, ctx) -> dict:
    """The octree's numbers: the program's, or the control's."""
    return control_tree(tree, scan) if ctx.control \
        else ref.tree_checks(tree, scan, ctx.leaf_cap)


class Loop:
    """A traffic loop: `setup()` warms the cell's shapes, `window(seconds)`
    measures, `stretch(seconds)` runs the same under the profiler,
    `check(scan)` -> the numbers compared, `info(window)` -> what else the
    run records."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.eng = ctx.engine()
        self.answers = 0

    def sync(self):
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def info(self, window: dict) -> dict:
        return {"frame_ms": percentiles_ms(window["frame_s"])} \
            if "frame_s" in window else {}
