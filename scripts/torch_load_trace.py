#!/usr/bin/env python3
"""Where a load's time goes, from the port's spans
(simlod_tpu_torch/utils/trace.py), for one load cell of the benchmark:

    python3 scripts/torch_load_trace.py --workload simlod36m.load \\
        [--seed N] [--loads 6] [--traced 2] [--out FILE.json]

The cell's scan is made from the seed as the benchmark makes it
(lodbench/data.py), and loaded back to back as its load loop does
(lodbench/traffic/load.py), after one warm-up load. A summary is printed
as one JSON line; the whole record goes to --out:

  - `off_cost`: a span's cost with no profiler running (ns), and with one;
    the spans a load closes;
  - `loads`: per untraced load, each phase's seconds and share of the load
    (Engine.open + load_all), the device reads per site, how much of the
    load's seconds the spans cover, the stream's first item
    (`first_item_s`) and its `stats()`;
  - `audit`: one load under torch.cuda.set_sync_debug_mode("warn"): every
    synchronizing call, and whether a `sync.<site>` span holds it; on the
    card `audit_cold` audits the warm-up load too (the one whose build
    captures its graphs), and `memory` gives the card's peak allocated and
    reserved bytes over the untraced loads;
  - `traced`: loads under torch.profiler (CPU and CUDA): their seconds
    against the untraced loads' (the on-cost), the card's idle seconds put
    down to the innermost program span at each gap's midpoint, and the
    benchmark's own list of the longest gaps (lodbench/devtrace.py).

On the CPU (--device cpu, --points) it runs at a small size with a small
EngineConfig; the audit and the traced loads need a card and are left out.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import statistics
import sys
import tempfile
import threading
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from lodbench import data, devtrace  # noqa: E402
from lodbench import reference as ref  # noqa: E402
from lodbench import run as R  # noqa: E402
from lodbench.loops import loop_class  # noqa: E402
from simlod_tpu_torch.utils import trace  # noqa: E402

# the phases of a bulk load, and the spans directly under engine.load_all
PHASES = ("engine.open", "open.config", "open.stream", "open.state",
          "engine.load_all", "stream.wait", "load.item",
          "load.item_overlapped", "build.many", "build.step", "build.route",
          "build.split", "build.voxels", "build.insert", "build.compact",
          "build.finish", "build.replay", "build.capture", "build.eager")
LOAD_ALL_CHILDREN = ("stream.wait", "load.item", "build.finish",
                     "sync.engine.capacity")


def phases(d: dict, loop_s: float) -> dict:
    """One load's totals (trace.since) -> its phase table."""
    load_s = d["engine.open"]["seconds"] + d["engine.load_all"]["seconds"]
    la = d["engine.load_all"]
    out = dict(loop_s=loop_s, load_s=load_s, spans=sum(
        v["count"] for v in d.values()))
    out["phases"] = {n: dict(seconds=d[n]["seconds"], count=d[n]["count"],
                             sync_s=d[n]["sync_s"],
                             pct=100 * d[n]["seconds"] / load_s)
                     for n in PHASES if n in d}
    sync = {n[5:]: dict(count=v["count"], seconds=v["seconds"])
            for n, v in d.items() if n.startswith("sync.")}
    out["syncs"] = sync
    out["sync_count"] = sum(v["count"] for v in sync.values())
    out["sync_pct"] = 100 * (d["engine.open"]["sync_s"] + la["sync_s"]) \
        / load_s
    if "build.step" in d:
        s = d["build.step"]
        out["step_host_ms"] = 1e3 * (s["seconds"] - s["sync_s"]) / s["count"]
    if "stream.stage" in d:
        out["stage_s"] = d["stream.stage"]["seconds"]
    if "stream.first_item" in d:
        out["first_item_s"] = d["stream.first_item"]["seconds"]
    out["load_all_children_pct"] = 100 * sum(
        d[n]["seconds"] for n in LOAD_ALL_CHILDREN if n in d) / la["seconds"]
    out["open_load_all_pct_of_loop"] = 100 * load_s / loop_s
    return out


def off_cost(n: int = 200_000) -> dict:
    """ns a span with no profiler, and with torch.profiler (CPU) running."""
    def per_span(k):
        t0 = time.perf_counter()
        for _ in range(k):
            pass
        base = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(k):
            with trace.span("bench.span"):
                pass
        return 1e9 * (time.perf_counter() - t0 - base) / k
    off = per_span(n)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        on = per_span(n // 10)
    return dict(ns_per_span_off=off, ns_per_span_profiled=on)


def audit(loop) -> dict:
    """One load with every synchronizing CUDA call reported: each is
    counted when the innermost open span of its thread is a sync.<site>."""
    hits = collections.Counter()
    where = {}
    prog = str(ROOT / "simlod_tpu_torch")

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        spans = trace.open_spans()
        counted = bool(spans) and spans[-1].startswith("sync.")
        frames = [f for f in traceback.extract_stack()[:-1]
                  if f.filename.startswith(prog)]
        site = (f"{os.path.relpath(frames[-1].filename, ROOT)}:"
                f"{frames[-1].lineno}" if frames
                else f"outside the program ({os.path.basename(filename)}:"
                f"{lineno})")
        key = (counted, spans[-1] if spans else "", site,
               threading.current_thread().name)
        hits[key] += 1
        where[key] = [f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} "
                      f"{f.name}" for f in frames[-4:]]

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            r = loop.one()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    rows = [dict(counted=k[0], span=k[1], site=k[2], thread=k[3], calls=c,
                 stack=where[k]) for k, c in hits.most_common()]
    return dict(host_syncs=r["host_syncs"], calls=rows,
                uncounted_in_program=sum(
                    x["calls"] for x in rows if not x["counted"]
                    and not x["site"].startswith("outside")))


def idle_by_span(events) -> dict:
    """The card's idle seconds in the traced stretch, each gap put down to
    the innermost program span at its midpoint (user annotations of the
    program's names; "(none)" outside them)."""
    host, dev = [], []
    stretch = None
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((e.start_ns(), e.end_ns()))
        elif e.name() == devtrace.SPAN:
            stretch = (e.start_ns(), e.end_ns())
        elif e.is_user_annotation() and not e.name().startswith(
                ("Engine.", "lodbench")):
            host.append((e.start_ns(), e.end_ns(), e.name()))
    lo, hi = stretch
    dev = sorted((max(s, lo), min(e, hi)) for s, e in dev if e > lo and s < hi)
    host.sort()
    out = collections.Counter()
    for s, e in devtrace._gaps(dev, lo, hi):
        mid, best = (s + e) // 2, "(none)"
        for hs, he, n in host:
            if hs > mid:
                break
            if he >= mid:
                best = n
        out[best] += (e - s) * 1e-9
    return dict(window_s=(hi - lo) * 1e-9, idle_s=sum(out.values()),
                by_span=dict(out.most_common()))


def traced(loop, n: int) -> dict:
    from torch.profiler import ProfilerActivity, profile
    loads = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(devtrace.SPAN):
            for _ in range(n):
                snap = trace.snapshot()
                r = loop.one()
                loads.append(phases(trace.since(snap), r["seconds"]))
            torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    summary = devtrace.summarize(events, {})
    return dict(loads=loads, idle=idle_by_span(events),
                busy_s=summary["busy_s"], window_s=summary["window_s"],
                idle_gaps=summary["idle_gaps"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 7)
    ap.add_argument("--loads", type=int, default=6)
    ap.add_argument("--traced", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--points", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    cuda = device.type == "cuda"
    cell = R.load_cell(args.workload)
    config = cell.config
    engine_cfg = None
    if not cuda:
        from simlod_tpu_torch.config import EngineConfig
        engine_cfg = EngineConfig(
            node_capacity=1 << 14, point_capacity=1 << 19,
            voxel_capacity=1 << 20, segment_capacity=1 << 15,
            step_points=1 << 15, spill_capacity=1 << 15,
            max_points_per_node=2000, seg_select_cap=1 << 10,
            max_render_points=1 << 18, max_render_voxels=1 << 18)
    tmp = tempfile.mkdtemp(prefix="loadtrace-")
    loop = None
    out = dict(workload=cell.name, seed=args.seed,
               card=torch.cuda.get_device_name(device) if cuda else "cpu",
               power_limit=R.power_limit() if cuda else None)
    try:
        path = data.make_scan(config, args.seed, device, tmp, args.points)
        ctx = R.Ctx(device=device, path=path,
                    extent=ref.scan_extent(path, config["format"]),
                    traffic=cell.traffic, seed=args.seed,
                    width=config["width"], height=config["height"],
                    points=args.points or config["points"],
                    overrides=config.get("engine", {}),
                    settings=R.settings_of(config), engine_cfg=engine_cfg)
        loop = loop_class(cell.traffic["loop"])(ctx)
        if cuda:
            out["audit_cold"] = audit(loop)     # the warm-up load
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        else:
            loop.setup()
        out["off_cost"] = off_cost()
        rows = []
        for _ in range(args.loads):
            snap = trace.snapshot()
            r = loop.one()
            rows.append(phases(trace.since(snap), r["seconds"]))
            rows[-1]["host_syncs"] = r["host_syncs"]
            rows[-1]["stream"] = loop.eng.stream.stats()
        out["loads"] = rows
        out["off_cost"]["spans_per_load"] = statistics.median(
            x["spans"] for x in rows)
        if cuda:
            out["memory"] = dict(
                peak_allocated=torch.cuda.max_memory_allocated(device),
                peak_reserved=torch.cuda.max_memory_reserved(device))
            out["audit"] = audit(loop)
            out["traced"] = traced(loop, args.traced)
            on = statistics.median(x["loop_s"] for x in out["traced"]["loads"])
            off = statistics.median(x["loop_s"] for x in rows)
            out["on_cost"] = dict(untraced_load_s=off, traced_load_s=on,
                                  pct=100 * (on / off - 1))
    finally:
        if loop is not None and loop.eng.stream is not None:
            loop.eng.stream.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    brief = {k: v for k, v in out.items() if k not in ("loads", "traced",
                                                       "audit", "audit_cold")}
    med = lambda key: statistics.median(x[key] for x in rows)
    brief["median"] = {k: med(k) for k in (
        "loop_s", "load_s", "sync_pct", "sync_count", "step_host_ms",
        "stage_s", "first_item_s", "load_all_children_pct",
        "open_load_all_pct_of_loop") if k in rows[0]}
    brief["staged_rows"] = [x["stream"].get("staged_rows") for x in rows]
    brief["min_coverage"] = dict(
        load_all_children_pct=min(x["load_all_children_pct"] for x in rows),
        open_load_all_pct_of_loop=min(x["open_load_all_pct_of_loop"]
                                      for x in rows))
    brief["phase_pct"] = {n: statistics.median(
        x["phases"][n]["pct"] for x in rows if n in x["phases"])
        for n in PHASES if n in rows[0]["phases"]}
    brief["syncs"] = {n: v["count"] for n, v in rows[-1]["syncs"].items()}
    brief["stretches"] = {n: rows[-1]["phases"][n]["count"] for n in (
        "build.replay", "build.capture", "build.eager")
        if n in rows[-1]["phases"]}
    for name in ("audit_cold", "audit"):
        if name in out:
            brief[name] = dict(
                host_syncs=out[name]["host_syncs"],
                uncounted_in_program=out[name]["uncounted_in_program"],
                calls=[(c["counted"], c["span"], c["site"], c["thread"],
                        c["calls"]) for c in out[name]["calls"]])
    if "traced" in out:
        t = out["traced"]
        brief["traced"] = dict(idle=t["idle"], busy_s=t["busy_s"],
                               window_s=t["window_s"],
                               idle_gaps=t["idle_gaps"], coverage=[
                                   (x["load_all_children_pct"],
                                    x["open_load_all_pct_of_loop"])
                                   for x in t["loads"]])
    print(json.dumps(brief))
    return 0


if __name__ == "__main__":
    sys.exit(main())
