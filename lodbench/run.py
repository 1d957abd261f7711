#!/usr/bin/env python3
"""The benchmark of simlod_tpu_torch, one run of one cell:

    python3 lodbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell (BENCHMARK.json's `workloads`)
names a configuration (its file: the scan's format and size, the engine's
settings, the generator's parameters and the limits of the check) and a
traffic mix (traffic/<name>.json: the loop, traffic/<loop>.py, and its
parameters). A run makes the scan from the seed on the card, writes it
under TMPDIR in its format (formats/<format>.py), warms the
cell's own shapes (set-up, `setup_s`), measures the traffic for --seconds
on the host clock, then checks a sample of the window's answers against the
plain reference (reference.py) and prints one JSON line. With --trace 1 a
stretch of the same traffic follows the window under torch.profiler, and
the line holds the cell's per-layer metrics instead of its end-to-end ones.
Each metric is read by lodbench/metrics/<name>.py. Without a CUDA card, or
with fewer cards than the cell asks for, it prints no result and exits 1.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if __name__ == "__main__":
    # run as a script: import this folder as the package it is
    sys.path[0] = str(ROOT)

from lodbench import found  # noqa: E402

# top-level module names no run may load (the JAX package and JAX)
FORBIDDEN = ("jax", "jaxlib", "flax", "simlod_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    metrics: list          # the BENCHMARK.json entries this cell reports


def load_cell(name: str, root: Path = ROOT, trace: bool = False) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its configuration file,
    its traffic file and the metrics it reports (end to end, or with
    `trace` per layer)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    metrics = [m for m in bench["per_layer" if trace else "end_to_end"]
               if name in m.get("workloads", [name])]
    return make_cell(name, configs[w["config"]]["file"], w["traffic"],
                     w["chips"], metrics, root)


def make_cell(name: str, config_file: str, traffic: str, chips: int = 1,
              metrics: list | None = None, root: Path = ROOT) -> Cell:
    """A cell of the configuration file `config_file` (relative to `root`)
    under the traffic mix traffic/<traffic>.json."""
    config = json.loads((root / config_file).read_text())
    mix = json.loads((root / HERE.name / "traffic" / f"{traffic}.json")
                     .read_text())
    return Cell(name, chips, config, mix, list(metrics or []))


def metric_module(name: str):
    """The reader of a per-layer or end-to-end metric: metrics/<name>.py."""
    return found.module("metrics", name)


@dataclasses.dataclass
class Ctx:
    """What a loop needs: the device, the scan's file and box, the traffic's
    parameters, the frame size and the engine's settings."""
    device: object
    path: str
    extent: list
    traffic: dict
    seed: int
    width: int
    height: int
    settings: dict
    points: int = 0                # in the scan
    overrides: dict = dataclasses.field(default_factory=dict)
    engine_cfg: object = None      # None: EngineConfig.auto, as the app,
                                   # with `overrides` (the configuration's
                                   # `engine` keys)
    control: bool = False          # the reference in bfloat16 in the
                                   # program's place (control.py)
    leaf_cap: int = 50_000         # the points a leaf may hold


    def engine(self):
        from simlod_tpu_torch.config import Settings
        from simlod_tpu_torch.engine import Engine
        return Engine(self._cfg(), Settings(**self.settings),
                      device=self.device)

    def _cfg(self):
        """EngineConfig.auto for the scan with the configuration's `engine`
        keys set (None without them: the engine sizes itself at open)."""
        if self.engine_cfg is not None or not self.overrides:
            return self.engine_cfg
        from simlod_tpu_torch.config import EngineConfig
        return EngineConfig.auto(total_points=self.points, device=self.device,
                                 **self.overrides)

    def open(self, eng, chunk_steps: int | None = None):
        """Engine.open of the scan, its capacities sized anew at each open
        as the app's are (the engine adapts its config while it loads)."""
        if self.engine_cfg is None and self.overrides:
            eng.cfg = self._cfg()
        return eng.open([self.path], chunk_steps=chunk_steps)


def settings_of(config: dict) -> dict:
    """The engine's Settings as the configuration states them (the app's
    defaults where it states none), as a dict of every field."""
    from simlod_tpu_torch.config import Settings
    s = dataclasses.asdict(Settings())
    s.update(config.get("settings", {}))
    return s


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        points: int | None = None, engine_cfg=None, control: bool = False,
        t0: float | None = None) -> dict:
    """One run of `cell` on `device` -> the result (the JSON line's keys,
    and `checks`: {name: (value, limit)}). Set-up counts from `t0` (the
    process's start; default: now). `points` and `engine_cfg` shrink the
    run for a test on the CPU; `control` puts the reference, computed in
    bfloat16, in the place of the program's answers."""
    t0 = time.perf_counter() if t0 is None else t0
    import torch

    from . import data, devtrace
    from . import reference as ref
    from .loops import loop_class

    cuda = device.type == "cuda"
    config, traffic = cell.config, cell.traffic
    tmp = tempfile.mkdtemp(prefix="lodbench-")
    loop = None
    try:
        path = data.make_scan(config, seed, device, tmp, points)
        fmt = config["format"]
        ctx = Ctx(device=device, path=path,
                  extent=ref.scan_extent(path, fmt),
                  traffic=traffic, seed=seed, width=config["width"],
                  points=points or config["points"],
                  overrides=config.get("engine", {}),
                  height=config["height"], settings=settings_of(config),
                  engine_cfg=engine_cfg, control=control,
                  leaf_cap=getattr(engine_cfg, "max_points_per_node", 50_000))
        loop = loop_class(traffic["loop"])(ctx)
        loop.setup()
        loop.answers = 0
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - t0
        window = loop.window(seconds)
        answers = loop.answers
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        rec = dict(setup_s=setup_s, window=window, traffic=traffic,
                   settings=ctx.settings, width=ctx.width, height=ctx.height)
        mods = {m["name"]: metric_module(m["name"]) for m in cell.metrics}
        summary = None
        if trace:
            groups = {}
            for mod in mods.values():
                groups.update(getattr(mod, "KERNELS", {}))
            stretch, summary = devtrace.traced(
                lambda: loop.stretch(traffic["trace_seconds"]), groups)
            rec.update(stretch=stretch, trace=summary)
        loop.eng.graphs.clear()     # the graphs' memory, before the check
        try:
            scan = ref.read_scan(path, fmt, device)
            numbers = loop.check(scan)
            error = None
        except Exception:       # a check that fails to run is not correct
            numbers, error = {}, traceback.format_exc()
        limits = config["limits"]
        checks = {k: (v, limits[k]) for k, v in numbers.items()}
        failed = sum(v > lim for v, lim in checks.values())
        metrics = {}
        for m in cell.metrics:
            value = mods[m["name"]].read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = dict(platform="gpu" if cuda else device.type,
                   kind=torch.cuda.get_device_name(device) if cuda else "cpu",
                   count=cell.chips, memory_peak_bytes=int(peak))
        if summary is not None:
            dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        out = dict(correct=error is None and failed == 0 and bool(checks),
                   attempted=answers, failed=failed if error is None
                   else max(answers, 1), metrics=metrics, device=dev)
        if summary is not None:
            out["breakdown"] = dict(device_ops=summary["device_ops"],
                                    idle_gaps=summary["idle_gaps"])
        out["info"] = dict(loop.info(window),
                           power_limit=power_limit() if cuda else None,
                           seed=seed, error=error)
        out["checks"] = checks
        return out
    finally:
        if loop is not None and loop.eng.stream is not None:
            loop.eng.stream.stop()
        shutil.rmtree(tmp, ignore_errors=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None, t0: float = T0) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload, trace=bool(args.trace))

    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"lodbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    out = run(cell, args.seed, args.seconds, bool(args.trace),
              torch.device("cuda", 0), t0=t0)
    loaded = forbidden_modules()
    if loaded:
        print(f"lodbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 1
    checks = out.pop("checks")
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    if out["info"]["error"]:
        print(out["info"]["error"], file=sys.stderr)
    for k, (v, lim) in checks.items():
        print(f"check {k} {v} limit {lim}"
              f" {'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    from lodbench.run import main as _main
    sys.exit(_main(t0=T0))
