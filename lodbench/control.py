#!/usr/bin/env python3
"""The readings that the limits of a cell's check are set from, in one
process on one card:

    python3 lodbench/control.py --workload <cell> --seeds S1 S2 ... \\
        --control-seeds C1 C2 C3 [--seconds 3]

For each of --seeds, a short run of the cell (the program at the cell's
own size and traffic) and its check; for each of --control-seeds, the same
run with the reference, computed in bfloat16, put in the place of the
program's answers (the control, which has to come out not correct).
Prints one line a run, then one JSON line: for each number compared, the
largest that the program's runs read (the lower reading), the smallest
that the control's read (the upper reading) and the limit the
configuration holds it to. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)


def readings(cell, seeds, control_seeds, seconds, device, **small) -> dict:
    """{number: {"lower", "upper", "limit"}} over the runs (see the module);
    `small` shrinks the runs for a test on the CPU."""
    import gc

    import torch

    from lodbench.run import run
    lower, upper = {}, {}
    for seeds_, control, into in ((seeds, False, lower),
                                  (control_seeds, True, upper)):
        for s in seeds_:
            out = run(cell, s, seconds, False, device, control=control,
                      **small)
            print(json.dumps(dict(seed=s, control=control,
                                  correct=out["correct"],
                                  error=out["info"]["error"],
                                  checks=out["checks"])), flush=True)
            for k, (v, _) in out["checks"].items():
                into.setdefault(k, []).append(v)
            del out
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
    limits = cell.config["limits"]
    keys = sorted(set(lower) | set(upper))
    return {k: dict(lower=max(lower[k]) if k in lower else None,
                    upper=min(upper[k]) if k in upper else None,
                    limit=limits[k]) for k in keys}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    import torch
    from lodbench.run import load_cell
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    cell = load_cell(args.workload)
    out = readings(cell, args.seeds, args.control_seeds, args.seconds,
                   torch.device("cuda", 0))
    print(json.dumps(dict(workload=args.workload, readings=out,
                          seconds=time.perf_counter() - t0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
