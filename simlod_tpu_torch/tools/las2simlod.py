"""LAS/LAZ -> .simlod converter (port of simlod_tpu/tools/las2simlod.py; parity
with the reference's tools/las2simlod.mjs).

Usage: python -m simlod_tpu_torch.tools.las2simlod input.las [output.simlod]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..formats import las, laz

BATCH = 1_000_000


def convert(src: str, dst: str, batch: int = BATCH, verbose: bool = True) -> int:
    """Write src's points, rebased to the origin, as a .simlod file; returns
    the number of points written."""
    is_laz = src.lower().endswith(".laz")
    hdr = las.load_header(src)
    header = np.concatenate([np.zeros(3, np.float32),
                             (hdr.box_max - hdr.box_min).astype(np.float32)])
    rec = np.dtype([("xyz", np.float32, 3), ("rgba", np.uint32)])
    n_done = 0
    with open(dst, "wb") as f:
        f.write(header.astype(np.float32).tobytes())
        while n_done < hdr.num_points:
            cnt = min(batch, hdr.num_points - n_done)
            if is_laz:
                xyz, rgba = laz.read_points(src, n_done, cnt,
                                            translation=-hdr.box_min)
            else:
                xyz, rgba = las.read_points(hdr, n_done, cnt,
                                            translation=-hdr.box_min)
            out = np.zeros(len(xyz), dtype=rec)
            out["xyz"] = xyz
            out["rgba"] = rgba
            f.write(out.tobytes())
            n_done += cnt
            if verbose:
                print(f"points processed: {n_done:,}", file=sys.stderr)
    return n_done


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input")
    ap.add_argument("output", nargs="?")
    ap.add_argument("--batch", type=int, default=BATCH)
    args = ap.parse_args(argv)
    out = args.output or os.path.splitext(args.input)[0] + ".simlod"
    n = convert(args.input, out, args.batch)
    print(f"wrote {n:,} points -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
