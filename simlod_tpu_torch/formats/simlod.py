""".simlod format: 24-byte header (box min xyz, box max xyz as float32) followed by
16 bytes per point: x,y,z float32 (rebased so coordinates start at 0) + RGBA uint8.

Defined by the reference's converter tool (tools/las2simlod.mjs:1-9) and read natively
by SimlodLoader.cpp:59-157. Reading here is a zero-copy numpy memmap view — the decode
loop is memcpy-level work, never a per-point Python loop.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

HEADER_BYTES = 24
POINT_BYTES = 16


@dataclasses.dataclass
class SimlodInfo:
    path: str
    box_min: np.ndarray       # [3] f32
    box_max: np.ndarray       # [3] f32
    num_points: int


def load_info(path: str) -> SimlodInfo:
    with open(path, "rb") as f:
        hdr = np.frombuffer(f.read(HEADER_BYTES), dtype=np.float32)
    size = os.path.getsize(path)
    n = (size - HEADER_BYTES) // POINT_BYTES
    return SimlodInfo(path=path, box_min=hdr[:3].copy(), box_max=hdr[3:].copy(),
                      num_points=int(n))


def read_points(path: str, first: int = 0, count: int | None = None):
    """Read a range of points -> (xyz f32 [n,3], rgba u32 [n]). Zero-copy memmap."""
    info = load_info(path)
    if count is None:
        count = info.num_points - first
    count = max(0, min(count, info.num_points - first))
    mm = np.memmap(path, dtype=np.uint8, mode="r", offset=HEADER_BYTES,
                   shape=(info.num_points * POINT_BYTES,))
    raw = mm[first * POINT_BYTES:(first + count) * POINT_BYTES]
    rec = raw.view(np.dtype([("xyz", np.float32, 3), ("rgba", np.uint32)]))
    return np.ascontiguousarray(rec["xyz"]), np.ascontiguousarray(rec["rgba"])


def write(path: str, xyz: np.ndarray, rgba: np.ndarray,
          box_min=None, box_max=None) -> None:
    """Write a .simlod file. Coordinates are rebased so they start at 0 (matching the
    reference converter, las2simlod.mjs:96-101)."""
    xyz = np.asarray(xyz, np.float32)
    rgba = np.asarray(rgba, np.uint32)
    mn = np.asarray(box_min if box_min is not None else xyz.min(axis=0), np.float32)
    mx = np.asarray(box_max if box_max is not None else xyz.max(axis=0), np.float32)
    rebased = xyz - mn
    hdr = np.concatenate([np.zeros(3, np.float32), (mx - mn).astype(np.float32)])
    rec = np.zeros(len(xyz), dtype=np.dtype([("xyz", np.float32, 3),
                                             ("rgba", np.uint32)]))
    rec["xyz"] = rebased
    rec["rgba"] = rgba
    with open(path, "wb") as f:
        f.write(hdr.tobytes())
        f.write(rec.tobytes())
