"""The .simlod format of the reference's converter: a 24-byte box header
(min rebased to 0, then max, as 6 float32), then 16 B a point (x, y, z
float32 rebased so the box starts at 0, and the RGBA word). The writer
makes the benchmark's file; the reader is the plain reference's decode
(the reference's SimlodLoader)."""
from __future__ import annotations

import os

import numpy as np
import torch

SUFFIX = ".simlod"
WRITE_ROWS = 1 << 23           # rows written per copy from the device
READ_ROWS = 1 << 23            # records decoded on the device at a time


def write(path: str, xyz: torch.Tensor, rgba: torch.Tensor) -> None:
    mn = xyz.min(0).values
    mx = xyz.max(0).values
    header = np.concatenate([np.zeros(3, np.float32),
                             (mx - mn).cpu().numpy().astype(np.float32)])
    with open(path, "wb") as f:
        f.write(header.tobytes())
        for s in range(0, xyz.shape[0], WRITE_ROWS):
            rows = torch.cat([(xyz[s:s + WRITE_ROWS] - mn).view(torch.int32),
                              rgba[s:s + WRITE_ROWS, None]], 1)
            rows.cpu().numpy().tofile(f)
        # on the disk in set-up, so that its write-back stays out of the
        # window (the file stays in the page cache)
        f.flush()
        os.fsync(f.fileno())


def _box(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return np.frombuffer(f.read(24), np.float32).astype(np.float64)


def extent(path: str) -> list:
    """The box's extent (max - min an axis)."""
    box = _box(path)
    return (box[3:] - box[:3]).tolist()


def read(path: str, device) -> tuple:
    """-> (rebased float32 positions [n, 3], colours int32 [n], the octree's
    cube edge: the largest extent as float32), on `device`."""
    raw = np.memmap(path, np.int32, "r", offset=24).reshape(-1, 4)
    xyz, rgba = [], []
    for s in range(0, raw.shape[0], READ_ROWS):
        block = torch.from_numpy(np.array(raw[s:s + READ_ROWS])).to(device)
        xyz.append(block[:, :3].contiguous().view(torch.float32))
        rgba.append(block[:, 3].contiguous())
    cube = torch.tensor(float(np.float32(max(extent(path)))), device=device)
    return torch.cat(xyz), torch.cat(rgba), cube
