"""A survey folder of LAS tiles. The writer cuts the scan into a grid of
GRID[0] x GRID[1] equal cells over its box in x and y, and writes each
cell's points, in scan order, as one LAS 1.2 point-format-2 file by
lodbench/formats/las.py's writer (26 B records, scale 0.001, the tile's own
min as its offset). The path is the folder. The reader gives the whole
survey: every tile decoded as las.py's reader does, but rebased to the
union box's min (lodbench/tiles_reference.py)."""
from __future__ import annotations

import os

import torch

from lodbench import found
from lodbench import tiles_reference as tiles

SUFFIX = ".tiles"              # the folder's name ends so
GRID = (4, 2)                  # tiles along x, along y


def cells(xyz: torch.Tensor) -> torch.Tensor:
    """The grid cell of each point, int64 [n]: column + GRID[0] * row."""
    mn = xyz.min(0).values.double()
    edge = (xyz.max(0).values.double() - mn).clamp(min=1e-30)
    at = []
    for axis, k in enumerate(GRID):
        c = torch.floor((xyz[:, axis].double() - mn[axis]) * k / edge[axis])
        at.append(c.clamp_(0, k - 1).to(torch.int64))
    return at[0] + GRID[0] * at[1]


def write(path: str, xyz: torch.Tensor, rgba: torch.Tensor) -> None:
    las = found.module("formats", "las")
    os.makedirs(path)
    cell = cells(xyz)
    for row in range(GRID[1]):
        for col in range(GRID[0]):
            rows = torch.nonzero(cell == col + GRID[0] * row).flatten()
            if rows.numel():
                las.write(os.path.join(path, f"tile_{row}_{col}.las"),
                          xyz[rows], rgba[rows])


def extent(path: str) -> list:
    """The union box's extent (max - min an axis), from the headers."""
    mn, mx = tiles.union_box(tiles.tile_paths(path))
    return [b - a for a, b in zip(mn, mx)]


def read(path: str, device) -> tuple:
    """-> (the survey's positions rebased to the union box's min as float32
    [n, 3], colours as int32 words [n], the octree's cube edge: the union's
    largest extent as float32), the tiles in file-name order."""
    return tiles.read_survey(path, device)
