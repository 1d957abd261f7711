"""The plain reference of the out-of-core survey build: a folder of LAS
tiles (lodbench/formats/las_tiles.py), each built by the program as one
brick over the union cube and evicted to host memory.

Each tile is decoded as lodbench/formats/las.py's reader does (the
reference's LasLoader: int32 * scale + offset, minus the origin, in float64,
then float32), with the union box's min as the origin. Each brick, read
from its host arrays as the reference's `Tree`, is held to its tile's
points over the union cube by `reference.tree_checks` (the control: the
tile's points in bfloat16, by `loops.tree_numbers`). Survey-wide numbers:
`tiles_points_mismatched`, the points of all bricks against the survey's
(0 when every point is stored once), and `bricks_missing`, the tiles with
no brick. Plain PyTorch; nothing of the program is imported.
"""
from __future__ import annotations

import os
import struct

import numpy as np
import torch

from lodbench import found, loops
from lodbench import reference as ref

READ_ROWS = 1 << 23            # records decoded on the device at a time
RGB_AT = {2: 20, 3: 28, 5: 28, 7: 30, 8: 30, 10: 30}
# the LAS header's readers (its first 375 bytes, its box)
LAS = found.module("formats", "las")
# the columns a brick keeps on the host (outofcore.Brick) that the
# reference reads, by the group they are kept in
NODE_COLS = ("child_base", "parent", "level", "nx", "ny", "nz")
VOX_COLS = ("vox_k0", "vox_k1", "vox_k2l", "vox_rgba")
PT_COLS = ("pt_w0", "pt_w1", "pt_w2", "pt_rgba")
SEG_COLS = ("seg_node", "seg_off", "seg_cnt")


def tile_paths(folder: str) -> list:
    """The survey's tiles, in file-name order."""
    return [os.path.join(folder, n) for n in sorted(os.listdir(folder))
            if n.lower().endswith(".las")]


def tile_counts(paths) -> list:
    """The point count of each tile, from its header."""
    return [struct.unpack_from("<I", LAS._head(p), 107)[0] for p in paths]


def union_box(paths) -> tuple:
    """The union of the tiles' header boxes -> (min, max), lists of 3."""
    boxes = [LAS._box(LAS._head(p)) for p in paths]
    return ([min(b[0][a] for b in boxes) for a in range(3)],
            [max(b[1][a] for b in boxes) for a in range(3)])


def read_tile(path: str, origin, device) -> tuple:
    """One tile -> (positions rebased to `origin` as float32 [n, 3],
    colours as int32 words [n]), on `device`."""
    head = LAS._head(path)
    offset_to_points = struct.unpack_from("<I", head, 96)[0]
    fmt = head[104] & 0x3F
    bpp = struct.unpack_from("<H", head, 105)[0]
    n = struct.unpack_from("<I", head, 107)[0]
    rgb_at = RGB_AT.get(fmt)
    raw = np.memmap(path, np.uint8, "r", offset=offset_to_points,
                    shape=(n * bpp,)).reshape(n, bpp)
    f64 = dict(dtype=torch.float64, device=device)
    sc, off, lo = (torch.tensor(v, **f64) for v in (
        struct.unpack_from("<3d", head, 131),
        struct.unpack_from("<3d", head, 155), list(origin)))
    xyz, rgba = [], []
    for s in range(0, n, READ_ROWS):
        rec = torch.from_numpy(np.array(raw[s:s + READ_ROWS])).to(device)
        ints = rec[:, :12].contiguous().view(torch.int32).to(torch.float64)
        # world coordinates, then rebased to the origin
        xyz.append(((ints * sc + off) - lo).float())
        if rgb_at is None:
            c = torch.full((rec.shape[0], 3), 255, dtype=torch.int64,
                           device=device)
        else:
            c = rec[:, rgb_at:rgb_at + 6].contiguous().view(torch.int16)
            c = c.to(torch.int64) & 0xFFFF
            c = torch.where(c > 255, c // 256, c)
        word = c[:, 0] | (c[:, 1] << 8) | (c[:, 2] << 16) | (255 << 24)
        rgba.append(torch.where(word >= (1 << 31), word - (1 << 32),
                                word).to(torch.int32))
    return torch.cat(xyz), torch.cat(rgba)


def read_survey(folder: str, device) -> tuple:
    """Every tile rebased to the union box's min, in file-name order ->
    (xyz float32 [n, 3], rgba int32 [n], the cube edge: the union's largest
    extent as float32)."""
    paths = tile_paths(folder)
    mn, mx = union_box(paths)
    parts = [read_tile(p, mn, device) for p in paths]
    cube = torch.tensor(float(np.float32(max(b - a for a, b in zip(mn, mx)))),
                        device=device)
    return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]),
            cube)


def evicted_bytes(bricks) -> int:
    """The bytes the bricks hold on the host: the used prefixes of the
    columns each eviction copied from the device."""
    return sum(a.nbytes for b in bricks
               for group in (b.nodes, b.voxels, b.points, b.segs)
               for a in group.values())


def brick_tree(brick, device) -> ref.Tree:
    """A brick's host arrays as the reference's Tree. Its voxel store was
    compacted before the eviction, so every voxel counts as compacted."""
    col = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    state = {c: col(brick.nodes[c]) for c in NODE_COLS}
    state.update({c: col(brick.voxels[c]) for c in VOX_COLS})
    state.update({c: col(brick.points[c]) for c in PT_COLS})
    state.update({c: col(brick.segs[c]) for c in SEG_COLS})
    state.update(num_nodes=brick.num_nodes, num_segments=brick.num_segments,
                 vox_used=brick.vox_used, vox_compacted=brick.vox_used)
    return ref.Tree(state)


def survey_numbers(bricks, folder: str, scan: ref.Scan, ctx) -> dict:
    """The bricks against the survey `scan` (read_survey's, on the device
    the check runs on) -> {check name: number}: each of tree_checks'
    numbers summed over the bricks (voxel_cells_missing_pct: the largest
    brick's), `tiles_points_mismatched` and `bricks_missing`. With
    `ctx.control` the tiles' points in bfloat16 stand in for the program's
    (loops.tree_numbers)."""
    paths = tile_paths(folder)
    by_name = {os.path.basename(b.path): b for b in bricks}
    out: dict = {}
    qs, colours = [], []
    start = missing = 0
    for path, n in zip(paths, tile_counts(paths)):
        tile = ref.Scan(scan.xyz[start:start + n], scan.rgba[start:start + n],
                        scan.cube)
        start += n
        brick = by_name.get(os.path.basename(path))
        if brick is None:
            missing += 1
            continue
        tree = brick_tree(brick, scan.xyz.device)
        for k, v in loops.tree_numbers(tree, tile, ctx).items():
            out[k] = max(out.get(k, v), v) if k.endswith("_pct") \
                else out.get(k, 0) + v
        qs.append(tree.q)
        colours.append(tree.rgba)
        del tree
    want = scan.quantized()
    if ctx.control:
        out["tiles_points_mismatched"] = ref.points_mismatched(
            scan.quantized(torch.bfloat16), scan.rgba, want, scan.rgba)
    else:
        out["tiles_points_mismatched"] = ref.points_mismatched(
            torch.cat(qs), torch.cat(colours), want, scan.rgba)
    out["bricks_missing"] = missing
    return out
