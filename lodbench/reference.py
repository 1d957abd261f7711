"""The plain reference that decides `correct`: the file read and decoded
again, the octree the program built held to the points the file holds, and
a frame drawn again from that octree.

Plain PyTorch, written from the formats and from SimLOD's rules (the
decode is each format's reader in lodbench/formats/, after the reference's
LasLoader and SimlodLoader; its octree of
50,000-point leaves with first-come 128^3 voxels in inner nodes, its
kernel_render for LOD, frustum, the depth-min splat with high-quality
shading and eye-dome lighting). It imports nothing of the program: the
program's octree comes in as a dict of tensors, its images as tensors.
Everything runs on the device the tensors are on, in whole columns.

Bit widths: a position is quantized to 28 bits an axis; a node at level L
holds a 128^3 grid, so a level-L voxel cell is (q >> (21 - L)) an axis. The
keys packed below hold levels up to 14 (3 x 21 bits in an int64).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from lodbench import found

GRID_BITS = 28                 # per-axis quantization
CELL_BITS = 7                  # 128 cells a node edge
LEAF_CAP = 50_000              # points in a leaf that may not split further
MAX_DEPTH = 20
MAX_KEY_LEVEL = 14             # deepest level the packed keys hold
BACKGROUND = 0x00332211        # the clear colour (abgr)
DEPTH_INF = 0x7F800000         # +inf as float32 bits
HQS_TOLERANCE = 1.01           # samples within 1% of the nearest are blended


class Scan:
    """A scan file decoded: rebased float32 positions [n, 3], u32 colours as
    int32 [n], and the octree's cube edge (float32, the largest box extent)."""

    def __init__(self, xyz, rgba, cube):
        self.xyz, self.rgba, self.cube = xyz, rgba, cube

    def quantized(self, dtype=torch.float32) -> torch.Tensor:
        """Grid coordinates int64 [n, 3]: floor(x * (2^28 / cube)), the
        positions first rounded to `dtype` (float32: the file's own)."""
        xyz = self.xyz.to(dtype).float()
        inv = torch.tensor(float(1 << GRID_BITS), dtype=torch.float32,
                           device=xyz.device) / self.cube
        q = torch.floor(xyz * inv).to(torch.int64)
        return q.clamp_(0, (1 << GRID_BITS) - 1)


def read_scan(path: str, fmt: str, device) -> Scan:
    """Decode the scan's file by its format's reader
    (lodbench/formats/<fmt>.py), as the reference's loaders do."""
    return Scan(*found.module("formats", fmt).read(path, device))


def _i32(word: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> their int32 bit patterns."""
    return torch.where(word >= (1 << 31), word - (1 << 32), word).to(torch.int32)


def morton_decode(words) -> torch.Tensor:
    """Three Morton words (levels 0-9, 10-19, 20-27 of the 28-bit axes; 3
    bits a level, x y z from high to low) -> int64 [n, 3] coordinates."""
    q = torch.zeros((words[0].shape[0], 3), dtype=torch.int64,
                    device=words[0].device)
    hi = GRID_BITS
    for w, nlev in zip(words, (10, 10, 8)):
        lo = hi - nlev
        w = w.to(torch.int64)
        for i in range(nlev):
            for axis in range(3):
                q[:, axis] |= ((w >> (3 * i + 2 - axis)) & 1) << (lo + i)
        hi = lo
    return q


def pack(c: torch.Tensor, bits: int) -> torch.Tensor:
    """int64 [n, 3] coordinates of `bits` bits an axis -> one int64 key."""
    return (c[:, 0] << (2 * bits)) | (c[:, 1] << bits) | c[:, 2]


class Tree:
    """The program's octree as the reference reads it: node columns (the
    live ones), and every stored point with its node and grid coordinates."""

    def __init__(self, state: dict):
        nn = int(state["num_nodes"])
        self.nodes = {k: state[k][:nn].to(torch.int64) for k in
                      ("child_base", "parent", "level", "nx", "ny", "nz")}
        self.num_nodes = nn
        nseg = int(state["num_segments"])
        node, off, cnt = (state[k][:nseg].to(torch.int64)
                          for k in ("seg_node", "seg_off", "seg_cnt"))
        live = (cnt > 0) & (node >= 0)
        node, off, cnt = node[live], off[live], cnt[live]
        seg = torch.repeat_interleave(torch.arange(cnt.shape[0],
                                                   device=cnt.device), cnt)
        start = torch.cumsum(cnt, 0) - cnt
        row = off[seg] + torch.arange(seg.shape[0], device=seg.device) \
            - start[seg]
        del start
        self.point_node = node[seg]
        del seg
        self.q = morton_decode([state[k][row] for k in
                                ("pt_w0", "pt_w1", "pt_w2")])
        self.rgba = state["pt_rgba"][row]
        del row
        used = int(state["vox_used"])
        self.vox_compacted = int(state["vox_compacted"])
        k2l = state["vox_k2l"][:used].to(torch.int64)
        self.vox_level = k2l & 31
        self.vox_q = morton_decode([state["vox_k0"][:used],
                                    state["vox_k1"][:used], k2l & ~31])
        self.vox_rgba = state["vox_rgba"][:used]

    def node_key(self, level, coords) -> torch.Tensor:
        """(level, node coordinates) -> one int64 key (levels <= 14)."""
        return (level << 48) | pack(coords, MAX_KEY_LEVEL)

    def node_ids(self, level, coords) -> torch.Tensor:
        """Node ids of (level, coords) pairs, -1 where no node has them."""
        n = self.nodes
        keys = self.node_key(n["level"], torch.stack([n["nx"], n["ny"],
                                                      n["nz"]], 1))
        order = torch.argsort(keys)
        sk = keys[order]
        want = self.node_key(level, coords)
        at = torch.searchsorted(sk, want).clamp_(max=sk.shape[0] - 1)
        return torch.where(sk[at] == want, order[at], -1)

    def point_counts(self) -> torch.Tensor:
        return torch.bincount(self.point_node, minlength=self.num_nodes)


def _sorted_rows(q: torch.Tensor, rgba: torch.Tensor):
    """Points in one canonical order: by (x, y) then (z, colour)."""
    k1 = (q[:, 0] << GRID_BITS) | q[:, 1]
    k2 = (q[:, 2] << 32) | (rgba.to(torch.int64) & 0xFFFFFFFF)
    o = torch.argsort(k2, stable=True)
    k1, k2 = k1[o], k2[o]
    o = torch.argsort(k1, stable=True)
    return k1[o], k2[o]


def points_mismatched(qa, rgba_a, qb, rgba_b) -> int:
    """Rows where two point sets (grid coordinates and colour), each sorted,
    differ, plus the difference in their counts: 0 exactly when they hold
    the same points as often."""
    a1, a2 = _sorted_rows(qa, rgba_a)
    b1, b2 = _sorted_rows(qb, rgba_b)
    m = min(a1.shape[0], b1.shape[0])
    return int(((a1[:m] != b1[:m]) | (a2[:m] != b2[:m])).sum()) \
        + abs(a1.shape[0] - b1.shape[0])


def tree_checks(tree: Tree, scan: Scan, leaf_cap: int = LEAF_CAP) -> dict:
    """The octree against the scan -> {check name: number}.

    points_mismatched   rows where the tree's points (grid coordinates and
                        colour), sorted, differ from the file's, plus the
                        difference in their counts (0 when every point of
                        the file is stored exactly once)
    points_misplaced    points stored in an inner node or outside their
                        node's cell
    leaves_overfull     leaves above `leaf_cap` points that could still split
    nodes_malformed     inner nodes whose 8 children are not the 8 octants
                        one level down, and nodes no parent holds
    voxels_misplaced    stored voxels whose cell lies in no inner node
    voxels_duplicated   compacted voxels that repeat a cell
    voxel_cells_empty   voxel cells that hold no point of the file
    voxel_colors_foreign  voxels whose colour is no colour of a point in
                        their cell
    voxel_cells_missing_pct  of the cells of inner nodes that hold a point
                        of the file, the share with no voxel (%)"""
    q_ref = scan.quantized()
    n = tree.nodes
    pq = tree.q
    out = {"points_mismatched": points_mismatched(pq, tree.rgba, q_ref,
                                                  scan.rgba)}

    inner = n["child_base"] >= 0
    lvl = n["level"]
    coords = torch.stack([n["nx"], n["ny"], n["nz"]], 1)
    pn = tree.point_node
    cell = pq >> (GRID_BITS - lvl[pn])[:, None]
    out["points_misplaced"] = int((inner[pn] | (cell != coords[pn]).any(1))
                                  .sum())
    del cell
    counts = tree.point_counts()
    out["leaves_overfull"] = int((~inner & (counts > leaf_cap)
                                  & (lvl < MAX_DEPTH)).sum())
    out["nodes_malformed"] = _malformed(n, inner, coords)

    max_level = int(lvl.max())
    if max_level > MAX_KEY_LEVEL:
        raise ValueError(f"the tree reaches level {max_level}; the check's "
                         f"keys hold {MAX_KEY_LEVEL}")
    misplaced = dup = empty = foreign = missing = expected = 0
    for L in range(max_level):
        inner_l = inner & (lvl == L)
        inner_keys = torch.sort(pack(coords[inner_l], L)).values
        vsel = tree.vox_level == L
        vq = tree.vox_q[vsel]
        vcell = pack(vq >> (MAX_DEPTH + 1 - L), L + CELL_BITS)
        vnode = pack(vq >> (GRID_BITS - L), L)
        ok = torch.isin(vnode, inner_keys)
        misplaced += int((~ok).sum())
        comp = vsel[:tree.vox_compacted]
        ccell = vcell[:int(comp.sum())]
        dup += ccell.shape[0] - torch.unique(ccell).shape[0]
        pin, pcell = _cells(q_ref, L, inner_keys)
        want = torch.unique(pcell)
        have = torch.unique(vcell)
        expected += want.shape[0]
        missing += want.shape[0] - int(torch.isin(want, have).sum())
        empty += int((~torch.isin(have, want)).sum())
        pair = _pair_hash(pcell, scan.rgba[pin])
        vpair = _pair_hash(vcell, tree.vox_rgba[vsel])
        foreign += int((~torch.isin(vpair, pair)).sum())
        del pin, pcell, want, have, pair, vpair
    misplaced += int((tree.vox_level >= max(max_level, 0)).sum())
    out["voxels_misplaced"] = misplaced
    out["voxels_duplicated"] = dup
    out["voxel_cells_empty"] = empty
    out["voxel_colors_foreign"] = foreign
    out["voxel_cells_missing_pct"] = 100.0 * missing / max(expected, 1)
    return out


def _cells(q: torch.Tensor, L: int, inner_keys: torch.Tensor):
    """Which points lie in an inner node of level L (of `inner_keys`), and
    their level-L voxel cells."""
    pin = torch.isin(pack(q >> (GRID_BITS - L), L), inner_keys)
    return pin, pack(q[pin] >> (MAX_DEPTH + 1 - L), L + CELL_BITS)


def voxel_cells_missing_pct(tree: Tree, q_want: torch.Tensor,
                            q_have: torch.Tensor) -> float:
    """tree_checks' voxel_cells_missing_pct with the cells that points
    `q_have` occupy in place of the tree's voxels (the control's)."""
    n = tree.nodes
    inner = n["child_base"] >= 0
    lvl = n["level"]
    coords = torch.stack([n["nx"], n["ny"], n["nz"]], 1)
    missing = expected = 0
    for L in range(int(lvl.max())):
        keys = torch.sort(pack(coords[inner & (lvl == L)], L)).values
        want = torch.unique(_cells(q_want, L, keys)[1])
        have = torch.unique(_cells(q_have, L, keys)[1])
        expected += want.shape[0]
        missing += want.shape[0] - int(torch.isin(want, have).sum())
    return 100.0 * missing / max(expected, 1)


def _pair_hash(cell: torch.Tensor, rgba: torch.Tensor) -> torch.Tensor:
    """(cell key, colour) -> one int64 (wrapping multiply)."""
    return cell * -7046029254386353131 + (rgba.to(torch.int64) & 0xFFFFFFFF)


def _malformed(n: dict, inner: torch.Tensor, coords: torch.Tensor) -> int:
    ids = torch.nonzero(inner).flatten()
    nn = inner.shape[0]
    bad = torch.zeros(ids.shape[0], dtype=torch.bool, device=ids.device)
    seen = torch.zeros(nn, dtype=torch.int64, device=ids.device)
    for k in range(8):
        c = n["child_base"][ids] + k
        out_of_range = (c <= 0) | (c >= nn)
        bad |= out_of_range
        c = c.clamp(0, nn - 1)
        octant = torch.tensor([(k >> 2) & 1, (k >> 1) & 1, k & 1],
                              device=ids.device)
        bad |= n["parent"][c] != ids
        bad |= n["level"][c] != n["level"][ids] + 1
        bad |= (coords[c] != 2 * coords[ids] + octant).any(1)
        seen.index_add_(0, c[~out_of_range],
                        torch.ones_like(c[~out_of_range]))
    root_bad = int(n["level"][0] != 0) + int(n["parent"][0] != -1)
    held = int((seen[1:] != 1).sum()) if nn > 1 else 0
    return int(bad.sum()) + root_bad + held


# --- the frame ---

def view_projection(yaw: float, pitch: float, radius: float, target,
                    fovy: float, width: int, height: int) -> np.ndarray:
    """The orbit camera's transform (proj @ view), float32 [4, 4] acting on
    column vectors: world = T(target) Rz(yaw) Rx(pitch) F T(0, 0, radius)
    with F the Z-up flip (x, y, z) -> (x, -z, y); a GL perspective of
    `fovy` degrees, near 0.1, far 2e6."""
    def tr(v):
        m = np.eye(4)
        m[:3, 3] = v
        return m
    c, s = math.cos(yaw), math.sin(yaw)
    rz = np.eye(4)
    rz[0, 0], rz[0, 1], rz[1, 0], rz[1, 1] = c, -s, s, c
    c, s = math.cos(pitch), math.sin(pitch)
    rx = np.eye(4)
    rx[1, 1], rx[1, 2], rx[2, 1], rx[2, 2] = c, -s, s, c
    flip = np.array([[1.0, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0],
                     [0, 0, 0, 1]])
    world = tr(np.asarray(target, np.float64)) @ rz @ rx @ flip \
        @ tr([0.0, 0.0, radius])
    near, far = 0.1, 2_000_000.0
    f = 1.0 / math.tan(math.radians(fovy) / 2.0)
    proj = np.zeros((4, 4))
    proj[0, 0] = f / (width / height)
    proj[1, 1] = f
    proj[2, 2] = (far + near) / (near - far)
    proj[2, 3] = 2.0 * far * near / (near - far)
    proj[3, 2] = -1.0
    return (proj @ np.linalg.inv(world)).astype(np.float32)


def _screen(m, x, y, z, width, height):
    """(screen x, screen y, clip w) of positions under transform m."""
    n0 = x * m[0, 0] + y * m[0, 1] + z * m[0, 2] + m[0, 3]
    n1 = x * m[1, 0] + y * m[1, 1] + z * m[1, 2] + m[1, 3]
    w = x * m[3, 0] + y * m[3, 1] + z * m[3, 2] + m[3, 3]
    return (n0 / w * 0.5 + 0.5) * width, (n1 / w * 0.5 + 0.5) * height, w


def render(tree: Tree, cube: torch.Tensor, transform: np.ndarray, width: int,
           height: int, min_node_size: float = 64.0, hqs: bool = True,
           edl_strength: float | None = 0.4, voxel_rows: int | None = None,
           dtype=torch.float32) -> torch.Tensor:
    """The frame of `tree` -> u32 abgr words as int32 [height, width].

    LOD: a node is large when its screen box is wider or taller than twice
    `min_node_size`; the drawn nodes are the visible children of large
    nodes that are not large themselves, and large visible leaves (leaves
    draw their points, inner nodes their voxels). A node is visible when its
    box meets the frustum and it can hold samples. Each sample lands on one
    pixel (x, y truncated, 1 < x < width - 2, 1 < y < height - 2, in front
    of the eye); the nearest depth wins, and with high-quality shading the
    pixel's colour is the mean of the samples within 1% of it. Then
    eye-dome lighting. `voxel_rows` voxels are drawn (default: all stored;
    a frame draws the compacted ones). `dtype` is the precision of the
    positions and the projection (the control's is bfloat16)."""
    dev = tree.q.device
    f32 = torch.float32
    m = torch.as_tensor(transform, device=dev).to(dtype)
    n = tree.nodes
    inner = n["child_base"] >= 0
    size = (cube / torch.exp2(n["level"].to(f32))).to(dtype)
    mn = [size * n[k].to(dtype) for k in ("nx", "ny", "nz")]
    mx = [a + size for a in mn]
    big = 3.4e38
    lo_x = torch.full_like(size, big, dtype=f32)
    hi_x = torch.full_like(size, -big, dtype=f32)
    lo_y, hi_y = lo_x.clone(), hi_x.clone()
    for c in range(8):
        px = mx[0] if (c >> 2) & 1 else mn[0]
        py = mx[1] if (c >> 1) & 1 else mn[1]
        pz = mx[2] if c & 1 else mn[2]
        sx, sy, _ = _screen(m, px, py, pz, width, height)
        sx, sy = sx.float(), sy.float()
        lo_x, hi_x = torch.minimum(lo_x, sx), torch.maximum(hi_x, sx)
        lo_y, hi_y = torch.minimum(lo_y, sy), torch.maximum(hi_y, sy)
    large = ((hi_x - lo_x) > 2.0 * min_node_size) \
        | ((hi_y - lo_y) > 2.0 * min_node_size)
    mf = m.float()
    planes = torch.stack([mf[3] - mf[0], mf[3] + mf[0], mf[3] + mf[1],
                          mf[3] - mf[1], mf[3] - mf[2], mf[3] + mf[2]])
    planes = planes / torch.sqrt((planes[:, :3] ** 2).sum(1))[:, None]
    in_frustum = torch.ones_like(inner)
    for p in planes:
        corner = [torch.where(p[i] > 0, mx[i], mn[i]).float() for i in range(3)]
        dist = corner[0] * p[0] + corner[1] * p[1] + corner[2] * p[2] + p[3]
        in_frustum &= dist >= 0.0
    counts = tree.point_counts()
    visible = in_frustum & (inner | (counts > 0))
    parent = n["parent"]
    parent_large = (parent >= 0) & large[parent.clamp(min=0)]
    drawn = visible & ((parent_large & ~large) | (large & ~inner))

    # the samples: points of drawn leaves, voxels of drawn inner nodes
    pick = drawn[tree.point_node]
    s = (cube / float(1 << GRID_BITS)).to(dtype)
    pts = (tree.q[pick].to(f32).to(dtype) + 0.5) * s
    cols = [tree.rgba[pick]]
    rows = tree.vox_level.shape[0] if voxel_rows is None else voxel_rows
    vl, vq = tree.vox_level[:rows], tree.vox_q[:rows]
    vp = vq >> (MAX_DEPTH + 1 - vl)[:, None]
    node = tree.node_ids(vl, vp >> CELL_BITS)
    vpick = (node >= 0) & drawn[node.clamp(min=0)]
    vl, vp = vl[vpick], vp[vpick]
    vsize = (cube / torch.exp2(vl.to(f32))).to(dtype)[:, None]
    vox = (vp >> CELL_BITS).to(f32).to(dtype) * vsize \
        + vsize * (((vp & 127).to(f32).to(dtype) + 0.5) / 128.0)
    cols.append(tree.vox_rgba[:rows][vpick])
    xyz = torch.cat([pts, vox])
    color = torch.cat(cols).to(torch.int64) & 0xFFFFFFFF
    sx, sy, w = _screen(m, xyz[:, 0], xyz[:, 1], xyz[:, 2], width, height)
    sx, sy, w = sx.float(), sy.float(), w.float()
    px, py = sx.to(torch.int32), sy.to(torch.int32)
    ok = (px > 1) & (px.to(f32) < width - 2.0) & (py > 1) \
        & (py.to(f32) < height - 2.0) & (w > 0.0)
    npx = width * height
    pix = (px + width * py).to(torch.int64)[ok]
    depth = w[ok].contiguous()
    color = color[ok]
    bits = depth.view(torch.int32)
    fb = torch.full((npx,), DEPTH_INF, dtype=torch.int32, device=dev)
    fb.scatter_reduce_(0, pix, bits, "amin")
    if hqs:
        near = fb[pix].view(f32)
        take = depth < near * HQS_TOLERANCE
        rgb1 = torch.stack([color & 0xFF, (color >> 8) & 0xFF,
                            (color >> 16) & 0xFF, torch.ones_like(color)], 1)
        acc = torch.zeros((npx, 4), dtype=torch.int64, device=dev)
        acc.index_add_(0, pix[take], rgb1[take])
        cnt = acc[:, 3].clamp(min=1)
        word = (acc[:, 0] // cnt) | ((acc[:, 1] // cnt) << 8) \
            | ((acc[:, 2] // cnt) << 16) | (0xFF << 24)
        img = torch.where(acc[:, 3] > 0, word, BACKGROUND)
    else:
        win = bits == fb[pix]
        best = torch.full((npx,), 1 << 32, dtype=torch.int64, device=dev)
        best.scatter_reduce_(0, pix[win], color[win], "amin")
        img = torch.where(fb < DEPTH_INF, best, BACKGROUND)
    if edl_strength is not None:
        img = eye_dome(img, fb.view(f32), width, height, edl_strength)
    return _i32(img).reshape(height, width)


def eye_dome(color: torch.Tensor, depth: torch.Tensor, width: int,
             height: int, strength: float) -> torch.Tensor:
    """Eye-dome lighting: response = sum over the 4 neighbours (wrapping at
    the edges) of max(log2 d - log2 d_n, 0) / 50, colour scaled by
    exp(-response * 300 * strength); a difference of two infinities counts
    0. `color` int64 words -> int64 words, alpha 255."""
    logd = torch.log2(depth.reshape(height, width))
    resp = torch.zeros_like(logd)
    for dx, dy in ((0, 1), (1, 0), (0, -1), (-1, 0)):
        diff = logd - torch.roll(logd, shifts=(-dy, -dx), dims=(0, 1))
        resp = resp + torch.where(torch.isnan(diff), 0.0, diff.clamp(min=0.0))
    shade = torch.exp(-(resp / 50.0) * 300.0 * strength).reshape(-1)
    out = torch.full_like(color, 0xFF << 24)
    for k in range(3):
        ch = (((color >> (8 * k)) & 0xFF).to(torch.float32) * shade)
        out |= ch.to(torch.int64) << (8 * k)
    return out


def pixels_off_pct(image: torch.Tensor, ref: torch.Tensor) -> float:
    """Share of pixels (%) where a colour channel differs by more than 1."""
    a = image.reshape(-1).to(torch.int64)
    b = ref.reshape(-1).to(ref.device).to(torch.int64)
    off = torch.zeros_like(a, dtype=torch.bool)
    for k in range(3):
        off |= (((a >> (8 * k)) & 0xFF) - ((b >> (8 * k)) & 0xFF)).abs() > 1
    return 100.0 * float(off.sum()) / a.shape[0]


def scan_extent(path: str, fmt: str) -> list:
    """The scan's box extent (max - min an axis) from its file's header."""
    return found.module("formats", fmt).extent(path)
