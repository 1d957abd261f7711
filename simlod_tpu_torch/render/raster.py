"""Software point/voxel rasterization (port of simlod_tpu/render/raster.py).

A frame's sample sets are `SampleSource`s: the block plan of a ragged gather
(ragged.plan_blocks) over the octree's or the draw pool's columns, not yet
gathered. `rasterize` draws them as the reference's kernel_render does
(render.cu:95-99, 487-493): decode and project each sample, a u64 atomicMin
of (depth bits << 32 | colour) per pixel, then either an HQS accumulate
(depth < closest*1.01) or the plain winner's colour. On CUDA tensors that is
one hand-written kernel, csrc/raster_splat.cu (`splat_samples`), which reads
the sources where they lie; on CPU tensors it is its plain PyTorch version
`splat_samples_reference`: `materialize` (the gathers, Morton decode and
positions, as column-form `Samples`), `splat_columns` (projection into one
(pixel, depth bits, colour) row per splat) and `splat_resolve_reference`
(scatter-mins and an index_add). `splat_resolve` is the previous design's
CUDA kernel over those columns, kept as the yardstick of the stage. Frames go
through `rasterize` unless `use_tile_raster` sends them to
render/raster_tiles.py.

Colours and packed words are int32 bit patterns (torch has no uint32 `>>` or
scatter-min): unsigned order is signed order after flipping the sign bit.
Pixel layout is flat row-major pixel = x + width*y, like the reference.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import constants as C
from .. import kernels
from ..config import EngineConfig, Uniforms
from ..octree.structures import OctreeState
from ..ops import morton, ragged
from ..ops.segments import I32_MIN, device_constant, iota


def u32(v: int) -> int:
    """An unsigned 32-bit constant as its int32 bit pattern."""
    return v - (1 << 32) if v >= (1 << 31) else v


class Samples(NamedTuple):
    """Column-form sample set. node_fn/level_fn are thunks: only the debug colour
    modes (colorByNode / colorByLOD) evaluate them."""
    x: torch.Tensor       # [S] f32 world positions
    y: torch.Tensor
    z: torch.Tensor
    rgba: torch.Tensor    # [S] i32 (u32 bit pattern)
    node_fn: object
    level_fn: object
    valid: torch.Tensor   # [S] bool
    count: torch.Tensor   # i32


POINTS, VOXELS = 0, 1


class SampleSource(NamedTuple):
    """One sample set where it lies: the block plan of its ragged gather over
    pool columns, and what decoding and the debug colour modes read. Points
    carry Morton words (c0, c1, c2 = w0, w1, w2), voxels global prefix keys
    (k0, k1, k2l); a sample's node is seg_node[segment], or the segment id
    itself where seg_node is None (per-node CSR directories)."""
    kind: int                        # POINTS or VOXELS
    plan: ragged.BlockPlan
    c0: torch.Tensor                 # [P] i32 pool columns
    c1: torch.Tensor
    c2: torch.Tensor
    rgba: torch.Tensor               # [P] i32 (u32 bit pattern)
    seg_node: torch.Tensor | None    # [S] i32
    level: torch.Tensor              # [N] i32 node levels (points' LOD colour)
    box_min: torch.Tensor            # [3] f32
    cube_size: torch.Tensor          # f32
    show: torch.Tensor | None        # bool: the frame's show_points (None: on)
    count: torch.Tensor              # i32 samples in the window


def point_source(state: OctreeState, plan: ragged.BlockPlan, w0, w1, w2, rgba,
                 seg_node, count) -> SampleSource:
    return SampleSource(POINTS, plan, w0, w1, w2, rgba, seg_node, state.level,
                        state.box_min, state.cube_size, None, count)


def voxel_source(state: OctreeState, plan: ragged.BlockPlan, k0, k1, k2l,
                 rgba, count) -> SampleSource:
    return SampleSource(VOXELS, plan, k0, k1, k2l, rgba, None, state.level,
                        state.box_min, state.cube_size, None, count)


def point_spec(cfg: EngineConfig, state: OctreeState, emitted: torch.Tensor,
               window: int | None = None) -> tuple:
    """The ragged.plan_blocks_many spec of a frame's point samples: the live
    segments of emitted nodes (selected through seg_node) in a dense window
    of (window or max_render_points) rounded down to 128 rows."""
    W = ((window or cfg.max_render_points) // 128) * 128
    return (state.seg_off, state.seg_cnt, W, emitted, state.seg_node)


def state_point_source(state: OctreeState,
                       plan: ragged.BlockPlan) -> SampleSource:
    """The point samples of a point_spec plan, over the octree's columns."""
    return point_source(state, plan, state.pt_w0, state.pt_w1, state.pt_w2,
                        state.pt_rgba, state.seg_node, plan.count)


def gather_point_samples(cfg: EngineConfig, state: OctreeState,
                         emitted: torch.Tensor,
                         window: int | None = None) -> Samples:
    """The emitted nodes' point samples in a dense window, gathered into
    column-form Samples (the JAX function of this name): point_spec, its
    block plan, state_point_source, materialize. The frame paths keep the
    source and let the splat kernel read it where it lies."""
    plan = ragged.plan_blocks(*point_spec(cfg, state, emitted, window))
    return materialize(state_point_source(state, plan))


def voxel_positions_from_keys(box_min, cube_size, k0, k1, k2l):
    """Voxel cell-center world positions from global prefix keys; float op order
    matches the reference (sampleVoxel voxels.cu:103-115). Returns (x, y, z,
    level)."""
    lvl = k2l & 31
    qx, qy, qz = morton.decode(k0, k1, k2l & ~31)
    shift = torch.clamp((C.MAX_DEPTH + 1) - lvl, 0, C.FULL_GRID_BITS)
    px, py, pz = qx >> shift, qy >> shift, qz >> shift
    m = C.GRID_SIZE - 1
    f32 = torch.float32
    size = cube_size / torch.exp2(lvl.to(f32))
    g = float(C.GRID_SIZE)
    x = ((px >> C.GRID_BITS).to(f32) * size
         + box_min[0]) + size * (((px & m).to(f32) + 0.5) / g)
    y = ((py >> C.GRID_BITS).to(f32) * size
         + box_min[1]) + size * (((py & m).to(f32) + 0.5) / g)
    z = ((pz >> C.GRID_BITS).to(f32) * size
         + box_min[2]) + size * (((pz & m).to(f32) + 0.5) / g)
    return x, y, z, lvl


def voxel_spec(cfg: EngineConfig, state: OctreeState, emitted: torch.Tensor,
               window: int | None = None) -> tuple:
    """The ragged.plan_blocks_many spec of a frame's voxel samples: emitted
    nodes' voxel ranges (compacted CSR) in a dense window of (window or
    max_render_voxels) rounded down to 128 rows."""
    W = ((window or cfg.max_render_voxels) // 128) * 128
    return (state.vox_voff, state.vox_vcnt, W, emitted, None)


def state_voxel_source(state: OctreeState,
                       plan: ragged.BlockPlan) -> SampleSource:
    """The voxel samples of a voxel_spec plan, over the octree's columns;
    positions are the cell centers of the global prefix keys."""
    return voxel_source(state, plan, state.vox_k0, state.vox_k1,
                        state.vox_k2l, state.vox_rgba, plan.count)


def gather_voxel_samples(cfg: EngineConfig, state: OctreeState,
                         emitted: torch.Tensor,
                         window: int | None = None) -> Samples:
    """gather_point_samples for the emitted nodes' voxels (voxel_spec,
    state_voxel_source)."""
    plan = ragged.plan_blocks(*voxel_spec(cfg, state, emitted, window))
    return materialize(state_voxel_source(state, plan))


class VoxelTail(NamedTuple):
    """The voxel store's tail, the rows [vox_compacted, vox_used) appended
    since the last compaction, grouped by the node each row belongs to: the
    inner node at the row's level on the path of its emitting leaf
    (anc[vox_node, level], the node compaction would resolve it to). The
    compacted CSR (vox_voff, vox_vcnt) does not reach these rows; a frame
    draws them through this per-node CSR of its own, so that every stored
    voxel of a drawn node is drawn, duplicates of a cell included, as the
    reference's insertVoxels makes each new voxel drawable at once."""
    k0: torch.Tensor        # [T] i32 rows in node order
    k1: torch.Tensor
    k2l: torch.Tensor
    rgba: torch.Tensor      # [T] i32 (u32 bit pattern)
    voff: torch.Tensor      # [N] i32 each node's first row in the tail
    vcnt: torch.Tensor      # [N] i32 and its row count


def tail_buffers(state: OctreeState) -> VoxelTail:
    """Columns of the store's rows and a directory of the node slots for
    voxel_tail to write a state's tail into: a frame drawn from them reads
    the same tensors every frame, so a recorded frame replays."""
    rows, nodes = state.vox_k0.shape[0], state.child_base.shape[0]
    col = lambda n: torch.zeros(n, dtype=torch.int32, device=state.device)
    return VoxelTail(col(rows), col(rows), col(rows), col(rows), col(nodes),
                     col(nodes))


def voxel_tail(state: OctreeState, compacted: int, used: int,
               out: VoxelTail | None = None) -> VoxelTail | None:
    """The VoxelTail of `state` for its watermarks vox_compacted and
    vox_used as read by the caller, in tensors of its own or written into
    `out` (tail_buffers of the state: its columns' rows past the tail keep
    what they held); None when the tail is empty. A stable sort of the tail
    rows by node, four gathers of them, and each node's range found by
    binary search in the sorted nodes: the rows' bytes, whatever the frame
    draws."""
    if used <= compacted:
        return None
    rows = slice(compacted, used)
    k2l = state.vox_k2l[rows]
    node = state.anc[state.vox_node[rows] * (C.MAX_DEPTH + 1) + (k2l & 31)]
    node, order = torch.sort(node, stable=True)
    ids = iota(state.child_base.shape[0], state.device)
    cols = (state.vox_k0, state.vox_k1, state.vox_k2l, state.vox_rgba)
    if out is None:
        voff = torch.searchsorted(node, ids, out_int32=True)
        vcnt = torch.searchsorted(node, ids, right=True, out_int32=True) \
            - voff
        return VoxelTail(*(torch.index_select(c[rows], 0, order)
                           for c in cols), voff, vcnt)
    n = used - compacted
    for c, dst in zip(cols, out[:4]):
        torch.index_select(c[rows], 0, order, out=dst[:n])
    torch.searchsorted(node, ids, out_int32=True, out=out.voff)
    torch.searchsorted(node, ids, right=True, out_int32=True, out=out.vcnt)
    out.vcnt.sub_(out.voff)
    return out


def tail_spec(cfg: EngineConfig, tail: VoxelTail, emitted: torch.Tensor,
              window: int | None = None) -> tuple:
    """The ragged.plan_blocks_many spec of a frame's tail voxel samples:
    emitted nodes' tail ranges in a dense window of (window or
    max_render_voxels) rounded down to 128 rows (voxel_spec over the
    tail's CSR, cut to the frame's node window)."""
    W = ((window or cfg.max_render_voxels) // 128) * 128
    n = emitted.shape[0]
    return (tail.voff[:n], tail.vcnt[:n], W, emitted, None)


def tail_voxel_source(state: OctreeState, tail: VoxelTail,
                      plan: ragged.BlockPlan) -> SampleSource:
    """The voxel samples of a tail_spec plan, over the tail's columns."""
    return voxel_source(state, plan, tail.k0, tail.k1, tail.k2l, tail.rgba,
                        plan.count)


def materialize(s) -> Samples:
    """A source gathered into column-form Samples (Samples pass through):
    the plain version of what the splat kernel reads in registers."""
    if isinstance(s, Samples):
        return s
    p = ragged.expand(s.plan)
    c0, c1, c2, rgba = (ragged.gather_column(p, c)
                        for c in (s.c0, s.c1, s.c2, s.rgba))
    if s.kind == POINTS:
        x, y, z = morton.dequantize_cols(*morton.decode(c0, c1, c2),
                                         s.box_min, s.cube_size)
    else:
        x, y, z, lvl = voxel_positions_from_keys(s.box_min, s.cube_size,
                                                 c0, c1, c2)
    zero = torch.zeros((), dtype=torch.int32, device=rgba.device)

    def node_fn():
        node = p.seg_of if s.seg_node is None \
            else ragged.broadcast_i32(p, s.seg_node)
        return torch.where(p.valid, node, zero)

    def level_fn():
        return s.level[node_fn().long()] if s.kind == POINTS else lvl

    valid = p.valid if s.show is None else p.valid & s.show
    return Samples(x=x, y=y, z=z, rgba=rgba, node_fn=node_fn,
                   level_fn=level_fn, valid=valid, count=s.count)


def _lod_color(level: torch.Tensor) -> torch.Tensor:
    """Spectral LOD palette (reference render.cu:49-59)."""
    idx = torch.clamp(((8.0 - level.to(torch.float32)) * 1.8).to(torch.int32),
                      0, 7)
    pal = device_constant(C.SPECTRAL, torch.int32, level.device)
    return pal[idx.long()]


def _sample_colors(s: Samples, uniforms: Uniforms) -> torch.Tensor:
    """Debug colour modes; their node/level gathers run only when one is on
    (the switches are the host flags: no device read)."""
    f = uniforms.flags
    color = s.rgba
    if f.color_by_node:
        node = (s.node_fn() % 127).to(torch.int64)
        color = u32_bits((node * 123456789) & 0xFFFFFFFF)
    if f.color_by_lod:
        color = _lod_color(s.level_fn())
    if f.color_white:
        color = torch.full_like(s.rgba, 0x00FFFFFF)
    return color


def u32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same low 32 bits."""
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def _project(s: Samples, uniforms: Uniforms):
    """Project samples; returns (x, y, depth, ok) with the reference's window
    guard x in (1, width-2), y in (1, height-2), depth > 0 (render.cu:290-298)."""
    m = uniforms.transform
    ndc0 = s.x * m[0, 0] + s.y * m[0, 1] + s.z * m[0, 2] + m[0, 3]
    ndc1 = s.x * m[1, 0] + s.y * m[1, 1] + s.z * m[1, 2] + m[1, 3]
    wdepth = s.x * m[3, 0] + s.y * m[3, 1] + s.z * m[3, 2] + m[3, 3]
    sx = (ndc0 / wdepth * 0.5 + 0.5) * uniforms.width
    sy = (ndc1 / wdepth * 0.5 + 0.5) * uniforms.height
    x = sx.to(torch.int32)
    y = sy.to(torch.int32)
    ok = (s.valid & (x > 1) & (x.to(torch.float32) < uniforms.width - 2.0)
          & (y > 1) & (y.to(torch.float32) < uniforms.height - 2.0)
          & (wdepth > 0.0))
    return x, y, wdepth, ok


def _splat_pixels(x, y, ok, uniforms, width: int, height: int,
                  max_point_size: int = 1):
    """(pixel, mask) for each of the point_size x point_size splat offsets."""
    out = []
    for ox in range(max_point_size):
        for oy in range(max_point_size):
            use = ok & (ox < uniforms.point_size) & (oy < uniforms.point_size)
            px = torch.clamp(x + ox, 0, width - 1)
            py = torch.clamp(y + oy, 0, height - 1)
            out.append((px + width * py, use))
    return out


def splat_columns(cfg: EngineConfig, uniforms: Uniforms, width: int,
                  height: int, sample_sets, unused: int):
    """Project the sample sets and expand every splat offset into one row.

    Returns (pix, dbits, color), int32 [S] each, S = rows of all sets times
    max_point_size^2; a row that draws nothing has pix == `unused` and +inf
    depth bits. Sources are materialized first."""
    pixs, dbits, colors = [], [], []
    for s in map(materialize, sample_sets):
        x, y, d, ok = _project(s, uniforms)
        db = d.view(torch.int32)
        col = _sample_colors(s, uniforms)
        for pix, use in _splat_pixels(x, y, ok, uniforms, width, height,
                                      cfg.max_point_size):
            pixs.append(torch.where(use, pix, unused))
            dbits.append(torch.where(use, db, C.DEPTH_INF_BITS))
            colors.append(col)
    return torch.cat(pixs), torch.cat(dbits), torch.cat(colors)


def splat_resolve_reference(pix: torch.Tensor, dbits: torch.Tensor,
                            color: torch.Tensor, mode: torch.Tensor, npx: int):
    """Plain PyTorch version of the splat kernel: the scatter-based drawing
    stage of the JAX package's raster.rasterize over the columns of
    `splat_columns` (rows with pix == npx draw nothing). Returns (color i32
    [npx] (u32 bits), depth bits i32 [npx]) with background where uncovered
    (clear values per render.cu:1126-1131)."""
    dev = pix.device
    # pass 1: depth (scatter-min of positive-float bits behaves like float min)
    fbd = torch.full((npx + 1,), C.DEPTH_INF_BITS, dtype=torch.int32,
                     device=dev)
    fbd.scatter_reduce_(0, pix.long(), dbits, "amin")
    fbd = fbd[:npx]
    drawn = pix < npx
    at = pix.clamp(max=npx - 1).long()
    if bool(mode.reshape(()) == 1):
        accept = drawn & (dbits.view(torch.float32)
                          < fbd.view(torch.float32)[at] * 1.01)
        c = color.to(torch.int64)
        rgb1 = torch.stack([c & 0xFF, (c >> 8) & 0xFF, (c >> 16) & 0xFF,
                            torch.ones_like(c)], -1)
        acc = torch.zeros((npx + 1, 4), dtype=torch.int64, device=dev)
        acc.index_add_(0, torch.where(accept, pix, npx).long(), rgb1)
        acc = acc[:npx]
        cnt = acc[:, 3].clamp(min=1)
        packed = ((acc[:, 0] // cnt) | ((acc[:, 1] // cnt) << 8)
                  | ((acc[:, 2] // cnt) << 16) | 0xFF000000)
        out = torch.where(acc[:, 3] > 0, u32_bits(packed),
                          torch.full_like(fbd, C.BACKGROUND_COLOR))
    else:
        # winner colour: unsigned min == signed min of the sign-flipped bits
        eq = drawn & (dbits == fbd[at])
        cmin = torch.full((npx + 1,), u32(0xFFFFFFFF) ^ I32_MIN,
                          dtype=torch.int32, device=dev)
        cmin.scatter_reduce_(0, torch.where(eq, pix, npx).long(),
                             color ^ I32_MIN, "amin")
        out = torch.where(fbd < C.DEPTH_INF_BITS, cmin[:npx] ^ I32_MIN,
                          torch.full_like(fbd, C.BACKGROUND_COLOR))
    return out, fbd


@kernels.counted
def splat_resolve(pix: torch.Tensor, dbits: torch.Tensor, color: torch.Tensor,
                  mode: torch.Tensor, npx: int):
    """The CUDA splat kernel (csrc/raster_splat.cu) on CUDA tensors; raises for
    anything else. Same arguments and result as splat_resolve_reference.

    It replaces the sort, the prepass and the tile resolve of
    render/raster_tiles.py (the port of the Pallas kernel at
    simlod_tpu/render/raster_tiles.py:237) with the reference's own design:
    a 64-bit atomicMin per row into an L2-resident depth|colour buffer, then
    (HQS) a 64-bit atomicAdd of the accepted rows' colour sums. It is bound by
    memory: 12 B read per row, 8 B written per pixel. The rows of one pixel
    within a warp are merged before their atomic. Each call adds one to
    `splat_resolve.launches`."""
    tensors = (("pix", pix), ("dbits", dbits), ("color", color), ("mode", mode))
    for name, t in tensors:
        if not t.is_cuda:
            raise ValueError(f"splat_resolve: {name} is on {t.device}; the "
                             "kernel takes CUDA tensors (splat_resolve_reference"
                             " is the plain version)")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"splat_resolve: {name} must be contiguous int32")
        if t.device != pix.device:
            raise ValueError("splat_resolve: tensors on different devices")
    if pix.ndim != 1 or dbits.shape != pix.shape or color.shape != pix.shape:
        raise ValueError("splat_resolve: pix, dbits and color must be [S]")
    if mode.shape != (1,):
        raise ValueError("splat_resolve: mode must be [1]")
    if not 0 < npx < (1 << 31) or pix.shape[0] >= (1 << 31):
        raise ValueError("splat_resolve: npx and S must be int32 (npx > 0)")
    lib = kernels.load()
    dev = pix.device
    fb = torch.empty(npx, dtype=torch.int64, device=dev)
    acc = torch.empty(2 * npx, dtype=torch.int64, device=dev)
    out = torch.empty(npx, dtype=torch.int32, device=dev)
    depth = torch.empty_like(out)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.simlod_splat_resolve(
            pix.data_ptr(), dbits.data_ptr(), color.data_ptr(), pix.shape[0],
            mode.data_ptr(), npx, fb.data_ptr(),
            acc.data_ptr(), out.data_ptr(), depth.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"splat_resolve: kernel launch failed (cudaError {rc})")
    splat_resolve.launches += 1
    return out, depth


def splat_samples_reference(cfg: EngineConfig, uniforms: Uniforms, width: int,
                            height: int, sample_sets):
    """Plain PyTorch version of the splat_samples kernel: materialize +
    splat_columns + splat_resolve_reference (sources or Samples)."""
    npx = width * height
    pix, dbits, color = splat_columns(cfg, uniforms, width, height,
                                      sample_sets, npx)
    mode = uniforms.use_high_quality_shading.to(torch.int32).reshape(1)
    return splat_resolve_reference(pix, dbits, color, mode, npx)


# SampleSource fields -> the kernel's per-set descriptor (csrc/raster_splat.cu
# `SetDesc`: three int64 then fifteen pointers, in this order)
_PLAN_FIELDS = (("src_row", torch.int32), ("pstart_r", torch.int32),
                ("pend_r", torch.int32), ("r_ok", torch.bool),
                ("sr", torch.int32))
MAX_SETS = 8
# Uniforms.flags colour modes -> the kernel's colour_mode bits
COLOR_BY_NODE, COLOR_BY_LOD, COLOR_WHITE = 1, 2, 4


def _checked(t: torch.Tensor, what: str, dtype, dev, shape=None) -> int:
    return kernels.data_ptr(t, "splat_samples", what, dtype, dev, shape)


@kernels.counted
def splat_samples(cfg: EngineConfig, uniforms: Uniforms, width: int,
                  height: int, sources):
    """The CUDA kernel csrc/raster_splat.cu (`simlod_splat_samples`) on
    SampleSources of CUDA tensors; raises for anything else. Same arguments
    and result as splat_samples_reference, bit for bit.

    It replaces the sort, the prepass and the tile resolve of the JAX
    package's TPU path (the Pallas kernel at simlod_tpu/render/raster_tiles.py
    :237) and the port's gather -> Morton decode -> projection -> columns ->
    splat_resolve chain: one walk over the 128-row blocks of every set's
    plan reads each sample's 16 B where it lies, decodes, projects and
    splats it in registers (the reference's kernel_render). Bound by memory:
    16 B per drawn row (read twice with HQS), the plan, 8 B per pixel.
    Each call adds one to `splat_samples.launches`."""
    if not sources or len(sources) > MAX_SETS:
        raise ValueError(f"splat_samples: 1 to {MAX_SETS} sample sets")
    if not all(isinstance(s, SampleSource) for s in sources):
        raise ValueError("splat_samples: the kernel takes SampleSource sets "
                         "(column-form Samples go to splat_samples_reference "
                         "or splat_columns + splat_resolve)")
    dev = sources[0].c0.device
    npx = width * height
    if not 0 < npx < (1 << 31):
        raise ValueError("splat_samples: width * height must be an int32 > 0")
    i32, f32 = torch.int32, torch.float32
    scales = {}
    desc = []
    for k, s in enumerate(sources):
        name = f"set {k}"
        pool = s.c0.shape[0]
        cols = [_checked(c, f"{name} column {i}", i32, dev, (pool,))
                for i, c in enumerate((s.c0, s.c1, s.c2, s.rgba))]
        WR = s.plan.out_len // 128
        plan = [_checked(getattr(s.plan, f), f"{name} plan.{f}", dt, dev, (WR,))
                for f, dt in _PLAN_FIELDS]
        seg = 0 if s.seg_node is None else _checked(
            s.seg_node, f"{name} seg_node", i32, dev)
        show = 0 if s.show is None else _checked(s.show, f"{name} show",
                                                 torch.bool, dev, ())
        key = (s.cube_size.data_ptr(), s.kind)
        if key not in scales:
            # the plain version's own expressions (dequantize_cols,
            # voxel_positions_from_keys), evaluated once by torch
            _checked(s.cube_size, f"{name} cube_size", f32, dev, ())
            scales[key] = (s.cube_size.to(f32) / float(1 << C.FULL_GRID_BITS)
                           if s.kind == POINTS else s.cube_size / torch.exp2(
                               torch.arange(32, dtype=f32, device=dev)))
        scale = scales[key]
        desc += [s.kind, WR, pool, *plan, *cols, seg,
                 _checked(s.level, f"{name} level", i32, dev),
                 show, _checked(s.box_min, f"{name} box_min", f32, dev, (3,)),
                 scale.data_ptr() if s.kind == POINTS else 0,
                 scale.data_ptr() if s.kind == VOXELS else 0]
    u = uniforms
    flags = u.flags
    mode = (COLOR_BY_NODE * flags.color_by_node
            | COLOR_BY_LOD * flags.color_by_lod | COLOR_WHITE * flags.color_white)
    uni = [_checked(u.transform, "transform", f32, dev, (4, 4)),
           _checked(u.width, "width", f32, dev, ()),
           _checked(u.height, "height", f32, dev, ()),
           _checked(u.point_size, "point_size", i32, dev, ()),
           _checked(u.use_high_quality_shading, "use_high_quality_shading",
                    torch.bool, dev, ())]
    lib = kernels.load()
    fb = torch.empty(npx, dtype=torch.int64, device=dev)
    acc = torch.empty(2 * npx, dtype=torch.int64, device=dev)
    out = torch.empty(npx, dtype=i32, device=dev)
    depth = torch.empty_like(out)
    table = (ctypes.c_int64 * len(desc))(*desc)
    kernels.check_launch(lib.simlod_splat_samples(
        table, len(sources), *uni, width, height, cfg.max_point_size, mode,
        fb.data_ptr(), acc.data_ptr(), out.data_ptr(), depth.data_ptr(),
        dev.index, kernels.stream(dev)), "splat_samples")
    splat_samples.launches += 1
    return out, depth


def _device(s) -> torch.device:
    return (s.x if isinstance(s, Samples) else s.c0).device


def rasterize(cfg: EngineConfig, uniforms: Uniforms, width: int, height: int,
              sample_sets):
    """The drawing stage over one or more sample sets: the splat_samples
    kernel for CUDA tensors, its plain version for CPU tensors.

    Returns (color i32 [H*W] (u32 bits), depth_bits i32 [H*W]) with background
    where uncovered (clear values per render.cu:1126-1131)."""
    draw = splat_samples if _device(sample_sets[0]).type == "cuda" \
        else splat_samples_reference
    return draw(cfg, uniforms, width, height, sample_sets)


def edl(color: torch.Tensor, depth_bits: torch.Tensor, uniforms: Uniforms,
        width: int, height: int) -> torch.Tensor:
    """Eye-dome lighting post-process (reference render.cu:1255-1325), when
    the frame's enable_edl flag is on: the CUDA kernel `edl_cuda` for CUDA
    tensors, its plain version `edl_reference` for CPU tensors."""
    if not uniforms.flags.enable_edl:
        return color
    impl = edl_cuda if color.is_cuda else edl_reference
    return impl(color, depth_bits, uniforms, width, height)


def edl_reference(color: torch.Tensor, depth_bits: torch.Tensor,
                  uniforms: Uniforms, width: int, height: int) -> torch.Tensor:
    """Plain PyTorch version of the EDL kernel.

    response = sum over 4 neighbours of max(log2(d) - log2(d_n), 0) / 50;
    shade = exp(-response * 300 * edlStrength). Background pairs give inf - inf =
    NaN, which CUDA's fmaxf treats as 0."""
    if not uniforms.flags.enable_edl:
        return color
    d = depth_bits.view(torch.float32).reshape(height, width)
    logd = torch.log2(d)
    resp = torch.zeros_like(logd)
    for dx, dy in ((0, 1), (1, 0), (0, -1), (-1, 0)):
        shifted = torch.roll(logd, shifts=(-dy, -dx), dims=(0, 1))
        diff = logd - shifted
        diff = torch.where(torch.isnan(diff), 0.0, torch.clamp(diff, min=0.0))
        resp = resp + diff
    resp = resp / 50.0
    shade = torch.exp(-resp * 300.0 * uniforms.edl_strength).reshape(-1)
    c = color.to(torch.int64) & 0xFFFFFFFF
    ch = lambda k: ((((c >> (8 * k)) & 0xFF).to(torch.float32) * shade)
                    .to(torch.int64))
    return u32_bits(ch(0) | (ch(1) << 8) | (ch(2) << 16) | 0xFF000000)


@kernels.counted
def edl_cuda(color: torch.Tensor, depth_bits: torch.Tensor,
             uniforms: Uniforms, width: int, height: int) -> torch.Tensor:
    """The CUDA kernel csrc/frame.cu (`simlod_edl`) on CUDA tensors; raises
    for anything else. Same arguments and result as edl_reference (EDL on),
    bit for bit where libdevice's log2f / expf round as torch's CUDA log2 /
    exp do (they are the same functions).

    It replaces the plain version's ~35 launches (log2, four rolls and
    clamped differences, the shade, three channels), which XLA fuses in the
    JAX package's jitted frame (raster.edl, simlod_tpu/render/raster.py
    :259): one launch of 128 x 8-pixel tiles, 4 pixels a thread, each block
    computing log2 of its tile's depths and a wrapping one-pixel halo (as
    torch.roll) once, in shared memory. Bound by memory: 12 B a pixel. The
    strength is read on the device (`uniforms.edl_strength`), so the launch
    takes no per-frame value. Each call adds one to `edl_cuda.launches`."""
    npx = width * height
    dev = color.device
    if not 0 < npx < (1 << 31):
        raise ValueError("edl_cuda: width * height must be an int32 > 0")
    where, i32 = "edl_cuda", torch.int32
    c = kernels.data_ptr(color, where, "color", i32, dev, (npx,))
    d = kernels.data_ptr(depth_bits, where, "depth_bits", i32, dev, (npx,))
    s = kernels.data_ptr(uniforms.edl_strength, where, "edl_strength",
                         torch.float32, dev, ())
    out = torch.empty(npx, dtype=i32, device=dev)
    kernels.check_launch(kernels.load().simlod_edl(
        c, d, width, height, s, out.data_ptr(), dev.index,
        kernels.stream(dev)), where)
    edl_cuda.launches += 1
    return out
