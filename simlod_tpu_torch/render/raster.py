"""Software point/voxel rasterization (port of simlod_tpu/render/raster.py).

Sample gathering (ragged segment / voxel-CSR expansion), projection into one
(pixel, depth bits, colour) row per splat (`splat_columns`), and the drawing
stage of the reference (render.cu:95-99, 487-493): a u64 atomicMin of
(depth bits << 32 | colour) per pixel, then either an HQS accumulate (depth <
closest*1.01) or the plain winner's colour. On CUDA tensors that stage is the
hand-written kernel csrc/raster_splat.cu (`splat_resolve`); on CPU tensors it
is its plain PyTorch version `splat_resolve_reference` (scatter-mins and an
index_add). Frames go through `rasterize` unless `use_tile_raster` sends them
to render/raster_tiles.py.

Colours and packed words are int32 bit patterns (torch has no uint32 `>>` or
scatter-min): unsigned order is signed order after flipping the sign bit.
Pixel layout is flat row-major pixel = x + width*y, like the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as C
from .. import kernels
from ..config import EngineConfig, Uniforms
from ..octree.structures import OctreeState
from ..ops import morton, ragged
from ..ops.segments import I32_MIN


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


def gather_point_samples(cfg: EngineConfig, state: OctreeState,
                         emitted: torch.Tensor,
                         window: int | None = None) -> Samples:
    """Expand the live segments of emitted nodes into a dense sample window."""
    n_cap = state.child_base.shape[0]
    sn = state.seg_node
    ok = (state.seg_cnt > 0) & (sn >= 0) & emitted[sn.clamp(0, n_cap - 1).long()]
    zero = torch.zeros((), dtype=torch.int32, device=sn.device)
    counts = torch.where(ok, state.seg_cnt, zero)
    offs = torch.where(ok, state.seg_off, zero)
    W = ((window or cfg.max_render_points) // 128) * 128
    p = ragged.plan(offs, counts, W)
    qx, qy, qz = morton.decode(ragged.gather_column(p, state.pt_w0),
                               ragged.gather_column(p, state.pt_w1),
                               ragged.gather_column(p, state.pt_w2))
    x, y, z = morton.dequantize_cols(qx, qy, qz, state.box_min, state.cube_size)
    rgba = ragged.gather_column(p, state.pt_rgba)

    def node_fn():
        return torch.where(p.valid, ragged.broadcast_i32(p, sn), zero)

    def level_fn():
        return state.level[node_fn().long()]

    return Samples(x=x, y=y, z=z, rgba=rgba, node_fn=node_fn, level_fn=level_fn,
                   valid=p.valid,
                   count=torch.clamp(counts.sum(dtype=torch.int32), max=W))


def voxel_positions_from_keys(state: OctreeState, k0, k1, k2l):
    """Voxel cell-center world positions from global prefix keys; float op order
    matches the reference (sampleVoxel voxels.cu:103-115). Returns (x, y, z,
    level)."""
    lvl = k2l & 31
    qx, qy, qz = morton.decode(k0, k1, k2l & ~31)
    shift = torch.clamp((C.MAX_DEPTH + 1) - lvl, 0, C.FULL_GRID_BITS)
    px, py, pz = qx >> shift, qy >> shift, qz >> shift
    m = C.GRID_SIZE - 1
    f32 = torch.float32
    size = state.cube_size / torch.exp2(lvl.to(f32))
    g = float(C.GRID_SIZE)
    x = ((px >> C.GRID_BITS).to(f32) * size
         + state.box_min[0]) + size * (((px & m).to(f32) + 0.5) / g)
    y = ((py >> C.GRID_BITS).to(f32) * size
         + state.box_min[1]) + size * (((py & m).to(f32) + 0.5) / g)
    z = ((pz >> C.GRID_BITS).to(f32) * size
         + state.box_min[2]) + size * (((pz & m).to(f32) + 0.5) / g)
    return x, y, z, lvl


def gather_voxel_samples(cfg: EngineConfig, state: OctreeState,
                         emitted: torch.Tensor,
                         window: int | None = None) -> Samples:
    """Expand emitted nodes' voxel ranges (compacted CSR); positions are the
    cell centers decoded from the global prefix keys."""
    zero = torch.zeros((), dtype=torch.int32, device=emitted.device)
    counts = torch.where(emitted, state.vox_vcnt, zero)
    offs = torch.where(emitted, state.vox_voff, zero)
    W = ((window or cfg.max_render_voxels) // 128) * 128
    p = ragged.plan(offs, counts, W)
    k0 = ragged.gather_column(p, state.vox_k0)
    k1 = ragged.gather_column(p, state.vox_k1)
    k2l = ragged.gather_column(p, state.vox_k2l)
    rgba = ragged.gather_column(p, state.vox_rgba)
    x, y, z, lvl = voxel_positions_from_keys(state, k0, k1, k2l)

    def node_fn():
        ids = torch.arange(counts.shape[0], dtype=torch.int32,
                           device=counts.device)
        return torch.where(p.valid, ragged.broadcast_i32(p, ids), zero)

    return Samples(x=x, y=y, z=z, rgba=rgba, node_fn=node_fn,
                   level_fn=lambda: lvl, valid=p.valid,
                   count=torch.clamp(counts.sum(dtype=torch.int32), max=W))


def _lod_color(level: torch.Tensor) -> torch.Tensor:
    """Spectral LOD palette (reference render.cu:49-59)."""
    idx = torch.clamp(((8.0 - level.to(torch.float32)) * 1.8).to(torch.int32),
                      0, 7)
    pal = torch.tensor(C.SPECTRAL, dtype=torch.int32, device=level.device)
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
    depth bits."""
    pixs, dbits, colors = [], [], []
    for s in sample_sets:
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


splat_resolve.launches = 0


def rasterize(cfg: EngineConfig, uniforms: Uniforms, width: int, height: int,
              sample_sets: list[Samples]):
    """The drawing stage over one or more sample sets: the splat kernel for
    CUDA tensors, its plain version for CPU tensors.

    Returns (color i32 [H*W] (u32 bits), depth_bits i32 [H*W]) with background
    where uncovered (clear values per render.cu:1126-1131)."""
    npx = width * height
    pix, dbits, color = splat_columns(cfg, uniforms, width, height,
                                      sample_sets, npx)
    mode = uniforms.use_high_quality_shading.to(torch.int32).reshape(1)
    resolve = splat_resolve if pix.is_cuda else splat_resolve_reference
    return resolve(pix, dbits, color, mode, npx)


def edl(color: torch.Tensor, depth_bits: torch.Tensor, uniforms: Uniforms,
        width: int, height: int) -> torch.Tensor:
    """Eye-dome lighting post-process (reference render.cu:1255-1325).

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
