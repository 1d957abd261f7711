"""Software point/voxel rasterization (port of simlod_tpu/render/raster.py).

Sample gathering (ragged segment / voxel-CSR expansion), projection, and the
scatter-based framebuffer: a scatter-min of f32 depth bits, then either an HQS
accumulate (depth < closest*1.01, render.cu:487-493) or the plain winner by
colour scatter-min. The scatter path stays as the oracle and for
`use_tile_raster=False`; frames normally go through render/raster_tiles.py.

Colours and packed words are int32 bit patterns (torch has no uint32 `>>` or
scatter-min): unsigned order is signed order after flipping the sign bit.
Pixel layout is flat row-major pixel = x + width*y, like the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as C
from ..config import EngineConfig, Uniforms
from ..octree.structures import OctreeState
from ..ops import morton, ragged
from ..ops.segments import I32_MIN, scatter_drop


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
    """Debug colour modes; their node/level gathers run only when one is on."""
    if not bool(uniforms.color_by_node | uniforms.color_by_lod
                | uniforms.color_white):
        return s.rgba
    color = s.rgba
    if bool(uniforms.color_by_node):
        node = (s.node_fn() % 127).to(torch.int64)
        color = u32_bits((node * 123456789) & 0xFFFFFFFF)
    if bool(uniforms.color_by_lod):
        color = _lod_color(s.level_fn())
    if bool(uniforms.color_white):
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


def rasterize(cfg: EngineConfig, uniforms: Uniforms, width: int, height: int,
              sample_sets: list[Samples]):
    """Scatter-based drawing stage over one or more sample sets.

    Returns (color i32 [H*W] (u32 bits), depth_bits i32 [H*W]) with background
    where uncovered (clear values per render.cu:1126-1131)."""
    npx = width * height
    dev = sample_sets[0].x.device
    projected = []
    for s in sample_sets:
        x, y, d, ok = _project(s, uniforms)
        projected.append((x, y, d.view(torch.int32), d,
                          _sample_colors(s, uniforms), ok))

    # pass 1: depth (scatter-min of positive-float bits behaves like float min)
    fbd = torch.full((npx + 1,), C.DEPTH_INF_BITS, dtype=torch.int32,
                     device=dev)
    for (x, y, dbits, d, color, ok) in projected:
        for pix, use in _splat_pixels(x, y, ok, uniforms, width, height,
                                      cfg.max_point_size):
            fbd.scatter_reduce_(0, torch.where(use, pix, npx).long(), dbits,
                                "amin")
    fbd = fbd[:npx]

    if bool(uniforms.use_high_quality_shading):
        fbd_f = fbd.view(torch.float32)
        acc = torch.zeros((npx, 4), dtype=torch.int64, device=dev)
        for (x, y, dbits, d, color, ok) in projected:
            for pix, use in _splat_pixels(x, y, ok, uniforms, width, height,
                                          cfg.max_point_size):
                accept = use & (d < fbd_f[pix.clamp(0, npx - 1).long()] * 1.01)
                c = color.to(torch.int64)
                rgb1 = torch.stack([c & 0xFF, (c >> 8) & 0xFF, (c >> 16) & 0xFF,
                                    torch.ones_like(c)], -1)
                scatter_drop(acc, torch.where(accept, pix, npx), rgb1,
                             accumulate=True)
        cnt = acc[:, 3].clamp(min=1)
        packed = ((acc[:, 0] // cnt) | ((acc[:, 1] // cnt) << 8)
                  | ((acc[:, 2] // cnt) << 16) | 0xFF000000)
        color = torch.where(acc[:, 3] > 0, u32_bits(packed),
                            torch.full_like(fbd, C.BACKGROUND_COLOR))
    else:
        # winner colour: unsigned min == signed min of the sign-flipped bits
        cmin = torch.full((npx + 1,), u32(0xFFFFFFFF) ^ I32_MIN,
                          dtype=torch.int32, device=dev)
        for (x, y, dbits, d, color, ok) in projected:
            for pix, use in _splat_pixels(x, y, ok, uniforms, width, height,
                                          cfg.max_point_size):
                eq = use & (dbits == fbd[pix.clamp(0, npx - 1).long()])
                cmin.scatter_reduce_(0, torch.where(eq, pix, npx).long(),
                                     color ^ I32_MIN, "amin")
        covered = fbd < C.DEPTH_INF_BITS
        color = torch.where(covered, cmin[:npx] ^ I32_MIN,
                            torch.full_like(fbd, C.BACKGROUND_COLOR))
    return color, fbd


def edl(color: torch.Tensor, depth_bits: torch.Tensor, uniforms: Uniforms,
        width: int, height: int) -> torch.Tensor:
    """Eye-dome lighting post-process (reference render.cu:1255-1325).

    response = sum over 4 neighbours of max(log2(d) - log2(d_n), 0) / 50;
    shade = exp(-response * 300 * edlStrength). Background pairs give inf - inf =
    NaN, which CUDA's fmaxf treats as 0."""
    if not bool(uniforms.enable_edl):
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
