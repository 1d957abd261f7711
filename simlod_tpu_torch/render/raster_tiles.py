"""Tile-binned sort-based rasterizer (port of simlod_tpu/render/raster_tiles.py).

Taken with `EngineConfig(use_tile_raster=True)`; frames go through
render/raster.py's splat kernel by default, as the JAX package takes its tile
path only on a TPU (simlod_tpu/render/render.py:89).

  1. materialize the sample sources and project all samples -> (pixel,
     depth bits, colour) (raster.splat_columns)                           [torch]
  2. sort by (pixel, depth bits[, colour]): each pixel's samples form one run whose
     first row is the reference's u64 atomicMin winner (min depth, then min
     colour: render.cu:95-99)                                             [torch]
  3. prepass: winner flag (run start), winner depth carried along the run, HQS
     accept test (depth < winner * 1.01, render.cu:487) resolved per mode; both
     bits ride the pixel word, so each sample is 4 int32 columns (16 B) [torch]
  4. per-tile row offsets from one searchsorted over tile boundaries      [torch]
  5. tile resolve: per 512-pixel tile, sum the contributing colour bytes and
     counts, take the winner's colour / depth bits, resolve each pixel.
     On CUDA tensors this is the hand-written kernel csrc/raster_tiles.cu
     (`tile_resolve`, which replaces the Pallas kernel of the JAX package);
     on CPU tensors the plain PyTorch version `tile_resolve_reference`.

Colours and packed words are int32 bit patterns throughout.
"""
from __future__ import annotations

import torch

from .. import constants as C
from .. import kernels
from ..config import EngineConfig, Uniforms
from ..ops.segments import I32_MIN, device_constant, take_last
from . import raster

TILE = 512           # framebuffer pixels per tile (the kernel's block)
WIN_BIT = 28         # this row is its pixel's u64-atomicMin winner
AM_BIT = 29          # this row contributes colour (mode already resolved)
PIX_MASK = (1 << WIN_BIT) - 1


def pack_samples(cfg: EngineConfig, uniforms: Uniforms, width: int, height: int,
                 sample_sets):
    """Steps 1-4: the packed, sorted sample stream of one frame.

    Returns (cols i32 [S, 4], offs i32 [n_tiles+1], mode i32 [1], n_tiles)."""
    npx = width * height
    n_tiles = (npx + TILE - 1) // TILE
    npad = n_tiles * TILE
    assert npad < (1 << WIN_BIT), (width, height)
    pix, db, col = raster.splat_columns(cfg, uniforms, width, height,
                                        sample_sets, npad)
    dev = pix.device

    # pixel (28 bits) and depth bits (31: positive floats and +inf) pack into one
    # int64 key; the exact tiebreak sorts by colour first (unsigned order = signed
    # order of the sign-flipped bits) and relies on the stable second pass
    key = (pix.to(torch.int64) << 31) | db.to(torch.int64)
    if cfg.raster_exact_tiebreak:
        order = torch.sort(col ^ I32_MIN, stable=True).indices
        order = order[torch.sort(key[order], stable=True).indices]
    else:
        order = torch.sort(key, stable=True).indices
    spix, sdb, scol = pix[order], db[order], col[order]

    valid = spix < npad
    win = spix != torch.roll(spix, 1, 0)
    win[:1].fill_(True)     # a fill: a captured frame copies nothing in
    win = win & valid
    wdb = take_last(torch.where(win, sdb, I32_MIN), sentinel=I32_MIN)
    wd = wdb.view(torch.float32)
    depth = sdb.view(torch.float32)
    accept = valid & (depth < wd * device_constant(1.01, torch.float32, dev))
    am = torch.where(uniforms.use_high_quality_shading, accept, win)
    f0 = spix | (win.to(torch.int32) << WIN_BIT) | (am.to(torch.int32) << AM_BIT)

    bounds = torch.arange(n_tiles + 1, dtype=torch.int32, device=dev) * TILE
    offs = torch.searchsorted(spix, bounds).to(torch.int32)
    cols = torch.stack([f0, sdb, scol, torch.zeros_like(f0)], dim=1).contiguous()
    mode = uniforms.use_high_quality_shading.to(torch.int32).reshape(1)
    return cols, offs, mode, n_tiles


def tile_resolve_reference(cols: torch.Tensor, offs: torch.Tensor,
                           mode: torch.Tensor, n_tiles: int):
    """Plain PyTorch version of the tile-resolve kernel (same sums, same
    resolve). Returns (color i32 [n_tiles*512] (u32 bits), depth i32)."""
    dev = cols.device
    npad = n_tiles * TILE
    S = cols.shape[0]
    f0, db, col = cols[:, 0], cols[:, 1], cols[:, 2]
    rows = torch.arange(S, dtype=torch.int32, device=dev)
    # a row counts for tile t only inside [offs[t], offs[t+1]) and only for a
    # pixel of that tile, exactly as the kernel walks the stream
    tile = torch.searchsorted(offs, rows, right=True).to(torch.int32) - 1
    pix = f0 & PIX_MASK
    mine = (tile >= 0) & (tile < n_tiles) & (pix >= tile * TILE) \
        & (pix < (tile + 1) * TILE)
    win = mine & (((f0 >> WIN_BIT) & 1) == 1)
    am = mine & (((f0 >> AM_BIT) & 1) == 1)
    hqs = (mode.reshape(()) == 1)
    cw = torch.where(hqs, am, win).to(torch.int64)
    wi = win.to(torch.int64)
    c64 = col.to(torch.int64) & 0xFFFFFFFF
    d64 = db.to(torch.int64) & 0xFFFFFFFF
    byte = lambda v, k: (v >> (8 * k)) & 0xFF
    vals = torch.stack([
        byte(c64, 0) * cw, byte(c64, 1) * cw, byte(c64, 2) * cw,
        torch.where(hqs, am.to(torch.int64), byte(c64, 3) * wi),
        byte(d64, 0) * wi, byte(d64, 1) * wi, byte(d64, 2) * wi,
        (byte(d64, 3) + torch.where(hqs, 0, 1)) * wi], dim=1)
    acc = torch.zeros((npad + 1, 8), dtype=torch.int64, device=dev)
    acc.index_add_(0, torch.where(mine, pix, npad).long(), vals)
    acc = acc[:npad]

    cnt = acc[:, 3]
    covered = torch.where(hqs, cnt, acc[:, 7]) > 0
    cntf = cnt.clamp(min=1).to(torch.float32)
    q8 = lambda k: (torch.floor(acc[:, k].to(torch.float32) / cntf)
                    .to(torch.int64) & 0xFF)
    hq_color = q8(0) | (q8(1) << 8) | (q8(2) << 16) | 0xFF000000
    b8 = lambda k: acc[:, k] & 0xFF
    pl_color = b8(0) | (b8(1) << 8) | (b8(2) << 16) | (b8(3) << 24)
    color = torch.where(hqs, hq_color, pl_color)
    db3 = torch.where(hqs, acc[:, 7], acc[:, 7] - 1) & 0xFF
    dbits = b8(4) | (b8(5) << 8) | (b8(6) << 16) | (db3 << 24)
    color = torch.where(covered, raster.u32_bits(color), C.BACKGROUND_COLOR)
    depth = torch.where(covered, raster.u32_bits(dbits), C.DEPTH_INF_BITS)
    return color.to(torch.int32), depth.to(torch.int32)


@kernels.counted
def tile_resolve(cols: torch.Tensor, offs: torch.Tensor, mode: torch.Tensor,
                 n_tiles: int):
    """The CUDA tile-resolve kernel (csrc/raster_tiles.cu) on CUDA tensors; raises
    for anything else. Returns (color i32 [n_tiles*512] (u32 bits), depth i32).

    Replaces the Pallas kernel of simlod_tpu/render/raster_tiles.py
    (`_make_kernel._kernel`, launched through the pallas_call at line 237). It
    is bound by memory: 12 B of each sample read (flags|pixel, depth bits,
    colour), 8 B written per pixel. The design reads each sample once with one
    16-byte load (the fourth word is padding), keeps every per-pixel sum in
    shared memory (one block per 512-pixel tile) and writes each pixel once.
    Each launch adds one to `tile_resolve.launches`."""
    for name, t in (("cols", cols), ("offs", offs), ("mode", mode)):
        if not t.is_cuda:
            raise ValueError(f"tile_resolve: {name} is on {t.device}; the kernel "
                             "takes CUDA tensors (tile_resolve_reference is the "
                             "plain version)")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"tile_resolve: {name} must be contiguous int32")
        if t.device != cols.device:
            raise ValueError("tile_resolve: tensors on different devices")
    if cols.ndim != 2 or cols.shape[1] != 4 or cols.data_ptr() % 16:
        raise ValueError("tile_resolve: cols must be a 16-byte aligned [S, 4]")
    if offs.shape != (n_tiles + 1,) or mode.shape != (1,):
        raise ValueError("tile_resolve: offs must be [n_tiles + 1], mode [1]")
    if cols.shape[0] >= (1 << 31):
        raise ValueError("tile_resolve: more than 2^31 - 1 samples")
    lib = kernels.load()
    color = torch.empty(n_tiles * TILE, dtype=torch.int32, device=cols.device)
    depth = torch.empty_like(color)
    with torch.cuda.device(cols.device):
        stream = torch.cuda.current_stream(cols.device).cuda_stream
        rc = lib.simlod_tile_resolve(cols.data_ptr(), offs.data_ptr(),
                                     mode.data_ptr(), n_tiles,
                                     color.data_ptr(), depth.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"tile_resolve: kernel launch failed (cudaError {rc})")
    tile_resolve.launches += 1
    return color, depth


def rasterize_tiles(cfg: EngineConfig, uniforms: Uniforms, width: int,
                    height: int, sample_sets):
    """Drop-in replacement for raster.rasterize: (color i32 [H*W] (u32 bits),
    depth bits i32 [H*W]). The tile resolve runs as the CUDA kernel for CUDA
    tensors and as its plain version for CPU tensors."""
    cols, offs, mode, n_tiles = pack_samples(cfg, uniforms, width, height,
                                             sample_sets)
    resolve = tile_resolve if cols.is_cuda else tile_resolve_reference
    color, depth = resolve(cols, offs, mode, n_tiles)
    npx = width * height
    return color[:npx], depth[:npx]
