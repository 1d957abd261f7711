"""Morton (Z-order) utilities (port of simlod_tpu/ops/morton.py).

Coordinates are quantized to FULL_GRID_BITS = 28 bits per axis; a full code is 84
bits, carried as three int32 words ordered for lexicographic comparison:
w0 = levels 0..9 (30 bits), w1 = levels 10..19 (30 bits), w2 = levels 20..27
(24 bits). Octant convention childIndex = (x<<2)|(y<<1)|z.

Every word, coordinate and intermediate here stays below 2^31, so plain int32
arithmetic (and arithmetic `>>` on non-negative values) reproduces the JAX
package's uint32 math bit for bit.
"""
from __future__ import annotations

import torch

from .. import constants as C

WORD_LEVELS = (10, 10, 8)
assert sum(WORD_LEVELS) == C.FULL_GRID_BITS


def _spread3(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so bit i moves to bit 3*i."""
    v = v.to(torch.int32) & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _compact3(v: torch.Tensor) -> torch.Tensor:
    """Inverse of _spread3: gather bits 0,3,6,... into the low 10 bits."""
    v = v.to(torch.int32) & 0x09249249
    v = (v | (v >> 2)) & 0x030C30C3
    v = (v | (v >> 4)) & 0x0300F00F
    v = (v | (v >> 8)) & 0x030000FF
    v = (v | (v >> 16)) & 0x000003FF
    return v


def quantize(xyz, box_min, cube_size, bits: int = C.FULL_GRID_BITS):
    """[N, 3] float positions -> [N, 3] int32 grid coords in [0, 2^bits), in the
    JAX package's op order: divide by cube_size, then scale by 2^bits, floor,
    clamp (quantize_cols multiplies by 2^bits / cube_size and rounds
    differently). XLA's float -> int32 conversion saturates (NaN -> 0) and
    torch's is undefined out of range, so the floored floats are first held
    to [0, 2^bits] (exact in f32, unlike 2^bits - 1), NaN mapped to 0."""
    g = float(1 << bits)
    rel = (xyz - box_min.to(torch.float32)) / cube_size.to(torch.float32)
    q = torch.floor(rel * g).nan_to_num(0.0).clamp(0.0, g).to(torch.int32)
    return q.clamp(0, (1 << bits) - 1)


def quantize_cols(x, y, z, box_min, cube_size, bits: int = C.FULL_GRID_BITS):
    """Float positions -> integer grid coords in [0, 2^bits), truncating like the
    reference (progressive_octree_voxels.cu:148-156), clamped at the max edge."""
    g = torch.full((), float(1 << bits), dtype=torch.float32, device=x.device)
    inv = g / cube_size.to(torch.float32)
    hi = (1 << bits) - 1
    qx = torch.floor((x - box_min[0]) * inv).to(torch.int32).clamp(0, hi)
    qy = torch.floor((y - box_min[1]) * inv).to(torch.int32).clamp(0, hi)
    qz = torch.floor((z - box_min[2]) * inv).to(torch.int32).clamp(0, hi)
    return qx, qy, qz


def dequantize_cols(qx, qy, qz, box_min, cube_size,
                    bits: int = C.FULL_GRID_BITS):
    """Cell-center float positions of quantized grid coords."""
    s = cube_size.to(torch.float32) / float(1 << bits)
    x = box_min[0] + (qx.to(torch.float32) + 0.5) * s
    y = box_min[1] + (qy.to(torch.float32) + 0.5) * s
    z = box_min[2] + (qz.to(torch.float32) + 0.5) * s
    return x, y, z


def encode(qx, qy, qz):
    """Interleave 28-bit per-axis coords into 3 lexicographic int32 Morton words."""
    words = []
    hi = C.FULL_GRID_BITS
    for nlev in WORD_LEVELS:
        lo = hi - nlev
        m = (1 << nlev) - 1
        sx = (qx >> lo) & m
        sy = (qy >> lo) & m
        sz = (qz >> lo) & m
        words.append((_spread3(sx) << 2) | (_spread3(sy) << 1) | _spread3(sz))
        hi = lo
    return tuple(words)


def decode(w0, w1, w2):
    """Inverse of encode: back to 28-bit per-axis coords (int32)."""
    qx = torch.zeros_like(w0, dtype=torch.int32)
    qy = torch.zeros_like(qx)
    qz = torch.zeros_like(qx)
    hi = C.FULL_GRID_BITS
    for w, nlev in zip((w0, w1, w2), WORD_LEVELS):
        lo = hi - nlev
        # the JAX package reads the word as uint32; a negative word would need a
        # logical shift, but no caller decodes one (fill rows are INT32_MAX)
        qx = qx | (_compact3(w >> 2) << lo)
        qy = qy | (_compact3(w >> 1) << lo)
        qz = qz | (_compact3(w) << lo)
        hi = lo
    return qx, qy, qz


def octant_at_level(qx, qy, qz, level):
    """Octant index taken when descending from a node at `level`: bit
    (FULL_GRID_BITS - 1 - level) of each 28-bit coordinate, (x<<2)|(y<<1)|z."""
    shift = (C.FULL_GRID_BITS - 1) - level
    bx, by, bz = (qx >> shift) & 1, (qy >> shift) & 1, (qz >> shift) & 1
    return ((bx << 2) | (by << 1) | bz).to(torch.int32)


def cell_at_level(qx, qy, qz, level):
    """Packed 21-bit cell index (cx << 14) | (cy << 7) | cz of a point in a
    level-`level` node's 128^3 grid, c = (q >> (MAX_DEPTH + 1 - level)) & 127
    (the reference's sampleVoxel leveling)."""
    shift = (C.MAX_DEPTH + 1) - level
    m = C.GRID_SIZE - 1
    cx, cy, cz = (qx >> shift) & m, (qy >> shift) & m, (qz >> shift) & m
    return ((cx << (2 * C.GRID_BITS)) | (cy << C.GRID_BITS)
            | cz).to(torch.int32)


def cell_to_xyz(cell):
    """Unpack a 21-bit cell index to (cx, cy, cz) in [0, 128)."""
    m = C.GRID_SIZE - 1
    return (cell >> (2 * C.GRID_BITS)) & m, (cell >> C.GRID_BITS) & m, cell & m


def prefix_at_level(qx, qy, qz, level):
    """Per-axis coordinate prefixes of the (node, 128^3-cell) pair at `level`:
    two points share a level-`level` voxel cell iff all three are equal."""
    shift = (C.MAX_DEPTH + 1) - level
    return qx >> shift, qy >> shift, qz >> shift


def key_words_at_level(w0, w1, w2, level):
    """Global voxel-cell identity key: Morton words masked to the top
    3*(level + GRID_BITS) bits, with `level` packed into k2's low 5 bits
    (see the JAX package for why this is a complete sortable key)."""
    keep = level + C.GRID_BITS
    words = []
    off = 0
    for w, nlev in zip((w0, w1, w2), WORD_LEVELS):
        if isinstance(keep, torch.Tensor):
            k = torch.clamp(keep - off, 0, nlev)
        else:
            k = min(max(keep - off, 0), nlev)
        drop = 3 * (nlev - k)
        # drop <= 30, so the mask is exact in int32
        mask = ~((torch.ones_like(w) << drop) - 1)
        words.append(w & mask)
        off += nlev
    k0, k1, k2 = words
    return k0, k1, k2 | level


def key_words_decode(k0, k1, k2l):
    """Inverse of key_words_at_level: (level, local 128^3 cell coords cx, cy,
    cz); the per-axis prefix is q >> (MAX_DEPTH + 1 - level) and its low
    GRID_BITS bits are the cell within the owning node."""
    level = k2l & 31
    qx, qy, qz = decode(k0, k1, k2l & ~31)
    shift = (C.MAX_DEPTH + 1) - level
    m = C.GRID_SIZE - 1
    return level, (qx >> shift) & m, (qy >> shift) & m, (qz >> shift) & m
