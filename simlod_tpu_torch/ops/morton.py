"""Morton (Z-order) utilities (port of simlod_tpu/ops/morton.py).

Coordinates are quantized to FULL_GRID_BITS = 28 bits per axis; a full code is 84
bits, carried as three int32 words ordered for lexicographic comparison:
w0 = levels 0..9 (30 bits), w1 = levels 10..19 (30 bits), w2 = levels 20..27
(24 bits). Octant convention childIndex = (x<<2)|(y<<1)|z.

Every word, coordinate and intermediate here stays below 2^31, so plain int32
arithmetic (and arithmetic `>>` on non-negative values) reproduces the JAX
package's uint32 math bit for bit.

The build step's chains of these ops are entry points of their own
(route_keys, decode_sorted, prefix_floor, spill_floor, key_words,
node_keys): on CUDA tensors each is one kernel of csrc/morton.cu (its
`*_cuda` wrapper), on CPU tensors its plain version (`*_reference`), the
torch ops the build ran before, which the kernel matches bit for bit.
"""
from __future__ import annotations

import torch

from .. import constants as C
from .. import kernels
from .segments import I32_MAX, iota, popcount32, roll1

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


# --- the build step's fused chains (csrc/morton.cu) ---------------------------


def common_prefix_lo(qx, qy, qz, prev_ok):
    """Per-row first-in-cell emission floor from the Morton-sorted stream
    (common prefix bits with the previous row, minus GRID_BITS-1)."""
    xor3 = ((qx ^ roll1(qx)) | (qy ^ roll1(qy)) | (qz ^ roll1(qz)))
    xor3 = torch.where(prev_ok, xor3, -1)
    # uint32 math in int64: shift the 28 coordinate bits to the top of 32
    yv = (xor3.to(torch.int64) << (32 - C.FULL_GRID_BITS)) & 0xFFFFFFFF
    for s in (1, 2, 4, 8, 16):
        yv = yv | (yv >> s)
    n_common = 32 - popcount32(yv)
    return torch.clamp(n_common - (C.GRID_BITS - 1), min=0)


def route_keys(x, y, z, box_min, cube_size, count):
    """The routing keys of a step's batch: f32 columns x, y, z -> (w2, pk0,
    pk1) int32: the points' third Morton word, and their first two as the
    merge sort's keys (pk0 = w0, pk1 = (w1 << 1) | 1, both INT32_MAX from
    row `count` on, a 0-d int32 tensor). The kernel for CUDA tensors, its
    plain version for CPU tensors."""
    impl = route_keys_cuda if x.is_cuda else route_keys_reference
    return impl(x, y, z, box_min, cube_size, count)


def route_keys_reference(x, y, z, box_min, cube_size, count):
    """Plain version of route_keys: quantize_cols, encode, the pack."""
    qx, qy, qz = quantize_cols(x, y, z, box_min, cube_size)
    valid = iota(x.shape[0], x.device) < count
    w0, w1, w2 = encode(qx, qy, qz)
    pk0 = torch.where(valid, w0, I32_MAX)
    pk1 = torch.where(valid, (w1 << 1) | 1, I32_MAX)
    return w2, pk0, pk1


def decode_sorted(k0, k1, k2):
    """The merge-sorted routing stream's words (k1 tagged in bit 0) -> (w1,
    qx, qy, qz) int32: k1 >> 1, and the coordinates decode(k0, w1, k2). The
    kernel for CUDA tensors, its plain version for CPU tensors."""
    impl = decode_sorted_cuda if k0.is_cuda else decode_sorted_reference
    return impl(k0, k1, k2)


def decode_sorted_reference(k0, k1, k2):
    """Plain version of decode_sorted."""
    w1 = k1 >> 1
    return (w1, *decode(k0, w1, k2))


def prefix_floor(qx, qy, qz, valid, lvl):
    """Voxel-candidate levels of the Morton-sorted working batch -> (lo, cnt)
    int32: each row's emission floor against the row before it (0 on row 0
    and after an invalid row) and its count of levels, max(max(lvl, 1) - lo,
    0) on valid rows, else 0. `valid` is bool. The kernel for CUDA tensors,
    its plain version for CPU tensors."""
    impl = prefix_floor_cuda if qx.is_cuda else prefix_floor_reference
    return impl(qx, qy, qz, valid, lvl)


def prefix_floor_reference(qx, qy, qz, valid, lvl):
    """Plain version of prefix_floor."""
    rowi = iota(qx.shape[0], qx.device)
    nlev = torch.clamp(lvl, min=1)
    prev_ok = roll1(valid) & (rowi != 0)
    lo = common_prefix_lo(qx, qy, qz, prev_ok)
    cnt = torch.where(valid, torch.clamp(nlev - lo, min=0), 0)
    return lo, cnt


def spill_floor(k0, k1, k2, glvl, cum_s, n_spill):
    """Voxel-candidate levels of the spilled rows, sorted by full Morton key
    -> (leaf, lo, cnt) int32: the final leaf and level from the re-route's
    cumulative pack `cum_s` (id * 32 + level + 1, 0 for none), each row's
    emission floor against the row before it, at least its old node's level
    `glvl`, and its count of levels. Rows from `n_spill` (a 0-d int32
    tensor) on count 0. The kernel for CUDA tensors, its plain version for
    CPU tensors."""
    impl = spill_floor_cuda if k0.is_cuda else spill_floor_reference
    return impl(k0, k1, k2, glvl, cum_s, n_spill)


def spill_floor_reference(k0, k1, k2, glvl, cum_s, n_spill):
    """Plain version of spill_floor."""
    srow = iota(k0.shape[0], k0.device)
    svalid = srow < n_spill
    s_leaf = torch.where(cum_s > 0, (cum_s - 1) >> 5, 0)
    s_flvl = torch.where(cum_s > 0, (cum_s - 1) & 31, 0)
    sqx, sqy, sqz = decode(k0, k1, k2)
    prev_ok = svalid & roll1(svalid) & (srow > 0)
    s_lo = torch.maximum(common_prefix_lo(sqx, sqy, sqz, prev_ok), glvl)
    s_cnt = torch.where(svalid, torch.clamp(s_flvl - s_lo, min=0), 0)
    return s_leaf, s_lo, s_cnt


def key_words(w0, w1, w2, lo, r=None):
    """key_words_at_level(w0, w1, w2, lo + r): the voxel keys at each row's
    level lo plus the round `r`, a 0-d int32 tensor (None: round 0). The
    kernel for CUDA tensors, its plain version for CPU tensors."""
    impl = key_words_cuda if w0.is_cuda else key_words_reference
    return impl(w0, w1, w2, lo, r)


def key_words_reference(w0, w1, w2, lo, r=None):
    """Plain version of key_words."""
    return key_words_at_level(w0, w1, w2, lo if r is None else lo + r)


def node_keys(nx, ny, nz, level, end: bool = False):
    """The first two Morton words (int32) of each node's spatial interval:
    its start key, or with `end` the query strictly greater than every key
    inside the node (the start of its last cell, then w1 + 1). The kernel
    for CUDA tensors, its plain version for CPU tensors."""
    impl = node_keys_cuda if nx.is_cuda else node_keys_reference
    return impl(nx, ny, nz, level, end)


def node_keys_reference(nx, ny, nz, level, end: bool = False):
    """Plain version of node_keys."""
    shift = C.FULL_GRID_BITS - level
    if not end:
        w0, w1, _ = encode(nx << shift, ny << shift, nz << shift)
        return w0, w1
    ones = (torch.ones_like(nx) << shift) - 1
    w0, w1, _ = encode((nx << shift) | ones, (ny << shift) | ones,
                       (nz << shift) | ones)
    return w0, w1 + 1


def _columns(where: str, dtype, device, n: int, **cols) -> list:
    """The device pointers of the [n] columns `cols` of a kernel wrapper."""
    return [kernels.data_ptr(t, where, name, dtype, device, (n,))
            for name, t in cols.items()]


def _launch(wrapper, entry: str, n: int, device, args, outputs: int):
    """`outputs` new int32 [n] columns, filled by the C entry point `entry`
    of csrc/morton.cu, whose leading arguments are `args` (the input
    pointers, and node_keys' flag); adds one launch to `wrapper.launches`.
    An empty call launches nothing."""
    out = [torch.empty(n, dtype=torch.int32, device=device)
           for _ in range(outputs)]
    if n:
        where = wrapper.__name__
        kernels.check_launch(getattr(kernels.load(), entry)(
            *args, *(t.data_ptr() for t in out), n, device.index,
            kernels.stream(device)), where)
        wrapper.launches += 1
    return tuple(out)


@kernels.counted
def route_keys_cuda(x, y, z, box_min, cube_size, count):
    """route_keys by the kernel csrc/morton.cu `route_keys` on CUDA tensors;
    raises for anything else. One pass over the batch in place of
    quantize_cols, encode and the pack (some 150 torch ops): 12 B read and
    12 B written a row. Adds one to `route_keys_cuda.launches` a call."""
    where, dev, n = "route_keys_cuda", x.device, x.shape[0]
    ptrs = _columns(where, torch.float32, dev, n, x=x, y=y, z=z)
    ptrs += [kernels.data_ptr(box_min, where, "box_min", torch.float32, dev,
                              (3,)),
             kernels.data_ptr(cube_size, where, "cube_size", torch.float32,
                              dev, ()),
             kernels.data_ptr(count, where, "count", torch.int32, dev, ())]
    return _launch(route_keys_cuda, "simlod_route_keys", n, dev, ptrs, 3)


@kernels.counted
def decode_sorted_cuda(k0, k1, k2):
    """decode_sorted by the kernel csrc/morton.cu `decode_sorted` on CUDA
    tensors; raises for anything else. 12 B read and 16 B written a row in
    place of some 140 torch ops. Adds one to `decode_sorted_cuda.launches` a
    call."""
    where, dev, n = "decode_sorted_cuda", k0.device, k0.shape[0]
    ptrs = _columns(where, torch.int32, dev, n, k0=k0, k1=k1, k2=k2)
    return _launch(decode_sorted_cuda, "simlod_decode_sorted", n, dev, ptrs,
                   4)


@kernels.counted
def prefix_floor_cuda(qx, qy, qz, valid, lvl):
    """prefix_floor by the kernel csrc/morton.cu `prefix_floor` on CUDA
    tensors; raises for anything else. 17 B read and 8 B written a row (the
    row before from the cache) in place of some 35 torch ops. Adds one to
    `prefix_floor_cuda.launches` a call."""
    where, dev, n = "prefix_floor_cuda", qx.device, qx.shape[0]
    ptrs = _columns(where, torch.int32, dev, n, qx=qx, qy=qy, qz=qz)
    ptrs += _columns(where, torch.bool, dev, n, valid=valid)
    ptrs += _columns(where, torch.int32, dev, n, lvl=lvl)
    return _launch(prefix_floor_cuda, "simlod_prefix_floor", n, dev, ptrs, 2)


@kernels.counted
def spill_floor_cuda(k0, k1, k2, glvl, cum_s, n_spill):
    """spill_floor by the kernel csrc/morton.cu `spill_floor` on CUDA
    tensors; raises for anything else. 20 B read and 12 B written a row,
    the coordinates decoded in registers, in place of some 190 torch ops.
    Adds one to `spill_floor_cuda.launches` a call."""
    where, dev, n = "spill_floor_cuda", k0.device, k0.shape[0]
    ptrs = _columns(where, torch.int32, dev, n, k0=k0, k1=k1, k2=k2,
                    glvl=glvl, cum_s=cum_s)
    ptrs.append(kernels.data_ptr(n_spill, where, "n_spill", torch.int32, dev,
                                 ()))
    return _launch(spill_floor_cuda, "simlod_spill_floor", n, dev, ptrs, 3)


@kernels.counted
def key_words_cuda(w0, w1, w2, lo, r=None):
    """key_words by the kernel csrc/morton.cu `key_words` on CUDA tensors;
    raises for anything else. The round is read on the device, so a graph
    that advances it replays at each round's level. 16 B read and 12 B
    written a row in place of some 20 torch ops. Adds one to
    `key_words_cuda.launches` a call."""
    where, dev, n = "key_words_cuda", w0.device, w0.shape[0]
    ptrs = _columns(where, torch.int32, dev, n, w0=w0, w1=w1, w2=w2, lo=lo)
    ptrs.append(None if r is None else kernels.data_ptr(
        r, where, "r", torch.int32, dev, ()))
    return _launch(key_words_cuda, "simlod_key_words", n, dev, ptrs, 3)


@kernels.counted
def node_keys_cuda(nx, ny, nz, level, end: bool = False):
    """node_keys by the kernel csrc/morton.cu `node_keys` on CUDA tensors;
    raises for anything else. One launch in place of some 150 over the
    taken nodes or their children (1,024-8,192 rows: the launches, not the
    24 B a row, bound it). Adds one to `node_keys_cuda.launches` a call."""
    where, dev, n = "node_keys_cuda", nx.device, nx.shape[0]
    args = _columns(where, torch.int32, dev, n, nx=nx, ny=ny, nz=nz,
                    level=level)
    args.append(int(end))
    return _launch(node_keys_cuda, "simlod_node_keys", n, dev, args, 2)
