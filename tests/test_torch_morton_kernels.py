"""The build step's Morton kernels (csrc/morton.cu) and their plain versions
(ops/morton.py: route_keys, decode_sorted, prefix_floor, spill_floor,
key_words, node_keys).

On the CPU: each plain version equals the composition of the morton
functions it replaced in octree/build.py (quantize_cols, encode, decode,
key_words_at_level, and a numpy oracle for the emission floor), on random
columns and on the edge rows the build can feed it; a CPU build launches
none of the kernels.

On the card (the `cuda` marker; `pytest tests/test_torch_morton_kernels.py
-m cuda --noconftest`): each kernel bit-equal to its plain version run on the
card, at the main path's shapes and at ragged sizes, aligned and not; a
graph-replayed build equal to the CPU's build of the same scan; and a
replayed step counting its kernels' launches.
"""
import dataclasses

import numpy as np
import pytest
import torch

from simlod_tpu_torch import constants as C
from simlod_tpu_torch.config import EngineConfig
from simlod_tpu_torch.formats import synthetic
from simlod_tpu_torch.graphs import BuildGraphs
from simlod_tpu_torch.octree import build
from simlod_tpu_torch.octree.structures import (OctreeState, init_state,
                                                reset_state)
from simlod_tpu_torch.ops import morton

# six test processes share the machine in the tier-1 run; these small tensors
# gain nothing from intra-op threads, which would oversubscribe the cores
torch.set_num_threads(1)

I32_MAX = 0x7FFFFFFF
QMAX = (1 << C.FULL_GRID_BITS) - 1
KERNELS = (morton.route_keys_cuda, morton.decode_sorted_cuda,
           morton.prefix_floor_cuda, morton.spill_floor_cuda,
           morton.key_words_cuda, morton.node_keys_cuda)
# the main path's rows (EngineConfig.auto at 36M points): a step's batch B,
# B + the boundary window, the spill window, the candidate rows, the
# multi-level block
MAIN_ROWS = (2_097_152, 2_228_224, 1_572_992, 3_801_216, 262_144)
RAGGED_ROWS = (1, 31, 4097)
# node_keys' rows: the taken nodes (max_splits_per_round), their children,
# a cascade round's children
NODE_ROWS = (1024, 8192, 2048)


# --- inputs: random columns with the edge rows mixed in ---

def _i32(a, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)


def _f32(a, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)


def _q(rng, n):
    """28-bit coordinates: random, 0, 2^28 - 1, and runs of exact
    duplicates and near neighbours (rows sorted, as the build's are)."""
    q = rng.integers(0, QMAX + 1, size=(n, 3), dtype=np.int64)
    edge = rng.random(n)
    q[edge < 0.05] = 0
    q[(edge >= 0.05) & (edge < 0.1)] = QMAX
    near = (edge >= 0.1) & (edge < 0.5)
    q[1:][near[1:]] = q[:-1][near[1:]] ^ rng.integers(
        0, 1 << rng.integers(0, 29), size=(int(near[1:].sum()), 3))
    dup = (edge >= 0.5) & (edge < 0.7)
    q[1:][dup[1:]] = q[:-1][dup[1:]]
    return np.clip(q, 0, QMAX).astype(np.int32)


def _words(rng, n, fill=0.1):
    """Morton words of _q's coordinates, rows sorted, the last `fill` of
    them INT32_MAX fill words (as the build's invalid rows)."""
    q = torch.from_numpy(_q(rng, n))
    w = torch.stack(morton.encode(q[:, 0], q[:, 1], q[:, 2]), 1).numpy()
    order = np.lexsort((w[:, 2], w[:, 1], w[:, 0]))
    w = w[order]
    w[n - int(n * fill):] = I32_MAX
    return [w[:, i].copy() for i in range(3)]


def route_inputs(rng, n, count=None):
    """f32 columns inside a box, with rows on its min corner and max edge,
    NaN, infinities and far outside, a box and a count."""
    bmin = np.array([-3.5, 12.25, 100.0], np.float32)
    cube = np.float32(rng.uniform(0.5, 2000.0))
    xyz = bmin + rng.random((n, 3)).astype(np.float32) * cube
    edge = rng.random(n)
    xyz[edge < 0.05] = bmin
    xyz[(edge >= 0.05) & (edge < 0.1)] = bmin + cube
    bad = np.array([np.nan, np.inf, -np.inf, 1e30, -1e30, -1.0], np.float32)
    odd = (edge >= 0.1) & (edge < 0.2)
    xyz[odd] = bad[rng.integers(0, len(bad), size=(int(odd.sum()), 3))]
    if count is None:
        count = int(rng.integers(0, n + 1))
    return ([xyz[:, i].copy() for i in range(3)], bmin, cube, count)


def decode_inputs(rng, n):
    """The merged stream's sorted words: point rows (k1 tagged), boundary
    rows (k1 even), fill rows, and arbitrary int32 words."""
    w0, w1, w2 = _words(rng, n)
    k1 = (w1 << 1) | 1
    bnd = rng.random(n) < 0.1
    k1[bnd] = w1[bnd] << 1
    k1[w0 == I32_MAX] = I32_MAX
    wild = rng.random(n) < 0.05
    for w in (w0, k1, w2):
        w[wild] = rng.integers(-(1 << 31), 1 << 31, size=int(wild.sum()))
    return w0, k1, w2


def prefix_inputs(rng, n):
    q = _q(rng, n)
    valid = rng.random(n) < 0.8
    lvl = rng.integers(0, 32, size=n)
    return q[:, 0], q[:, 1], q[:, 2], valid, lvl


def spill_inputs(rng, n, n_spill=None):
    w0, w1, w2 = _words(rng, n)
    glvl = rng.integers(0, C.MAX_DEPTH + 1, size=n)
    cum = np.where(rng.random(n) < 0.2, 0,
                   rng.integers(1, 1 << 24, size=n) * 32
                   + rng.integers(1, 32, size=n))
    if n_spill is None:
        n_spill = int(rng.integers(0, n + 1))
    return w0, w1, w2, glvl, cum, n_spill


def key_inputs(rng, n):
    w0, w1, w2 = _words(rng, n)
    w2 = w2 & ~31
    w2[w0 == I32_MAX] = I32_MAX & ~31
    lo = rng.integers(0, C.MAX_DEPTH + 1, size=n)
    return w0, w1, w2, lo


def node_inputs(rng, n, wild=False):
    """Node coordinates below 2^level at levels 0 to max_depth, with the
    first and last node of each level; `wild`: any int32 coordinates and
    levels from -4 to 40 (shifts out of range, as torch defines them)."""
    if wild:
        return (*(rng.integers(-(1 << 31), 1 << 31, size=n) for _ in range(3)),
                rng.integers(-4, 41, size=n))
    lvl = rng.integers(0, C.MAX_DEPTH + 1, size=n)
    n_at = (1 << lvl).astype(np.int64)
    q = [rng.integers(0, n_at) for _ in range(3)]
    edge = rng.random(n)
    for a in q:
        a[edge < 0.1] = 0
        a[edge > 0.9] = n_at[edge > 0.9] - 1
    return (*q, lvl)


# --- oracles: the morton functions the build composed before ---

def floor_oracle(q, prev_ok):
    """The emission floor in numpy: leading bits of 32 that the row's xor
    with the row before leaves zero (28-bit coordinates), less 6."""
    x = np.zeros(len(q), np.int64)
    x[1:] = np.bitwise_or.reduce(q[1:].astype(np.int64)
                                 ^ q[:-1].astype(np.int64), axis=1)
    bits = np.array([int(v).bit_length() for v in x])
    n_common = np.where(x == 0, 32, 28 - bits)
    n_common = np.where(prev_ok, n_common, 0)
    return np.maximum(n_common - (C.GRID_BITS - 1), 0)


SEEDS = (0, 1, 2)
SIZES = (1, 2, 31, 4097)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", SIZES)
def test_route_keys_is_quantize_encode_and_pack(seed, n):
    rng = np.random.default_rng(seed)
    (x, y, z), bmin, cube, count = route_inputs(rng, n)
    x, y, z = _f32(x), _f32(y), _f32(z)
    bmin_t, cube_t, count_t = _f32(bmin), _f32(cube).reshape(()), \
        _i32(count).reshape(())
    w2, pk0, pk1 = morton.route_keys(x, y, z, bmin_t, cube_t, count_t)
    q = morton.quantize_cols(x, y, z, bmin_t, cube_t)
    e0, e1, e2 = morton.encode(*q)
    valid = np.arange(n) < count
    assert torch.equal(w2, e2)
    assert np.array_equal(pk0.numpy(), np.where(valid, e0.numpy(), I32_MAX))
    assert np.array_equal(pk1.numpy(),
                          np.where(valid, (e1.numpy() << 1) | 1, I32_MAX))
    for w in (w2, pk0, pk1):
        assert w.dtype == torch.int32 and w.shape == (n,)


def test_route_keys_edges():
    """Rows on the box's min corner quantize to 0, on its max edge to
    2^28 - 1; count 0 fills every key."""
    x = _f32([0.0, 8.0, 4.0])
    box, cube = _f32([0.0, 0.0, 0.0]), _f32(8.0).reshape(())
    w2, pk0, pk1 = morton.route_keys(x, x, x, box, cube, _i32(2).reshape(()))
    full = morton.encode(*(torch.full((1,), QMAX, dtype=torch.int32),) * 3)
    assert pk0.tolist()[:2] == [0, int(full[0])]
    assert pk1.tolist()[:2] == [1, (int(full[1]) << 1) | 1]
    assert w2.tolist()[:2] == [0, int(full[2])]
    assert pk0.tolist()[2] == pk1.tolist()[2] == I32_MAX
    _, pk0, pk1 = morton.route_keys(x, x, x, box, cube, _i32(0).reshape(()))
    assert pk0.tolist() == pk1.tolist() == [I32_MAX] * 3


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", SIZES)
def test_decode_sorted_is_untag_and_decode(seed, n):
    k0, k1, k2 = decode_inputs(np.random.default_rng(seed), n)
    w1, qx, qy, qz = morton.decode_sorted(_i32(k0), _i32(k1), _i32(k2))
    assert np.array_equal(w1.numpy(), k1 >> 1)
    for a, b in zip((qx, qy, qz), morton.decode(_i32(k0), _i32(k1 >> 1),
                                                _i32(k2))):
        assert torch.equal(a, b)


def test_decode_sorted_inverts_encode_and_reads_fill_words():
    q = torch.from_numpy(_q(np.random.default_rng(9), 1000))
    w0, w1, w2 = morton.encode(q[:, 0], q[:, 1], q[:, 2])
    _, qx, qy, qz = morton.decode_sorted(w0, (w1 << 1) | 1, w2)
    assert torch.equal(torch.stack([qx, qy, qz], 1), q)
    fill = torch.full((1,), I32_MAX, dtype=torch.int32)
    w1, qx, qy, qz = morton.decode_sorted(fill, fill, fill)
    # arithmetic shifts, as the build's decode of its fill rows
    assert w1.tolist() == [I32_MAX >> 1]
    assert [int(qx), int(qy), int(qz)] == [
        int(v) for v in morton.decode(fill, fill >> 1, fill)]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", SIZES)
def test_prefix_floor_is_the_common_prefix_floor(seed, n):
    qx, qy, qz, valid, lvl = prefix_inputs(np.random.default_rng(seed), n)
    lo, cnt = morton.prefix_floor(_i32(qx), _i32(qy), _i32(qz),
                                  torch.from_numpy(valid), _i32(lvl))
    prev_ok = np.zeros(n, bool)
    prev_ok[1:] = valid[:-1]
    want = floor_oracle(np.stack([qx, qy, qz], 1), prev_ok)
    assert np.array_equal(lo.numpy(), want)
    assert np.array_equal(cnt.numpy(), np.where(
        valid, np.maximum(np.maximum(lvl, 1) - want, 0), 0))


def test_prefix_floor_edges():
    """Row 0 and a row after an invalid row start at 0; an exact duplicate
    shares all 28 bits (26 after the 6-bit cell); a row differing in the
    top bit shares none."""
    q = _i32([5, 5, 5, 5, 1 << 27])
    valid = torch.tensor([True, True, False, True, True])
    lo, cnt = morton.prefix_floor(q, q, q, valid, _i32([0, 20, 20, 3, 9]))
    assert lo.tolist() == [0, 26, 26, 0, 0]
    assert cnt.tolist() == [1, 0, 0, 3, 9]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", SIZES)
def test_spill_floor_is_decode_floor_and_leaf(seed, n):
    k0, k1, k2, glvl, cum, n_spill = spill_inputs(
        np.random.default_rng(seed), n)
    leaf, lo, cnt = morton.spill_floor(_i32(k0), _i32(k1), _i32(k2),
                                       _i32(glvl), _i32(cum),
                                       _i32(n_spill).reshape(()))
    q = torch.stack(morton.decode(_i32(k0), _i32(k1), _i32(k2)), 1).numpy()
    rows = np.arange(n)
    svalid = rows < n_spill
    prev_ok = svalid & (rows > 0)
    want_lo = np.maximum(floor_oracle(q, prev_ok), glvl)
    flvl = np.where(cum > 0, (cum - 1) & 31, 0)
    assert np.array_equal(leaf.numpy(), np.where(cum > 0, (cum - 1) >> 5, 0))
    assert np.array_equal(lo.numpy(), want_lo)
    assert np.array_equal(cnt.numpy(), np.where(
        svalid, np.maximum(flvl - want_lo, 0), 0))


def test_spill_floor_with_nothing_spilled():
    z = torch.zeros(8, dtype=torch.int32)
    leaf, lo, cnt = morton.spill_floor(z + I32_MAX, z, z, z + 3, z,
                                       _i32(0).reshape(()))
    assert leaf.tolist() == [0] * 8 and cnt.tolist() == [0] * 8
    assert lo.tolist() == [3] * 8


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("r", (None, 0, 3))
def test_key_words_is_key_words_at_level(seed, n, r):
    w0, w1, w2, lo = key_inputs(np.random.default_rng(seed), n)
    rt = None if r is None else _i32(r).reshape(())
    got = morton.key_words(_i32(w0), _i32(w1), _i32(w2), _i32(lo), rt)
    want = morton.key_words_at_level(_i32(w0), _i32(w1), _i32(w2),
                                     _i32(lo + (r or 0)))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_key_words_at_every_level():
    """Levels 0 to max_depth (and the garbage levels of a round's rows past
    their count) mask the words to their top 3 * (level + 7) bits and tag
    k2 with the level."""
    levels = np.arange(C.MAX_DEPTH + 12)
    one = I32_MAX >> 1
    ones = np.full(len(levels), one, np.int32)
    k0, k1, k2l = morton.key_words(_i32(ones), _i32(ones), _i32(ones & ~31),
                                   _i32(levels))
    for lv, a, b, c in zip(levels.tolist(), k0.tolist(), k1.tolist(),
                           k2l.tolist()):
        keep = lv + C.GRID_BITS
        bits = [min(max(keep - off, 0), n) for off, n in ((0, 10), (10, 10),
                                                          (20, 8))]
        m = [~((1 << (3 * (n - k))) - 1) for n, k in zip((10, 10, 8), bits)]
        assert (a, b, c) == (one & m[0], one & m[1],
                             ((one & ~31) & m[2]) | lv)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("end", (False, True))
def test_node_keys_is_the_shifted_encode(seed, n, end):
    nx, ny, nz, lvl = (_i32(c) for c in node_inputs(
        np.random.default_rng(seed), n))
    w0, w1 = morton.node_keys(nx, ny, nz, lvl, end)
    shift = C.FULL_GRID_BITS - lvl
    ones = ((1 << shift) - 1) if end else torch.zeros_like(nx)
    e0, e1, _ = morton.encode((nx << shift) | ones, (ny << shift) | ones,
                              (nz << shift) | ones)
    assert torch.equal(w0, e0)
    assert torch.equal(w1, e1 + int(end))


def test_node_keys_bound_each_node_interval():
    """A node's points' keys lie in [start, end query) of its interval, and
    a neighbour's start key is at or past the end query."""
    rng = np.random.default_rng(4)
    for lvl in (0, 1, 5, C.MAX_DEPTH):
        n = np.int32(1 << lvl)
        node = [rng.integers(0, n, size=64).astype(np.int32) for _ in range(3)]
        lv = _i32(np.full(64, lvl))
        s0, s1 = morton.node_keys(*(_i32(a) for a in node), lv)
        e0, e1 = morton.node_keys(*(_i32(a) for a in node), lv, end=True)
        shift = C.FULL_GRID_BITS - lvl
        pts = [_i32((a.astype(np.int64) << shift)
                    + rng.integers(0, 1 << shift, size=64)) for a in node]
        p0, p1, _ = morton.encode(*pts)
        key = lambda a, b: a.long() * (1 << 30) + b.long()
        assert bool((key(s0, s1) <= key(p0, p1)).all())
        assert bool((key(p0, p1) < key(e0, e1)).all())


# --- the build on the CPU ---

B = 1 << 13
KW = dict(cand_multi_rows=1 << 12, node_capacity=1 << 12,
          point_capacity=1 << 17, voxel_capacity=1 << 16,
          segment_capacity=1 << 14, step_points=B, spill_capacity=1 << 13,
          max_splits_per_round=64, cascade_splits_per_round=16,
          seg_select_cap=1 << 10, max_points_per_node=256,
          max_render_points=1 << 17, max_render_voxels=1 << 17,
          voxel_compact_watermark=0.25)


def _scan(n=30_000, seed=5):
    xyz, rgba = synthetic.clustered(n, seed=seed, extent=1.0)
    return xyz.astype(np.float32), rgba


def _build(cfg, xyz, rgba, device, graphs=None, state=None):
    """build_many of the scan in [K, B] planes on `device`, into a new
    state or `state` reset in place."""
    K = -(-len(xyz) // B)
    cols = np.zeros((3, K, B), np.float32)
    cc = np.zeros((K, B), np.uint32)
    counts = np.zeros(K, np.int32)
    for k in range(K):
        chunk = xyz[k * B:(k + 1) * B]
        cols[:, k, :len(chunk)] = chunk.T
        cc[k, :len(chunk)] = rgba[k * B:(k + 1) * B]
        counts[k] = len(chunk)
    t = lambda a: torch.from_numpy(a).to(device)
    lo, hi = np.zeros(3, np.float32), np.maximum(xyz.max(0), 1e-3)
    if state is None:
        state = init_state(cfg, lo, hi, device=device)
    else:
        assert reset_state(state, cfg, lo, hi)
    return build.build_many(cfg, state, t(cols[0]), t(cols[1]), t(cols[2]),
                            t(cc.view(np.int32)), counts, graphs=graphs)


def _launches():
    return [f.launches for f in KERNELS]


def test_a_cpu_build_launches_no_morton_kernel():
    before = _launches()
    state = _build(EngineConfig(**KW), *_scan(12_000), "cpu")
    assert int(state.num_points.sum()) == 12_000
    assert _launches() == before == [0] * len(KERNELS)


def test_the_kernel_wrappers_raise_on_cpu_tensors():
    z = torch.zeros(4, dtype=torch.int32)
    s = torch.zeros((), dtype=torch.int32)
    f = torch.zeros(4, dtype=torch.float32)
    calls = ((morton.route_keys_cuda, (f, f, f, torch.zeros(3), f[0], s)),
             (morton.decode_sorted_cuda, (z, z, z)),
             (morton.prefix_floor_cuda, (z, z, z, z > 0, z)),
             (morton.spill_floor_cuda, (z, z, z, z, z, s)),
             (morton.key_words_cuda, (z, z, z, z, s)),
             (morton.node_keys_cuda, (z, z, z, z)))
    for fn, args in calls:
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(*args)
        assert fn.launches == 0


# --- on the card ---

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


def _equal_on_card(kernel, plain, args, what):
    """kernel(*args) bit-equal to plain(*args), both on the card, one
    launch."""
    before = kernel.launches
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1, what
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype == torch.int32, (what, i)
        assert torch.equal(a, b), (what, i, int((a != b).sum()))


def _on(device, cols, offset):
    """The columns on `device`, each `offset` rows into a larger tensor (1:
    not 16 B aligned, so the kernel's one-row path)."""
    out = []
    for c in cols:
        t = torch.from_numpy(np.ascontiguousarray(c)).to(device)
        if offset:
            t = torch.cat([t[:offset], t])[offset:]
        out.append(t)
    return out


CARD_ROWS = MAIN_ROWS + RAGGED_ROWS


@pytest.mark.cuda
@pytest.mark.parametrize("n", CARD_ROWS)
@pytest.mark.parametrize("offset", (0, 1))
def test_route_keys_kernel_matches_plain_version(card, n, offset):
    rng = np.random.default_rng(n + offset)
    for count in (0, n // 2, n, int(rng.integers(0, n + 1))):
        (x, y, z), bmin, cube, _ = route_inputs(rng, n, count)
        x, y, z = _on(card, (np.float32(x), np.float32(y), np.float32(z)),
                      offset)
        args = (x, y, z, _f32(bmin, card), _f32(cube, card).reshape(()),
                _i32(count, card).reshape(()))
        _equal_on_card(morton.route_keys_cuda, morton.route_keys_reference,
                       args, ("route_keys", n, offset, count))


@pytest.mark.cuda
@pytest.mark.parametrize("n", CARD_ROWS)
@pytest.mark.parametrize("offset", (0, 1))
def test_decode_sorted_kernel_matches_plain_version(card, n, offset):
    cols = decode_inputs(np.random.default_rng(n + offset), n)
    args = _on(card, [c.astype(np.int32) for c in cols], offset)
    _equal_on_card(morton.decode_sorted_cuda, morton.decode_sorted_reference,
                   args, ("decode_sorted", n, offset))


@pytest.mark.cuda
@pytest.mark.parametrize("n", CARD_ROWS)
@pytest.mark.parametrize("offset", (0, 1))
def test_prefix_floor_kernel_matches_plain_version(card, n, offset):
    qx, qy, qz, valid, lvl = prefix_inputs(np.random.default_rng(n), n)
    args = _on(card, (qx, qy, qz, valid, lvl.astype(np.int32)), offset)
    _equal_on_card(morton.prefix_floor_cuda, morton.prefix_floor_reference,
                   args, ("prefix_floor", n, offset))


@pytest.mark.cuda
@pytest.mark.parametrize("n", CARD_ROWS)
@pytest.mark.parametrize("offset", (0, 1))
def test_spill_floor_kernel_matches_plain_version(card, n, offset):
    rng = np.random.default_rng(n + 7)
    for n_spill in (0, n // 3, n, None):
        k0, k1, k2, glvl, cum, ns = spill_inputs(rng, n, n_spill)
        args = _on(card, [c.astype(np.int32) for c in (k0, k1, k2, glvl,
                                                       cum)], offset)
        args.append(_i32(ns, card).reshape(()))
        _equal_on_card(morton.spill_floor_cuda, morton.spill_floor_reference,
                       args, ("spill_floor", n, offset, ns))


@pytest.mark.cuda
@pytest.mark.parametrize("n", CARD_ROWS)
@pytest.mark.parametrize("offset", (0, 1))
def test_key_words_kernel_matches_plain_version(card, n, offset):
    rng = np.random.default_rng(n + 11)
    w0, w1, w2, lo = key_inputs(rng, n)
    lo = np.where(rng.random(n) < 0.1, lo + 31, lo)   # a round's garbage rows
    cols = _on(card, [c.astype(np.int32) for c in (w0, w1, w2, lo)], offset)
    for r in (None, 0, 1, 5):
        rt = None if r is None else _i32(r, card).reshape(())
        _equal_on_card(morton.key_words_cuda, morton.key_words_reference,
                       (*cols, rt), ("key_words", n, offset, r))


@pytest.mark.cuda
@pytest.mark.parametrize("n", NODE_ROWS + RAGGED_ROWS)
@pytest.mark.parametrize("offset", (0, 1))
@pytest.mark.parametrize("wild", (False, True))
def test_node_keys_kernel_matches_plain_version(card, n, offset, wild):
    cols = node_inputs(np.random.default_rng(n + offset), n, wild)
    args = _on(card, [c.astype(np.int32) for c in cols], offset)
    for end in (False, True):
        _equal_on_card(morton.node_keys_cuda, morton.node_keys_reference,
                       (*args, end), ("node_keys", n, offset, wild, end))


@pytest.mark.cuda
def test_key_words_reads_its_round_on_the_device_in_a_graph(card):
    """A graph recorded at round 0 and replayed after the round advanced
    (as _cand_round's slot) keys each replay's level."""
    w0, w1, w2, lo = (_i32(c, card) for c in key_inputs(
        np.random.default_rng(3), 262_144))
    r = torch.zeros((), dtype=torch.int32, device=card)
    morton.key_words_cuda(w0, w1, w2, lo, r)       # warm the library
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = morton.key_words_cuda(w0, w1, w2, lo, r)
    for step in (0, 1, 2, 7):
        r.fill_(step)
        g.replay()
        want = morton.key_words_reference(w0, w1, w2, lo, r)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, want)), step


def _assert_states_equal(a: OctreeState, b: OctreeState):
    for f in dataclasses.fields(OctreeState):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.shape == y.shape and x.dtype == y.dtype, f.name
        assert torch.equal(x.cpu(), y.cpu()), f.name


@pytest.fixture(scope="module")
def scan():
    return _scan()


@pytest.mark.cuda
def test_a_graph_build_on_the_card_equals_the_cpu_build(card, scan):
    cfg = EngineConfig(**KW)
    graphs = BuildGraphs()
    on_card = _build(cfg, *scan, card, graphs)
    torch.cuda.synchronize()
    assert graphs.replays["route"] > 0 and graphs.replays["cand_round"] > 0
    assert int(on_card.vox_compacted) > 0
    _assert_states_equal(on_card, _build(cfg, *scan, "cpu"))


@pytest.mark.cuda
def test_a_replayed_step_counts_its_kernels(card, scan):
    """Once every stretch is recorded, each replay adds the launches its
    graph holds: one of each kernel a step, key_words once more a
    candidate round, node_keys four times a spill gather and twice a
    cascade round."""
    cfg = EngineConfig(**KW)
    graphs = BuildGraphs()
    state = _build(cfg, *scan, card, graphs)
    captures = sum(graphs.captures.values())
    before = dict(graphs.replays)
    launched = _launches()
    _build(cfg, *scan, card, graphs, state)
    torch.cuda.synchronize()
    assert sum(graphs.captures.values()) == captures
    rep = {k: v - before.get(k, 0) for k, v in graphs.replays.items()}
    steps = rep["route"]
    assert steps == rep["leaves"] > 0
    added = [a - b for a, b in zip(_launches(), launched)]
    assert added == [steps, steps, steps, steps, steps + rep["cand_round"],
                     4 * rep["gather"] + 2 * rep["round"]]
