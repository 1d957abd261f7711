"""Segment / scan / compaction primitives (port of simlod_tpu/ops/segments.py).

Conventions: index arrays are int32; torch's cumsum of int32 promotes to int64, so
every cumsum here names its dtype. Compaction is a stable partition computed from
prefix sums (a scatter of a permutation), never a boolean index: a boolean index
would make the host wait for the device to learn the output length.
"""
from __future__ import annotations

import functools

import torch

I32_MAX = torch.iinfo(torch.int32).max
I32_MIN = torch.iinfo(torch.int32).min


def iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def device_constant(values, dtype, device) -> torch.Tensor:
    """A constant tensor of `values` (a number or nested tuples), made once
    per (values, dtype, device) and shared: callers must not write to it.
    Making it is a host-to-device copy, which a CUDA graph cannot capture,
    so a captured frame reads the one its warm-up made."""
    return torch.tensor(values, dtype=dtype, device=device)


def cumsum32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 prefix sum (wraps like the JAX package's int32 cumsum)."""
    return torch.cumsum(x, 0, dtype=torch.int32)


def exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    return cumsum32(x) - x


def roll1(x: torch.Tensor) -> torch.Tensor:
    """jnp.roll(x, 1): row i holds x[i-1], row 0 holds x[-1]."""
    return torch.roll(x, 1, 0)


def run_starts(vals: torch.Tensor,
               valid: torch.Tensor | None = None) -> torch.Tensor:
    """True where a run of equal adjacent values starts (row 0 included); with
    `valid`, invalid rows (compacted to the tail) never start a run."""
    starts = vals != roll1(vals)
    starts[0] = True
    return starts & valid if valid is not None else starts


def expand_segments(sel_counts: torch.Tensor, out_len: int):
    """Ragged expansion: segments of `sel_counts[i]` elements laid out densely
    in `out_len` rows; row j holds (segment index, element within segment).

    Returns (seg_of_row, elem_of_row, row_valid, total). Rows past the total are
    invalid and, like the JAX package's, carry the last non-empty segment
    (segment 0 when every segment is empty). The owning segment of a row is a
    binary search over the inclusive prefix counts (the JAX package scatters
    markers and carries them with cummax)."""
    ends = cumsum32(sel_counts)
    total = ends[-1] if ends.shape[0] else torch.zeros(
        (), dtype=torch.int32, device=sel_counts.device)
    j = iota(out_len, sel_counts.device)
    seg = torch.searchsorted(ends, torch.minimum(j, total - 1),
                             right=True).to(torch.int32)
    elem = j - (ends - sel_counts)[seg.long()]
    return seg, elem, j < total, total


def next_start_pos(starts: torch.Tensor) -> torch.Tensor:
    """For each row, the position of the next run start strictly after it (n
    if none), int32: the running minimum from the end, shifted by one row.
    One row per input row, except that an empty input gives [0], as the JAX
    package's does."""
    n = starts.shape[0]
    pos = torch.where(starts, iota(n, starts.device), n)
    at_or_after = torch.flip(torch.cummin(torch.flip(pos, (0,)), 0).values,
                             (0,))
    return torch.cat([at_or_after[1:], torch.full(
        (1,), n, dtype=torch.int32, device=starts.device)])


def run_reduce_sum(values: torch.Tensor, starts: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """Sum `values` ([n] or [n, k]) over the runs that `starts` opens, masked
    by `valid`; each run-start row holds its run's sum (other rows hold the sum
    of the run they lie in; rows before the first start hold 0). Sums are
    formed in int64 with one index_add_ over run ids (a prefix count), and
    returned in the values' dtype."""
    n = values.shape[0]
    rid = cumsum32(starts.to(torch.int32)) - 1
    v = values.to(torch.int64)
    mask = valid if v.ndim == 1 else valid[:, None]
    v = torch.where(mask, v, 0)
    acc = torch.zeros((n + 1,) + tuple(v.shape[1:]), dtype=torch.int64,
                      device=values.device)
    acc.index_add_(0, torch.where(rid >= 0, rid, n).long(), v)
    return acc[torch.where(rid >= 0, rid, n).long()].to(values.dtype)


def carry_last(markers: torch.Tensor) -> torch.Tensor:
    """Carry-forward of monotonically scattered markers: -1 at unmarked rows,
    non-decreasing values at marked ones; each row receives the most recent
    marker at or before it (-1 before the first). The running maximum, as the
    JAX package's cummax; on CUDA torch's cummax also computes indices, so the
    frame and build paths use take_last instead."""
    return torch.cummax(markers, 0).values


def take_last(markers: torch.Tensor, sentinel: int = -1) -> torch.Tensor:
    """Each row receives the most recent non-sentinel value at or before it
    (sentinel before the first). The k-th marker lands in slot k of a small
    table and every row reads the slot of its running marker count: a prefix
    sum, a scatter and a gather (the JAX package uses a log-shift scan, a TPU
    compile-time workaround; torch's cummax also computes indices and is an
    order of magnitude slower on CUDA)."""
    n = markers.shape[0]
    marked = markers != sentinel
    c = cumsum32(marked.to(torch.int32))
    table = torch.full((n + 1,), sentinel, dtype=markers.dtype,
                       device=markers.device)
    # unmarked rows write the sentinel into slot 0, marked rows their own slot
    table.scatter_(0, torch.where(marked, c, 0).long(), markers)
    return table[c.long()]


def partition_perm(mask: torch.Tensor):
    """Stable partition permutation: perm lists the True rows in order, then the
    False rows in order. Returns (perm int64, n_true 0-d int32)."""
    n = mask.shape[0]
    m = mask.to(torch.int32)
    n_true = m.sum(dtype=torch.int32)
    before_t = exclusive_cumsum(m)
    rows = iota(n, mask.device)
    dest = torch.where(mask, before_t, n_true + (rows - before_t))
    perm = torch.empty(n, dtype=torch.int64, device=mask.device)
    perm[dest.long()] = rows.long()
    return perm, n_true


def compact_mask_via_sort(mask: torch.Tensor, payloads):
    """Stably move rows where mask is True to the front; (payloads', count)."""
    perm, n_true = partition_perm(mask)
    return tuple(p[perm] for p in payloads), n_true


def compact_indices(mask: torch.Tensor):
    """Row indices of True rows, front-compacted ascending, INT32_MAX after them;
    (idx int32, count)."""
    perm, n_true = partition_perm(mask)
    n = mask.shape[0]
    idx = torch.where(iota(n, mask.device) < n_true, perm.to(torch.int32),
                      torch.full((n,), I32_MAX, dtype=torch.int32,
                                 device=mask.device))
    return idx, n_true


def pack2(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Order-preserving int64 key for the lexicographic int32 pair (hi, lo)."""
    return (hi.to(torch.int64) << 32) + (lo.to(torch.int64) - I32_MIN)


def lexsort(keys) -> torch.Tensor:
    """Stable lexicographic sort permutation (int64) over int32 key columns,
    most significant first: ceil(len(keys)/2) stable int64 sort passes, least
    significant pair first. Rows with equal keys keep their input order."""
    keys = list(keys)
    n = keys[0].shape[0]
    perm = None
    while keys:
        if len(keys) >= 2:
            hi, lo = keys[-2], keys[-1]
            keys = keys[:-2]
            k = pack2(hi, lo)
        else:
            k = keys.pop().to(torch.int64)
        if perm is not None:
            k = k[perm]
        order = torch.sort(k, stable=True).indices
        perm = order if perm is None else perm[order]
    if perm is None:
        perm = torch.arange(n, device=keys[0].device)
    return perm


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Population count of the low 32 bits (int64 math: no uint32 shifts)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def scatter_drop(col: torch.Tensor, idx: torch.Tensor, vals,
                 accumulate: bool = False) -> torch.Tensor:
    """In-place `col.at[idx].set/add(vals, mode="drop")` for idx in [0, n]: index
    n (the JAX package's drop index) lands in a scratch row that is cut off.
    Duplicate indices only ever come with accumulate=True, which adds with
    atomics (index_add_; integer sums, so the result is exact):
    index_put_(accumulate=True) serializes duplicates on CUDA, and most
    dropped rows share the scratch index."""
    n = col.shape[0]
    ext = torch.cat([col, col.new_zeros((1,) + tuple(col.shape[1:]))])
    if not isinstance(vals, torch.Tensor):
        vals = torch.full(idx.shape, vals, dtype=col.dtype, device=col.device)
    idx = idx.clamp(0, n).long()
    if accumulate:
        ext.index_add_(0, idx, vals.to(col.dtype))
    else:
        ext.index_put_((idx,), vals.to(col.dtype))
    col.copy_(ext[:n])
    return col


def dus(col: torch.Tensor, src: torch.Tensor, start) -> torch.Tensor:
    """In-place `lax.dynamic_update_slice(col, src, (start,))`: the start clamps
    to [0, len(col) - len(src)] like XLA's. `start` may be a device scalar (no
    host sync)."""
    n, m = col.shape[0], src.shape[0]
    if m == 0:
        return col
    s = torch.as_tensor(start, device=col.device).to(torch.int64).clamp(0, n - m)
    idx = s + torch.arange(m, device=col.device)
    col.index_copy_(0, idx, src.to(col.dtype))
    return col
