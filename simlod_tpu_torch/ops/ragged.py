"""Ragged segment gathers (port of simlod_tpu/ops/ragged.py).

The plan / gather_column / broadcast_i32 contract and output layout are the JAX
package's: each segment lands in a window of `out_len` rows at the same phase
(offset mod 128) it has in the pool, on whole 128-row blocks, so a segment set
that outgrows the window truncates exactly where the JAX package's does. The
aligned-row DMA trick behind that layout was a TPU device; here the gather is a
plain element gather through the plan's source indices.

`plan_blocks` is the plan in its per-block form (WR = out_len / 128 entries),
`expand` its element-wise form: block r of the window is one aligned 128-row
run of the pool, so a kernel can read a block's rows straight from the pool
columns (csrc/raster_splat.cu) without the window-sized tensors.
`plan_blocks_many` plans several segment sets at once (a frame's sample
sets): the CUDA kernel csrc/frame.cu (`plan_blocks_many_cuda`, one launch)
for CUDA tensors, its plain PyTorch version `plan_blocks_many_reference` for
CPU tensors; `plan_blocks` is one set of it. Both take the frame's selection
of segments as a mask.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from .segments import exclusive_cumsum, iota

A = 128  # window block (alignment unit of the layout)


class RaggedPlan(NamedTuple):
    src: torch.Tensor     # [W] int64 pool index per output element
    seg_of: torch.Tensor  # [W] segment id per output element (clamped >= 0)
    elem: torch.Tensor    # [W] element index within its segment
    valid: torch.Tensor   # [W] element validity
    mpos: torch.Tensor    # [S] output position of each segment's first element
                          # (out_len for empty segments)
    out_len: int


class BlockPlan(NamedTuple):
    """A plan per 128-row window block r: its elements are pool rows
    src_row[r] * 128 + l (l < 128), element (r, l) is valid iff r_ok[r] and
    pstart_r[r] <= r * 128 + l < pend_r[r], and it belongs to segment sr[r]."""
    src_row: torch.Tensor   # [WR] i32 pool row block
    pstart_r: torch.Tensor  # [WR] i32 window position of the segment's start
    pend_r: torch.Tensor    # [WR] i32 ... and of its end
    r_ok: torch.Tensor      # [WR] bool
    sr: torch.Tensor        # [WR] i32 segment id (clamped >= 0)
    mpos: torch.Tensor      # [S] as RaggedPlan.mpos
    out_len: int
    count: torch.Tensor     # i32: min(sum of the selected counts, out_len)


def plan_blocks(src_off: torch.Tensor, cnt: torch.Tensor, out_len: int,
                mask: torch.Tensor | None = None,
                index: torch.Tensor | None = None) -> BlockPlan:
    """Per-block gather plan for the selected segments (src_off[i], cnt[i]);
    out_len % 128 == 0. Without `mask` every segment is selected; with it
    segment i is selected where mask[i] (index None) or, with `index`, where
    cnt[i] > 0, index[i] >= 0 and mask[clamp(index[i], 0, len(mask) - 1)]
    (a node mask seen through each segment's node); an unselected segment
    counts 0. plan_blocks_many of one set."""
    return plan_blocks_many([(src_off, cnt, out_len, mask, index)])[0]


def plan_blocks_many(specs) -> list[BlockPlan]:
    """The plans of several segment sets, one BlockPlan per spec
    (src_off, cnt, out_len, mask, index) (the arguments of plan_blocks; mask
    and index may be left out): a frame plans all its sample sets in one
    call. The CUDA kernel (one launch for all of them) for CUDA tensors, the
    plain version for CPU tensors."""
    impl = plan_blocks_many_cuda if specs[0][0].is_cuda \
        else plan_blocks_many_reference
    return impl(specs)


def plan_blocks_many_reference(specs) -> list[BlockPlan]:
    """Plain PyTorch version of the plan_blocks_many kernel: plan by plan."""
    return [plan_blocks_reference(*s) for s in specs]


def _select(cnt, mask, index):
    """The selected segments' counts (0 where unselected)."""
    if mask is None:
        return cnt
    if index is None:
        ok = mask
    else:
        ok = (cnt > 0) & (index >= 0) \
            & mask[index.clamp(0, mask.shape[0] - 1).long()]
    return torch.where(ok, cnt, torch.zeros((), dtype=cnt.dtype,
                                            device=cnt.device))


def plan_blocks_reference(src_off: torch.Tensor, cnt: torch.Tensor,
                          out_len: int, mask: torch.Tensor | None = None,
                          index: torch.Tensor | None = None) -> BlockPlan:
    """Plain PyTorch version of one plan of the plan_blocks_many kernel."""
    assert out_len % A == 0
    dev = src_off.device
    S = src_off.shape[0]
    cnt = _select(cnt, mask, index)
    nz = cnt > 0
    zero = torch.zeros_like(src_off)
    row0 = torch.where(nz, torch.div(src_off, A, rounding_mode="floor"), zero)
    phase = torch.where(nz, src_off % A, zero)
    rcnt = torch.where(nz, torch.div(src_off + cnt + A - 1, A,
                                     rounding_mode="floor") - row0, zero)
    WR = out_len // A
    row_offs = exclusive_cumsum(rcnt)
    row_end = row_offs + rcnt
    total_rows = rcnt.sum(dtype=torch.int32)
    jr = iota(WR, dev)
    # segment owning window row r: the first segment whose row range ends after r
    seg_of_r = torch.searchsorted(row_end, jr, right=True).to(torch.int32)
    r_ok = (jr < total_rows) & (seg_of_r < S)
    sr = seg_of_r.clamp(max=max(S - 1, 0))
    at = sr.long()
    src_row = row0[at] + (jr - row_offs[at])
    pstart_r = row_offs[at] * A + phase[at]
    pend_r = pstart_r + cnt[at]
    mpos = torch.where(nz, row_offs * A + phase, out_len)
    return BlockPlan(src_row=src_row, pstart_r=pstart_r, pend_r=pend_r,
                     r_ok=r_ok, sr=sr, mpos=mpos, out_len=out_len,
                     count=torch.clamp(cnt.sum(dtype=torch.int32),
                                       max=out_len))


def window_need(src_off: torch.Tensor, cnt: torch.Tensor,
                mask: torch.Tensor | None = None,
                index: torch.Tensor | None = None) -> torch.Tensor:
    """Rows of window a plan of the selected segments fills (the arguments
    of plan_blocks but the window), phase padding included: each segment
    takes the whole 128-row blocks its pool rows touch. A plan whose window
    holds fewer drops samples (0-d int32)."""
    sel = _select(cnt, mask, index)
    blocks = torch.div(src_off + sel + A - 1, A, rounding_mode="floor") \
        - torch.div(src_off, A, rounding_mode="floor")
    return A * torch.where(sel > 0, blocks, 0).sum(dtype=torch.int32)


MAX_PLANS = 8     # sets of one launch (csrc/frame.cu MAX_PLANS)
_SCAN = 1024      # segments of a scan tile (csrc/frame.cu SCAN)


def plan_chunks(sizes) -> tuple:
    """The arena chunks ((numel, dtype), ...) of plan_blocks_many_cuda for
    sets of (S, WR) = (segments, window blocks): per set src_row, pstart_r,
    pend_r, sr ([WR] i32 each) and mpos ([S] i32), the sets' counts
    ([nsets] i32), per set r_ok ([WR] bool), then the scratch, per set
    local ([S] i32) and the tile sums ([2 ceil(S / 1024) + 1] i32). All but
    the scratch become tensors."""
    i32 = torch.int32
    out = []
    for S, WR in sizes:
        out += [(WR, i32)] * 4 + [(S, i32)]
    out += [(len(sizes), i32)] + [(WR, torch.bool) for _, WR in sizes]
    for S, _ in sizes:
        out += [(S, i32), (2 * -(-S // _SCAN) + 1, i32)]
    return tuple(out)


def plan_blocks_many_cuda(specs) -> list[BlockPlan]:
    """The CUDA kernel csrc/frame.cu (`simlod_plan_blocks_many`) on CUDA
    tensors; raises for anything else. Same arguments and result as
    plan_blocks_many_reference, bit for bit, the rows past each set's last
    segment included (they take segment S - 1's values with r_ok false, as
    searchsorted puts them there).

    It replaces the plain version's ~20 launches a set (masking, cumsum,
    searchsorted, WR-sized gathers), which XLA fuses in the JAX package's
    jitted frame (ragged.plan, simlod_tpu/ops/ragged.py:46), with one
    cooperative launch for up to MAX_PLANS sets: block scans of the
    segments' row and selected counts, a scan of each set's tile sums, and a
    fill in which each warp writes its 32 segments' rows, split by grid
    barriers. Its bytes (8-13 B read a segment, 17 B written a window block
    and 4 B a segment) take under a microsecond: the launch bounds it, so the
    host side is one arena allocation, one check per distinct tensor and one
    ctypes call. Each call adds one to `plan_blocks_cuda.launches`."""
    n = len(specs)
    where, i32 = "plan_blocks_many_cuda", torch.int32
    if not 0 < n <= MAX_PLANS:
        raise ValueError(f"{where}: 1 to {MAX_PLANS} sets, not {n}")
    dev = specs[0][0].device
    seen = {}

    def ptr(t, what, dtype, S=None):
        p = seen.get(id(t))
        if p is None:
            p = seen[id(t)] = kernels.data_ptr(t, where, what, dtype, dev)
        if S is not None and t.shape != (S,):
            raise ValueError(f"{where}: {what} must have shape ({S},)")
        return p

    sets, sizes = [], []
    for spec in specs:
        off, cnt, out_len, mask, index = (*spec, None, None)[:5]
        S = off.shape[0] if off.dim() == 1 else 0
        if not 0 < S < (1 << 31) or not 0 <= out_len < (1 << 31) \
                or out_len % A:
            raise ValueError(f"{where}: 1 <= S < 2^31 and out_len a multiple "
                             f"of 128 below 2^31 (S {S}, out_len {out_len})")
        w = [ptr(off, "src_off", i32, S), ptr(cnt, "cnt", i32, S)]
        mask_len = 0
        if mask is None:
            w += [0, 0]
        else:
            mask_len = mask.shape[0] if mask.dim() == 1 else 0
            if mask_len < 1 or (index is None and mask_len != S):
                raise ValueError(f"{where}: mask must be a non-empty 1-D bool "
                                 "tensor, of S entries without index")
            w += [ptr(mask, "mask", torch.bool),
                  0 if index is None else ptr(index, "index", i32, S)]
        sets.append((w, S, mask_len, out_len))
        sizes.append((S, out_len // A))
    views, ptrs = kernels.carve(dev, plan_chunks(sizes), 6 * n + 1)
    words, plans = [], []
    for k, ((w, S, mask_len, out_len), count) in enumerate(
            zip(sets, views[5 * n].unbind())):
        src_row, pstart, pend, sr, mpos = views[5 * k:5 * k + 5]
        r_ok = views[5 * n + 1 + k]
        # csrc/frame.cu's word order: the inputs, the set's 5 i32 outputs,
        # its count, r_ok, its 2 scratch chunks, then the sizes
        words += [*w, *ptrs[5 * k:5 * k + 5], ptrs[5 * n] + 4 * k,
                  ptrs[5 * n + 1 + k], *ptrs[6 * n + 1 + 2 * k:6 * n + 3 + 2 * k],
                  S, mask_len, out_len]
        plans.append(BlockPlan(src_row=src_row, pstart_r=pstart, pend_r=pend,
                               r_ok=r_ok, sr=sr, mpos=mpos, out_len=out_len,
                               count=count))
    rc = kernels.load().simlod_plan_blocks_many(
        kernels.words(words), n, dev.index, kernels.stream(dev))
    kernels.check_launch(rc, where)
    plan_blocks_cuda.launches += 1
    return plans


@kernels.counted
def plan_blocks_cuda(src_off: torch.Tensor, cnt: torch.Tensor, out_len: int,
                     mask: torch.Tensor | None = None,
                     index: torch.Tensor | None = None) -> BlockPlan:
    """plan_blocks_many_cuda of one set. `plan_blocks_cuda.launches` counts
    the plan kernel's launches: one per batched call, however many sets it
    plans."""
    return plan_blocks_many_cuda([(src_off, cnt, out_len, mask, index)])[0]


def expand(bp: BlockPlan) -> RaggedPlan:
    """The element-wise plan of a block plan ([out_len] tensors)."""
    WR, dev = bp.out_len // A, bp.src_row.device
    lanes = iota(A, dev)
    j2 = iota(WR, dev)[:, None] * A + lanes[None, :]
    valid = bp.r_ok[:, None] & (j2 >= bp.pstart_r[:, None]) \
        & (j2 < bp.pend_r[:, None])
    elem = j2 - bp.pstart_r[:, None]
    src = bp.src_row.to(torch.int64)[:, None] * A + lanes[None, :]
    seg_of = bp.sr[:, None].expand(WR, A)
    n = bp.out_len
    return RaggedPlan(src=src.reshape(n), seg_of=seg_of.reshape(n),
                      elem=elem.reshape(n), valid=valid.reshape(n),
                      mpos=bp.mpos, out_len=n)


def plan(src_off: torch.Tensor, cnt: torch.Tensor, out_len: int) -> RaggedPlan:
    """Gather plan for segments (src_off[i], cnt[i]). out_len % 128 == 0."""
    return expand(plan_blocks(src_off, cnt, out_len))


def gather_column(p: RaggedPlan, src: torch.Tensor) -> torch.Tensor:
    """Gather one pool column through the plan -> [out_len]. Rows outside every
    segment read a clamped pool row (junk; callers mask with p.valid)."""
    return src[p.src.clamp(0, src.shape[0] - 1)]


def broadcast_i32(p: RaggedPlan, vals: torch.Tensor) -> torch.Tensor:
    """vals[p.seg_of[j]] for every output element (valid rows match the JAX
    package's cumsum broadcast; invalid rows are junk there and here)."""
    return vals[p.seg_of.long()]


def window_for(total_points: int, max_segments: int) -> int:
    """Static output window: every segment may add up to 2(A-1) phase-padding rows."""
    w = total_points + max_segments * 2 * A + A
    return ((w + A - 1) // A) * A
