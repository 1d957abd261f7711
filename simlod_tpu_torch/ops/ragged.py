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
`plan_blocks` takes the CUDA kernel csrc/frame.cu (`plan_blocks_cuda`) for
CUDA tensors and its plain PyTorch version `plan_blocks_reference` for CPU
tensors; both take the frame's selection of segments as a mask.
"""
from __future__ import annotations

import ctypes
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
    counts 0. The CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    impl = plan_blocks_cuda if src_off.is_cuda else plan_blocks_reference
    return impl(src_off, cnt, out_len, mask, index)


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
    """Plain PyTorch version of the plan_blocks kernel."""
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


def plan_blocks_cuda(src_off: torch.Tensor, cnt: torch.Tensor, out_len: int,
                     mask: torch.Tensor | None = None,
                     index: torch.Tensor | None = None) -> BlockPlan:
    """The CUDA kernel csrc/frame.cu (`simlod_plan_blocks`) on CUDA tensors;
    raises for anything else. Same arguments and result as
    plan_blocks_reference, bit for bit, the rows past the last segment
    included (they take segment S - 1's values with r_ok false, as
    searchsorted puts them there).

    It replaces the plain version's ~20 launches (masking, cumsum,
    searchsorted, WR-sized gathers), which XLA fuses in the JAX package's
    jitted frame (ragged.plan, simlod_tpu/ops/ragged.py:46), with three: a
    block scan of the segments' row counts and selected counts, one block's
    scan of the block sums, and a fill in which each warp writes its 32
    segments' rows. Bound by memory: 8-13 B read a segment, 17 B written a
    window block and 4 B a segment. Each call adds one to
    `plan_blocks_cuda.launches`."""
    if out_len % A != 0 or out_len < 0:
        raise ValueError(f"plan_blocks_cuda: out_len {out_len} is not a "
                         "multiple of 128")
    dev = src_off.device
    S = src_off.shape[0]
    if not 0 < S < (1 << 31) or out_len >= (1 << 31):
        raise ValueError("plan_blocks_cuda: 1 <= S and out_len < 2^31")
    i32 = torch.int32
    arg = lambda t, what, dtype, shape=None: kernels.data_ptr(
        t, "plan_blocks_cuda", what, dtype, dev, shape)
    ptrs = [arg(src_off, "src_off", i32, (S,)), arg(cnt, "cnt", i32, (S,))]
    mask_len = 0
    if mask is None:
        ptrs += [0, 0]
    else:
        mask_len = mask.shape[0] if mask.ndim == 1 else 0
        if mask_len < 1:
            raise ValueError("plan_blocks_cuda: mask must be a non-empty "
                             "1-D bool tensor")
        ptrs += [arg(mask, "mask", torch.bool),
                 0 if index is None else arg(index, "index", i32, (S,))]
        if index is None and mask_len != S:
            raise ValueError("plan_blocks_cuda: mask must have S entries "
                             "without index")
    WR = out_len // A
    nb = -(-S // 1024)
    scratch = torch.empty(S + 2 * nb + 1, dtype=i32, device=dev)
    rows = [torch.empty(WR, dtype=i32, device=dev) for _ in range(3)]
    r_ok = torch.empty(WR, dtype=torch.bool, device=dev)
    sr = torch.empty(WR, dtype=i32, device=dev)
    mpos = torch.empty(S, dtype=i32, device=dev)
    count = torch.empty((), dtype=i32, device=dev)
    ptrs += [scratch.data_ptr(), *(t.data_ptr() for t in rows),
             r_ok.data_ptr(), sr.data_ptr(), mpos.data_ptr(),
             count.data_ptr()]
    lib = kernels.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.simlod_plan_blocks((ctypes.c_int64 * len(ptrs))(*ptrs), S,
                                    mask_len, out_len, stream)
    if rc != 0:
        raise RuntimeError(f"plan_blocks_cuda: kernel launch failed "
                           f"(cudaError {rc})")
    plan_blocks_cuda.launches += 1
    return BlockPlan(src_row=rows[0], pstart_r=rows[1], pend_r=rows[2],
                     r_ok=r_ok, sr=sr, mpos=mpos, out_len=out_len,
                     count=count)


plan_blocks_cuda.launches = 0


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
