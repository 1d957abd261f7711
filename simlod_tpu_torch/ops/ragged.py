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
"""
from __future__ import annotations

from typing import NamedTuple

import torch

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


def plan_blocks(src_off: torch.Tensor, cnt: torch.Tensor,
                out_len: int) -> BlockPlan:
    """Per-block gather plan for segments (src_off[i], cnt[i]);
    out_len % 128 == 0."""
    assert out_len % A == 0
    dev = src_off.device
    S = src_off.shape[0]
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
                     r_ok=r_ok, sr=sr, mpos=mpos, out_len=out_len)


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
