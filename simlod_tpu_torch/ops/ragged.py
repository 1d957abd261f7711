"""Ragged segment gathers (port of simlod_tpu/ops/ragged.py).

The plan / gather_column / broadcast_i32 contract and output layout are the JAX
package's: each segment lands in a window of `out_len` rows at the same phase
(offset mod 128) it has in the pool, on whole 128-row blocks, so a segment set
that outgrows the window truncates exactly where the JAX package's does. The
aligned-row DMA trick behind that layout was a TPU device; here the gather is a
plain element gather through the plan's source indices.
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


def plan(src_off: torch.Tensor, cnt: torch.Tensor, out_len: int) -> RaggedPlan:
    """Gather plan for segments (src_off[i], cnt[i]). out_len % 128 == 0."""
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
    sr = seg_of_r.clamp(max=max(S - 1, 0)).long()
    src_row = row0[sr] + (jr - row_offs[sr])
    pstart_r = row_offs[sr] * A + phase[sr]
    pend_r = pstart_r + cnt[sr]
    lanes = iota(A, dev)
    j2 = jr[:, None] * A + lanes[None, :]
    valid = r_ok[:, None] & (j2 >= pstart_r[:, None]) & (j2 < pend_r[:, None])
    elem = j2 - pstart_r[:, None]
    src = src_row.to(torch.int64)[:, None] * A + lanes[None, :]
    seg_of = sr.to(torch.int32)[:, None].expand(WR, A)
    mpos = torch.where(nz, row_offs * A + phase, out_len)
    return RaggedPlan(src=src.reshape(out_len), seg_of=seg_of.reshape(out_len),
                      elem=elem.reshape(out_len), valid=valid.reshape(out_len),
                      mpos=mpos, out_len=out_len)


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
