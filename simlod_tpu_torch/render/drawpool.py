"""Screen-budgeted sample decimation: the draw pool (port of
simlod_tpu/render/drawpool.py; see there for the design).

Per node, a contiguous copy of its samples (leaf points, inner-node voxels)
ordered by a hash of the sample's Morton words, so every prefix of a node's
range is a deterministic uniform spatial subsample and "draw k of n" is a
ragged prefix gather. Copies are capped at cfg.draw_cap rows per node; nodes
above the cap, and nodes the pool misses (created after the pool was built, or
dropped by a copy overflow), render through the exact path, so a stale pool
costs time, never samples.

The pool is a snapshot: it is built by gathers out of the state's columns
and shares no storage with them (octree/build.py updates the state in
place). The (node, hash) sorts are stable `torch.sort`s over packed int64
keys, where the JAX package sorts unstably: rows whose (node, hash) tie
(exact-duplicate points) may come out in another order, nothing else.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import EngineConfig
from ..octree.structures import OctreeState
from ..ops import ragged
from ..ops.segments import I32_MAX, iota, pack2
from . import raster

# fields that hold u32 words in the JAX package (int32 bit patterns here)
U32_FIELDS = ("p_rgba", "v_rgba")


class DrawPool(NamedTuple):
    """Per-node hash-ordered sample copies + CSR directories ([N] node cols)."""
    pt_off: torch.Tensor   # [N] i32
    pt_cnt: torch.Tensor   # [N] i32 (min(node points, draw_cap))
    p_w0: torch.Tensor     # [PC] Morton words + colour of the copied points
    p_w1: torch.Tensor
    p_w2: torch.Tensor
    p_rgba: torch.Tensor   # i32 (u32 bit pattern)
    vx_off: torch.Tensor   # [N] i32
    vx_cnt: torch.Tensor   # [N] i32 (min(node voxels, draw_cap))
    v_k0: torch.Tensor     # [VC] global prefix keys + colour of copied voxels
    v_k1: torch.Tensor
    v_k2l: torch.Tensor
    v_rgba: torch.Tensor   # i32 (u32 bit pattern)


def pool_to_numpy(pool: DrawPool) -> dict:
    """Host copy of every column with the JAX package's dtypes (u32 words as
    uint32), like structures.state_to_numpy."""
    out = {}
    for f in DrawPool._fields:
        a = getattr(pool, f).detach().cpu().numpy()
        out[f] = (a.view(np.uint32) if f in U32_FIELDS else a).copy()
    return out


def pool_from_numpy(d: dict, device=None) -> DrawPool:
    """Inverse of pool_to_numpy; also takes `{field: np.asarray(jax_field)}` of
    a pool the JAX package built."""
    device = torch.device(device if device is not None else "cpu")
    kw = {}
    for f in DrawPool._fields:
        a = np.asarray(d[f])
        if f in U32_FIELDS:
            a = a.astype(np.uint32, copy=False).view(np.int32)
        kw[f] = torch.from_numpy(np.array(a, copy=True)).to(device)
    return DrawPool(**kw)


def _hash2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """32-bit multiply-xor mix of two words (the JAX package's uint32 hash):
    computed in int64 masked to 32 bits, returned as its int32 bit pattern."""
    m = 0xFFFFFFFF
    h = (((a.to(torch.int64) & m) * 0x9E3779B9) & m) \
        ^ (((b.to(torch.int64) & m) * 0x85EBCA6B) & m)
    h = h ^ (h >> 15)
    h = (h * 0xC2B2AE35) & m
    h = h ^ (h >> 13)
    return torch.where(h >= (1 << 31), h - (1 << 32), h).to(torch.int32)


def _node_ranges(snode: torch.Tensor, total: torch.Tensor, node_window: int):
    """Per-node (start, count) of the node-sorted stream, by searchsorted over
    the node-id window (node ids ascend after the sort)."""
    q = iota(node_window + 1, snode.device)
    pos = torch.searchsorted(snode, q, side="left").to(torch.int32)
    pos = torch.minimum(pos, total)
    return pos[:-1], pos[1:] - pos[:-1]


def _sorted_copy(node: torch.Tensor, h: torch.Tensor, src: torch.Tensor,
                 total: torch.Tensor, NW: int, cap: int, out_len: int):
    """Sort window rows by (node, hash), keep each node's first min(cnt, cap)
    rows, and lay them out as ragged segments of an out_len window.
    Returns (source row per output row, off [NW], cnt [NW]); a node whose
    copy would overflow the window gets cnt 0."""
    order = torch.sort(pack2(node, h), stable=True).indices
    snode = node[order]
    start, ncnt = _node_ranges(snode, total, NW)
    cnt = torch.clamp(ncnt, max=cap)
    dp = ragged.plan(start, cnt, out_len)
    cnt = torch.where(dp.mpos + cnt <= out_len, cnt, 0)
    off = torch.where(cnt > 0, dp.mpos, 0)
    rows = ragged.gather_column(dp, src[order])
    return rows, off, cnt


def build_draw_pool(cfg: EngineConfig, state: OctreeState, pool_window: int,
                    vox_window: int, node_window: int, cap: int,
                    pc: int | None = None, vc: int | None = None) -> DrawPool:
    """Build both draw pools (points + voxels) from the current state.

    pool_window/vox_window are 128-multiples >= the live watermarks (a smaller
    window only truncates the copy: counts clamp). node_window >= num_nodes.
    cap = cfg.draw_cap. pc/vc size the output copies (engine: sum of per-node
    min(cnt, cap) + plan padding); default cap*node_window clamped to the input
    windows."""
    dev = state.device
    n_cap = state.child_base.shape[0]
    NW = min(node_window, n_cap)

    # --- leaf points: gather all live segments, sort by (node, hash) ---
    sn = state.seg_node
    ok = (state.seg_cnt > 0) & (sn >= 0)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    counts = torch.where(ok, state.seg_cnt, zero)
    offs = torch.where(ok, state.seg_off, zero)
    p = ragged.plan(offs, counts, pool_window)
    src = p.src.clamp(0, state.pt_w0.shape[0] - 1)
    gw0, gw1, gw2 = state.pt_w0[src], state.pt_w1[src], state.pt_w2[src]
    gnode = torch.where(p.valid, ragged.broadcast_i32(p, sn.clamp(0, n_cap)),
                        NW)
    gnode = torch.where(gnode < NW, gnode, NW)   # out-of-window nodes drop
    h = _hash2(gw0 ^ gw2, gw1)
    total_p = (gnode < NW).sum(dtype=torch.int32)
    PC = pc if pc is not None else min(cap * NW, pool_window)
    prow, pt_off, pt_cnt = _sorted_copy(gnode, h, src, total_p, NW, cap, PC)
    p_w0, p_w1, p_w2 = state.pt_w0[prow], state.pt_w1[prow], state.pt_w2[prow]
    p_rgba = state.pt_rgba[prow]

    # --- voxels: the same over the compacted store's live prefix ---
    rows = iota(vox_window, dev)
    vvalid = rows < torch.clamp(state.vox_compacted, max=vox_window)
    vnode = torch.where(vvalid, state.vox_node[:vox_window], NW)
    vnode = torch.where(vnode < NW, vnode, NW)
    vh = _hash2(state.vox_k0[:vox_window] ^ state.vox_k2l[:vox_window],
                state.vox_k1[:vox_window])
    total_v = vvalid.sum(dtype=torch.int32)
    VC = vc if vc is not None else min(cap * NW, vox_window)
    vrow, vx_off, vx_cnt = _sorted_copy(vnode, vh, rows, total_v, NW, cap, VC)
    v_k0, v_k1, v_k2l = state.vox_k0[vrow], state.vox_k1[vrow], \
        state.vox_k2l[vrow]
    v_rgba = state.vox_rgba[vrow]

    def pad_n(a):
        if NW >= n_cap:
            return a
        return torch.cat([a, torch.zeros(n_cap - NW, dtype=torch.int32,
                                         device=dev)])
    return DrawPool(
        pt_off=pad_n(pt_off), pt_cnt=pad_n(pt_cnt),
        p_w0=p_w0, p_w1=p_w1, p_w2=p_w2, p_rgba=p_rgba,
        vx_off=pad_n(vx_off), vx_cnt=pad_n(vx_cnt),
        v_k0=v_k0, v_k1=v_k1, v_k2l=v_k2l, v_rgba=v_rgba)


# --- render side: budgeted sample gathers ------------------------------------

def node_budgets(cfg: EngineConfig, vis, uniforms) -> torch.Tensor:
    """Per-node sample budget = point_budget * dx * dy of the node's screen
    extent (samples ~ covered pixels). point_budget == 0 disables decimation:
    budget = INT32_MAX. A NaN extent gives budget 0, as XLA's float-to-int
    conversion does."""
    z = torch.zeros((), dtype=torch.float32, device=vis.dx.device)
    area = torch.maximum(vis.dx, z) * torch.maximum(vis.dy, z)
    b = torch.ceil(uniforms.point_budget * torch.clamp(area, max=2.0e9))
    b = torch.clamp(b, 0.0, 2.0e9)
    b = torch.where(torch.isnan(b), z, b).to(torch.int32)
    return torch.where(uniforms.point_budget > 0.0, b, I32_MAX)


def split_masks(cfg: EngineConfig, state: OctreeState, vis, pool: DrawPool):
    """Partition emitted nodes between the pooled (budgeted) and exact paths:
    (pool_pts, exact_pts, pool_vox, exact_vox) [N] bool.

    Exact path: any node whose sample count exceeds draw_cap (its copy is cut)
    and any node the pool misses: created after the pool build (the live
    state's counts are read against the pool's), or dropped by a copy
    overflow."""
    n = pool.pt_cnt.shape[0]
    ids = iota(state.num_points.shape[0], state.device)
    at = torch.clamp(ids, max=n - 1).long()
    in_pool_p = (ids < n) & (pool.pt_cnt[at] > 0)
    in_pool_v = (ids < n) & (pool.vx_cnt[at] > 0)
    poolable_p = (state.num_points <= cfg.draw_cap) \
        & (in_pool_p | (state.num_points == 0))
    poolable_v = (state.num_voxels <= cfg.draw_cap) \
        & (in_pool_v | (state.num_voxels == 0))
    pool_pts = vis.emitted & poolable_p
    exact_pts = vis.emitted & (state.num_points > 0) & ~poolable_p
    pool_vox = vis.emitted & poolable_v
    exact_vox = vis.emitted & (state.num_voxels > 0) & ~poolable_v
    return pool_pts, exact_pts, pool_vox, exact_vox


def _pool_take(mask, stored_cnt, budgets):
    return torch.where(mask, torch.minimum(stored_cnt, budgets), 0)


def _prefix_plan(off, cnt, take, window: int):
    """Block plan of each node's first `take` pooled rows in a window of
    (window // 128) * 128 rows; returns (plan, samples in the window)."""
    N = off.shape[0]
    take = torch.minimum(take[:N], cnt)
    W = (window // 128) * 128
    return (ragged.plan_blocks(torch.where(take > 0, off, 0), take, W),
            torch.clamp(take.sum(dtype=torch.int32), max=W))


def gather_pool_points(cfg: EngineConfig, state: OctreeState, pool: DrawPool,
                       take: torch.Tensor, window: int):
    """Budgeted prefix of pooled leaf points -> raster.SampleSource (hash
    order makes each prefix a deterministic uniform subsample)."""
    p, count = _prefix_plan(pool.pt_off, pool.pt_cnt, take, window)
    return raster.point_source(state, p, pool.p_w0, pool.p_w1, pool.p_w2,
                               pool.p_rgba, None, count)


def gather_pool_voxels(cfg: EngineConfig, state: OctreeState, pool: DrawPool,
                       take: torch.Tensor, window: int):
    """Budgeted prefix of pooled inner-node voxels -> raster.SampleSource."""
    p, count = _prefix_plan(pool.vx_off, pool.vx_cnt, take, window)
    return raster.voxel_source(state, p, pool.v_k0, pool.v_k1, pool.v_k2l,
                               pool.v_rgba, count)
