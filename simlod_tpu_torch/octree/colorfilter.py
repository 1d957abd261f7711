"""Bottom-up voxel colour filtering (port of simlod_tpu/octree/colorfilter.py;
the reference's colorfilter pass, colorfilter.cu, disabled upstream at
main_progressive_octree.cpp:628-634).

Each inner node's voxel colours become the average colour of its children's
samples (child points for leaves, child voxels, already filtered, for inner
nodes) that fall into the voxel's 128^3 cell. Levels are processed bottom-up;
per level, all child samples are laid out densely, sorted by (parent node,
global cell key), averaged per run and scattered into the voxel store. The store
is (node, cell)-sorted and every parent cell receives at least one child sample
(the reference asserts that equality at colorfilter.cu:393-398), so the averaged
runs pair 1:1 with the level's store entries in order.

Requires a freshly compacted voxel store (exact CSR). The per-level windows are
the exact sample counts, read for all levels in one device read before the
first level (the JAX package pads them to powers of two to bound its compiles).
The run sums do not depend on the order inside a run, so the result is bit-equal
to the JAX package's on equal input states.
"""
from __future__ import annotations

import torch

from .. import constants as C
from ..config import EngineConfig
from ..ops import morton
from ..ops.segments import (I32_MAX, cumsum32, expand_segments, lexsort,
                            roll1, run_reduce_sum, run_starts, scatter_drop)
from ..utils import trace
from .structures import OctreeState


def _level_counts(state: OctreeState) -> list[list[int]]:
    """Per level L: [child voxels at L, child leaf points at L, store entries
    of inner nodes at L], plus the deepest live level; one device read."""
    n_cap = state.child_base.shape[0]
    dev = state.device
    L = C.MAX_DEPTH + 2
    active = torch.arange(n_cap, dtype=torch.int32, device=dev) < state.num_nodes
    lvl = state.level.clamp(0, L - 1).long()
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    counts = torch.zeros((3, L), dtype=torch.int64, device=dev)
    counts[0].index_add_(0, lvl, torch.where(active, state.vox_vcnt, zero).long())
    inner = active & (state.child_base >= 0)
    counts[2].index_add_(0, lvl, torch.where(inner, state.vox_vcnt, zero).long())
    sn = state.seg_node.clamp(0, n_cap - 1).long()
    seg_ok = (state.seg_cnt > 0) & (state.seg_node >= 0) \
        & (state.child_base[sn] < 0)
    counts[1].index_add_(0, state.level[sn].clamp(0, L - 1).long(),
                         torch.where(seg_ok, state.seg_cnt, zero).long())
    max_level = torch.where(active, state.level, zero).max().reshape(1)
    out = trace.sync("colorfilter.levels",
                     torch.cat([counts.reshape(-1), max_level.long()]))
    return [out[:L], out[L:2 * L], out[2 * L:3 * L], out[3 * L]]


def _filter_level(cfg: EngineConfig, state: OctreeState, vw: int, pw: int,
                  sw: int, lvl: int) -> OctreeState:
    """Filter all inner nodes at level `lvl` from their level lvl+1 children
    (windows: vw child voxels, pw child points, sw store entries)."""
    n_cap = state.child_base.shape[0]
    dev = state.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    ids = torch.arange(n_cap, dtype=torch.int32, device=dev)
    active = ids < state.num_nodes
    child_sel = active & (state.level == lvl + 1)
    parent_sel = active & (state.level == lvl) & (state.child_base >= 0)
    csr_cnt = state.vox_vcnt

    # --- child voxel samples ---
    vnode, velem, vvalid, _ = expand_segments(
        torch.where(child_sel, csr_cnt, zero), vw)
    v_cap = state.vox_k0.shape[0]
    vidx = torch.where(vvalid, state.vox_voff[vnode.long()] + velem,
                       v_cap - 1).long()
    # child voxel coords at resolution 2^(lvl+1+7) from the global key (the
    # decoded prefix has its low bits zero: shift down to the prefix value)
    vq = morton.decode(state.vox_k0[vidx], state.vox_k1[vidx],
                       state.vox_k2l[vidx] & ~31)
    down = C.FULL_GRID_BITS - ((lvl + 1) + C.GRID_BITS)
    up = C.FULL_GRID_BITS - (lvl + C.GRID_BITS)
    # parent-level cell coords = child-resolution coords >> 1, re-aligned to
    # 28-bit coords for the parent-level key
    pk0, pk1, pk2l = morton.key_words_at_level(
        *morton.encode(*(((q >> down) >> 1) << up for q in vq)), lvl)
    vrgba = state.vox_rgba[vidx]
    vparent = torch.where(vvalid, state.parent[vnode.long()], n_cap)

    # --- child point samples (leaves) ---
    seg_node_safe = state.seg_node.clamp(0, n_cap - 1).long()
    seg_sel = (state.seg_cnt > 0) & (state.seg_node >= 0) \
        & (state.level[seg_node_safe] == lvl + 1) \
        & (state.child_base[seg_node_safe] < 0)
    pseg, pelem, pvalid, _ = expand_segments(
        torch.where(seg_sel, state.seg_cnt, zero), pw)
    p_cap = state.pt_w0.shape[0]
    pidx = torch.where(pvalid, state.seg_off[pseg.long()] + pelem,
                       p_cap - 1).long()
    # the pool stores Morton words: the level key masks them directly
    qk0, qk1, qk2l = morton.key_words_at_level(
        state.pt_w0[pidx], state.pt_w1[pidx], state.pt_w2[pidx], lvl)
    prgba = state.pt_rgba[pidx]
    pparent = torch.where(pvalid, state.parent[seg_node_safe[pseg.long()]],
                          n_cap)

    # --- aggregate: sort by (parent, global cell key), average per run ---
    valid = torch.cat([vvalid, pvalid])
    node_k = torch.where(valid, torch.cat([vparent, pparent]), I32_MAX)
    ck0 = torch.cat([pk0, qk0])
    ck1 = torch.cat([pk1, qk1])
    ck2 = torch.cat([pk2l, qk2l])
    col = torch.cat([vrgba, prgba])
    order = lexsort([node_k, ck0, ck1, ck2])
    snode, sk0, sk1, sk2, scol = (a[order] for a in (node_k, ck0, ck1, ck2, col))
    svalid = snode < I32_MAX
    key_change = (snode != roll1(snode)) | (sk0 != roll1(sk0)) \
        | (sk1 != roll1(sk1)) | (sk2 != roll1(sk2))
    starts = (run_starts(snode, svalid) | key_change) & svalid
    rgb1 = torch.stack([scol & 0xFF, (scol >> 8) & 0xFF, (scol >> 16) & 0xFF,
                        torch.ones_like(scol)], 1)
    sums = run_reduce_sum(rgb1, starts, svalid)
    cs = sums[:, 3].clamp(min=1)
    q8 = lambda k: torch.div(sums[:, k], cs, rounding_mode="floor") & 0xFF
    avg = q8(0) | (q8(1) << 8) | (q8(2) << 16)

    # the run-start rows in order: the level's averaged (node, cell) uniques
    arank = cumsum32(starts.to(torch.int32)) - 1
    agg_col = scatter_drop(torch.zeros(sw, dtype=torch.int32, device=dev),
                           torch.where(starts, arank.clamp(max=sw), sw), avg)
    n_agg = starts.sum(dtype=torch.int32)

    # --- scatter into the store: level-lvl entries in (node, cell) order ---
    tnode, telem, tvalid, _ = expand_segments(
        torch.where(parent_sel, csr_cnt, zero), sw)
    ok = tvalid & (torch.arange(sw, dtype=torch.int32, device=dev) < n_agg)
    tidx = torch.where(ok, state.vox_voff[tnode.long()] + telem, v_cap)
    scatter_drop(state.vox_rgba, tidx, agg_col)
    return state


def filter_colors(cfg: EngineConfig, state: OctreeState) -> OctreeState:
    """Run the whole bottom-up colour filter (host-driven over levels). The
    voxel store must be compacted first (exact CSR); the state is updated in
    place and returned."""
    n_vox, n_pts, n_store, max_level = _level_counts(state)
    for lvl in range(max_level - 1, -1, -1):
        vw, pw, sw = n_vox[lvl + 1], n_pts[lvl + 1], n_store[lvl]
        if sw == 0 or vw + pw == 0:
            continue
        state = _filter_level(cfg, state, vw, pw, max(sw, vw + pw), lvl)
    return state
