"""Incremental octree construction (port of simlod_tpu/octree/build.py).

The algorithm is the JAX package's, step for step; see its module docstring for
the design (routing by one merge sort against the sorted leaf-boundary directory,
splits as directory surgery over sorted intervals, lazy first-come voxel dedup).
What changed in the port:

  - `lax.while_loop` / `lax.cond` / `lax.scan` are Python loops and `if`s. Where a
    condition is a device scalar the loop reads it back (`trace.sync`, one site
    per call site), which makes the host wait for the device; a bulk-load step
    costs 4 + (cascade rounds) of them (see PERF.md).
  - Multi-key `lax.sort`s are stable `torch.sort`s over packed int64 keys
    (ops/segments.lexsort). Where the JAX package sorts unstably, rows with equal
    keys may come out in another order here; only order-defined outputs can
    differ (which exact-duplicate point's colour a voxel keeps, the order of
    points inside a segment), never counts or node tables.
  - The state is updated in place (scatters, watermark writes into the pools,
    `+=` and `copy_` into the 0-d watermarks): the JAX version is functional
    and relies on buffer donation instead. A state keeps its tensors, so a
    CUDA graph that reads them stays valid from step to step.
  - The JAX package jits the step. Here `_build` runs it as six stretches
    between its device reads, each eagerly (`eager`) or, given a
    graphs.BuildGraphs on the card, as a CUDA graph replay.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from .. import constants as C
from ..config import EngineConfig
from ..ops import morton, ragged
from ..ops.segments import (I32_MAX, compact_indices, compact_mask_via_sort,
                            cumsum32, dus, exclusive_cumsum, iota, lexsort,
                            pack2, roll1, scatter_drop)
from ..utils import trace
from .structures import OctreeState


class Work(NamedTuple):
    """The routed, Morton-sorted working batch (see the JAX package: width is
    B + boundary_window, boundary rows stay interleaved as invalid junk)."""
    w0: torch.Tensor
    w1: torch.Tensor
    w2: torch.Tensor
    rgba: torch.Tensor   # i32 bit pattern
    qx: torch.Tensor
    qy: torch.Tensor
    qz: torch.Tensor
    leaf: torch.Tensor
    lvl: torch.Tensor
    count: torch.Tensor  # 0-d i32: number of VALID rows
    valid: torch.Tensor
    k0: torch.Tensor
    k1: torch.Tensor


class Runs(NamedTuple):
    """Per-(leaf, contiguous Morton run) view of the working batch."""
    r_leaf: torch.Tensor
    r_cnt: torch.Tensor
    r_row: torch.Tensor
    n_runs: torch.Tensor


def _i32(v, device) -> torch.Tensor:
    # filled on the device: a copy from the host waits for the device
    return torch.full((), v, dtype=torch.int32, device=device)


def route(cfg: EngineConfig, state: OctreeState, x, y, z, rgba, count):
    """Sort the batch by Morton code and assign each point its current leaf
    (one merge sort of points + leaf boundaries, then a cumsum carry of the
    boundary packs). Returns (state, Work)."""
    dev = state.device
    n_cap = state.child_base.shape[0]
    W = min(cfg.boundary_window, n_cap)
    mx = I32_MAX
    if not isinstance(count, torch.Tensor):
        count = _i32(count, dev)

    w2, pk0, pk1 = morton.route_keys(x, y, z, state.box_min, state.cube_size,
                                     count)

    # re-sort the boundary window by (key0, key1, pack): splits appended rows
    state.mem_capacity_reached |= state.num_boundaries > W
    brow = iota(W, dev)
    bvalid = brow < state.num_boundaries
    bk0 = torch.where(bvalid, state.b_key0[:W], mx)
    bk1 = torch.where(bvalid, state.b_key1[:W], mx)
    bpk = torch.where(bvalid, state.b_pack[:W], mx)
    order = lexsort((bk0, bk1, bpk))
    sb0, sb1, sbp = bk0[order], bk1[order], bpk[order]
    sbp = torch.where(bvalid, sbp, 0)
    state.b_key0[:W] = sb0
    state.b_key1[:W] = sb1
    state.b_pack[:W] = sbp

    # merge points + boundaries; boundary rows carry their pack as a delta vs the
    # previous boundary so a cumsum after the sort telescopes to the governing pack
    bdelta = torch.where(bvalid, sbp - torch.where(brow > 0, roll1(sbp), 0), 0)
    k0 = torch.cat([pk0, sb0])
    k1 = torch.cat([pk1, torch.where(bvalid, sb1 << 1, mx)])
    k2 = torch.cat([w2, torch.zeros(W, dtype=torch.int32, device=dev)])
    aux = torch.cat([rgba.to(torch.int32), bdelta])
    order = torch.sort(pack2(k0, k1), stable=True).indices
    sk0, sk1, sk2, saux = k0[order], k1[order], k2[order], aux[order]

    is_pt = ((sk1 & 1) == 1) & (sk0 != mx)
    is_bnd = ((sk1 & 1) == 0) & (sk0 != mx)
    sc = torch.where(is_pt, saux, 0)
    carried = cumsum32(torch.where(is_bnd, saux, 0))
    cpk = carried.clamp(min=0)
    sw1, cqx, cqy, cqz = morton.decode_sorted(sk0, sk1, sk2)
    return state, Work(w0=sk0, w1=sw1, w2=sk2, rgba=sc, qx=cqx, qy=cqy,
                       qz=cqz, leaf=cpk >> 5, lvl=cpk & 31, count=count,
                       valid=is_pt, k0=sk0, k1=sk1)


def compute_runs(cfg: EngineConfig, work: Work) -> Runs:
    """Run structure of the current batch->leaf assignment."""
    dev = work.leaf.device
    B = work.leaf.shape[0]
    valid = work.valid
    prev_valid = roll1(valid)
    prev_valid[:1].fill_(False)
    starts = valid & (~prev_valid | (work.leaf != roll1(work.leaf)))
    RW = min(cfg.run_window, B)
    r_row_f, n_runs = compact_indices(starts)
    r_row = torch.clamp(r_row_f[:RW], max=B)
    rw_i = iota(RW, dev)
    rv = rw_i < torch.clamp(n_runs, max=RW)
    nxt = torch.where(rw_i + 1 < n_runs, torch.cat([r_row[1:], r_row[:1]]),
                      _i32(B, dev))
    v32 = valid.to(torch.int32)
    ecs_pad = torch.cat([exclusive_cumsum(v32), work.count.reshape(1)])
    r_cnt = torch.where(rv, ecs_pad[nxt.clamp(0, B).long()]
                        - ecs_pad[r_row.clamp(0, B).long()], 0)
    r_leaf = work.leaf[torch.where(rv, r_row, 0).long()]
    return Runs(r_leaf=r_leaf, r_cnt=r_cnt,
                r_row=torch.where(rv, r_row, _i32(B, dev)), n_runs=n_runs)


def _append_voxels_prefix(cfg: EngineConfig, state: OctreeState, k0, k1, k2l,
                          src, rgba, n_emit):
    """Append candidate voxels packed at the window front at the store
    watermark (rows past n_emit are overwritten by later appends)."""
    room = torch.clamp(cfg.voxel_capacity - state.vox_used, min=0)
    n_new = torch.minimum(n_emit, room)
    start = state.vox_used
    for col, val in ((state.vox_k0, k0), (state.vox_k1, k1),
                     (state.vox_k2l, k2l), (state.vox_node, src),
                     (state.vox_rgba, rgba)):
        dus(col, val, start)
    state.vox_used += n_new
    state.mem_capacity_reached |= n_emit > room
    return state


def _lower_bound2(keys, q0, q1, lo, hi):
    """First i in [lo, hi) with keys[i] >= pack2(q0, q1), else hi, where `keys`
    is pack2 of a (k0, k1) stream.

    Every caller's stream is sorted by (k0, k1) over its whole length, so this is
    a global binary search clamped to [lo, hi]: the JAX package's bisection
    restricted to the range returns the same index."""
    g = torch.searchsorted(keys, pack2(q0, q1)).to(torch.int32)
    return torch.minimum(torch.maximum(g, lo), hi)


def _create_children(cfg: EngineConfig, state: OctreeState, tids, tv, n_take):
    """Create 8 children (a contiguous block) for each taken node id; append
    their boundary rows and ancestor rows. Returns (state, base[K], cnx, cny,
    cnz, clvl [8K])."""
    dev = state.device
    n_cap = state.child_base.shape[0]
    K = tids.shape[0]
    tsafe = tids.clamp(min=0).long()

    base = state.num_nodes + 8 * iota(K, dev)
    plvl = state.level[tsafe]
    pnx, pny, pnz = state.nx[tsafe], state.ny[tsafe], state.nz[tsafe]
    octs = iota(8, dev)
    ox, oy, oz = (octs >> 2) & 1, (octs >> 1) & 1, octs & 1
    cid = torch.where(tv[:, None], base[:, None] + octs[None, :],
                      n_cap).reshape(-1)
    rep = lambda a: torch.repeat_interleave(a, 8)
    cnx = (2 * pnx[:, None] + ox).reshape(-1)
    cny = (2 * pny[:, None] + oy).reshape(-1)
    cnz = (2 * pnz[:, None] + oz).reshape(-1)
    scatter_drop(state.parent, cid, rep(tids))
    scatter_drop(state.level, cid, rep(plvl + 1))
    scatter_drop(state.nx, cid, cnx)
    scatter_drop(state.ny, cid, cny)
    scatter_drop(state.nz, cid, cnz)
    scatter_drop(state.counter, cid, 0)
    scatter_drop(state.num_points, cid, 0)
    scatter_drop(state.num_voxels, cid, 0)
    # ancestor rows: copy parent's row up to parent level, self afterwards
    L = C.MAX_DEPTH + 1
    cols = iota(L, dev)
    panc = state.anc[(tsafe[:, None] * L + cols[None, :].long()).reshape(-1)] \
        .reshape(-1, L)
    crow = torch.where(cols[None, None, :] <= plvl[:, None, None],
                       panc[:, None, :],
                       (base[:, None] + octs[None, :])[:, :, None])
    n_anc = state.anc.shape[0]
    anc_idx = torch.where(cid[:, None] < n_cap, cid[:, None] * L + cols[None, :],
                          n_anc)
    scatter_drop(state.anc, anc_idx.reshape(-1), crow.reshape(-1))
    scatter_drop(state.child_base, torch.where(tv, tids.clamp(min=0), n_cap),
                 base)
    state.num_nodes += 8 * n_take

    # leaf-boundary directory: append the 8 child boundaries
    clvl = rep(plvl + 1)
    bw0, bw1 = morton.node_keys(cnx, cny, cnz, clvl)
    bpk = (rep(base) + octs.repeat(K)) * 32 + clvl
    pos = state.num_boundaries + iota(8 * K, dev)
    fitb = rep(tv) & (pos < n_cap)
    widx = torch.where(fitb, pos, n_cap)
    scatter_drop(state.b_key0, widx, bw0)
    scatter_drop(state.b_key1, widx, bw1)
    scatter_drop(state.b_pack, widx, bpk)
    nb = state.num_boundaries + 8 * n_take
    state.mem_capacity_reached |= nb > n_cap
    state.num_boundaries.copy_(torch.clamp(nb, max=n_cap))
    return state, base, cnx, cny, cnz, clvl


def _child_rows(wkeys, skeys, tv, base, cnx, cny, cnz, clvl,
                t_ws, t_we, t_ss, t_se, B):
    """Frontier rows for the 8 children of each taken node: ids, levels, coords,
    and their work/spill stream intervals."""
    dev = tv.device
    K = tv.shape[0]
    rep = lambda a: torch.repeat_interleave(a, 8)
    bw0, bw1 = morton.node_keys(cnx, cny, cnz, clvl)
    posw = _lower_bound2(wkeys, bw0, bw1 << 1,
                         rep(t_ws), rep(t_we)).reshape(K, 8)
    ws = posw.clone()
    ws[:, 0] = t_ws
    we = torch.cat([ws[:, 1:], t_we[:, None]], dim=1)
    poss = _lower_bound2(skeys, bw0, bw1, rep(t_ss), rep(t_se)).reshape(K, 8)
    ss = poss.clone()
    ss[:, 0] = t_ss
    se = torch.cat([ss[:, 1:], t_se[:, None]], dim=1)
    kid = torch.where(tv[:, None], base[:, None] + iota(8, dev)[None, :], -1)
    has = kid >= 0
    return (kid.reshape(-1), clvl, cnx, cny, cnz,
            torch.where(has, ws, B).reshape(-1),
            torch.where(has, we, B).reshape(-1),
            torch.where(has, ss, 0).reshape(-1),
            torch.where(has, se, 0).reshape(-1))


def _pad_to(a, n, fill):
    return torch.cat([a, torch.full((n - a.shape[0],), fill, dtype=a.dtype,
                                    device=a.device)])


def _append_leaves(fl, fl_n, FLW, FW, cols, mask):
    """Append the rows of `cols` where mask holds to the final-leaf list."""
    dev = mask.device
    (d_id, d_lvl, d_ws, d_we, d_ss, d_se), n_done = compact_mask_via_sort(
        mask, cols)
    dv = iota(FW, dev) < n_done
    pos = fl_n + iota(FW, dev)
    fit = dv & (pos < FLW)
    widx = torch.where(fit, pos, FLW)
    for dst, src in zip(fl, (d_id, d_lvl, d_ws, d_we, d_ss, d_se)):
        scatter_drop(dst, widx, src)
    return fl_n + fit.sum(dtype=torch.int32), (dv & ~fit).any()


class Select(NamedTuple):
    """A step's round-1 split selection (biggest stored + batch first)."""
    ecs_pad: torch.Tensor   # [B + 1] valid rows before each row; the count
    tv: torch.Tensor        # [K1] taken
    tids: torch.Tensor      # [K1] taken leaf ids, -1 past n_take1
    tstart: torch.Tensor    # [K1] their batch rows
    tend: torch.Tensor
    n_take1: torch.Tensor
    spill: torch.Tensor     # bool: the taken leaves store points


class Spill(NamedTuple):
    """The taken leaves' stored points, gathered once and sorted by their
    full Morton key, with the pack2 keys of both streams."""
    k0: torch.Tensor        # [SPW]
    k1: torch.Tensor
    k2: torch.Tensor
    goff: torch.Tensor      # pool row
    rgba: torch.Tensor
    seg: torch.Tensor       # gathered segment
    glvl: torch.Tensor      # its node's level
    n: torch.Tensor         # rows gathered
    sv: torch.Tensor        # [SS] the gathered segments
    ssafe: torch.Tensor     # [SS] their directory rows
    wkeys: torch.Tensor     # [B] pack2 of the working batch's keys
    skeys: torch.Tensor     # [SPW] ... and of the spill's


class Cascade(NamedTuple):
    """The split cascade: frontier rows still to decide (id, lvl, nx, ny,
    nz, ws, we, ss, se; [FW] each) and the final leaves (id, lvl, ws, we,
    ss, se; [FLW] each)."""
    frontier: tuple
    leaves: tuple
    n_leaves: torch.Tensor
    n_took: torch.Tensor    # splits of the last round


class Cand(NamedTuple):
    """The multi-level voxel emitters: a cnt-descending block of G2W rows,
    appended round-major (round r emits level lo + r of rows with ecnt > r)."""
    w0: torch.Tensor
    w1: torch.Tensor
    w2: torch.Tensor
    leaf: torch.Tensor
    lo: torch.Tensor
    rgba: torch.Tensor
    ecnt: torch.Tensor
    rounds: torch.Tensor    # ecnt.max()
    dropped: torch.Tensor   # emitters past the block (transient)
    r: torch.Tensor         # the next round


def _split_widths(cfg: EngineConfig):
    """(K1, CK, FW, FLW, SS, SPW) of the split loop."""
    K1 = cfg.max_splits_per_round
    CK = min(cfg.cascade_splits_per_round, K1)
    FW = 8 * K1
    FLW = 8 * (K1 + CK * cfg.split_rounds) + FW
    SS = cfg.seg_select_cap
    return K1, CK, FW, FLW, SS, ragged.window_for(cfg.spill_capacity, SS)


def _frontier_fill(B: int):
    """Frontier column fills (id, lvl, nx, ny, nz, ws, we, ss, se)."""
    return (-1, 0, 0, 0, 0, B, B, 0, 0)


def _select(cfg: EngineConfig, state: OctreeState, work: Work,
            force_ids=None) -> Select:
    """Round-1 selection: over-budget leaf runs, biggest first, within the
    split, spill, segment and node budgets. With `force_ids` (end-of-load
    convergence) the overfull ids ride as zero-length runs."""
    dev = state.device
    n_cap = state.child_base.shape[0]
    B = work.leaf.shape[0]
    K1, _, _, _, SS, _ = _split_widths(cfg)
    mx = I32_MAX

    runs = compute_runs(cfg, work)
    if force_ids is not None:
        KF = force_ids.shape[0]
        nf = (force_ids >= 0).sum(dtype=torch.int32)
        z = torch.zeros(KF, dtype=torch.int32, device=dev)
        runs = Runs(r_leaf=torch.cat([force_ids.clamp(min=0), runs.r_leaf]),
                    r_cnt=torch.cat([z, runs.r_cnt]),
                    r_row=torch.cat([z, runs.r_row]), n_runs=nf)
    RW = runs.r_leaf.shape[0]

    v32 = work.valid.to(torch.int32)
    ecs_pad = torch.cat([exclusive_cumsum(v32), work.count.reshape(1)])

    rvalid = iota(RW, dev) < torch.clamp(runs.n_runs, max=RW)
    lsafe = torch.where(rvalid, runs.r_leaf, 0).long()
    counter_r = state.counter[lsafe]
    level_r = state.level[lsafe]
    cb_r = state.child_base[lsafe]
    over = (rvalid & (cb_r < 0)
            & (counter_r + runs.r_cnt > cfg.max_points_per_node)
            & (level_r < cfg.max_depth))
    prio = torch.where(over, -(counter_r + runs.r_cnt), mx)
    perm = torch.sort(prio, stable=True).indices
    over_p = over[perm]
    cnt_p = counter_r[perm]
    rank_p = cumsum32(over_p.to(torch.int32))
    pts_p = torch.where(over_p, cnt_p, 0)
    pts_ex = exclusive_cumsum(pts_p)
    segs_p = torch.where(over_p, state.node_seg_count[lsafe[perm]], 0)
    segs_ex = exclusive_cumsum(segs_p)
    node_room = (state.num_nodes + 8 * rank_p) <= n_cap
    take_p = (over_p & (rank_p <= K1) & (pts_ex + pts_p <= cfg.spill_capacity)
              & (segs_ex + segs_p <= SS) & node_room)
    n_take1 = take_p.sum(dtype=torch.int32)
    state.mem_capacity_reached |= (over_p & ~node_room).any()

    sel_p, _ = compact_indices(take_p)
    tv = iota(K1, dev) < n_take1
    srows = perm[torch.where(tv, torch.clamp(sel_p[:K1], max=RW - 1), 0).long()]
    total_spill = torch.where(take_p, pts_p, 0).sum(dtype=torch.int32)
    return Select(
        ecs_pad=ecs_pad, tv=tv, tids=torch.where(tv, runs.r_leaf[srows], -1),
        tstart=torch.where(tv, runs.r_row[srows], B),
        tend=torch.where(tv, runs.r_row[srows] + runs.r_cnt[srows], B),
        n_take1=n_take1, spill=total_spill > 0)


def _route_select(cfg: EngineConfig, state: OctreeState, x, y, z, rgba, count,
                  force_ids=None) -> dict:
    """Stretch: route the batch, then the round-1 selection."""
    state, work = route(cfg, state, x, y, z, rgba, count)
    return dict(work=work, sel=_select(cfg, state, work, force_ids))


def _gather(cfg: EngineConfig, state: OctreeState, work: Work, sel: Select,
            has_spill: bool) -> dict:
    """Stretch: gather the taken nodes' stored points once and sort them by
    full Morton key (where any are stored), then create the round-1
    children, which seed the cascade's frontier."""
    dev = state.device
    n_cap = state.child_base.shape[0]
    s_cap = state.seg_node.shape[0]
    B = work.leaf.shape[0]
    K1, _, FW, FLW, SS, SPW = _split_widths(cfg)
    mx = I32_MAX
    tv, tids = sel.tv, sel.tids
    tsafe = tids.clamp(min=0).long()

    just = torch.zeros(n_cap, dtype=torch.bool, device=dev)
    scatter_drop(just, torch.where(tv, tids.clamp(min=0), n_cap), True)
    if has_spill:
        memflag = torch.zeros((), dtype=torch.bool, device=dev)
        SGW = min(cfg.seg_scan_window, s_cap)
        memflag = memflag | (state.num_segments > SGW)
        s_sel = (state.seg_cnt[:SGW] > 0) & (state.seg_node[:SGW] >= 0) & \
            just[state.seg_node[:SGW].clamp(0, n_cap - 1).long()]
        sel_full, n_sel = compact_indices(s_sel)
        memflag = memflag | (n_sel > SS)
        sv = iota(SS, dev) < n_sel
        ssafe = torch.where(sv, sel_full[:SS], 0)
        scnt = torch.where(sv, state.seg_cnt[ssafe.long()], 0)
        soff = state.seg_off[ssafe.long()]
        snode = torch.where(sv, state.seg_node[ssafe.long()], 0)
        snlvl = state.level[snode.long()]

        rplan = ragged.plan(soff, scnt, SPW)
        rvalid_g = rplan.valid
        n_spill = rvalid_g.sum(dtype=torch.int32)
        memflag = memflag | (n_spill != scnt.sum(dtype=torch.int32))
        gw0 = ragged.gather_column(rplan, state.pt_w0)
        gw1 = ragged.gather_column(rplan, state.pt_w1)
        gw2 = ragged.gather_column(rplan, state.pt_w2)
        gc = ragged.gather_column(rplan, state.pt_rgba)
        glvl = ragged.broadcast_i32(rplan, snlvl)
        goff0 = ragged.broadcast_i32(rplan, soff)
        k0m = torch.where(rvalid_g, gw0, mx)
        ggoff = goff0 + rplan.elem
        order = lexsort((k0m, gw1, gw2, ggoff))
        sk0, sk1, sk2, sgoff = k0m[order], gw1[order], gw2[order], ggoff[order]
        srgba, sseg, sglvl = gc[order], rplan.seg_of[order], glvl[order]
    else:
        z = torch.zeros(SPW, dtype=torch.int32, device=dev)
        sk0, sk1, sk2, sgoff, srgba, sseg, sglvl = (z + mx, z, z, z, z, z, z)
        n_spill = _i32(0, dev)
        memflag = torch.zeros((), dtype=torch.bool, device=dev)
        sv = torch.zeros(SS, dtype=torch.bool, device=dev)
        ssafe = torch.zeros(SS, dtype=torch.int32, device=dev)
    state.mem_capacity_reached |= memflag

    # taken nodes' spill intervals (their stored rows, contiguous post-sort)
    tnx, tny, tnz, tlv = (state.nx[tsafe], state.ny[tsafe], state.nz[tsafe],
                          state.level[tsafe])
    t_s0, t_s1 = morton.node_keys(tnx, tny, tnz, tlv)
    wkeys, skeys = pack2(work.k0, work.k1), pack2(sk0, sk1)
    zK = torch.zeros(K1, dtype=torch.int32, device=dev)
    tss = _lower_bound2(skeys, t_s0, t_s1, zK, zK + SPW)
    tse = _lower_bound2(skeys, *morton.node_keys(tnx, tny, tnz, tlv, end=True),
                        zK, zK + SPW)
    tss = torch.where(tv, torch.minimum(tss, n_spill), 0)
    tse = torch.where(tv, torch.minimum(tse, n_spill), 0)

    # --- create round-1 children; they seed the frontier ---
    state, base1, cnx1, cny1, cnz1, clvl1 = _create_children(
        cfg, state, tids, tv, sel.n_take1)
    seed = _child_rows(wkeys, skeys, tv, base1, cnx1, cny1, cnz1, clvl1,
                       sel.tstart, sel.tend, tss, tse, B)
    frontier = tuple(_pad_to(a, FW, f)
                     for a, f in zip(seed, _frontier_fill(B)))
    # final leaves: id, lvl, ws, we, ss, se
    fl = tuple(torch.zeros(FLW, dtype=torch.int32, device=dev)
               for _ in range(6))
    spill = Spill(k0=sk0, k1=sk1, k2=sk2, goff=sgoff, rgba=srgba, seg=sseg,
                  glvl=sglvl, n=n_spill, sv=sv, ssafe=ssafe, wkeys=wkeys,
                  skeys=skeys)
    # the cascade runs while the previous round split something (the JAX
    # loop carries n_take in its n_alive slot)
    return dict(spill=spill, casc=Cascade(frontier=frontier, leaves=fl,
                                          n_leaves=_i32(0, dev),
                                          n_took=sel.n_take1))


def _cascade_round(cfg: EngineConfig, state: OctreeState, work: Work,
                   sel: Select, spill: Spill, casc: Cascade) -> dict:
    """Stretch: one cascade round over the frontier. Rows over the budget
    split (at most CK of them) or wait for the next round; the rest are
    final leaves."""
    dev = state.device
    n_cap = state.child_base.shape[0]
    B = work.leaf.shape[0]
    _, CK, FW, FLW, _, _ = _split_widths(cfg)
    ecs_pad, frontier = sel.ecs_pad, casc.frontier
    c_id, c_lvl, c_nx, c_ny, c_nz, c_ws, c_we, c_ss, c_se = frontier
    alive = c_id >= 0
    wcnt = ecs_pad[c_we.clamp(0, B).long()] - ecs_pad[c_ws.clamp(0, B).long()]
    scnt2 = c_se - c_ss
    overc = alive & (wcnt + scnt2 > cfg.max_points_per_node) \
        & (c_lvl < cfg.max_depth)
    rank = cumsum32(overc.to(torch.int32))
    room = (state.num_nodes + 8 * rank) <= n_cap
    takec = overc & (rank <= CK) & room
    n_take = takec.sum(dtype=torch.int32)
    state.mem_capacity_reached |= (overc & ~room).any()

    ct, _ = compact_mask_via_sort(takec, frontier)
    ct_id, ct_lvl, ct_nx, ct_ny, ct_nz, ct_ws, ct_we, ct_ss, ct_se = ct
    ctv = iota(CK, dev) < n_take
    sl = lambda a, f: torch.where(ctv, a[:CK], f)
    ct_id = sl(ct_id, -1)
    ct_ws, ct_we = sl(ct_ws, B), sl(ct_we, B)
    ct_ss, ct_se = sl(ct_ss, 0), sl(ct_se, 0)

    state, baseC, cnxC, cnyC, cnzC, clvlC = _create_children(
        cfg, state, ct_id, ctv, n_take)
    rows = _child_rows(spill.wkeys, spill.skeys, ctv, baseC, cnxC, cnyC, cnzC,
                       clvlC, ct_ws, ct_we, ct_ss, ct_se, B)

    # frontier rows that are not over capacity are decided: leaves
    fl_n, lost = _append_leaves(casc.leaves, casc.n_leaves, FLW, FW,
                                (c_id, c_lvl, c_ws, c_we, c_ss, c_se),
                                alive & ~overc)
    state.mem_capacity_reached |= lost

    # next frontier = retained over-budget rows ++ the new children
    kept, n_keep = compact_mask_via_sort(overc & ~takec, frontier)
    kv = iota(FW, dev) < n_keep
    cat = tuple(torch.cat([torch.where(kv, k[:FW], f), r])
                for k, r, f in zip(kept, rows, _frontier_fill(B)))
    cat_c, n_alive = compact_mask_via_sort(cat[0] >= 0, cat)
    state.mem_capacity_reached |= n_alive > FW
    return dict(casc=Cascade(frontier=tuple(a[:FW] for a in cat_c),
                             leaves=casc.leaves, n_leaves=fl_n,
                             n_took=n_take))


def _leaves(cfg: EngineConfig, state: OctreeState, work: Work, sel: Select,
            spill: Spill, casc: Cascade, has_spill: bool) -> dict:
    """Stretch: the frontier rows left when the cascade ends are leaves as
    well; re-route both streams to the final leaves (one disjoint interval
    scatter + cumsum each), subdivide the stored segments straight to final
    depth (where any were spilled), and emit the voxel candidates up to the
    multi-level rounds."""
    dev = state.device
    n_cap = state.child_base.shape[0]
    s_cap = state.seg_node.shape[0]
    B = work.leaf.shape[0]
    _, _, FW, FLW, SS, SPW = _split_widths(cfg)
    RUNW = 8 * SS

    c_id, c_lvl, _, _, _, c_ws, c_we, c_ss, c_se = casc.frontier
    fl_n, lost = _append_leaves(casc.leaves, casc.n_leaves, FLW, FW,
                                (c_id, c_lvl, c_ws, c_we, c_ss, c_se),
                                c_id >= 0)
    state.mem_capacity_reached |= lost

    # --- final re-route: one disjoint interval-scatter + cumsum per stream ---
    fl_id, fl_lvl, fl_ws, fl_we, fl_ss, fl_se = casc.leaves
    flv = iota(FLW, dev) < fl_n
    pk = torch.where(flv, fl_id * 32 + fl_lvl + 1, 0)

    def reroute(n_rows, s_idx, e_idx):
        delta = torch.zeros(n_rows + 1, dtype=torch.int32, device=dev)
        scatter_drop(delta, torch.where(flv, s_idx, n_rows), pk, accumulate=True)
        scatter_drop(delta, torch.where(flv, e_idx, n_rows), -pk,
                     accumulate=True)
        return cumsum32(delta[:n_rows])

    cum_w = reroute(B, fl_ws, fl_we)
    new_leaf = torch.where(cum_w > 0, (cum_w - 1) >> 5, work.leaf)
    new_lvl = torch.where(cum_w > 0, (cum_w - 1) & 31, work.lvl)
    work = work._replace(leaf=new_leaf, lvl=new_lvl)
    runs = compute_runs(cfg, work)

    n_spill = spill.n
    cum_s = reroute(SPW, fl_ss, fl_se)

    # --- spilled rows join the voxel-candidate emission ---
    s_leaf, s_lo, s_cnt = morton.spill_floor(spill.k0, spill.k1, spill.k2,
                                             spill.glvl, cum_s, n_spill)
    spill_extra = (spill.k0, spill.k1, spill.k2, s_leaf, spill.rgba, s_lo,
                   s_cnt)

    # --- segment surgery: subdivide stored segments straight to final depth ---
    if has_spill:
        srow = iota(SPW, dev)
        svalid = srow < n_spill
        skey = torch.where(svalid, spill.seg, SS)
        order = lexsort((skey, s_leaf, spill.goff))
        o_seg, o_leaf, o_goff = skey[order], s_leaf[order], spill.goff[order]
        starts = svalid & ((o_seg != roll1(o_seg)) | (o_leaf != roll1(o_leaf))
                           | (srow == 0))
        pos_f, n_runs_all = compact_indices(starts)
        rw_i = iota(RUNW, dev)
        rok = rw_i < n_runs_all
        r_pos = torch.where(rok, torch.clamp(pos_f[:RUNW], max=SPW - 1), 0)
        r_leaf = o_leaf[r_pos.long()]
        r_goff = o_goff[r_pos.long()]
        nxt = torch.where(rw_i + 1 < n_runs_all,
                          torch.cat([r_pos[1:], r_pos[:1]]), n_spill)
        r_len = torch.where(rok, nxt - r_pos, 0)
        npos = state.num_segments + rw_i
        fit2 = rok & (npos < s_cap)
        widx2 = torch.where(fit2, npos, s_cap)
        scatter_drop(state.seg_node, widx2, r_leaf)
        scatter_drop(state.seg_off, widx2, r_goff)
        scatter_drop(state.seg_cnt, widx2, r_len)
        n_runs = fit2.sum(dtype=torch.int32)
        state.num_segments += n_runs
        state.mem_capacity_reached |= n_runs_all > n_runs
        # inherited counts: final leaves take over the stored points they own
        addi = torch.where(fit2, r_leaf, n_cap)
        addv = torch.where(fit2, r_len, 0)
        scatter_drop(state.counter, addi, addv, accumulate=True)
        scatter_drop(state.num_points, addi, addv, accumulate=True)
        scatter_drop(state.node_seg_count, addi, fit2.to(torch.int32),
                     accumulate=True)
        # kill the split nodes' old segments; zero their stored-point counts
        scatter_drop(state.seg_cnt, torch.where(spill.sv, spill.ssafe, s_cap),
                     0)
        tkill = torch.where(sel.tv, sel.tids.clamp(min=0), n_cap)
        scatter_drop(state.num_points, tkill, 0)
        scatter_drop(state.node_seg_count, tkill, 0)
    return dict(work=work, runs=runs,
                cand=_candidates(cfg, state, work, spill_extra))


def _candidates(cfg: EngineConfig, state: OctreeState, work: Work,
                spill_extra) -> Cand:
    """Emit the first-in-cell voxel candidates for every inner ancestor level
    (a point's first-in-cell levels form the contiguous range [lo, leaf level)).
    Single-level emitters append in place here; multi-level emitters come
    back as the block that _cand_round appends round-major."""
    dev = state.device
    lo, cnt = morton.prefix_floor(work.qx, work.qy, work.qz, work.valid,
                                  work.lvl)

    xw0, xw1, xw2, xleaf, xrgba, xlo, xcnt = spill_extra
    w0 = torch.cat([work.w0, xw0])
    w1 = torch.cat([work.w1, xw1])
    w2 = torch.cat([work.w2, xw2])
    leaf = torch.cat([work.leaf, xleaf])
    rgba_i = torch.cat([work.rgba, xrgba])
    lo = torch.cat([lo, xlo])
    cnt = torch.cat([cnt, xcnt])
    W2 = w0.shape[0]

    cls = torch.where(cnt == 1, 0, torch.where(cnt >= 2, 1, 2)).to(torch.int32)
    total = cnt.sum(dtype=torch.int32)
    inv_cnt = 31 - cnt
    if cfg.node_capacity <= (1 << 19):
        safe_leaf = leaf.clamp(0, (1 << 19) - 1)
        ckey = (cls << 29) | (inv_cnt << 24) | (safe_leaf << 5) | lo
        order = torch.sort(ckey, stable=True).indices
        skey, sw0, sw1, sw2, srgba = (ckey[order], w0[order], w1[order],
                                      w2[order], rgba_i[order])
        sleaf = (skey >> 5) & ((1 << 19) - 1)
        scnt = 31 - ((skey >> 24) & 31)
    else:
        ckey = (cls << 10) | (inv_cnt << 5) | lo
        order = torch.sort(ckey, stable=True).indices
        skey, sw0, sw1, sw2, sleaf, srgba = (ckey[order], w0[order], w1[order],
                                             w2[order], leaf[order],
                                             rgba_i[order])
        scnt = 31 - ((skey >> 5) & 31)
    slo = skey & 31
    n_single = (cls == 0).sum(dtype=torch.int32)
    n_multi = (cls == 1).sum(dtype=torch.int32)

    # --- single-level emitters: packed at [0, n_single), level == lo ---
    k0, k1, k2l = morton.key_words(sw0, sw1, sw2, slo)
    state = _append_voxels_prefix(cfg, state, k0, k1, k2l, sleaf, srgba,
                                  n_single)

    # --- multi-level emitters: a block of G2W rows after the single ones ---
    G2W = min(W2, cfg.cand_multi_rows or max(W2 // 4, 1024))
    grow = iota(G2W, dev)
    blk = (n_single.to(torch.int64) + torch.arange(G2W, device=dev))
    pz = lambda a: torch.cat([a, torch.zeros(G2W, dtype=a.dtype, device=dev)])
    ds = lambda a: pz(a)[blk]
    ecnt = torch.where(grow < n_multi, ds(scnt), 0)
    total2 = ecnt.sum(dtype=torch.int32)
    # overflow (multi rows past the G2W block window) is transient
    return Cand(w0=ds(sw0), w1=ds(sw1), w2=ds(sw2), leaf=ds(sleaf),
                lo=ds(slo), rgba=ds(srgba), ecnt=ecnt, rounds=ecnt.max(),
                dropped=torch.clamp(total - n_single - total2, min=0),
                r=_i32(0, dev))


def _cand_round(cfg: EngineConfig, state: OctreeState, cand: Cand) -> dict:
    """Stretch: one multi-level candidate round, a prefix append of the
    block's rows with ecnt > r at level lo + r."""
    r = cand.r
    k_r = (cand.ecnt > r).sum(dtype=torch.int32)
    ek0, ek1, ek2l = morton.key_words(cand.w0, cand.w1, cand.w2, cand.lo, r)
    room = torch.clamp(cfg.voxel_capacity - state.vox_used, min=0)
    n_new = torch.minimum(k_r, room)
    for col, val in ((state.vox_k0, ek0), (state.vox_k1, ek1),
                     (state.vox_k2l, ek2l), (state.vox_node, cand.leaf),
                     (state.vox_rgba, cand.rgba)):
        dus(col, val, state.vox_used)
    state.vox_used += n_new
    state.mem_capacity_reached |= k_r > room
    return dict(cand=cand._replace(r=r + 1))


def _insert(cfg: EngineConfig, state: OctreeState, work: Work, runs: Runs,
            cand: Cand) -> dict:
    """Stretch: count the dropped candidates, then insert the batch."""
    state.num_candidates_dropped += cand.dropped
    insert_points(cfg, state, work, runs)
    return {}


def eager(stretch: str, branch, fn, *args):
    """Run a stretch of the step (see _build) as it stands: the path of
    every state a BuildGraphs does not take."""
    with trace.span("build.eager"):
        return fn(*args)


def _build(cfg: EngineConfig, state: OctreeState, run, x, y, z, rgba, count,
           force_ids=None, phase=trace.span) -> OctreeState:
    """The build step as stretches between its device reads: `run(stretch,
    branch, fn, *args)` runs each (`eager`, or a BuildGraphs' replay) and
    returns fn's {role: value}. The reads: whether the round-1 splits spill
    stored points (which picks the gather's and the leaves' branch), whether
    the last cascade round split anything, and how many multi-level
    candidate rounds there are."""
    with phase("build.route"):
        s = run("route", None, _route_select, cfg, state, x, y, z, rgba,
                count, force_ids)
    work, sel = s["work"], s["sel"]
    with phase("build.split"):
        has_spill = trace.sync("build.spill", sel.spill)
        s = run("gather", has_spill, _gather, cfg, state, work, sel, has_spill)
        spill, casc = s["spill"], s["casc"]
        rounds = 0
        while rounds < cfg.split_rounds \
                and trace.sync("build.split_round", casc.n_took) > 0:
            casc = run("round", None, _cascade_round, cfg, state, work, sel,
                       spill, casc)["casc"]
            rounds += 1
    with phase("build.voxels"):
        s = run("leaves", has_spill, _leaves, cfg, state, work, sel, spill,
                casc, has_spill)
        work, runs, cand = s["work"], s["runs"], s["cand"]
        for _ in range(trace.sync("build.cand_rounds", cand.rounds)):
            cand = run("cand_round", None, _cand_round, cfg, state,
                       cand)["cand"]
    with phase("build.insert"):
        run("insert", None, _insert, cfg, state, work, runs, cand)
    return state


def insert_points(cfg: EngineConfig, state: OctreeState, work: Work, runs: Runs):
    """Bulk-append the routed batch to the point pool (one contiguous write at
    the watermark) and register one segment per leaf run."""
    dev = state.device
    n_cap = state.child_base.shape[0]
    s_cap = state.seg_node.shape[0]
    RW = runs.r_leaf.shape[0]

    rv0 = iota(RW, dev) < torch.clamp(runs.n_runs, max=RW)
    span = torch.where(rv0, runs.r_row + runs.r_cnt, 0).max()
    room = torch.clamp(cfg.point_capacity - state.pool_used, min=0)
    new_span = torch.minimum(span, room)
    state.mem_capacity_reached |= span > room

    for col, val in ((state.pt_w0, work.w0), (state.pt_w1, work.w1),
                     (state.pt_w2, work.w2), (state.pt_rgba, work.rgba)):
        dus(col, val, state.pool_used)

    n_runs = torch.clamp(runs.n_runs, max=RW)
    state.mem_capacity_reached |= runs.n_runs > RW
    r_start = torch.minimum(runs.r_row, new_span)
    r_end = torch.minimum(runs.r_row + runs.r_cnt, new_span)
    r_cnt = torch.clamp(r_end - r_start, min=0)
    rvalid = (iota(RW, dev) < n_runs) & (r_cnt > 0)

    pos = state.num_segments + iota(RW, dev)
    fit = rvalid & (pos < s_cap)
    sidx = torch.where(fit, pos, s_cap)
    scatter_drop(state.seg_node, sidx, runs.r_leaf)
    scatter_drop(state.seg_off, sidx, state.pool_used + r_start)
    scatter_drop(state.seg_cnt, sidx, r_cnt)
    state.num_segments += fit.sum(dtype=torch.int32)
    state.mem_capacity_reached |= (rvalid & ~fit).any()

    addi = torch.where(fit, runs.r_leaf, n_cap)
    addv = torch.where(fit, r_cnt, 0)
    scatter_drop(state.num_points, addi, addv, accumulate=True)
    scatter_drop(state.counter, addi, addv, accumulate=True)
    scatter_drop(state.node_seg_count, addi, fit.to(torch.int32),
                 accumulate=True)

    stored = torch.where(fit, r_cnt, 0).sum(dtype=torch.int32)
    state.pool_used += new_span
    state.pool_waste += new_span - stored
    state.num_points_processed += stored
    state.num_points_dropped += work.count - stored
    return state


def build_step(cfg: EngineConfig, state: OctreeState, x, y, z, rgba,
               count, graphs=None) -> OctreeState:
    """Ingest one batch: route -> split loop -> voxel sampling -> insert.
    x/y/z are f32 columns and rgba an int32 (u32 bit pattern) column, all of the
    same width on the state's device; `count` is the number of valid rows.
    With `graphs` (a BuildGraphs) on a state it takes, the step's stretches
    replay as CUDA graphs; otherwise they run eagerly."""
    with trace.span("build.step"):
        if graphs is not None and graphs.applies(state.device):
            run, (x, y, z, rgba, count) = graphs.step(cfg, state, x, y, z,
                                                      rgba, count)
        else:
            run = eager
        return _build(cfg, state, run, x, y, z, rgba, count)


def build_many(cfg: EngineConfig, state: OctreeState, x_batches, y_batches,
               z_batches, rgba_batches, counts, graphs=None) -> OctreeState:
    """Ingest K batches ([K, B] planes, `counts` host ints) in order, compacting
    the voxel store whenever it crosses the compaction watermark. `graphs`
    as in build_step."""
    wm = int(cfg.voxel_capacity * cfg.voxel_compact_watermark)
    with trace.span("build.many"):
        for k in range(x_batches.shape[0]):
            state = build_step(cfg, state, x_batches[k], y_batches[k],
                               z_batches[k], rgba_batches[k], int(counts[k]),
                               graphs)
            used = trace.sync("build.vox_used", state.vox_used)
            if used > wm:
                state = compact_voxels_auto(cfg, state, used=used)
    return state


def overfull_leaf_ids(cfg: EngineConfig, state: OctreeState):
    """Leaves still over the split threshold -> (ids [max_splits_per_round]
    front-compacted, -1 padded; total count)."""
    dev = state.device
    n_cap = state.child_base.shape[0]
    ids = iota(n_cap, dev)
    over = ((state.child_base < 0) & (ids < state.num_nodes)
            & (state.counter > cfg.max_points_per_node)
            & (state.level < cfg.max_depth))
    (sel,), n = compact_mask_via_sort(over, (ids,))
    K1 = cfg.max_splits_per_round
    kf = iota(K1, dev)
    sel = _pad_to(sel[:K1], K1, -1) if sel.shape[0] < K1 else sel[:K1]
    return torch.where(kf < torch.clamp(n, max=K1), sel, -1), n


# the finish pass carries no batch; a small work width keeps it cheap
_FINISH_B = 1024


def split_finish(cfg: EngineConfig, state: OctreeState,
                 force_ids: torch.Tensor) -> OctreeState:
    """One end-of-load split-convergence pass: split the given overfull leaves
    (the normal step machinery on an empty batch with a forced selection)."""
    dev = state.device
    zf = torch.zeros(_FINISH_B, dtype=torch.float32, device=dev)
    zc = torch.zeros(_FINISH_B, dtype=torch.int32, device=dev)
    return _build(cfg, state, eager, zf, zf, zf, zc, 0, force_ids,
                  phase=contextlib.nullcontext)


def _compact_voxels_core(cfg: EngineConfig, state: OctreeState,
                         w: int) -> OctreeState:
    """Sort the first `w` store rows by (level, global key), drop duplicate keys
    (first arrival wins: the sort is stable over append order), resolve each
    node group's id with one ancestor lookup, and rebuild the per-node
    (vox_voff, vox_vcnt) directory and exact counts. Rows [0, w) are rewritten
    in place."""
    dev = state.device
    n_cap = state.child_base.shape[0]
    rows = iota(w, dev)
    valid = rows < state.vox_used
    mx = I32_MAX
    # pack (lvl, k0, k1, cell) -> three lexicographic 31-bit words (see the JAX
    # package); all operands are non-negative, so int32 math is exact
    k0u = state.vox_k0[:w]
    k1u = state.vox_k1[:w]
    k2u = state.vox_k2l[:w]
    lvl = k2u & 31
    a0 = torch.where(valid, (lvl << 26) | (k0u >> 4), mx)
    a1 = torch.where(valid, ((k0u & 15) << 27) | (k1u >> 3), mx)
    a2 = torch.where(valid, ((k1u & 7) << 24) | (k2u & ~31), mx)
    order = lexsort((a0, a1, a2))
    sa0, sa1, sa2 = a0[order], a1[order], a2[order]
    siota = order.to(torch.int32)
    srgba = state.vox_rgba[:w][order]
    uniq = valid & ((sa0 != roll1(sa0)) | (sa1 != roll1(sa1))
                    | (sa2 != roll1(sa2)) | (rows == 0))
    # dedup compaction: unique rows are already ascending; a stable partition
    # moves them to the front
    (ca0, ca1, ca2, ciota, crgba), n_uniq = compact_mask_via_sort(
        uniq, (sa0, sa1, sa2, siota, srgba))
    cvalid = rows < n_uniq

    clvl = (ca0 >> 26) & 31
    ck0 = ((ca0 & ((1 << 26) - 1)) << 4) | ((ca1 >> 27) & 15)
    ck1 = ((ca1 & ((1 << 27) - 1)) << 3) | ((ca2 >> 24) & 7)
    ck2l = (ca2 & 0x00FFFFC0) | clvl
    ciota_s = torch.where(cvalid, ciota, 0)

    # node-group boundaries: level change or node-prefix change
    n0, n1, n2l = morton.key_words_at_level(ck0, ck1, ck2l & ~31,
                                            clvl - C.GRID_BITS)
    gstart = cvalid & ((clvl != roll1(clvl)) | (n0 != roll1(n0))
                       | (n1 != roll1(n1)) | (n2l != roll1(n2l))
                       | (rows == 0))
    NW = min(n_cap, w)
    g_pos, n_groups = compact_indices(gstart)
    gi = iota(NW, dev)
    gok = gi < n_groups
    g_row = torch.where(gok, torch.clamp(g_pos[:NW], max=w - 1), 0)
    g_lvl = clvl[g_row.long()]
    g_src = state.vox_node[ciota_s[g_row.long()].long()]
    g_row = torch.where(gok, g_row, w)
    g_node = state.anc[(torch.where(gok, g_src, 0) * (C.MAX_DEPTH + 1)
                        + torch.where(gok, g_lvl, 0)).long()]
    nxt = torch.where(gi + 1 < n_groups, torch.cat([g_row[1:], g_row[:1]]),
                      n_uniq)
    g_len = torch.where(gok, nxt - g_row, 0)

    # resolved node per row (broadcast from group starts: scatter-delta + cumsum)
    prev_node = roll1(g_node)
    prev_node[0] = 0
    delta = torch.where(gok, g_node - torch.where(gi > 0, prev_node, 0), 0)
    dacc = torch.zeros(w, dtype=torch.int32, device=dev)
    scatter_drop(dacc, torch.where(gok, g_row, w), delta, accumulate=True)
    cnode = cumsum32(dacc)

    zero = torch.zeros((), dtype=torch.int32, device=dev)
    state.vox_k0[:w] = torch.where(cvalid, ck0, zero)
    state.vox_k1[:w] = torch.where(cvalid, ck1, zero)
    state.vox_k2l[:w] = torch.where(cvalid, ck2l, zero)
    state.vox_node[:w] = torch.where(cvalid, cnode, zero)
    state.vox_rgba[:w] = torch.where(cvalid, crgba, zero)
    state.vox_used.copy_(n_uniq)
    state.vox_compacted.copy_(n_uniq)

    nidx = torch.where(gok, g_node, n_cap)
    scatter_drop(state.vox_voff.zero_(), nidx, g_row)
    scatter_drop(state.vox_vcnt.zero_(), nidx, g_len)
    scatter_drop(state.num_voxels.zero_(), nidx, g_len)
    state.mem_capacity_reached |= n_groups > NW
    return state


def compact_voxels(cfg: EngineConfig, state: OctreeState) -> OctreeState:
    """Full-capacity voxel compaction (see _compact_voxels_core)."""
    with trace.span("build.compact"):
        return _compact_voxels_core(cfg, state, state.vox_k0.shape[0])


def compact_voxels_auto(cfg: EngineConfig, state: OctreeState,
                        used: int | None = None) -> OctreeState:
    """Compaction over exactly the live rows [0, vox_used). `used` is the
    watermark if the caller already read it back."""
    with trace.span("build.compact"):
        if used is None:
            used = trace.sync("build.compact_used", state.vox_used)
        return _compact_voxels_core(cfg, state, max(int(used), 1))


def compact_segments(cfg: EngineConfig, state: OctreeState) -> OctreeState:
    """Drop dead (split-killed) segment directory entries."""
    with trace.span("build.compact"):
        s_cap = state.seg_node.shape[0]
        rows = iota(s_cap, state.device)
        alive = (rows < state.num_segments) & (state.seg_cnt > 0)
        (n, o, c), n_alive = compact_mask_via_sort(
            alive, (state.seg_node, state.seg_off, state.seg_cnt))
        keep = rows < n_alive
        state.seg_node.copy_(torch.where(keep, n, -1))
        state.seg_off.copy_(torch.where(keep, o, 0))
        state.seg_cnt.copy_(torch.where(keep, c, 0))
        state.num_segments.copy_(n_alive)
        return state
