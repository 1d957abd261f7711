"""Frame assembly (port of simlod_tpu/render/render.py; the reference's
kernel_render, render.cu:1084-1345): LOD selection -> sample gathering ->
rasterization -> optional box overlays -> EDL -> RGBA image + visible stats, on
the exact path and on the pooled (screen-budgeted) path through
render/drawpool.py. `composite_frames` depth-min blends frames rendered
separately (out-of-core bricks) before one EDL pass.

The JAX package scans K frames in one program (render_frames*); here that is a
Python loop.

The JAX package jits render_frame and render_frame_pooled on their static
arguments (simlod_tpu/render/render.py:139-142, 237-242). Their counterpart
here is graphs.FrameGraphs: a frame's span recorded once per static key
(`frame_key`) as a CUDA graph and replayed as one unit. The functions below
stay the un-jitted bodies: the CPU path, and what a graph records.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..config import EngineConfig, Uniforms
from ..graphs import _tensor_key
from ..octree.structures import OctreeState
from ..ops import ragged
from . import drawpool, lines, raster, raster_tiles, visibility


class FrameStats(NamedTuple):
    num_visible_nodes: torch.Tensor
    num_visible_inner: torch.Tensor
    num_visible_leaves: torch.Tensor
    num_visible_points: torch.Tensor
    num_visible_voxels: torch.Tensor
    # visible samples exceeded the frame's sample windows: some were not drawn
    truncated: torch.Tensor
    # exact frames: the rows of window the points', the voxels' and the
    # voxel tail's plans fill (ragged.window_need), and the tail rows drawn
    need_points: torch.Tensor | None = None
    need_voxels: torch.Tensor | None = None
    need_tail: torch.Tensor | None = None
    tail_rows: torch.Tensor | None = None


def _trim_directories(state: OctreeState, node_window: int | None,
                      seg_window: int | None) -> OctreeState:
    """View of `state` with the per-node and per-segment columns sliced to the
    windows (consumers key off `ids < num_nodes` masks and column lengths)."""
    rep = {}
    if node_window is not None and node_window < state.child_base.shape[0]:
        rep.update({f: getattr(state, f)[:node_window] for f in
                    ("nx", "ny", "nz", "level", "parent", "child_base",
                     "num_points", "num_voxels", "vox_voff", "vox_vcnt")})
    if seg_window is not None and seg_window < state.seg_node.shape[0]:
        rep.update({f: getattr(state, f)[:seg_window] for f in
                    ("seg_node", "seg_off", "seg_cnt")})
    return dataclasses.replace(state, **rep) if rep else state


def frame_samples(cfg: EngineConfig, state: OctreeState, uniforms: Uniforms,
                  point_window: int | None = None,
                  voxel_window: int | None = None,
                  node_window: int | None = None,
                  seg_window: int | None = None,
                  tail: raster.VoxelTail | None = None,
                  tail_window: int | None = None):
    """LOD selection and the sample sources of one frame -> (vis, [points,
    voxels] and with `tail` the tail's voxels, directory-window overflow
    flag)."""
    over = torch.zeros((), dtype=torch.bool, device=state.device)
    if node_window is not None:
        over = over | (state.num_nodes > node_window)
    if seg_window is not None:
        over = over | (state.num_segments > seg_window)
    state = _trim_directories(state, node_window, seg_window)
    vis = visibility.compute_visibility(state, uniforms)
    specs = [raster.point_spec(cfg, state, vis.emitted, point_window),
             raster.voxel_spec(cfg, state, vis.emitted, voxel_window)]
    if tail is not None:
        specs.append(raster.tail_spec(cfg, tail, vis.emitted, tail_window))
    plans = ragged.plan_blocks_many(specs)
    sets = [raster.state_point_source(state, plans[0]),
            raster.state_voxel_source(state, plans[1])]
    if tail is not None:
        sets.append(raster.tail_voxel_source(state, tail, plans[2]))
    # honour showPoints: drop every sample set (render.cu:214)
    return vis, [s._replace(show=uniforms.show_points) for s in sets], over


def _rasterize(cfg: EngineConfig, uniforms: Uniforms, width: int, height: int,
               sets, state: OctreeState, emitted: torch.Tensor):
    """Draw the sample sets, then (with show_bounding_box) the emitted nodes'
    boxes and the frozen-camera frustum over them. cfg.use_tile_raster is the
    only switch: by default the sample sources go through raster.rasterize
    (on the card the CUDA splat_samples kernel), with it through raster_tiles
    (materialized, sorted, then the CUDA tile kernel). On CPU tensors each
    uses its kernel's plain version."""
    if cfg.use_tile_raster:
        color, depth = raster_tiles.rasterize_tiles(cfg, uniforms, width,
                                                    height, sets)
    else:
        color, depth = raster.rasterize(cfg, uniforms, width, height, sets)
    if not uniforms.flags.show_bounding_box:
        return color, depth
    # the frustum rides the same flag and draw list as in the reference
    # (render.cu:1197-1229)
    box = lines.node_box_lines(state, emitted, cfg.max_render_lines)
    fru = lines.frustum_lines(uniforms)
    return lines.rasterize_lines(cfg, uniforms, width, height, color, depth,
                                 *(torch.cat([p, q]) for p, q in zip(box, fru)))


def _frame_stats(vis, truncated) -> FrameStats:
    return FrameStats(
        num_visible_nodes=vis.num_visible_nodes,
        num_visible_inner=vis.num_visible_inner,
        num_visible_leaves=vis.num_visible_leaves,
        num_visible_points=vis.num_visible_points,
        num_visible_voxels=vis.num_visible_voxels,
        truncated=truncated)


def render_components(cfg: EngineConfig, state: OctreeState, width: int,
                      height: int, uniforms: Uniforms,
                      point_window: int | None = None,
                      voxel_window: int | None = None,
                      node_window: int | None = None,
                      seg_window: int | None = None,
                      tail: raster.VoxelTail | None = None,
                      tail_window: int | None = None):
    """Render one frame without EDL; returns (color i32 [H*W] (u32 bits),
    depth_bits i32 [H*W], FrameStats). With `tail` the frame draws the
    emitted nodes' tail voxels too (raster.VoxelTail).

    The frame is truncated where the JAX package's is (visible samples past
    a window, or live directories past theirs) and, beyond it, where a
    plan's phase padding pushes drawn rows past its window
    (ragged.window_need): every frame that drops a sample says so."""
    vis, sets, over = frame_samples(cfg, state, uniforms, point_window,
                                    voxel_window, node_window, seg_window,
                                    tail, tail_window)
    color, depth = _rasterize(cfg, uniforms, width, height, sets, state,
                              vis.emitted)
    pw = ((point_window or cfg.max_render_points) // 128) * 128
    vw = ((voxel_window or cfg.max_render_voxels) // 128) * 128
    em = vis.emitted
    n = em.shape[0]
    st = _trim_directories(state, node_window, seg_window)
    need_p = ragged.window_need(st.seg_off, st.seg_cnt, em, st.seg_node)
    need_v = ragged.window_need(st.vox_voff, st.vox_vcnt, em)
    trunc = (vis.num_visible_points > pw) | (vis.num_visible_voxels > vw) \
        | (need_p > pw) | (need_v > vw) | over
    zero = torch.zeros((), dtype=torch.int32, device=state.device)
    need_t = tail_rows = zero
    if tail is not None:
        tw = ((tail_window or cfg.max_render_voxels) // 128) * 128
        need_t = ragged.window_need(tail.voff[:n], tail.vcnt[:n], em)
        tail_rows = torch.where(em, tail.vcnt[:n], 0).sum(dtype=torch.int32)
        trunc = trunc | (need_t > tw)
    return color, depth, _frame_stats(vis, trunc)._replace(
        need_points=need_p, need_voxels=need_v, need_tail=need_t,
        tail_rows=tail_rows)


def render_frame(cfg: EngineConfig, state: OctreeState, width: int, height: int,
                 uniforms: Uniforms, point_window: int | None = None,
                 voxel_window: int | None = None,
                 node_window: int | None = None,
                 seg_window: int | None = None,
                 tail: raster.VoxelTail | None = None,
                 tail_window: int | None = None):
    """Render one frame (components + EDL). Returns (rgba i32 [H, W] (u32 bits),
    FrameStats)."""
    color, depth, stats = render_components(
        cfg, state, width, height, uniforms, point_window, voxel_window,
        node_window, seg_window, tail, tail_window)
    color = raster.edl(color, depth, uniforms, width, height)
    return color.reshape(height, width), stats


def render_frames(cfg: EngineConfig, state: OctreeState, width: int,
                  height: int, uniforms_seq, point_window: int | None = None,
                  voxel_window: int | None = None,
                  node_window: int | None = None,
                  seg_window: int | None = None):
    """Render one frame per Uniforms of `uniforms_seq` (a camera path); returns
    the last image and the last frame's stats with `truncated` OR-ed over all
    frames (the JAX package scans the stacked uniforms in one program)."""
    return _frames(lambda u: render_frame(
        cfg, state, width, height, u, point_window, voxel_window, node_window,
        seg_window), uniforms_seq)


def _frames(render_one, uniforms_seq):
    img = trunc = stats = None
    for u in uniforms_seq:
        img, stats = render_one(u)
        trunc = stats.truncated if trunc is None else trunc | stats.truncated
    if img is None:
        raise ValueError("render_frames: no uniforms given")
    return img, stats._replace(truncated=trunc)


def _trim_pool(pool: drawpool.DrawPool, node_window: int | None):
    if node_window is None or node_window >= pool.pt_off.shape[0]:
        return pool
    nw = node_window
    return pool._replace(pt_off=pool.pt_off[:nw], pt_cnt=pool.pt_cnt[:nw],
                         vx_off=pool.vx_off[:nw], vx_cnt=pool.vx_cnt[:nw])


def pooled_frame_samples(cfg: EngineConfig, state: OctreeState,
                         pool: drawpool.DrawPool, uniforms: Uniforms,
                         pool_pw: int, pool_vw: int, exact_pw: int,
                         exact_vw: int, node_window: int | None = None,
                         seg_window: int | None = None):
    """LOD selection and sample gathering of one screen-budgeted frame ->
    (vis, [pool points, pool voxels, exact points, exact voxels], truncated).

    Budgeted prefixes of the pool for emitted nodes it holds, the exact path
    for nodes above draw_cap and nodes the pool misses. Equal to frame_samples'
    frame whenever every node's budget clears its sample count."""
    over = torch.zeros((), dtype=torch.bool, device=state.device)
    if node_window is not None:
        over = over | (state.num_nodes > node_window)
    if seg_window is not None:
        over = over | (state.num_segments > seg_window)
    state = _trim_directories(state, node_window, seg_window)
    pool = _trim_pool(pool, node_window)
    vis = visibility.compute_visibility(state, uniforms, pool, cfg)
    plans = ragged.plan_blocks_many([
        drawpool.pool_point_spec(pool, vis.take_p, pool_pw),
        drawpool.pool_voxel_spec(pool, vis.take_v, pool_vw),
        raster.point_spec(cfg, state, vis.exact_p, exact_pw),
        raster.voxel_spec(cfg, state, vis.exact_v, exact_vw)])
    pp = drawpool.pool_point_source(state, pool, plans[0])
    pv = drawpool.pool_voxel_source(state, pool, plans[1])
    ep = raster.state_point_source(state, plans[2])
    ev = raster.state_voxel_source(state, plans[3])
    sets = [s._replace(show=uniforms.show_points) for s in (pp, pv, ep, ev)]
    # any sample set reaching its window dropped drawn samples (>=, where the
    # exact path's test is >: the JAX package's two tests)
    trunc = (pp.count >= pool_pw) | (pv.count >= pool_vw) \
        | (ep.count >= exact_pw) | (ev.count >= exact_vw) | over
    return vis, sets, trunc


def render_components_pooled(cfg: EngineConfig, state: OctreeState,
                             pool: drawpool.DrawPool, width: int, height: int,
                             uniforms: Uniforms, pool_pw: int, pool_vw: int,
                             exact_pw: int, exact_vw: int,
                             node_window: int | None = None,
                             seg_window: int | None = None):
    """Screen-budgeted frame without EDL -> (color, depth_bits, FrameStats);
    the four sample sets go through one rasterization."""
    vis, sets, trunc = pooled_frame_samples(
        cfg, state, pool, uniforms, pool_pw, pool_vw, exact_pw, exact_vw,
        node_window, seg_window)
    color, depth = _rasterize(cfg, uniforms, width, height, sets, state,
                              vis.emitted)
    return color, depth, _frame_stats(vis, trunc)


def render_frame_pooled(cfg: EngineConfig, state: OctreeState,
                        pool: drawpool.DrawPool, width: int, height: int,
                        uniforms: Uniforms, pool_pw: int, pool_vw: int,
                        exact_pw: int, exact_vw: int,
                        node_window: int | None = None,
                        seg_window: int | None = None):
    """Screen-budgeted frame (components + EDL) -> (rgba i32 [H, W],
    FrameStats)."""
    color, depth, stats = render_components_pooled(
        cfg, state, pool, width, height, uniforms, pool_pw, pool_vw, exact_pw,
        exact_vw, node_window, seg_window)
    color = raster.edl(color, depth, uniforms, width, height)
    return color.reshape(height, width), stats


def render_frames_pooled(cfg: EngineConfig, state: OctreeState,
                         pool: drawpool.DrawPool, width: int, height: int,
                         uniforms_seq, pool_pw: int, pool_vw: int,
                         exact_pw: int, exact_vw: int,
                         node_window: int | None = None,
                         seg_window: int | None = None):
    """Pooled analogue of render_frames."""
    return _frames(lambda u: render_frame_pooled(
        cfg, state, pool, width, height, u, pool_pw, pool_vw, exact_pw,
        exact_vw, node_window, seg_window), uniforms_seq)


def frame_key(cfg: EngineConfig, width: int, height: int, windows,
              uniforms: Uniforms, state: OctreeState,
              pool: drawpool.DrawPool | None = None,
              tail: raster.VoxelTail | None = None) -> tuple:
    """The static key of a frame's graph: the JAX package's static
    arguments (cfg, which holds use_tile_raster, width, height and the
    windows: the exact frame's four, a fused frame's five, or the pooled
    frame's six), the host switches that change the launch sequence
    (uniforms.flags), exact or pooled, with a voxel tail or not, and what a
    graph freezes: the pointer and shape of every state, pool, tail and
    uniform tensor."""
    return (cfg, width, height, tuple(windows), uniforms.flags,
            pool is not None, tail is not None, _tensor_key(state),
            _tensor_key(pool), _tensor_key(tail), _tensor_key(uniforms))


def probe_pooled_counts(cfg: EngineConfig, state: OctreeState,
                        pool: drawpool.DrawPool, uniforms: Uniforms):
    """(pool_pts, pool_vox, exact_pts, exact_vox) drawn-sample window demand
    of the pooled path, as 0-d int32 tensors: the pooled counts are the exact
    128-row blocks the budgeted prefix plans fetch, the exact counts add 256
    rows of phase padding per node."""
    vis = visibility.compute_visibility(state, uniforms, pool, cfg)
    tp, tv, m_ep, m_ev = vis.take_p, vis.take_v, vis.exact_p, vis.exact_v
    rp = torch.where(tp > 0, torch.div(pool.pt_off % 128 + tp + 127, 128,
                                       rounding_mode="floor"), 0)
    rv = torch.where(tv > 0, torch.div(pool.vx_off % 128 + tv + 127, 128,
                                       rounding_mode="floor"), 0)
    i32 = lambda a: a.sum(dtype=torch.int32)
    pad = 2 * 128
    pp = 128 * i32(rp)
    pv = 128 * i32(rv)
    ep = i32(torch.where(m_ep, state.num_points, 0)) \
        + pad * i32(m_ep & (state.num_points > 0))
    ev = i32(torch.where(m_ev, state.num_voxels, 0)) \
        + pad * i32(m_ev & (state.num_voxels > 0))
    return pp, pv, ep, ev


def probe_visible_counts(state: OctreeState, uniforms: Uniforms):
    """(num_visible_points, num_visible_voxels) without rendering."""
    vis = visibility.compute_visibility(state, uniforms)
    return vis.num_visible_points, vis.num_visible_voxels


def composite_frames(colors: torch.Tensor, depths: torch.Tensor,
                     uniforms: Uniforms, width: int, height: int):
    """Depth-min composite of separately rendered (colour, depth) planes plus
    one EDL pass: equal to rendering their union state, since the u64
    atomicMin winner rule is associative (reference blend, render.cu:95-99).

    colors/depths are [K, H*W] stacks (u32 colour bits / f32 depth bits as
    int32; positive-float bits order like the floats, so the integer min is the
    depth test, and ties go to the lower plane index). Returns (image i32
    [H, W], depth i32 [H*W])."""
    k = torch.argmin(depths, dim=0, keepdim=True)
    depth = torch.take_along_dim(depths, k, dim=0)[0]
    color = torch.take_along_dim(colors, k, dim=0)[0]
    color = raster.edl(color, depth, uniforms, width, height)
    return color.reshape(height, width), depth


def image_to_rgba8(img) -> np.ndarray:
    """u32 abgr words (or their int32 bit patterns) -> [H, W, 4] uint8."""
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    img = np.asarray(img).view(np.uint32)
    out = np.zeros(img.shape + (4,), np.uint8)
    for k in range(4):
        out[..., k] = (img >> (8 * k)) & 0xFF
    return out


def write_ppm(path: str, img) -> None:
    """Minimal dependency-free image writer (binary PPM, RGB), flipped from
    GL-style y-up rows to image y-down."""
    rgba = image_to_rgba8(img)
    h, w = rgba.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(rgba[::-1, :, :3].tobytes())
