"""Frame assembly (port of the exact path of simlod_tpu/render/render.py; the
reference's kernel_render, render.cu:1084-1345): LOD selection -> sample
gathering -> rasterization -> EDL -> RGBA image + visible stats.

The pooled (screen-budgeted) render and the line overlays are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..config import EngineConfig, Uniforms
from ..octree.structures import OctreeState
from . import raster, raster_tiles, visibility


class FrameStats(NamedTuple):
    num_visible_nodes: torch.Tensor
    num_visible_inner: torch.Tensor
    num_visible_leaves: torch.Tensor
    num_visible_points: torch.Tensor
    num_visible_voxels: torch.Tensor
    # visible samples exceeded the frame's sample windows: some were not drawn
    truncated: torch.Tensor


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
                  seg_window: int | None = None):
    """LOD selection and sample gathering of one frame -> (vis, [points, voxels],
    directory-window overflow flag)."""
    over = torch.zeros((), dtype=torch.bool, device=state.device)
    if node_window is not None:
        over = over | (state.num_nodes > node_window)
    if seg_window is not None:
        over = over | (state.num_segments > seg_window)
    state = _trim_directories(state, node_window, seg_window)
    vis = visibility.compute_visibility(state, uniforms)
    pts = raster.gather_point_samples(cfg, state, vis.emitted, point_window)
    vox = raster.gather_voxel_samples(cfg, state, vis.emitted, voxel_window)
    # honour showPoints: drop both sample sets (render.cu:214)
    pts = pts._replace(valid=pts.valid & uniforms.show_points)
    vox = vox._replace(valid=vox.valid & uniforms.show_points)
    return vis, [pts, vox], over


def render_components(cfg: EngineConfig, state: OctreeState, width: int,
                      height: int, uniforms: Uniforms,
                      point_window: int | None = None,
                      voxel_window: int | None = None,
                      node_window: int | None = None,
                      seg_window: int | None = None):
    """Render one frame without EDL; returns (color i32 [H*W] (u32 bits),
    depth_bits i32 [H*W], FrameStats). With cfg.use_tile_raster (the default)
    the frame goes through raster_tiles on every device; on the card that is
    the CUDA tile kernel."""
    if bool(uniforms.show_bounding_box):
        raise NotImplementedError("line overlays: later PR")
    vis, sets, over = frame_samples(cfg, state, uniforms, point_window,
                                    voxel_window, node_window, seg_window)
    if cfg.use_tile_raster:
        color, depth = raster_tiles.rasterize_tiles(cfg, uniforms, width, height,
                                                    sets)
    else:
        color, depth = raster.rasterize(cfg, uniforms, width, height, sets)

    pw = ((point_window or cfg.max_render_points) // 128) * 128
    vw = ((voxel_window or cfg.max_render_voxels) // 128) * 128
    stats = FrameStats(
        num_visible_nodes=vis.num_visible_nodes,
        num_visible_inner=vis.num_visible_inner,
        num_visible_leaves=vis.num_visible_leaves,
        num_visible_points=vis.num_visible_points,
        num_visible_voxels=vis.num_visible_voxels,
        truncated=(vis.num_visible_points > pw) | (vis.num_visible_voxels > vw)
        | over,
    )
    return color, depth, stats


def render_frame(cfg: EngineConfig, state: OctreeState, width: int, height: int,
                 uniforms: Uniforms, point_window: int | None = None,
                 voxel_window: int | None = None,
                 node_window: int | None = None,
                 seg_window: int | None = None):
    """Render one frame (components + EDL). Returns (rgba i32 [H, W] (u32 bits),
    FrameStats)."""
    color, depth, stats = render_components(
        cfg, state, width, height, uniforms, point_window, voxel_window,
        node_window, seg_window)
    color = raster.edl(color, depth, uniforms, width, height)
    return color.reshape(height, width), stats


def image_to_rgba8(img) -> np.ndarray:
    """u32 abgr words (or their int32 bit patterns) -> [H, W, 4] uint8."""
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    img = np.asarray(img).view(np.uint32)
    out = np.zeros(img.shape + (4,), np.uint8)
    for k in range(4):
        out[..., k] = (img >> (8 * k)) & 0xFF
    return out
