"""Visible-node selection with pixel-projected-size LOD (port of
simlod_tpu/render/visibility.py; the reference's compute_visibility_disjunct,
render.cu:690-934), one dense pass over the node columns.

  node emitted  <=>  (parent.isLarge and not node.isLarge and node.visible)
                 or  (node.isLarge and node.isLeaf and node.visible)
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import Uniforms
from ..octree.structures import OctreeState
from . import frustum


class Visibility(NamedTuple):
    emitted: torch.Tensor       # [N] bool: node's samples are drawn this frame
    visible: torch.Tensor       # [N] bool
    is_large: torch.Tensor      # [N] bool
    dx: torch.Tensor            # [N] f32 screen extent (render.cu:817)
    dy: torch.Tensor            # [N] f32
    num_visible_nodes: torch.Tensor
    num_visible_inner: torch.Tensor
    num_visible_leaves: torch.Tensor
    num_visible_points: torch.Tensor
    num_visible_voxels: torch.Tensor


def compute_visibility(state: OctreeState, uniforms: Uniforms) -> Visibility:
    n_cap = state.child_base.shape[0]
    dev = state.child_base.device
    ids = torch.arange(n_cap, dtype=torch.int32, device=dev)
    active = ids < state.num_nodes

    f32 = torch.float32
    size = state.cube_size / torch.exp2(state.level.to(f32))
    mnx = state.box_min[0] + size * state.nx.to(f32)
    mny = state.box_min[1] + size * state.ny.to(f32)
    mnz = state.box_min[2] + size * state.nz.to(f32)
    mxx, mxy, mxz = mnx + size, mny + size, mnz + size

    # 8 corners -> screen extents (reference render.cu:780-846)
    m = uniforms.transform_update_bound
    big = 3.4e38
    sminx = torch.full((n_cap,), big, dtype=f32, device=dev)
    smaxx = torch.full((n_cap,), -big, dtype=f32, device=dev)
    sminy = sminx.clone()
    smaxy = smaxx.clone()
    for c in range(8):
        px = mxx if (c >> 2) & 1 else mnx
        py = mxy if (c >> 1) & 1 else mny
        pz = mxz if c & 1 else mnz
        n0 = px * m[0, 0] + py * m[0, 1] + pz * m[0, 2] + m[0, 3]
        n1 = px * m[1, 0] + py * m[1, 1] + pz * m[1, 2] + m[1, 3]
        w = px * m[3, 0] + py * m[3, 1] + pz * m[3, 2] + m[3, 3]
        sx = (n0 / w * 0.5 + 0.5) * uniforms.width
        sy = (n1 / w * 0.5 + 0.5) * uniforms.height
        sminx = torch.minimum(sminx, sx)
        smaxx = torch.maximum(smaxx, sx)
        sminy = torch.minimum(sminy, sy)
        smaxy = torch.maximum(smaxy, sy)
    dx = smaxx - sminx
    dy = smaxy - sminy

    planes = frustum.frustum_planes(m)
    in_frustum = frustum.intersects_frustum_cols(
        planes, mnx, mny, mnz, mxx, mxy, mxz)
    # num_voxels is exact only after compaction; a fresh inner node counts as
    # having samples
    has_samples = (state.num_points > 0) | (state.num_voxels > 0) \
        | (state.child_base >= 0)
    visible = active & in_frustum & has_samples
    is_large = active & ((dx > 2.0 * uniforms.min_node_size)
                         | (dy > 2.0 * uniforms.min_node_size))

    parent = state.parent.clamp(0, n_cap - 1).long()
    parent_large = (state.parent >= 0) & is_large[parent]
    is_leaf = state.child_base < 0
    emitted = visible & ((parent_large & ~is_large) | (is_large & is_leaf))

    # stats replicate makeVisible (render.cu:744-758)
    asz = lambda b: b.sum(dtype=torch.int32)
    leafish = emitted & (state.num_points > 0)
    innerish = emitted & (state.num_points == 0) & (state.num_voxels > 0)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return Visibility(
        emitted=emitted, visible=visible, is_large=is_large, dx=dx, dy=dy,
        num_visible_nodes=asz(emitted),
        num_visible_inner=asz(innerish),
        num_visible_leaves=asz(leafish),
        num_visible_points=torch.where(leafish, state.num_points, zero)
        .sum(dtype=torch.int32),
        num_visible_voxels=torch.where(innerish, state.num_voxels, zero)
        .sum(dtype=torch.int32),
    )
