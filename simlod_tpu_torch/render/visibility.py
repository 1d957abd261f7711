"""Visible-node selection with pixel-projected-size LOD (port of
simlod_tpu/render/visibility.py; the reference's compute_visibility_disjunct,
render.cu:690-934), one dense pass over the node columns.

  node emitted  <=>  (parent.isLarge and not node.isLarge and node.visible)
                 or  (node.isLarge and node.isLeaf and node.visible)

`compute_visibility` takes the CUDA kernel csrc/frame.cu (`visibility`,
`compute_visibility_cuda`) for CUDA tensors and its plain PyTorch version
`compute_visibility_reference` for CPU tensors. With a draw pool both also
return the pooled frame's per-node takes and exact masks
(render/drawpool.py node_budgets, split_masks, _pool_take).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..config import EngineConfig, Uniforms
from ..octree.structures import OctreeState
from . import drawpool, frustum


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
    # with a draw pool: the pooled frame's per-node takes (drawpool._pool_take
    # of the split masks and budgets) and exact-path masks
    take_p: torch.Tensor | None = None   # [N] i32
    take_v: torch.Tensor | None = None   # [N] i32
    exact_p: torch.Tensor | None = None  # [N] bool
    exact_v: torch.Tensor | None = None  # [N] bool


def compute_visibility(state: OctreeState, uniforms: Uniforms, pool=None,
                       cfg: EngineConfig | None = None) -> Visibility:
    """LOD selection of one frame over the node columns of `state` (a
    trimmed directory is a view with shorter node columns); with a draw pool
    (and cfg for its draw_cap) also the pooled frame's takes and exact masks.
    The CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    impl = compute_visibility_cuda if state.child_base.is_cuda \
        else compute_visibility_reference
    return impl(state, uniforms, pool, cfg)


def compute_visibility_reference(state: OctreeState, uniforms: Uniforms,
                                 pool=None, cfg: EngineConfig | None = None
                                 ) -> Visibility:
    """Plain PyTorch version of the visibility kernel."""
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
    vis = Visibility(
        emitted=emitted, visible=visible, is_large=is_large, dx=dx, dy=dy,
        num_visible_nodes=asz(emitted),
        num_visible_inner=asz(innerish),
        num_visible_leaves=asz(leafish),
        num_visible_points=torch.where(leafish, state.num_points, zero)
        .sum(dtype=torch.int32),
        num_visible_voxels=torch.where(innerish, state.num_voxels, zero)
        .sum(dtype=torch.int32),
    )
    if pool is None:
        return vis
    budgets = drawpool.node_budgets(cfg, vis, uniforms)
    m_pp, m_ep, m_pv, m_ev = drawpool.split_masks(cfg, state, vis, pool)
    return vis._replace(
        take_p=drawpool._pool_take(m_pp, pool.pt_cnt, budgets),
        take_v=drawpool._pool_take(m_pv, pool.vx_cnt, budgets),
        exact_p=m_ep, exact_v=m_ev)


# node columns the kernel reads, in the order of csrc/frame.cu's VisArgs
_NODE_COLUMNS = ("nx", "ny", "nz", "level", "parent", "child_base",
                 "num_points", "num_voxels")


@kernels.counted
def compute_visibility_cuda(state: OctreeState, uniforms: Uniforms,
                            pool=None, cfg: EngineConfig | None = None
                            ) -> Visibility:
    """The CUDA kernel csrc/frame.cu (`simlod_visibility`) on a state of
    CUDA tensors; raises for anything else. Same arguments and result as
    compute_visibility_reference, bit for bit (dx, dy as bit patterns: NaN
    where a corner lies on the eye plane, as there).

    It replaces the ~300 torch launches of the plain version (8 corners x
    ~30 elementwise ops, the frustum test, the parent gather, five sums, and
    with a pool the budgets, masks and takes) that XLA fuses in the JAX
    package's jitted frame (simlod_tpu/render/visibility.py:42) with one
    cooperative launch: one thread per node slot, the counts as partial rows
    summed after a grid barrier (no memset). Its bytes (32 B read a node, 11
    B written; with a pool 8 B more read and 10 B more written) take under a
    microsecond at a frame's 8,192 slots: the launch bounds it, so the host
    side is one check per column, a torch.empty per output and one for the
    partial rows (chip_smoke's host_breakdown times an arena against them:
    no clear gain), and one ctypes call. The frame's scalars and frustum
    planes are read on the device (`uniforms.vis`, 44 floats that the
    frame's one uniform copy fills), num_nodes through a pointer: no host
    read and no per-frame value by value, so that a captured launch reads
    each replay's camera. Each call adds one to
    `compute_visibility_cuda.launches`."""
    dev = state.child_base.device
    n = state.child_base.shape[0]
    i32, f32 = torch.int32, torch.float32
    where = "compute_visibility_cuda"
    shape = (n,)
    ptrs = [kernels.data_ptr(getattr(state, f), where, f, i32, dev, shape)
            for f in _NODE_COLUMNS]
    ptrs += [kernels.data_ptr(state.num_nodes, where, "num_nodes", i32, dev,
                              ()),
             kernels.data_ptr(state.box_min, where, "box_min", f32, dev, (3,)),
             kernels.data_ptr(state.cube_size, where, "cube_size", f32, dev,
                              ())]
    pooled = pool is not None
    if pooled:
        if cfg is None:
            raise ValueError(f"{where}: a pool needs cfg (its draw_cap)")
        ptrs += [kernels.data_ptr(pool.pt_cnt, where, "pool.pt_cnt", i32, dev,
                                  shape),
                 kernels.data_ptr(pool.vx_cnt, where, "pool.vx_cnt", i32, dev,
                                  shape)]
    else:
        ptrs += [0, 0]
    # VisArgs' outputs: emitted, visible, is_large, dx, dy, counts, (take_p,
    # take_v, exact_p, exact_v), then one partial row of 5 counts for each
    # of the ceil(n / 256) blocks (at most 4096) a launch may have
    b8 = torch.bool
    out = [torch.empty(n, dtype=dt, device=dev)
           for dt in (b8, b8, b8, f32, f32)]
    counts = torch.empty(5, dtype=i32, device=dev)
    extra = [torch.empty(n, dtype=dt, device=dev)
             for dt in (i32, i32, b8, b8)] if pooled else []
    partials = torch.empty(5 * min(-(-n // 256), 4096), dtype=i32, device=dev)
    ptrs += [t.data_ptr() for t in (*out, counts)] \
        + ([t.data_ptr() for t in extra] or [0] * 4) + [partials.data_ptr()]
    vis = kernels.data_ptr(uniforms.vis, where, "uniforms.vis", f32, dev,
                           (44,))
    rc = kernels.load().simlod_visibility(
        kernels.words(ptrs), vis, n,
        cfg.draw_cap if cfg is not None else 0, dev.index, kernels.stream(dev))
    kernels.check_launch(rc, where)
    compute_visibility_cuda.launches += 1
    return Visibility(*out, *counts.unbind(), *extra)
