"""Octree device data model: dense capacity-padded tensors with watermark counters
(port of simlod_tpu/octree/structures.py; see there for the design).

  - node pool: int32 columns indexed by node id; children are a contiguous block of
    8 (`child_base`), `anc` is the flat [node_capacity * (MAX_DEPTH+1)] ancestor table;
  - point pool: the three 28-bit-per-axis Morton words + rgba per point, addressed
    by segments (node, offset, count);
  - leaf-boundary directory: sorted Morton interval starts of the live leaves;
  - voxel store: global prefix keys (k0, k1, k2|level) + node + rgba, lazily
    deduplicated by compaction.

Unsigned 32-bit words (rgba) are carried as int32 bit patterns: torch has no
`>>` or scatter-min for uint32. Scalars are 0-d tensors on the state's device.
The builder updates the state in place where that saves a copy of a pool.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import constants as C
from ..config import EngineConfig, resolve_device
from ..ops import morton

# fields that hold u32 words in the JAX package (int32 bit patterns here)
U32_FIELDS = ("pt_rgba", "vox_rgba")


@dataclasses.dataclass
class OctreeState:
    """The complete device-resident engine state."""

    # --- node pool ([node_capacity] int32) ---
    child_base: torch.Tensor    # id of first of 8 children, or -1 if leaf
    parent: torch.Tensor        # -1 for root
    level: torch.Tensor
    nx: torch.Tensor            # node coords at its level
    ny: torch.Tensor
    nz: torch.Tensor
    counter: torch.Tensor       # points ever routed while leaf
    num_points: torch.Tensor    # points stored (leaves)
    num_voxels: torch.Tensor    # voxels attributed (exact after compaction)
    node_seg_count: torch.Tensor  # live segments owned by the node
    anc: torch.Tensor           # [node_capacity * (MAX_DEPTH+1)] ancestor table
    num_nodes: torch.Tensor     # scalar watermark

    # --- point pool ---
    pt_w0: torch.Tensor         # Morton word 0
    pt_w1: torch.Tensor         # word 1
    pt_w2: torch.Tensor         # word 2
    pt_rgba: torch.Tensor       # u32 bit pattern
    pool_used: torch.Tensor     # scalar watermark
    pool_waste: torch.Tensor    # scalar: junk rows appended between segments

    # --- leaf-boundary directory ([node_capacity]) ---
    b_key0: torch.Tensor
    b_key1: torch.Tensor
    b_pack: torch.Tensor        # leaf_id * 32 + level
    num_boundaries: torch.Tensor

    # --- segment directory ([segment_capacity]) ---
    seg_node: torch.Tensor      # -1 = never used
    seg_off: torch.Tensor
    seg_cnt: torch.Tensor       # 0 = dead
    num_segments: torch.Tensor

    # --- voxel store ---
    vox_k0: torch.Tensor
    vox_k1: torch.Tensor
    vox_k2l: torch.Tensor
    vox_node: torch.Tensor      # emitting leaf (tail) / resolved node (compacted)
    vox_rgba: torch.Tensor      # u32 bit pattern
    vox_used: torch.Tensor
    vox_compacted: torch.Tensor
    vox_voff: torch.Tensor      # [node_capacity]
    vox_vcnt: torch.Tensor      # [node_capacity]

    # --- octree domain ---
    box_min: torch.Tensor       # f32 [3]
    cube_size: torch.Tensor     # f32 scalar

    # --- bookkeeping ---
    num_points_processed: torch.Tensor
    num_points_dropped: torch.Tensor
    num_candidates_dropped: torch.Tensor
    mem_capacity_reached: torch.Tensor  # bool

    @property
    def device(self) -> torch.device:
        return self.child_base.device

    def pt_positions(self):
        """Decoded world positions (x, y, z) f32 columns of every point-pool
        row (not on the frame path)."""
        qx, qy, qz = morton.decode(self.pt_w0, self.pt_w1, self.pt_w2)
        return morton.dequantize_cols(qx, qy, qz, self.box_min, self.cube_size)

    @property
    def pt_xyz(self) -> torch.Tensor:
        """pt_positions as one [P, 3] tensor (materialized; for inspection
        and tests)."""
        return torch.stack(self.pt_positions(), dim=-1)


def _columns(cfg: EngineConfig) -> dict:
    """{field: (shape, dtype, initial value)} of every field but the
    octree domain (box_min, cube_size): the one description init_state and
    reset_state build from. Every tensor is filled on the device: a copy
    from the host would wait for the device."""
    n_cap = cfg.node_capacity
    rnd = lambda v, m: ((v + m - 1) // m) * m
    p_cap = rnd(cfg.point_capacity + cfg.working_capacity, 128)
    v_cap = rnd(cfg.voxel_capacity + _cand_capacity(cfg), 128)
    s_cap = cfg.segment_capacity
    i32 = torch.int32
    col = lambda n, v=0: ((n,), i32, v)
    scalar = lambda v=0: ((), i32, v)
    return dict(
        child_base=col(n_cap, -1), parent=col(n_cap, -1), level=col(n_cap),
        nx=col(n_cap), ny=col(n_cap), nz=col(n_cap),
        counter=col(n_cap), num_points=col(n_cap), num_voxels=col(n_cap),
        node_seg_count=col(n_cap),
        anc=col(n_cap * (C.MAX_DEPTH + 1)),
        num_nodes=scalar(1),
        b_key0=col(n_cap), b_key1=col(n_cap), b_pack=col(n_cap),
        num_boundaries=scalar(1),   # the root leaf (keys 0,0; pack 0)
        pt_w0=col(p_cap), pt_w1=col(p_cap), pt_w2=col(p_cap),
        pt_rgba=col(p_cap),
        pool_used=scalar(), pool_waste=scalar(),
        seg_node=col(s_cap, -1), seg_off=col(s_cap), seg_cnt=col(s_cap),
        num_segments=scalar(),
        vox_k0=col(v_cap), vox_k1=col(v_cap), vox_k2l=col(v_cap),
        vox_node=col(v_cap), vox_rgba=col(v_cap),
        vox_used=scalar(), vox_compacted=scalar(),
        vox_voff=col(n_cap), vox_vcnt=col(n_cap),
        num_points_processed=scalar(), num_points_dropped=scalar(),
        num_candidates_dropped=scalar(),
        mem_capacity_reached=((), torch.bool, False),
    )


def _domain(box_min, box_max, device):
    """(box_min f32 [3], cube_size f32 scalar) on `device`: the cube with
    edge max(extent) anchored at box_min. Filled on the device: a copy from
    the host would wait for the device."""
    box = lambda b: torch.stack([torch.full((), float(v), dtype=torch.float32,
                                            device=device)
                                 for v in np.asarray(b, np.float32)])
    lo, hi = box(box_min), box(box_max)
    return lo, torch.max(hi - lo)


def init_state(cfg: EngineConfig, box_min, box_max, device=None) -> OctreeState:
    """Create the initial single-root state (the reference's reset.cu kernel).

    The octree domain is the cube with edge max(extent) anchored at box_min.
    The tensors go to `device`, the card unless another is named."""
    device = resolve_device(device, "init_state")
    cols = {name: torch.full(shape, v, dtype=dtype, device=device)
            for name, (shape, dtype, v) in _columns(cfg).items()}
    lo, cube = _domain(box_min, box_max, device)
    return OctreeState(**cols, box_min=lo, cube_size=cube)


def reset_state(state: OctreeState, cfg: EngineConfig, box_min,
                box_max) -> bool:
    """Re-initialise `state` in place to what init_state(cfg, box_min,
    box_max, state.device) makes, keeping every tensor (and its pointer: a
    CUDA graph that reads the state stays valid). Returns False, and writes
    nothing, where a field's shape or dtype differs from cfg's."""
    cols = _columns(cfg)
    for name, (shape, dtype, _) in cols.items():
        t = getattr(state, name)
        if tuple(t.shape) != shape or t.dtype != dtype:
            return False
    if state.box_min.shape != (3,) or state.cube_size.shape != ():
        return False
    for name, (_, _, v) in cols.items():
        getattr(state, name).fill_(v)
    lo, cube = _domain(box_min, box_max, state.device)
    state.box_min.copy_(lo)
    state.cube_size.copy_(cube)
    return True


def node_min_size(state: OctreeState, ids=None):
    """World-space AABB min corner [n, 3] and edge length [n] of the node ids
    (default: every node slot), in the JAX package's op order:
    size = cube_size / exp2(level), then box_min + size * (nx, ny, nz)."""
    nx, ny, nz, lvl = state.nx, state.ny, state.nz, state.level
    if ids is not None:
        at = torch.as_tensor(ids, device=state.device).long()
        nx, ny, nz, lvl = nx[at], ny[at], nz[at], lvl[at]
    size = state.cube_size / torch.exp2(lvl.to(torch.float32))
    mn = state.box_min[None, :] + size[:, None] * torch.stack(
        [nx, ny, nz], dim=-1).to(torch.float32)
    return mn, size


def is_leaf(state: OctreeState) -> torch.Tensor:
    return state.child_base < 0


def active_mask(state: OctreeState) -> torch.Tensor:
    """True on the node slots below the num_nodes watermark."""
    return torch.arange(state.child_base.shape[0], dtype=torch.int32,
                        device=state.device) < state.num_nodes


def _cand_capacity(cfg: EngineConfig) -> int:
    """Voxel-store physical padding: covers the largest single append window so
    the watermark writes in build stay in bounds (vox_used never exceeds
    cfg.voxel_capacity)."""
    from ..ops import ragged
    spill_window = ragged.window_for(cfg.spill_capacity, cfg.seg_select_cap)
    work_width = cfg.step_points + min(cfg.boundary_window, cfg.node_capacity)
    cand_width = work_width + spill_window
    return max(cand_width, spill_window) + 256


def state_to_numpy(state: OctreeState) -> dict:
    """Host copy of every field, with the JAX package's dtypes (u32 words as
    uint32), so a dict from either package's state has the same layout."""
    out = {}
    for f in dataclasses.fields(OctreeState):
        a = getattr(state, f.name).detach().cpu().numpy()
        out[f.name] = (a.view(np.uint32) if f.name in U32_FIELDS else a).copy()
    return out


def state_from_numpy(d: dict, device=None) -> OctreeState:
    """Inverse of state_to_numpy; also takes `{field: np.asarray(jax_field)}` of a
    state the JAX package built. The tensors go to `device`, the card unless
    another is named."""
    device = resolve_device(device, "state_from_numpy")
    kw = {}
    for f in dataclasses.fields(OctreeState):
        a = np.asarray(d[f.name])
        if f.name in U32_FIELDS:
            a = a.astype(np.uint32, copy=False).view(np.int32)
        kw[f.name] = torch.from_numpy(np.array(a, copy=True)).to(device)
    return OctreeState(**kw)
