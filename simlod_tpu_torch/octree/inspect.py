"""Host-side octree inspection (port of simlod_tpu/octree/inspect.py): pull an
OctreeState back into Python dicts. Used by tests and debugging tools; slow by
design and never on the hot path.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from ..ops import morton
from .structures import OctreeState, state_to_numpy


def snapshot(state: OctreeState) -> dict:
    """Device -> host copy of all fields as numpy arrays (u32 words as
    uint32, the JAX package's layout)."""
    return state_to_numpy(state)


def _cells(k0, k1, k2l) -> np.ndarray:
    """Packed 21-bit local cells (cx << 14 | cy << 7 | cz) of voxel keys."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))
    _, cx, cy, cz = morton.key_words_decode(t(k0), t(k1), t(k2l))
    return ((cx.numpy().astype(np.int64) << (2 * C.GRID_BITS))
            | (cy.numpy().astype(np.int64) << C.GRID_BITS)
            | cz.numpy().astype(np.int64))


def node_table(state: OctreeState) -> dict:
    """dict (level, x, y, z) -> node info dict, mirroring RefOctree.node_map().
    The voxel part needs a compacted store (in the uncompacted tail vox_node
    is the emitting leaf, not the owner)."""
    s = snapshot(state)
    n = int(s["num_nodes"])
    nseg = int(s["num_segments"])
    pts_by_node: dict[int, list] = {}
    for sn, so, sc in zip(s["seg_node"][:nseg], s["seg_off"][:nseg],
                          s["seg_cnt"][:nseg]):
        if sc > 0 and sn >= 0:
            pts_by_node.setdefault(int(sn), []).append((int(so), int(sc)))
    vox_by_node: dict[int, dict] = {}
    vu = int(s["vox_used"])
    if vu:
        cell = _cells(s["vox_k0"][:vu], s["vox_k1"][:vu], s["vox_k2l"][:vu])
        for i in range(vu):
            vox_by_node.setdefault(int(s["vox_node"][i]), {}).setdefault(
                int(cell[i]), int(s["vox_rgba"][i]))
    # pool positions decoded once (Morton words -> cell centres)
    q = morton.decode(state.pt_w0.cpu(), state.pt_w1.cpu(), state.pt_w2.cpu())
    pool_xyz = torch.stack(morton.dequantize_cols(
        *q, state.box_min.cpu(), state.cube_size.cpu()), -1).numpy()
    table = {}
    for i in range(n):
        spans = pts_by_node.get(i, [])
        idx = np.concatenate([np.arange(o, o + c) for (o, c) in spans]) \
            if spans else np.zeros((0,), np.int64)
        table[(int(s["level"][i]), int(s["nx"][i]), int(s["ny"][i]),
               int(s["nz"][i]))] = dict(
            id=i,
            is_leaf=bool(s["child_base"][i] < 0),
            child_base=int(s["child_base"][i]),
            parent=int(s["parent"][i]),
            counter=int(s["counter"][i]),
            num_points=int(s["num_points"][i]),
            num_voxels=int(s["num_voxels"][i]),
            points_xyz=pool_xyz[idx],
            points_rgba=s["pt_rgba"][idx],
            voxels=vox_by_node.get(i, {}),
        )
    return table


def voxel_cells(state: OctreeState) -> np.ndarray:
    """Packed 21-bit local cell per store row [0, vox_used) (host-side)."""
    vu = int(state.vox_used)
    if vu == 0:
        return np.zeros((0,), np.int64)
    return _cells(state.vox_k0[:vu].cpu().numpy(),
                  state.vox_k1[:vu].cpu().numpy(),
                  state.vox_k2l[:vu].cpu().numpy())
