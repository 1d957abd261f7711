"""The port's colour filter and inspection (simlod_tpu_torch.octree.colorfilter,
octree.inspect) against simlod_tpu on the CPU, on test_colorfilter.py's cloud
(4000 seeded points, 64-point leaves).

Tolerances: on a state built by the JAX package and carried across with
state_from_numpy, the filtered voxel colours are bit-equal (the run sums do not
depend on the order inside a run). On a state the port builds itself, voxel
colours are compared per (node identity, cell); a cell holding exact-duplicate
points would be exempt (test_torch_build.py), but filtering replaces every
inner voxel colour with an average of leaf points, so none is needed here.
The inspection tables are equal field for field.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simlod_tpu.config import EngineConfig as JCfg
from simlod_tpu.octree import build as jb, colorfilter as jcf, inspect as jin
from simlod_tpu.octree.structures import init_state as jinit
from simlod_tpu_torch.config import EngineConfig as TCfg
from simlod_tpu_torch.octree import build as tb, colorfilter as tcf, \
    inspect as tin
from simlod_tpu_torch.octree.structures import (init_state as tinit,
                                                state_from_numpy,
                                                state_to_numpy)

# six test processes share the machine in the tier-1 run; these small tensors
# gain nothing from intra-op threads, which would oversubscribe the cores
torch.set_num_threads(1)

KW = dict(candidate_factor=21, cand_multi_rows=1 << 12, node_capacity=1 << 12,
          point_capacity=1 << 16, voxel_capacity=1 << 18,
          segment_capacity=1 << 14, step_points=1 << 12,
          spill_capacity=1 << 12, max_splits_per_round=64,
          seg_select_cap=1 << 10, max_points_per_node=64)


def _cloud():
    rng = np.random.default_rng(1234)
    xy = rng.random((4000, 2), dtype=np.float32)
    z = 0.4 + 0.1 * np.sin(7 * xy[:, 0]) * np.cos(5 * xy[:, 1])
    xyz = np.stack([xy[:, 0], xy[:, 1], z.astype(np.float32)], -1)
    rgba = rng.integers(0, 2**32, 4000, dtype=np.uint64).astype(np.uint32)
    return xyz, rgba


def _steps(xyz, rgba, B):
    for s in range(0, len(xyz), B):
        cx = np.zeros((B, 3), np.float32)
        cc = np.zeros((B,), np.uint32)
        cx[:len(xyz[s:s + B])] = xyz[s:s + B]
        cc[:len(xyz[s:s + B])] = rgba[s:s + B]
        yield cx, cc, len(xyz[s:s + B])


@pytest.fixture(scope="module")
def states():
    xyz, rgba = _cloud()
    jc, tc = JCfg(**KW), TCfg(**KW)
    js = jinit(jc, [0, 0, 0], [1, 1, 1])
    ts = tinit(tc, [0, 0, 0], [1, 1, 1], device="cpu")
    for cx, cc, n in _steps(xyz, rgba, KW["step_points"]):
        js = jb.build_step(jc, js, *(jnp.asarray(np.ascontiguousarray(cx[:, k]))
                                     for k in range(3)),
                           jnp.asarray(cc), jnp.int32(n))
        ts = tb.build_step(tc, ts, *(torch.from_numpy(np.ascontiguousarray(
            cx[:, k])) for k in range(3)), torch.from_numpy(cc.view(np.int32)),
            n)
    js = jb.compact_voxels(jc, js)
    ts = tb.compact_voxels(tc, ts)
    jraw = {k: np.asarray(v) for k, v in vars(js).items()}
    return jc, tc, js, jraw, ts


def state_from_numpy_jax(raw):
    """A fresh JAX state from a field dict (filter_colors donates its input)."""
    from simlod_tpu.octree.structures import OctreeState
    return OctreeState(**{k: jnp.asarray(v) for k, v in raw.items()})


def _voxels_by_identity(table):
    return {key: node["voxels"] for key, node in table.items()}


def test_filter_is_bit_equal_on_the_jax_state(states):
    jc, tc, _, jraw, _ = states
    jf = jcf.filter_colors(jc, state_from_numpy_jax(jraw))
    tf = tcf.filter_colors(tc, state_from_numpy(jraw, device="cpu"))
    vu = int(jf.vox_used)
    got = state_to_numpy(tf)["vox_rgba"]
    want = np.asarray(jf.vox_rgba)
    assert (got[:vu] != jraw["vox_rgba"][:vu]).any()     # colours did change
    np.testing.assert_array_equal(got, want)


def test_filter_on_the_port_built_state_matches_per_node_cell(states):
    jc, tc, _, jraw, ts = states
    jt = _voxels_by_identity(jin.node_table(jcf.filter_colors(
        jc, state_from_numpy_jax(jraw))))
    tt = _voxels_by_identity(tin.node_table(tcf.filter_colors(
        tc, state_from_numpy(state_to_numpy(ts), device="cpu"))))
    assert jt.keys() == tt.keys() and sum(map(len, jt.values())) > 1000
    assert jt == tt


def test_level_windows_are_the_exact_sample_counts(states):
    jc, _, js, jraw, _ = states
    n_vox, n_pts, n_store, max_level = tcf._level_counts(
        state_from_numpy(jraw, device="cpu"))
    assert max_level == int(jraw["level"][:int(jraw["num_nodes"])].max())
    for lvl in range(max_level):
        jv, jp, jsd = (int(x) for x in jcf._level_counts(jc, js,
                                                         jnp.int32(lvl)))
        assert (n_vox[lvl + 1], n_store[lvl]) == (jv, jsd), lvl
        assert n_pts[lvl + 1] <= jp     # leaves only; JAX counts inner too


def test_node_table_matches_jax(states):
    _, _, js, jraw, _ = states
    jt = jin.node_table(js)
    tt = tin.node_table(state_from_numpy(jraw, device="cpu"))
    assert jt.keys() == tt.keys() and len(jt) > 8
    for key in jt:
        for f, v in jt[key].items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(tt[key][f], v, err_msg=f)
            else:
                assert tt[key][f] == v, (key, f)


def test_snapshot_and_voxel_cells_match_jax(states):
    _, _, js, jraw, _ = states
    t = state_from_numpy(jraw, device="cpu")
    np.testing.assert_array_equal(tin.voxel_cells(t), jin.voxel_cells(js))
    snap = tin.snapshot(t)
    for f in dataclasses.fields(t):
        np.testing.assert_array_equal(snap[f.name], jraw[f.name],
                                      err_msg=f.name)
