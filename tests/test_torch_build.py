"""The port's octree builder (simlod_tpu_torch.octree.build) against the JAX
builder on the CPU, on the golden fixture's cloud (60k points, 8192-point steps,
256-point leaves), with the voxel-compaction watermark set low enough that
build_many compacts mid-load.

What is compared, and how:
  - watermarks and counters: bit-equal;
  - the node table: equal per node identity (level, nx, ny, nz). Node ids follow
    the order in which a step's split candidates are taken, and the JAX package
    takes them from an UNSTABLE priority sort: XLA's CPU sort (an introsort)
    orders equal priorities arbitrarily, the port's stable sort by row. Sibling
    blocks of equal-priority splits can therefore carry swapped ids; the tree,
    its counts and every parent/child relation are the same;
  - point pools: per-node sorted multisets of (w0, w1, w2, rgba) (the route and
    compaction sorts are unstable in the JAX package, so rows inside a segment
    may come in another order);
  - compacted voxels: per-node sets of (k0, k1, k2l, rgba). A voxel keeps the
    colour of the first point that arrived in its cell; when that point has an
    exact duplicate (same 84-bit Morton code, other colour), which of the two
    arrives first is decided by the unstable sort, so only such cells may
    differ in colour.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simlod_tpu.config import EngineConfig as JCfg
from simlod_tpu.octree import build as jb
from simlod_tpu.octree.structures import init_state as jinit
from simlod_tpu_torch.config import EngineConfig as TCfg
from simlod_tpu_torch.formats import synthetic
from simlod_tpu_torch.octree import build as tb
from simlod_tpu_torch.octree.structures import (init_state as tinit,
                                                state_from_numpy,
                                                state_to_numpy)
from simlod_tpu_torch.ops import morton

# six test processes share the machine in the tier-1 run; these small tensors
# gain nothing from intra-op threads, which would oversubscribe the cores
torch.set_num_threads(1)

KW = dict(candidate_factor=21, cand_multi_rows=1 << 13,
          node_capacity=1 << 12, point_capacity=1 << 17, voxel_capacity=1 << 18,
          segment_capacity=1 << 14, step_points=1 << 13, spill_capacity=1 << 13,
          max_splits_per_round=64, seg_select_cap=1 << 10,
          max_points_per_node=256, max_render_points=1 << 17,
          max_render_voxels=1 << 17)
WATERMARKS = ("num_nodes", "pool_used", "pool_waste", "num_points_processed",
              "num_points_dropped", "num_candidates_dropped", "num_segments",
              "num_boundaries", "vox_used", "vox_compacted",
              "mem_capacity_reached")


def _planes(xyz, rgba, B):
    K = (len(xyz) + B - 1) // B
    cols = np.zeros((4, K, B), np.float32)
    cc = np.zeros((K, B), np.uint32)
    counts = np.zeros(K, np.int32)
    for k in range(K):
        chunk = xyz[k * B:(k + 1) * B]
        cols[:3, k, :len(chunk)] = chunk.T
        cc[k, :len(chunk)] = rgba[k * B:(k + 1) * B]
        counts[k] = len(chunk)
    return cols[:3], cc, counts


@pytest.fixture(scope="module")
def built():
    xyz, rgba = synthetic.terrain(60_000, seed=23, extent=1.0, z_scale=0.4)
    box_max = np.maximum(xyz.max(0), 1e-3)
    jc, tc = JCfg(**KW), TCfg(**KW)
    (px, py, pz), cc, counts = _planes(xyz, rgba, KW["step_points"])
    js = jb.build_many(jc, jinit(jc, np.zeros(3, np.float32), box_max),
                       jnp.asarray(px), jnp.asarray(py), jnp.asarray(pz),
                       jnp.asarray(cc), jnp.asarray(counts))
    ts = tb.build_many(tc, tinit(tc, np.zeros(3, np.float32), box_max,
                                 device="cpu"),
                       torch.from_numpy(px), torch.from_numpy(py),
                       torch.from_numpy(pz),
                       torch.from_numpy(cc.view(np.int32)), counts)
    raw = ({k: np.asarray(v) for k, v in vars(js).items()}, state_to_numpy(ts))
    js = jb.compact_voxels(jc, jb.compact_segments(jc, js))
    ts = tb.compact_voxels(tc, tb.compact_segments(tc, ts))
    done = ({k: np.asarray(v) for k, v in vars(js).items()}, state_to_numpy(ts))
    return xyz, box_max, raw, done


def _ident(d):
    """Node id -> identity (level, nx, ny, nz) for live nodes."""
    n = int(d["num_nodes"])
    return {i: (int(d["level"][i]), int(d["nx"][i]), int(d["ny"][i]),
                int(d["nz"][i])) for i in range(n)}


def _node_table(d):
    idn = _ident(d)
    out = {}
    for i, key in idn.items():
        cb, par = int(d["child_base"][i]), int(d["parent"][i])
        out[key] = (idn.get(par), idn.get(cb) if cb >= 0 else None,
                    int(d["num_points"][i]), int(d["counter"][i]),
                    int(d["node_seg_count"][i]))
    return out


def _point_sets(d):
    idn = _ident(d)
    out = {}
    for s in range(int(d["num_segments"])):
        node, off, cnt = (int(d["seg_node"][s]), int(d["seg_off"][s]),
                          int(d["seg_cnt"][s]))
        if cnt <= 0:
            continue
        rows = [tuple(int(d[c][r]) for c in ("pt_w0", "pt_w1", "pt_w2",
                                              "pt_rgba"))
                for r in range(off, off + cnt)]
        out.setdefault(idn[node], []).extend(rows)
    return {k: sorted(v) for k, v in out.items()}


def _voxel_sets(d):
    idn = _ident(d)
    out = {}
    for r in range(int(d["vox_used"])):
        key = (int(d["vox_k0"][r]), int(d["vox_k1"][r]), int(d["vox_k2l"][r]))
        out.setdefault(idn[int(d["vox_node"][r])], {})[key] = int(d["vox_rgba"][r])
    return out


def _duplicate_cells(xyz, box_max):
    """Voxel keys (levels 0..19) of cells holding exact-duplicate points."""
    q = morton.quantize_cols(*(torch.from_numpy(np.ascontiguousarray(c))
                               for c in xyz.T),
                             torch.zeros(3), torch.tensor(float(box_max.max())))
    w = torch.stack(morton.encode(*q), 1).numpy()
    _, inv, cnt = np.unique(w, axis=0, return_inverse=True, return_counts=True)
    dup = w[cnt[inv.reshape(-1)] > 1]
    cells = set()
    for lvl in range(20):
        t = torch.from_numpy(dup)
        ks = morton.key_words_at_level(t[:, 0], t[:, 1], t[:, 2],
                                       torch.full((len(dup),), lvl,
                                                  dtype=torch.int32))
        cells.update(zip(*(k.tolist() for k in ks)))
    return cells


def test_watermarks_bit_equal(built):
    _, _, raw, done = built
    for jd, td in (raw, done):
        for k in WATERMARKS:
            np.testing.assert_array_equal(jd[k], td[k], err_msg=k)
    assert int(raw[0]["vox_compacted"]) > 0      # build_many compacted mid-load


def test_node_table_equal_by_identity(built):
    _, _, raw, _ = built
    jt, tt = _node_table(raw[0]), _node_table(raw[1])
    assert len(jt) == int(raw[0]["num_nodes"]) > 8
    assert jt == tt


def test_point_pools_equal_as_multisets(built):
    _, _, raw, _ = built
    jp, tp = _point_sets(raw[0]), _point_sets(raw[1])
    assert sum(map(len, jp.values())) == 60_000
    assert jp == tp


def test_compacted_voxels_equal_as_sets(built):
    xyz, box_max, _, done = built
    jv, tv = _voxel_sets(done[0]), _voxel_sets(done[1])
    assert jv.keys() == tv.keys()
    dup = None
    for node in jv:
        assert jv[node].keys() == tv[node].keys(), node
        for key, c in jv[node].items():
            if tv[node][key] != c:
                dup = _duplicate_cells(xyz, box_max) if dup is None else dup
                assert key in dup, (node, key)
    for k in ("vox_voff", "vox_vcnt", "num_voxels"):
        # per-node directory, compared through node identity
        jm = {v: done[0][k][i] for i, v in _ident(done[0]).items()}
        tm = {v: done[1][k][i] for i, v in _ident(done[1]).items()}
        assert jm == tm, k


def test_state_numpy_round_trip(built):
    _, _, raw, _ = built
    t = state_from_numpy(raw[1], device="cpu")
    back = state_to_numpy(t)
    assert back.keys() == raw[1].keys()
    for k, v in raw[1].items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    # the JAX state's dict carries across with the same layout
    j = state_to_numpy(state_from_numpy(raw[0], device="cpu"))
    for f in dataclasses.fields(t):
        assert j[f.name].shape == raw[0][f.name].shape, f.name
        np.testing.assert_array_equal(j[f.name], raw[0][f.name], err_msg=f.name)
