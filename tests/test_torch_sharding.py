"""The port's sharded engine (simlod_tpu_torch.parallel.shard and .engine)
against simlod_tpu.parallel on the CPU: the JAX package on the conftest's
virtual CPU devices (all 8, or the first 4), the port on a mesh of as many CPU
shards, with the CFG and fixtures of tests/test_sharding.py and
tests/test_sharded_engine.py (W x H = 96 x 64, slot_factor = n unless noted).

Tolerances:
  - brick levels, owners, slot rows, receive windows, per-step received
    counts, per-shard processed / stored / dropped counts and report():
    equal;
  - per-shard trees: node tables equal by identity (level, nx, ny, nz), point
    pools as per-node multisets, compacted voxels as per-node {key: colour}
    maps. JAX's exchange and route sorts are unstable, so rows reach a shard's
    build in another order; the fixtures hold no two points in one level-20
    cell, where that order could pick another voxel colour;
  - composited images: bit-equal with EDL off (HQS on and off), within 1 per
    channel with HQS and EDL (XLA and torch round EDL's log2/exp
    differently).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simlod_tpu.config import Settings as JSet, Uniforms as JU
from simlod_tpu.parallel import shard as jshard
from simlod_tpu.parallel.engine import ShardedEngine as JEngine
from simlod_tpu_torch import constants as C
from simlod_tpu_torch.config import (EngineConfig as TCfg, Settings as TSet,
                                     Uniforms as TU)
from simlod_tpu_torch.formats import simlod, synthetic
from simlod_tpu_torch.ops import morton
from simlod_tpu_torch.parallel import shard as tshard
from simlod_tpu_torch.parallel.engine import ShardedEngine as TEngine
from simlod_tpu_torch.render import camera as cam
from simlod_tpu_torch.render.render import image_to_rgba8
from test_sharding import CFG, H, W
from test_torch_build import _ident, _node_table, _point_sets

# six test processes share the machine in the tier-1 run; these small tensors
# gain nothing from intra-op threads, which would oversubscribe the cores
torch.set_num_threads(1)

TCFG = TCfg(**dataclasses.asdict(CFG))
B = CFG.step_points


def _meshes(n):
    return jshard.make_mesh(jax.devices()[:n]), tshard.make_mesh(["cpu"] * n)


def _uniforms(box_max, **settings):
    """JAX and port Uniforms of the auto-focus view of the box."""
    c = cam.Camera(width=W, height=H)
    o = cam.OrbitControls()
    o.focus_box([0, 0, 0], box_max)
    c.world = o.world()
    kw = dict(min_node_size=8.0, enable_edl=False)
    kw.update(settings)
    t = c.transform()
    return (JU.make(W, H, t, settings=JSet(**kw)),
            TU.make(W, H, t, settings=TSet(**kw), device="cpu"))


def _columns(xyz, rgba):
    """A [<=B] chunk as B-row JAX and port batch columns."""
    cx = np.zeros((B, 3), np.float32)
    cx[:len(xyz)] = xyz
    cc = np.zeros(B, np.uint32)
    cc[:len(xyz)] = rgba
    cols = [np.ascontiguousarray(cx[:, a]) for a in range(3)]
    return ([jnp.asarray(c) for c in cols] + [jnp.asarray(cc)],
            [torch.from_numpy(c) for c in cols]
            + [torch.from_numpy(cc.view(np.int32))])


def _no_level20_collisions(xyz, box_max):
    """No two points share their first 20 Morton levels (words 0 and 1)."""
    q = morton.quantize_cols(*(torch.from_numpy(np.ascontiguousarray(c))
                               for c in xyz.T),
                             torch.zeros(3), torch.tensor(float(box_max.max())))
    w0, w1, _ = morton.encode(*q)
    pairs = np.stack([w0.numpy(), w1.numpy()], 1)
    return len(np.unique(pairs, axis=0)) == len(pairs)


def _shard(d, s):
    return {k: v[s] for k, v in d.items()}


def _voxel_maps(d):
    """Per node identity: {(k0, k1, k2l): rgba} of a compacted store."""
    idn = _ident(d)
    out = {}
    for r in range(int(d["vox_used"])):
        key = (int(d["vox_k0"][r]), int(d["vox_k1"][r]), int(d["vox_k2l"][r]))
        out.setdefault(idn[int(d["vox_node"][r])], {})[key] = \
            int(d["vox_rgba"][r])
    return out


def _leaf_points(d):
    return int(np.where(d["child_base"] < 0, d["num_points"], 0).sum())


def _assert_trees_equal(jd, td, n):
    for s in range(n):
        j, t = _shard(jd, s), _shard(td, s)
        assert _node_table(j) == _node_table(t), f"shard {s} nodes"
        assert _point_sets(j) == _point_sets(t), f"shard {s} points"
        assert _voxel_maps(j) == _voxel_maps(t), f"shard {s} voxels"
        for k in ("vox_vcnt", "num_voxels"):
            jm = {v: j[k][i] for i, v in _ident(j).items()}
            tm = {v: t[k][i] for i, v in _ident(t).items()}
            assert jm == tm, (s, k)


def _rgb(img):
    return image_to_rgba8(np.asarray(img))[..., :3].astype(int)


@pytest.fixture(scope="module", params=[8, 4])
def stepped(request):
    """test_sharding.py's 20k terrain through both sharded steps (the last
    build step renders), then compaction and render-only steps with EDL off
    (HQS on and off) and with HQS + EDL."""
    n = request.param
    jm, tm = _meshes(n)
    xyz, rgba = synthetic.terrain(20_000, seed=4, extent=1.0, z_scale=0.6)
    box_max = np.maximum(xyz.max(0), 1e-3)
    assert _no_level20_collisions(xyz, box_max)
    jstep = jshard.build_sharded_step(CFG, jm, W, H, slot_factor=n)
    tstep = tshard.build_sharded_step(TCFG, tm, W, H, slot_factor=n)
    js = jshard.init_sharded_state(CFG, jm, np.zeros(3, np.float32), box_max)
    ts = tshard.init_sharded_state(TCFG, tm, np.zeros(3, np.float32), box_max)
    ju, tu = _uniforms(box_max)
    counts, imgs = [], {}
    starts = range(0, len(xyz), B)
    for s in starts:
        jc, tc = _columns(xyz[s:s + B], rgba[s:s + B])
        cnt = len(xyz[s:s + B])
        last = s == starts[-1]
        js, jimg, jdep, jn = jstep(js, *jc, jnp.int32(cnt), ju, last)
        ts, timg, tdep, tn = tstep(ts, *tc, cnt, tu, last)
        counts.append((np.asarray(jn), tn))
    imgs["ingest"] = (jimg, jdep, timg, tdep)
    js = jshard.sharded_compact(CFG, jm, js)
    ts = tshard.sharded_compact(TCFG, tm, ts)
    zj, zt = _columns(xyz[:0], rgba[:0])
    for key, kw in (("hqs", {}), ("plain", dict(use_high_quality_shading=False)),
                    ("hqs_edl", dict(enable_edl=True))):
        ju, tu = _uniforms(box_max, **kw)
        js, jimg, jdep, _ = jstep(js, *zj, jnp.int32(0), ju, True)
        ts, timg, tdep, _ = tstep(ts, *zt, 0, tu, True)
        imgs[key] = (jimg, jdep, timg, tdep)
    jd = {k: np.asarray(v) for k, v in vars(js).items()}
    return dict(n=n, counts=counts, imgs=imgs, jd=jd,
                td=tshard.sharded_state_to_numpy(ts), mesh=tm)


def test_brick_level_for_matches_jax():
    for n in range(1, 70):
        assert tshard.brick_level_for(n) == jshard.brick_level_for(n)


@pytest.mark.parametrize("n", [1, 2, 4, 8, 9])
def test_brick_owner_bit_equal(n):
    rng = np.random.default_rng(n)
    q = rng.integers(0, C.FULL_GRID_SIZE, size=(3, 5000)).astype(np.int32)
    level = tshard.brick_level_for(n)
    want = np.asarray(jshard._brick_owner(*(jnp.asarray(a) for a in q),
                                          level, n))
    got = tshard._brick_owner(*(torch.from_numpy(a) for a in q), level, n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(got.tolist()) == set(range(n))


def test_slot_rows_and_recv_window_match_jax():
    for bl in (128, 1000, 1024, 1 << 18):
        for n in (1, 2, 4, 8, 9):
            for sf in (1, 2, 4, 8):
                assert tshard._slot_rows(bl, n, sf) == \
                    jshard._slot_rows(bl, n, sf)
    for n in (8, 4):
        jm, tm = _meshes(n)
        for sf in (1, 2, 4, 8):
            js = jshard.build_sharded_step(CFG, jm, W, H, slot_factor=sf)
            ts = tshard.build_sharded_step(TCFG, tm, W, H, slot_factor=sf)
            assert ts.recv_window(B) == js.recv_window(B)
    assert ts.recv_window(B) == B          # slot_factor n: S == B/n


def test_step_counts_equal(stepped):
    n = stepped["n"]
    for jn, tn in stepped["counts"]:
        np.testing.assert_array_equal(tn, jn)
    assert sum(int(tn.sum()) for _, tn in stepped["counts"]) == 20_000
    jd, td = stepped["jd"], stepped["td"]
    for k in ("num_points_processed", "num_points_dropped", "num_nodes",
              "vox_used", "mem_capacity_reached"):
        np.testing.assert_array_equal(td[k], jd[k], err_msg=k)
    stored = [_leaf_points(_shard(td, s)) for s in range(n)]
    assert stored == [_leaf_points(_shard(jd, s)) for s in range(n)]
    assert sum(stored) == 20_000 and sum(v > 0 for v in stored) >= 2


def test_step_trees_equal(stepped):
    _assert_trees_equal(stepped["jd"], stepped["td"], stepped["n"])


def test_step_images(stepped):
    for key, (jimg, jdep, timg, tdep) in stepped["imgs"].items():
        assert timg.shape == (H, W) and tdep.shape == (H, W)
        # XLA rounds the sharded program's projection differently from its
        # single-device one (1 ulp of depth on ~1% of the drawn pixels); the
        # winners and so the images are the same
        ulps = np.abs(tdep.numpy().astype(np.int64) - np.asarray(jdep))
        assert ulps.max() <= 1, key
        if key == "hqs_edl":
            d = np.abs(_rgb(timg.numpy()) - _rgb(jimg))
            assert d.max() <= 1, key
        else:
            np.testing.assert_array_equal(timg.numpy(),
                                          np.asarray(jimg).view(np.int32),
                                          err_msg=key)
        assert (timg.numpy() != C.BACKGROUND_COLOR).any(), key


def test_sharded_state_numpy_round_trip(stepped):
    jd = stepped["jd"]
    back = tshard.sharded_state_to_numpy(
        tshard.sharded_state_from_numpy(jd, stepped["mesh"]))
    assert back.keys() == jd.keys()
    for k, v in jd.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_render_skipped_returns_background():
    _, tm = _meshes(4)
    step = tshard.build_sharded_step(TCFG, tm, W, H)
    st = tshard.init_sharded_state(TCFG, tm, np.zeros(3, np.float32),
                                   np.ones(3, np.float32))
    _, img, depth, n = step(st, None, None, None, None, 0, None, False)
    assert (img == C.BACKGROUND_COLOR).all()
    assert (depth == C.DEPTH_INF_BITS).all() and n.tolist() == [0] * 4


def test_chunk_matches_per_step_and_jax():
    """test_sharding.py's K=3 chunk: the port's chunk builds the same trees
    as its per-step path and as the JAX chunk."""
    n, K = 8, 3
    jm, tm = _meshes(n)
    xyz, rgba = synthetic.terrain(K * B, seed=9, extent=1.0, z_scale=0.6)
    box_max = np.maximum(xyz.max(0), 1e-3)
    assert _no_level20_collisions(xyz, box_max)
    step = tshard.build_sharded_step(TCFG, tm, W, H, slot_factor=n)
    s_ref = tshard.init_sharded_state(TCFG, tm, np.zeros(3, np.float32),
                                      box_max)
    for k in range(K):
        _, tc = _columns(xyz[k * B:(k + 1) * B], rgba[k * B:(k + 1) * B])
        s_ref, *_ = step(s_ref, *tc, B, None, False)
    planes = [np.ascontiguousarray(xyz[:, a].reshape(K, B)) for a in range(3)]
    cplane = np.ascontiguousarray(rgba.reshape(K, B))
    s_chk = tshard.build_sharded_chunk(TCFG, tm, slot_factor=n)(
        tshard.init_sharded_state(TCFG, tm, np.zeros(3, np.float32), box_max),
        *(torch.from_numpy(p) for p in planes),
        torch.from_numpy(cplane.view(np.int32)), [B] * K)
    j_chk = jshard.build_sharded_chunk(CFG, jm, slot_factor=n)(
        jshard.init_sharded_state(CFG, jm, np.zeros(3, np.float32), box_max),
        *(jnp.asarray(p) for p in planes), jnp.asarray(cplane),
        jnp.full((K,), B, jnp.int32))
    compact = lambda s: tshard.sharded_state_to_numpy(
        tshard.sharded_compact(TCFG, tm, s))
    ref, chk = compact(s_ref), compact(s_chk)
    jd = {k: np.asarray(v) for k, v in
          vars(jshard.sharded_compact(CFG, jm, j_chk)).items()}
    for k in ("num_nodes", "num_points_processed", "num_points_dropped",
              "vox_used"):
        np.testing.assert_array_equal(chk[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(chk[k], jd[k], err_msg=k)
    _assert_trees_equal(ref, chk, n)
    _assert_trees_equal(jd, chk, n)


def test_slot_overflow_counts_match_jax(rng):
    """test_sharding.py's maximally skewed batch (every point in shard 0's
    brick) at slot_factor 1: the same received and dropped counts as JAX.
    Which rows are dropped is not compared: JAX picks them through an
    unstable sort."""
    n = 8
    jm, tm = _meshes(n)
    xyz = (rng.random((B, 3), dtype=np.float32) * 0.49).astype(np.float32)
    rgba = rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.uint32)
    box_max = np.ones(3, np.float32)
    jc, tc = _columns(xyz, rgba)
    js = jshard.init_sharded_state(CFG, jm, np.zeros(3, np.float32), box_max)
    ts = tshard.init_sharded_state(TCFG, tm, np.zeros(3, np.float32), box_max)
    ju, _ = _uniforms(box_max)
    js, _, _, jn = jshard.build_sharded_step(CFG, jm, W, H, slot_factor=1)(
        js, *jc, jnp.int32(B), ju, False)
    ts, _, _, tn = tshard.build_sharded_step(TCFG, tm, W, H, slot_factor=1)(
        ts, *tc, B, None, False)
    np.testing.assert_array_equal(tn, np.asarray(jn))
    td = tshard.sharded_state_to_numpy(ts)
    np.testing.assert_array_equal(td["num_points_dropped"],
                                  np.asarray(js.num_points_dropped))
    S = max(128, (B // n) // n)
    assert tn.sum() == n * S < B
    assert int(td["num_points_dropped"].sum()) == B - tn.sum()
    stored = [_leaf_points(_shard(td, s)) for s in range(n)]
    assert stored[0] == tn.sum() and not any(stored[1:])


@pytest.fixture(scope="module")
def cloud(tmp_path_factory):
    """test_sharded_engine.py's 30k terrain file."""
    xyz, rgba = synthetic.terrain(30_000, seed=9, extent=1.0, z_scale=0.5)
    path = str(tmp_path_factory.mktemp("sharded") / "cloud.simlod")
    simlod.write(path, xyz, rgba)
    return path


@pytest.mark.parametrize("bulk", [True, False])
def test_engine_file_to_frame_matches_jax(cloud, bulk):
    settings = dict(min_node_size=8.0, enable_edl=False)
    j = JEngine(CFG, mesh=jshard.make_mesh(), width=W, height=H,
                settings=JSet(**settings), slot_factor=8)
    t = TEngine(TCFG, mesh=tshard.make_mesh(["cpu"] * 8), width=W, height=H,
                settings=TSet(**settings), slot_factor=8)
    for e in (j, t):
        e.open([cloud])
        e.load_all(bulk=bulk)
        e.stream.stop()
    rep = t.report()
    assert rep == j.report()
    assert rep["num_points"] == rep["num_points_processed"] == 30_000
    assert not rep["mem_capacity_reached"]
    # per step at least the received counts and the watermarks (one read for
    # all shards each), plus the builder's own reads
    assert t.host_syncs > 2 * 4
    jimg, timg = np.asarray(j.render()), t.render()
    assert timg.shape == (H, W)
    np.testing.assert_array_equal(timg.numpy(), jimg.view(np.int32))
    ulps = np.abs(t.last_depth.numpy().astype(np.int64)
                  - np.asarray(j.last_depth))
    assert ulps.max() <= 1          # see test_step_images
    assert (timg.numpy() != C.BACKGROUND_COLOR).any()


def test_cpu_mesh_and_no_cuda_fallback():
    m = tshard.make_mesh(["cpu"] * 3)
    assert m.size == 3 and set(m.devices) == {torch.device("cpu")}
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tshard.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        tshard.make_mesh(["cuda"] * 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        TEngine()
