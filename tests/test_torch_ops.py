"""The port's primitives (simlod_tpu_torch.ops) against simlod_tpu.ops on the CPU:
the same seeded inputs through both packages, bit-equal outputs."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from simlod_tpu.ops import morton as jm
from simlod_tpu.ops import ragged as jr
from simlod_tpu.ops import segments as js
from simlod_tpu_torch.ops import morton as tm
from simlod_tpu_torch.ops import ragged as tr
from simlod_tpu_torch.ops import segments as ts

# six test processes share the machine in the tier-1 run; these small tensors
# gain nothing from intra-op threads, which would oversubscribe the cores
torch.set_num_threads(1)


def _eq(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


def _q(rng, n):
    return [rng.integers(0, 1 << 28, n).astype(np.int32) for _ in range(3)]


def test_morton_encode_decode():
    rng = np.random.default_rng(0)
    q = _q(rng, 4096)
    jw = jm.encode(*map(jnp.asarray, q))
    tw = tm.encode(*map(torch.from_numpy, q))
    for a, b in zip(jw, tw):
        _eq(a, b)
    for a, b in zip(jm.decode(*jw), tm.decode(*tw)):
        _eq(a, b)
    for a, b in zip(tm.decode(*tw), q):     # round trip
        np.testing.assert_array_equal(a.numpy(), b)


def test_morton_quantize_dequantize():
    rng = np.random.default_rng(1)
    xyz = rng.uniform(-3.0, 7.0, (3, 4096)).astype(np.float32)
    xyz[:, :3] = [[-3.0, 7.0, 2.0]] * 3                 # box edges
    bmin = np.array([-3.0, -3.0, -3.0], np.float32)
    cube = np.float32(10.0)
    jq = jm.quantize_cols(*map(jnp.asarray, xyz), jnp.asarray(bmin),
                          jnp.asarray(cube))
    tq = tm.quantize_cols(*map(torch.from_numpy, xyz), torch.from_numpy(bmin),
                          torch.tensor(cube))
    for a, b in zip(jq, tq):
        _eq(a, b)
    for a, b in zip(jm.dequantize_cols(*jq, jnp.asarray(bmin), jnp.asarray(cube)),
                    tm.dequantize_cols(*tq, torch.from_numpy(bmin),
                                       torch.tensor(cube))):
        _eq(a, b)


def test_morton_key_words():
    rng = np.random.default_rng(2)
    q = _q(rng, 4096)
    lvl = rng.integers(0, 20, 4096).astype(np.int32)
    jw = jm.encode(*map(jnp.asarray, q))
    tw = tm.encode(*map(torch.from_numpy, q))
    jk = jm.key_words_at_level(*jw, jnp.asarray(lvl))
    tk = tm.key_words_at_level(*tw, torch.from_numpy(lvl))
    for a, b in zip(jk, tk):
        _eq(a, b)


def test_segments_scans_and_compaction():
    rng = np.random.default_rng(3)
    n = 5000
    vals = rng.integers(0, 40, n).astype(np.int32)
    mask = rng.random(n) < 0.3
    markers = np.where(rng.random(n) < 0.05, rng.integers(-9, 9, n),
                       -1).astype(np.int32)
    markers[0] = -1
    _eq(js.exclusive_cumsum(jnp.asarray(vals)),
        ts.exclusive_cumsum(torch.from_numpy(vals)))
    _eq(js.take_last(jnp.asarray(markers)), ts.take_last(torch.from_numpy(markers)))
    _eq(js.popcount32(jnp.asarray(vals * 7919)),
        ts.popcount32(torch.from_numpy(vals * 7919)))
    ji, jn = js.compact_indices(jnp.asarray(mask))
    ti, tn = ts.compact_indices(torch.from_numpy(mask))
    _eq(ji, ti)
    assert int(jn) == int(tn)
    (jp,), jn = js.compact_mask_via_sort(jnp.asarray(mask), (jnp.asarray(vals),))
    (tp,), tn = ts.compact_mask_via_sort(torch.from_numpy(mask),
                                        (torch.from_numpy(vals),))
    _eq(jp, tp)


def test_segments_lexsort_is_stable_lexicographic():
    rng = np.random.default_rng(4)
    keys = [rng.integers(-3, 3, 3000).astype(np.int32) for _ in range(3)]
    keys[1][::7] = np.iinfo(np.int32).max
    keys[2][::5] = np.iinfo(np.int32).min
    perm = ts.lexsort([torch.from_numpy(k) for k in keys]).numpy()
    np.testing.assert_array_equal(perm, np.lexsort(keys[::-1]))


@pytest.mark.parametrize("out_len", [1 << 14, 1 << 11])   # fits / truncates
def test_ragged_plan_gather_broadcast(out_len):
    rng = np.random.default_rng(5)
    S, P = 300, 1 << 14
    cnt = np.where(rng.random(S) < 0.2, 0, rng.integers(1, 60, S)).astype(np.int32)
    off = rng.integers(0, P - 64, S).astype(np.int32)
    pool = rng.integers(-2**31, 2**31 - 1, P, dtype=np.int64).astype(np.int32)
    per_seg = rng.integers(0, 1000, S).astype(np.int32)
    jp = jr.plan(jnp.asarray(off), jnp.asarray(cnt), out_len)
    tp = tr.plan(torch.from_numpy(off), torch.from_numpy(cnt), out_len)
    v = np.asarray(jp.valid)
    np.testing.assert_array_equal(v, tp.valid.numpy())
    for a, b in ((jp.elem, tp.elem), (jp.seg_of, tp.seg_of),
                 (jr.gather_column(jp, jnp.asarray(pool)),
                  tr.gather_column(tp, torch.from_numpy(pool))),
                 (jr.broadcast_i32(jp, jnp.asarray(per_seg)),
                  tr.broadcast_i32(tp, torch.from_numpy(per_seg)))):
        np.testing.assert_array_equal(np.asarray(a)[v], b.numpy()[v])
    assert jr.window_for(1000, 17) == tr.window_for(1000, 17)


def test_morton_key_words_decode():
    rng = np.random.default_rng(6)
    q = _q(rng, 4096)
    lvl = rng.integers(0, 20, 4096).astype(np.int32)
    jk = jm.key_words_at_level(*jm.encode(*map(jnp.asarray, q)),
                               jnp.asarray(lvl))
    tk = [torch.from_numpy(np.array(k)) for k in jk]
    for a, b in zip(jm.key_words_decode(*jk), tm.key_words_decode(*tk)):
        _eq(a, b)


@pytest.mark.parametrize("out_len", [3000, 700, 0])   # covers / truncates / empty
def test_segments_expand_segments(out_len):
    rng = np.random.default_rng(7)
    cnt = np.where(rng.random(400) < 0.3, 0,
                   rng.integers(1, 12, 400)).astype(np.int32)
    cnt[-5:] = 0                                         # trailing empties
    for c in (cnt, np.zeros(50, np.int32)):
        j = js.expand_segments(jnp.asarray(c), out_len)
        t = ts.expand_segments(torch.from_numpy(c), out_len)
        for a, b in zip(j[:3], t[:3]):       # rows past the total included
            _eq(a, b)
        assert int(j[3]) == int(t[3])


def test_segments_run_starts_and_run_reduce_sum():
    rng = np.random.default_rng(8)
    n = 4000
    vals = np.sort(rng.integers(0, 300, n)).astype(np.int32)
    valid = np.arange(n) < 3500                  # invalid rows at the tail
    x = rng.integers(0, 256, n).astype(np.int32)
    js_st = js.run_starts(jnp.asarray(vals), jnp.asarray(valid))
    ts_st = ts.run_starts(torch.from_numpy(vals), torch.from_numpy(valid))
    _eq(js_st, ts_st)
    _eq(js.run_starts(jnp.asarray(vals)), ts.run_starts(torch.from_numpy(vals)))
    st = np.asarray(js_st)
    j = np.asarray(js.run_reduce_sum(jnp.asarray(x), js_st, jnp.asarray(valid)))
    t = ts.run_reduce_sum(torch.from_numpy(x), ts_st, torch.from_numpy(valid))
    np.testing.assert_array_equal(j[st], t.numpy()[st])   # run-start rows
    # the [n, k] form sums every column at once
    x2 = np.stack([x, 2 * x + 1], 1)
    t2 = ts.run_reduce_sum(torch.from_numpy(x2), ts_st, torch.from_numpy(valid))
    np.testing.assert_array_equal(t2.numpy()[st, 0], j[st])
    j1 = np.asarray(js.run_reduce_sum(jnp.asarray(x2[:, 1]), js_st,
                                      jnp.asarray(valid)))
    np.testing.assert_array_equal(t2.numpy()[st, 1], j1[st])
