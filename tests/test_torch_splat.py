"""The splat route of the port (render/raster.py: splat_columns, then the CUDA
kernel splat_resolve or, on CPU tensors, its plain version
splat_resolve_reference) on the CPU:

  - raster.rasterize against the JAX package's raster.rasterize: bit-equal, in
    both shading modes, at point sizes 1 and 2, over two sample sets;
  - the port's default route against the JAX rasterize_tiles with the Pallas
    kernel in interpret mode: bit-equal;
  - hand-made columns against a numpy u64-min / integer-sum oracle: exact
    (pixel, depth) ties, 1000 rows on one pixel, rows that draw nothing, an
    empty frame;
  - the route switch, the wrapper's refusal of CPU tensors, and the entry
    points' default device (the card: without one they raise).

On a machine with a card, tests/test_torch_port.py (`-m cuda`) holds the
kernel to its plain version there.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from simlod_tpu import constants as C
from simlod_tpu.config import EngineConfig as JCfg, Settings as JSet, Uniforms as JUni
from simlod_tpu.render import raster as jr
from simlod_tpu.render import raster_tiles as jt
from simlod_tpu_torch.config import EngineConfig as TCfg, Settings as TSet, Uniforms as TUni
from simlod_tpu_torch.engine import Engine
from simlod_tpu_torch.outofcore import OutOfCoreEngine
from simlod_tpu_torch.render import raster as tr
from simlod_tpu_torch.render import raster_tiles as tt
from simlod_tpu_torch.render import render as trender

# six test processes share the machine in the tier-1 run; these small tensors
# gain nothing from intra-op threads, which would oversubscribe the cores
torch.set_num_threads(1)

W, H = 160, 120
NPX = W * H
INF = np.uint32(C.DEPTH_INF_BITS)
BG = np.uint32(C.BACKGROUND_COLOR)


def _samples(rng, n, spread=0.8):
    """Seeded samples for both packages; rows 100-199 repeat the positions of
    rows 0-99 with other colours (exact (pixel, depth) ties)."""
    x = rng.uniform(-spread, spread, n).astype(np.float32)
    y = rng.uniform(-spread, spread, n).astype(np.float32)
    z = rng.uniform(1.0, 5.0, n).astype(np.float32)
    rgba = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    x[100:200], y[100:200], z[100:200] = x[:100], y[:100], z[:100]
    valid = np.ones(n, bool)
    valid[-3:] = False
    js = jr.Samples(x=jnp.asarray(x), y=jnp.asarray(y), z=jnp.asarray(z),
                    rgba=jnp.asarray(rgba),
                    node_fn=lambda: jnp.zeros(n, jnp.int32),
                    level_fn=lambda: jnp.zeros(n, jnp.int32),
                    valid=jnp.asarray(valid), count=jnp.int32(n - 3))
    ts = tr.Samples(x=torch.from_numpy(x), y=torch.from_numpy(y),
                    z=torch.from_numpy(z),
                    rgba=torch.from_numpy(rgba.view(np.int32)),
                    node_fn=lambda: torch.zeros(n, dtype=torch.int32),
                    level_fn=lambda: torch.zeros(n, dtype=torch.int32),
                    valid=torch.from_numpy(valid), count=torch.tensor(n - 3))
    return js, ts


def _ortho(hqs, point_size=1):
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = m[1, 1] = m[3, 2] = 1.0
    kw = dict(use_high_quality_shading=hqs, enable_edl=False,
              point_size=point_size)
    return (JUni.make(W, H, m, settings=JSet(**kw)),
            TUni.make(W, H, m, settings=TSet(**kw), device="cpu"))


def _eq(j, t):
    np.testing.assert_array_equal(np.asarray(j).view(np.int32), t.numpy())


@pytest.mark.parametrize("point_size", [1, 2])
@pytest.mark.parametrize("hqs", [True, False])
def test_rasterize_matches_jax_rasterize(hqs, point_size):
    (ja, ta), (jb, tb) = (_samples(np.random.default_rng(s), n)
                          for s, n in ((11, 3000), (12, 1500)))
    ju, tu = _ortho(hqs, point_size)
    jc, jd = jr.rasterize(JCfg(max_point_size=point_size), ju, W, H, [ja, jb])
    tc, td = tr.rasterize(TCfg(max_point_size=point_size), tu, W, H, [ta, tb])
    _eq(jd, td)
    _eq(jc, tc)
    assert (tc.numpy() != C.BACKGROUND_COLOR).mean() > 0.05


@pytest.mark.parametrize("hqs", [True, False])
def test_default_route_matches_pallas_tiles(hqs):
    js, ts = _samples(np.random.default_rng(7), 4096)
    ju, tu = _ortho(hqs)
    jc, jd = jt.rasterize_tiles(JCfg(), ju, W, H, [js], interpret=True)
    tc, td = trender._rasterize(TCfg(), tu, W, H, [ts], None, None)
    _eq(jd, td)
    _eq(jc, tc)


def _oracle(pix, dbits, color, hqs):
    """numpy u64 atomicMin of (depth bits << 32 | colour), then the HQS
    integer sums or the plain winner; rows with pix == NPX draw nothing."""
    m = pix < NPX
    p = pix[m]
    key = (dbits[m].view(np.uint32).astype(np.uint64) << np.uint64(32)) \
        | color[m].view(np.uint32).astype(np.uint64)
    fb = np.full(NPX, np.iinfo(np.uint64).max, np.uint64)
    np.minimum.at(fb, p, key)
    hi = (fb >> np.uint64(32)).astype(np.uint32)
    depth = np.minimum(hi, INF)
    if hqs:
        wd = hi[p].view(np.float32)
        take = dbits[m].view(np.float32) < wd * np.float32(1.01)
        c = color[m].view(np.uint32)[take].astype(np.uint64)
        sums = np.zeros((NPX, 4), np.uint64)
        np.add.at(sums, p[take], np.stack([c & 0xFF, (c >> 8) & 0xFF,
                                           (c >> 16) & 0xFF,
                                           np.ones_like(c)], -1))
        n = np.maximum(sums[:, 3], 1)
        out = np.where(sums[:, 3] > 0,
                       (sums[:, 0] // n) | ((sums[:, 1] // n) << 8)
                       | ((sums[:, 2] // n) << 16) | 0xFF000000, BG)
    else:
        out = np.where(hi < INF, fb & 0xFFFFFFFF, BG)
    return out.astype(np.uint32).view(np.int32), depth.view(np.int32)


def _columns(case, rng):
    """(pix, dbits, color) int32 numpy columns of one hand-made case."""
    f = lambda a: np.asarray(a, np.float32).view(np.int32)
    cols = lambda n: rng.integers(0, 2**32, n, dtype=np.uint64).astype(
        np.uint32).view(np.int32)
    if case == "ties":       # equal (pixel, depth), other colours; deeper rows
        pix = np.repeat(np.array([3, 7, 11, NPX - 1], np.int32), 12)
        d = np.where(np.arange(48) % 3 == 0, 2.5, 2.0).astype(np.float32)
        return pix, f(d), cols(48)
    if case == "one_pixel":  # 1000 rows on one pixel, some at equal depth,
        # some exactly at the HQS limit (1.0 * 1.01 rounds to f32(1.01))
        d = rng.choice(np.float32([1.0, 1.005, 1.01, 1.0101, 1.02, 3.0]), 1000)
        return np.full(1000, 5, np.int32), f(d), cols(1000)
    if case == "unused":     # rows at pix == NPX carry the nearest depths
        n = 2000
        pix = rng.integers(0, 64, n).astype(np.int32)
        d = rng.uniform(1.0, 2.0, n).astype(np.float32)
        off = rng.random(n) < 0.5
        pix[off], d[off] = NPX, 0.5
        return pix, f(d), cols(n)
    return (np.zeros(0, np.int32),) * 3     # empty frame


@pytest.mark.parametrize("hqs", [True, False])
@pytest.mark.parametrize("case", ["ties", "one_pixel", "unused", "empty"])
def test_splat_plain_version_matches_oracle(case, hqs):
    pix, dbits, color = _columns(case, np.random.default_rng(5))
    want_c, want_d = _oracle(pix, dbits, color, hqs)
    mode = torch.tensor([int(hqs)], dtype=torch.int32)
    got_c, got_d = tr.splat_resolve_reference(
        *map(torch.from_numpy, (pix, dbits, color)), mode, NPX)
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    drawn = (got_c.numpy() != C.BACKGROUND_COLOR).sum()
    assert drawn == (0 if case == "empty" else len(np.unique(pix[pix < NPX])))


def test_splat_resolve_rejects_cpu_tensors():
    before = tr.splat_resolve.launches
    z = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tr.splat_resolve(z, z, z, torch.ones(1, dtype=torch.int32), NPX)
    assert tr.splat_resolve.launches == before


@pytest.mark.parametrize("hqs", [True, False])
def test_route_switch(monkeypatch, hqs):
    """render._rasterize takes raster.rasterize by default and the tile route
    with use_tile_raster=True; the two images are equal."""
    taken = []
    for mod, name in ((tr, "rasterize"), (tt, "rasterize_tiles")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name:
                            taken.append(_n) or _fn(*a))
    _, ts = _samples(np.random.default_rng(8), 4096)
    _, tu = _ortho(hqs)
    assert not TCfg().use_tile_raster
    a = trender._rasterize(TCfg(), tu, W, H, [ts], None, None)
    b = trender._rasterize(TCfg(use_tile_raster=True), tu, W, H, [ts], None,
                           None)
    assert taken == ["rasterize", "rasterize_tiles"]
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("make", [Engine, OutOfCoreEngine])
def test_entry_points_default_to_the_card(make):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make()


