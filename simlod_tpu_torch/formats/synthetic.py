"""Synthetic point-cloud generation for tests and benchmarks.

The reference benchmarks against the Morro Bay / San Simeon lidar scans (README.md:
131-137), which are not redistributable here. This module generates clouds with the
same structural character — a 2.5D terrain surface with buildings/vegetation-like
clutter and scan-line spatial locality — so octree depth, split cascades, and voxel
occupancy behave like real lidar.
"""
from __future__ import annotations

import numpy as np


def terrain(n: int, seed: int = 0, extent: float = 1000.0, z_scale: float = 120.0,
            scan_order: bool = True):
    """Generate a lidar-like terrain cloud -> (xyz f32 [n,3], rgba u32 [n]).

    Multi-octave sine terrain + gaussian clutter; points are emitted in scan-line
    order (like real LAS files) unless scan_order=False (uniform shuffle).
    """
    rng = np.random.default_rng(seed)
    if scan_order:
        # boustrophedon scan lines with jitter: strong spatial locality like real scans
        lines = max(1, int(np.sqrt(n / 4)))
        per = n // lines + 1
        ys = np.repeat(np.linspace(0, 1, lines), per)[:n]
        xs = np.tile(np.linspace(0, 1, per), lines)[:n]
        flip = (np.repeat(np.arange(lines), per)[:n] % 2) == 1
        xs = np.where(flip, 1.0 - xs, xs)
        xs = np.clip(xs + rng.normal(0, 0.3 / per, n), 0, 1)
        ys = np.clip(ys + rng.normal(0, 0.3 / lines, n), 0, 1)
    else:
        xs = rng.random(n)
        ys = rng.random(n)

    def height(u, v):
        h = np.zeros_like(u)
        for freq, amp in ((2.1, 0.5), (5.3, 0.25), (11.7, 0.12), (23.9, 0.06)):
            h += amp * np.sin(freq * u * 2 * np.pi + freq) \
                * np.cos(freq * v * 2 * np.pi + 2 * freq)
        return h

    z = height(xs, ys)
    # clutter clusters (trees/buildings): lift ~8% of points above ground
    m = n // 12
    idx = rng.integers(0, n, m)
    z[idx] += rng.gamma(2.0, 0.03, m)
    z = (z - z.min()) / (np.ptp(z) + 1e-9)

    xyz = np.stack([xs * extent, ys * extent, z * z_scale], -1).astype(np.float32)

    t = z.astype(np.float32)
    r = (46 + 180 * t).astype(np.uint32)
    g = (82 + 120 * t).astype(np.uint32)
    b = (140 - 90 * t).astype(np.uint32)
    rgba = (r | (g << 8) | (b << 16) | np.uint32(255) << 24).astype(np.uint32)
    return xyz, rgba


def clustered(n: int, seed: int = 0, extent: float = 1000.0,
              depth_scales: int = 12, cluster_frac: float = 0.5):
    """Generate a cloud that forces a DEEP octree -> (xyz f32 [n,3], rgba u32 [n]).

    The scan terrain above splats points near-uniformly over the ground plane, so
    a 50k-point leaf cap resolves at depth ~5 even at 64M points. Real datasets
    (and the reference's San Simeon tiles, README.md:131-137) contain density
    hotspots that split much deeper. Here `cluster_frac` of the points land in
    gaussian clusters whose sigmas are log-spaced down to extent/2^depth_scales:
    any leaf cell bigger than a cluster keeps >cap points inside it, so the build
    must subdivide until cell size ~ sigma — a guaranteed depth ~depth_scales
    cascade (exercises the frontier split loop far beyond the terrain bench).
    """
    rng = np.random.default_rng(seed)
    n_base = n - int(n * cluster_frac)
    xyz_b, rgba_b = terrain(n_base, seed=seed + 1, extent=extent)

    n_cl = n - n_base
    # one cluster per scale, a few extra at the coarse end; every cluster gets
    # an equal point share so the finest (deepest) cluster is fully loaded
    sigmas = extent / np.exp2(np.linspace(3, depth_scales, depth_scales))
    centers = rng.random((len(sigmas), 3)) * extent * 0.8 + extent * 0.1
    per = np.full(len(sigmas), n_cl // len(sigmas))
    per[: n_cl - per.sum()] += 1
    parts = []
    for c, s, m in zip(centers, sigmas, per):
        parts.append(c + rng.normal(0, s, (m, 3)))
    xyz_c = np.concatenate(parts).astype(np.float32)
    np.clip(xyz_c, 0, extent, out=xyz_c)
    t = rng.random(n_cl, dtype=np.float32)
    r = (200 + 55 * t).astype(np.uint32)
    g = (60 + 120 * t).astype(np.uint32)
    b = (40 + 40 * t).astype(np.uint32)
    rgba_c = (r | (g << 8) | (b << 16) | np.uint32(255) << 24).astype(np.uint32)

    xyz = np.concatenate([xyz_b, xyz_c])
    rgba = np.concatenate([rgba_b, rgba_c])
    # interleave deterministically so clusters arrive spread across batches
    # (stresses revisit/split behavior instead of one catastrophic batch)
    order = rng.permutation(n)
    return xyz[order], rgba[order]


def cloud_bounds(xyz: np.ndarray):
    return xyz.min(axis=0), xyz.max(axis=0)
