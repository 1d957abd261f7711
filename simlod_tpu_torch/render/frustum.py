"""Frustum culling math (port of simlod_tpu/render/frustum.py).

Gribb-Hartmann plane extraction from a world-view-projection matrix plus the
positive-vertex AABB test (reference math.cuh:154-199).
"""
from __future__ import annotations

import numpy as np
import torch


def _fma(a, b, c):
    """XLA's fused multiply-add of f32 tensors, emulated in float64 (the
    product of two f32 values is exact there) and rounded to f32."""
    return (a.double() * b.double() + c.double()).float()


def frustum_planes(m: torch.Tensor) -> torch.Tensor:
    """6 normalized planes [6,4] (nx,ny,nz,d) from a row-major transform `m` that
    acts on column vectors (reference math.cuh:69-108 / 154-186)."""
    planes = torch.stack([
        m[3] - m[0],   # right
        m[3] + m[0],   # left
        m[3] + m[1],   # bottom
        m[3] - m[1],   # top
        m[3] - m[2],   # far
        m[3] + m[2],   # near
    ])
    # XLA evaluates the norm's sum of squares as a fused multiply-add chain,
    # fma(z, z, fma(y, y, x*x))
    x, y, z = planes[:, 0], planes[:, 1], planes[:, 2]
    n = torch.sqrt(_fma(z, z, _fma(y, y, x * x)))[:, None]
    return planes / torch.clamp(n, min=1e-30)


def frustum_planes_host(m) -> np.ndarray:
    """frustum_planes on the host: float32 [6, 4] numpy, bit-equal to the
    device version (every step is one IEEE-rounded float32 op, the norm's
    fused multiply-adds emulated in float64 as there). The visibility kernel
    takes these planes by value."""
    m = np.asarray(m, np.float32).reshape(4, 4)
    planes = np.stack([m[3] - m[0], m[3] + m[0], m[3] + m[1],
                       m[3] - m[1], m[3] - m[2], m[3] + m[2]])

    def fma(a, b, c):
        return (a.astype(np.float64) * b + c).astype(np.float32)

    x, y, z = planes[:, 0], planes[:, 1], planes[:, 2]
    n = np.sqrt(fma(z, z, fma(y, y, x * x)))[:, None]
    return planes / np.maximum(n, np.float32(1e-30))


def intersects_frustum_cols(planes, mnx, mny, mnz, mxx, mxy, mxz):
    """Column-wise p-vertex test over 1-D AABB coordinate arrays."""
    ok = None
    for i in range(6):
        nx, ny, nz, d = planes[i, 0], planes[i, 1], planes[i, 2], planes[i, 3]
        px = torch.where(nx > 0, mxx, mnx)
        py = torch.where(ny > 0, mxy, mny)
        pz = torch.where(nz > 0, mxz, mnz)
        good = (px * nx + py * ny + pz * nz + d) >= 0.0
        ok = good if ok is None else (ok & good)
    return ok


def intersects_frustum(planes: torch.Tensor, box_min: torch.Tensor,
                       box_max: torch.Tensor) -> torch.Tensor:
    """p-vertex test of [N, 3] boxes -> [N] bool (reference math.cuh:186-199):
    each plane's corner most positive along its normal must lie on or in front
    of it. The JAX package writes the distances as an einsum over the three
    coordinates, which XLA's CPU dot contracts into fused multiply-adds,
    fma(p2, n2, fma(p1, n1, p0 * n0)) + d; the columns here follow that order
    (intersects_frustum_cols, the visibility pass's test, rounds each
    product)."""
    n, d = planes[:, :3], planes[:, 3]
    pv = torch.where(n[None, :, :] > 0, box_max[:, None, :],
                     box_min[:, None, :])                     # [N, 6, 3]
    dist = _fma(pv[..., 2], n[:, 2],
                _fma(pv[..., 1], n[:, 1], pv[..., 0] * n[:, 0])) + d
    return torch.all(dist >= 0.0, dim=1)
