"""Line and bounding-box overlays (port of simlod_tpu/render/lines.py; the
reference's rasterization.cuh:90-183, render.cu:637-688, 1197-1223).

Every line's parametric range is clipped against the homogeneous view volume
(each clip plane is linear in t), then the line is expanded into `line_steps`
screen-lerped samples, valid up to its screen length (the reference steps one
pixel at a time, clamped to 400 steps), and depth-tested into the frame.

Colours are int32 bit patterns of u32 words; the colour scatter-min needs
unsigned order, so it compares `x ^ INT32_MIN` (torch has no uint32 amin).
"""
from __future__ import annotations

import torch

from ..config import EngineConfig, Uniforms
from ..octree.structures import OctreeState
from ..ops.segments import I32_MIN, device_constant, expand_segments

# 12 box edges as pairs of corner octants ((x<<2)|(y<<1)|z)
_BOX_EDGES = (
    (0b000, 0b100), (0b000, 0b010), (0b000, 0b001),
    (0b111, 0b011), (0b111, 0b101), (0b111, 0b110),
    (0b100, 0b110), (0b100, 0b101),
    (0b010, 0b110), (0b010, 0b011),
    (0b001, 0b101), (0b001, 0b011),
)
BOX_COLOR = 0x000000FF   # the reference's box colour
SCRATCH = 4096           # framebuffer slots for line samples that draw nothing
# the frustum's 8 edges in NDC; the far quad sits at 0.99995 like the
# reference's
_FEND = 0.99995
_FRUSTUM_SEGS = (
    ((1, 1, -1.0), (1, 1, _FEND)), ((1, -1, -1.0), (1, -1, _FEND)),
    ((-1, 1, -1.0), (-1, 1, _FEND)), ((-1, -1, -1.0), (-1, -1, _FEND)),
    ((-1, -1, _FEND), (1, -1, _FEND)), ((-1, 1, _FEND), (1, 1, _FEND)),
    ((-1, -1, _FEND), (-1, 1, _FEND)), ((1, -1, _FEND), (1, 1, _FEND)))


def node_box_lines(state: OctreeState, emitted: torch.Tensor, max_lines: int):
    """Wireframe edges of the emitted nodes' AABBs -> (a [L, 3], b [L, 3],
    colour i32 [L], valid [L])."""
    node_of, _elem, valid, _tot = expand_segments(emitted.to(torch.int32),
                                                  max_lines // 12)
    n = node_of.long()
    size = state.cube_size / torch.exp2(state.level[n].to(torch.float32))
    mn = state.box_min[None, :] + size[:, None] * torch.stack(
        [state.nx[n], state.ny[n], state.nz[n]], -1).to(torch.float32)
    mx = mn + size[:, None]

    def corner(o):
        return torch.stack([mx[:, k] if (o >> (2 - k)) & 1 else mn[:, k]
                            for k in range(3)], -1)

    a = torch.cat([corner(e[0]) for e in _BOX_EDGES])
    b = torch.cat([corner(e[1]) for e in _BOX_EDGES])
    v = torch.cat([valid] * 12)
    color = torch.full((a.shape[0],), BOX_COLOR, dtype=torch.int32,
                       device=a.device)
    return a, b, color, v


def frustum_lines(uniforms: Uniforms):
    """The frozen-visibility camera frustum wireframe (render.cu:1197-1223):
    corners unprojected from the NDC cube with the inverse of the frozen
    transform; the far quad sits at 0.99995 like the reference's.

    The inverse and the unprojection run in float64 and round once to
    float32: near the far plane the unprojection amplifies the inverse's
    rounding ~1e4 times, and a float32 inverse rounds differently on the CPU,
    the GPU and in the JAX package (whose corners are float32 throughout)."""
    m = uniforms.transform_update_bound.double()
    minv = torch.linalg.inv_ex(m).inverse      # no error check: no host sync

    def unproject(pts):
        # the NDC corners are a device constant: a captured frame copies
        # nothing from the host
        ph = device_constant(tuple((x, y, z, 1.0) for x, y, z in pts),
                             torch.float64, m.device)
        p = ph @ minv.T
        return (p[:, :3] / p[:, 3:4]).float()

    a = unproject([s for s, _ in _FRUSTUM_SEGS])
    b = unproject([e for _, e in _FRUSTUM_SEGS])
    n = len(_FRUSTUM_SEGS)
    color = torch.full((n,), BOX_COLOR, dtype=torch.int32, device=m.device)
    valid = torch.ones((n,), dtype=torch.bool, device=m.device)
    return a, b, color, valid


def _clip_t_range(ca, cb, t_lo, t_hi):
    """Intersect [t_lo, t_hi] with { t : ca*(1-t) + cb*t >= 0 } (a linear
    clip plane)."""
    cross = ca / torch.where(ca == cb, 1.0, ca - cb)
    t_lo = torch.where((ca < 0) & (cb >= 0), torch.maximum(t_lo, cross), t_lo)
    t_hi = torch.where((ca >= 0) & (cb < 0), torch.minimum(t_hi, cross), t_hi)
    empty = (ca < 0) & (cb < 0)
    return torch.where(empty, 1.0, t_lo), torch.where(empty, 0.0, t_hi)


def rasterize_lines(cfg: EngineConfig, uniforms: Uniforms, width: int,
                    height: int, color_fb: torch.Tensor,
                    depth_fb: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                    line_color: torch.Tensor, valid: torch.Tensor):
    """Clip, project and splat lines into (color_fb, depth_fb) (i32 [H*W]
    each: u32 colour bits, f32 depth bits); returns the new pair."""
    steps = cfg.line_steps
    npx = width * height
    dev = a.device
    m = uniforms.transform

    def clip4(p):   # [L, 3] world -> [L, 4] clip space
        # (x m0 + y m1) + (z m2 + m3): the summation order of XLA's CPU dot
        # for this [L, 4] x [4, 4] product, so the clip is bit-equal to the
        # JAX package's
        return torch.stack([(p[:, 0] * m[r, 0] + p[:, 1] * m[r, 1])
                            + (p[:, 2] * m[r, 2] + m[r, 3]) for r in range(4)],
                           -1)

    ca4, cb4 = clip4(a), clip4(b)
    eps = 1e-6
    # homogeneous clip: w >= eps, |x'| <= w, |y'| <= w, each linear in t
    t_lo = torch.zeros(a.shape[0], dtype=torch.float32, device=dev)
    t_hi = torch.ones(a.shape[0], dtype=torch.float32, device=dev)
    for wa, wb in (
        (ca4[:, 3] - eps, cb4[:, 3] - eps),
        (ca4[:, 3] - ca4[:, 0], cb4[:, 3] - cb4[:, 0]),
        (ca4[:, 3] + ca4[:, 0], cb4[:, 3] + cb4[:, 0]),
        (ca4[:, 3] - ca4[:, 1], cb4[:, 3] - cb4[:, 1]),
        (ca4[:, 3] + ca4[:, 1], cb4[:, 3] + cb4[:, 1]),
    ):
        t_lo, t_hi = _clip_t_range(wa, wb, t_lo, t_hi)
    ok_line = valid & (t_lo < t_hi)

    lerp = lambda p, q, t: p * (1.0 - t[:, None]) + q * t[:, None]
    cs = lerp(ca4, cb4, t_lo)
    ce = lerp(ca4, cb4, t_hi)
    ndc_s = cs[:, :2] / cs[:, 3:4]
    ndc_e = ce[:, :2] / ce[:, 3:4]
    sx_s = (ndc_s[:, 0] * 0.5 + 0.5) * uniforms.width
    sy_s = (ndc_s[:, 1] * 0.5 + 0.5) * uniforms.height
    sx_e = (ndc_e[:, 0] * 0.5 + 0.5) * uniforms.width
    sy_e = (ndc_e[:, 1] * 0.5 + 0.5) * uniforms.height
    # screen-length stepping, clamped to the step budget
    slen = torch.sqrt((sx_e - sx_s) ** 2 + (sy_e - sy_s) ** 2)
    nstep = torch.clamp(torch.ceil(slen), 1.0, float(steps - 1))

    j = torch.arange(steps, dtype=torch.float32, device=dev)
    u = torch.clamp(j[None, :] / nstep[:, None], max=1.0)       # [L, S]
    use = ok_line[:, None] & (j[None, :] <= nstep[:, None])
    lerpv = lambda p, q: p[:, None] * (1.0 - u) + q[:, None] * u
    x = lerpv(sx_s, sx_e)
    y = lerpv(sy_s, sy_e)
    # linear depth interpolation like the reference (rasterization.cuh:152-158),
    # with a slight viewer bias so overlays win ties
    d = lerpv(cs[:, 3], ce[:, 3]) * 0.999

    xi = torch.clamp(x.to(torch.int32), 0, width - 1)
    yi = torch.clamp(y.to(torch.int32), 0, height - 1)
    pix = (xi + width * yi).reshape(-1)
    use = (use & (x >= 0) & (x < uniforms.width) & (y >= 0)
           & (y < uniforms.height) & (d > 0)).reshape(-1)
    dbits = d.view(torch.int32).reshape(-1)
    col = line_color.repeat_interleave(steps)

    # samples that draw nothing (most of the static line window) land on
    # SCRATCH slots past the frame, spread out: on one slot their millions
    # of atomics would serialize on the card
    spread = npx + torch.arange(pix.shape[0], device=dev) % SCRATCH
    dmin = torch.cat([depth_fb, depth_fb.new_zeros(SCRATCH)])
    dmin.scatter_reduce_(0, torch.where(use, pix, spread), dbits, "amin")
    dmin = dmin[:npx]
    won = use & (dbits <= dmin[pix.clamp(0, npx - 1).long()])
    # unsigned colour min: signed min of the sign-flipped bits; the empty
    # value 0xFFFFFFFF flips to INT32_MAX
    cmin = torch.full((npx + SCRATCH,), -1 ^ I32_MIN, dtype=torch.int32,
                      device=dev)
    cmin.scatter_reduce_(0, torch.where(won, pix, spread), col ^ I32_MIN,
                         "amin")
    cmin = cmin[:npx]
    color_out = torch.where(cmin < (-1 ^ I32_MIN), cmin ^ I32_MIN, color_fb)
    return color_out, dmin
