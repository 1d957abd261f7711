"""The benchmark's inputs, made from the seed on the device: a lidar-like
terrain (a copy, in PyTorch, of the port's numpy generator
`formats.synthetic.terrain`), written as the configuration's file format
by the writer of lodbench/formats/<format>.py.

The writers are the benchmark's own, written from the formats' definitions,
so that the program reads a file it did not write.
"""
from __future__ import annotations

import math
import os

import torch

from lodbench import found



def terrain(n: int, seed: int, device, extent: float = 1000.0,
            z_scale: float = 120.0, scan_order: bool = True):
    """A lidar-like cloud of n points -> (xyz f32 [n, 3], rgba i32 [n], the
    u32 colour bits), on `device`, the same for the same seed.

    Multi-octave sine terrain, gamma-distributed clutter lifting 1/12 of the
    points, boustrophedon scan lines with jitter (the order of a lidar scan),
    colours from the height: the port's generator, with its draws taken from
    a torch.Generator on the device (the clutter's points drawn without
    replacement, so that the same seed always adds the same heights)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    f64 = dict(dtype=torch.float64, device=device)
    if scan_order:
        lines = max(1, int(math.sqrt(n / 4)))
        per = n // lines + 1
        i = torch.arange(n, dtype=torch.int64, device=device)
        line, col = i // per, i % per
        ys = line.to(torch.float64) / max(lines - 1, 1)
        xs = col.to(torch.float64) / max(per - 1, 1)
        xs = torch.where(line % 2 == 1, 1.0 - xs, xs)
        del i, line, col
        xs = (xs + torch.randn(n, generator=g, **f64) * (0.3 / per)).clamp_(0, 1)
        ys = (ys + torch.randn(n, generator=g, **f64) * (0.3 / lines)).clamp_(0, 1)
    else:
        xs = torch.rand(n, generator=g, **f64)
        ys = torch.rand(n, generator=g, **f64)

    z = torch.zeros(n, **f64)
    for freq, amp in ((2.1, 0.5), (5.3, 0.25), (11.7, 0.12), (23.9, 0.06)):
        z += amp * torch.sin(freq * xs * 2 * math.pi + freq) \
            * torch.cos(freq * ys * 2 * math.pi + 2 * freq)
    m = n // 12
    idx = torch.randperm(n, generator=g, device=device)[:m]
    # gamma(2, 0.03): the sum of two exponentials of scale 0.03
    u = 1.0 - torch.rand((2, m), generator=g, **f64)
    z[idx] += -0.03 * torch.log(u).sum(0)
    del idx, u
    z = (z - z.min()) / (z.max() - z.min() + 1e-9)

    xyz = torch.stack([xs * extent, ys * extent, z * z_scale], -1).float()
    t = z.float()
    r = (46 + 180 * t).to(torch.int64)
    gg = (82 + 120 * t).to(torch.int64)
    b = (140 - 90 * t).to(torch.int64)
    rgba = r | (gg << 8) | (b << 16) | (255 << 24)
    rgba = torch.where(rgba >= (1 << 31), rgba - (1 << 32), rgba).to(torch.int32)
    return xyz, rgba


def make_scan(config: dict, seed: int, device, directory: str,
              points: int | None = None) -> str:
    """The configuration's scan from the seed, written as its file format in
    `directory` -> the file's path."""
    gen = config["generator"]
    n = points or config["points"]
    xyz, rgba = terrain(n, seed, device, extent=gen["extent"],
                        z_scale=gen["z_scale"], scan_order=gen["scan_order"])
    fmt = found.module("formats", config["format"])
    path = os.path.join(directory, "scan" + fmt.SUFFIX)
    fmt.write(path, xyz, rgba)
    return path
