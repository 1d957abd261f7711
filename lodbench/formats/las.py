"""LAS 1.2: a 227-byte public header block, then point records. The writer
makes point-format-2 records (26 B: XYZ int32 at the scale from the box's
min, RGB 16-bit at byte 20 as colour * 257); the reader is the plain
reference's decode (the reference's LasLoader: formats 0-3, 5, 7, 8, 10,
16-bit colours scaled down where they exceed 255, white without colour)."""
from __future__ import annotations

import os
import struct

import numpy as np
import torch

SUFFIX = ".las"
HEADER = 227
RECORD = 26
WRITE_ROWS = 1 << 23           # rows written per copy from the device
READ_ROWS = 1 << 23            # records decoded on the device at a time


def header(n: int, mn, mx, scale: float, offset) -> bytes:
    """A LAS 1.2 public header block for n point-format-2 records."""
    buf = bytearray(HEADER)
    buf[0:4] = b"LASF"
    buf[24], buf[25] = 1, 2
    struct.pack_into("<H", buf, 94, HEADER)
    struct.pack_into("<I", buf, 96, HEADER)
    struct.pack_into("<I", buf, 100, 0)
    buf[104] = 2
    struct.pack_into("<H", buf, 105, RECORD)
    struct.pack_into("<I", buf, 107, n)
    struct.pack_into("<3d", buf, 131, scale, scale, scale)
    struct.pack_into("<3d", buf, 155, *offset)
    for axis, o in enumerate((179, 195, 211)):
        struct.pack_into("<d", buf, o, mx[axis])
        struct.pack_into("<d", buf, o + 8, mn[axis])
    return bytes(buf)


def write(path: str, xyz: torch.Tensor, rgba: torch.Tensor,
          scale: float = 0.001) -> None:
    mn = xyz.min(0).values.double()
    mx = xyz.max(0).values.double()
    n = xyz.shape[0]
    with open(path, "wb") as f:
        f.write(header(n, mn.tolist(), mx.tolist(), scale, mn.tolist()))
        for s in range(0, n, WRITE_ROWS):
            p = xyz[s:s + WRITE_ROWS].double()
            q = torch.round((p - mn) / scale).to(torch.int32)
            c = rgba[s:s + WRITE_ROWS].to(torch.int64)
            rgb = torch.stack([(c >> (8 * k)) & 0xFF for k in range(3)], 1) * 257
            rgb = torch.where(rgb >= (1 << 15), rgb - (1 << 16), rgb)
            rec = torch.zeros((q.shape[0], RECORD // 2), dtype=torch.int16,
                              device=xyz.device)
            rec[:, 0:6] = q.contiguous().view(torch.int16)
            rec[:, 10:13] = rgb.to(torch.int16)
            rec.cpu().numpy().tofile(f)
        # on the disk in set-up, so that its write-back stays out of the
        # window (the file stays in the page cache)
        f.flush()
        os.fsync(f.fileno())


def _head(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read(375)


def _box(head: bytes) -> tuple:
    mx = [struct.unpack_from("<d", head, o)[0] for o in (179, 195, 211)]
    mn = [struct.unpack_from("<d", head, o)[0] for o in (187, 203, 219)]
    return mn, mx


def extent(path: str) -> list:
    """The box's extent (max - min an axis), from the header."""
    mn, mx = _box(_head(path))
    return [b - a for a, b in zip(mn, mx)]


def read(path: str, device) -> tuple:
    """-> (positions rebased to the box's min as float32 [n, 3], colours as
    int32 words [n], the octree's cube edge: the largest extent as float32),
    on `device`."""
    head = _head(path)
    offset_to_points = struct.unpack_from("<I", head, 96)[0]
    fmt = head[104] & 0x3F
    bpp = struct.unpack_from("<H", head, 105)[0]
    n = struct.unpack_from("<I", head, 107)[0]
    scale = struct.unpack_from("<3d", head, 131)
    offset = struct.unpack_from("<3d", head, 155)
    mn, mx = _box(head)
    rgb_at = {2: 20, 3: 28, 5: 28, 7: 30, 8: 30, 10: 30}.get(fmt)
    raw = np.memmap(path, np.uint8, "r", offset=offset_to_points,
                    shape=(n * bpp,)).reshape(n, bpp)
    f64 = dict(dtype=torch.float64, device=device)
    sc, off, lo = (torch.tensor(v, **f64) for v in (scale, offset, mn))
    xyz, rgba = [], []
    for s in range(0, n, READ_ROWS):
        rec = torch.from_numpy(np.array(raw[s:s + READ_ROWS])).to(device)
        ints = rec[:, :12].contiguous().view(torch.int32).to(torch.float64)
        # world coordinates, then rebased to the box's min
        xyz.append(((ints * sc + off) - lo).float())
        if rgb_at is None:
            c = torch.full((rec.shape[0], 3), 255, dtype=torch.int64,
                           device=device)
        else:
            c = rec[:, rgb_at:rgb_at + 6].contiguous().view(torch.int16)
            c = c.to(torch.int64) & 0xFFFF
            c = torch.where(c > 255, c // 256, c)
        word = c[:, 0] | (c[:, 1] << 8) | (c[:, 2] << 16) | (255 << 24)
        rgba.append(torch.where(word >= (1 << 31), word - (1 << 32),
                                word).to(torch.int32))
    cube = torch.tensor(float(np.float32(max(b - a for a, b in zip(mn, mx)))),
                        device=device)
    return torch.cat(xyz), torch.cat(rgba), cube
