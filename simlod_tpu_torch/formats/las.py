"""LAS format reader and writer (port of simlod_tpu/formats/las.py).

Replicates the reference's native loader (LasLoader.h:21-55 header fields,
LasLoader.cpp:169-227 point decode): int32 XYZ * scale + offset + translation
(the engine passes -box_min, so coordinates are rebased to the origin), 16-bit
RGB scaled to 8-bit when > 255, RGB record offsets per point format 2/3/5/7
(LasLoader.cpp:178-187). Formats without RGB decode as white, alpha 255.

Points decode with the native single-pass decoder (native/fastload.c);
`decode_points_reference` is its numpy plain version, which the tests hold it to.
"""
from __future__ import annotations

import dataclasses
import struct

import numpy as np

from .. import native

RGB_OFFSET = {2: 20, 3: 28, 5: 28, 7: 30, 8: 30, 10: 30}


@dataclasses.dataclass
class LasHeader:
    path: str
    version: tuple
    header_size: int
    offset_to_points: int
    format: int
    bytes_per_point: int
    num_points: int
    scale: np.ndarray         # [3] f64
    offset: np.ndarray        # [3] f64
    box_min: np.ndarray       # [3] f64 (original CRS coords)
    box_max: np.ndarray       # [3] f64


def load_header(path: str) -> LasHeader:
    with open(path, "rb") as f:
        buf = f.read(375)
    if len(buf) < 227 or buf[:4] != b"LASF":
        raise ValueError(f"{path}: not a LAS/LAZ file")
    vmaj, vmin = buf[24], buf[25]
    header_size = struct.unpack_from("<H", buf, 94)[0]
    offset_to_points = struct.unpack_from("<I", buf, 96)[0]
    fmt = buf[104] & 0x3F  # the high bits flag compression in LAZ
    bpp = struct.unpack_from("<H", buf, 105)[0]
    # LAS <= 1.3 has only the legacy u32 count at 107; 1.4 adds the u64 at 247
    # but still fills the legacy field when the count fits
    legacy = struct.unpack_from("<I", buf, 107)[0]
    if vmaj == 1 and vmin <= 3:
        num_points = legacy
    else:
        num_points = struct.unpack_from("<Q", buf, 247)[0] or legacy
    scale = np.array(struct.unpack_from("<3d", buf, 131))
    offset = np.array(struct.unpack_from("<3d", buf, 155))
    # max/min interleaved per axis: maxX@179 minX@187 maxY@195 minY@203 ...
    box_max = np.array([struct.unpack_from("<d", buf, o)[0]
                        for o in (179, 195, 211)])
    box_min = np.array([struct.unpack_from("<d", buf, o)[0]
                        for o in (187, 203, 219)])
    return LasHeader(path=path, version=(vmaj, vmin), header_size=header_size,
                     offset_to_points=offset_to_points, format=fmt,
                     bytes_per_point=bpp, num_points=num_points, scale=scale,
                     offset=offset, box_min=box_min, box_max=box_max)


def decode_points(hdr: LasHeader, raw: np.ndarray, translation: np.ndarray):
    """Decode raw point records -> (xyz f32 [n, 3], rgba u32 [n]) with the
    native decoder. `translation` is added to the scaled coordinates (the
    reference's loadLasNative translation, LasLoader.cpp:208-215)."""
    bpp = hdr.bytes_per_point
    n = len(raw) // bpp
    return native.decode_las(raw, n, bpp, RGB_OFFSET.get(hdr.format, -1),
                             hdr.scale, hdr.offset,
                             np.asarray(translation, np.float64))


def decode_points_reference(hdr: LasHeader, raw: np.ndarray,
                            translation: np.ndarray):
    """Plain numpy version of decode_points (same output, several passes)."""
    bpp = hdr.bytes_per_point
    n = len(raw) // bpp
    rec = raw[:n * bpp].reshape(n, bpp)
    xyz_i = np.frombuffer(np.ascontiguousarray(rec[:, :12]).tobytes(),
                          dtype="<i4").reshape(n, 3)
    xyz = (xyz_i.astype(np.float64) * hdr.scale[None, :] + hdr.offset[None, :]
           + np.asarray(translation, np.float64)[None, :]).astype(np.float32)
    off = RGB_OFFSET.get(hdr.format)
    if off is not None and off + 6 <= bpp:
        rgb16 = np.frombuffer(np.ascontiguousarray(rec[:, off:off + 6]).tobytes(),
                              dtype="<u2").reshape(n, 3).astype(np.uint32)
        # 16-bit colour detection per channel value (LasLoader.cpp:216-222)
        rgb8 = np.where(rgb16 > 255, rgb16 // 256, rgb16)
    else:
        rgb8 = np.full((n, 3), 255, np.uint32)
    rgba = (rgb8[:, 0] | (rgb8[:, 1] << 8) | (rgb8[:, 2] << 16)
            | np.uint32(255) << 24).astype(np.uint32)
    return xyz, rgba


def read_points(path_or_header, first: int = 0, count: int | None = None,
                translation=None):
    """Read + decode a range of points from a LAS file."""
    hdr = path_or_header if isinstance(path_or_header, LasHeader) \
        else load_header(path_or_header)
    if count is None:
        count = hdr.num_points - first
    count = max(0, min(count, hdr.num_points - first))
    if translation is None:
        translation = -hdr.box_min
    with open(hdr.path, "rb") as f:
        f.seek(hdr.offset_to_points + first * hdr.bytes_per_point)
        raw = np.frombuffer(f.read(count * hdr.bytes_per_point), dtype=np.uint8)
    return decode_points(hdr, raw, translation)


def header_bytes(n: int, mn, mx, scale3, offset, offset_to_points: int,
                 fmt_byte: int, bpp: int, num_vlrs: int = 0) -> bytearray:
    """A LAS 1.2 public header block (227 bytes)."""
    buf = bytearray(227)
    buf[0:4] = b"LASF"
    buf[24], buf[25] = 1, 2
    struct.pack_into("<H", buf, 94, 227)
    struct.pack_into("<I", buf, 96, offset_to_points)
    struct.pack_into("<I", buf, 100, num_vlrs)
    buf[104] = fmt_byte
    struct.pack_into("<H", buf, 105, bpp)
    struct.pack_into("<I", buf, 107, n)
    struct.pack_into("<3d", buf, 131, *scale3)
    struct.pack_into("<3d", buf, 155, *offset)
    for axis, o in enumerate((179, 195, 211)):
        struct.pack_into("<d", buf, o, mx[axis])
        struct.pack_into("<d", buf, o + 8, mn[axis])
    return buf


def format2_records(xyz: np.ndarray, rgba: np.ndarray, scale3, offset):
    """Point-format-2 records [n, 26] uint8 (XYZ int32, RGB16 at byte 20)."""
    n = len(xyz)
    rec = np.zeros((n, 26), np.uint8)
    xyz_i = np.round((xyz - offset[None, :]) / scale3[None, :]).astype("<i4")
    rec[:, :12] = xyz_i.view(np.uint8).reshape(n, 12)
    rgb16 = np.stack([(rgba & 0xFF) * 257, ((rgba >> 8) & 0xFF) * 257,
                      ((rgba >> 16) & 0xFF) * 257], -1).astype("<u2")
    rec[:, 20:26] = rgb16.view(np.uint8).reshape(n, 6)
    return rec


def write(path: str, xyz: np.ndarray, rgba: np.ndarray, scale=0.001) -> None:
    """Write a minimal LAS 1.2 format-2 file (for tests and the converter
    tool)."""
    xyz = np.asarray(xyz, np.float64)
    rgba = np.asarray(rgba, np.uint32)
    mn, mx = xyz.min(axis=0), xyz.max(axis=0)
    scale3 = np.full(3, scale, np.float64)
    buf = header_bytes(len(xyz), mn, mx, scale3, mn, 227, 2, 26)
    rec = format2_records(xyz, rgba, scale3, mn)
    with open(path, "wb") as f:
        f.write(buf)
        f.write(rec.tobytes())
