"""LAZ (LASzip-compressed LAS) reader and writer (port of
simlod_tpu/formats/laz.py).

The reference decodes LAZ through the vendored laszip library in its loader
threads, batch by batch (main_progressive_octree.cpp:879-926, ~30 MP/s per
README.md:10). Here the decode runs through the package's own C codec
(native/laszip_codec.c: arithmetic coder + v2 item codecs for point formats
0-3, built from the published LAZ specification). There is no other decoder:
a failed codec build raises.

`index` reads a file's LASzip VLR and chunk table once; `decode_range` then
reads the compressed bytes of the chunks that cover a range of points and
decodes them (chunks are coded independently). Nothing is cached: each call
decodes. A file whose chunk table is missing or does not tile the stream
(compressor 1, or a corrupt table) has no random access, and a range of it
decodes the whole stream.
"""
from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np

from .. import native
from ..utils import trace
from . import las

LASZIP_USER_ID = b"laszip encoded\x00\x00"
LASZIP_RECORD_ID = 22204
ITEM_BYTE, ITEM_POINT10, ITEM_GPSTIME11, ITEM_RGB12 = 0, 6, 7, 8
DEFAULT_CHUNK = 50_000
WHOLE_STREAM = 1 << 62      # the chunk size of a pointwise (compressor 1) file


@dataclasses.dataclass(frozen=True)
class LazIndex:
    """What a range decode of one file needs: its header, the LASzip VLR's
    items and chunk size, and where the compressed chunks lie."""
    path: str
    header: las.LasHeader
    chunk_size: int            # points a chunk (WHOLE_STREAM: one chunk)
    item_types: tuple
    item_sizes: tuple
    nchunks: int
    # absolute file offsets of chunks 0..nchunks (nchunks + 1 entries), or
    # None where the chunk table cannot be used: the stream then starts at
    # `stream_start` and decodes whole
    offsets: np.ndarray | None
    stream_start: int

    @property
    def seekable(self) -> bool:
        return self.offsets is not None

    @property
    def record_size(self) -> int:
        return sum(self.item_sizes)


def available() -> bool:
    """The LAZ decoder builds and loads: native.laz_available() (the port has
    no other decoder)."""
    return native.laz_available()


def load_header(path: str) -> las.LasHeader:
    # the LAZ header is a LAS header (compression flagged in the format bits)
    return las.load_header(path)


def _read_laszip_vlr(path: str, hdr: las.LasHeader):
    """Parse the LASzip VLR -> (compressor, chunk_size, item_types,
    item_sizes)."""
    with open(path, "rb") as f:
        buf = f.read(hdr.offset_to_points)
    pos = hdr.header_size
    while pos + 54 <= len(buf):
        user_id = buf[pos + 2:pos + 18]
        record_id = struct.unpack_from("<H", buf, pos + 18)[0]
        length = struct.unpack_from("<H", buf, pos + 20)[0]
        payload = buf[pos + 54:pos + 54 + length]
        if user_id == LASZIP_USER_ID and record_id == LASZIP_RECORD_ID:
            compressor, _coder = struct.unpack_from("<HH", payload, 0)
            chunk_size = struct.unpack_from("<I", payload, 12)[0]
            num_items = struct.unpack_from("<H", payload, 32)[0]
            types, sizes = [], []
            for i in range(num_items):
                t, s, _v = struct.unpack_from("<HHH", payload, 34 + 6 * i)
                types.append(t)
                sizes.append(s)
            return compressor, chunk_size, types, sizes
        pos += 54 + length
    raise ValueError(f"{path}: no LASzip VLR found (not a LAZ file?)")


def _items_for_format(fmt: int, bpp: int):
    types = [ITEM_POINT10]
    sizes = [20]
    if fmt in (1, 3):
        types.append(ITEM_GPSTIME11)
        sizes.append(8)
    if fmt in (2, 3):
        types.append(ITEM_RGB12)
        sizes.append(6)
    used = sum(sizes)
    if bpp > used:
        types.append(ITEM_BYTE)
        sizes.append(bpp - used)
    return types, sizes


def index(path: str, hdr: las.LasHeader | None = None) -> LazIndex:
    """Read a file's LASzip VLR and chunk table (no point is decoded)."""
    hdr = hdr or las.load_header(path)
    compressor, chunk_size, types, sizes = _read_laszip_vlr(path, hdr)
    if compressor not in (1, 2):
        raise ValueError(f"{path}: unsupported LASzip compressor {compressor} "
                         "(layered/LAS-1.4 formats 6+ not supported)")
    if sum(sizes) != hdr.bytes_per_point:
        raise ValueError(f"{path}: VLR items sum to {sum(sizes)} B but header "
                         f"says {hdr.bytes_per_point} B/point")
    n, start = hdr.num_points, hdr.offset_to_points
    if compressor == 1:         # pointwise: one chunk spanning the file
        return LazIndex(path, hdr, WHOLE_STREAM, tuple(types), tuple(sizes),
                        1, None, start)
    if chunk_size <= 0:
        raise ValueError(f"{path}: LASzip chunk size {chunk_size}")
    nchunks = -(-n // chunk_size)
    table_abs = int(np.fromfile(path, "<i8", count=1, offset=start)[0])
    start += 8                  # the stream follows the table's offset
    offsets = None
    size = os.path.getsize(path)
    if start < table_abs <= size:
        csizes = native.laz_chunk_table(
            np.fromfile(path, np.uint8, offset=table_abs), nchunks)
        # a corrupt but decodable table would seek to wrong offsets
        if csizes is not None and len(csizes) == nchunks \
                and int(np.sum(csizes, dtype=np.int64)) == table_abs - start:
            offsets = np.zeros(nchunks + 1, np.int64)
            np.cumsum(csizes, out=offsets[1:])
            offsets += start
    return LazIndex(path, hdr, chunk_size, tuple(types), tuple(sizes),
                    nchunks, offsets, start)


def decode_range(entry: LazIndex, first: int, count: int,
                 out: np.ndarray) -> int:
    """Decode the raw records of points [first, first + count) into `out`, a
    C-contiguous uint8 [count, record size] array: the compressed bytes of
    the chunks that cover them are read from the file and decoded (the whole
    stream where the file has no usable chunk table). Returns the number of
    chunks decoded. A `laz.decode` span."""
    if count <= 0:
        return 0
    if first < 0 or first + count > entry.header.num_points:
        raise ValueError(f"{entry.path}: points [{first}, {first + count}) "
                         f"outside the file's {entry.header.num_points}")
    with trace.span("laz.decode"):
        cs = entry.chunk_size
        if entry.seekable:
            c0, c1 = first // cs, -(-(first + count) // cs)
            begin = int(entry.offsets[c0])
            nbytes = int(entry.offsets[c1]) - begin
        else:
            c0, c1 = 0, entry.nchunks
            begin, nbytes = entry.stream_start, -1
        p0 = c0 * cs
        npts = min(c1 * cs, entry.header.num_points) - p0
        data = np.fromfile(entry.path, np.uint8, count=nbytes, offset=begin)
        whole = p0 == first and npts == count
        dst = out if whole else np.empty((npts, entry.record_size), np.uint8)
        native.laz_decode_into(data, dst, cs, entry.item_types,
                               entry.item_sizes)
        if not whole:
            out[:] = dst[first - p0:first - p0 + count]
    return c1 - c0


def read_records(path: str, hdr: las.LasHeader | None = None, first: int = 0,
                 count: int | None = None) -> np.ndarray:
    """Raw records [count, bpp] of a range of points (a range decode)."""
    entry = index(path, hdr)
    n = entry.header.num_points
    if count is None:
        count = n - first
    count = max(0, min(count, n - first))
    out = np.empty((count, entry.record_size), np.uint8)
    decode_range(entry, first, count, out)
    return out


def read_points(path: str, first: int = 0, count: int | None = None,
                translation=None):
    """Read + decode a range of points -> (xyz f32 [n, 3], rgba u32 [n])."""
    hdr = las.load_header(path)
    if translation is None:
        translation = -hdr.box_min
    rec = read_records(path, hdr, first, count)
    return las.decode_points(hdr, rec.reshape(-1), translation)


def write(path: str, xyz: np.ndarray, rgba: np.ndarray, scale=0.001,
          chunk_size: int = DEFAULT_CHUNK) -> None:
    """Write a LAZ file (LAS 1.2 point format 2 + LASzip v2 chunked stream)."""
    xyz = np.asarray(xyz, np.float64)
    rgba = np.asarray(rgba, np.uint32)
    mn, mx = xyz.min(axis=0), xyz.max(axis=0)
    scale3 = np.full(3, scale, np.float64)
    bpp = 26
    types, sizes = _items_for_format(2, bpp)

    # LASzip VLR payload
    items = b"".join(struct.pack("<HHH", t, s, 2) for t, s in zip(types, sizes))
    payload = struct.pack("<HHBBHIIqqH", 2, 0, 2, 2, 0, 0, chunk_size,
                          0, -1, len(types)) + items
    vlr = struct.pack("<H", 0) + LASZIP_USER_ID + \
        struct.pack("<HH", LASZIP_RECORD_ID, len(payload)) + b"\x00" * 32 + payload
    offset_to_points = 227 + len(vlr)
    buf = las.header_bytes(len(xyz), mn, mx, scale3, mn, offset_to_points,
                           2 | 0x80, bpp, num_vlrs=1)
    rec = las.format2_records(xyz, rgba, scale3, mn)
    stream = native.laz_encode(rec, chunk_size, types, sizes)
    # the codec stores the chunk-table offset relative to the stream start;
    # readers expect an absolute file offset
    rel = int(np.frombuffer(stream[:8].tobytes(), "<i8")[0])
    stream[0:8] = np.frombuffer(struct.pack("<q", rel + offset_to_points),
                                np.uint8)
    with open(path, "wb") as f:
        f.write(buf)
        f.write(vlr)
        f.write(stream.tobytes())
