"""LAZ (LASzip-compressed LAS) reader and writer (port of
simlod_tpu/formats/laz.py).

The reference decodes LAZ through the vendored laszip library in its loader
threads (main_progressive_octree.cpp:879-926, ~30 MP/s per README.md:10). Here
the decode runs through the package's own C codec (native/laszip_codec.c:
arithmetic coder + v2 item codecs for point formats 0-3, built from the
published LAZ specification). There is no other decoder: a failed codec build
raises.

A file is decompressed once and its raw records cached, since LAZ is not
seekable per batch and the streaming loaders pull many batches per file. The
decode is single-flight per path: the first caller decodes, concurrent callers
for the same file wait for it and then read the cache. The chunks of one file
decode in parallel over a thread pool.
"""
from __future__ import annotations

import collections
import os
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import native
from . import las

LASZIP_USER_ID = b"laszip encoded\x00\x00"
LASZIP_RECORD_ID = 22204
ITEM_BYTE, ITEM_POINT10, ITEM_GPSTIME11, ITEM_RGB12 = 0, 6, 7, 8
DEFAULT_CHUNK = 50_000

# decoded records per path, least recently used first
_CACHE_FILES = 2
_cache_lock = threading.Lock()
_cache: collections.OrderedDict[str, np.ndarray] = collections.OrderedDict()
_inflight: dict[str, threading.Event] = {}
# whole-file decodes run in this process (each file once while it stays
# cached) and the wall seconds they took
decode_count = 0
decode_seconds = 0.0


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


def _decode_file(path: str, hdr: las.LasHeader) -> np.ndarray:
    """Raw LAS records [n, bpp] of the whole file, decoded once (cached).

    Single-flight: while one thread decodes a path, other threads asking for
    it wait on the path's event and then read the cache (if the decoding
    thread failed, the next waiter decodes)."""
    while True:
        with _cache_lock:
            rec = _cache.get(path)
            if rec is not None:
                _cache.move_to_end(path)
                return rec
            event = _inflight.get(path)
            owner = event is None
            if owner:
                event = _inflight[path] = threading.Event()
        if owner:
            break
        event.wait()
    try:
        t0 = time.perf_counter()
        rec = _decode_uncached(path, hdr)
        global decode_count, decode_seconds
        with _cache_lock:
            while len(_cache) >= _CACHE_FILES:
                _cache.popitem(last=False)
            _cache[path] = rec
            decode_count += 1
            decode_seconds += time.perf_counter() - t0
        return rec
    finally:
        with _cache_lock:
            del _inflight[path]
        event.set()


def _decode_uncached(path: str, hdr: las.LasHeader) -> np.ndarray:
    compressor, chunk_size, types, sizes = _read_laszip_vlr(path, hdr)
    if compressor not in (1, 2):
        raise ValueError(f"{path}: unsupported LASzip compressor {compressor} "
                         "(layered/LAS-1.4 formats 6+ not supported)")
    if sum(sizes) != hdr.bytes_per_point:
        raise ValueError(f"{path}: VLR items sum to {sum(sizes)} B but header "
                         f"says {hdr.bytes_per_point} B/point")
    with open(path, "rb") as f:
        f.seek(hdr.offset_to_points)
        data = np.frombuffer(f.read(), np.uint8)
    if compressor == 2:
        table_abs = int(np.frombuffer(data[:8].tobytes(), "<i8")[0])
        data = data[8:]
        table_off = table_abs - hdr.offset_to_points - 8
        return _decode_chunked(hdr, data, table_off, chunk_size, types, sizes)
    # pointwise: one chunk spanning the file
    return native.laz_decode(data, hdr.num_points, 1 << 62, types, sizes)


def _decode_chunked(hdr, data, table_off, chunk_size, types, sizes,
                    workers: int | None = None) -> np.ndarray:
    """Decode a chunked stream. With a chunk table whose sizes tile the
    stream exactly, contiguous chunk ranges decode in parallel threads (the
    codec releases the GIL); otherwise the stream decodes sequentially."""
    n = hdr.num_points
    nchunks = (n + chunk_size - 1) // chunk_size
    csizes = None
    if 0 < table_off <= len(data):
        csizes = native.laz_chunk_table(data[table_off:], nchunks)
        if csizes is not None and len(csizes) != nchunks:
            csizes = None
        # a corrupt but decodable table would seek workers to wrong offsets
        if csizes is not None and int(np.sum(csizes)) != table_off:
            csizes = None
    workers = workers or min(nchunks, max(2, os.cpu_count() or 1))
    if csizes is None or workers <= 1 or nchunks <= 1:
        return native.laz_decode(data, n, chunk_size, types, sizes)
    starts = np.zeros(nchunks + 1, np.int64)
    np.cumsum(csizes, out=starts[1:])
    out = np.empty((n, int(np.sum(sizes))), np.uint8)
    per = (nchunks + workers - 1) // workers

    def run(w):
        c0 = w * per
        c1 = min(c0 + per, nchunks)
        if c0 >= c1:
            return
        p0 = c0 * chunk_size
        npts = min(c1 * chunk_size, n) - p0
        native.laz_decode_into(data[starts[c0]:starts[c1]], out[p0:p0 + npts],
                               chunk_size, types, sizes)

    with ThreadPoolExecutor(max_workers=workers) as ex:
        list(ex.map(run, range(workers)))
    return out


def read_records(path: str, hdr: las.LasHeader | None = None, first: int = 0,
                 count: int | None = None) -> np.ndarray:
    """Raw records [count, bpp] of a range of points (a view of the cached
    whole-file decode)."""
    hdr = hdr or las.load_header(path)
    if count is None:
        count = hdr.num_points - first
    count = max(0, min(count, hdr.num_points - first))
    return _decode_file(path, hdr)[first:first + count]


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
