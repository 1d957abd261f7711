"""LAZ: a LAS 1.2 file whose point records are compressed as LASzip v2
(compressor 2: chunks of CHUNK points coded independently, a chunk table
at the end; laszip's default layout). The writer makes the header and the
point-format-2 records exactly as formats/las.py does, writes them as a
raw LAS copy beside the file (the truth: `<path>` + TRUTH), and compresses
the same records with the LASzip encoder of lodbench/laz_encode.py under
the LASzip VLR of the LAZ specification. The reader decodes the truth copy
with the plain LAS decode of formats/las.py, so the reference never runs a
LASzip decoder: a fault of the program's decode shows as points that do
not match."""
from __future__ import annotations

import os
import struct

import numpy as np

from lodbench import found, laz_encode

SUFFIX = ".laz"
TRUTH = ".truth"               # the raw LAS copy of the records
CHUNK = 50_000                 # points a chunk (laszip's default)
USER_ID = b"laszip encoded\x00\x00"
RECORD_ID = 22204
VLR_HEADER = 54


def _las():
    return found.module("formats", "las")


def vlr(chunk_size: int = CHUNK) -> bytes:
    """The LASzip VLR (LAZ specification) for point-format-2 records:
    compressor 2 (chunked), arithmetic coder 0, LASzip 2.2.0, the chunk
    size, no special EVLRs, two items (POINT10 v2, RGB12 v2)."""
    items = b"".join(struct.pack("<HHH", t, s, 2) for t, s in laz_encode.ITEMS)
    payload = struct.pack("<HHBBHIIqqH", 2, 0, 2, 2, 0, 0, chunk_size,
                          -1, -1, len(laz_encode.ITEMS)) + items
    return struct.pack("<H", 0) + USER_ID \
        + struct.pack("<HH", RECORD_ID, len(payload)) + b"\x00" * 32 + payload


def write(path: str, xyz, rgba, chunk_size: int = CHUNK) -> None:
    las = _las()
    truth = path + TRUTH
    las.write(truth, xyz, rgba)
    with open(truth, "rb") as f:
        head = bytearray(f.read(las.HEADER))
    n = struct.unpack_from("<I", head, 107)[0]
    v = vlr(chunk_size)
    offset_to_points = las.HEADER + len(v)
    struct.pack_into("<I", head, 96, offset_to_points)
    struct.pack_into("<I", head, 100, 1)          # one VLR
    head[104] = 2 | 0x80                          # format 2, compressed
    records = np.fromfile(truth, np.uint8, count=n * las.RECORD,
                          offset=las.HEADER).reshape(n, las.RECORD)
    stream = laz_encode.encode(records, chunk_size)
    del records
    # the chunk table's offset: from the stream's start to the file's
    rel = struct.unpack_from("<q", stream[:8].tobytes())[0]
    stream[:8] = np.frombuffer(struct.pack("<q", rel + offset_to_points),
                               np.uint8)
    with open(path, "wb") as f:
        f.write(bytes(head))
        f.write(v)
        f.write(memoryview(stream))
        # on the disk in set-up, so that its write-back stays out of the
        # window (the file stays in the page cache)
        f.flush()
        os.fsync(f.fileno())


def extent(path: str) -> list:
    """The box's extent (max - min an axis), from the header."""
    return _las().extent(path)


def read(path: str, device) -> tuple:
    """The truth copy's records by the plain LAS decode -> (positions
    rebased to the box's min as float32 [n, 3], colours as int32 words
    [n], the octree's cube edge), on `device`."""
    return _las().read(path + TRUTH, device)
