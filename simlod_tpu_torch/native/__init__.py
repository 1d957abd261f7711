"""Host C codecs (port of simlod_tpu/native): the point-record decoders
(fastload.c) and the LAZ codec (laszip_codec.c), bound with ctypes.

Each source is compiled at first use, never at import, with
`cc -O3 -shared -fPIC` into simlod_tpu_torch/_build/, keyed by a hash of the
source and flags, through the same compile-and-replace step as the CUDA kernels
(`kernels.compile_to`). There is no fallback: a missing compiler or a failed
build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import threading
from pathlib import Path

import numpy as np

from ..kernels import compile_to

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parent / "_build"
CC_FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def library_path(src_name: str) -> Path:
    h = hashlib.sha256(" ".join(CC_FLAGS).encode())
    h.update((_HERE / src_name).read_bytes())
    return BUILD_DIR / f"{Path(src_name).stem}-{h.hexdigest()[:16]}.so"


def build(src_name: str) -> Path:
    """Compile native/<src_name> into its library (if not built yet); returns
    its path."""
    out = library_path(src_name)
    if out.exists():
        return out
    cc = os.environ.get("CC") or shutil.which("cc")
    if cc is None:
        raise RuntimeError(f"no C compiler (cc) to build {src_name}; the host "
                           "codecs are built from source at first use")
    compile_to(out, [cc, *CC_FLAGS, str(_HERE / src_name)])
    return out


def _load(src_name: str, declare) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(src_name)
        if lib is None:
            lib = ctypes.CDLL(str(build(src_name)))
            declare(lib)
            _libs[src_name] = lib
        return lib


def _declare_fastload(lib):
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    for name, args in (
            ("simlod_decode_las", [p, i64, i32, i32, p, p, p, p, p]),
            ("simlod_decode_simlod", [p, i64, p, p, p]),
            ("simlod_decode_las_cols", [p, i64, i32, i32, p, p, p, p, p, p, p]),
            ("simlod_decode_simlod_cols", [p, i64, p, p, p, p, p])):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = args


def _declare_laz(lib):
    p, lng, i = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    lib.laz_decode.restype = lng
    lib.laz_decode.argtypes = [p, lng, p, lng, lng, p, p, i, lng]
    lib.laz_encode.restype = lng
    lib.laz_encode.argtypes = [p, lng, lng, p, p, i, lng, p, lng]
    lib.laz_decode_chunk_table.restype = lng
    lib.laz_decode_chunk_table.argtypes = [p, lng, p, lng]


def load() -> ctypes.CDLL:
    """The point-record decoder library (fastload.c), built if needed."""
    return _load("fastload.c", _declare_fastload)


def load_laz() -> ctypes.CDLL:
    """The LAZ codec library (laszip_codec.c), built if needed."""
    return _load("laszip_codec.c", _declare_laz)


def _loads(load_lib) -> bool:
    """True iff the library builds and loads (no compiler or a failed build
    raises RuntimeError, a library that will not load OSError)."""
    try:
        load_lib()
    except (RuntimeError, OSError):
        return False
    return True


def available() -> bool:
    """The point-record decoders build and load. Nothing in the port switches
    on this: a decode without them raises."""
    return _loads(load)


def cols_available() -> bool:
    """The column decoders load: the library of available() declares them."""
    return available()


def laz_available() -> bool:
    """The LAZ codec builds and loads."""
    return _loads(load_laz)


def _f64(a) -> np.ndarray:
    a = np.ascontiguousarray(a, np.float64)
    if a.size != 3:
        raise ValueError(f"expected 3 values per transform, got {a.size}")
    return a


def _records(raw, n: int, rec_bytes: int) -> np.ndarray:
    """raw as contiguous bytes holding at least n records."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if n < 0 or raw.size < n * rec_bytes:
        raise ValueError(f"{raw.size} bytes hold fewer than {n} records of "
                         f"{rec_bytes} bytes")
    return raw


def decode_las(raw: np.ndarray, n: int, bpp: int, rgb_off: int,
               scale: np.ndarray, offset: np.ndarray, trans: np.ndarray):
    """LAS records -> (xyz f32 [n, 3], rgba u32 [n])."""
    lib = load()
    raw = _records(raw, n, bpp)
    xyz = np.empty((n, 3), np.float32)
    rgba = np.empty((n,), np.uint32)
    lib.simlod_decode_las(raw.ctypes.data, n, bpp, rgb_off,
                          _f64(scale).ctypes.data, _f64(offset).ctypes.data,
                          _f64(trans).ctypes.data, xyz.ctypes.data,
                          rgba.ctypes.data)
    return xyz, rgba


def decode_simlod(raw: np.ndarray, n: int, shift: np.ndarray):
    """.simlod records + a float3 shift -> (xyz f32 [n, 3], rgba u32 [n])."""
    lib = load()
    raw = _records(raw, n, 16)
    xyz = np.empty((n, 3), np.float32)
    rgba = np.empty((n,), np.uint32)
    lib.simlod_decode_simlod(raw.ctypes.data, n,
                             np.ascontiguousarray(shift, np.float32).ctypes.data,
                             xyz.ctypes.data, rgba.ctypes.data)
    return xyz, rgba


def _col_views(ox, oy, oz, orgba, n):
    for a in (ox, oy, oz, orgba):
        if not (a.flags.c_contiguous and a.dtype.kind in "fiu"
                and a.itemsize == 4 and a.size >= n):
            raise ValueError("output columns must be contiguous 4-byte arrays "
                             f"of at least {n} rows")
    if ox.dtype != np.float32 or oy.dtype != np.float32 \
            or oz.dtype != np.float32:
        raise ValueError("x/y/z output columns must be float32")
    return ox.ctypes.data, oy.ctypes.data, oz.ctypes.data, orgba.ctypes.data


def decode_simlod_cols(raw: np.ndarray, n: int, shift: np.ndarray,
                       ox, oy, oz, orgba) -> None:
    """decode_simlod writing x/y/z/rgba into caller-provided column arrays
    (rgba may be uint32 or its int32 view)."""
    lib = load()
    raw = _records(raw, n, 16)
    px, py, pz, pc = _col_views(ox, oy, oz, orgba, n)
    lib.simlod_decode_simlod_cols(
        raw.ctypes.data, n, np.ascontiguousarray(shift, np.float32).ctypes.data,
        px, py, pz, pc)


def decode_las_cols(raw: np.ndarray, n: int, bpp: int, rgb_off: int,
                    scale, offset, trans, ox, oy, oz, orgba) -> None:
    """decode_las writing into caller-provided column arrays (see
    decode_simlod_cols)."""
    lib = load()
    raw = _records(raw, n, bpp)
    px, py, pz, pc = _col_views(ox, oy, oz, orgba, n)
    lib.simlod_decode_las_cols(raw.ctypes.data, n, bpp, rgb_off,
                               _f64(scale).ctypes.data,
                               _f64(offset).ctypes.data,
                               _f64(trans).ctypes.data, px, py, pz, pc)


# --- LAZ codec (laszip_codec.c) ---

def _items(item_types, item_sizes):
    return (np.ascontiguousarray(item_types, np.uint16),
            np.ascontiguousarray(item_sizes, np.uint16))


def laz_decode(stream: np.ndarray, npoints: int, chunk_size: int,
               item_types, item_sizes) -> np.ndarray:
    """Decode a chunked LASzip point stream (after the 8-byte chunk-table
    offset) into raw LAS point records [npoints, rec_size] uint8."""
    it, isz = _items(item_types, item_sizes)
    out = np.empty((npoints, int(isz.sum())), np.uint8)
    laz_decode_into(stream, out, chunk_size, it, isz)
    return out


def laz_decode_into(stream: np.ndarray, out: np.ndarray, chunk_size: int,
                    item_types, item_sizes) -> None:
    """laz_decode writing into a caller-provided C-contiguous
    [npoints, rec_size] uint8 array (a row slice of a larger one is)."""
    lib = load_laz()
    stream = np.ascontiguousarray(stream, np.uint8)
    it, isz = _items(item_types, item_sizes)
    if not (out.flags.c_contiguous and out.dtype == np.uint8 and out.ndim == 2
            and out.shape[1] == int(isz.sum())):
        raise ValueError("out must be a contiguous uint8 [npoints, record "
                         "size] array")
    r = lib.laz_decode(stream.ctypes.data, stream.size, out.ctypes.data,
                       out.shape[0], chunk_size, it.ctypes.data,
                       isz.ctypes.data, len(it), int(isz.sum()))
    if r != 0:
        raise ValueError(f"laz decode failed ({r}): corrupt or unsupported stream")


def laz_chunk_table(table: np.ndarray, max_chunks: int) -> np.ndarray | None:
    """Decode a LASzip chunk table -> per-chunk byte sizes (u32 [n]), or None
    if the table is malformed. Chunks are coded independently, so the sizes
    make the stream seekable (the parallel decode in formats/laz.py)."""
    lib = load_laz()
    table = np.ascontiguousarray(table, np.uint8)
    sizes = np.empty(max_chunks, np.uint32)
    n = lib.laz_decode_chunk_table(table.ctypes.data, table.size,
                                   sizes.ctypes.data, max_chunks)
    return sizes[:n].copy() if n >= 0 else None


def laz_encode(records: np.ndarray, chunk_size: int, item_types,
               item_sizes) -> np.ndarray:
    """Encode raw LAS point records [n, rec_size] into a chunked LASzip stream
    (starting with the 8-byte chunk-table offset, ending with the chunk
    table)."""
    lib = load_laz()
    records = np.ascontiguousarray(records, np.uint8)
    it, isz = _items(item_types, item_sizes)
    n, rec_size = records.shape
    cap = records.size * 2 + 65536
    out = np.empty(cap, np.uint8)
    r = lib.laz_encode(records.ctypes.data, n, chunk_size, it.ctypes.data,
                       isz.ctypes.data, len(it), rec_size, out.ctypes.data, cap)
    if r <= 0:
        raise ValueError(f"laz encode failed ({r})")
    return out[:r].copy()
