"""The port's LAS/LAZ input (simlod_tpu_torch.formats.las/laz, native/, the
streaming loaders, tools/las2simlod) against simlod_tpu on the CPU, on files
made from seeded numpy clouds.

Tolerances: headers, decoded points and colours, raw LAZ records, converter
output and streamed columns are bit-equal to the JAX package's; the native
decoders are bit-equal to their numpy plain versions. Every stream of a LAZ
file decodes each of its chunks exactly once, on its loader threads, and
nothing is cached between streams.
"""
import dataclasses
import os
import struct
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from simlod_tpu.formats import las as jlas, laz as jlaz
from simlod_tpu.io.streaming import PointStream as JStream
from simlod_tpu.io.streaming import scan_paths as jscan
from simlod_tpu.tools import las2simlod as jconv
from simlod_tpu_torch import native
from simlod_tpu_torch.formats import las, laz, simlod
from simlod_tpu_torch.io.streaming import PointStream, scan_paths
from simlod_tpu_torch.tools import las2simlod

# six test processes share the machine in the tier-1 run; these small tensors
# gain nothing from intra-op threads, which would oversubscribe the cores
torch.set_num_threads(1)


def cloud(seed, n, walk=False):
    rng = np.random.default_rng(seed)
    if walk:   # lidar-like locality: what the LAZ predictors are built for
        xyz = np.cumsum(rng.normal(0, 0.2, (n, 3)), axis=0)
    else:
        xyz = rng.random((n, 3)) * [100.0, 50.0, 20.0] + [500.0, -200.0, 30.0]
    rgba = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    return xyz.astype(np.float64), rgba


def same_points(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_las_header_points_and_bytes_match_jax(tmp_path):
    xyz, rgba = cloud(1, 5000)
    p, pj = str(tmp_path / "a.las"), str(tmp_path / "j.las")
    las.write(p, xyz, rgba)
    jlas.write(pj, xyz, rgba)
    assert open(p, "rb").read() == open(pj, "rb").read()
    h, hj = las.load_header(p), jlas.load_header(p)
    for f in ("version", "header_size", "offset_to_points", "format",
              "bytes_per_point", "num_points"):
        assert getattr(h, f) == getattr(hj, f), f
    for f in ("scale", "offset", "box_min", "box_max"):
        np.testing.assert_array_equal(getattr(h, f), getattr(hj, f))
    same_points(las.read_points(p), jlas.read_points(p))
    same_points(las.read_points(p, first=100, count=50, translation=[1, 2, 3]),
                jlas.read_points(p, first=100, count=50,
                                 translation=np.array([1.0, 2.0, 3.0])))


def test_native_las_decode_matches_numpy_plain_version(tmp_path):
    xyz, rgba = cloud(2, 5000)
    p = str(tmp_path / "n.las")
    las.write(p, xyz, rgba & 0x00FFFFFF)
    hdr = las.load_header(p)
    with open(p, "rb") as f:
        f.seek(hdr.offset_to_points)
        raw = np.frombuffer(f.read(), np.uint8)
    same_points(las.decode_points(hdr, raw, -hdr.box_min),
                las.decode_points_reference(hdr, raw, -hdr.box_min))
    # the column variant writes the same values into int32 columns
    cols = [np.empty(hdr.num_points, np.float32) for _ in range(3)] \
        + [np.empty(hdr.num_points, np.int32)]
    native.decode_las_cols(raw, hdr.num_points, hdr.bytes_per_point,
                           las.RGB_OFFSET[hdr.format], hdr.scale, hdr.offset,
                           -hdr.box_min, *cols)
    ref = las.decode_points_reference(hdr, raw, -hdr.box_min)
    np.testing.assert_array_equal(np.stack(cols[:3], -1), ref[0])
    np.testing.assert_array_equal(cols[3].view(np.uint32), ref[1])


def test_native_simlod_decode():
    rng = np.random.default_rng(3)
    n = 1000
    rec = np.zeros(n, dtype=np.dtype([("xyz", np.float32, 3),
                                      ("rgba", np.uint32)]))
    rec["xyz"] = rng.random((n, 3), dtype=np.float32)
    rec["rgba"] = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    raw = np.frombuffer(rec.tobytes(), np.uint8)
    shift = np.array([1.0, 2.0, 3.0], np.float32)
    xyz, c = native.decode_simlod(raw, n, shift)
    np.testing.assert_array_equal(xyz, rec["xyz"] + shift[None, :])
    np.testing.assert_array_equal(c, rec["rgba"])


def test_laz_matches_jax_and_las(tmp_path):
    xyz, rgba = cloud(9, 130_000, walk=True)         # several 50k chunks
    rgba |= np.uint32(0xFF000000)
    p, pj, pl = (str(tmp_path / n) for n in ("c.laz", "j.laz", "c.las"))
    laz.write(p, xyz, rgba)
    jlaz.write(pj, xyz, rgba)
    las.write(pl, xyz, rgba)
    assert open(p, "rb").read() == open(pj, "rb").read()
    assert os.path.getsize(p) < 0.7 * os.path.getsize(pl)
    assert laz.load_header(p).num_points == 130_000
    full = laz.read_points(p)
    same_points(full, jlaz.read_points(p))
    same_points(full, las.read_points(pl))
    same_points(laz.read_points(p, first=60_000, count=1000),
                jlaz.read_points(p, first=60_000, count=1000))


def _write_format3_laz(path, rec):
    """A LAZ file of point format 3 (XYZ..., gpstime, RGB) holding `rec`."""
    n = len(rec)
    types, sizes = laz._items_for_format(3, 34)
    items = b"".join(struct.pack("<HHH", t, s, 2) for t, s in zip(types, sizes))
    payload = struct.pack("<HHBBHIIqqH", 2, 0, 2, 2, 0, 0, 5000, 0, -1,
                          len(types)) + items
    vlr = struct.pack("<H", 0) + laz.LASZIP_USER_ID + struct.pack(
        "<HH", laz.LASZIP_RECORD_ID, len(payload)) + b"\0" * 32 + payload
    otp = 227 + len(vlr)
    stream = native.laz_encode(rec, 5000, types, sizes)
    rel = int(np.frombuffer(stream[:8].tobytes(), "<i8")[0])
    stream[:8] = np.frombuffer(struct.pack("<q", rel + otp), np.uint8)
    hdr = las.header_bytes(n, [0, 0, 0], [10, 10, 10], [0.01] * 3, [0, 0, 0],
                           otp, 3 | 0x80, 34, num_vlrs=1)
    with open(path, "wb") as f:
        f.write(hdr + vlr + stream.tobytes())


def test_laz_gpstime_format3_records_match_jax(tmp_path):
    """Point-format-3 records (gpstime + RGB) survive the codec byte for
    byte, and both packages decode the file to the same points."""
    rng = np.random.default_rng(4)
    n = 20_000
    rec = np.zeros((n, 34), np.uint8)
    xyz_i = np.cumsum(rng.integers(-40, 50, (n, 3)), axis=0).astype("<i4")
    rec[:, :12] = xyz_i.view(np.uint8).reshape(n, 12)
    rec[:, 14] = 0b001001
    t = (1e9 + np.cumsum(np.abs(rng.normal(5e-4, 2e-4, n)))).astype("<f8")
    rec[:, 20:28] = t.view(np.uint8).reshape(n, 8)
    rgb = np.cumsum(rng.integers(-300, 300, (n, 3)), axis=0) % 65536
    rec[:, 28:34] = rgb.astype("<u2").view(np.uint8).reshape(n, 6)
    types, sizes = laz._items_for_format(3, 34)
    back = native.laz_decode(native.laz_encode(rec, 5000, types, sizes)[8:],
                             n, 5000, types, sizes)
    np.testing.assert_array_equal(back, rec)
    p = str(tmp_path / "f3.laz")
    _write_format3_laz(p, rec)
    np.testing.assert_array_equal(laz.read_records(p), rec)
    same_points(laz.read_points(p), jlaz.read_points(p))


def _laz_stream(path):
    """A LAZ file's point stream after the chunk-table offset, its table's
    offset within that stream, and the VLR's items."""
    hdr = laz.load_header(path)
    _comp, chunk, types, sizes = laz._read_laszip_vlr(path, hdr)
    with open(path, "rb") as f:
        f.seek(hdr.offset_to_points)
        data = np.frombuffer(f.read(), np.uint8)
    table_off = int(np.frombuffer(data[:8].tobytes(), "<i8")[0]) \
        - hdr.offset_to_points - 8
    return hdr, data[8:], table_off, chunk, types, sizes


def test_laz_chunk_table_parallel_decode(tmp_path):
    """The chunk table tiles the stream, the index's offsets are the chunks'
    places in the file, range decodes of the chunks run in parallel threads
    tile the file bit-identically to the sequential decode and to the JAX
    package's parallel one, and a corrupt but decodable table leaves the
    file without random access, decoding it whole and right."""
    xyz, rgba = cloud(12, 205_000, walk=True)          # 5 chunks, last partial
    p = str(tmp_path / "c.laz")
    laz.write(p, xyz, rgba)
    hdr, data, table_off, chunk, types, sizes = _laz_stream(p)
    csizes = native.laz_chunk_table(data[table_off:], 5)
    assert csizes is not None and len(csizes) == 5
    assert int(csizes.sum()) == table_off
    idx = laz.index(p)
    assert idx.seekable and idx.nchunks == 5 and idx.chunk_size == chunk
    np.testing.assert_array_equal(np.diff(idx.offsets), csizes)
    assert idx.offsets[0] == hdr.offset_to_points + 8
    seq = native.laz_decode(data, hdr.num_points, chunk, types, sizes)
    par = np.empty_like(seq)
    ranges = [(c * chunk, min(chunk, hdr.num_points - c * chunk))
              for c in range(5)]
    threads = [threading.Thread(target=laz.decode_range,
                                args=(idx, f, n, par[f:f + n]))
               for f, n in ranges]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    np.testing.assert_array_equal(seq, par)
    jpar = jlaz._decode_chunked(jlaz.load_header(p), data, table_off, chunk,
                                types, sizes, 3)
    np.testing.assert_array_equal(par, jpar)
    raw = bytearray(Path(p).read_bytes())
    at = hdr.offset_to_points + 8 + table_off
    raw[at:at + 16] = bytes(x ^ 0xA5 for x in raw[at:at + 16])
    bad = str(tmp_path / "bad.laz")
    Path(bad).write_bytes(bytes(raw))
    bidx = laz.index(bad)
    assert not bidx.seekable and bidx.nchunks == 5
    out = np.empty_like(seq)
    assert laz.decode_range(bidx, 0, hdr.num_points, out) == 5
    np.testing.assert_array_equal(out, seq)
    np.testing.assert_array_equal(laz.read_records(bad, first=120_000,
                                                   count=7), seq[120_000:120_007])


@pytest.mark.parametrize("chunk,first,count", [
    (7000, 0, 123_457), (7000, 6999, 2), (7000, 7000, 7000),
    (7000, 13_999, 30_001), (7000, 123_456, 1), (7000, 119_000, 4457),
    (50_000, 49_999, 50_002), (50_000, 100_000, 23_457), (50_000, 3, 5)])
def test_laz_decode_range_matches_whole_and_jax(tmp_path, chunk, first, count):
    """Ranges that straddle chunk edges, with chunk sizes that do not divide
    the range and a short last chunk (123,457 points): the range decode is
    the whole-file decode's rows, its points the JAX package's, and it
    decodes just the chunks that cover the range."""
    xyz, rgba = cloud(13, 123_457, walk=True)
    p = str(tmp_path / "r.laz")
    laz.write(p, xyz, rgba, chunk_size=chunk)
    hdr, data, _off, _c, types, sizes = _laz_stream(p)
    whole = native.laz_decode(data, hdr.num_points, chunk, types, sizes)
    idx = laz.index(p)
    out = np.empty((count, idx.record_size), np.uint8)
    chunks = laz.decode_range(idx, first, count, out)
    assert chunks == -(-(first + count) // chunk) - first // chunk
    np.testing.assert_array_equal(out, whole[first:first + count])
    same_points(laz.read_points(p, first=first, count=count),
                jlaz.read_points(p, first=first, count=count))
    with pytest.raises(ValueError):
        laz.decode_range(idx, hdr.num_points - 1, 2, np.empty((2, 26),
                                                             np.uint8))


def _write_pointwise_laz(path, xyz, rgba):
    """The records of laz.write's file as a LASzip compressor-1 (pointwise)
    file: one chunk spanning the stream, no chunk table."""
    tmp = path + ".chunked"
    laz.write(tmp, xyz, rgba, chunk_size=len(xyz))
    raw = bytearray(Path(tmp).read_bytes())
    os.remove(tmp)
    otp = struct.unpack_from("<I", raw, 96)[0]
    vlr_payload = 227 + 54          # the VLR's payload: compressor first
    struct.pack_into("<H", raw, vlr_payload, 1)
    table = struct.unpack_from("<q", raw, otp)[0]
    Path(path).write_bytes(bytes(raw[:otp] + raw[otp + 8:table]))


def test_laz_compressor1_file_decodes(tmp_path):
    """A pointwise file has no random access: any range decodes the whole
    stream (one chunk) and gives the records laz.write's file holds, as the
    JAX package reads them."""
    xyz, rgba = cloud(14, 30_000, walk=True)
    p, pl = str(tmp_path / "pw.laz"), str(tmp_path / "pw.las")
    _write_pointwise_laz(p, xyz, rgba)
    las.write(pl, xyz, rgba)
    idx = laz.index(p)
    assert not idx.seekable and idx.nchunks == 1
    same_points(laz.read_points(p), las.read_points(pl))
    same_points(laz.read_points(p, first=11_111, count=999),
                jlaz.read_points(p, first=11_111, count=999))
    s = PointStream([p], step_points=1 << 12, device="cpu",
                    batch_points=7000, num_loaders=3)
    cols = _stream_columns(list(s), True)
    s.stop()
    assert s.laz_chunks == 1
    np.testing.assert_array_equal(cols[3].view(np.uint32),
                                  las.read_points(pl)[1])


@pytest.mark.parametrize("ext", ["las", "laz"])
def test_las2simlod_matches_jax(tmp_path, ext):
    xyz, rgba = cloud(5, 3000, walk=True)
    src = str(tmp_path / f"a.{ext}")
    (laz if ext == "laz" else las).write(src, xyz, rgba & 0x00FFFFFF)
    dst, dst_j = str(tmp_path / "t.simlod"), str(tmp_path / "j.simlod")
    assert las2simlod.convert(src, dst, batch=1000, verbose=False) == 3000
    assert jconv.convert(src, dst_j, batch=1000, verbose=False) == 3000
    assert open(dst, "rb").read() == open(dst_j, "rb").read()
    assert simlod.load_info(dst).num_points == 3000


def _tile_dir(tmp_path):
    """.simlod, .las and .laz files with different boxes in one directory."""
    xyz, rgba = cloud(6, 30_000, walk=True)
    simlod.write(str(tmp_path / "a.simlod"), xyz, rgba)
    las.write(str(tmp_path / "b.las"), xyz + 40.0, rgba)
    laz.write(str(tmp_path / "c.laz"), xyz - 25.0, rgba)
    (tmp_path / "notes.txt").write_text("not a point cloud")
    return str(tmp_path)


def test_scan_paths_las_laz_match_jax(tmp_path):
    d = _tile_dir(tmp_path)
    t, j = scan_paths([d]), jscan([d])
    assert [e.kind for e in t] == ["simlod", "las", "laz"]
    assert [(e.path, e.kind, e.num_points) for e in t] == \
        [(e.path, e.kind, e.num_points) for e in j]
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.box_min, b.box_min)
        np.testing.assert_array_equal(a.box_max, b.box_max)


def _stream_points(cols):
    """Streamed columns as (xyz, rgba) points."""
    return np.stack(cols[:3], -1), cols[3].view(np.uint32)


def _stream_columns(items, chunked):
    cols = [[], [], [], []]
    for it in items:
        if chunked:        # the port: [K, B] planes + counts
            for k, n in enumerate(it[4]):
                for c in range(4):
                    cols[c].append(np.asarray(it[c][k][:n]))
        else:              # the JAX package, one step per item
            for c in range(4):
                cols[c].append(np.asarray(it[c])[:it[4]])
    return [np.concatenate(c) for c in cols]


@pytest.mark.parametrize("box_override", [False, True])
def test_stream_over_las_laz_matches_jax(tmp_path, box_override):
    """A directory of .simlod, .las and .laz files streams the same columns
    in both packages, rebased into the union box or into an override box."""
    d = _tile_dir(tmp_path)
    box = (np.array([-100.0, -90.0, -80.0]), np.array([900.0, 700.0, 500.0])) \
        if box_override else None
    t = PointStream([d], step_points=1 << 12, device="cpu", batch_points=7000,
                    num_loaders=3, box_override=box)
    tc = _stream_columns(list(t), True)
    t.stop()
    # one loader: the JAX stream keeps file order only then
    j = JStream([d], step_points=1 << 12, batch_points=7000, num_loaders=1,
                box_override=box)
    jc = _stream_columns(list(j), False)
    j.stop()
    np.testing.assert_array_equal(t.box_min, j.box_min)
    np.testing.assert_array_equal(t.box_max, j.box_max)
    assert len(tc[0]) == 90_000
    for a, b in zip(tc[:3], jc[:3]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tc[3].view(np.uint32), jc[3])
    if box_override:
        np.testing.assert_array_equal(t.box_min, box[0])


@pytest.mark.parametrize("batch_points,per", [
    (12_000, 2500), (1_200, 1000), (100, 500)])
def test_laz_stream_decodes_each_file_once(tmp_path, monkeypatch,
                                           batch_points, per):
    """Every open of a LAZ file decodes each of its chunks exactly once, on
    the stream's loader threads, in batches of whole chunks
    (LAZ_BATCH_CHUNKS, fewer where `batch_points` holds fewer, one at
    least): two streams of the same path decode twice (nothing is cached),
    each with laz_chunks == the file's chunks, one `laz.decode` span a
    batch and one `stream.first_item`."""
    from simlod_tpu_torch.io import streaming
    from simlod_tpu_torch.utils import trace
    assert streaming.LAZ_BATCH_CHUNKS == 5
    xyz, rgba = cloud(7, 60_000, walk=True)
    p = str(tmp_path / "d.laz")
    laz.write(p, xyz, rgba, chunk_size=500)              # 120 chunks
    # one core: 2 decode threads
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    calls = []
    real = laz.decode_range

    def spy(entry, first, count, out):
        calls.append((threading.get_ident(), first, count))
        return real(entry, first, count, out)
    monkeypatch.setattr(laz, "decode_range", spy)
    want = laz.read_points(p)[1]
    for _ in range(2):
        calls.clear()
        snap = trace.snapshot()
        s = PointStream([p], step_points=1 << 13, device="cpu",
                        batch_points=batch_points)
        cols = _stream_columns(list(s), True)
        s.stop()
        d = trace.since(snap)
        assert len(s._loaders) == 2
        assert s.laz_chunks == 120 and s.stats()["laz_chunks"] == 120
        covered = sorted(c for _, f, n in calls
                         for c in range(f // 500, -(-(f + n) // 500)))
        assert covered == list(range(120))
        assert all(f % per == 0 and n == per for _, f, n in calls)
        assert d["laz.decode"]["count"] == len(calls) == 60_000 // per
        assert d["stream.first_item"]["count"] == 1
        assert len(cols[0]) == 60_000
        np.testing.assert_array_equal(cols[3].view(np.uint32), want)


def test_laz_single_flight_retries_after_a_failed_decode(tmp_path, monkeypatch):
    """No decode is shared: a range decode that fails fails its own caller
    only, and the next read of the same range decodes again and is right.
    A stream whose decode fails raises to its consumer."""
    xyz, rgba = cloud(8, 5000, walk=True)
    p = str(tmp_path / "e.laz")
    laz.write(p, xyz, rgba, chunk_size=1000)
    want = las.format2_records(xyz, rgba, np.full(3, 0.001), xyz.min(0))
    real = native.laz_decode_into
    calls = []

    lock = threading.Lock()

    def flaky(*a):
        with lock:
            first = not calls
            calls.append(1)
        time.sleep(0.05)          # the other readers decode meanwhile
        if first:
            raise OSError("read failed")
        return real(*a)
    monkeypatch.setattr(native, "laz_decode_into", flaky)
    out, errors = [], []

    def reader():
        try:
            out.append(laz.read_records(p, first=1500, count=2000))
        except OSError as e:
            errors.append(e)
    threads = [threading.Thread(target=reader) for _ in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert len(errors) == 1 and len(out) == 2 and len(calls) == 3
    assert out[0] is not out[1]
    for rec in out:
        np.testing.assert_array_equal(rec, want[1500:3500])
    calls.clear()
    s = PointStream([p], step_points=1 << 12, device="cpu",
                    batch_points=1000, num_loaders=2)
    with pytest.raises(RuntimeError, match="point stream failed"):
        list(s)
    s.stop()


def test_laz_single_flight_under_thread_stress(tmp_path):
    """More threads than cores and a short switch interval: range reads of
    two files from every thread return the right records, and a file
    without random access streamed by as many loaders is decoded once (its
    whole stream is one batch, however many loaders)."""
    paths, want = [], []
    for i in range(2):
        xyz, rgba = cloud(20 + i, 20_000, walk=True)
        paths.append(str(tmp_path / f"s{i}.laz"))
        laz.write(paths[-1], xyz, rgba, chunk_size=3000)
        want.append(las.format2_records(xyz, rgba, np.full(3, 0.001),
                                        xyz.min(0)))
    pw = str(tmp_path / "pw.laz")
    _write_pointwise_laz(pw, *cloud(20, 20_000, walk=True))
    bad = []
    nthreads = 4 * (os.cpu_count() or 1)

    def reader(k):
        rng = np.random.default_rng(k)
        for _ in range(20):
            i = int(rng.integers(2))
            first = int(rng.integers(0, 19_000))
            got = laz.read_records(paths[i], first=first, count=500)
            if not np.array_equal(got, want[i][first:first + 500]):
                bad.append((k, i, first))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=reader, args=(k,))
                   for k in range(nthreads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        s = PointStream([pw], step_points=1 << 12, device="cpu",
                        batch_points=500, num_loaders=nthreads)
        cols = _stream_columns(list(s), True)
        s.stop()
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not bad
    assert s.laz_chunks == 1 and s._n_batches == 1
    # the same records as paths[0], whose reads are checked above
    same_points(_stream_points(cols), laz.read_points(paths[0]))


def test_laz_records_are_not_held_after_stop(tmp_path, monkeypatch):
    """Nothing keeps a range decode's records once its batch's columns are
    made: after stop(), mid-stream or at its end, every record array the
    loaders decoded into is gone, for a file without random access (one
    batch, the whole stream) and for one with it."""
    import gc
    import weakref
    xyz, rgba = cloud(15, 40_000, walk=True)
    pw, pc = str(tmp_path / "pw.laz"), str(tmp_path / "pc.laz")
    _write_pointwise_laz(pw, xyz, rgba)
    laz.write(pc, xyz, rgba, chunk_size=4000)
    refs = []
    real = laz.decode_range

    def spy(entry, first, count, out):
        refs.append(weakref.ref(out))
        return real(entry, first, count, out)
    monkeypatch.setattr(laz, "decode_range", spy)
    s = PointStream([pw, pc], step_points=1 << 12, device="cpu",
                    batch_points=4000, num_loaders=2, ring_slots=1)
    it = iter(s)
    next(it)
    s.stop()
    del it
    gc.collect()
    assert refs and all(r() is None for r in refs)
    refs.clear()
    s = PointStream([pw, pc], step_points=1 << 12, device="cpu",
                    batch_points=4000, num_loaders=2)
    assert len(_stream_columns(list(s), True)[0]) == 80_000
    s.stop()
    gc.collect()
    assert len(refs) == 1 + 10 and all(r() is None for r in refs)
    assert s.laz_chunks == 1 + 10


def test_laz_with_more_than_four_decode_threads_builds_the_las_tree(
        tmp_path, monkeypatch):
    """On a host of 8 cores a LAZ file streams on 8 loader threads (the
    LAS file of the same records on 4), in batches of LAZ_BATCH_CHUNKS
    whole chunks; the engine builds the same octree from both."""
    from simlod_tpu_torch.config import EngineConfig, Settings
    from simlod_tpu_torch.engine import Engine
    from simlod_tpu_torch.formats import synthetic
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    xyz, rgba = synthetic.terrain(38_400, seed=16)
    pz, pl = str(tmp_path / "t.laz"), str(tmp_path / "t.las")
    laz.write(pz, xyz, rgba, chunk_size=100)             # 384 chunks
    las.write(pl, xyz, rgba)
    cfg = EngineConfig(node_capacity=1 << 11, point_capacity=1 << 16,
                       voxel_capacity=1 << 17, segment_capacity=1 << 12,
                       step_points=1 << 13, spill_capacity=1 << 13,
                       max_points_per_node=2000, seg_select_cap=1 << 10,
                       max_render_points=1 << 14, max_render_voxels=1 << 14)
    states = []
    for p in (pz, pl):
        eng = Engine(cfg, Settings(), device="cpu")
        stream = eng.open([p])
        eng.load_all()
        stream.stop()
        if p == pz:
            assert len(stream._loaders) == 8 and stream.laz_chunks == 384
            assert stream._n_batches == 77        # of 5 chunks, the last 4
        else:
            assert len(stream._loaders) == 4 and stream.laz_chunks == 0
        states.append(eng.state)
    for f in dataclasses.fields(states[0]):
        a, b = getattr(states[0], f.name), getattr(states[1], f.name)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, \
            f.name
