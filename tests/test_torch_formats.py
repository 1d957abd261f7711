"""The port's LAS/LAZ input (simlod_tpu_torch.formats.las/laz, native/, the
streaming loaders, tools/las2simlod) against simlod_tpu on the CPU, on files
made from seeded numpy clouds.

Tolerances: headers, decoded points and colours, raw LAZ records, converter
output and streamed columns are bit-equal to the JAX package's; the native
decoders are bit-equal to their numpy plain versions. A LAZ file streamed by
several loaders is decoded exactly once (single-flight per path).
"""
import os
import struct
import sys
import threading
import time

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


def test_laz_chunk_table_parallel_decode(tmp_path):
    """The chunk table tiles the stream, the parallel chunk-range decode is
    bit-identical to the sequential one and to the JAX package's, and a
    corrupt but decodable table falls back to the sequential decode."""
    xyz, rgba = cloud(12, 205_000, walk=True)          # 5 chunks, last partial
    p = str(tmp_path / "c.laz")
    laz.write(p, xyz, rgba)
    hdr = laz.load_header(p)
    _comp, chunk, types, sizes = laz._read_laszip_vlr(p, hdr)
    with open(p, "rb") as f:
        f.seek(hdr.offset_to_points)
        data = np.frombuffer(f.read(), np.uint8)
    table_off = int(np.frombuffer(data[:8].tobytes(), "<i8")[0]) \
        - hdr.offset_to_points - 8
    data = data[8:]
    csizes = native.laz_chunk_table(data[table_off:], 5)
    assert csizes is not None and len(csizes) == 5
    assert int(csizes.sum()) == table_off
    seq = native.laz_decode(data, hdr.num_points, chunk, types, sizes)
    par = laz._decode_chunked(hdr, data, table_off, chunk, types, sizes, 3)
    np.testing.assert_array_equal(seq, par)
    jpar = jlaz._decode_chunked(jlaz.load_header(p), data, table_off, chunk,
                                types, sizes, 3)
    np.testing.assert_array_equal(par, jpar)
    bad = np.array(data, copy=True)
    bad[table_off:table_off + 16] ^= 0xA5
    np.testing.assert_array_equal(
        laz._decode_chunked(hdr, bad, table_off, chunk, types, sizes, 3), seq)


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


def test_laz_stream_decodes_each_file_once(tmp_path, monkeypatch):
    """Four loaders take batches of one LAZ file at the same moment; the
    single-flight cache decodes the file once, and the others wait for it."""
    xyz, rgba = cloud(7, 60_000, walk=True)
    p = str(tmp_path / "d.laz")
    laz.write(p, xyz, rgba)
    calls = []
    real = laz._decode_uncached

    def slow_decode(*a):
        calls.append(threading.get_ident())
        time.sleep(0.2)            # every loader arrives while this one decodes
        return real(*a)
    monkeypatch.setattr(laz, "_decode_uncached", slow_decode)
    before = laz.decode_count
    s = PointStream([p], step_points=1 << 13, device="cpu", batch_points=5000,
                    num_loaders=4)
    cols = _stream_columns(list(s), True)
    s.stop()
    assert len(calls) == 1 and laz.decode_count == before + 1
    assert len(cols[0]) == 60_000
    np.testing.assert_array_equal(cols[3].view(np.uint32),
                                  laz.read_points(p)[1])
    assert len(calls) == 1                      # later reads hit the cache


def test_laz_single_flight_retries_after_a_failed_decode(tmp_path, monkeypatch):
    xyz, rgba = cloud(8, 5000, walk=True)
    p = str(tmp_path / "e.laz")
    laz.write(p, xyz, rgba)
    real = laz._decode_uncached
    calls = []

    def flaky(*a):
        calls.append(1)
        time.sleep(0.1)
        if len(calls) == 1:
            raise OSError("read failed")
        return real(*a)
    monkeypatch.setattr(laz, "_decode_uncached", flaky)
    hdr = laz.load_header(p)
    out, errors = [], []

    def reader():
        try:
            out.append(laz._decode_file(p, hdr))
        except OSError as e:
            errors.append(e)
    threads = [threading.Thread(target=reader) for _ in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert len(errors) == 1 and len(out) == 2 and len(calls) == 2
    assert out[0] is out[1]


def test_laz_single_flight_under_thread_stress(tmp_path):
    """More reader threads than cores and a short switch interval, on two
    files (what the cache holds): every read returns the right records and
    each file is decoded exactly once."""
    paths, want = [], []
    for i in range(2):
        xyz, rgba = cloud(20 + i, 20_000, walk=True)
        paths.append(str(tmp_path / f"s{i}.laz"))
        laz.write(paths[-1], xyz, rgba)
        want.append(las.format2_records(xyz, rgba, np.full(3, 0.001),
                                        xyz.min(0)))
    before = laz.decode_count
    bad = []

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
                   for k in range(4 * (os.cpu_count() or 1))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not bad
    assert laz.decode_count == before + 2
