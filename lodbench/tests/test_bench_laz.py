"""The LAZ cell (laz36m.load): the format module's writer and reader, its
encoder's chunk table, the load loop that opens a new name on every load,
the per-layer readers the cell reports, and its runs shrunk to the CPU
(small.py): correct unbroken, not correct with one chunk of the program's
decode zeroed. The control of the cell is test_bench_control.py's, which
runs every cell of BENCHMARK.json."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import small
from lodbench import data, found, laz_encode
from lodbench import reference as ref
from lodbench import run as R

CPU = torch.device("cpu")
CELL = "laz36m.load"
HERE = Path(__file__).resolve().parent


def test_the_writer_and_reader_round_trip(tmp_path):
    """The truth copy is formats/las.py's file of the same scan byte for
    byte; the LAZ file has its header with the LASzip VLR and flag, and
    the program decodes it to the truth's records; the reader reads the
    truth."""
    from simlod_tpu_torch.formats import laz as plaz
    xyz, rgba = data.terrain(123_457, 2 ** 31 + 21, CPU)
    fmt, las = found.module("formats", "laz"), found.module("formats", "las")
    path, lpath = str(tmp_path / "scan.laz"), str(tmp_path / "scan.las")
    fmt.write(path, xyz, rgba, chunk_size=10_000)
    las.write(lpath, xyz, rgba)
    truth = Path(path + fmt.TRUTH).read_bytes()
    assert truth == Path(lpath).read_bytes()
    head = Path(path).read_bytes()[:las.HEADER]
    assert head[104] == 2 | 0x80 and head[100:104] == b"\x01\0\0\0"
    same = [i for i in range(las.HEADER) if head[i] != truth[i]]
    assert set(same) <= {96, 97, 98, 99, 100, 104}
    idx = plaz.index(path)
    assert idx.seekable and idx.nchunks == 13 and idx.chunk_size == 10_000
    records = np.frombuffer(truth[las.HEADER:], np.uint8).reshape(-1, 26)
    np.testing.assert_array_equal(plaz.read_records(path), records)
    scan = ref.read_scan(path, "laz", CPU)
    want = ref.read_scan(lpath, "las", CPU)
    assert torch.equal(scan.xyz, want.xyz) and torch.equal(scan.rgba, rgba)
    assert fmt.extent(path) == las.extent(lpath)
    assert os.path.getsize(path) < 0.5 * len(truth)


def test_the_cell_runs_correct_and_opens_a_new_name_every_load(monkeypatch):
    from simlod_tpu_torch.engine import Engine
    opened = []
    real = Engine.open

    def spy(self, paths, *a, **k):
        opened.append(list(paths))
        return real(self, paths, *a, **k)
    monkeypatch.setattr(Engine, "open", spy)
    out = small.small_run(CELL, points=60_000, seconds=0.3)
    assert out["correct"] is True, out["checks"]
    assert all(v == 0 for k, (v, _) in out["checks"].items()
               if k != "voxel_cells_missing_pct")
    names = [p for paths in opened for p in paths]
    assert len(names) == len(set(names)) >= 2        # warm-up and window
    d = os.path.dirname(names[0])
    assert all(os.path.dirname(n) == d and n.endswith(".laz")
               and n != os.path.join(d, "scan.laz") for n in names)


@pytest.mark.parametrize("n,chunk", [(0, 50), (49, 50), (50, 50),
                                     (123_457, 7000), (20_000, 10)])
def test_the_threaded_encode_is_the_single_call_stream(n, chunk):
    """Chunks encoded one a call on a pool, with the chunk table written
    here: byte for byte the stream of one call of the encoder over all the
    records (a short last chunk, one chunk, none, 2,000 chunks)."""
    rng = np.random.default_rng(n)
    rec = rng.integers(0, 256, (n, 26), dtype=np.uint8)
    rec[:, :12] = np.cumsum(rng.integers(-3, 4, (n, 12)), axis=0)
    want = laz_encode._native_encode(rec, chunk)
    got = laz_encode.encode(rec, chunk, threads=3)
    assert np.array_equal(got, want)


def test_the_chunk_table_decodes_to_its_sizes():
    """Sizes whose steps need every bit count of the integer compressor
    (0 and 1 as a bit, up to 31 bits with raw low bits, and -2^31) come
    back from the program's chunk-table decode."""
    from simlod_tpu_torch import native
    sizes = [0, 1, 0, 2, 300, 299, 70_000, 1 << 20, 3, (1 << 31) - 1, 0,
             (1 << 31) - 1, 1 << 30, 5, 5, 123_456_789, 7]
    sizes += [int(x) for x in np.random.default_rng(3).integers(0, 1 << 31,
                                                                 200)]
    table = laz_encode.chunk_table(sizes)
    got = native.laz_chunk_table(table, len(sizes))
    assert got is not None and got.tolist() == sizes


def test_each_load_reports_its_chunks_and_spans(monkeypatch):
    """The loop's loads each decode the file's chunks once and carry their
    own span totals, its info lists them a load, and every per-layer
    reader the cell lists that reads the program (all but the device
    trace's) reads a number after the run."""
    loop_cls = found.module("traffic", "load_new_name").LOOP
    loads = []
    real = loop_cls.one

    def keep(self):
        x = real(self)
        loads.append(x)
        return x
    monkeypatch.setattr(loop_cls, "one", keep)
    out = small.small_run(CELL, points=120_000, seconds=0.3)
    assert loads and all(x["laz_chunks"] == 3 for x in loads)
    for x in loads:
        assert x["spans"]["stream.first_item"]["count"] == 1
        assert x["spans"]["laz.decode"]["count"] >= 1
    window = loads[1:]                          # after the warm-up load
    info = out["info"]
    assert info["laz_chunks"] == [3] * len(window)
    assert len(info["first_item_ms"]) == len(window)
    assert all(v > 0 for v in info["first_item_ms"])
    rec = dict(window=dict(loads=window))
    metrics = [m for m in R.load_cell(CELL, trace=True).metrics
               if m["source"] != "device_trace"]
    assert len(metrics) == 8
    for m in metrics:
        v = R.metric_module(m["name"]).read(rec)
        # a CPU state builds eagerly: no replayed stretch
        eager = m["name"] == "build.replayed_pct.load"
        assert v is not None and (v == 0 if eager else v > 0), m["name"]


def test_a_zeroed_chunk_of_the_decode_is_not_correct(monkeypatch):
    """The last chunk's records zeroed where the program decodes them (500
    points: a pile small enough for a leaf of the small config, so the
    tree stays checkable)."""
    from simlod_tpu_torch.formats import laz as plaz
    real = plaz.decode_range

    def zeroed(entry, first, count, out):
        n = real(entry, first, count, out)
        last = (entry.header.num_points - 1) // entry.chunk_size
        lo = last * entry.chunk_size - first
        if lo < count:
            out[max(lo, 0):] = 0
        return n
    monkeypatch.setattr(plaz, "decode_range", zeroed)
    out = small.small_run(CELL, points=50_500, seconds=0.3)
    assert out["correct"] is False
    assert out["checks"]["points_mismatched"][0] >= 500, out["checks"]


RUN = """
import json, sys
sys.path[:0] = [{root!r}, {here!r}]
import small
from lodbench.run import forbidden_modules
out = small.small_run({cell!r}, points=60_000, seconds=0.3)
print(json.dumps(dict(correct=out["correct"], found=forbidden_modules())))
"""


def test_a_run_of_the_new_name_loop_loads_no_jax():
    res = subprocess.run(
        [sys.executable, "-c", RUN.format(root=str(R.ROOT), here=str(HERE),
                                          cell=CELL)],
        capture_output=True, text=True, timeout=600, cwd=R.ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == dict(correct=True, found=[])
