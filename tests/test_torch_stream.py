"""PointStream's plane ring on the CPU: the loaders decode each batch into its
own rows of the [K, B] plane sets, and the stream yields the items of a plain
reference stream (every file decoded whole in numpy, in file order, cut into
sets of K steps of B rows, zero past the end) bit for bit: planes, counts,
count-0 padding steps and order, for .simlod, LAS and LAZ files, one device or
a list of shards, a ring of one slot with more loaders than slots. The same
on a card (marker `cuda`: `python -m pytest tests/test_torch_stream.py -m cuda
--noconftest`)."""
import time

import numpy as np
import pytest
import torch

from simlod_tpu_torch.formats import las, laz, simlod, synthetic
from simlod_tpu_torch.io.streaming import PointStream, scan_paths


def _write(path, kind, xyz, rgba, chunk_size):
    if kind == "simlod":
        simlod.write(path, xyz, rgba)
    elif kind == "las":
        las.write(path, xyz, rgba)
    else:
        laz.write(path, xyz, rgba, chunk_size=chunk_size)


def _reference_columns(entry, box_min):
    """One file decoded whole by the plain numpy decoders, rebased by
    -box_min: (x, y, z f32, rgba as int32)."""
    translation = -box_min
    if entry.kind == "simlod":
        xyz, rgba = simlod.read_points(entry.path)
        shift = (entry.box_min + translation).astype(np.float32)
        xyz = xyz + shift
    else:
        hdr = entry.header
        if entry.kind == "las":
            raw = np.fromfile(entry.path, np.uint8,
                              offset=hdr.offset_to_points)
        else:
            raw = laz.read_records(entry.path).reshape(-1)
        xyz, rgba = las.decode_points_reference(
            hdr, raw[:hdr.num_points * hdr.bytes_per_point], translation)
    return (*(np.ascontiguousarray(xyz[:, c]) for c in range(3)),
            rgba.view(np.int32))


def _reference_items(paths, step_points, chunk_steps):
    """The stream as a plain reference makes it: the rows of every file in
    file order, cut into [K, B] sets, zero past the last row; counts per
    step."""
    entries = scan_paths(paths)
    box_min = np.min([e.box_min for e in entries], axis=0)
    cols = [np.concatenate(c) for c in
            zip(*(_reference_columns(e, box_min) for e in entries))]
    total, kb = len(cols[0]), chunk_steps * step_points
    items = []
    for lo in range(0, total, kb):
        rows = min(kb, total - lo)
        planes = []
        for c in cols:
            p = np.zeros(kb, c.dtype)
            p[:rows] = c[lo:lo + rows]
            planes.append(p.reshape(chunk_steps, step_points))
        counts = np.clip(rows - step_points * np.arange(chunk_steps), 0,
                         step_points).astype(np.int32)
        items.append((planes, counts))
    return items


# (files, step_points, chunk_steps, batch_points, LAZ chunk size, loaders,
#  ring slots, devices): batches that cross steps, sets and files; LAZ chunk
# batches (5 chunks of 300 points) that cross a step and a plane set
CASES = {
    "simlod": (("simlod",), 700, 3, 500, 0, 3, 4, "cpu"),
    "las": (("las",), 512, 2, 900, 0, 4, 4, "cpu"),
    "laz-chunks": (("laz",), 1000, 2, 5000, 300, 3, 4, "cpu"),
    "laz-small-chunks": (("laz",), 640, 1, 400, 3, 2, 2, "cpu"),
    "mixed": (("simlod", "las", "laz"), 800, 4, 1100, 700, 4, 4, "cpu"),
    "ring-of-one": (("las", "laz"), 300, 1, 250, 200, 6, 1, "cpu"),
    "sharded": (("simlod", "laz"), 600, 2, 700, 500, 3, 2, ["cpu", "cpu"]),
}


def _check_stream(tmp_path, case, device):
    kinds, step, k, batch, chunk, loaders, slots, _ = CASES[case]
    paths = []
    for i, kind in enumerate(kinds):
        xyz, rgba = synthetic.terrain(5300 + 977 * i, seed=40 + i)
        paths.append(str(tmp_path / f"{i}.{kind}"))
        _write(paths[-1], kind, xyz + 50.0 * i, rgba, chunk)
    want = _reference_items(paths, step, k)
    s = PointStream(paths, step_points=step, device=device, chunk_steps=k,
                    batch_points=batch, num_loaders=loaders, ring_slots=slots)
    got = list(s)
    s.stop()
    assert len(s._loaders) == loaders and len(got) == len(want) > 2
    for item, (wplanes, wcounts) in zip(got, want):
        np.testing.assert_array_equal(item[4], wcounts)
        for p, w in zip(item[:4], wplanes):
            if isinstance(device, list):
                assert [b.shape for b in p] == [(k, step // len(device))] * 2
                p = torch.cat([b.cpu() for b in p], 1)
            assert p.shape == (k, step)
            np.testing.assert_array_equal(p.cpu().numpy().view(np.int32),
                                          w.view(np.int32))
    st = s.stats()
    assert st["staged_rows"] == 0 and s.staged_rows == 0
    assert st["points_loaded"] == s.total_points == sum(
        int(c.sum()) for _, c in want)


@pytest.mark.parametrize("case", list(CASES))
def test_stream_items_match_the_plain_reference_stream(tmp_path, case):
    _check_stream(tmp_path, case, CASES[case][-1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["las", "ring-of-one", "sharded"])
def test_card_stream_items_match_the_plain_reference_stream(tmp_path, case):
    """On the card each set goes to a device block in one copy from the
    pinned ring, and the rows past the stream's end are zeroed there: the
    items equal the reference's bit for bit, also where the last set
    recycles pinned planes that held earlier rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (pinned planes, side-stream copies)")
    device = CASES[case][-1]
    _check_stream(tmp_path, case, ["cuda"] * len(device)
                  if isinstance(device, list) else "cuda")


def test_stop_wakes_loaders_waiting_on_a_full_ring(tmp_path):
    """A stream nobody consumes fills its ring: one set waits for the
    consumer, the uploader waits to queue the next, and every loader waits
    for a free set. stop() wakes them all, and every pipeline thread has
    ended within the joins' timeouts."""
    p = str(tmp_path / "a.las")
    las.write(p, *synthetic.terrain(20_000, seed=3))
    s = PointStream([p], step_points=500, device="cpu", batch_points=300,
                    num_loaders=4, ring_slots=1)
    deadline = time.monotonic() + 30.0
    while not (s._ready.full() and not s._ring) \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.3)             # the loaders reach their wait for a set
    threads = s._loaders + [s._uploader]
    assert s._ready.full() and not s._ring
    assert all(t.is_alive() for t in threads)
    assert s.points_loaded < s.total_points
    t0 = time.monotonic()
    s.stop()
    assert time.monotonic() - t0 < 2.0
    assert not any(t.is_alive() for t in threads)
    assert s._error is None and list(s) == []
