"""Host streaming pipeline (port of simlod_tpu/io/streaming.py; .simlod, LAS and
LAZ files): files -> loader threads -> pinned host staging planes -> async H2D
copies.

  - the stream's rows, in file order over all files, fill plane sets in
    pinned (page-locked) host memory one after another: row r lies in set
    r // KB, step r % KB // B, at offset r % B. A set is one [4, K, B] int32
    tensor: the x, y, z step planes (float32 bits) and the rgba plane;
  - loader threads decode 1M-point file batches straight into their rows of
    the planes with the native column decoders (native/fastload.c), one call
    a step: .simlod and LAS records from a memmap of the file, in batches
    cut where a plane set ends; LAZ records from a decode of the batch's own
    chunks (formats/laz.py: batches of LAZ_BATCH_CHUNKS whole chunks, which
    may cross a set, on as many loaders as the host has cores; a file
    without a usable chunk table is one batch, decoded whole by one loader);
  - the ring hands the plane sets to the loaders in file order, each once
    the copies out of the planes it recycles have completed: at most
    `ring_slots` + 1 sets are filling or in flight, and a loader whose set
    is not free waits;
  - one uploader thread waits, in file order, for each set's rows to be
    written and copies the set to the device in one non_blocking copy on a
    side CUDA stream, zeroes the last set's rows past the stream's end there
    and records an event; the consumer's stream waits on that event before
    it reads the planes (the reference's loaders parse into pinned slots, its
    uploader issues cuMemcpyHtoDAsync, main_progressive_octree.cpp:811-1063);
  - backpressure: at most `ring_slots` plane sets wait for the consumer.

On a CPU device the sets are plain tensors (one made anew for each item,
zeroed past the end on the host, which the consumer uses in place) and
nothing is pinned or async.
All files share one union box (or the `box_override` box: out-of-core bricks
are rebased into one world box); coordinates are translated by -box_min.

Given a sequence of n devices (the shards of a parallel.shard.Mesh), each
step's B rows are split into n blocks of B/n and block s goes from the pinned
planes straight to device s (the JAX package's sharded device_put); the
yielded planes are then lists of n per-shard [K, B/n] tensors.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import queue
import threading
import time

import numpy as np
import torch

from .. import native
from ..config import resolve_device
from ..formats import las, laz, simlod
from ..utils import trace

BATCH_POINTS = 1_000_000   # loader batch granularity (reference MAX_BATCH_SIZE)
# LASzip chunks a LAZ batch (at most BATCH_POINTS points): the best size of
# a bulk load of 36M points on an H100 host of 8 cores (5-chunk batches
# 16.1-16.3 MP/s, 20-chunk 13.7-15.6, 1-chunk 14.2-14.4)
LAZ_BATCH_CHUNKS = 5


def _copy_block(src: torch.Tensor, device) -> torch.Tensor:
    """Async copy of a [4, K, w] block of a pinned plane set to `device`: one
    copy where the block is contiguous (a whole set), else one a plane row:
    a strided source would be staged through pageable memory."""
    if src.is_contiguous():
        return src.to(device, non_blocking=True)
    dst = torch.empty(src.shape, dtype=src.dtype, device=device)
    for i in range(src.shape[0]):
        for k in range(src.shape[1]):
            dst[i, k].copy_(src[i, k], non_blocking=True)
    return dst


def _zero_past(block: torch.Tensor, valid) -> None:
    """Zero each step's columns of a [4, K, w] block from valid[k] on."""
    w = block.shape[2]
    for k, v in enumerate(valid):
        if v < w:
            block[:, k, max(int(v), 0):].zero_()


def _plane_views(block: torch.Tensor) -> tuple:
    """A [4, K, w] int32 plane set block -> its x, y, z (float32) and rgba
    (int32) [K, w] planes."""
    return (*(block[i].view(torch.float32) for i in range(3)), block[3])


@dataclasses.dataclass
class FileEntry:
    path: str
    kind: str                # "simlod" | "las" | "laz"
    num_points: int
    box_min: np.ndarray      # original coords
    box_max: np.ndarray
    header: object = None
    laz: laz.LazIndex | None = None


@dataclasses.dataclass
class BatchRef:
    entry: FileEntry
    first: int               # first point in the file
    count: int
    row: int                 # its first row in the stream


def scan_paths(paths) -> list[FileEntry]:
    """File entries for the given files / directories (.simlod, .las, .laz;
    other files are skipped)."""
    files = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(os.path.join(p, n) for n in sorted(os.listdir(p)))
        else:
            files.append(p)
    entries = []
    for f in files:
        low = f.lower()
        if low.endswith(".simlod"):
            info = simlod.load_info(f)
            entries.append(FileEntry(f, "simlod", info.num_points,
                                     info.box_min.astype(np.float64),
                                     info.box_max.astype(np.float64), info))
        elif low.endswith((".las", ".laz")):
            hdr = las.load_header(f)
            kind = low[-3:]
            entries.append(FileEntry(f, kind, hdr.num_points, hdr.box_min,
                                     hdr.box_max, hdr,
                                     laz.index(f, hdr) if kind == "laz"
                                     else None))
    return entries


class PointStream:
    """Threaded reader yielding device step batches.

    Iterating yields (x, y, z, rgba, counts): [K, B] tensors on `device` (the
    card unless another is named; rgba as int32 bit patterns) and a numpy
    int32 [K] of valid rows per step. The tensors are ready to use on the
    consumer's current stream. With a sequence of n devices (all of one type)
    each plane is a list of n [K, B/n] tensors, block s on device s."""

    def __init__(self, paths, step_points: int, device=None,
                 num_loaders: int | None = None, ring_slots: int = 4,
                 batch_points: int = BATCH_POINTS, chunk_steps: int = 1,
                 box_override=None):
        self._t_start = time.perf_counter()
        self.sharded = isinstance(device, (list, tuple))
        devices = [resolve_device(d, "PointStream")
                   for d in (device if self.sharded else [device])]
        self.entries = scan_paths(paths)
        if not self.entries:
            raise FileNotFoundError(f"no point cloud files under {paths!r}")
        # an index-less "cuda" names the current card (tensors report cuda:i)
        devices = [torch.device("cuda", torch.cuda.current_device())
                   if d.type == "cuda" and d.index is None else d
                   for d in devices]
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"PointStream: devices {devices} mix types")
        if step_points % len(devices):
            raise ValueError(f"PointStream: {step_points} rows per step do "
                             f"not split over {len(devices)} devices")
        self.devices = devices
        self.device = devices[0]
        self.step_points = step_points
        self.chunk_steps = max(1, chunk_steps)
        if box_override is not None:
            # out-of-core bricks: coordinates are rebased into a wider world
            # box shared by all bricks, so their octrees share one cube
            self.box_min = np.asarray(box_override[0], np.float64)
            self.box_max = np.asarray(box_override[1], np.float64)
        else:
            self.box_min = np.min([e.box_min for e in self.entries], axis=0)
            self.box_max = np.max([e.box_max for e in self.entries], axis=0)
        self.total_points = sum(e.num_points for e in self.entries)
        # rows of a plane set; the stream's rows fill the sets in file order
        self._set_points = self.chunk_steps * step_points
        self._n_sets = -(-self.total_points // self._set_points)

        self._batches = collections.deque()
        n_loaders = max(1, min(4, os.cpu_count() or 1))
        row = 0
        for e in self.entries:
            per = batch_points
            if e.laz is not None and e.laz.seekable:
                # whole chunks, decoded on a loader per core (at most one
                # per chunk)
                cs = e.laz.chunk_size
                per = max(1, min(LAZ_BATCH_CHUNKS, batch_points // cs)) * cs
                n_loaders = max(n_loaders, min(e.laz.nchunks,
                                               max(2, os.cpu_count() or 1)))
            elif e.laz is not None:
                # no random access: one batch, the whole stream decoded once
                per = max(1, e.num_points)
            first = 0
            while first < e.num_points:
                n = min(per, e.num_points - first)
                if e.laz is None:
                    # a .simlod or LAS batch ends where its plane set ends
                    n = min(n, self._set_points - row % self._set_points)
                self._batches.append(BatchRef(e, first, n, row))
                first += n
                row += n
        self._n_batches = len(self._batches)
        self._batch_lock = threading.Lock()

        n_loaders = num_loaders or n_loaders
        self._ready: queue.Queue = queue.Queue(maxsize=ring_slots)
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._sides = {d: torch.cuda.Stream(d) for d in devices}
        # the plane ring: (events, plane set) entries, taken in file order by
        # the loaders once the events (the copies out of the set) have
        # completed. CPU entries hold no set: the consumer keeps each set, so
        # every set is made anew
        self._ring = collections.deque(
            ([], self._new_set(pin=True) if self._cuda else None)
            for _ in range(ring_slots + 1))
        self._cv = threading.Condition()
        # the sets being filled (index -> set), the rows written into each,
        # and the next set the ring hands out
        self._sets: dict[int, torch.Tensor] = {}
        self._rows: dict[int, int] = {}
        self._next_set = 0
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self._stats_lock = threading.Lock()
        self.bytes_read = 0
        self.points_loaded = 0
        self.t_decode = 0.0     # loaders: file read + decode into the planes
        self.laz_chunks = 0     # LAZ chunks decoded by this stream
        # point rows the uploader copies into the planes itself: none, the
        # loaders decode every row in place
        self.staged_rows = 0
        # set once by the uploader, read-only elsewhere: the host clock
        # (perf_counter) at which it queued its last plane set
        self.t_last_queued: float | None = None
        # this stream's `stream.stage` spans (uploader: the H2D copy
        # launches and the zero-fill past the stream's end) and `stream.wait`
        # spans (consumer blocked)
        self.t_stage = trace.Timings()
        self.t_wait = trace.Timings()

        self._loaders = [threading.Thread(target=self._guard(self._loader),
                                          daemon=True)
                         for _ in range(n_loaders)]
        self._uploader = threading.Thread(target=self._guard(self._upload),
                                          daemon=True)
        self._n_active = n_loaders
        for t in self._loaders:
            t.start()
        self._uploader.start()

    def _new_set(self, pin: bool) -> torch.Tensor:
        """A plane set: one [4, K, B] int32 tensor, the x, y, z planes as
        float32 bit patterns and rgba (`_plane_views`), so that a set goes
        to a device in one copy."""
        return torch.empty((4, self.chunk_steps, self.step_points),
                           dtype=torch.int32, pin_memory=pin)

    def _set_rows(self, s: int) -> int:
        """Rows of the stream in plane set s (the last set's may be fewer)."""
        return min(self._set_points, self.total_points - s * self._set_points)

    def _guard(self, fn):
        """Run a pipeline thread; an exception stops the stream and is raised
        again to the consumer."""
        def run():
            try:
                fn()
            except BaseException as e:   # re-raised in __iter__
                self._error = e
                self._stop.set()
        return run

    # --- loader threads ---
    def _loader(self):
        while not self._stop.is_set():
            with self._batch_lock:
                if not self._batches:
                    break
                ref = self._batches.popleft()
            if not self._fill(ref):
                break
        with self._cv:
            self._n_active -= 1
            self._cv.notify_all()

    def _fill(self, ref: BatchRef) -> bool:
        """Decode one batch into its rows of the plane ring, one decoder call
        a step; False once the stream is stopped. The seconds outside the
        wait for a set are `t_decode`."""
        t0 = time.perf_counter()
        raw, decode, nbytes, chunks = self._records(ref)
        busy = time.perf_counter() - t0
        KB, B = self._set_points, self.step_points
        row, end = ref.row, ref.row + ref.count
        while row < end:
            s = row // KB
            pset = self._take(s)
            if pset is None:
                return False
            t0 = time.perf_counter()
            planes = [p.numpy() for p in _plane_views(pset)]
            top, n_set = min(end, (s + 1) * KB), 0
            while row < top:
                k, o = divmod(row - s * KB, B)
                n = min(top - row, B - o)
                lo = row - ref.row
                decode(raw[lo:lo + n], n, [p[k, o:o + n] for p in planes])
                row += n
                n_set += n
            busy += time.perf_counter() - t0
            with self._cv:
                self._rows[s] += n_set
                if self._rows[s] == self._set_rows(s):
                    self._cv.notify_all()
        with self._stats_lock:
            self.t_decode += busy
            self.points_loaded += ref.count
            self.bytes_read += nbytes
            self.laz_chunks += chunks
        return True

    def _records(self, ref: BatchRef):
        """A batch's raw records [count, record bytes] (a view of the file's
        memmap, or the decode of its LAZ chunks), the column decoder of its
        format (records, n, (x, y, z f32, rgba i32) columns), the bytes read
        and the LAZ chunks decoded."""
        e, n = ref.entry, ref.count
        translation = -self.box_min
        if e.kind == "simlod":
            shift = (e.box_min + translation).astype(np.float32)
            mm = np.memmap(e.path, dtype=np.uint8, mode="r",
                           offset=simlod.HEADER_BYTES)
            raw = mm[ref.first * simlod.POINT_BYTES:
                     (ref.first + n) * simlod.POINT_BYTES]
            return (raw.reshape(n, simlod.POINT_BYTES),
                    lambda r, m, cols: native.decode_simlod_cols(
                        r, m, shift, *cols),
                    n * simlod.POINT_BYTES, 0)
        hdr = e.header
        bpp = hdr.bytes_per_point
        chunks = 0
        if e.kind == "las":
            mm = np.memmap(e.path, dtype=np.uint8, mode="r",
                           offset=hdr.offset_to_points)
            raw = mm[ref.first * bpp:(ref.first + n) * bpp].reshape(n, bpp)
            nbytes = n * bpp
        else:
            raw = np.empty((n, e.laz.record_size), np.uint8)
            chunks = laz.decode_range(e.laz, ref.first, n, raw)
            nbytes = n * 8   # compressed estimate
        rgb_off = las.RGB_OFFSET.get(hdr.format, -1)
        trans = np.asarray(translation, np.float64)
        return (raw,
                lambda r, m, cols: native.decode_las_cols(
                    r, m, bpp, rgb_off, hdr.scale, hdr.offset, trans, *cols),
                nbytes, chunks)

    def _take(self, s: int):
        """Plane set s ([4, K, B]), to write rows into; None once the stream
        is stopped.
        The ring hands the sets out in file order, each once the copies out
        of the planes it recycles have completed; while it is empty (the
        consumer is `ring_slots` sets behind) the loader waits."""
        while True:
            with self._cv:
                while True:
                    if self._stop.is_set():
                        return None
                    pset = self._sets.get(s)
                    if pset is not None:
                        return pset
                    if self._next_set <= s and self._ring:
                        idx = self._next_set
                        self._next_set += 1
                        events, pset = self._ring.popleft()
                        break
                    self._cv.wait(0.1)
            for _, ev in events:
                ev.synchronize()
            if pset is None:
                pset = self._new_set(pin=False)
            with self._cv:
                self._sets[idx] = pset
                self._rows[idx] = 0
                self._cv.notify_all()

    def _put(self, q: queue.Queue, item) -> bool:
        """Backpressured put that gives up once the stream is stopped."""
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    # --- uploader thread ---
    def _place(self, filled):
        """A filled plane set on its device(s) -> (planes, [(device, event)]).
        `filled` is the [4, K, B] set and its counts per step; the rows past
        them are zeroed. On CUDA each device's block of the set is copied
        and zeroed on the device's side stream, and each device's event
        marks that done; a CPU set is zeroed and used in place. In sharded
        mode each plane becomes its list of per-device blocks."""
        pset, counts = filled
        n = len(self.devices)
        w = self.step_points // n
        blocks = [pset[:, :, s * w:(s + 1) * w] for s in range(n)]
        events = []
        if self._cuda:
            for d, side in self._sides.items():
                with torch.cuda.stream(side):
                    for s in range(n):
                        if self.devices[s] == d:
                            blocks[s] = _copy_block(blocks[s], d)
                            _zero_past(blocks[s], counts - s * w)
                    ev = torch.cuda.Event()
                    ev.record(side)
                events.append((d, ev))
        else:
            for s in range(n):
                _zero_past(blocks[s], counts - s * w)
        planes = [_plane_views(b) for b in blocks]
        out = tuple(map(list, zip(*planes))) if self.sharded else planes[0]
        return out, events

    def _complete(self, s: int):
        """Plane set s's planes once the loaders have written all its rows;
        None once the stream is stopped."""
        want = self._set_rows(s)
        with self._cv:
            while self._rows.get(s) != want:
                if self._stop.is_set():
                    return None
                if self._n_active == 0:
                    raise RuntimeError(f"stream lost rows (plane set {s} of "
                                       f"{self._n_sets})")
                self._cv.wait(0.1)
            del self._rows[s]
            return self._sets.pop(s)

    def _upload(self):
        K, B = self.chunk_steps, self.step_points
        queued = None       # host clock of the latest plane set queued
        for s in range(self._n_sets):
            pset = self._complete(s)
            if pset is None:
                break
            rows = self._set_rows(s)
            counts = np.clip(rows - B * np.arange(K), 0, B).astype(np.int32)
            with trace.span("stream.stage", self.t_stage):
                out, events = self._place((pset, counts))
            if not self._put(self._ready, (out, events, counts)):
                break
            if queued is None:
                # PointStream's start to its first plane set on `_ready`
                trace.add("stream.first_item",
                          time.perf_counter() - self._t_start)
            queued = time.perf_counter()
            with self._cv:
                self._ring.append((events, pset if self._cuda else None))
                self._cv.notify_all()
        else:
            self.t_last_queued = queued
        # the copies out of the pinned planes complete before the stream ends
        with self._cv:
            pending = [ev for events, _ in self._ring for _, ev in events]
        for ev in pending:
            ev.synchronize()
        self._put(self._ready, None)

    # --- consumer side ---
    def __iter__(self):
        """Yield the uploaded chunks in file order. Ends once the uploader's
        end marker arrives or, after stop(), once nothing is left to take
        (a stopped uploader gives up on its end marker); raises if a pipeline
        thread failed. The time blocked on each item is a `stream.wait`
        span."""
        while True:
            with trace.span("stream.wait", self.t_wait):
                item = self._next_ready()
            if item is None:
                if self._error is not None:
                    raise RuntimeError("point stream failed") from self._error
                return
            planes, events, counts = item
            tensors = [t for p in planes
                       for t in (p if self.sharded else [p])]
            for d, ev in events:
                cur = torch.cuda.current_stream(d)
                cur.wait_event(ev)
                for t in tensors:
                    if t.device == d:
                        t.record_stream(cur)
            yield (*planes, counts)

    def _next_ready(self):
        """The next uploaded item; None at the end marker, or once the
        stream is stopped or failed and nothing is left to take."""
        while True:
            try:
                return self._ready.get(timeout=0.1)
            except queue.Empty:
                if self._error is not None or self._stop.is_set():
                    return None

    def stop(self):
        """Stop and join the pipeline threads, and drop the items not taken:
        once before the joins, which frees an uploader waiting to queue an
        item, and once after, for the item that its put then lands."""
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        self._drop_ready()
        for t in (*self._loaders, self._uploader):
            t.join(timeout=2.0)
        self._drop_ready()

    def _drop_ready(self):
        while True:
            try:
                self._ready.get_nowait()
            except queue.Empty:
                return

    def stats(self):
        """Points and bytes read so far, the point rows the uploader copied
        itself (staged_rows: 0, the loaders decode in place), and seconds
        summed over threads: the loaders' read and decode into the planes
        (t_decode), the uploader's zero-fill and copy launches (stage_s),
        the consumer's wait for items (wait_s)."""
        return dict(points_loaded=self.points_loaded, bytes_read=self.bytes_read,
                    laz_chunks=self.laz_chunks, staged_rows=self.staged_rows,
                    t_decode=round(self.t_decode, 3),
                    stage_s=round(self.t_stage.total, 3),
                    wait_s=round(self.t_wait.total, 3))
