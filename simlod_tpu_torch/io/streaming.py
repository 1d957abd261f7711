"""Host streaming pipeline (port of simlod_tpu/io/streaming.py; .simlod, LAS and
LAZ files): files -> loader threads -> pinned host staging planes -> async H2D
copies.

  - loader threads decode 1M-point file batches into column arrays with the
    native column decoders (native/fastload.c): .simlod and LAS records straight
    from a memmap of the file, LAZ records from a decode of the batch's own
    chunks (formats/laz.py: batches of LAZ_BATCH_CHUNKS whole chunks, on as
    many loaders as the host has cores; a file without a usable chunk table
    is one batch, decoded whole by one loader);
  - one uploader thread packs them, in file order, into [K, B] step planes in
    pinned (page-locked) host memory (numpy copies on that thread alone) and
    copies each plane set to the device with non_blocking copies on a side
    CUDA stream, recording an event; the consumer's stream waits on that
    event before it reads the planes (the reference's uploader thread +
    cuMemcpyHtoDAsync ring, main_progressive_octree.cpp:963-1063);
  - backpressure: at most `ring_slots` plane sets are in flight ahead of the
    consumer.

On a CPU device the planes are plain tensors and nothing is pinned or async.
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
    """Async copy of a [K, w] block of a pinned plane to `device`. A strided
    block (a column block of K > 1 steps) goes one contiguous row at a time:
    a strided source would be staged through pageable memory."""
    if src.is_contiguous():
        return src.to(device, non_blocking=True)
    dst = torch.empty(src.shape, dtype=src.dtype, device=device)
    for k in range(src.shape[0]):
        dst[k].copy_(src[k], non_blocking=True)
    return dst


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
    seq: int
    entry: FileEntry
    first: int
    count: int


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

        self._batches = collections.deque()
        n_loaders = max(1, min(4, os.cpu_count() or 1))
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
            for first in range(0, e.num_points, per):
                self._batches.append(BatchRef(
                    len(self._batches), e, first,
                    min(per, e.num_points - first)))
        self._n_batches = len(self._batches)
        self._batch_lock = threading.Lock()

        n_loaders = num_loaders or n_loaders
        self._loaded: queue.Queue = queue.Queue(maxsize=max(4, n_loaders * 2))
        self._ready: queue.Queue = queue.Queue(maxsize=ring_slots)
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._sides = {d: torch.cuda.Stream(d) for d in devices}
            # pinned plane sets, recycled once their copy has completed
            self._free: queue.Queue = queue.Queue()
            for _ in range(ring_slots + 1):
                self._free.put(self._new_planes(pin=True))
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self._stats_lock = threading.Lock()
        self.bytes_read = 0
        self.points_loaded = 0
        self.t_decode = 0.0     # loaders: file read + column decode
        self.laz_chunks = 0     # LAZ chunks decoded by this stream
        # set once by the uploader, read-only elsewhere: the host clock
        # (perf_counter) at which it queued its last plane set
        self.t_last_queued: float | None = None
        # this stream's `stream.stage` spans (uploader: pinned-plane fills and
        # the H2D copy launches) and `stream.wait` spans (consumer blocked)
        self.t_stage = trace.Timings()
        self.t_wait = trace.Timings()

        self._loaders = [threading.Thread(target=self._guard(self._loader),
                                          daemon=True)
                         for _ in range(n_loaders)]
        self._uploader = threading.Thread(target=self._guard(self._upload),
                                          daemon=True)
        self._n_active = n_loaders
        self._active_lock = threading.Lock()
        for t in self._loaders:
            t.start()
        self._uploader.start()

    def _new_planes(self, pin: bool):
        K, B = self.chunk_steps, self.step_points
        mk = lambda dt: torch.empty((K, B), dtype=dt, pin_memory=pin)
        return (mk(torch.float32), mk(torch.float32), mk(torch.float32),
                mk(torch.int32))

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
        translation = -self.box_min
        while not self._stop.is_set():
            with self._batch_lock:
                if not self._batches:
                    break
                ref = self._batches.popleft()
            t0 = time.perf_counter()
            cols, nbytes, chunks = self._decode(ref, translation)
            with self._stats_lock:
                self.t_decode += time.perf_counter() - t0
                self.points_loaded += ref.count
                self.bytes_read += nbytes
                self.laz_chunks += chunks
            if not self._put(self._loaded, (ref.seq, cols)):
                break
        with self._active_lock:
            self._n_active -= 1
            if self._n_active == 0:
                self._put(self._loaded, None)

    @staticmethod
    def _decode(ref: BatchRef, translation):
        """One batch -> ((x, y, z f32, rgba i32) numpy columns, bytes read,
        LAZ chunks decoded)."""
        e, n = ref.entry, ref.count
        cols = (np.empty(n, np.float32), np.empty(n, np.float32),
                np.empty(n, np.float32), np.empty(n, np.int32))
        if e.kind == "simlod":
            shift = (e.box_min + translation).astype(np.float32)
            mm = np.memmap(e.path, dtype=np.uint8, mode="r",
                           offset=simlod.HEADER_BYTES)
            raw = mm[ref.first * simlod.POINT_BYTES:
                     (ref.first + n) * simlod.POINT_BYTES]
            native.decode_simlod_cols(raw, n, shift, *cols)
            return cols, n * simlod.POINT_BYTES, 0
        hdr = e.header
        bpp = hdr.bytes_per_point
        chunks = 0
        if e.kind == "las":
            mm = np.memmap(e.path, dtype=np.uint8, mode="r",
                           offset=hdr.offset_to_points)
            raw = mm[ref.first * bpp:(ref.first + n) * bpp]
            nbytes = n * bpp
        else:
            rec = np.empty((n, e.laz.record_size), np.uint8)
            chunks = laz.decode_range(e.laz, ref.first, n, rec)
            raw = rec.reshape(-1)
            nbytes = n * 8   # compressed estimate
        native.decode_las_cols(raw, n, bpp, las.RGB_OFFSET.get(hdr.format, -1),
                               hdr.scale, hdr.offset,
                               np.asarray(translation, np.float64), *cols)
        return cols, nbytes, chunks

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
    def _place(self, planes):
        """A filled plane set on its device(s) -> (planes, [(device, event)]).
        On CUDA the copies are issued on each device's side stream and each
        device's event marks them done; CPU planes are used in place. In
        sharded mode each plane becomes its list of per-device blocks."""
        n = len(self.devices)
        w = self.step_points // n
        blocks = [[p[:, s * w:(s + 1) * w] for s in range(n)] if self.sharded
                  else [p] for p in planes]
        events = []
        if self._cuda:
            for d, side in self._sides.items():
                with torch.cuda.stream(side):
                    for bl in blocks:
                        for s in range(n):
                            if self.devices[s] == d:
                                bl[s] = _copy_block(bl[s], d)
                    ev = torch.cuda.Event()
                    ev.record(side)
                events.append((d, ev))
        out = tuple(bl if self.sharded else bl[0] for bl in blocks)
        return out, events

    def _upload(self):
        K, B = self.chunk_steps, self.step_points
        inflight = collections.deque()     # ([(device, event)], pinned planes)
        planes = self._free.get() if self._cuda else self._new_planes(False)
        counts = np.zeros(K, np.int32)
        step = fill = 0
        queued = None       # host clock of the latest plane set queued

        def recycle_one():
            events, pset = inflight.popleft()
            for _, ev in events:
                ev.synchronize()
            self._free.put(pset)

        def flush():
            nonlocal planes, counts, step, fill, queued
            if fill > 0:
                for p in planes:
                    p.numpy()[step, fill:] = 0
                counts[step] = fill
                step, fill = step + 1, 0
            if step == 0:
                return
            with trace.span("stream.stage", self.t_stage):
                for p in planes:
                    p.numpy()[step:] = 0
                out, events = self._place(planes)
            if self._cuda:
                inflight.append((events, planes))
            item = (out, events, counts.copy())
            if not self._put(self._ready, item):
                return
            if queued is None:
                # PointStream's start to its first plane set on `_ready`
                trace.add("stream.first_item",
                          time.perf_counter() - self._t_start)
            queued = time.perf_counter()
            counts = np.zeros(K, np.int32)
            step = 0
            if self._cuda:
                while self._free.empty() and inflight:
                    recycle_one()
                planes = self._free.get()
            else:
                planes = self._new_planes(False)

        def consume(cols, n):
            nonlocal step, fill
            off = 0
            # a stopped stream's flush gives up on its put: stop filling then
            while off < n and not self._stop.is_set():
                take = min(B - fill, n - off)
                # numpy copies, on this thread alone: torch's intra-op
                # threads would take the cores of the loaders' decodes
                with trace.span("stream.stage", self.t_stage):
                    for p, c in zip(planes, cols):
                        p.numpy()[step, fill:fill + take] = c[off:off + take]
                fill += take
                off += take
                if fill == B:
                    counts[step] = B
                    step, fill = step + 1, 0
                    if step == K:
                        flush()

        # batches arrive from several loaders; pack them in file order
        pending, nxt = {}, 0
        while not self._stop.is_set():
            try:
                item = self._loaded.get(timeout=0.1)
            except queue.Empty:
                continue
            if item is None:
                break
            pending[item[0]] = item[1]
            while nxt in pending:
                cols = pending.pop(nxt)
                consume(cols, len(cols[0]))
                nxt += 1
        if not self._stop.is_set():
            if nxt != self._n_batches:
                raise RuntimeError(f"stream lost batches ({nxt} of "
                                   f"{self._n_batches})")
            flush()
            self.t_last_queued = queued
        while inflight:
            recycle_one()
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
        """Stop and join the pipeline threads."""
        self._stop.set()
        for q in (self._loaded, self._ready):
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
        for t in self._loaders:
            t.join(timeout=2.0)
        self._uploader.join(timeout=2.0)

    def stats(self):
        """Points and bytes read so far, and seconds summed over threads: the
        loaders' read and decode (t_decode), the uploader's staging
        (stage_s), the consumer's wait for items (wait_s)."""
        return dict(points_loaded=self.points_loaded, bytes_read=self.bytes_read,
                    laz_chunks=self.laz_chunks,
                    t_decode=round(self.t_decode, 3),
                    stage_s=round(self.t_stage.total, 3),
                    wait_s=round(self.t_wait.total, 3))
