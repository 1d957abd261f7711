"""Engine orchestrator (port of simlod_tpu/engine.py): open files, load them
into the octree, render frames, or do both in every frame.

The reference alternates two kernels per frame on one device: renderCUDA()
then updateOctree() (main_progressive_octree.cpp:1176-1180). `Engine.frame` is
that simultaneous loop: it ingests the next streamed batches and renders the
growing octree, exactly or through the screen-budgeted draw pool
(Settings.point_budget > 0, render/drawpool.py). `Engine.load_all` is the
drag-drop bulk load, `Engine.render` a render-only frame.

Engine policies kept from the JAX package (and the reference):
  - ingest budget per frame: batches per frame adapt to a wall-clock target
    (`frame_budget_ms`; the reference's <= 20 x 1M batches and 10 ms budget,
    voxels.cu:883, :939);
  - capacity watermark: when pools run out the engine stops ingesting and
    reports mem_capacity_reached (reference: voxels.cu:896-912);
  - lazy voxel dedup: the store is compacted near capacity and before a render
    that needs the exact per-node voxel ranges;
  - sample and directory windows sized from the previous frame's counts; the
    draw pool is rebuilt when the octree changed, with bounded staleness while
    streaming.

Where the port departs from the JAX package (the reference draws every
visible sample): an exact fused frame also draws the voxels appended since
the last compaction (render/raster.py `voxel_tail`), as insertVoxels makes
each voxel drawable at once; an exact frame whose read says it truncated is
drawn again at the windows that read asks for (`_checked`); truncation
counts the plans' phase padding; EngineConfig.auto caps the sample windows
at twice the pools in place of 4M.

The JAX package's compile-storm workarounds (AOT preload, stream shape pins,
the XLA cache, the per-state watermark cache) are not part of this port:
PyTorch runs eagerly, and the state is updated in place. Its jitted frame
and build step have counterparts: on the card `render` replays a CUDA graph
per static key (graphs.FrameGraphs), `frame` the draw of an exact fused
frame (a cache of its own, one key), and every build on the engine's state
replays the step's stretches as CUDA graphs (graphs.BuildGraphs); `reset`
keeps the build's and the fused frames' graphs across opens by
re-initialising the state in place.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .config import (EngineConfig, Settings, Stats, UniformBuffer, Uniforms,
                     resolve_device)
from .graphs import BuildGraphs, FrameGraphs
from .io.streaming import PointStream, scan_paths
from .octree import build
from .octree.structures import OctreeState, init_state, reset_state
from .ops import ragged
from .render import camera as camera_mod
from .render import drawpool as drawpool_mod
from .render.raster import tail_buffers, voxel_tail
from .render.render import (FrameStats, frame_key, probe_pooled_counts,
                            render_frame, render_frame_pooled)
from .utils import trace


def _stat_tensors(state: OctreeState, fstats: FrameStats | None) -> dict:
    """The engine counters of Stats as 0-d device tensors (num_points counts
    points stored in leaves, the JAX package's definition; num_points_dropped
    sits beside it)."""
    n_cap = state.child_base.shape[0]
    ids = torch.arange(n_cap, dtype=torch.int32, device=state.device)
    active = ids < state.num_nodes
    leaf = active & (state.child_base < 0)
    i32 = lambda b: b.sum(dtype=torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=state.device)
    return dict(
        num_nodes=state.num_nodes,
        num_inner=i32(active & ~leaf),
        num_leaves=i32(leaf),
        num_nonempty_leaves=i32(leaf & (state.num_points > 0)),
        num_points=torch.where(leaf, state.num_points, zero).sum(
            dtype=torch.int32),
        num_voxels=torch.where(active, state.num_voxels, zero).sum(
            dtype=torch.int32),
        num_voxels_stored=state.vox_used,
        num_visible_nodes=fstats.num_visible_nodes if fstats else zero,
        num_visible_inner=fstats.num_visible_inner if fstats else zero,
        num_visible_leaves=fstats.num_visible_leaves if fstats else zero,
        num_visible_points=fstats.num_visible_points if fstats else zero,
        num_visible_voxels=fstats.num_visible_voxels if fstats else zero,
        num_points_processed=state.num_points_processed,
        num_points_dropped=state.num_points_dropped,
        num_candidates_dropped=state.num_candidates_dropped,
        pool_used=state.pool_used,
        num_segments=state.num_segments,
        mem_capacity_reached=state.mem_capacity_reached,
        render_truncated=fstats.truncated if fstats else zero.bool(),
    )


def _to_stats(values: dict) -> Stats:
    """Stats from the host values of _stat_tensors."""
    out = dict(values)
    for k in ("mem_capacity_reached", "render_truncated"):
        out[k] = bool(out[k])
    return Stats(**out)


# Stats' fields, in the order of _stat_tensors
_STATS = tuple(f.name for f in dataclasses.fields(Stats))


def _stack(tensors) -> torch.Tensor:
    """0-d device integers and bools in one int32 tensor (int64 where one
    is int64), so that one read fetches them all."""
    tensors = list(tensors)
    dt = torch.int64 if any(t.dtype == torch.int64 for t in tensors) \
        else torch.int32
    return torch.stack([t.to(dt) for t in tensors])


# Engine._marks: watermark name -> state field
_MARKS = (("processed", "num_points_processed"), ("vox_used", "vox_used"),
          ("vox_compacted", "vox_compacted"), ("pool_used", "pool_used"),
          ("num_nodes", "num_nodes"), ("num_segments", "num_segments"),
          ("dropped", "num_candidates_dropped"),
          ("mem_cap", "mem_capacity_reached"))


def _marks_of(values: list) -> dict:
    m = dict(zip((k for k, _ in _MARKS), values))
    m["mem_cap"] = bool(m["mem_cap"])
    return m


def _frame_stack(state: OctreeState, fstats: FrameStats) -> torch.Tensor:
    """A frame's visible counts and truncation, the engine counters, the
    watermarks and the frame's window needs and tail rows in one tensor
    (_STATS, _MARKS, then _NEEDS): what _after_frame reads in one device
    read. A frame that counts no need (pooled) gives its visible counts."""
    zero = torch.zeros((), dtype=torch.int32, device=state.device)
    needs = [fstats.need_points, fstats.need_voxels, fstats.need_tail,
             fstats.tail_rows]
    fallback = [fstats.num_visible_points, fstats.num_visible_voxels, zero,
                zero]
    return _stack([*_stat_tensors(state, fstats).values(),
                   *(getattr(state, f) for _, f in _MARKS),
                   *(n if n is not None else f
                     for n, f in zip(needs, fallback))])


# the Stats fields a frame gives (the rest are the engine's counters)
_FRAME_FIELDS = ("num_visible_nodes", "num_visible_inner",
                 "num_visible_leaves", "num_visible_points",
                 "num_visible_voxels", "render_truncated")

# _frame_stack's last entries: the rows of window the frame's points',
# voxels' and tail's plans fill, and the tail rows it drew
_NEEDS = ("points", "voxels", "tail", "tail_rows")


def _fused_chunk_pooled(cfg: EngineConfig, state: OctreeState, width: int,
                        height: int, bx, by, bz, brgba, counts, ppw: int,
                        pvw: int, epw: int, evw: int, nw: int, sw: int,
                        pool, uniforms: Uniforms, graphs: BuildGraphs):
    """A K-step chunk through build_many, then one frame drawn through the
    draw pool. The pool is a snapshot with bounded staleness: nodes it misses
    render through the exact path (drawpool.split_masks), so a stale pool
    costs exact-path time, never samples."""
    state = build.build_many(cfg, state, bx, by, bz, brgba, counts, graphs)
    img, fstats = render_frame_pooled(cfg, state, pool, width, height,
                                      uniforms, ppw, pvw, epw, evw, nw, sw)
    return state, img, fstats


def _pool_need(state: OctreeState, cap: int) -> torch.Tensor:
    """Drawn-sample upper bounds [points, voxels] for the draw-pool copy."""
    return torch.stack([torch.clamp(state.num_points, max=cap).sum(),
                        torch.clamp(state.num_voxels, max=cap).sum()])


def _size_bucket(n: int) -> int:
    """1-8-pow2 size bucket rounded to 128 rows (<= 12.5% pad)."""
    n = max(n, 256)
    b = max((n - 1).bit_length() - 3, 0)
    n = ((n + (1 << b) - 1) >> b) << b
    return ((n + 127) // 128) * 128


def sample_window(n: int, prev: int, cap: int) -> int:
    """1/8-pow2 render sample window with 1.25x headroom; shrinks at most one
    octave per frame (same policy as the JAX package)."""
    n = max(int(n * 1.25) + 1024, 1 << 18, prev >> 1)
    b = max((n - 1).bit_length() - 3, 0)
    return min(((n + (1 << b) - 1) >> b) << b, cap)


# frames the need of an exact frame's sample window stays within half of it
# before the window shrinks (held_window)
WINDOW_SHRINK_FRAMES = 8


def held_window(n: int, prev: int, low: int, cap: int) -> tuple[int, int]:
    """Sample window of an exact frame, held so that a moving camera keeps
    its frame's graph key (the windows are part of it): a power of two (or
    the cap) no smaller than the JAX package's sample_window(n, prev, cap).
    It grows at once to the power of two above the need, and shrinks to the
    power of two below it only once the need has stayed within half of it for
    WINDOW_SHRINK_FRAMES frames in a row. `low` counts those frames so far.
    Returns (window, low)."""
    prev = min(prev, cap)
    need = sample_window(n, 0, cap)
    if need > prev:
        return min(1 << (need - 1).bit_length(), cap), 0
    if 2 * need > prev:
        return prev, 0
    if low + 1 < WINDOW_SHRINK_FRAMES:
        return prev, low + 1
    return 1 << ((prev - 1).bit_length() - 1), 0


def directory_window(n: int, cap: int) -> int:
    """Pow2 directory window from a live watermark (2x headroom)."""
    n = max(2 * n + 64, 4096)
    return min(1 << (n - 1).bit_length(), cap)


class Engine:
    """Holds device state and drives streaming, construction and rendering on
    one torch device: the card unless the caller names another (device="cpu"
    runs the plain PyTorch versions of the kernels)."""

    def __init__(self, cfg: EngineConfig | None = None,
                 settings: Settings | None = None, device=None):
        self.device = resolve_device(device, "Engine")
        # cfg=None: capacities come from device memory and the stream size at
        # open() (the reference sizes its buffer to 80% of free VRAM)
        self._auto_cfg = cfg is None
        self.cfg = cfg or EngineConfig()
        self.settings = settings or Settings()
        self.state: OctreeState | None = None
        self.stream: PointStream | None = None
        self._stream_iter = None
        self.camera = camera_mod.Camera()
        self.orbit = camera_mod.OrbitControls()
        self._transform_update_bound = None
        # render()'s per-frame values live here, and its frames as CUDA
        # graphs (on the card)
        self._uniform_buffer: UniformBuffer | None = None
        self.graphs = FrameGraphs()
        # on the card the draw of an exact fused frame replays a CUDA graph
        # of its own: at the sample windows' caps, over the whole
        # directories and the voxel tail's buffers, one key serves every
        # fused frame of every load on the state (kept across opens)
        self.fused_graphs = FrameGraphs()
        self._tail_out = None
        # the build step's stretches as CUDA graphs (on the card), kept
        # across opens while the state keeps its tensors
        self.build_graphs = BuildGraphs()
        # what an exact frame's windows are held from (_windows), kept
        # across opens: the rows of window the last frame's plans filled
        # (points, voxels, tail), the live directories' sizes, and the held
        # sample windows with the frames their need has stayed low
        self._last_visible = (1 << 20, 1 << 20)
        self._last_tail_need = 0
        self._last_counts = (0, 0)
        self._last_windows = (1 << 20, 1 << 20)
        self._tail_window = 1 << 20
        self._low_frames = (0, 0)
        self._tail_low = 0
        self.reset_counters()

    def reset_counters(self):
        self.last_batch_finished = False
        self._capacity_flag = False
        self._splits_finished = False
        self._consumed_chunks = 0
        self._steps_since_poll = 0
        self._cand_bumps = 0
        self._last_dropped = self._last_processed = 0
        self._batches_per_frame = 1
        self._last_truncated = False
        self._draw_pool = None
        self._pool_key = None
        self._pool_built_pts = -1
        self._pool_rebuild_cost = 0.0
        self._pool_rebuild_t = 0.0
        self._cached_pool_ws = None
        self._pool_ws_age = 0
        self.steps = 0
        self.frames = 0
        self.host_syncs = 0
        # exact frames drawn again after a truncated read, and the tail
        # voxel rows the fused frames drew (t_fused counts those frames)
        self.redraws = 0
        self.tail_rows = 0
        self.t_build = trace.Timings()
        self.t_render = trace.Timings()
        self.t_fused = trace.Timings()
        self.t_pool = trace.Timings()

    # --- lifecycle (reference reset()/reload(), :644-809) ---
    def reset(self, box_min, box_max):
        """Fresh octree over the box. Stops and drops the current stream:
        `open` is the reload path. A state of the config's shapes is
        re-initialised in place (reset_state), so the build graphs keep
        their keys; any other is replaced."""
        if self.stream is not None:
            self.stream.stop()
        self.stream = None
        self._stream_iter = None
        # the frames' keys hold the windows of the old octree: free their
        # memory pools
        self.graphs.clear()
        if self.state is None or not reset_state(self.state, self.cfg,
                                                 box_min, box_max):
            # no build or fused-frame graph can replay on a new state
            self.build_graphs.clear()
            self.fused_graphs.clear()
            self._tail_out = None
            self.state = None       # free the old state before the new
            self.state = init_state(self.cfg, box_min, box_max, self.device)
        self.reset_counters()
        if self.settings.auto_focus_on_load:
            self.orbit.focus_box(np.zeros(3),
                                 np.asarray(box_max) - np.asarray(box_min))
            self.camera.world = self.orbit.world()

    def open(self, paths, chunk_steps: int | None = None,
             box_override=None) -> PointStream:
        """Scan files, reset the octree to their union box (or to
        box_override = (min, max): an out-of-core brick's world box), start
        streaming. chunk_steps overrides cfg.steps_per_dispatch for this
        stream only (frame-loop pacing: steps per streamed item)."""
        with trace.span("engine.open"):
            if self._auto_cfg:
                with trace.span("open.config"):
                    total = sum(e.num_points for e in scan_paths(paths))
                    self.cfg = EngineConfig.auto(total_points=total,
                                                 device=self.device)
            with trace.span("open.stream"):
                stream = PointStream(
                    paths, self.cfg.step_points, device=self.device,
                    chunk_steps=chunk_steps if chunk_steps is not None
                    else self.cfg.steps_per_dispatch,
                    box_override=box_override)
            box = stream.box_max - stream.box_min
            with trace.span("open.state"):
                self.reset(np.zeros(3, np.float32), box.astype(np.float32))
            self.stream = stream
            self._stream_iter = iter(stream)
            self._last_paths = list(paths)  # the viewer's "Reset + Benchmark"
            return stream

    # --- construction ---
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _read(self, site: str, tensors) -> list:
        """Device scalars (or one stacked tensor of them) -> Python numbers
        in one device read at `site` (trace.sync, counted)."""
        if not isinstance(tensors, torch.Tensor):
            tensors = _stack(tensors)
        return self._counted(trace.sync, site, tensors)

    def _counted(self, fn, *args):
        """fn(*args), adding the device reads it makes to host_syncs."""
        reads = trace.reads()
        try:
            return fn(*args)
        finally:
            self.host_syncs += trace.reads() - reads

    def ingest(self, x, y, z, rgba, count: int, sync: bool = True) -> None:
        """One build step (build_step: no in-loop compaction); with sync the
        host-side compaction policy runs after and the device is waited on."""
        t0 = time.perf_counter()
        self.state = self._counted(build.build_step, self.cfg, self.state, x,
                                   y, z, rgba, int(count), self.build_graphs)
        self.steps += 1
        self._steps_since_poll += 1
        if sync:
            self._maybe_compact()
            self._sync()
            self.t_build.add(time.perf_counter() - t0)

    def ingest_chunk(self, item, sync: bool = True) -> None:
        """Ingest one [K, B] chunk of steps with one build_many call (which
        compacts at the watermark); sync as in `ingest`."""
        t0 = time.perf_counter()
        bx, by, bz, bc, counts = item
        self.state = self._counted(build.build_many, self.cfg, self.state, bx,
                                   by, bz, bc, counts, self.build_graphs)
        self.steps += bx.shape[0]
        self._steps_since_poll += bx.shape[0]
        if sync:
            self._maybe_compact()
            self._sync()
            self.t_build.add(time.perf_counter() - t0)

    def _ingest_item(self, item, sync: bool) -> None:
        """A streamed item through the build the JAX package gives it: a
        one-step stream's items are single batches (build_step), a K-step
        stream's items are chunks (build_many)."""
        if self.stream.chunk_steps == 1:
            x, y, z, rgba, counts = item
            self.ingest(x[0], y[0], z[0], rgba[0], int(counts[0]), sync=sync)
        else:
            self.ingest_chunk(item, sync=sync)

    def _next_item(self):
        item = next(self._stream_iter, None)
        if item is not None:
            self._consumed_chunks += 1
        return item

    def ingest_next(self) -> bool:
        """Ingest the next streamed item; False once the stream is done (then
        the end-of-load split convergence has run). The capacity flag is the
        one cached on the compaction poll's cadence."""
        if self.stream is None:
            return False
        if self._capacity_flag:
            # the reference treats capacity-reached as end of load (:1216-1219)
            self._end_of_stream()
            return False
        item = self._next_item()
        if item is None:
            self._end_of_stream()
            return False
        self._ingest_item(item, sync=True)
        return True

    def load_all(self, poll_every: int | None = None,
                 bulk: bool | None = None) -> None:
        """Consume the entire stream (the reference's drag-drop load),
        dispatching each streamed item's build as it arrives, so the card
        builds while the file still streams (span `load.item` an item).

        Bulk path (default when the file fits the point pool): every item
        through build_many (`ingest_chunk`, one-step streams too), which
        compacts the voxel store in-loop at its watermark, and nothing read
        between items: the steps, their order and the compactions are those
        of one build_many over the whole stream. Chunked path (bulk=False, a
        partly consumed stream, or a file larger than the point pool): each
        item through the build its stream gives it (`_ingest_item`), with a
        capacity poll every `poll_every` items."""
        if self.stream is None:
            return
        with trace.span("engine.load_all", self.t_build):
            if bulk is None:
                bulk = (self._consumed_chunks == 0
                        and self.stream.total_points
                        <= self.cfg.point_capacity)
            if not bulk and poll_every is None:
                poll_every = 1 if self.cfg.estimated_state_bytes() \
                    > (1 << 30) else 4
            built = []      # (host clock, seconds) of each item's build call
            while (item := self._next_item()) is not None:
                t0 = time.perf_counter()
                with trace.span("load.item"):
                    if bulk:
                        self.ingest_chunk(item, sync=False)
                    else:
                        self._ingest_item(item, sync=False)
                built.append((t0, time.perf_counter() - t0))
                if not bulk and len(built) % poll_every == 0:
                    self._maybe_compact(poll=True)
                    if self._capacity_flag:
                        break
            self.last_batch_finished = True
            self._count_overlapped(built, ended=item is None)
            self._splits_finished = True
            self.finish_splits()
            self._capacity_flag = bool(self._read(
                "engine.capacity", [self.state.mem_capacity_reached])[0])
            self._steps_since_poll = 0

    def _count_overlapped(self, built: list, ended: bool) -> None:
        """A `load.item_overlapped` span (the item's build seconds) for each
        item of `built` whose build was dispatched before the stream's
        uploader had queued its last plane set. The stream's last item
        (`ended`: the stream has ended) never was; a stream that has not
        ended has not queued its last set yet."""
        last = self.stream.t_last_queued
        for t0, dt in built[:-1] if ended else built:
            if last is None or t0 < last:
                trace.add("load.item_overlapped", dt)

    def _end_of_stream(self) -> None:
        """Stream drained (or capacity reached): run the one-time end-of-load
        split convergence on every consumption path (load_all, ingest_next,
        frame)."""
        self.last_batch_finished = True
        if not self._splits_finished:
            self._splits_finished = True
            self.finish_splits()

    def finish_splits(self, max_rounds: int = 32) -> int:
        """End-of-load split convergence: split leaves still over the threshold
        (round-1 budgets may have deferred them) until none is; returns the
        rounds run."""
        rounds = 0
        with trace.span("build.finish"):
            while rounds < max_rounds:
                ids, n = build.overfull_leaf_ids(self.cfg, self.state)
                if self._read("engine.overfull", n) == 0:
                    break
                self.state = self._counted(build.split_finish, self.cfg,
                                           self.state, ids)
                rounds += 1
        return rounds

    def _marks(self) -> dict:
        """All host-side watermarks in one device read. Not cached: the state
        is updated in place, so the same object's watermarks change."""
        return _marks_of(self._read("engine.marks", [getattr(self.state, f)
                                                     for _, f in _MARKS]))

    def _maybe_compact(self, force: bool = False, poll: bool = False,
                       marks: dict | None = None) -> dict | None:
        """Capacity poll + near-capacity voxel compaction (renders that need the
        exact voxel ranges force it). Without force or poll it acts every 4
        steps. `marks`: the watermarks as the caller read them, reused (no
        read of its own); they are read again only after a compaction.
        Returns the current watermarks (None where it did not act and was
        given none)."""
        if not (force or poll) and self._steps_since_poll < 4:
            return marks
        self._steps_since_poll = 0
        m = marks if marks is not None else self._marks()
        self._capacity_flag = m["mem_cap"]
        self._adapt_candidate_windows(m)
        threshold = int(self.cfg.voxel_capacity * self.cfg.voxel_compact_watermark)
        if force or m["vox_used"] > threshold:
            self.state = self._counted(build.compact_voxels_auto, self.cfg,
                                       self.state, m["vox_used"])
            m = self._marks()
            seg_limit = min(self.cfg.seg_scan_window,
                            self.cfg.segment_capacity) // 2
            if m["num_segments"] > seg_limit:
                self.state = self._counted(build.compact_segments,
                                           self.cfg, self.state)
                m = self._marks()
        return m

    def _adapt_candidate_windows(self, m: dict):
        """Upsize the multi-level candidate window under sustained drops (more
        than 1% of the points ingested since the last poll; two bumps max);
        `m` holds the current watermarks."""
        dropped, processed = m["dropped"], m["processed"]
        d_drop = dropped - self._last_dropped
        d_proc = processed - self._last_processed
        self._last_dropped, self._last_processed = dropped, processed
        if self._cand_bumps >= 2 or d_proc <= 0 or d_drop * 100 < d_proc:
            return
        self._cand_bumps += 1
        cur = self.cfg.cand_multi_rows or self.cfg.step_points // 4
        steps = max(d_proc // max(self.cfg.step_points, 1), 1)
        need = cur + (d_drop + steps - 1) // steps
        need = max(2 * cur, int(need * 1.25))
        need = 1 << (need - 1).bit_length()
        cap = self.cfg.step_points + self.cfg.spill_capacity
        self.cfg = dataclasses.replace(self.cfg,
                                       cand_multi_rows=min(need, cap))

    def filter_colors(self) -> None:
        """Bottom-up voxel colour filtering (reference colorfilter.cu; see
        octree/colorfilter.py). Compacts first for an exact CSR. Drops the draw
        pool, which holds its own copy of the voxel colours and whose key does
        not change with them."""
        from .octree import colorfilter
        self._maybe_compact(force=True)
        self.state = self._counted(colorfilter.filter_colors, self.cfg,
                                   self.state)
        self._draw_pool = None
        self._pool_key = None

    # --- rendering ---
    def _transforms(self, width: int, height: int):
        """The camera's transform and the frozen visibility transform."""
        self.camera.width, self.camera.height = width, height
        self.camera.fovy = self.settings.fovy
        t = self.camera.transform()
        if self.settings.do_update_visibility or self._transform_update_bound is None:
            self._transform_update_bound = t
        return t, self._transform_update_bound

    def uniforms(self, width: int, height: int) -> Uniforms:
        """This frame's Uniforms in tensors of their own."""
        return Uniforms.make(width, height, *self._transforms(width, height),
                             self.settings, device=self.device)

    def _frame_uniforms(self, width: int, height: int) -> Uniforms:
        """This frame's Uniforms in the engine's persistent uniform buffer
        (one small copy to the device): the tensors a captured frame reads
        keep their pointers from frame to frame."""
        if self._uniform_buffer is None:
            self._uniform_buffer = UniformBuffer(self.device)
        return self._uniform_buffer.write(
            width, height, *self._transforms(width, height), self.settings)

    def _windows(self):
        """Sample windows held from the rows of window the previous frames'
        plans filled (held_window; at least their visible counts), and
        directory windows from the live watermarks -> (points, voxels,
        nodes, segments, tail)."""
        cfg = self.cfg
        (pv, vv), (ppw, pvw) = self._last_visible, self._last_windows
        lp, lv = self._low_frames
        pw, lp = held_window(pv, ppw, lp, cfg.max_render_points)
        vw, lv = held_window(vv, pvw, lv, cfg.max_render_voxels)
        tw, self._tail_low = held_window(self._last_tail_need,
                                         self._tail_window, self._tail_low,
                                         cfg.max_render_voxels)
        self._last_windows, self._low_frames = (pw, vw), (lp, lv)
        self._tail_window = tw
        nn, ns = self._last_counts
        nw = directory_window(nn, cfg.node_capacity)
        sw = directory_window(ns, cfg.segment_capacity)
        self.last_windows = (pw, vw, nw, sw)
        return (*self.last_windows, tw)

    def _grown_windows(self):
        """The windows the last frame's read asks for, after it truncated:
        each sample window grown at once past its plan's need (held_window),
        the directory windows from the live counts; held from here on. None
        where no window can grow (at the caps)."""
        cfg = self.cfg
        (pv, vv), (ppw, pvw) = self._last_visible, self._last_windows
        pw = held_window(pv, ppw, 0, cfg.max_render_points)[0]
        vw = held_window(vv, pvw, 0, cfg.max_render_voxels)[0]
        tw = held_window(self._last_tail_need, self._tail_window, 0,
                         cfg.max_render_voxels)[0]
        nn, ns = self._last_counts
        nw = directory_window(nn, cfg.node_capacity)
        sw = directory_window(ns, cfg.segment_capacity)
        grown = (pw, vw, nw, sw, tw)
        if grown == (*self.last_windows, self._tail_window):
            return None
        self._last_windows, self._low_frames = (pw, vw), (0, 0)
        self._tail_window, self._tail_low = tw, 0
        self.last_windows = grown[:4]
        return grown

    def _after_frame(self, stack: torch.Tensor):
        """One device read after a frame, of its _frame_stack: its visible
        counts and truncation, the engine counters, the watermarks and the
        window needs -> (Stats, watermarks, tail rows drawn); notes what the
        next frame's windows are sized from."""
        host = self._read("engine.frame", stack)
        n, m = len(_STATS), len(_MARKS)
        stats = _to_stats(dict(zip(_STATS, host)))
        need = dict(zip(_NEEDS, host[n + m:]))
        self._last_visible = (max(need["points"], stats.num_visible_points),
                              max(need["voxels"], stats.num_visible_voxels))
        self._last_tail_need = need["tail"]
        self._last_truncated = stats.render_truncated
        self._last_counts = (stats.num_nodes, stats.num_segments)
        return stats, _marks_of(host[n:n + m]), need["tail_rows"]

    def _checked(self, draw, img, stack):
        """An exact frame's read, and while it says the frame truncated, the
        same state drawn again at the windows its counts ask for (span
        `frame.redraw`, counted in `redraws`) -> (image, Stats,
        watermarks, tail rows drawn). `draw(*windows)` draws the frame at
        (points, voxels, nodes, segments, tail) windows -> (image, stack)."""
        stats, m, tail_rows = self._after_frame(stack)
        while stats.render_truncated:
            windows = self._grown_windows()
            if windows is None:
                break
            with trace.span("frame.redraw"):
                img, stack = draw(*windows)
                stats, m, tail_rows = self._after_frame(stack)
            self.redraws += 1
        return img, stats, m, tail_rows

    def _stats(self, fstats: FrameStats | None) -> Stats:
        """The engine counters as Python values, in one device read."""
        vals = _stat_tensors(self.state, fstats)
        return _to_stats(dict(zip(vals, self._read("engine.stats",
                                                   vals.values()))))

    # --- draw pool (screen-budgeted decimation, render/drawpool.py) ---
    def _ensure_draw_pool(self, m: dict) -> None:
        """(Re)build the draw pool when the octree changed since the last
        build. Callers have already compacted (the pool reads the exact voxel
        ranges) and pass the watermarks `m` they read since."""
        key = (m["processed"], m["num_nodes"], m["vox_compacted"])
        if self._draw_pool is not None and self._pool_key == key:
            return
        cap = self.cfg.draw_cap
        pool_w = _size_bucket(ragged.window_for(m["pool_used"],
                                                max(m["num_segments"], 1)))
        vox_w = min(_size_bucket(max(m["vox_compacted"], 128)),
                    (self.state.vox_k0.shape[0] // 128) * 128)
        node_w = directory_window(m["num_nodes"], self.cfg.node_capacity)
        pc_need, vc_need = self._read("engine.pool_need",
                                      _pool_need(self.state, cap))
        live_nodes = m["num_nodes"]
        pc = _size_bucket(pc_need + 256 * live_nodes + 128)
        vc = _size_bucket(vc_need + 256 * live_nodes + 128)
        self._draw_pool = None    # free the old copy before building the new
        self._draw_pool = drawpool_mod.build_draw_pool(
            self.cfg, self.state, pool_w, vox_w, node_w, cap, pc, vc)
        self._pool_key = key

    def _pooled_windows(self, u: Uniforms):
        pp, pv, ep, ev = self._read("engine.pool_probe", probe_pooled_counts(
            self.cfg, self.state, self._draw_pool, u))
        prev = getattr(self, "_last_pool_windows", (1 << 18,) * 4)
        ws = tuple(sample_window(n, p, cap) for n, p, cap in zip(
            (pp, pv, ep, ev), prev,
            (self.cfg.max_render_points, self.cfg.max_render_voxels,
             self.cfg.max_render_points, self.cfg.max_render_voxels)))
        self._last_pool_windows = ws
        return ws

    def _pooled_windows_cached(self, u: Uniforms, force: bool = False):
        """Re-probe the pooled windows only when they are missing or 8 frames
        old, the pool was rebuilt (force), or the last frame truncated (the
        probe undercounted); otherwise reuse them."""
        ws = self._cached_pool_ws
        self._pool_ws_age += 1
        if ws is None or force or self._pool_ws_age >= 8 \
                or self._last_truncated:
            ws = self._pooled_windows(u)
            self._cached_pool_ws = ws
            self._pool_ws_age = 0
        return ws

    def _ensure_stream_pool(self):
        """Draw-pool rebuild policy of the simultaneous loop: rebuild when the
        pool is missing, or when more than a quarter of the processed points
        (and at least one step) postdate it AND at most a quarter of wall-clock
        time goes to rebuilds (a rebuild is a forced compaction + a sort of the
        whole point pool). Nodes the pool misses render exactly meanwhile.
        Returns (whether a rebuild happened, the current watermarks)."""
        m = self._marks()
        pts = m["processed"]
        built = self._pool_built_pts
        if self._draw_pool is not None and built >= 0:
            if pts - built <= max(built // 4, self.cfg.step_points):
                return False, m
            if time.perf_counter() - self._pool_rebuild_t \
                    < 4.0 * self._pool_rebuild_cost:
                return False, m
        t0 = time.perf_counter()
        # the pool reads the exact voxel ranges: fold in tail appends first
        m = self._maybe_compact(force=m["vox_used"] > m["vox_compacted"],
                                marks=m)
        self._ensure_draw_pool(m)
        self._sync()
        self._pool_rebuild_cost = time.perf_counter() - t0
        self._pool_rebuild_t = time.perf_counter()
        self._pool_built_pts = pts
        self.t_pool.add(self._pool_rebuild_cost)
        return True, m

    def _pooled_args(self, u: Uniforms, force: bool, m: dict):
        """(pool_pw, pool_vw, exact_pw, exact_vw, node_window, seg_window) of a
        pooled frame; kept as last_pooled_windows."""
        ws = self._pooled_windows_cached(u, force=force)
        nw = directory_window(m["num_nodes"], self.cfg.node_capacity)
        sw = directory_window(m["num_segments"], self.cfg.segment_capacity)
        self.last_pooled_windows = (*ws, nw, sw)
        return self.last_pooled_windows

    def render(self, width: int, height: int):
        """Render-only frame -> (image i32 [H, W] (u32 abgr bits), Stats);
        through the draw pool when settings.point_budget > 0 (span
        `engine.render`). Two device reads (the watermarks before, the
        counters after), more only after a compaction, a pool rebuild, a
        window re-probe or a truncated exact frame, which is drawn again at
        the windows its counts ask for (`_checked`).

        On the card the frame's span (render_frame or render_frame_pooled,
        then the Stats tensors) runs through `self.graphs`: eagerly and then
        recorded as a CUDA graph on the first frame of its key
        (render.frame_key), replayed on every later one; the image returned
        is a copy. On the CPU the span runs eagerly."""
        with trace.span("engine.render"):
            return self._render(width, height, graphed=True)

    def _render(self, width: int, height: int, graphed: bool):
        """render(); `graphed` False draws the frame eagerly on the card as
        well (a frame drawn once: no graph to record)."""
        # an exact voxel CSR needs every tail append folded in
        m = self._marks()
        m = self._maybe_compact(force=m["vox_used"] > m["vox_compacted"],
                                marks=m)
        u = self._frame_uniforms(width, height)
        t0 = time.perf_counter()
        cfg, state = self.cfg, self.state
        if self.settings.point_budget > 0:
            key_before = self._pool_key
            self._ensure_draw_pool(m)
            args = self._pooled_args(u, self._pool_key != key_before, m)
            pool = self._draw_pool

            def span():
                img, fstats = render_frame_pooled(cfg, state, pool, width,
                                                  height, u, *args)
                return img, _frame_stack(state, fstats)
            img, stack = self._run_graph(cfg, width, height, args, u, pool,
                                         span, graphed)
            self._sync()
            self.t_render.add(time.perf_counter() - t0)
            stats = self._after_frame(stack)[0]
        else:
            def draw(pw, vw, nw, sw, tw):
                args = (pw, vw, nw, sw)

                def span():
                    img, fstats = render_frame(cfg, state, width, height, u,
                                               *args)
                    return img, _frame_stack(state, fstats)
                return self._run_graph(cfg, width, height, args, u, None,
                                       span, graphed)
            img, stack = draw(*self._windows())
            self._sync()
            self.t_render.add(time.perf_counter() - t0)
            img, stats = self._checked(draw, img, stack)[:2]
        self.frames += 1
        return img, stats

    def _run_graph(self, cfg, width: int, height: int, args, u: Uniforms,
                   pool, span, graphed: bool, tail=None, graphs=None):
        """span() of a frame's draw: with `graphed` through `graphs`
        (`self.graphs` unless given) on the card (its image a copy), else
        eagerly."""
        graphs = self.graphs if graphs is None else graphs
        if not (graphed and graphs.applies(self.device)):
            return span()
        img, stack = graphs.run(
            frame_key(cfg, width, height, args, u, self.state, pool, tail),
            span, self.device)
        return img.clone(), stack    # the next replay overwrites the graph's

    def _voxel_tail(self, graphed: bool):
        """The state's voxel tail grouped by node for a fused frame (span
        `frame.tail`; one device read of the watermarks), with `graphed` in
        the engine's tail buffers; None when every stored voxel is
        compacted."""
        with trace.span("frame.tail"):
            used, compacted = self._read("engine.tail", [
                self.state.vox_used, self.state.vox_compacted])
            if graphed and self._tail_out is None and used > compacted:
                self._tail_out = tail_buffers(self.state)
            return voxel_tail(self.state, compacted, used,
                              self._tail_out if graphed else None)

    def frame(self, width: int, height: int):
        """One simultaneous frame: ingest + render (the reference's per-frame
        renderCUDA + updateOctree, main_progressive_octree.cpp:1176-1180) ->
        (image, Stats); span `engine.frame`.

        Batches consumed per frame adapt to settings.frame_budget_ms (the host
        analogue of the construct kernel's 10 ms / <= 20-batch self-limit,
        progressive_octree_voxels.cu:22,883,939-949): the items are built
        (`frame.build`), then the frame is drawn (`frame.draw`), all inside
        `frame.fused`. An exact fused frame draws every voxel stored so far:
        the compacted CSR and, through a per-node CSR of the tail prepared
        after the build (`frame.tail`), the rows appended since the last
        compaction, as the reference's insertVoxels makes each voxel
        drawable at once. On the card the draw replays a CUDA graph
        (`self.fused_graphs`) at the sample windows' caps over the whole
        directories and the tail's buffers, so that one key serves every
        fused frame; elsewhere it runs eagerly at the held windows, and a
        truncated frame is drawn again at the windows its counts ask for
        (`_checked`). Once the stream is drained or capacity is reached, the
        frame is render-only and the end-of-load split convergence has run;
        the frame in which that is found is drawn eagerly, the later ones
        through `self.graphs` (as `render`)."""
        with trace.span("engine.frame"):
            return self._frame(width, height)

    def _frame(self, width: int, height: int):
        items = []
        streaming = self.stream is not None and not self.last_batch_finished
        if streaming:
            if self._marks()["mem_cap"]:
                self.last_batch_finished = True
            else:
                for _ in range(max(1, self._batches_per_frame)):
                    item = self._next_item()
                    if item is None:
                        self.last_batch_finished = True
                        break
                    items.append(item)
        if not items:
            if self.stream is not None:
                self._end_of_stream()
            # the frame a load ends on is drawn once (a compaction precedes
            # it, and the next load's builds follow): no graph to record
            with trace.span("engine.render"):
                return self._render(width, height, graphed=not streaming)
        with trace.span("frame.fused"):
            img, stats, m, dt = self._fused(width, height, items)
        self.t_fused.add(dt)
        # _maybe_compact hands the caller's watermarks back unless it
        # compacted
        changed = self._maybe_compact(marks=m) is not m
        if self.last_batch_finished:
            changed |= not self._splits_finished
            self._end_of_stream()
        self.frames += 1
        if changed:
            # the state changed after the frame: count it again
            stats = dataclasses.replace(
                self._stats(None),
                **{k: getattr(stats, k) for k in _FRAME_FIELDS})
        return img, stats

    def _fused(self, width: int, height: int, items: list):
        """Build the frame's items and draw the frame -> (image, Stats,
        watermarks, seconds of the build and the first draw)."""
        t0 = time.perf_counter()
        cfg = self.cfg
        if self.settings.point_budget > 0:
            u = self.uniforms(width, height)
            with trace.span("frame.build"):
                for it in items[:-1]:
                    self._ingest_item(it, sync=False)
            bx, by, bz, bc, counts = items[-1]
            # a one-step item rides as a K=1 chunk, through build_many
            rebuilt, m = self._ensure_stream_pool()
            args = self._pooled_args(u, rebuilt, m)
            self.state, img, fstats = self._counted(
                _fused_chunk_pooled, cfg, self.state, width, height, bx, by,
                bz, bc, counts, *args, self._draw_pool, u, self.build_graphs)
            k = bx.shape[0]
            self.steps += k
            self._steps_since_poll += k
            self._sync()
            dt = time.perf_counter() - t0
            self._adapt_budget(dt * 1e3, len(items))
            stats, m, _ = self._after_frame(_frame_stack(self.state, fstats))
            return img, stats, m, dt
        with trace.span("frame.build"):
            for it in items:
                self._ingest_item(it, sync=False)
        graphed = self.fused_graphs.applies(self.device)
        tail = self._voxel_tail(graphed)
        state = self.state
        windows = self._windows()
        if graphed:
            # the caps hold every stored sample: no frame truncates, and
            # the key holds while the octree grows
            windows = (cfg.max_render_points, cfg.max_render_voxels, None,
                       None, cfg.max_render_voxels)
        u = self._frame_uniforms(width, height)

        def draw(pw, vw, nw, sw, tw):
            def span():
                img, fstats = render_frame(cfg, state, width, height, u, pw,
                                           vw, nw, sw, tail, tw)
                return img, _frame_stack(state, fstats)
            return self._run_graph(cfg, width, height, (pw, vw, nw, sw, tw),
                                   u, None, span, graphed, tail,
                                   self.fused_graphs)
        with trace.span("frame.draw"):
            img, stack = draw(*windows)
            self._sync()
        dt = time.perf_counter() - t0
        self._adapt_budget(dt * 1e3, len(items))
        if graphed:
            stats, m, tail_rows = self._after_frame(stack)
        else:
            img, stats, m, tail_rows = self._checked(draw, img, stack)
        self.tail_rows += tail_rows
        return img, stats, m, dt

    def _adapt_budget(self, frame_ms: float, consumed: int):
        """Grow/shrink batches-per-frame toward settings.frame_budget_ms, one
        batch at a time (the reference caps at 20 batches per frame); a budget
        of 0 pins one batch per frame."""
        budget = self.settings.frame_budget_ms
        bpf = max(1, self._batches_per_frame)
        if budget <= 0:
            self._batches_per_frame = 1
            return
        per_batch = frame_ms / max(consumed, 1)
        target = max(1, int(budget / max(per_batch, 1e-3)))
        if target > bpf:
            bpf += 1
        elif target < bpf:
            bpf -= 1
        self._batches_per_frame = min(max(bpf, 1),
                                      self.cfg.max_batches_per_frame)

    # --- reporting (reference stats table, :1484-1583) ---
    def report(self) -> dict:
        out = dataclasses.asdict(self._stats(None))
        out["timings"] = dict(build=self.t_build.row(),
                              render=self.t_render.row(),
                              fused=self.t_fused.row(),
                              pool=self.t_pool.row())
        out["host_syncs"] = self.host_syncs
        out["steps"] = self.steps
        out["frames"] = self.frames
        if self.stream is not None:
            out["stream"] = self.stream.stats()
        return out
