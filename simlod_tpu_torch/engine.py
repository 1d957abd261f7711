"""Engine orchestrator (port of the bulk-load and render path of
simlod_tpu/engine.py): open files, load them into the octree, render frames.

Engine policies kept from the JAX package (and the reference):
  - capacity watermark: when pools run out the engine reports
    mem_capacity_reached (reference: voxels.cu:896-912);
  - lazy voxel dedup: the store is compacted near capacity and before a render
    that needs the exact per-node voxel ranges;
  - sample and directory windows sized from the previous frame's counts.

The simultaneous loop (`frame`, `ingest_next`, fused ingest+render), the draw
pool and the JAX package's compile-storm workarounds (AOT preload, stream shape
pins, the XLA cache) are not part of this port; PyTorch runs eagerly.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .config import EngineConfig, Settings, Stats, Uniforms
from .io.streaming import PointStream, scan_paths
from .octree import build
from .octree.structures import OctreeState, init_state
from .render import camera as camera_mod
from .render.render import FrameStats, render_frame


def _collect_stats(cfg: EngineConfig, state: OctreeState,
                   fstats: FrameStats | None) -> Stats:
    """Engine counters as Python values (one device read for all of them).
    num_points counts points stored in leaves (the JAX package's definition);
    num_points_dropped sits beside it."""
    n_cap = state.child_base.shape[0]
    ids = torch.arange(n_cap, dtype=torch.int32, device=state.device)
    active = ids < state.num_nodes
    leaf = active & (state.child_base < 0)
    i32 = lambda b: b.sum(dtype=torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=state.device)
    vals = dict(
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
    host = torch.stack([v.to(torch.int64) for v in vals.values()]).tolist()
    out = dict(zip(vals, host))
    for k in ("mem_capacity_reached", "render_truncated"):
        out[k] = bool(out[k])
    return Stats(**out)


@dataclasses.dataclass
class Timings:
    """min/max/avg accumulator (reference benchmark mode, :234-246)."""

    count: int = 0
    total: float = 0.0
    min: float = float("inf")
    max: float = 0.0

    def add(self, dt: float):
        self.count += 1
        self.total += dt
        self.min = min(self.min, dt)
        self.max = max(self.max, dt)

    @property
    def avg(self) -> float:
        return self.total / self.count if self.count else 0.0

    def row(self) -> dict:
        return dict(count=self.count, avg_ms=self.avg * 1e3,
                    min_ms=self.min * 1e3 if self.count else 0.0,
                    max_ms=self.max * 1e3)


def sample_window(n: int, prev: int, cap: int) -> int:
    """1/8-pow2 render sample window with 1.25x headroom; shrinks at most one
    octave per frame (same policy as the JAX package)."""
    n = max(int(n * 1.25) + 1024, 1 << 18, prev >> 1)
    b = max((n - 1).bit_length() - 3, 0)
    return min(((n + (1 << b) - 1) >> b) << b, cap)


def directory_window(n: int, cap: int) -> int:
    """Pow2 directory window from a live watermark (2x headroom)."""
    n = max(2 * n + 64, 4096)
    return min(1 << (n - 1).bit_length(), cap)


class Engine:
    """Holds device state and drives streaming, construction and rendering on
    an explicit torch device."""

    def __init__(self, cfg: EngineConfig | None = None,
                 settings: Settings | None = None, device=None):
        self.device = torch.device(device if device is not None else "cpu")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"Engine(device={self.device}): no CUDA device "
                               "is available")
        # cfg=None: capacities come from device memory and the stream size at
        # open() (the reference sizes its buffer to 80% of free VRAM)
        self._auto_cfg = cfg is None
        self.cfg = cfg or EngineConfig()
        self.settings = settings or Settings()
        self.state: OctreeState | None = None
        self.stream: PointStream | None = None
        self.camera = camera_mod.Camera()
        self.orbit = camera_mod.OrbitControls()
        self._transform_update_bound = None
        self.reset_counters()

    def reset_counters(self):
        self.last_batch_finished = False
        self._capacity_flag = False
        self._consumed_chunks = 0
        self._steps_since_poll = 0
        self._cand_bumps = 0
        self._last_dropped = self._last_processed = 0
        self.steps = 0
        self.host_syncs = 0
        self.t_build = Timings()
        self.t_render = Timings()

    # --- lifecycle (reference reset()/reload(), :644-809) ---
    def reset(self, box_min, box_max):
        if self.stream is not None:
            self.stream.stop()
        self.state = init_state(self.cfg, box_min, box_max, self.device)
        self.reset_counters()
        if self.settings.auto_focus_on_load:
            self.orbit.focus_box(np.zeros(3),
                                 np.asarray(box_max) - np.asarray(box_min))
            self.camera.world = self.orbit.world()

    def open(self, paths, chunk_steps: int | None = None) -> PointStream:
        """Scan files, reset the octree to their union box, start streaming."""
        if self._auto_cfg:
            total = sum(e.num_points for e in scan_paths(paths))
            self.cfg = EngineConfig.auto(total_points=total, device=self.device)
        stream = PointStream(
            paths, self.cfg.step_points, device=self.device,
            chunk_steps=chunk_steps if chunk_steps is not None
            else self.cfg.steps_per_dispatch)
        box = stream.box_max - stream.box_min
        self.reset(np.zeros(3, np.float32), box.astype(np.float32))
        self.stream = stream
        self._stream_iter = iter(stream)
        return stream

    # --- construction ---
    def ingest_chunk(self, item) -> None:
        """Ingest one [K, B] chunk of steps (no capacity poll)."""
        bx, by, bz, bc, counts = item
        syncs = build.host_syncs
        self.state = build.build_many(self.cfg, self.state, bx, by, bz, bc,
                                      counts)
        self.host_syncs += build.host_syncs - syncs
        self.steps += bx.shape[0]
        self._steps_since_poll += bx.shape[0]

    def load_all(self, poll_every: int | None = None,
                 bulk: bool | None = None) -> None:
        """Consume the entire stream (the reference's drag-drop load).

        Bulk path (default when the file fits the point pool): take every
        uploaded chunk, then build them all with one build_many call, which
        compacts the voxel store in-loop at its watermark. Chunked path
        (bulk=False, a partly consumed stream, or a file larger than the point
        pool): one build_many per chunk with a capacity poll every
        `poll_every` chunks."""
        if self.stream is None:
            return
        t0 = time.perf_counter()
        if bulk is None:
            bulk = (self._consumed_chunks == 0
                    and self.stream.total_points <= self.cfg.point_capacity)
        if bulk:
            items = list(self._stream_iter)
            self._consumed_chunks += len(items)
            self.last_batch_finished = True
            if items:
                planes = [torch.cat([it[i] for it in items]) for i in range(4)]
                counts = np.concatenate([it[4] for it in items])
                del items
                self.ingest_chunk((*planes, counts))
                del planes
        else:
            if poll_every is None:
                poll_every = 1 if self.cfg.estimated_state_bytes() > (1 << 30) \
                    else 4
            for item in self._stream_iter:
                self._consumed_chunks += 1
                self.ingest_chunk(item)
                if self._consumed_chunks % poll_every == 0:
                    self._maybe_compact(poll=True)
                    if self._capacity_flag:
                        break
            self.last_batch_finished = True
        self.finish_splits()
        self._capacity_flag = bool(self.state.mem_capacity_reached)
        self._steps_since_poll = 0
        self.t_build.add(time.perf_counter() - t0)

    def finish_splits(self, max_rounds: int = 32) -> int:
        """End-of-load split convergence: split leaves still over the threshold
        (round-1 budgets may have deferred them) until none is; returns the
        rounds run."""
        syncs = build.host_syncs
        rounds = 0
        while rounds < max_rounds:
            ids, n = build.overfull_leaf_ids(self.cfg, self.state)
            if build._host(n) == 0:
                break
            self.state = build.split_finish(self.cfg, self.state, ids)
            rounds += 1
        self.host_syncs += build.host_syncs - syncs
        return rounds

    def _marks(self) -> dict:
        """All host-side watermarks in one device read."""
        s = self.state
        v = torch.stack([s.num_points_processed, s.vox_used, s.vox_compacted,
                         s.pool_used, s.num_nodes, s.num_segments,
                         s.num_candidates_dropped,
                         s.mem_capacity_reached.to(torch.int32)]).tolist()
        return dict(processed=v[0], vox_used=v[1], vox_compacted=v[2],
                    pool_used=v[3], num_nodes=v[4], num_segments=v[5],
                    dropped=v[6], mem_cap=bool(v[7]))

    def _maybe_compact(self, force: bool = False, poll: bool = False):
        """Capacity poll + near-capacity voxel compaction (renders that need the
        exact voxel ranges force it)."""
        if not (force or poll) and self._steps_since_poll < 4:
            return
        self._steps_since_poll = 0
        m = self._marks()
        self._capacity_flag = m["mem_cap"]
        self._adapt_candidate_windows()
        threshold = int(self.cfg.voxel_capacity * self.cfg.voxel_compact_watermark)
        if force or m["vox_used"] > threshold:
            self.state = build.compact_voxels_auto(self.cfg, self.state,
                                                   used=m["vox_used"])
            m = self._marks()
            seg_limit = min(self.cfg.seg_scan_window,
                            self.cfg.segment_capacity) // 2
            if m["num_segments"] > seg_limit:
                self.state = build.compact_segments(self.cfg, self.state)

    def _adapt_candidate_windows(self):
        """Upsize the multi-level candidate window under sustained drops (more
        than 1% of the points ingested since the last poll; two bumps max)."""
        m = self._marks()
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

    # --- rendering ---
    def uniforms(self, width: int, height: int) -> Uniforms:
        self.camera.width, self.camera.height = width, height
        self.camera.fovy = self.settings.fovy
        t = self.camera.transform()
        if self.settings.do_update_visibility or self._transform_update_bound is None:
            self._transform_update_bound = t
        return Uniforms.make(width, height, t, self._transform_update_bound,
                             self.settings, device=self.device)

    def _windows(self):
        """Sample windows sized to the previous frame's visible counts, and
        directory windows from the live watermarks."""
        pv, vv = getattr(self, "_last_visible", (1 << 20, 1 << 20))
        ppw, pvw = getattr(self, "_last_windows", (1 << 20, 1 << 20))
        pw = sample_window(pv, ppw, self.cfg.max_render_points)
        vw = sample_window(vv, pvw, self.cfg.max_render_voxels)
        self._last_windows = (pw, vw)
        nn, ns = getattr(self, "_last_counts", (0, 0))
        nw = directory_window(nn, self.cfg.node_capacity)
        sw = directory_window(ns, self.cfg.segment_capacity)
        return pw, vw, nw, sw

    def _note_visible(self, fstats: FrameStats):
        self._last_visible = tuple(torch.stack(
            [fstats.num_visible_points, fstats.num_visible_voxels]).tolist())
        m = self._marks()
        self._last_counts = (m["num_nodes"], m["num_segments"])

    def render(self, width: int, height: int):
        """Render-only frame -> (image i32 [H, W] (u32 abgr bits), Stats).
        Exact render only: the screen-budgeted draw pool is not ported."""
        if self.settings.point_budget > 0:
            raise NotImplementedError("point_budget > 0 needs the draw pool, "
                                      "which is not ported yet")
        # an exact voxel CSR needs every tail append folded in
        m = self._marks()
        self._maybe_compact(force=m["vox_used"] > m["vox_compacted"])
        u = self.uniforms(width, height)
        t0 = time.perf_counter()
        self.last_windows = self._windows()
        img, fstats = render_frame(self.cfg, self.state, width, height, u,
                                   *self.last_windows)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t_render.add(time.perf_counter() - t0)
        self._note_visible(fstats)
        return img, _collect_stats(self.cfg, self.state, fstats)

    # --- reporting (reference stats table, :1484-1583) ---
    def report(self) -> dict:
        out = dataclasses.asdict(_collect_stats(self.cfg, self.state, None))
        out["timings"] = dict(build=self.t_build.row(),
                              render=self.t_render.row())
        out["host_syncs"] = self.host_syncs
        out["steps"] = self.steps
        if self.stream is not None:
            out["stream"] = self.stream.stats()
        return out
