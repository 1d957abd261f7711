"""Sharded engine: the multi-device counterpart of engine.Engine (port of
simlod_tpu/parallel/engine.py).

Batches stream from files as in the single-device engine (io/streaming's
PointStream), but each step's B rows go straight from the pinned host planes
to the shards, B/n rows to each shard's device, are routed to their owning
Morton brick by one all-to-all exchange and built into per-shard local octrees
(parallel/shard.py). A frame composites the shards' planes on shard 0's
device.

The reference has no distributed mode (one GPU,
main_progressive_octree.cpp:274). Without a mesh the engine takes every
visible CUDA device and raises where there is none; a CPU mesh is asked for by
name (shard.make_mesh(["cpu"] * n)). The JAX package's XLA compilation cache
is not part of the port.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..config import EngineConfig, Settings, Uniforms
from ..io.streaming import PointStream
from ..render import camera as camera_mod
from ..utils import trace
from . import shard


class ShardedEngine:
    """Holds the shards' states and drives streaming, build and render."""

    def __init__(self, cfg: EngineConfig | None = None,
                 mesh: shard.Mesh | None = None, width: int = 1920,
                 height: int = 1080, settings: Settings | None = None,
                 slot_factor: int = 4):
        self.cfg = cfg or EngineConfig()
        self.mesh = mesh or shard.make_mesh()
        self.width, self.height = width, height
        self.settings = settings or Settings()
        self.step = shard.build_sharded_step(self.cfg, self.mesh, width, height,
                                             slot_factor=slot_factor)
        self.chunk = shard.build_sharded_chunk(self.cfg, self.mesh,
                                               slot_factor=slot_factor)
        self.camera = camera_mod.Camera(width=width, height=height)
        self.orbit = camera_mod.OrbitControls()
        self.state: list | None = None
        self.stream: PointStream | None = None
        self._stream_iter = None
        self._steps_since_compact = 0
        self.last_batch_finished = False
        self.host_syncs = 0

    @contextlib.contextmanager
    def _counting(self):
        """Add the device reads made inside the block to host_syncs."""
        before = trace.reads()
        try:
            yield
        finally:
            self.host_syncs += trace.reads() - before

    def _sync(self):
        for d in set(self.mesh.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    # --- lifecycle ---
    def reset(self, box_min, box_max):
        """Fresh per-shard octrees over the box. Stops and drops the current
        stream (as Engine.reset does): `open` is the reload path."""
        if self.stream is not None:
            self.stream.stop()
        self.stream = None
        self._stream_iter = None
        self.state = shard.init_sharded_state(self.cfg, self.mesh, box_min,
                                              box_max)
        self._steps_since_compact = 0
        self.last_batch_finished = False
        self.host_syncs = 0
        if self.settings.auto_focus_on_load:
            self.orbit.focus_box(np.zeros(3),
                                 np.asarray(box_max) - np.asarray(box_min))
            self.camera.world = self.orbit.world()

    def open(self, paths, chunk_steps: int | None = None,
             box_override=None) -> PointStream:
        """Scan files, reset the octrees to their union box (or to
        box_override = (min, max), an out-of-core brick's world box), start
        streaming: each step's rows go to the shards' devices, B/n rows each.
        chunk_steps overrides cfg.steps_per_dispatch for this stream."""
        k = chunk_steps if chunk_steps is not None \
            else max(1, self.cfg.steps_per_dispatch)
        stream = PointStream(paths, self.cfg.step_points,
                             device=list(self.mesh.devices), chunk_steps=k,
                             box_override=box_override)
        box = stream.box_max - stream.box_min
        self.reset(np.zeros(3, np.float32), box.astype(np.float32))
        self.stream = stream
        self._stream_iter = iter(stream)
        return stream

    def uniforms(self) -> Uniforms:
        self.camera.fovy = self.settings.fovy
        return Uniforms.make(self.width, self.height, self.camera.transform(),
                             settings=self.settings,
                             device=self.mesh.devices[0])

    # --- construction ---
    def ingest(self, x, y, z, rgba, count: int, render: bool = False):
        """One sharded step (exchange + per-shard build, then with `render`
        the composited frame). Returns the image (background without
        render)."""
        with self._counting():
            self.state, img, depth, _ = self.step(
                self.state, x, y, z, rgba, count,
                self.uniforms() if render else None, render)
        self._steps_since_compact += 1
        self.last_depth = depth
        return img

    def _maybe_compact(self, force: bool = False):
        """sharded_compact on the single-device cadence (every 4 steps, when a
        shard's store is past the watermark)."""
        if not force and self._steps_since_compact < 4:
            return
        self._steps_since_compact = 0
        threshold = int(self.cfg.voxel_capacity
                        * self.cfg.voxel_compact_watermark)
        with self._counting():
            used = shard._read("sharded.vox_used",
                               [st.vox_used for st in self.state],
                               self.mesh.devices[0])
            if force or max(used) > threshold:
                self.state = shard.sharded_compact(self.cfg, self.mesh,
                                                   self.state, used)

    def ingest_chunk(self, item):
        """One K-step sharded build (compaction at the watermark inside)."""
        bx, by, bz, brgba, counts = item
        with self._counting():
            self.state = self.chunk(self.state, bx, by, bz, brgba, counts)
        self._steps_since_compact += len(counts)

    def ingest_next(self) -> bool:
        """Ingest the next streamed item; False once the stream is done."""
        if self.stream is None:
            return False
        item = next(self._stream_iter, None)
        if item is None:
            self.last_batch_finished = True
            return False
        if self.stream.chunk_steps == 1:
            x, y, z, rgba, counts = item
            self.ingest(*([b[0] for b in p] for p in (x, y, z, rgba)),
                        int(counts[0]))
            self._maybe_compact()
        else:
            self.ingest_chunk(item)
        return True

    def stage(self):
        """Drain the stream (its planes are already on the shards' devices)
        and return per-shard [K, B/n] planes and the [K] counts, ready for one
        chunked build."""
        items = list(self._stream_iter)
        self.last_batch_finished = True
        if not items:
            return None
        planes = tuple([torch.cat([it[i][s] for it in items])
                        for s in range(self.mesh.size)] for i in range(4))
        counts = np.concatenate([it[4] for it in items])
        return (*planes, counts)

    def _finish_splits(self):
        with self._counting():
            self.state = shard.sharded_finish_splits(self.cfg, self.mesh,
                                                     self.state)
        self._sync()

    def build_staged(self, staged) -> None:
        """One chunked build over staged planes, then the end-of-load split
        convergence."""
        if staged is not None:
            self.ingest_chunk(staged)
        self._finish_splits()

    def load_all(self, bulk: bool = True):
        """Consume the stream: bulk (default) stages the whole stream on the
        devices and builds it as one chunk; bulk=False builds item by item.
        Both end with the split convergence."""
        if not bulk:
            while self.ingest_next():
                pass
            self._finish_splits()
            return
        self.build_staged(self.stage())

    # --- rendering ---
    def render(self):
        """Composited frame -> image i32 [H, W] (u32 bits) from exact voxel
        ranges; its depth bits are `last_depth`. The JAX package compacts
        before every frame; here only when a shard has rows appended since
        its last compaction (a compacted store compacts to itself)."""
        with self._counting():
            v = shard._read("sharded.compacted",
                            [t for s in self.state
                             for t in (s.vox_used, s.vox_compacted)],
                            self.mesh.devices[0])
        if any(u > c for u, c in zip(v[0::2], v[1::2])):
            self._maybe_compact(force=True)
        return self.ingest(None, None, None, None, 0, render=True)

    def report(self) -> dict:
        """The JAX package's counters, summed over the shards (num_nodes per
        shard), in one device read."""
        dev0 = self.mesh.devices[0]
        rows = []
        for s in self.state:
            leaf = torch.where(s.child_base < 0, s.num_points, 0)
            rows.append(torch.stack([
                s.num_nodes, leaf.sum(dtype=torch.int32),
                s.num_points_processed, s.num_points_dropped, s.vox_used,
                s.mem_capacity_reached.to(torch.int32)]).to(dev0))
        with self._counting():
            m = trace.sync("sharded.report",
                           torch.stack(rows).to(torch.int64))
        col = lambda i: [r[i] for r in m]
        return dict(
            num_nodes=col(0),
            num_points=sum(col(1)),
            num_points_processed=sum(col(2)),
            num_points_dropped=sum(col(3)),
            num_voxels_stored=sum(col(4)),
            mem_capacity_reached=any(col(5)),
        )
