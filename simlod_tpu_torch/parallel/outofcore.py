"""Sharded out-of-core ingestion (port of simlod_tpu/parallel/outofcore.py):
datasets larger than the shards' combined point pools, built brick by brick
through the ShardedEngine and rendered from the evicted voxel LODs with a
depth-min composite across shards and bricks.

  - every brick (one input file) streams through the sharded engine: its
    points are routed to their owning shards, each shard builds its local
    octree over the shared world cube, then the brick's per-shard node
    directories and compacted voxel stores are evicted to the host;
  - a frame re-materializes one brick's per-shard voxel LODs at a time
    (exact-size states, as outofcore.OutOfCoreEngine does), renders them
    through the sharded step with EDL off (the shards composite on shard 0's
    device) and drops them; the brick planes then composite with
    render.composite_frames and one EDL pass. That is the reference's u64
    atomicMin blend (render.cu:95-99) applied twice.

Leaf point pools stay evicted (a voxel-LOD overview).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import EngineConfig, Settings, Uniforms
from ..io.streaming import scan_paths
from ..outofcore import _NODE_COLS, _VOX_COLS, lod_render_state
from ..render.render import composite_frames
from . import shard
from .engine import ShardedEngine


@dataclasses.dataclass
class ShardedBrick:
    """One evicted brick: per-shard host columns (padded to the brick's
    per-shard maximum) and per-shard watermarks."""
    path: str
    nodes: dict            # col -> np [n_shards, max_nodes]
    voxels: dict           # col -> np [n_shards, max_vox] (compacted)
    num_nodes: np.ndarray  # [n_shards] i32
    vox_used: np.ndarray   # [n_shards] i32
    num_points: int

    @property
    def host_bytes(self) -> int:
        return sum(a.nbytes for d in (self.nodes, self.voxels)
                   for a in d.values())


class ShardedOutOfCoreEngine:
    """Builds bricks one after another through one ShardedEngine, evicts each
    to the host, and renders their union by shard-then-brick depth-min
    compositing."""

    def __init__(self, cfg: EngineConfig | None = None, mesh=None,
                 width: int = 1920, height: int = 1080,
                 settings: Settings | None = None, slot_factor: int = 4):
        self.cfg = cfg or EngineConfig()
        self.settings = settings or Settings()
        self.engine = ShardedEngine(self.cfg, mesh=mesh, width=width,
                                    height=height, settings=self.settings,
                                    slot_factor=slot_factor)
        self.mesh = self.engine.mesh
        self.width, self.height = width, height
        self.bricks: list[ShardedBrick] = []

    # --- lifecycle ---
    def open(self, paths) -> list[str]:
        """Scan bricks (one per file) and compute the global union box."""
        entries = scan_paths(paths)
        if not entries:
            raise FileNotFoundError(f"no point cloud files under {paths!r}")
        self.global_min = np.min([e.box_min for e in entries], axis=0)
        self.global_max = np.max([e.box_max for e in entries], axis=0)
        self.brick_paths = [e.path for e in entries]
        self.bricks = []
        if self.settings.auto_focus_on_load:
            self.engine.orbit.focus_box(np.zeros(3), self._extent())
            self.engine.camera.world = self.engine.orbit.world()
        return self.brick_paths

    def _extent(self) -> np.ndarray:
        return (self.global_max - self.global_min).astype(np.float32)

    def build_all(self) -> None:
        for path in self.brick_paths:
            self.build_brick(path)

    def build_brick(self, path: str) -> ShardedBrick:
        """Stream one brick through the sharded engine (points routed to their
        owning shards), converge splits, compact, evict. The engine's open
        resets the octrees to the world box before it attaches the brick's
        stream (a reset drops the engine's current stream)."""
        eng = self.engine
        stream = eng.open([path], chunk_steps=1,
                          box_override=(self.global_min, self.global_max))
        eng.load_all()
        stream.stop()
        eng._maybe_compact(force=True)   # exact CSR for the evicted LOD
        brick = self._evict(path, eng.state)
        self.bricks.append(brick)
        return brick

    def _evict(self, path: str, states) -> ShardedBrick:
        """Copy each shard's used node and voxel prefixes to the host (padded
        to the largest shard's); the device states are replaced when the next
        brick resets the engine."""
        eng = self.engine
        n = len(states)
        with eng._counting():
            v = shard._read("sharded.evict", [t for s in states for t in (
                s.num_nodes, s.vox_used, s.num_points_processed,
                s.num_points_dropped)], self.mesh.devices[0])
        nn = np.asarray(v[0::4], np.int32)
        vu = np.asarray(v[1::4], np.int32)
        max_n, max_v = int(nn.max()), max(int(vu.max()), 1)
        pull = lambda col, w: np.stack([getattr(s, col)[:w].cpu().numpy()
                                        for s in states])
        return ShardedBrick(
            path=path,
            nodes={c: pull(c, max_n) for c in _NODE_COLS},
            voxels={c: pull(c, max_v) for c in _VOX_COLS},
            num_nodes=nn, vox_used=vu,
            num_points=sum(v[2::4]) - sum(v[3::4]))

    # --- rendering ---
    def _materialize(self, brick: ShardedBrick):
        """One brick's voxel LOD as per-shard exact-size render states, each
        on its shard's device."""
        cube = self._extent().max()
        out = []
        for s, dev in enumerate(self.mesh.devices):
            nn, vu = int(brick.num_nodes[s]), int(brick.vox_used[s])
            out.append(lod_render_state(
                {c: a[s, :nn] for c, a in brick.nodes.items()},
                {c: a[s, :vu] for c, a in brick.voxels.items()},
                nn, vu, cube, dev))
        return out

    def render_planes(self, width: int | None = None,
                      height: int | None = None):
        """Per brick: (colour i32 [H*W], depth bits i32 [H*W]) composited
        over the shards without EDL; also returns the frame's Uniforms (EDL
        as in the settings)."""
        w, h = width or self.width, height or self.height
        if (w, h) != (self.width, self.height):
            raise ValueError(f"the sharded step draws {self.width}x"
                             f"{self.height}, not {w}x{h}")
        eng = self.engine
        eng.camera.fovy = self.settings.fovy
        t = eng.camera.transform()
        dev0 = self.mesh.devices[0]
        u_brick = Uniforms.make(
            w, h, t, settings=dataclasses.replace(self.settings,
                                                  enable_edl=False),
            device=dev0)
        u_final = Uniforms.make(w, h, t, settings=self.settings, device=dev0)
        planes = []
        for brick in self.bricks:
            st = self._materialize(brick)
            _, img, depth, _ = eng.step(st, None, None, None, None, 0,
                                        u_brick, True)
            planes.append((img.reshape(-1), depth.reshape(-1)))
            del st                         # the brick leaves the devices here
        return planes, u_final

    def render(self, width: int | None = None, height: int | None = None):
        """Composited frame over all bricks -> (image i32 [H, W] (u32 bits),
        depth bits i32 [H, W]). Device residency is one brick's LOD."""
        w, h = width or self.width, height or self.height
        planes, u = self.render_planes(w, h)
        img, depth = composite_frames(torch.stack([p[0] for p in planes]),
                                      torch.stack([p[1] for p in planes]),
                                      u, w, h)
        return img, depth.reshape(h, w)

    def report(self) -> dict:
        return dict(
            bricks=len(self.bricks),
            n_chips=self.mesh.size,
            total_points=sum(b.num_points for b in self.bricks),
            total_voxels=sum(int(b.vox_used.sum()) for b in self.bricks),
            total_nodes=sum(int(b.num_nodes.sum()) for b in self.bricks),
            host_bytes=sum(b.host_bytes for b in self.bricks),
            per_chip_point_capacity=self.cfg.point_capacity,
        )
