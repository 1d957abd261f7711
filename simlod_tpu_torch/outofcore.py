"""Out-of-core ingestion: datasets larger than the device point pool (port of
simlod_tpu/outofcore.py).

The reference caps datasets at GPU-resident size ("can only display data sets
that fit in GPU memory", reference README.md:12). This module lifts the cap with
brick-granular residency:

  - the input is partitioned into spatial bricks, one per input file (LAS/LAZ
    tiles keep their world placement; .simlod files are rebased to their own
    origin and cannot be placed);
  - every brick streams through one device engine into its own octree over the
    shared global cube (PointStream box_override rebases each brick into the
    union frame);
  - a finished brick is evicted to host memory: the leaf point pool leaves the
    device, and the node directory and compacted voxel store (the LOD above the
    leaves) stay on the host, re-materialized into an exact-size render state
    on demand;
  - a frame renders every frustum-visible brick's voxel LOD and composites the
    frames by depth-min (render.composite_frames), which equals a joint render
    of all bricks (the reference's u64 atomicMin blend, render.cu:95-99);
  - a closeup pages one brick's point pool back in (`page_in`).

Spans (utils/trace): `ooc.open` (the tile scan and the union box), one
`ooc.brick` a brick (its engine open, load, forced compaction and eviction)
holding `ooc.compact` and `ooc.evict` (the eviction's read,
`sync.outofcore.evict`, and the copies, done once the span closes).
Counters since the last `open`: `bricks_built` and `evicted_bytes` (the
bytes of the used prefixes copied to the host).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import constants as C
from .config import EngineConfig, Settings, Uniforms
from .engine import Engine
from .io.streaming import scan_paths
from .octree.structures import OctreeState, state_from_numpy
from .render import camera as camera_mod
from .render.render import composite_frames, render_components
from .utils import trace

# node columns copied into a brick's resident render state
_NODE_COLS = ("child_base", "parent", "level", "nx", "ny", "nz", "counter",
              "num_points", "num_voxels", "vox_voff", "vox_vcnt")
_VOX_COLS = ("vox_k0", "vox_k1", "vox_k2l", "vox_node", "vox_rgba")
_PT_COLS = ("pt_w0", "pt_w1", "pt_w2", "pt_rgba")
_SEG_COLS = ("seg_node", "seg_off", "seg_cnt")


@dataclasses.dataclass
class Brick:
    """One evicted brick: host-resident arrays + watermarks."""
    path: str
    nodes: dict            # column -> np [num_nodes]
    voxels: dict           # column -> np [vox_used] (compacted: sorted + deduped)
    points: dict           # column -> np [pool_used] (evicted leaf points)
    segs: dict             # column -> np [num_segments]
    num_nodes: int
    num_segments: int
    vox_used: int
    pool_used: int
    num_points: int        # points fed (accounting)
    box_min: np.ndarray = None   # brick AABB in the rebased global frame
    box_max: np.ndarray = None   # (host-side frustum cull key, see render())

    @property
    def host_bytes(self) -> int:
        return sum(a.nbytes for d in (self.nodes, self.voxels, self.points,
                                      self.segs) for a in d.values())


def _pow2(n: int) -> int:
    return max(128, 1 << (max(n, 1) - 1).bit_length())


def lod_render_state(nodes: dict, voxels: dict, num_nodes: int,
                     vox_used: int, cube_size, device,
                     paged: Brick | None = None) -> OctreeState:
    """An exact-size device OctreeState from host columns: the node directory
    (`num_nodes` rows) and compacted voxels (`vox_used` rows) of an evicted
    octree, plus the point pool and segments of `paged` when it is paged back
    in. Columns a render never reads stay minimal."""
    nn = num_nodes
    i32 = lambda n, v=0: np.full(n, v, np.int32)
    # an empty column keeps one row: gathers clamp their indices into it
    rows = lambda cols: {c: a if len(a) else np.zeros(1, a.dtype)
                         for c, a in cols.items()}
    d = dict(nodes)
    d.update(node_seg_count=i32(nn), anc=i32(nn * (C.MAX_DEPTH + 1)),
             num_nodes=np.int32(nn), b_key0=i32(1), b_key1=i32(1),
             b_pack=i32(1), num_boundaries=np.int32(1),
             pool_waste=np.int32(0), box_min=np.zeros(3, np.float32),
             cube_size=np.float32(cube_size),
             num_points_processed=np.int32(0),
             num_points_dropped=np.int32(0),
             num_candidates_dropped=np.int32(0),
             mem_capacity_reached=np.bool_(False))
    d.update(rows(voxels))
    d.update(vox_used=np.int32(vox_used), vox_compacted=np.int32(vox_used))
    if paged is not None:
        d.update(rows(paged.points))
        d.update(rows(paged.segs))
        d.update(pool_used=np.int32(paged.pool_used),
                 num_segments=np.int32(paged.num_segments))
    else:
        d.update({c: i32(1) for c in _PT_COLS})
        d.update(seg_node=i32(1, -1), seg_off=i32(1), seg_cnt=i32(1),
                 pool_used=np.int32(0), num_segments=np.int32(0))
    return state_from_numpy(d, device)


class OutOfCoreEngine:
    """Builds bricks one after another through one device engine, keeps their
    voxel LOD renderable, and composites frames across bricks. Runs on the
    card unless `device` names another (the default of Engine)."""

    def __init__(self, cfg: EngineConfig | None = None,
                 settings: Settings | None = None, device=None):
        self.cfg = cfg or EngineConfig()
        self.settings = settings or Settings()
        self.engine = Engine(self.cfg, self.settings, device=device)
        self.device = self.engine.device
        self.bricks: list[Brick] = []
        self._resident: dict[int, OctreeState] = {}  # brick -> render state
        self._paged_in: int | None = None
        self.camera = camera_mod.Camera()
        self.orbit = camera_mod.OrbitControls()
        self.bricks_built = 0
        self.evicted_bytes = 0

    # --- lifecycle ---
    def open(self, paths) -> list[str]:
        """Scan bricks (one per file) and compute the global union box."""
        with trace.span("ooc.open"):
            entries = scan_paths(paths)
            if not entries:
                raise FileNotFoundError(
                    f"no point cloud files under {paths!r}")
            self.global_min = np.min([e.box_min for e in entries], axis=0)
            self.global_max = np.max([e.box_max for e in entries], axis=0)
        self.brick_paths = [e.path for e in entries]
        self.bricks = []
        self._resident = {}
        self._paged_in = None
        self.bricks_built = 0
        self.evicted_bytes = 0
        if self.settings.auto_focus_on_load:
            self.orbit.focus_box(np.zeros(3), self._extent())
            self.camera.world = self.orbit.world()
        return self.brick_paths

    def _extent(self) -> np.ndarray:
        return (self.global_max - self.global_min).astype(np.float32)

    def build_all(self) -> None:
        for path in self.brick_paths:
            self.build_brick(path)

    def build_brick(self, path: str) -> Brick:
        """Stream one brick through the shared engine, then evict it. The
        engine's open resets the octree to the world box before it attaches
        the brick's stream (a reset drops the engine's current stream)."""
        eng = self.engine
        with trace.span("ooc.brick"):
            stream = eng.open([path], box_override=(self.global_min,
                                                    self.global_max))
            eng.load_all()
            stream.stop()
            with trace.span("ooc.compact"):
                eng._maybe_compact(force=True)
            brick = self._evict(path, eng.state)
        e = stream.entries[0]
        brick.box_min = (e.box_min - self.global_min).astype(np.float32)
        brick.box_max = (e.box_max - self.global_min).astype(np.float32)
        self.bricks.append(brick)
        self.bricks_built += 1
        return brick

    def _evict(self, path: str, s: OctreeState) -> Brick:
        """Copy the brick's used prefixes to the host; the device state is
        replaced when the next brick resets the engine."""
        with trace.span("ooc.evict"):
            nn, ns, vu, pu, processed, dropped = self.engine._read(
                "outofcore.evict",
                [s.num_nodes, s.num_segments, s.vox_used, s.pool_used,
                 s.num_points_processed, s.num_points_dropped])
            pull = lambda col, n: getattr(s, col)[:n].cpu().numpy().copy()
            brick = Brick(
                path=path,
                nodes={c: pull(c, nn) for c in _NODE_COLS},
                voxels={c: pull(c, vu) for c in _VOX_COLS},
                points={c: pull(c, pu) for c in _PT_COLS},
                segs={c: pull(c, ns) for c in _SEG_COLS},
                num_nodes=nn, num_segments=ns, vox_used=vu, pool_used=pu,
                num_points=processed - dropped)
        self.evicted_bytes += brick.host_bytes
        return brick

    # --- resident render states ---
    def _render_cfg(self) -> EngineConfig:
        """The config frames are rendered with: the sample windows the JAX
        package derives from its shared power-of-two render shapes (they
        decide what a frame draws and when it reports truncation). The render
        states themselves are sized exactly per brick."""
        vv = _pow2(max(b.vox_used for b in self.bricks))
        pp = _pow2(max(b.pool_used for b in self.bricks))
        return dataclasses.replace(
            self.cfg, max_render_voxels=min(self.cfg.max_render_voxels, vv),
            max_render_points=min(self.cfg.max_render_points, pp))

    def _render_state(self, i: int, with_points: bool) -> OctreeState:
        """Materialize brick i as an exact-size device OctreeState: the voxel
        LOD only, or with its point pool paged back in."""
        b = self.bricks[i]
        return lod_render_state(b.nodes, b.voxels, b.num_nodes, b.vox_used,
                                self._extent().max(), self.device,
                                b if with_points else None)

    def resident_state(self, i: int) -> OctreeState:
        if i not in self._resident:
            self._resident[i] = self._render_state(i, with_points=False)
        return self._resident[i]

    def page_in(self, i: int) -> OctreeState:
        """Restore brick i's evicted leaf points for full-detail closeups; at
        most one brick's point pool is on the device at a time."""
        if self._paged_in is not None and self._paged_in != i:
            self._resident.pop(self._paged_in, None)   # back to voxel-only
        self._resident[i] = self._render_state(i, with_points=True)
        self._paged_in = i
        return self._resident[i]

    # --- rendering ---
    def uniforms(self, width: int, height: int) -> Uniforms:
        self.camera.width, self.camera.height = width, height
        self.camera.fovy = self.settings.fovy
        return Uniforms.make(width, height, self.camera.transform(),
                             settings=self.settings, device=self.device)

    def visible_bricks(self, width: int, height: int) -> list[int]:
        """Host-side frustum cull over brick AABBs (Gribb-Hartmann planes and
        the p-vertex test that render/frustum.py runs per node): an
        out-of-view brick is neither materialized nor rendered."""
        self.camera.width, self.camera.height = width, height
        m = np.asarray(self.camera.transform(), np.float64)
        planes = np.stack([m[3] + m[0], m[3] - m[0], m[3] + m[1],
                           m[3] - m[1], m[3] + m[2], m[3] - m[2]])
        out = []
        for i, b in enumerate(self.bricks):
            if b.box_min is None:
                out.append(i)
                continue
            # p-vertex: the AABB corner most aligned with each plane normal
            p = np.where(planes[:, :3] >= 0, b.box_max[None, :],
                         b.box_min[None, :])
            dist = (planes[:, :3] * p).sum(axis=1) + planes[:, 3]
            if np.all(dist >= 0):
                out.append(i)
        return out

    def auto_page(self, width: int, height: int) -> int | None:
        """Camera-driven paging: page in the visible brick whose box is nearest
        the eye when the eye is within one box diagonal of it (the closeup
        regime where the voxel LOD stops sufficing); evict otherwise. Returns
        the paged brick index (or None)."""
        vis = self.visible_bricks(width, height)
        eye = np.asarray(self.camera.world, np.float64)[:3, 3]
        best, best_d = None, np.inf
        for i in vis:
            b = self.bricks[i]
            if b.box_min is None:
                continue
            d = float(np.linalg.norm(eye - np.clip(eye, b.box_min, b.box_max)))
            if d < best_d:
                best, best_d = i, d
        if best is not None:
            diag = float(np.linalg.norm(
                self.bricks[best].box_max - self.bricks[best].box_min))
            if best_d <= diag:
                self.page_in(best)
                return best
        if self._paged_in is not None:   # left the closeup: back to voxel LOD
            self._resident.pop(self._paged_in, None)
            self._paged_in = None
        return None

    def render_planes(self, width: int, height: int):
        """Per visible brick: (brick index, colour i32 [H*W], depth i32 [H*W],
        FrameStats), without EDL; also returns the frame's Uniforms."""
        rcfg = self._render_cfg()
        u = self.uniforms(width, height)
        vw = rcfg.max_render_voxels
        pw = rcfg.max_render_points if self._paged_in is not None else 1 << 17
        self.last_drawn_bricks = self.visible_bricks(width, height)
        planes = [(i, *render_components(rcfg, self.resident_state(i), width,
                                         height, u, pw, vw))
                  for i in self.last_drawn_bricks]
        return planes, u

    def render(self, width: int, height: int):
        """Composited frame over the frustum-intersecting bricks -> (image
        i32 [H, W] (u32 bits), per-brick FrameStats keyed by brick index)."""
        planes, u = self.render_planes(width, height)
        if not planes:
            img = torch.full((height, width), C.BACKGROUND_COLOR,
                             dtype=torch.int32, device=self.device)
            return img, {}
        img, _ = composite_frames(torch.stack([p[1] for p in planes]),
                                  torch.stack([p[2] for p in planes]), u,
                                  width, height)
        return img, {p[0]: p[3] for p in planes}

    def report(self) -> dict:
        return dict(
            bricks=len(self.bricks),
            total_points=sum(b.num_points for b in self.bricks),
            total_voxels=sum(b.vox_used for b in self.bricks),
            total_nodes=sum(b.num_nodes for b in self.bricks),
            evicted_point_rows=sum(b.pool_used for b in self.bricks),
            host_bytes=sum(b.host_bytes for b in self.bricks),
            device_point_capacity=self.cfg.point_capacity,
            paged_in=self._paged_in,
        )
