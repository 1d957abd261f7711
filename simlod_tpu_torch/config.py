"""Typed configuration for the engine (port of simlod_tpu/config.py).

  - EngineConfig : capacities and step sizing (same fields and defaults as the
                   JAX package, so one config means the same octree in both)
  - Settings     : interactive render/LOD knobs (mirrors the reference `settings`)
  - Uniforms     : per-frame values as tensors on the device (views of one
                   buffer; UniformBuffer keeps one per engine), with the
                   switches (RenderFlags) and the visibility kernel's
                   values (UniformsHost) also as host values
  - Stats        : engine counters (mirrors HostDeviceInterface.h:46-71)

Every function of the port that makes tensors takes `device`; none given means
the card (`resolve_device`), and no card raises: CPU runs name "cpu".
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from . import constants as C
from .render.frustum import frustum_planes_host


def resolve_device(device=None, who: str = "Engine") -> torch.device:
    """The torch device of a function that makes tensors: `device` where the
    caller names one, else the card. A CUDA device where there is none raises
    (there is no CPU fallback); `who` names the caller in the message."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}(device={device}): no CUDA device is "
                           "available")
    return device


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Capacities and window sizes. The windows decide what a step truncates
    (and flags), so they keep the JAX package's meaning exactly."""

    # Octree capacities
    node_capacity: int = 1 << 20
    point_capacity: int = 64 << 20
    voxel_capacity: int = 64 << 20
    segment_capacity: int = 1 << 22

    # Per-step sizing
    step_points: int = 2 << 20
    spill_capacity: int = 4 << 20
    max_splits_per_round: int = 1024
    cascade_splits_per_round: int = 256
    seg_select_cap: int = 4096
    seg_scan_window: int = 1 << 18
    run_window: int = 1 << 17
    boundary_window: int = 1 << 17
    split_rounds: int = 24
    steps_per_dispatch: int = 4
    max_batches_per_frame: int = 20

    # Octree parameters (reference structures.cuh:21-26)
    max_points_per_node: int = C.MAX_POINTS_PER_NODE
    max_depth: int = C.MAX_DEPTH

    # Rasterizer: the tile-binned sort + tile-resolve kernel
    # (render/raster_tiles.py) when set, else the splat kernel
    # (render/raster.py). The JAX package takes its tile path only on a TPU
    # (simlod_tpu/config.py:74-76, simlod_tpu/render/render.py:89); on a GPU
    # and on the CPU it draws through raster.rasterize, and so does the port.
    use_tile_raster: bool = False
    # Tile path only. True: the pixel sort breaks (pixel, depth) ties by
    # colour, reproducing the reference's u64 atomicMin winner exactly
    # (render.cu:95-99); the splat kernel always does.
    raster_exact_tiebreak: bool = True

    # Draw-pool row cap per node (render/drawpool.py): nodes with more samples
    # render through the exact path.
    draw_cap: int = 1 << 18

    # Render capacities
    max_render_points: int = 8 << 20
    max_render_voxels: int = 8 << 20
    max_render_lines: int = 1 << 16
    line_steps: int = 128
    max_point_size: int = 1

    # Kept for config compatibility (sizes nothing).
    candidate_factor: int = 3
    # Rows of the batch allowed to emit candidates at multiple levels per step
    # (build._candidates); 0 = auto (batch/4).
    cand_multi_rows: int = 1 << 18

    # Voxel-store dedup compaction trigger (fraction of voxel_capacity).
    voxel_compact_watermark: float = 0.6

    @property
    def working_capacity(self) -> int:
        return self.step_points + self.spill_capacity + self.boundary_window

    def estimated_state_bytes(self) -> int:
        """Device bytes of the OctreeState this config allocates
        (structures.init_state)."""
        from .octree.structures import _cand_capacity
        pt = (self.point_capacity + self.working_capacity) * 16
        vx = (self.voxel_capacity + _cand_capacity(self)) * 20
        nd = self.node_capacity * 4 * (15 + C.MAX_DEPTH + 1)
        sg = self.segment_capacity * 12
        return pt + vx + nd + sg

    @classmethod
    def auto(cls, total_points: int | None = None, device=None,
             memory_bytes: int | None = None, **overrides) -> "EngineConfig":
        """Derive pool capacities from device memory and the dataset size
        (same policy as the JAX package: the state stays under ~45% of the
        device's free memory; the rest is working space for sorts). Without
        `memory_bytes` the budget is read from `device`, the card unless
        another is named."""
        budget = memory_bytes
        if budget is None:
            budget = _device_memory_bytes(
                resolve_device(device, "EngineConfig.auto"))
        state_budget = int(budget * 0.45)
        if total_points is None:
            total_points = max(state_budget // 36, 1 << 22)
        n = int(total_points)

        def bucket(v: int) -> int:   # 1-8-pow2 (<= 12.5% pad steps)
            v = max(v, 1024)
            b = max((v - 1).bit_length() - 3, 0)
            return ((v + (1 << b) - 1) >> b) << b

        kw: dict = dict(
            step_points=2 << 20,
            spill_capacity=1 << 20,
            seg_select_cap=2048,
            node_capacity=(1 << 19) if n >= 16_000_000 else (1 << 17),
            segment_capacity=min(max(bucket(n // 32), 1 << 16), 1 << 22),
            point_capacity=n + (1 << 20),
            voxel_capacity=max(bucket(n), 1 << 22),
        )
        kw.update(overrides)
        cfg = cls(**kw)
        while cfg.estimated_state_bytes() > state_budget \
                and cfg.point_capacity > (1 << 22):
            kw["point_capacity"] = max(kw["point_capacity"] // 2, 1 << 22)
            kw["voxel_capacity"] = max(kw["voxel_capacity"] // 2, 1 << 22)
            kw.update(overrides)
            cfg = cls(**kw)
        caps = dict(
            max_render_points=render_window_cap(cfg.point_capacity, budget),
            max_render_voxels=render_window_cap(cfg.voxel_capacity, budget))
        caps.update({k: v for k, v in overrides.items() if k in caps})
        return dataclasses.replace(cfg, **caps)


# the share of the memory budget the block plan of one sample window may
# take at its cap (EngineConfig.auto)
RENDER_PLAN_SHARE = 1 / 256
# plan bytes a window block of 128 rows takes (ragged.plan_chunks: four
# int32 and a bool)
PLAN_BLOCK_BYTES = 17


def render_window_cap(capacity: int, budget: int) -> int:
    """The cap of a sample window over a pool of `capacity` rows: the power
    of two at or above twice the pool, so that a view of every stored
    sample fits with phase padding (at most 254 rows a segment) as large as
    the pool, unless the window's plan would take more than
    RENDER_PLAN_SHARE of the memory budget. Never below the JAX package's
    fixed 4M. A frame's window is held from its need (Engine._windows):
    the cap only bounds it."""
    cap = 1 << (2 * capacity - 1).bit_length()
    fit = int(budget * RENDER_PLAN_SHARE) // PLAN_BLOCK_BYTES * 128
    return max(min(cap, 1 << max(fit.bit_length() - 1, 0)), 4 << 20)


def _device_memory_bytes(device: torch.device) -> int:
    """Free memory of a CUDA device, or half of physical RAM for the CPU."""
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return int(free)
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") // 2


@dataclasses.dataclass
class Settings:
    """Interactive knobs (reference: main_progressive_octree.cpp:123-139)."""

    use_high_quality_shading: bool = True
    show_bounding_box: bool = False
    do_update_visibility: bool = True
    show_points: bool = True
    color_by_node: bool = False
    color_by_lod: bool = False
    color_white: bool = False
    auto_focus_on_load: bool = True
    benchmark_rendering: bool = False
    lod: float = 0.2
    min_node_size: float = 64.0
    point_size: int = 1
    fovy: float = 60.0
    frame_budget_ms: float = 50.0
    enable_edl: bool = True
    edl_strength: float = 0.4
    # samples per covered pixel per node for the draw pool (render/drawpool.py);
    # 0 = exact render
    point_budget: float = 0.0


@dataclasses.dataclass(frozen=True)
class RenderFlags:
    """The Settings switches that decide which ops a frame runs, as host
    values: the render path branches on these, never on a device read."""

    show_bounding_box: bool = False
    color_by_node: bool = False
    color_by_lod: bool = False
    color_white: bool = False
    enable_edl: bool = True


@dataclasses.dataclass(frozen=True)
class UniformsHost:
    """Host copies of values the frame also reads on the device: the same
    float32 values as the device tensors, kept so that a check reads
    nothing back."""

    planes: tuple                   # 24 floats: the frustum planes [6, 4]
    # the visibility kernel's 44 float32 values (transform_update_bound,
    # planes, width, height, min_node_size, point_budget), as the kernel
    # reads them from Uniforms.vis
    vis_floats: bytes


# The uniform buffer's layout: 38 float32 (6 scalars, the two matrices), the
# visibility kernel's 44 float32 (Uniforms.vis), point_size, 7 switches
_VIS = slice(152, 328)
_POINT_SIZE = slice(328, 332)
_SWITCHES = slice(332, 339)
UNIFORM_BYTES = 339


def _pack_uniforms(width: int, height: int, transform, transform_update_bound,
                   s: "Settings"):
    """One frame's uniform bytes (the buffer's layout above), its host
    flags and its host copies."""
    if transform_update_bound is None:
        transform_update_bound = transform
    t = np.asarray(torch.as_tensor(transform, dtype=torch.float32))
    tub = np.asarray(torch.as_tensor(transform_update_bound,
                                     dtype=torch.float32))
    floats = np.concatenate([np.array(
        [width, height, s.lod, s.min_node_size, s.edl_strength,
         s.point_budget], np.float32), t.reshape(16), tub.reshape(16)])
    planes = frustum_planes_host(tub).reshape(24)
    vis = np.concatenate([floats[22:38], planes,
                          floats[[0, 1, 3, 5]]]).astype(np.float32)
    switches = (s.show_bounding_box, s.show_points, s.color_by_node,
                s.color_by_lod, s.color_white, s.use_high_quality_shading,
                s.enable_edl)
    raw = floats.tobytes() + vis.tobytes() \
        + np.array([s.point_size], np.int32).tobytes() \
        + np.array(switches, np.bool_).tobytes()
    flags = RenderFlags(
        show_bounding_box=bool(s.show_bounding_box),
        color_by_node=bool(s.color_by_node),
        color_by_lod=bool(s.color_by_lod),
        color_white=bool(s.color_white),
        enable_edl=bool(s.enable_edl))
    host = UniformsHost(planes=tuple(planes.tolist()),
                        vis_floats=vis.tobytes())
    return raw, flags, host


@dataclasses.dataclass
class Uniforms:
    """Per-frame values on the device (reference: HostDeviceInterface.h:10-44),
    the switches among them again as host values (`flags`), and host copies
    of what the kernels read (`host`). All tensors are views of one device
    buffer, which a frame's values reach in one copy.

    Matrices are row-major [4,4] float32 acting on column vectors, exactly like the
    reference's `uniforms.transform * float4`."""

    width: torch.Tensor                   # f32 scalar
    height: torch.Tensor                  # f32 scalar
    transform: torch.Tensor               # [4,4] f32: proj @ view @ world
    transform_update_bound: torch.Tensor  # frozen copy while !doUpdateVisibility
    show_bounding_box: torch.Tensor       # bool
    show_points: torch.Tensor             # bool
    color_by_node: torch.Tensor           # bool
    color_by_lod: torch.Tensor            # bool
    color_white: torch.Tensor             # bool
    use_high_quality_shading: torch.Tensor  # bool
    lod: torch.Tensor                     # f32
    min_node_size: torch.Tensor           # f32
    point_size: torch.Tensor              # i32
    enable_edl: torch.Tensor              # bool
    edl_strength: torch.Tensor            # f32
    point_budget: torch.Tensor            # f32
    # [44] f32: what the visibility kernel reads (UniformsHost.vis_floats)
    vis: torch.Tensor
    flags: RenderFlags                    # host copies of the switches above
    host: UniformsHost                    # host copies of the kernels' values

    @staticmethod
    def make(width: int, height: int, transform, transform_update_bound=None,
             settings: Settings | None = None, device=None) -> "Uniforms":
        """`transform` and `transform_update_bound` are host arrays (numpy or
        CPU tensors): their float32 values are kept on the host too. The
        tensors go to `device`, the card unless another is named, as views
        of a buffer of their own."""
        device = resolve_device(device, "Uniforms.make")
        raw, flags, host = _pack_uniforms(width, height, transform,
                                          transform_update_bound,
                                          settings or Settings())
        buf = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(device)
        return Uniforms.views(buf, flags, host)

    @staticmethod
    def views(buf: torch.Tensor, flags: RenderFlags,
              host: UniformsHost) -> "Uniforms":
        """The Uniforms over a uint8 buffer of UNIFORM_BYTES laid out as
        `Uniforms.make` packs it."""
        f = buf[:152].view(torch.float32)
        sw = buf[_SWITCHES].view(torch.bool)
        return Uniforms(
            width=f[0], height=f[1],
            transform=f[6:22].view(4, 4),
            transform_update_bound=f[22:38].view(4, 4),
            show_bounding_box=sw[0], show_points=sw[1], color_by_node=sw[2],
            color_by_lod=sw[3], color_white=sw[4],
            use_high_quality_shading=sw[5],
            lod=f[2], min_node_size=f[3],
            point_size=buf[_POINT_SIZE].view(torch.int32)[0],
            enable_edl=sw[6], edl_strength=f[4], point_budget=f[5],
            vis=buf[_VIS].view(torch.float32), flags=flags, host=host)


class UniformBuffer:
    """One persistent uniform buffer on a device: every `write` copies a
    frame's values into the same device bytes (one small host-to-device
    copy, ordered on the current stream after the work that read the last
    frame's) and returns Uniforms whose tensors are the same views each
    time. A recorded frame (graphs.FrameGraphs) reads its per-frame values
    there, so a replay sees the frame's camera and settings. On the card
    the copy leaves from pinned host memory without waiting for the device;
    the next write waits for it before refilling those bytes."""

    def __init__(self, device=None):
        self.device = resolve_device(device, "UniformBuffer")
        cuda = self.device.type == "cuda"
        self.buf = torch.zeros(UNIFORM_BYTES, dtype=torch.uint8,
                               device=self.device)
        self._staging = torch.zeros(UNIFORM_BYTES, dtype=torch.uint8,
                                    pin_memory=cuda)
        self._copied = torch.cuda.Event() if cuda else None
        self._views = Uniforms.views(self.buf, RenderFlags(), None)

    def write(self, width: int, height: int, transform,
              transform_update_bound=None,
              settings: Settings | None = None) -> Uniforms:
        """This frame's Uniforms (Uniforms.make's values) in the buffer."""
        raw, flags, host = _pack_uniforms(width, height, transform,
                                          transform_update_bound,
                                          settings or Settings())
        if self._copied is not None:
            self._copied.synchronize()     # the last copy has left
        self._staging.numpy()[:] = np.frombuffer(raw, np.uint8)
        self.buf.copy_(self._staging, non_blocking=self._copied is not None)
        if self._copied is not None:
            self._copied.record(torch.cuda.current_stream(self.device))
        return dataclasses.replace(self._views, flags=flags, host=host)


@dataclasses.dataclass
class Stats:
    """Engine counters (reference: HostDeviceInterface.h:46-71), as 0-d tensors
    or Python values once read back."""

    num_nodes: object
    num_inner: object
    num_leaves: object
    num_nonempty_leaves: object
    num_points: object
    num_voxels: object                    # logical voxel count (sum over nodes)
    num_voxels_stored: object             # store entries incl. lazy duplicates
    num_visible_nodes: object
    num_visible_inner: object
    num_visible_leaves: object
    num_visible_points: object
    num_visible_voxels: object
    num_points_processed: object
    num_points_dropped: object            # overflow guard drops
    num_candidates_dropped: object        # transient voxel-candidate overflows
    pool_used: object
    num_segments: object
    mem_capacity_reached: object          # bool (reference: voxels.cu:896-912)
    render_truncated: object              # bool: last frame dropped samples

    @staticmethod
    def zeros(device=None) -> "Stats":
        """The counters of a fresh single-root tree: 0-d int32 tensors (the
        two flags bool) on `device`, the card unless another is named. Each
        is its own element of one buffer, so none aliases another."""
        device = resolve_device(device, "Stats.zeros")
        names = [f.name for f in dataclasses.fields(Stats)]
        flags = ("mem_capacity_reached", "render_truncated")
        counts = [n for n in names if n not in flags]
        ints = torch.tensor([int(n in ("num_nodes", "num_leaves"))
                             for n in counts], dtype=torch.int32,
                            device=device)
        bools = torch.zeros(len(flags), dtype=torch.bool, device=device)
        return Stats(**{n: ints[i] for i, n in enumerate(counts)},
                     **{n: bools[i] for i, n in enumerate(flags)})
