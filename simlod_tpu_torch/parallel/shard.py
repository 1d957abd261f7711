"""Octree sharding over a mesh of torch devices (port of
simlod_tpu/parallel/shard.py; see there for the design).

Spatial data parallelism by top-level Morton brick: the octree cube is divided
into 8^L bricks (L = the smallest level with at least n bricks) and shard s
owns a contiguous Morton range of them, building its own local octree from the
points routed into its bricks. Each step's batch arrives split over the shards
(B/n rows each) and one all-to-all exchange routes every row to its owner. A
frame composites the shards' (colour, depth) planes by the depth-min of the
reference's u64 atomicMin (render.cu:95-99), then runs EDL once.

What changed in the port:
  - one process drives every shard, as the JAX package's single-controller
    shard_map does: a Mesh is a tuple of torch devices, one per shard, and may
    name a device more than once (several shards on one card, ["cpu"] * n in
    the tests);
  - the collectives are explicit: the all-to-all is one copy per (source,
    destination) slot onto the destination's device, concatenated in source
    order as lax.all_to_all(tiled=True) lays them out; the composite stacks
    the planes on shard 0's device (render.composite_frames);
  - the shards' states are a list of OctreeStates, not one stacked state:
    shards may live on different devices;
  - lax.scan / lax.cond become Python loops and host decisions. The per-shard
    counts they need are read for all shards in one device read (`_read`,
    counted by `trace.sync`): the received counts once per step, so every
    shard's build takes a host count and no tensor of another device;
  - a step with count 0 skips the exchange and the build (both do nothing
    then), so a render-only step is the render alone.
Not ported (TPU workarounds, ROADMAP "do not port"): the scan-length buckets of
the chunk and the pow2 compaction windows (compaction sorts exactly the live
rows).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import constants as C
from ..config import EngineConfig, Uniforms
from ..octree import build
from ..octree.structures import (OctreeState, init_state, state_from_numpy,
                                 state_to_numpy)
from ..ops import morton
from ..ops.segments import compact_mask_via_sort, iota
from ..render import raster, raster_tiles
from ..render.render import composite_frames, frame_samples
from ..utils import trace


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The shards' devices, shard s on devices[s]."""
    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices=None) -> Mesh:
    """A mesh over `devices` (torch devices or their names; one may repeat),
    or over every visible CUDA device. There is no CPU default: without a
    card it raises, and a CPU mesh is asked for by name (["cpu"] * n)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(): no CUDA device is available "
                               "(a CPU mesh is make_mesh(['cpu'] * n))")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"make_mesh(): {d} named, but no CUDA "
                                   "device is available")
            if d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    if not out:
        raise ValueError("make_mesh(): no devices")
    return Mesh(tuple(out))


def brick_level_for(n_devices: int) -> int:
    """Smallest octree level with at least n_devices bricks."""
    level = 0
    while (8 ** level) < n_devices:
        level += 1
    return level


def init_sharded_state(cfg: EngineConfig, mesh: Mesh, box_min,
                       box_max) -> list[OctreeState]:
    """One fresh local octree state per shard, each on its shard's device."""
    return [init_state(cfg, box_min, box_max, d) for d in mesh.devices]


def sharded_state_from_numpy(stacked: dict, mesh: Mesh) -> list[OctreeState]:
    """The JAX package's stacked [n, ...] state (as numpy) -> one state per
    shard, on its device."""
    n = mesh.size
    for k, v in stacked.items():
        if np.shape(v)[0] != n:
            raise ValueError(f"{k}: leading axis {np.shape(v)[0]} != {n} "
                             "shards")
    return [state_from_numpy({k: np.asarray(v)[s] for k, v in stacked.items()},
                             d) for s, d in enumerate(mesh.devices)]


def sharded_state_to_numpy(states: list[OctreeState]) -> dict:
    """Per-shard states -> stacked [n, ...] numpy fields (the JAX layout)."""
    dicts = [state_to_numpy(s) for s in states]
    return {k: np.stack([d[k] for d in dicts]) for k in dicts[0]}


def _read(site: str, tensors, device) -> list[int]:
    """0-d tensors of any shards -> Python ints, in one device read at
    `site` (trace.sync)."""
    return trace.sync(site, torch.stack(
        [t.reshape(()).to(device=device, dtype=torch.int64) for t in tensors]))


def _slot_rows(Bl: int, n: int, slot_factor: int) -> int:
    """Rows per exchange slot: slot_factor x the even share (skew headroom),
    clamped to Bl (a shard never sends more rows to one destination than it
    holds)."""
    return max(128, min(Bl, (slot_factor * Bl) // max(n, 1)))


def _brick_owner(qx, qy, qz, level: int, n_devices: int):
    """Shard owning each point: Morton brick id scaled onto the shard range."""
    bits = torch.zeros_like(qx)
    for l in range(level):
        s = C.FULL_GRID_BITS - 1 - l
        bits = (bits << 3) | (((qx >> s) & 1) << 2) \
            | (((qy >> s) & 1) << 1) | ((qz >> s) & 1)
    return torch.div(bits * n_devices, 8 ** level, rounding_mode="floor")


def _exchange(cols, owners, counts_l, mesh: Mesh, S: int):
    """All-to-all point exchange over the shards.

    cols[s] are shard s's columns ([Bl] each), owners[s] its rows' owners and
    counts_l[s] its valid prefix. Each source sorts its valid rows by owner
    (stable), finds the n + 1 destination offsets, clamps each destination's
    count to S rows (the excess is dropped and counted) and gathers n slots
    of S rows. Each destination concatenates the slot every source addressed
    to it, copied to its device, in source order, and compacts the valid rows
    to the front. Returns (received columns [n*S] per shard, received count
    per shard (0-d, on its device), dropped per source (0-d))."""
    n = mesh.size
    sent, send_cnt, dropped = [], [], []
    for c, owner, count_l in zip(cols, owners, counts_l):
        dev = owner.device
        Bl = owner.shape[0]
        okey = torch.where(iota(Bl, dev) < count_l, owner, n)
        order = torch.sort(okey, stable=True).indices
        offs = torch.searchsorted(okey[order], iota(n + 1, dev)) \
            .to(torch.int32)
        cnt = offs[1:] - offs[:-1]
        sc = torch.clamp(cnt, max=S)
        rows = order[(offs[:n, None] + iota(S, dev)[None, :])
                     .clamp(max=Bl - 1).reshape(-1).long()]
        sent.append([col[rows].reshape(n, S) for col in c])
        send_cnt.append(sc)
        dropped.append((cnt - sc).sum(dtype=torch.int32))
    recv, my_count = [], []
    for d, dev in enumerate(mesh.devices):
        rc = torch.stack([sc[d].to(dev) for sc in send_cnt])
        rvalid = (iota(S, dev)[None, :] < rc[:, None]).reshape(-1)
        flat = [torch.cat([sent[s][i][d].to(dev, non_blocking=True)
                           for s in range(n)]) for i in range(len(cols[0]))]
        comp, mc = compact_mask_via_sort(rvalid, flat)
        recv.append(comp)
        my_count.append(mc)
    return recv, my_count, dropped


def _shard_columns(mesh: Mesh, cols):
    """Per-shard blocks of batch columns: a column is either a global tensor
    ([B] or [K, B], split into n blocks along its last axis, block s copied to
    shard s's device) or already a sequence of n per-shard tensors. Returns
    [shard][column]."""
    n = mesh.size
    out = [[] for _ in range(n)]
    for c in cols:
        if isinstance(c, torch.Tensor):
            if c.shape[-1] % n:
                raise ValueError(f"{c.shape[-1]} rows do not split over {n} "
                                 "shards")
            c = [b.to(d) for b, d in zip(torch.chunk(c, n, dim=-1),
                                         mesh.devices)]
        if len(c) != n:
            raise ValueError(f"{len(c)} column blocks for {n} shards")
        for s in range(n):
            out[s].append(c[s])
    return out


def _route_step(cfg: EngineConfig, mesh: Mesh, level: int, slot_factor: int,
                states: list[OctreeState], cols, count: int) -> list[int]:
    """One exchange + per-shard build_step over the shards' [Bl] columns (the
    global batch's valid prefix is `count`); returns the received counts."""
    n = mesh.size
    if count <= 0:
        return [0] * n
    Bl = cols[0][0].shape[0]
    S = _slot_rows(Bl, n, slot_factor)
    owners = []
    for st, (x, y, z, _) in zip(states, cols):
        qx, qy, qz = morton.quantize_cols(x, y, z, st.box_min, st.cube_size)
        owners.append(_brick_owner(qx, qy, qz, level, n))
    counts_l = [min(max(count - s * Bl, 0), Bl) for s in range(n)]
    recv, my_count, dropped = _exchange(cols, owners, counts_l, mesh, S)
    my = _read("shard.counts", my_count, mesh.devices[0])
    for s, st in enumerate(states):
        st.num_points_dropped = st.num_points_dropped + dropped[s]
        states[s] = build.build_step(cfg, st, *recv[s], my[s])
    return my


def _uniforms_on(u: Uniforms, device) -> Uniforms:
    """`u` with its tensors on `device` (the host flags stay as they are)."""
    return dataclasses.replace(u, **{
        f.name: getattr(u, f.name).to(device) for f in dataclasses.fields(u)
        if isinstance(getattr(u, f.name), torch.Tensor)})


def _render(cfg: EngineConfig, mesh: Mesh, states: list[OctreeState],
            uniforms: Uniforms, width: int, height: int):
    """Every shard's frame of its local octree (LOD selection, gathers, then
    the splat kernel, or the tile route with cfg.use_tile_raster; no
    overlays), composited on shard 0's device: the depth is the minimum over
    shards, the colour the lowest-index winner's, then one EDL pass (the JAX
    package's pmin / winner pmin / psum). Returns (image i32 [H, W], depth
    bits i32 [H, W])."""
    dev0 = mesh.devices[0]
    colors, depths = [], []
    for st in states:
        u = _uniforms_on(uniforms, st.device)
        _, sets, _ = frame_samples(cfg, st, u)
        draw = raster_tiles.rasterize_tiles if cfg.use_tile_raster \
            else raster.rasterize
        color, depth = draw(cfg, u, width, height, sets)
        colors.append(color.to(dev0, non_blocking=True))
        depths.append(depth.to(dev0, non_blocking=True))
    img, depth = composite_frames(torch.stack(colors), torch.stack(depths),
                                  _uniforms_on(uniforms, dev0), width, height)
    return img, depth.reshape(height, width)


class _Step:
    """The sharded simultaneous step (see build_sharded_step)."""

    def __init__(self, cfg: EngineConfig, mesh: Mesh, width: int, height: int,
                 slot_factor: int):
        self.cfg, self.mesh = cfg, mesh
        self.width, self.height = width, height
        self.slot_factor = slot_factor
        self.level = brick_level_for(mesh.size)

    def __call__(self, states, x, y, z, rgba, count, uniforms,
                 do_render=True):
        count = int(count)
        my = [0] * self.mesh.size
        if count > 0:
            cols = _shard_columns(self.mesh, (x, y, z, rgba))
            my = _route_step(self.cfg, self.mesh, self.level,
                             self.slot_factor, states, cols, count)
        if bool(do_render):
            img, depth = _render(self.cfg, self.mesh, states, uniforms,
                                 self.width, self.height)
        else:
            # the background frame, like the composited render's layout
            full = lambda v: torch.full((self.height, self.width), v,
                                        dtype=torch.int32,
                                        device=self.mesh.devices[0])
            img, depth = full(C.BACKGROUND_COLOR), full(C.DEPTH_INF_BITS)
        return states, img, depth, np.asarray(my, np.int32)

    def recv_window(self, batch_rows: int) -> int:
        """Per-shard post-exchange work width for a batch of batch_rows."""
        n = self.mesh.size
        return n * _slot_rows(batch_rows // n, n, self.slot_factor)


def build_sharded_step(cfg: EngineConfig, mesh: Mesh, width: int, height: int,
                       slot_factor: int = 4) -> _Step:
    """The sharded simultaneous step:

        (states, x, y, z, rgba, count, uniforms, do_render)
            -> (states, image i32 [H, W], depth bits i32 [H, W],
                received counts np.int32 [n])

    x, y, z (f32) and rgba (i32 bit patterns) are the global [B] batch or its
    n per-shard [B/n] blocks; `count` is the global valid prefix (an int; 0
    builds nothing and the columns are not read). Each shard's local valid
    prefix is clip(count - s*B/n, 0, B/n). Voxel compaction is host-gated
    (`sharded_compact`). The states are updated in place and returned. The
    callable has .recv_window(batch_rows)."""
    return _Step(cfg, mesh, width, height, slot_factor)


def build_sharded_chunk(cfg: EngineConfig, mesh: Mesh, slot_factor: int = 4):
    """The K-step sharded build (no render):

        (states, bx, by, bz, brgba, counts) -> states

    with bx.. the global [K, B] planes or n per-shard [K, B/n] blocks and
    counts [K] the global valid prefixes (host ints). Each step is an exchange
    and a per-shard build_step; after it, every shard whose voxel store is
    past the compaction watermark is compacted (all shards' watermarks in one
    device read)."""
    level = brick_level_for(mesh.size)
    wm = int(cfg.voxel_capacity * cfg.voxel_compact_watermark)

    def chunk(states, bx, by, bz, brgba, counts):
        planes = _shard_columns(mesh, (bx, by, bz, brgba))
        for k in range(len(counts)):
            cols = [[p[k] for p in ps] for ps in planes]
            _route_step(cfg, mesh, level, slot_factor, states, cols,
                        int(counts[k]))
            used = _read("shard.vox_used", [st.vox_used for st in states],
                         mesh.devices[0])
            for s, u in enumerate(used):
                if u > wm:
                    states[s] = build.compact_voxels_auto(cfg, states[s],
                                                          used=u)
        return states

    return chunk


def sharded_compact(cfg: EngineConfig, mesh: Mesh, states: list[OctreeState],
                    used: list[int] | None = None) -> list[OctreeState]:
    """Voxel compaction of every shard over exactly its live rows. `used` are
    the shards' watermarks if the caller already read them."""
    if used is None:
        used = _read("shard.compact_used", [st.vox_used for st in states],
                     mesh.devices[0])
    return [build.compact_voxels_auto(cfg, st, used=u)
            for st, u in zip(states, used)]


def sharded_finish_splits(cfg: EngineConfig, mesh: Mesh,
                          states: list[OctreeState],
                          max_rounds: int = 32) -> list[OctreeState]:
    """End-of-load split convergence on every shard (the sharded analogue of
    Engine.finish_splits): per-shard forced splits until no shard has an
    overfull leaf, all shards' counts read in one device read per round. A
    converged shard skips the pass (the JAX package runs it with an all -1
    selection, which changes nothing)."""
    for _ in range(max_rounds):
        sel = [build.overfull_leaf_ids(cfg, st) for st in states]
        over = _read("shard.overfull", [k for _, k in sel], mesh.devices[0])
        if max(over) == 0:
            break
        states = [build.split_finish(cfg, st, ids) if k > 0 else st
                  for st, (ids, _), k in zip(states, sel, over)]
    return states
