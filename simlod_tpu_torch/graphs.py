"""The port's CUDA graphs: the recorder, and the two caches that replay
through it, the build step's stretches (BuildGraphs) and the frames
(FrameGraphs). They stand for what the JAX package jits: its build step, and
render_frame / render_frame_pooled on their static arguments.

Both caches keep one protocol. The first sight of a key runs its span
eagerly, as the step's or the frame's real work, and returns that result;
then it records the span without running it (record_cuda_graph). Every
later sight replays the graph. A graph reads and writes every tensor where
it lay when it was recorded, so a key holds the pointer and shape of every
tensor its span reads (_tensor_key). A cache makes graphs only on devices
of its `device_type` (the card's, `applies`); tests inject `record(span,
device)` in place of record_cuda_graph, and with it the CPU's type.

The build: octree/build.py runs a step as six stretches between its device
reads (build._build): route and the round-1 selection; the spill gather and
the round-1 children (one variant with stored points to spill, one
without); a cascade round (once per read that finds a split); the leftover
leaves, the re-route, the segment surgery and the voxel candidates (the two
variants again); a multi-level candidate round (once per round the read
counts); the insert. Eagerly each stretch is some hundreds of small torch
ops, and the host's dispatch of them, not the card, sets a step's time.
What makes a replay equal to the eager stretch:
  - the state keeps its tensors (build.py writes it in place,
    Engine.reset re-initialises it in place), the step's x, y, z, rgba and
    count are copied into input columns the cache owns, and what one stretch
    hands the next lives in slots the cache owns, each stretch writing its
    outputs into them. Slots and inputs are made per step key: (cfg, step
    width, the pointer and shape of every state tensor), and never move
    under it;
  - a replay runs on the stream the eager step would have used;
  - the round a candidate round emits is a device counter in its slot, which
    the graph itself advances, never a Python value baked into a recording;
  - all graphs of a cache share one memory pool: they run one after another
    on one stream, and nothing a graph allocates outlives its replay (what
    crosses stretches is in the slots, outside the pool).
Every stretch passes through one of the spans `build.replay`,
`build.capture` (the eager run and the recording) or `build.eager` (the
stretches of a state that no cache takes, build.eager).

The frames: Engine.render runs a frame's span (render_frame or
render_frame_pooled, then the Stats tensors) through FrameGraphs, keyed by
render.frame_key. Each frame graph has a memory pool of its own, which the
LRU frees when it evicts the graph.
"""
from __future__ import annotations

import collections
import functools
import gc
import time
from typing import NamedTuple

import torch

from . import kernels
from .utils import trace

# step keys a BuildGraphs holds (each with its slots, inputs and graphs)
# before it starts over
MAX_STEP_KEYS = 4
# graphs a FrameGraphs keeps (each with its memory pool) before it evicts
MAX_GRAPHS = 4


class CapturedFrame(NamedTuple):
    """A span recorded as one CUDA graph: `outputs` are the graph's own
    tensors, which each replay overwrites; `launches` the kernel launches
    the recording holds, per wrapper."""
    graph: object
    outputs: object
    launches: tuple              # ((wrapper, launches a replay makes), ...)

    def replay(self) -> None:
        """Run the graph on the card; each wrapper counts the launches its
        kernel makes in it."""
        self.graph.replay()
        for fn, n in self.launches:
            fn.launches += n


def record_cuda_graph(span, device, pool=None) -> CapturedFrame:
    """Record `span()` as a CUDA graph on `device` without running it (a
    span whose first use has happened). The recording runs on a stream of
    its own in thread-local mode (the stream's loader threads may copy
    meanwhile), in `pool` (torch.cuda.graph_pool_handle: a memory pool
    shared with graphs that never run at the same time as this one) or
    else a private pool. A recording launches nothing, so the counts of
    the wrappers in kernels.COUNTED are set back to what they were; a
    replay adds them. The cyclic garbage collector waits while it records:
    a collection could free another graph, which CUDA forbids while a
    stream captures. An error raises."""
    with torch.cuda.device(device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fns = tuple(kernels.COUNTED)
            before = [f.launches for f in fns]
            graph = torch.cuda.CUDAGraph()
            collecting = gc.isenabled()
            gc.disable()
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                outputs = span()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass        # the span's own error is the one to raise
                raise
            else:
                graph.capture_end()
            finally:
                if collecting:
                    gc.enable()
                made = [f.launches - b for f, b in zip(fns, before)]
                for f, b in zip(fns, before):
                    f.launches = b
        torch.cuda.current_stream().wait_stream(side)
    return CapturedFrame(graph, outputs,
                         tuple((f, n) for f, n in zip(fns, made) if n))


def _tensor_key(obj) -> tuple:
    """(pointer, shape) of every tensor field of a dataclass or NamedTuple:
    a graph reads each tensor where it lay when it was recorded, so a
    replaced tensor (a compaction, a pool rebuild, a new state) changes the
    key."""
    if obj is None:
        return ()
    vals = obj if isinstance(obj, tuple) else vars(obj).values()
    return tuple((t.data_ptr(), t.shape) for t in vals
                 if isinstance(t, torch.Tensor))


class _GraphCache:
    """What both caches share: the devices they take, the recorder and the
    first sight of a key (see the module docstring)."""

    def __init__(self, record=None, device_type: str = "cuda"):
        self.record = record
        self.device_type = device_type
        self.capture_seconds = 0.0

    def applies(self, device) -> bool:
        """Whether this cache makes graphs on `device` (its type); a span
        on any other device runs eagerly."""
        return torch.device(device).type == self.device_type

    def _pool(self):
        """The memory pool a new graph records into (None: its own)."""
        return None

    def _first_sight(self, span, device):
        """span() run eagerly -> (its result, a graph of span that has not
        run)."""
        t0 = time.perf_counter()
        out = span()
        if self.record is not None:
            graph = self.record(span, device)
        else:
            graph = record_cuda_graph(span, device, self._pool())
        self.capture_seconds += time.perf_counter() - t0
        return out, graph


def _flatten(tree, leaves: list):
    """Append the tensors of a pytree of (named) tuples to `leaves`; return
    its structure: the tuple types and lengths, None for a tensor."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return None
    if isinstance(tree, tuple):
        return (type(tree), tuple(_flatten(v, leaves) for v in tree))
    raise TypeError(f"a stretch hands on tensors and tuples of them, not "
                    f"{type(tree).__name__}")


def _unflatten(spec, leaves):
    """The pytree of `spec` (see _flatten) over the tensors of `leaves` (an
    iterator)."""
    if spec is None:
        return next(leaves)
    kind, parts = spec
    vals = [_unflatten(p, leaves) for p in parts]
    return kind(*vals) if hasattr(kind, "_fields") else kind(vals)


def _state_tensors(state) -> list:
    return [t for t in vars(state).values() if isinstance(t, torch.Tensor)]


class _StepSlots:
    """What the stretches of one step key read and write besides the state:
    the input columns, the count, the slots of each role and the graphs.
    It holds no reference back to its cache: a cache, and the graphs in it,
    is freed as soon as its owner drops it, never by a cyclic collection
    that could run while another graph records (CUDA forbids destroying a
    graph while a stream captures)."""

    def __init__(self, state, inputs):
        self.state = state
        self.device = state.device
        self.inputs = tuple(torch.empty_like(t) for t in inputs)
        self.count = torch.zeros((), dtype=torch.int32, device=self.device)
        self.slots: dict = {}       # (role, leaf index) -> tensor
        self.specs: dict = {}       # role -> structure
        self.trees: dict = {}       # role -> the pytree of its slots
        self.graphs: dict = {}      # (stretch, branch) -> (graph, outputs)

    def run(self, cache: "BuildGraphs", stretch: str, branch, fn,
            *args) -> dict:
        """fn(*args) of a stretch (see build._build): replayed once its key
        was captured, else run eagerly and recorded. Returns its {role:
        value} in the slots."""
        hit = self.graphs.get((stretch, branch))
        if hit is not None:
            with trace.span("build.replay"):
                hit[0].replay()
            cache.replays[stretch] += 1
            return hit[1]
        with trace.span("build.capture"):
            self._check(stretch, args)
            out, graph = cache._first_sight(lambda: self._store(fn(*args)),
                                            self.device)
            self.graphs[(stretch, branch)] = (graph, out)
            cache.captures[stretch] += 1
        return out

    def _check(self, stretch: str, args) -> None:
        """Every tensor a stretch is given lies in the state, the inputs or
        the slots: the step key covers where each lies."""
        known = {id(t) for t in _state_tensors(self.state)}
        known.update(id(t) for t in self.slots.values())
        known.update(id(t) for t in (*self.inputs, self.count))
        for a in args:
            if a is self.state or not isinstance(a, (tuple, torch.Tensor)):
                continue
            leaves = []
            _flatten(a, leaves)
            if any(id(t) not in known for t in leaves):
                raise ValueError(f"build stretch {stretch!r}: an argument "
                                 "lies outside the state, inputs and slots")

    def _store(self, out: dict) -> dict:
        """Copy each role's tensors into its slots -> {role: slot pytree}.
        The eager run of a stretch makes its slots; the recording, whose
        roles have the same structure, finds them."""
        res = {}
        for role, tree in out.items():
            leaves = []
            spec = _flatten(tree, leaves)
            if self.specs.setdefault(role, spec) != spec:
                raise ValueError(f"build role {role!r} changed its structure")
            slots = []
            for i, leaf in enumerate(leaves):
                slot = self.slots.get((role, i))
                if slot is None:
                    slot = self.slots[(role, i)] = torch.empty(
                        leaf.shape, dtype=leaf.dtype, device=leaf.device)
                elif slot.shape != leaf.shape or slot.dtype != leaf.dtype:
                    raise ValueError(f"build role {role!r}: output {i} is "
                                     f"{leaf.dtype} {tuple(leaf.shape)}, its "
                                     f"slot {slot.dtype} {tuple(slot.shape)}")
                if leaf is not slot:
                    slot.copy_(leaf)
                slots.append(slot)
            if role not in self.trees:
                self.trees[role] = _unflatten(spec, iter(slots))
            res[role] = self.trees[role]
        return res


class BuildGraphs(_GraphCache):
    """The build step's stretches as CUDA graphs, one per (step key,
    stretch, branch), all in one memory pool (see the module docstring).
    `step(...)` copies a step's inputs into the columns of its key and
    returns the runner that build._build calls for each stretch. `captures`
    and `replays` count per stretch."""

    def __init__(self, record=None, device_type: str = "cuda"):
        super().__init__(record, device_type)
        self.captures = collections.Counter()
        self.replays = collections.Counter()
        self.clear()

    def clear(self) -> None:
        """Drop every graph, slot and input column, and the memory pool."""
        self._steps: dict = {}
        self._shared_pool = None

    def __len__(self) -> int:
        return sum(len(s.graphs) for s in self._steps.values())

    def _pool(self):
        if self._shared_pool is None:
            self._shared_pool = torch.cuda.graph_pool_handle()
        return self._shared_pool

    def step(self, cfg, state, x, y, z, rgba, count: int):
        """The inputs of a step in the columns of its key -> (runner,
        (x, y, z, rgba, count) as those columns)."""
        key = (cfg, x.shape[0], _tensor_key(state))
        slots = self._steps.get(key)
        if slots is None:
            if len(self._steps) >= MAX_STEP_KEYS:
                self.clear()
            slots = self._steps[key] = _StepSlots(state, (x, y, z, rgba))
        for dst, src in zip(slots.inputs, (x, y, z, rgba)):
            dst.copy_(src)
        slots.count.fill_(count)
        return (functools.partial(slots.run, self),
                (*slots.inputs, slots.count))


class FrameGraphs(_GraphCache):
    """Frames as CUDA graphs, one per static key (render.frame_key), in an
    LRU of MAX_GRAPHS. `run(key, span, device)` returns span()'s tensors:
    the eager frame's on the first sight of its key, else the graph's,
    which the next replay overwrites. Each graph holds its memory pool
    until the LRU evicts it or the cache is dropped."""

    def __init__(self, record=None, device_type: str = "cuda"):
        super().__init__(record, device_type)
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self.captures = 0
        self.replays = 0

    def __len__(self) -> int:
        return len(self._graphs)

    def run(self, key, span, device):
        graph = self._graphs.get(key)
        if graph is not None:
            self._graphs.move_to_end(key)
            graph.replay()
            self.replays += 1
            return graph.outputs
        out, self._graphs[key] = self._first_sight(span, device)
        self.captures += 1
        if len(self._graphs) > MAX_GRAPHS:
            self._graphs.popitem(last=False)
        return out

    def clear(self) -> None:
        """Drop every graph (and its memory pool)."""
        self._graphs.clear()
