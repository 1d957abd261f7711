"""The build step's read-free stretches as CUDA graphs.

octree/build.py runs a step as six stretches between its device reads
(build._build): route and the round-1 selection; the spill gather and the
round-1 children (one variant with stored points to spill, one without); a
cascade round (once per read that finds a split); the leftover leaves, the
re-route, the segment surgery and the voxel candidates (the two variants
again); a multi-level candidate round (once per round the read counts); the
insert. Eagerly each stretch is some hundreds of small torch ops, and the
host's dispatch of them, not the card, sets a step's time. The JAX package
jits the whole step; here `BuildGraphs` captures each stretch once per key
and replays it after that. The reads stay where they are.

What makes a replay equal to the eager stretch:
  - a graph reads and writes every tensor where it lay at capture. The state
    keeps its tensors (the builder writes it in place, Engine.reset
    re-initialises it in place), the step's x, y, z, rgba and count are
    copied into input columns the cache owns, and what one stretch hands the
    next lives in slots the cache owns, each stretch writing its outputs
    into them. Slots and inputs are made per step key: (cfg, step width, the
    pointer and shape of every state tensor), and never move under it;
  - the first step that meets a stretch key runs the stretch eagerly (the
    step's work) and then records it: a recording runs nothing. Later steps
    replay it, on the stream the eager step would have used;
  - the round a candidate round emits is a device counter in its slot, which
    the graph itself advances, never a Python value baked into a recording;
  - all graphs of a cache share one memory pool: they run one after another
    on one stream, and nothing a graph allocates outlives its replay (what
    crosses stretches is in the slots, outside the pool).

Every stretch passes through one of the spans `build.replay`,
`build.capture` (the eager run and the recording) or `build.eager` (the
stretches of a state that no cache takes, build.eager).
"""
from __future__ import annotations

import collections
import functools
import time

import torch

from ..utils import trace

# step keys a cache holds (each with its slots, inputs and graphs) before it
# starts over
MAX_STEP_KEYS = 4


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
            t0 = time.perf_counter()
            self._check(stretch, args)
            out = self._store(fn(*args), make=True)   # this step's work
            graph = cache.record(lambda: self._store(fn(*args)), self.device)
            self.graphs[(stretch, branch)] = (graph, out)
            cache.captures[stretch] += 1
            cache.capture_seconds += time.perf_counter() - t0
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

    def _store(self, out: dict, make: bool = False) -> dict:
        """Copy each role's tensors into its slots (made on the eager run of
        a stretch, `make`; never while recording) -> {role: slot pytree}."""
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
                    if not make:
                        raise RuntimeError(f"build role {role!r}: no slot "
                                           "for a recorded output")
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


class BuildGraphs:
    """The build step's stretches as CUDA graphs, one per (step key,
    stretch, branch): the port's counterpart of the JAX package's jitted
    build step (see the module docstring). `step(...)` copies a step's
    inputs into the columns of its key and returns the runner that
    build._build calls for each stretch. `captures` and `replays` count per
    stretch. `record(span, device)` makes a graph without running it
    (render.record_cuda_graph with the cache's pool); tests inject another
    `capture(span, device)`, and with it `device_type`, the type of the
    states the cache takes (the card's)."""

    def __init__(self, capture=None, device_type: str = "cuda"):
        self.capture = capture
        self.device_type = device_type
        self.captures = collections.Counter()
        self.replays = collections.Counter()
        self.capture_seconds = 0.0
        self.clear()

    def clear(self) -> None:
        """Drop every graph, slot and input column, and the memory pool."""
        self._steps: dict = {}
        self._pool = None

    def __len__(self) -> int:
        return sum(len(s.graphs) for s in self._steps.values())

    def applies(self, state) -> bool:
        """Whether this cache builds on `state` (its device type)."""
        return state.device.type == self.device_type

    def step(self, cfg, state, x, y, z, rgba, count: int):
        """The inputs of a step in the columns of its key -> (runner,
        (x, y, z, rgba, count) as those columns)."""
        key = (cfg, x.shape[0],
               tuple((t.data_ptr(), t.shape) for t in _state_tensors(state)))
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

    def record(self, span, device):
        """A graph of span() that has not run."""
        if self.capture is not None:
            return self.capture(span, device)
        from ..render.render import record_cuda_graph
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return record_cuda_graph(span, device, self._pool)
