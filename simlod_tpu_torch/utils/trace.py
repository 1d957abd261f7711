"""Host spans and device reads of the port, on one accumulator.

  - `span(name)` times a block on the host clock and adds its seconds and a
    count to the per-name total (`Timings`). While torch.profiler runs, it is
    also a `record_function` of the same name: the span then lies on the
    profiler's timeline, on the clock of the device's events, so a gap of
    the device is put down to the innermost span around it. With no
    profiler it costs two clock reads and a locked add.
  - `sync(site, t)` is the port's one device read: `t.tolist()` inside the
    span `sync.<site>`. Every total carries `sync_s`, the seconds of the
    reads nested in its spans at any depth, so a span's own host time is
    `seconds - sync_s`. `reads()` counts the reads; the engines count their
    own (`host_syncs`) as its difference around their calls.
  - `add(name, seconds)` adds an interval that no one block holds (one
    that starts in one thread and ends in another) to the same totals.
  - `snapshot()` and `since(snap)` give the totals made in between, per
    name: {count, seconds, sync_s}.

Span stacks are per thread; totals may be added from any thread. A span
run in a thread the profiler did not start (the stream's uploader) is
counted on the host clock but does not reach the profiler's timeline.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import torch


@dataclasses.dataclass
class Timings:
    """count / total / min / max accumulator (reference benchmark mode,
    :234-246), with the seconds of device reads nested in the spans that
    were added (`sync`)."""

    count: int = 0
    total: float = 0.0
    min: float = float("inf")
    max: float = 0.0
    sync: float = 0.0

    def add(self, dt: float, sync: float = 0.0):
        self.count += 1
        self.total += dt
        if dt < self.min:
            self.min = dt
        if dt > self.max:
            self.max = dt
        self.sync += sync

    @property
    def avg(self) -> float:
        return self.total / self.count if self.count else 0.0

    def row(self) -> dict:
        return dict(count=self.count, avg_ms=self.avg * 1e3,
                    min_ms=self.min * 1e3 if self.count else 0.0,
                    max_ms=self.max * 1e3)


_lock = threading.Lock()
_totals: dict[str, Timings] = {}
_reads = 0
_local = threading.local()


def _thread():
    """This thread's open span names and the read seconds it has spent."""
    t = getattr(_local, "t", None)
    if t is None:
        t = _local.t = _Thread()
    return t


class _Thread:
    __slots__ = ("stack", "sync_s")

    def __init__(self):
        self.stack: list[str] = []
        self.sync_s = 0.0


class span:
    """Context manager: time the block under `name` (see the module's
    docstring); `into` is a Timings that takes the same add besides."""

    __slots__ = ("name", "into", "_t", "_t0", "_s0", "_depth", "_rf")

    def __init__(self, name: str, into: Timings | None = None):
        self.name = name
        self.into = into

    def __enter__(self):
        t = self._t = _thread()
        self._depth = len(t.stack)
        t.stack.append(self.name)
        self._rf = None
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self._s0 = t.sync_s
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        t = self._t
        if self.name.startswith("sync."):
            t.sync_s += dt
        sync = t.sync_s - self._s0
        if self._rf is not None:
            self._rf.__exit__(*exc)
        # spans opened inside this one and left open close with it
        del t.stack[self._depth:]
        add(self.name, dt, sync, self.into)
        return False


def add(name: str, seconds: float, sync: float = 0.0,
        into: Timings | None = None):
    """Add `seconds` (of which `sync` in device reads) to the total of
    `name`, and to `into` besides; host clock only, never on the
    profiler's timeline."""
    with _lock:
        tot = _totals.get(name)
        if tot is None:
            tot = _totals[name] = Timings()
        tot.add(seconds, sync)
        if into is not None:
            into.add(seconds, sync)


def sync(site: str, t: torch.Tensor):
    """Read `t` to the host in one device read (`tolist`: a Python number
    for a 0-d tensor), inside the span `sync.<site>`, and count it."""
    global _reads
    with span("sync." + site):
        out = t.tolist()
    with _lock:
        _reads += 1
    return out


def reads() -> int:
    """Device reads made through `sync` so far, by every thread."""
    return _reads


def open_spans() -> tuple[str, ...]:
    """The names of this thread's open spans, outermost first."""
    return tuple(_thread().stack)


def snapshot() -> dict:
    """The totals now: pass to `since`."""
    with _lock:
        return {n: (t.count, t.total, t.sync) for n, t in _totals.items()}


def since(snap: dict | None = None) -> dict:
    """The totals added after `snap` (all of them without one): {name:
    {count, seconds, sync_s}} for every name that took an add."""
    now, snap = snapshot(), snap or {}
    out = {}
    for name, (c, s, y) in now.items():
        c0, s0, y0 = snap.get(name, (0, 0.0, 0.0))
        if c > c0:
            out[name] = dict(count=c - c0, seconds=s - s0, sync_s=y - y0)
    return out
