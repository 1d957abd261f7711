"""A traced stretch of a cell's traffic under torch.profiler (CPU and CUDA
activities), reduced to what the per-layer metrics read: the device's busy
time over the stretch (the union of kernel, copy and set intervals), the
device time of named kernels and how many launches of them the trace holds,
the device operations that took most time, and the longest idle gaps with
what the host was doing in each."""
from __future__ import annotations

import contextlib

import torch

SPAN = "lodbench.stretch"


@contextlib.contextmanager
def span(name: str):
    """A host span of the benchmark's own, around a call into the program
    (torch.profiler's user annotation; nothing when no profiler runs)."""
    with torch.profiler.record_function(name):
        yield


def traced(fn, kernels: dict[str, tuple[str, ...]] | None = None) -> tuple:
    """Run fn() under the profiler -> (fn's result, trace summary dict).

    `kernels` maps a group name to the substrings of the kernel names it
    sums: the summary holds each group's device seconds and launch count."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(SPAN):
            out = fn()
            torch.cuda.synchronize()
    return out, summarize(prof.profiler.kineto_results.events(), kernels or {})


def _union(intervals) -> float:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def summarize(events, kernels: dict) -> dict:
    """Reduce kineto events to the summary (times in seconds)."""
    stretch = None
    host, dev = [], []
    spans = {SPAN}
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append((e.start_ns(), e.end_ns(), e.name(),
                        e.is_user_annotation()))
        else:
            if e.name() == SPAN:
                stretch = (e.start_ns(), e.end_ns())
            if e.is_user_annotation():
                spans.add(e.name())
            host.append((e.start_ns(), e.end_ns(), e.name()))
    if stretch is None:
        raise RuntimeError("the trace holds no stretch span")
    lo, hi = stretch
    # a host span's copy on the device timeline is no device work
    dev = [(max(s, lo), min(e, hi), n) for s, e, n, note in dev
           if e > lo and s < hi and not note and n not in spans]
    busy = _union((s, e) for s, e, _ in dev)
    by_name: dict[str, float] = {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0) + (e - s)
    groups = {}
    for g, subs in kernels.items():
        hit = [(s, e) for s, e, n in dev if any(x in n for x in subs)]
        groups[g] = dict(seconds=sum(e - s for s, e in hit) * 1e-9,
                         launches=len(hit))
    gaps = _gaps(sorted((s, e) for s, e, _ in dev), lo, hi)
    host.sort()
    top_gaps = [[_doing(host, (s + e) // 2), (e - s) * 1e-9]
                for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:10]]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(
        window_s=(hi - lo) * 1e-9, busy_s=busy * 1e-9,
        device_events=len(dev), kernels=groups,
        device_ops=[[n[:160], v * 1e-9] for n, v in ops],
        idle_gaps=top_gaps)


def _gaps(intervals, lo, hi) -> list:
    """Idle intervals of the device between lo and hi."""
    out, end = [], lo
    for s, e in intervals:
        if s > end:
            out.append((end, s))
        end = max(end, e)
    if hi > end:
        out.append((end, hi))
    return out


def _doing(host, t) -> str:
    """The innermost host span or op running at time t."""
    best = None
    for s, e, n in host:
        if s > t:
            break
        if e >= t and n != SPAN:
            best = n
    return (best or "host (no op)")[:160]
