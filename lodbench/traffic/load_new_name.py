"""The load loop with a file the process has not opened: whole drag-and-drop
loads back to back (Engine.open, then load_all, ending in a device sync),
as traffic/load.py runs them, each of the scan under a name not seen
before: a fresh hard link to the same inode (the bytes stay in the page
cache), removed after the load. A program that keeps anything by a file's
name (a decode cache) finds nothing kept, as a user opening one tile after
another does. Each load also returns the program's span totals of that
load (`spans`) and the LAZ chunks its stream decoded (`laz_chunks`; None
where the program counts none); the run's line lists both a load under
`info` (`laz_chunks`, and `first_item_ms` from the program's
`stream.first_item` span: the stream's start to its first plane set). The
answer checked is the octree of the window's last load."""
import dataclasses
import itertools
import os
import time

from lodbench import found
from lodbench.devtrace import span

LoadLoop = found.module("traffic", "load").LoadLoop


def _trace():
    """The program's span totals module, or None."""
    try:
        from simlod_tpu_torch.utils import trace
    except ImportError:     # a program without spans
        return None
    return trace


class NewNameLoadLoop(LoadLoop):
    def __init__(self, ctx):
        super().__init__(ctx)
        self._names = itertools.count()

    def one(self) -> dict:
        eng, ctx = self.eng, self.ctx
        stem, suffix = os.path.splitext(ctx.path)
        fresh = f"{stem}-{next(self._names)}{suffix}"
        os.link(ctx.path, fresh)
        trace = _trace()
        snap = trace.snapshot() if trace else None
        try:
            t0 = time.perf_counter()
            with span("Engine.open"):
                dataclasses.replace(ctx, path=fresh).open(eng)
            with span("Engine.load_all"):
                eng.load_all()
            self.sync()
            seconds = time.perf_counter() - t0
        finally:
            os.remove(fresh)
        self.answers += 1
        return dict(points=eng.stream.total_points, seconds=seconds,
                    host_syncs=eng.host_syncs, t_decode=eng.stream.t_decode,
                    laz_chunks=getattr(eng.stream, "laz_chunks", None),
                    spans=trace.since(snap) if trace else None)

    def info(self, window: dict) -> dict:
        def first_item_ms(x):
            t = (x["spans"] or {}).get("stream.first_item")
            return 1e3 * t["seconds"] / t["count"] if t else None
        loads = window["loads"]
        return dict(super().info(window),
                    laz_chunks=[x["laz_chunks"] for x in loads],
                    first_item_ms=[first_item_ms(x) for x in loads])


LOOP = NewNameLoadLoop
