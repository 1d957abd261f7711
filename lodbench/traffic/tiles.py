"""The out-of-core survey build: passes back to back, each
OutOfCoreEngine.open of the survey's folder, then build_all (every tile
built as one brick through the one device engine over the union cube,
compacted and evicted to host memory), ending in a device sync. The folder
stays in the page cache after the warm-up pass. The device engine's
point pool holds the largest tile (EngineConfig.auto of its size, with the
configuration's `engine` keys), not the survey. Each pass is one entry of
`window["loads"]`: `points` (the survey's), `seconds`, `bricks`,
`evicted_bytes` (the bytes the bricks hold on the host, counted by
tiles_reference.evicted_bytes) and the program's span totals of that pass
(`spans`; None where the program has none). The loop's `eng` is the device
engine. The answers checked are the last pass's bricks, held to the tiles
by lodbench/tiles_reference.py. No frame is drawn."""
import time

from lodbench import tiles_reference as tiles
from lodbench.devtrace import span
from lodbench.loops import Loop


def _trace():
    """The program's span totals module, or None."""
    try:
        from simlod_tpu_torch.utils import trace
    except ImportError:     # a program without spans
        return None
    return trace


class TilesLoop(Loop):
    def __init__(self, ctx):
        from simlod_tpu_torch.config import EngineConfig, Settings
        from simlod_tpu_torch.outofcore import OutOfCoreEngine
        self.ctx = ctx
        counts = tiles.tile_counts(tiles.tile_paths(ctx.path))
        self.points = sum(counts)
        cfg = ctx.engine_cfg or EngineConfig.auto(
            total_points=max(counts), device=ctx.device, **ctx.overrides)
        self.ooc = OutOfCoreEngine(cfg, Settings(**ctx.settings),
                                   device=ctx.device)
        self.eng = self.ooc.engine
        self.answers = 0

    def one(self) -> dict:
        """One pass over the survey -> its record."""
        ooc = self.ooc
        trace = _trace()
        snap = trace.snapshot() if trace else None
        t0 = time.perf_counter()
        with span("OutOfCoreEngine.open"):
            ooc.open([self.ctx.path])
        with span("OutOfCoreEngine.build_all"):
            ooc.build_all()
        self.sync()
        seconds = time.perf_counter() - t0
        self.answers += 1
        return dict(points=self.points, seconds=seconds,
                    bricks=len(ooc.bricks),
                    evicted_bytes=tiles.evicted_bytes(ooc.bricks),
                    spans=trace.since(snap) if trace else None)

    def setup(self):
        self.one()

    def window(self, seconds: float) -> dict:
        loads = []
        t0 = time.perf_counter()
        while True:
            loads.append(self.one())
            if time.perf_counter() - t0 >= seconds:
                break
        return dict(loads=loads, window_s=time.perf_counter() - t0)

    stretch = window

    def check(self, scan) -> dict:
        self.eng.stream.stop()
        return tiles.survey_numbers(self.ooc.bricks, self.ctx.path, scan,
                                    self.ctx)

    def info(self, window: dict) -> dict:
        loads = window["loads"]
        return dict(pass_s=[x["seconds"] for x in loads],
                    bricks=loads[-1]["bricks"],
                    evicted_bytes=loads[-1]["evicted_bytes"])


LOOP = TilesLoop
