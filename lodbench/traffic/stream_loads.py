"""The simultaneous drag-and-drop loads: traffic/stream.py's loop
(Engine.open with chunk_steps, then Engine.frame under the app's orbit
until the stream is drained), its window made of whole loads back to back,
each a record of its own: `points`, `seconds` (open to the last frame),
`frames`, `steps`, `host_syncs`, the program's frame counters
(`fused_frames`; `redraws` and `tail_rows`, the tail voxel rows its fused
frames drew, None where the program counts none), the load's frame times
(`frame_s`) and the program's span totals of that load (`spans`; None
where the program has none). load_mps reads the loads; the per-layer
readers read each load's spans and counters. The answers checked are the
stream loop's: every frame untruncated, one fused frame drawn from the
seed against the reference's frame of the same octree, the last load's
octree and the frame after it."""
import time

from lodbench import found

StreamLoop = found.module("traffic", "stream").StreamLoop


def _trace():
    """The program's span totals module, or None."""
    try:
        from simlod_tpu_torch.utils import trace
    except ImportError:     # a program without spans
        return None
    return trace


class StreamLoadsLoop(StreamLoop):
    def load(self) -> list:
        """StreamLoop.load, and where a load of the window kept no frame
        (none at or after the frame drawn from the seed could be checked:
        the frames a load splits into follow the host's clock), the frame
        kept next is sought from this load's last that could be."""
        frames = super().load()
        if self.kept is None and self.copy_at is not None:
            fit = [i for i, (_, ok) in enumerate(frames) if ok]
            if fit:
                self.copy_at = min(self.copy_at, fit[-1])
        return frames

    def one(self) -> dict:
        """One whole simultaneous load -> its record."""
        eng = self.eng
        trace = _trace()
        snap = trace.snapshot() if trace else None
        t0 = time.perf_counter()
        frames = self.load()
        seconds = time.perf_counter() - t0
        return dict(points=eng.stream.total_points, seconds=seconds,
                    frames=eng.frames, steps=eng.steps,
                    host_syncs=eng.host_syncs,
                    fused_frames=eng.t_fused.count,
                    redraws=getattr(eng, "redraws", None),
                    tail_rows=getattr(eng, "tail_rows", None),
                    frame_s=[dt for dt, _ in frames],
                    spans=trace.since(snap) if trace else None)

    def window(self, seconds: float) -> dict:
        loads = []
        t0 = time.perf_counter()
        while True:
            loads.append(self.one())
            if time.perf_counter() - t0 >= seconds:
                break
        window = time.perf_counter() - t0
        frame_s = [dt for x in loads for dt in x["frame_s"]]
        self.answers += len(frame_s)
        return dict(loads=loads, frame_s=frame_s, window_s=window,
                    points=sum(x["points"] for x in loads))

    stretch = window

    def info(self, window: dict) -> dict:
        loads = window["loads"]
        return dict(super().info(window),
                    load_s=[x["seconds"] for x in loads],
                    frames=[x["frames"] for x in loads],
                    redraws=[x["redraws"] for x in loads])


LOOP = StreamLoadsLoop
