"""build.host_ms_per_step: the host's own time per build step (the
program's `build.step` spans, less the device reads inside them), in ms,
over the run's steps."""
from lodbench import spans


def read(rec):
    t = spans.totals()
    if not t or "build.step" not in t:
        return None
    s = t["build.step"]
    return 1e3 * (s["seconds"] - s["sync_s"]) / s["count"]
