"""stream_frame_p95_ms: the 95th percentile of the wall time of every
Engine.frame call of the window."""
from lodbench import arith


def read(rec):
    return 1e3 * arith.p95(rec["window"]["frame_s"])
