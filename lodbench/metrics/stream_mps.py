"""stream_mps: millions of points the simultaneous loop built a second,
over the whole window (re-opens included)."""
from lodbench import arith


def read(rec):
    w = rec["window"]
    return arith.rate(w["points"], w["window_s"]) / 1e6
