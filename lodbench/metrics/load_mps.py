"""load_mps: millions of points loaded a second, over whole loads run back
to back from the window's start to the end of its last load."""
from lodbench import arith


def read(rec):
    w = rec["window"]
    return arith.rate(sum(x["points"] for x in w["loads"]), w["window_s"]) / 1e6
