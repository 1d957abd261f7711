"""The share of the traced stretch in which the card ran no kernel, copy
or set (100 minus the union of their intervals over the stretch's wall
time, torch.profiler)."""
from lodbench import arith


def read(rec):
    t = rec["trace"]
    return arith.idle_pct(t["busy_s"], t["window_s"])
