"""streaming.wait_pct.load: the share of the loads' seconds (Engine.open
and load_all) in which the engine waited on the point stream for its next
item (the program's `stream.wait` spans), over the run's loads."""
from lodbench import spans


def read(rec):
    t = spans.totals()
    total = t and spans.load_seconds(t)
    if not total or "stream.wait" not in t:
        return None
    return 100.0 * t["stream.wait"]["seconds"] / total
