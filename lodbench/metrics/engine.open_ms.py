"""engine.open_ms: the mean seconds of Engine.open (the program's
`engine.open` span: sizing the config, starting the point stream, a fresh
octree), in ms, over the run's loads."""
from lodbench import spans


def read(rec):
    t = spans.totals()
    if not t or "engine.open" not in t:
        return None
    return 1e3 * t["engine.open"]["seconds"] / t["engine.open"]["count"]
