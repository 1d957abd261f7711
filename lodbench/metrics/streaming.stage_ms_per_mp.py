"""streaming.stage_ms_per_mp: the uploader thread's seconds of staging
(the program's `stream.stage` spans: the copies into pinned planes and the
H2D copy launches), per million points loaded, over the run's loads."""
from lodbench import spans


def read(rec):
    t = spans.totals()
    if not t or "stream.stage" not in t or "engine.load_all" not in t:
        return None
    mp = t["engine.load_all"]["count"] * rec["window"]["loads"][0]["points"]
    return 1e3 * t["stream.stage"]["seconds"] / (mp / 1e6)
