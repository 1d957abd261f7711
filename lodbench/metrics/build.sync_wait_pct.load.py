"""build.sync_wait_pct.load: the share of the loads' seconds (Engine.open
and load_all) spent in device reads (the program's `sync.<site>` spans,
counted in each load span's `sync_s`), over the run's loads."""
from lodbench import spans


def read(rec):
    t = spans.totals()
    total = t and spans.load_seconds(t)
    if not total:
        return None
    return 100.0 * (t["engine.open"]["sync_s"]
                    + t["engine.load_all"]["sync_s"]) / total
