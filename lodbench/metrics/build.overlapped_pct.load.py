"""build.overlapped_pct.load: the share of the loads' streamed items whose
build was dispatched while the stream's uploader had not yet queued its
last plane set (the program's `load.item_overlapped` spans) among all the
items `load_all` built (`load.item`), in %, over the run's loads. Nothing
(None) where the program has no `load.item` spans."""
from lodbench import spans


def read(rec):
    t = spans.totals()
    if not t or "load.item" not in t:
        return None
    overlapped = t.get("load.item_overlapped", {}).get("count", 0)
    return 100.0 * overlapped / t["load.item"]["count"]
