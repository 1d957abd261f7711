"""outofcore.evict_pct.tiles: the share of the window's passes (host clock,
open to the device sync after the last brick) spent evicting bricks to host
memory (the program's `ooc.evict` spans: the eviction's read and the copies
of the used prefixes), in %. Nothing (None) where the program has no such
span."""


def read(rec):
    loads = rec["window"]["loads"]
    evict = [(x.get("spans") or {}).get("ooc.evict") for x in loads]
    if not all(evict):
        return None
    return 100.0 * sum(t["seconds"] for t in evict) \
        / sum(x["seconds"] for x in loads)
