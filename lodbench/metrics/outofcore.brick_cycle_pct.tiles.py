"""outofcore.brick_cycle_pct.tiles: the part of a brick outside its build,
over the window's passes: 100 x (the program's `ooc.brick` seconds -
its `engine.load_all` seconds) / `ooc.brick` seconds, in %. The rest of a
brick is the engine's open, the forced compaction and the eviction.
Nothing (None) where the program has no `ooc.brick` span."""


def read(rec):
    brick = load_all = 0.0
    for x in rec["window"]["loads"]:
        t = x.get("spans") or {}
        if "ooc.brick" not in t or "engine.load_all" not in t:
            return None
        brick += t["ooc.brick"]["seconds"]
        load_all += t["engine.load_all"]["seconds"]
    return 100.0 * (brick - load_all) / brick
