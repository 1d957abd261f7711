"""build.host_syncs_per_load: the engine's device reads (Engine.host_syncs)
over one Engine.open and load_all, the mean over the window's loads."""


def read(rec):
    loads = rec["window"]["loads"]
    return sum(x["host_syncs"] for x in loads) / len(loads)
