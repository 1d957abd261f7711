"""frame_ms: the window's wall time over the Engine.render calls it
completed."""


def read(rec):
    w = rec["window"]
    return 1e3 * w["window_s"] / len(w["frame_s"])
