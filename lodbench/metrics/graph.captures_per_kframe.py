"""graph.captures_per_kframe: CUDA graphs captured (FrameGraphs.captures)
per 1000 frames of the window."""


def read(rec):
    w = rec["window"]
    return 1e3 * w["captures"] / len(w["frame_s"])
