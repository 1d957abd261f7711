"""loop.batches_per_frame: build steps (Engine.steps) per frame
(Engine.frames) over the window's streamed frames."""


def read(rec):
    w = rec["window"]
    return w["steps"] / w["frames"]
