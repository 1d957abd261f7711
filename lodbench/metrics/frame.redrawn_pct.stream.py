"""frame.redrawn_pct.stream: the share of the window's frames the program
drew a second time because the first draw truncated (its `frame.redraw`
spans over the frames of its loads), in %. Nothing (None) where the
program has no frame spans (`engine.frame`)."""


def read(rec):
    loads = rec["window"]["loads"]
    if not all("engine.frame" in (x.get("spans") or {}) for x in loads):
        return None
    frames = sum(x["frames"] for x in loads)
    redraws = sum(x["spans"].get("frame.redraw", {}).get("count", 0)
                  for x in loads)
    return 100.0 * redraws / frames if frames else None
