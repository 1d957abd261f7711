"""frame.fused_ms.stream: the mean host ms of a simultaneous frame that
built (the program's `frame.fused` span: its build steps, the voxel tail
prepared, the frame drawn and any redraw), over the window's loads.
Nothing (None) where the program has no such span."""


def read(rec):
    count = seconds = 0
    for x in rec["window"]["loads"]:
        t = (x.get("spans") or {}).get("frame.fused")
        if t:
            count += t["count"]
            seconds += t["seconds"]
    return 1e3 * seconds / count if count else None
