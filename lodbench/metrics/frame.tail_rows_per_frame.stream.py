"""frame.tail_rows_per_frame.stream: the mean voxel rows of the store's
tail (appended since the last compaction) that a fused frame drew, over
the window's loads (the program's `tail_rows` counter over its fused
frames). Nothing (None) where the program counts no tail rows."""


def read(rec):
    loads = rec["window"]["loads"]
    if any(x.get("tail_rows") is None for x in loads):
        return None
    fused = sum(x["fused_frames"] for x in loads)
    return sum(x["tail_rows"] for x in loads) / fused if fused else None
