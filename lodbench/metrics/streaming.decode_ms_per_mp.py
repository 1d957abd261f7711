"""streaming.decode_ms_per_mp: the loader threads' seconds of file read and
column decode (PointStream.t_decode, summed over threads), per million
points loaded, over the window's loads."""


def read(rec):
    loads = rec["window"]["loads"]
    mp = sum(x["points"] for x in loads) / 1e6
    return 1e3 * sum(x["t_decode"] for x in loads) / mp
