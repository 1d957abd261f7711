"""outofcore.evict_link_pct.tiles: the eviction's share of its roofline,
the host link: the bytes the window's bricks hold on the host (each pass's
`evicted_bytes`, counted by tiles_reference.evicted_bytes) over the
program's `ooc.evict` seconds, as a share of 64 GB/s, in %. The span holds
the host's copies besides the transfers, so this can only under-read.
Nothing (None) where the program has no such span."""

# NVIDIA H100 SXM: PCIe Gen5 x16 to the host, one direction
HOST_LINK_BYTES_PER_S = 64e9


def read(rec):
    loads = rec["window"]["loads"]
    evict = [(x.get("spans") or {}).get("ooc.evict") for x in loads]
    if not all(evict):
        return None
    seconds = sum(t["seconds"] for t in evict)
    nbytes = sum(x["evicted_bytes"] for x in loads)
    return 100.0 * nbytes / seconds / HOST_LINK_BYTES_PER_S
