"""splat.roofline_pct: the least time the traced frames' raster work needs
(arith.splat_bytes of the samples they drew and their pixels, at the card's
bandwidth) over the device time of the raster stage's kernels in the trace.
Nothing when the trace lacks a launch of them (four a frame with
high-quality shading, three without)."""
from lodbench import arith

# the raster stage of the default route (csrc/raster_splat.cu)
KERNELS = {"raster": ("splat_clear", "splat_walk", "splat_finish")}


def read(rec):
    s, k = rec.get("stretch"), rec["trace"]["kernels"]["raster"]
    per_frame = 4 if rec["settings"]["use_high_quality_shading"] else 3
    if not s or k["launches"] != per_frame * s["frames"] or k["seconds"] <= 0:
        return None
    return arith.roofline_pct(arith.splat_bytes(s["drawn"], s["pixels"]),
                              k["seconds"])
