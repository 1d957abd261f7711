"""Engine-wide constants.

These mirror the reference's octree parameters (reference: structures.cuh:21-28) so the
same datasets produce the same octree:

  - MAX_POINTS_PER_NODE = 50_000 : leaf split threshold
  - GRID_SIZE           = 128    : per-node voxel sampling grid (128^3 cells)
  - MAX_DEPTH           = 20     : maximum octree depth
  - MAX_DEPTH_GRIDSIZE  = 2^28   : full-precision quantization grid
    (reference: structures.cuh:26; point cell coords at level l are bits of the 28-bit
    quantized coordinate, see progressive_octree_voxels.cu:78-114)

Everything below is a Python int; device code uses int32/uint32 arrays.
"""

MAX_POINTS_PER_NODE = 50_000
GRID_SIZE = 128
GRID_BITS = 7                      # log2(GRID_SIZE)
MAX_DEPTH = 20
# Full-precision per-axis quantization grid: 2^(MAX_DEPTH + GRID_BITS + 1) = 2^28.
# A node at level l has cells at per-axis resolution 2^(l+7); cell coords of a point are
# (q >> (MAX_DEPTH + 1 - l)) & 127 where q is the 28-bit quantized coordinate
# (reference: progressive_octree_voxels.cu:78-86).
FULL_GRID_BITS = MAX_DEPTH + GRID_BITS + 1   # 28
FULL_GRID_SIZE = 1 << FULL_GRID_BITS

# Default framebuffer clear values (reference: render.cu:31 BACKGROUND_COLOR, :1129 clear)
BACKGROUND_COLOR = 0x00332211      # abgr byte order: R=0x11 G=0x22 B=0x33, A=0
DEPTH_INF_BITS = 0x7F800000        # float32 +inf bit pattern

# LOD-by-level debug palette (reference: render.cu:38-47, colorbrewer2 spectral)
SPECTRAL = (0x4F3ED5, 0x436DF4, 0x61AEFD, 0x8BE0FE, 0x98F5E6, 0xA4DDAB, 0xA5C266, 0xBD8832)
