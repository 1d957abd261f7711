"""simlod_tpu_torch — the SimLOD point-cloud engine in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

A port of `simlod_tpu` (JAX/XLA/Pallas) that keeps its module layout and names:
stream .simlod, LAS and LAZ files (host C codecs in native/, built at first
use), build the LOD octree on the device (Morton-routed leaves split at 50k
points, first-come voxels on a 128^3 grid in inner nodes) and render it
(frustum + pixel-size LOD selection, depth-min splats with the u64 atomicMin
tiebreak, high-quality shading, eye-dome lighting, box overlays), with a
colour filter for inner voxels and an out-of-core brick engine for datasets
larger than the device point pool.

Every function takes or derives an explicit `torch.device`; `Engine` and
`OutOfCoreEngine` run on the card unless the caller asks for the CPU. The
package never imports jax; the JAX package stays the reference that the tests
hold it against. Frames are drawn by the u64 atomicMin splat kernel
(csrc/raster_splat.cu, bound by render/raster.py). The one TPU kernel of the
reference (the Pallas tile rasterizer) is a CUDA kernel here too
(csrc/raster_tiles.cu, bound by render/raster_tiles.py), taken with
`EngineConfig(use_tile_raster=True)`; everything else is plain torch ops.
"""

__version__ = "0.1.0"

from .config import EngineConfig, Settings, Stats, Uniforms  # noqa: F401
from .octree.structures import OctreeState, init_state  # noqa: F401
