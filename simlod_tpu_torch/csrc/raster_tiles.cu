// Tile-resolve kernel of the tile-binned rasterizer (simlod_tpu_torch/render/
// raster_tiles.py), for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel simlod_tpu/render/raster_tiles.py
// (_make_kernel._kernel, launched by _raster_kernel_call through the
// pl.pallas_call at raster_tiles.py:237). It computes what that kernel computes,
// not how: the one-hot bf16 MXU matmul, the 4-deep DMA ring and the chunk-major
// [S/512, 4, 512] layout were TPU devices and are gone.
//
// Input: the sample stream sorted by (pixel, depth bits, colour), one int4 row per
// sample: (pixel | winner bit 28 | contribute bit 29, depth bits, colour, pad),
// and per-tile row offsets offs[n_tiles + 1]. One thread block per 512-pixel
// tile walks its own row range [offs[t], offs[t+1]) and accumulates, per pixel,
// eight integer sums in shared memory (16 KB):
//   v0..v2  colour bytes 0..2 weighted by cw (HQS: contribute bit; plain: winner)
//   v3      HQS: contribute count; plain: winner's alpha byte
//   v4..v6  winner's depth bytes 0..2
//   v7      winner's depth byte 3, +1 in plain mode (plain's coverage flag)
// then resolves each pixel: HQS colour byte = floor(sum / max(count, 1)) in f32
// with alpha 0xFF; plain colour = the winner's bytes; depth = the winner's bits;
// uncovered pixels get BACKGROUND_COLOR and +inf depth bits.
//
// Exactness: the Pallas kernel sums in f32, which is exact while a sum stays
// below 2^24, i.e. while a pixel has fewer than 2^24 / 255 = 65793 contributing
// rows. Below that bound the integer sums here equal its f32 sums, and the f32
// division is the IEEE-rounded one (this file is built without
// --use_fast_math), so the output is bit-equal to the Pallas kernel and to the
// plain PyTorch version tile_resolve_reference.
//
// Cost: bound by memory. Each sample is read once as one 16-byte load (8M
// samples = 128 MB at a 1080p frame) and each pixel is written once (8 bytes);
// no intermediate leaves the SM. The shared-memory atomics serialize only among
// rows of the same pixel, which are adjacent in the sorted stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 512;
constexpr int THREADS = 256;
constexpr int WIN_BIT = 28;
constexpr int AM_BIT = 29;
constexpr int PIX_MASK = (1 << WIN_BIT) - 1;
constexpr uint32_t BACKGROUND_COLOR = 0x00332211u;
constexpr int DEPTH_INF_BITS = 0x7F800000;

__global__ void __launch_bounds__(THREADS)
tile_resolve_kernel(const int4* __restrict__ cols, const int* __restrict__ offs,
                    const int* __restrict__ mode_ptr,
                    uint32_t* __restrict__ color_out, int* __restrict__ depth_out) {
  __shared__ int acc[8][TILE];
  const int t = blockIdx.x;
  for (int i = threadIdx.x; i < 8 * TILE; i += THREADS) (&acc[0][0])[i] = 0;
  __syncthreads();

  const bool hqs = (*mode_ptr == 1);
  const int lo = offs[t];
  const int hi = offs[t + 1];
  const int tile0 = t * TILE;
  for (int r = lo + threadIdx.x; r < hi; r += THREADS) {
    const int4 row = cols[r];
    const int lpix = (row.x & PIX_MASK) - tile0;
    if (lpix < 0 || lpix >= TILE) continue;
    const int win = (row.x >> WIN_BIT) & 1;
    const int am = (row.x >> AM_BIT) & 1;
    const uint32_t db = static_cast<uint32_t>(row.y);
    const uint32_t col = static_cast<uint32_t>(row.z);
    const int cw = hqs ? am : win;
    if (cw) {
      atomicAdd(&acc[0][lpix], static_cast<int>(col & 0xFFu));
      atomicAdd(&acc[1][lpix], static_cast<int>((col >> 8) & 0xFFu));
      atomicAdd(&acc[2][lpix], static_cast<int>((col >> 16) & 0xFFu));
    }
    const int v3 = hqs ? am : win * static_cast<int>(col >> 24);
    if (v3) atomicAdd(&acc[3][lpix], v3);
    if (win) {
      atomicAdd(&acc[4][lpix], static_cast<int>(db & 0xFFu));
      atomicAdd(&acc[5][lpix], static_cast<int>((db >> 8) & 0xFFu));
      atomicAdd(&acc[6][lpix], static_cast<int>((db >> 16) & 0xFFu));
      atomicAdd(&acc[7][lpix], static_cast<int>(db >> 24) + (hqs ? 0 : 1));
    }
  }
  __syncthreads();

  for (int p = threadIdx.x; p < TILE; p += THREADS) {
    const int cnt = acc[3][p];
    const bool covered = hqs ? (cnt > 0) : (acc[7][p] > 0);
    uint32_t color;
    if (hqs) {
      const float cntf = static_cast<float>(cnt > 1 ? cnt : 1);
      color = 0xFF000000u;
      for (int k = 0; k < 3; ++k) {
        const float q = floorf(__fdiv_rn(static_cast<float>(acc[k][p]), cntf));
        color |= (static_cast<uint32_t>(static_cast<int>(q)) & 0xFFu) << (8 * k);
      }
    } else {
      color = 0u;
      for (int k = 0; k < 4; ++k)
        color |= (static_cast<uint32_t>(acc[k][p]) & 0xFFu) << (8 * k);
    }
    const uint32_t db3 = static_cast<uint32_t>(hqs ? acc[7][p] : acc[7][p] - 1) & 0xFFu;
    const uint32_t dbits = (static_cast<uint32_t>(acc[4][p]) & 0xFFu)
                         | ((static_cast<uint32_t>(acc[5][p]) & 0xFFu) << 8)
                         | ((static_cast<uint32_t>(acc[6][p]) & 0xFFu) << 16)
                         | (db3 << 24);
    color_out[tile0 + p] = covered ? color : BACKGROUND_COLOR;
    depth_out[tile0 + p] = covered ? static_cast<int>(dbits) : DEPTH_INF_BITS;
  }
}

}  // namespace

// C entry point (bound with ctypes). Launches on `stream`, allocates nothing,
// does not synchronise; returns cudaGetLastError() after the launch.
extern "C" int simlod_tile_resolve(const void* cols, const void* offs,
                                   const void* mode, int n_tiles, void* color,
                                   void* depth, void* stream) {
  if (n_tiles > 0) {
    tile_resolve_kernel<<<n_tiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int4*>(cols), static_cast<const int*>(offs),
        static_cast<const int*>(mode), static_cast<uint32_t*>(color),
        static_cast<int*>(depth));
  }
  return static_cast<int>(cudaGetLastError());
}
