// Splat kernel: the drawing stage of one frame (simlod_tpu_torch/render/
// raster.py, `splat_resolve`), for NVIDIA Hopper (sm_90a).
//
// What it replaces. On a TPU the JAX package draws through a sort and a Pallas
// kernel: simlod_tpu/render/raster_tiles.py (the pl.pallas_call at :237), ported
// as csrc/raster_tiles.cu. That design exists because the TPU has no atomics:
// the stream is sorted by (pixel, depth, colour) so that each pixel's samples
// form one run. On the card the sort, the prepass and the tile resolve cost
// ~6-7 ms per 1080p frame, almost all of it the sort. This file computes the
// same thing the way the reference does (render.cu:95-99 and 487-493) and the
// JAX package's raster.rasterize does on every backend but the TPU, from the
// unsorted columns:
//
//   clear       fb[p] = ~0 (u64), and with HQS acc[p] = {0, 0}
//   splat_min   fb[pix] = min(fb[pix], dbits << 32 | colour)  (u64 atomicMin)
//   accumulate  HQS only: rows with depth < closest * 1.01 add their colour
//               bytes and a count (two u64 atomicAdds: r | g << 32, b | n << 32)
//   finish      per pixel: HQS colour = sum / max(n, 1) in integer division
//               with alpha 0xFF, covered when n > 0; plain colour = the low
//               word of fb, covered when depth < +inf; depth = the high word
//               (+inf bits where nothing drew); uncovered pixels get the
//               background colour.
//
// Depth bits are non-negative (the projection requires depth > 0), so u64 order
// is (float depth, then unsigned colour) order: the min is the reference's
// winner, the sort's first row. A min over u64 and integer sums do not depend
// on the order of the atomics, so the output is deterministic and bit-equal to
// the plain PyTorch version splat_resolve_reference and to the tile route.
// A 32-bit half of an accumulator carries after 16.8M contributions of 255 to
// one pixel, where the JAX package's uint32 sums would wrap too.
//
// What bounds it: memory. Each row is read as three 4-byte loads (12 B,
// neighbouring threads on neighbouring rows; twice with HQS), each pixel
// written once (8 B). fb (8 B a pixel, 16.6 MB at 1080p) stays in the 50 MB L2,
// where the 64-bit atomics run. What the design does about it: nothing leaves
// the chip that does not have to, and rows that hit one pixel are merged
// before their atomic. Samples arrive in node order, so a warp's lanes often
// share a pixel (~26 samples per covered pixel at a 36M-point 1080p view):
// __match_any_sync groups the lanes by pixel, the group reduces with shuffles,
// and only its leader performs the atomic. On an H100 80GB HBM3 this was
// 1.4-2.0x faster than one atomic per row on a 36M-point 1080p frame's 5.5M
// rows and 1.1-1.2x on an 8.4M-row out-of-core brick (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using u64 = unsigned long long;

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 4096;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr unsigned NONE = 0xFFFFFFFFu;  // group key of a lane that draws nothing
constexpr uint32_t BACKGROUND_COLOR = 0x00332211u;
constexpr uint32_t DEPTH_INF_BITS = 0x7F800000u;

struct Min {
  __device__ u64 operator()(u64 a, u64 b) const { return a < b ? a : b; }
};
struct Sum {
  __device__ u64 operator()(u64 a, u64 b) const { return a + b; }
};

// Reduce x over the lanes of `peers` (this lane's group from __match_any_sync);
// the group's lowest lane ends with the result. All 32 lanes of the warp call
// it. A tree over the group's ranks: log2(group size) + 1 rounds of shuffles.
template <typename Op>
__device__ __forceinline__ u64 reduce_peers(unsigned peers, u64 x, Op op) {
  const unsigned lane = threadIdx.x & 31u;
  unsigned rank = __popc(peers & ((1u << lane) - 1u));  // peers below this lane
  unsigned above = peers & (0xFFFFFFFEu << lane);         // live peers above it
  while (__any_sync(FULL, above != 0)) {
    const int next = __ffs(above);                        // 1 + next live peer
    const u64 t = __shfl_sync(FULL, x, (next - 1) & 31);
    if (next) x = op(x, t);
    above &= ~__ballot_sync(FULL, rank & 1u);             // odd ranks are merged
    rank >>= 1;
  }
  return x;
}

__device__ __forceinline__ bool leads(unsigned peers) {
  return (threadIdx.x & 31u) == static_cast<unsigned>(__ffs(peers) - 1);
}

__global__ void __launch_bounds__(THREADS)
splat_clear(const int* __restrict__ mode, int npx, u64* __restrict__ fb,
            ulonglong2* __restrict__ acc) {
  const bool hqs = (*mode == 1);
  for (long long p = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; p < npx;
       p += static_cast<long long>(gridDim.x) * THREADS) {
    fb[p] = ~0ull;
    if (hqs) acc[p] = make_ulonglong2(0ull, 0ull);
  }
}

// The loops step a warp at a time, so every lane of a warp runs the same
// iterations (the shuffles need all 32); `i < S` masks the ragged end.
__global__ void __launch_bounds__(THREADS)
splat_min(const int* __restrict__ pix, const int* __restrict__ dbits,
          const int* __restrict__ color, int S, int npx, u64* __restrict__ fb) {
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
       i - (threadIdx.x & 31u) < S; i += stride) {
    int p = npx;
    u64 v = ~0ull;
    if (i < S) {
      p = pix[i];
      v = (static_cast<u64>(static_cast<uint32_t>(dbits[i])) << 32)
          | static_cast<uint32_t>(color[i]);
    }
    const bool ok = p < npx;
    const unsigned peers = __match_any_sync(FULL, ok ? static_cast<unsigned>(p) : NONE);
    v = reduce_peers(peers, v, Min());
    if (ok && leads(peers)) atomicMin(fb + p, v);
  }
}

__global__ void __launch_bounds__(THREADS)
splat_accumulate(const int* __restrict__ pix, const int* __restrict__ dbits,
                 const int* __restrict__ color, int S, const int* __restrict__ mode,
                 int npx, const u64* __restrict__ fb,
                 ulonglong2* __restrict__ acc) {
  if (*mode != 1) return;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
       i - (threadIdx.x & 31u) < S; i += stride) {
    int p = npx;
    bool ok = false;
    uint32_t c = 0;
    if (i < S) {
      p = pix[i];
      if (p < npx) {
        const float wd = __uint_as_float(static_cast<uint32_t>(__ldg(fb + p) >> 32));
        ok = __int_as_float(dbits[i]) < __fmul_rn(wd, 1.01f);
        c = static_cast<uint32_t>(color[i]);
      }
    }
    // r | g << 16 | b << 32 | 1 << 48: a group of at most 32 rows sums each
    // field to at most 32 * 255, so no field carries into the next
    u64 v = ok ? ((c & 0xFFu) | (((c >> 8) & 0xFFu) << 16)
                       | (static_cast<u64>((c >> 16) & 0xFFu) << 32) | (1ull << 48))
                    : 0ull;
    const unsigned peers = __match_any_sync(FULL, ok ? static_cast<unsigned>(p) : NONE);
    v = reduce_peers(peers, v, Sum());
    if (ok && leads(peers)) {
      atomicAdd(&acc[p].x, (v & 0xFFFFull) | (((v >> 16) & 0xFFFFull) << 32));
      atomicAdd(&acc[p].y, ((v >> 32) & 0xFFFFull) | ((v >> 48) << 32));
    }
  }
}

__global__ void __launch_bounds__(THREADS)
splat_finish(const int* __restrict__ mode, int npx, const u64* __restrict__ fb,
             const ulonglong2* __restrict__ acc, uint32_t* __restrict__ color_out,
             uint32_t* __restrict__ depth_out) {
  const bool hqs = (*mode == 1);
  for (long long p = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; p < npx;
       p += static_cast<long long>(gridDim.x) * THREADS) {
    const u64 w = fb[p];
    const uint32_t hi = static_cast<uint32_t>(w >> 32);
    const uint32_t depth = hi < DEPTH_INF_BITS ? hi : DEPTH_INF_BITS;
    uint32_t color;
    if (hqs) {
      const ulonglong2 a = acc[p];
      const uint32_t n = static_cast<uint32_t>(a.y >> 32);
      const uint32_t d = n > 1u ? n : 1u;
      color = n > 0u ? ((static_cast<uint32_t>(a.x) / d)
                        | ((static_cast<uint32_t>(a.x >> 32) / d) << 8)
                        | ((static_cast<uint32_t>(a.y) / d) << 16) | 0xFF000000u)
                     : BACKGROUND_COLOR;
    } else {
      color = hi < DEPTH_INF_BITS ? static_cast<uint32_t>(w) : BACKGROUND_COLOR;
    }
    color_out[p] = color;
    depth_out[p] = depth;
  }
}

inline int blocks_for(long long n) {
  const long long b = (n + THREADS - 1) / THREADS;
  return static_cast<int>(b < 1 ? 1 : (b > MAX_BLOCKS ? MAX_BLOCKS : b));
}

}  // namespace

// C entry point (bound with ctypes). Four launches on `stream` (clear, min,
// accumulate, finish); allocates nothing (fb [npx] u64 and acc [2 npx] u64 are
// scratch from the caller), does not synchronise, and reads the shading mode
// (1 = HQS) on the device. Returns the first nonzero cudaGetLastError().
extern "C" int simlod_splat_resolve(const void* pix, const void* dbits, const void* color,
                                    int S, const void* mode, int npx,
                                    void* fb, void* acc, void* color_out, void* depth_out,
                                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* m = static_cast<const int*>(mode);
  const int* px = static_cast<const int*>(pix);
  const int* db = static_cast<const int*>(dbits);
  const int* co = static_cast<const int*>(color);
  u64* f = static_cast<u64*>(fb);
  int rc;
  splat_clear<<<blocks_for(npx), THREADS, 0, st>>>(m, npx, f, static_cast<ulonglong2*>(acc));
  if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
  if (S > 0) {
    splat_min<<<blocks_for(S), THREADS, 0, st>>>(px, db, co, S, npx, f);
    if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
    splat_accumulate<<<blocks_for(S), THREADS, 0, st>>>(px, db, co, S, m, npx, f,
                                                        static_cast<ulonglong2*>(acc));
    if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
  }
  splat_finish<<<blocks_for(npx), THREADS, 0, st>>>(
      m, npx, f, static_cast<const ulonglong2*>(acc), static_cast<uint32_t*>(color_out),
      static_cast<uint32_t*>(depth_out));
  return static_cast<int>(cudaGetLastError());
}
