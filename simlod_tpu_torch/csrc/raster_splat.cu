// Splat kernels: the drawing stage of one frame (simlod_tpu_torch/render/
// raster.py), for NVIDIA Hopper (sm_90a). `splat_samples` (the second half of
// this file) is the frame path: it reads the sample sets where they lie and
// draws them in one walk. `splat_resolve` (this half) draws from materialised
// (pixel, depth bits, colour) columns: the previous design of the stage, kept
// as its yardstick; both share the clear, the warp merge and the finish.
//
// What splat_resolve replaces. On a TPU the JAX package draws through a sort and a Pallas
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

#include "launch.cuh"

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

template <typename Mode>
__global__ void __launch_bounds__(THREADS)
splat_clear(const Mode* __restrict__ mode, int npx, u64* __restrict__ fb,
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

template <typename Mode>
__global__ void __launch_bounds__(THREADS)
splat_finish(const Mode* __restrict__ mode, int npx, const u64* __restrict__ fb,
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

// ---- splat_samples: gather, decode, project and splat in one walk ----------
//
// What it replaces. On the TPU path the frame's samples are gathered into a
// window, decoded, projected, sorted and resolved by the Pallas tile kernel
// (simlod_tpu/render/raster_tiles.py:237); the port's first card design kept
// the gather -> Morton decode -> projection -> (pixel, depth bits, colour)
// columns chain in ~400 torch launches per frame and splatted the columns
// with splat_min / splat_accumulate above. Here one walk does it all, as the
// reference's kernel_render does (render.cu:1084-1345): a warp takes one
// 128-row block of a set's ragged plan (ops/ragged.py plan_blocks), whose
// rows are one aligned run of the pool columns, loads each lane's 4 rows with
// one 16-byte load per column, decodes the Morton words (points) or prefix
// keys (voxels), computes the world position, projects, applies the window
// guard and splats each of the point-size offsets with the warp-aggregated
// u64 atomicMin; with HQS a second walk recomputes the rows (arithmetic is
// free here; 16 B a row re-read beats 12 B written and read twice) and adds
// the accepted colours.
//
// What bounds it: memory. 16 B per drawn row (twice with HQS), the plan's
// 17 B per block, 8 B per pixel written; fb's u64 atomics stay in the 50 MB
// L2. What the design does about it: no sample window, column or sort is
// written to device memory at all; every row is read once per walk, in
// aligned 512-byte runs; lanes that hit one pixel merge before the atomic.
//
// Bit-equality with the plain version (torch on the card, one rounding per
// op): every float op is an explicit __f*_rn intrinsic in torch's order (nvcc
// would otherwise contract a*b+c into an FMA), int -> float is
// __int2float_rn, float -> int32 is __float2int_rz (torch's CUDA cast:
// truncation, saturating, NaN -> 0), and the scale factors (cube_size /
// 2^28, cube_size / exp2(level)) come from torch, evaluated with the plain
// version's own expressions.

constexpr int MAX_SETS = 8;
constexpr int BLOCK_ROWS = 128;  // rows of a plan block: one warp, 4 a lane
constexpr int WARPS = THREADS / 32;
constexpr int POINTS = 0;        // raster.POINTS / raster.VOXELS
constexpr int GRID_BITS = 7;     // constants.GRID_BITS (128^3 cells a node)
constexpr int MAX_DEPTH = 20;
constexpr int FULL_GRID_BITS = 28;
constexpr int COLOR_BY_NODE = 1, COLOR_BY_LOD = 2, COLOR_WHITE = 4;

// constants.SPECTRAL: the LOD palette (reference render.cu:38-47)
__constant__ uint32_t SPECTRAL[8] = {0x4F3ED5u, 0x436DF4u, 0x61AEFDu, 0x8BE0FEu,
                                     0x98F5E6u, 0xA4DDABu, 0xA5C266u, 0xBD8832u};

// One sample set (raster.SampleSource); the wrapper writes it as 18 int64
// words in this order.
struct SetDesc {
  long long kind;      // POINTS (Morton words w0 w1 w2) or voxels (k0 k1 k2l)
  long long n_blocks;  // WR: blocks of the plan
  long long pool_len;  // rows of each column
  const int* src_row;  // [WR] pool row block of each window block
  const int* pstart;   // [WR] window position of the block's segment start
  const int* pend;     // [WR] ... and end
  const bool* r_ok;    // [WR]
  const int* sr;       // [WR] segment of the block
  const int* c0;       // [pool_len] columns
  const int* c1;
  const int* c2;
  const int* rgba;
  const int* seg_node;  // [S] segment -> node, or null: node = segment
  const int* level;     // [N] node levels (points' LOD colour)
  const bool* show;     // the frame's show_points, or null: on
  const float* box_min;  // [3]
  const float* qscale;   // points: cube_size / 2^28
  const float* vsize;    // voxels: [32] cube_size / exp2(level)
};
static_assert(sizeof(SetDesc) == 18 * 8, "SetDesc is 18 words of 8 bytes");

struct Frame {
  SetDesc set[MAX_SETS];
  long long block_end[MAX_SETS];  // inclusive prefix sums of n_blocks
  const float* transform;         // [4, 4] row-major
  const float* width_f;
  const float* height_f;
  const int* point_size;
  const bool* hqs;                // use_high_quality_shading
  int nsets, width, height, max_point_size, color_mode;
};

__device__ __forceinline__ int compact3(int v) {  // morton._compact3
  v &= 0x09249249;
  v = (v | (v >> 2)) & 0x030C30C3;
  v = (v | (v >> 4)) & 0x0300F00F;
  v = (v | (v >> 8)) & 0x030000FF;
  v = (v | (v >> 16)) & 0x000003FF;
  return v;
}

// morton.decode: words of 10, 10 and 8 levels below bit 28
__device__ __forceinline__ void decode(int w0, int w1, int w2, int& qx, int& qy, int& qz) {
  qx = (compact3(w0 >> 2) << 18) | (compact3(w1 >> 2) << 8) | compact3(w2 >> 2);
  qy = (compact3(w0 >> 1) << 18) | (compact3(w1 >> 1) << 8) | compact3(w2 >> 1);
  qz = (compact3(w0) << 18) | (compact3(w1) << 8) | compact3(w2);
}

// raster.voxel_positions_from_keys, one axis:
// ((p >> 7) * size + box_min) + size * (((p & 127) + 0.5) / 128)
__device__ __forceinline__ float voxel_axis(int q, int shift, float size, float bmin) {
  const int p = q >> shift;
  const float a = __fadd_rn(__fmul_rn(__int2float_rn(p >> GRID_BITS), size), bmin);
  const float c = __fdiv_rn(__fadd_rn(__int2float_rn(p & ((1 << GRID_BITS) - 1)), 0.5f),
                            static_cast<float>(1 << GRID_BITS));
  return __fadd_rn(a, __fmul_rn(size, c));
}

// raster._project row 0, 1 or 3 of the transform: ((x m0 + y m1) + z m2) + m3
__device__ __forceinline__ float dot4(const float* m, float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, m[0]), __fmul_rn(y, m[1])),
                             __fmul_rn(z, m[2])), m[3]);
}

// One row: its splat anchor (x, y), depth bits, colour, and whether it draws.
struct Row {
  int x, y;
  uint32_t dbits, color;
  bool ok;
};

__device__ __forceinline__ Row make_row(const Frame& f, const SetDesc& d, bool valid,
                                        int a0, int a1, int a2, int rgba, int seg,
                                        float W, float H) {
  Row r;
  float x, y, z;
  int qx, qy, qz;
  const bool points = d.kind == POINTS;
  // voxels: level in k2l's low 5 bits, decoded from k2l & ~31
  const int lvl = a2 & 31;
  decode(a0, a1, points ? a2 : (a2 & ~31), qx, qy, qz);
  if (points) {  // morton.dequantize_cols: box_min + (q + 0.5) * s
    const float s = *d.qscale;
    x = __fadd_rn(d.box_min[0], __fmul_rn(__fadd_rn(__int2float_rn(qx), 0.5f), s));
    y = __fadd_rn(d.box_min[1], __fmul_rn(__fadd_rn(__int2float_rn(qy), 0.5f), s));
    z = __fadd_rn(d.box_min[2], __fmul_rn(__fadd_rn(__int2float_rn(qz), 0.5f), s));
  } else {
    const int sh = min(max(MAX_DEPTH + 1 - lvl, 0), FULL_GRID_BITS);
    const float size = d.vsize[lvl];
    x = voxel_axis(qx, sh, size, d.box_min[0]);
    y = voxel_axis(qy, sh, size, d.box_min[1]);
    z = voxel_axis(qz, sh, size, d.box_min[2]);
  }
  // raster._project: ((n / w) * 0.5 + 0.5) * width, truncated to int32
  const float* m = f.transform;
  const float n0 = dot4(m, x, y, z), n1 = dot4(m + 4, x, y, z), w = dot4(m + 12, x, y, z);
  r.x = __float2int_rz(__fmul_rn(__fadd_rn(__fmul_rn(__fdiv_rn(n0, w), 0.5f), 0.5f), W));
  r.y = __float2int_rz(__fmul_rn(__fadd_rn(__fmul_rn(__fdiv_rn(n1, w), 0.5f), 0.5f), H));
  r.ok = valid && r.x > 1 && __int2float_rn(r.x) < __fsub_rn(W, 2.0f) && r.y > 1
         && __int2float_rn(r.y) < __fsub_rn(H, 2.0f) && w > 0.0f;
  r.dbits = __float_as_uint(w);
  // raster._sample_colors: by node, by LOD, white (later modes win)
  uint32_t c = static_cast<uint32_t>(rgba);
  if (f.color_mode) {
    const int node = d.seg_node ? d.seg_node[seg] : seg;
    if (f.color_mode & COLOR_BY_NODE) c = static_cast<uint32_t>(node % 127) * 123456789u;
    if ((f.color_mode & COLOR_BY_LOD) && r.ok) {
      const int l = points ? d.level[node] : lvl;
      const int i = __float2int_rz(__fmul_rn(__fsub_rn(8.0f, __int2float_rn(l)), 1.8f));
      c = SPECTRAL[min(max(i, 0), 7)];
    }
    if (f.color_mode & COLOR_WHITE) c = 0x00FFFFFFu;
  }
  r.color = c;
  return r;
}

// One walk over every block of every set: ACC = false is the min pass, true
// the HQS accumulate (a no-op launch in plain mode). A warp owns a block at a
// time, so every lane runs the same iterations (the shuffles need all 32).
template <bool ACC>
__global__ void __launch_bounds__(THREADS)
splat_walk(const __grid_constant__ Frame f, u64* __restrict__ fb,
           ulonglong2* __restrict__ acc) {
  if (ACC && !*f.hqs) return;
  const unsigned lane = threadIdx.x & 31u;
  const long long n_blocks = f.block_end[f.nsets - 1];
  const float W = *f.width_f, H = *f.height_f;
  const int ps = *f.point_size;
  const int mps = f.max_point_size;
  for (long long b = static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32;
       b < n_blocks; b += static_cast<long long>(gridDim.x) * WARPS) {
    int k = 0;
    while (b >= f.block_end[k]) ++k;
    const SetDesc& d = f.set[k];
    const long long r = b - (k ? f.block_end[k - 1] : 0);
    if (!d.r_ok[r] || (d.show && !*d.show)) continue;  // the warp's block
    // window positions r*128 + l in [pstart, pend) are the segment's rows
    const long long base = r * BLOCK_ROWS;
    const long long lo = d.pstart[r] - base, hi = d.pend[r] - base;
    const long long row0 = static_cast<long long>(d.src_row[r]) * BLOCK_ROWS;
    const int seg = d.sr[r];
    const int first = static_cast<int>(lane) * 4;
    int a0[4], a1[4], a2[4], a3[4];
    bool valid[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) valid[i] = first + i >= lo && first + i < hi;
    const bool aligned =
        ((reinterpret_cast<uintptr_t>(d.c0) | reinterpret_cast<uintptr_t>(d.c1)
          | reinterpret_cast<uintptr_t>(d.c2) | reinterpret_cast<uintptr_t>(d.rgba)) & 15u) == 0;
    if (aligned && row0 + BLOCK_ROWS <= d.pool_len) {
      const int4 v0 = __ldg(reinterpret_cast<const int4*>(d.c0 + row0) + lane);
      const int4 v1 = __ldg(reinterpret_cast<const int4*>(d.c1 + row0) + lane);
      const int4 v2 = __ldg(reinterpret_cast<const int4*>(d.c2 + row0) + lane);
      const int4 v3 = __ldg(reinterpret_cast<const int4*>(d.rgba + row0) + lane);
      a0[0] = v0.x; a0[1] = v0.y; a0[2] = v0.z; a0[3] = v0.w;
      a1[0] = v1.x; a1[1] = v1.y; a1[2] = v1.z; a1[3] = v1.w;
      a2[0] = v2.x; a2[1] = v2.y; a2[2] = v2.z; a2[3] = v2.w;
      a3[0] = v3.x; a3[1] = v3.y; a3[2] = v3.z; a3[3] = v3.w;
    } else {  // the pool's last partial block (valid rows lie in the pool)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long row = row0 + first + i;
        a0[i] = valid[i] ? __ldg(d.c0 + row) : 0;
        a1[i] = valid[i] ? __ldg(d.c1 + row) : 0;
        a2[i] = valid[i] ? __ldg(d.c2 + row) : 0;
        a3[i] = valid[i] ? __ldg(d.rgba + row) : 0;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const Row row = make_row(f, d, valid[i], a0[i], a1[i], a2[i], a3[i], seg, W, H);
      for (int ox = 0; ox < mps; ++ox) {
        for (int oy = 0; oy < mps; ++oy) {
          const bool use = row.ok && ox < ps && oy < ps;
          if (!__any_sync(FULL, use)) continue;
          int p = 0;
          if (use) {
            const int px = min(max(row.x + ox, 0), f.width - 1);
            const int py = min(max(row.y + oy, 0), f.height - 1);
            p = px + f.width * py;
          }
          if (!ACC) {
            u64 v = use ? (static_cast<u64>(row.dbits) << 32) | row.color : ~0ull;
            const unsigned peers = __match_any_sync(FULL, use ? static_cast<unsigned>(p) : NONE);
            v = reduce_peers(peers, v, Min());
            if (use && leads(peers)) atomicMin(fb + p, v);
          } else {
            bool take = false;
            if (use) {
              const float wd = __uint_as_float(static_cast<uint32_t>(__ldg(fb + p) >> 32));
              take = __uint_as_float(row.dbits) < __fmul_rn(wd, 1.01f);
            }
            const uint32_t c = row.color;
            // r | g << 16 | b << 32 | 1 << 48, as in splat_accumulate
            u64 v = take ? ((c & 0xFFu) | (((c >> 8) & 0xFFu) << 16)
                            | (static_cast<u64>((c >> 16) & 0xFFu) << 32) | (1ull << 48))
                         : 0ull;
            const unsigned peers = __match_any_sync(FULL, take ? static_cast<unsigned>(p) : NONE);
            v = reduce_peers(peers, v, Sum());
            if (take && leads(peers)) {
              atomicAdd(&acc[p].x, (v & 0xFFFFull) | (((v >> 16) & 0xFFFFull) << 32));
              atomicAdd(&acc[p].y, ((v >> 32) & 0xFFFFull) | ((v >> 48) << 32));
            }
          }
        }
      }
    }
  }
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

// C entry point of splat_samples (bound with ctypes). `sets` is a host array
// of nsets SetDesc (18 int64 words each), copied into the launches'
// parameters; every other pointer is device memory. Four launches on
// `stream`, with `device` current (clear, min walk, HQS walk, finish); allocates nothing (fb [npx]
// u64 and acc [2 npx] u64 are scratch from the caller), does not synchronise,
// and reads every uniform (transform, width and height as floats, point size,
// shading mode, show_points) on the device. Returns the first nonzero
// cudaGetLastError().
extern "C" int simlod_splat_samples(const void* sets, int nsets, const void* transform,
                                    const void* width_f, const void* height_f,
                                    const void* point_size, const void* hqs, int width,
                                    int height, int max_point_size, int color_mode,
                                    void* fb, void* acc, void* color_out, void* depth_out,
                                    int device, void* stream) {
  if (nsets < 1 || nsets > MAX_SETS || width < 1 || height < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const simlod::DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  Frame f{};
  const SetDesc* in = static_cast<const SetDesc*>(sets);
  long long total = 0;
  for (int k = 0; k < MAX_SETS; ++k) {
    if (k < nsets) {
      f.set[k] = in[k];
      total += in[k].n_blocks;
    }
    f.block_end[k] = total;
  }
  f.transform = static_cast<const float*>(transform);
  f.width_f = static_cast<const float*>(width_f);
  f.height_f = static_cast<const float*>(height_f);
  f.point_size = static_cast<const int*>(point_size);
  f.hqs = static_cast<const bool*>(hqs);
  f.nsets = nsets;
  f.width = width;
  f.height = height;
  f.max_point_size = max_point_size;
  f.color_mode = color_mode;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int npx = width * height;
  u64* fbp = static_cast<u64*>(fb);
  ulonglong2* accp = static_cast<ulonglong2*>(acc);
  int rc;
  splat_clear<<<blocks_for(npx), THREADS, 0, st>>>(f.hqs, npx, fbp, accp);
  if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
  if (total > 0) {
    splat_walk<false><<<blocks_for(total * 32), THREADS, 0, st>>>(f, fbp, accp);
    if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
    splat_walk<true><<<blocks_for(total * 32), THREADS, 0, st>>>(f, fbp, accp);
    if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
  }
  splat_finish<<<blocks_for(npx), THREADS, 0, st>>>(
      f.hqs, npx, fbp, accp, static_cast<uint32_t*>(color_out),
      static_cast<uint32_t*>(depth_out));
  return static_cast<int>(cudaGetLastError());
}
