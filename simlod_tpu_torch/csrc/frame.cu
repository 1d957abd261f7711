// Frame kernels: the per-frame stages around the splat for NVIDIA Hopper
// (sm_90a). On the TPU the JAX package runs a frame as one jitted program
// (simlod_tpu/render/render.py:139-140), and XLA fuses these stages into a
// few device loops; in eager PyTorch each of their ops was a launch of its
// own (~600 per 1080p frame, while the splat itself is four). Here each stage
// is one launch:
//
//   visibility  (render/visibility.py; JAX visibility.compute_visibility,
//               simlod_tpu/render/visibility.py:42; the reference's
//               compute_visibility_disjunct, render.cu:690-934): one thread per
//               node slot computes the node's box, the 8-corner screen extents,
//               the p-vertex frustum test, has_samples, visible, is_large,
//               the parent's is_large (recomputed in the same thread) and
//               emitted. With a draw pool it also writes the node's budget,
//               the two pool takes and the two exact masks
//               (render/drawpool.py node_budgets, split_masks, _pool_take).
//               The five visible counts: each block writes its sums as one
//               partial row, a grid barrier, block 0 adds the rows (integer
//               sums: order-free). No memset, no atomics, and nothing carries
//               over between calls.
//   plan_many   (ops/ragged.py plan_blocks_many; JAX ragged.plan,
//               simlod_tpu/ops/ragged.py:46): the block plans of all of a
//               frame's ragged gathers (up to MAX_PLANS sets, each from its
//               unmasked (off, cnt) columns and the frame's selection) in one
//               launch, in three phases split by grid barriers: block scans of
//               the segments' row and sample counts over 1024-segment tiles of
//               every set, one block per set scanning its tile sums, and a fill
//               in which each warp writes its 32 segments' rows.
//   edl         (render/raster.edl; JAX raster.edl,
//               simlod_tpu/render/raster.py:259): a 2-D grid of 128 x 8
//               pixel tiles; each block puts log2 of its tile's depths and a
//               wrapping one-pixel halo (as torch.roll) in shared memory, then
//               each thread shades its 4 pixels' colours.
//
// What bounds them: the launch. Their bytes are few (a node's 32 B, a
// segment's 8-13 B, a plan row's 17 B, a pixel's 12 B): a few KB to a few MB,
// a fraction of a microsecond to a few microseconds at 3.35 TB/s, under the
// cost of one launch and of the host work around it. What the design does
// about it: one launch a stage and a frame; visibility and the plans are
// cooperative launches (cudaLaunchCooperativeKernel, grid barriers through
// cooperative_groups) whose grid is never larger than what is co-resident on
// the card (occupancy x SMs, computed once per device and cached), so that the
// scans and count sums that needed a second launch or a memset are a barrier
// inside one; every launch reads its inputs once and writes its outputs once;
// nothing in between goes to device memory except the plan's per-segment scan
// (4 B a segment), its tile sums and visibility's partial rows; no launch needs
// a host read and none takes a per-frame value by value: visibility reads
// the frame's camera and scalars from the device (Uniforms.vis), EDL its
// strength, so that a frame recorded as a CUDA graph (graphs.FrameGraphs)
// reads each replay's values. A cudaLaunchCooperativeKernel launch
// captures into a CUDA graph as it is and replays with its grid barriers
// (H100, nvcc 12.9, torch 2.11 cu128: chip_smoke.py phase 4c).
//
// Bit-equality with the plain versions (torch on the card, one rounding per
// op): every float op is an explicit __f*_rn intrinsic in torch's op order
// (nvcc would contract a*b+c into an FMA otherwise), int -> float is
// __int2float_rn, float -> int32 is __float2int_rz (torch's cast: truncate,
// saturate, NaN -> 0); exp2f, log2f and expf are the libdevice functions that
// torch's CUDA exp2, log2 and exp call (NVCC_FLAGS has no --use_fast_math);
// torch.minimum / maximum / clamp propagate NaN where fminf / fmaxf drop it,
// so the kernels test for NaN first, as torch does; torch's CUDA division of
// a tensor by a Python scalar multiplies by the scalar's float reciprocal.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 4096;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int A = 128;  // ragged window block (ops/ragged.py A)
constexpr int COUNTS = 5;  // visibility's visible counts

inline int blocks_for(long long n) {
  const long long b = (n + THREADS - 1) / THREADS;
  return static_cast<int>(b < 1 ? 1 : (b > MAX_BLOCKS ? MAX_BLOCKS : b));
}

using simlod::DeviceGuard;
using simlod::launch_error;

// torch.minimum / maximum on float tensors: a NaN operand is the result
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// ((x m0 + y m1) + z m2) + m3: one row of the transform, in torch's order
__device__ __forceinline__ float dot4(const float* m, float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, m[0]), __fmul_rn(y, m[1])),
                             __fmul_rn(z, m[2])),
                   m[3]);
}

// ---- visibility -------------------------------------------------------------

struct VisArgs {
  // [n] node columns of the (trimmed) directory
  const int* nx;
  const int* ny;
  const int* nz;
  const int* level;
  const int* parent;
  const int* child_base;
  const int* num_points;
  const int* num_voxels;
  const int* num_nodes;  // device scalar
  const float* box_min;  // [3]
  const float* cube_size;
  // [n] draw-pool counts, or null without a pool
  const int* pool_pt_cnt;
  const int* pool_vx_cnt;
  // outputs: [n] each, counts [5]; with a pool also the takes and masks
  bool* emitted;
  bool* visible;
  bool* is_large;
  float* dx;
  float* dy;
  int* counts;
  int* take_p;
  int* take_v;
  bool* exact_p;
  bool* exact_v;
  int* partials;  // [gridDim.x, 5] scratch: each block's counts
  // [44] on the device: the frame's VisUniforms (Uniforms.vis, filled by the
  // frame's one uniform copy), so that a captured launch reads each replay's
  // camera
  const float* uniforms;
  int n, draw_cap;
};

// The frame's values the kernel reads (config.Uniforms.vis, in this order);
// each block copies them into shared memory once.
struct VisUniforms {
  float m[16];       // transform_update_bound, row-major
  float planes[24];  // frustum.frustum_planes_host(m)
  float width, height, min_node_size, point_budget;
};
constexpr int VIS_UNIFORMS = 44;
static_assert(sizeof(VisUniforms) == VIS_UNIFORMS * sizeof(float), "VisUniforms is 44 floats");

struct Extent {
  float dx, dy;
  float mn[3], mx[3];
};

// the node's box (visibility.py: box_min + size * n, + size) and the screen
// extent of its 8 corners (min / max over the corners, NaN-propagating)
__device__ Extent node_extent(const VisArgs& a, const VisUniforms& u, int i) {
  Extent e;
  const float size = __fdiv_rn(*a.cube_size, exp2f(__int2float_rn(a.level[i])));
  const int q[3] = {a.nx[i], a.ny[i], a.nz[i]};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    e.mn[k] = __fadd_rn(a.box_min[k], __fmul_rn(size, __int2float_rn(q[k])));
    e.mx[k] = __fadd_rn(e.mn[k], size);
  }
  float sminx = 3.4e38f, smaxx = -3.4e38f, sminy = 3.4e38f, smaxy = -3.4e38f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float px = (c >> 2) & 1 ? e.mx[0] : e.mn[0];
    const float py = (c >> 1) & 1 ? e.mx[1] : e.mn[1];
    const float pz = c & 1 ? e.mx[2] : e.mn[2];
    const float n0 = dot4(u.m, px, py, pz);
    const float n1 = dot4(u.m + 4, px, py, pz);
    const float w = dot4(u.m + 12, px, py, pz);
    const float sx = __fmul_rn(__fadd_rn(__fmul_rn(__fdiv_rn(n0, w), 0.5f), 0.5f), u.width);
    const float sy = __fmul_rn(__fadd_rn(__fmul_rn(__fdiv_rn(n1, w), 0.5f), 0.5f), u.height);
    sminx = nan_min(sminx, sx);
    smaxx = nan_max(smaxx, sx);
    sminy = nan_min(sminy, sy);
    smaxy = nan_max(smaxy, sy);
  }
  e.dx = __fsub_rn(smaxx, sminx);
  e.dy = __fsub_rn(smaxy, sminy);
  return e;
}

__device__ __forceinline__ bool large(const VisUniforms& u, float dx, float dy) {
  const float t = __fmul_rn(u.min_node_size, 2.0f);
  return dx > t || dy > t;
}

// drawpool.node_budgets: ceil(point_budget * min(area, 2e9)) clamped to
// [0, 2e9], NaN -> 0, as int32; INT32_MAX without decimation
__device__ int node_budget(const VisUniforms& u, float dx, float dy) {
  if (!(u.point_budget > 0.0f)) return 0x7FFFFFFF;
  const float area = __fmul_rn(nan_max(dx, 0.0f), nan_max(dy, 0.0f));
  const float c = area != area ? area : fminf(area, 2.0e9f);
  float b = ceilf(__fmul_rn(u.point_budget, c));
  b = b != b ? b : fminf(fmaxf(b, 0.0f), 2.0e9f);
  return b != b ? 0 : __float2int_rz(b);
}

// Launched cooperatively (grid <= co-resident blocks): every thread reaches
// the grid barrier.
__global__ void __launch_bounds__(THREADS) visibility(const __grid_constant__ VisArgs a) {
  __shared__ VisUniforms u;
  if (threadIdx.x < VIS_UNIFORMS) reinterpret_cast<float*>(&u)[threadIdx.x] = a.uniforms[threadIdx.x];
  __syncthreads();
  const int num_nodes = *a.num_nodes;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  // this thread's counts over its node slots (unsigned: wraps as torch's
  // int32 sums do)
  unsigned c_nodes = 0, c_inner = 0, c_leaves = 0, c_points = 0, c_voxels = 0;
  for (long long t = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; t < a.n;
       t += stride) {
    const int i = static_cast<int>(t);
    const bool active = i < num_nodes;
    const Extent e = node_extent(a, u, i);
    bool in_frustum = true;
#pragma unroll
    for (int p = 0; p < 6; ++p) {
      const float* pl = u.planes + 4 * p;
      const float px = pl[0] > 0.0f ? e.mx[0] : e.mn[0];
      const float py = pl[1] > 0.0f ? e.mx[1] : e.mn[1];
      const float pz = pl[2] > 0.0f ? e.mx[2] : e.mn[2];
      const float dist = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(px, pl[0]), __fmul_rn(py, pl[1])), __fmul_rn(pz, pl[2])),
          pl[3]);
      in_frustum = in_frustum && dist >= 0.0f;
    }
    const int np = a.num_points[i], nv = a.num_voxels[i], cb = a.child_base[i];
    const bool has_samples = np > 0 || nv > 0 || cb >= 0;
    const bool vis = active && in_frustum && has_samples;
    const bool il = active && large(u, e.dx, e.dy);
    // the parent's is_large, from its own box (parent clamped into the
    // directory, as visibility.py indexes it)
    const int par = a.parent[i];
    bool parent_large = false;
    if (par >= 0) {
      const int j = min(par, a.n - 1);
      const Extent pe = node_extent(a, u, j);
      parent_large = j < num_nodes && large(u, pe.dx, pe.dy);
    }
    const bool leaf = cb < 0;
    const bool em = vis && ((parent_large && !il) || (il && leaf));
    a.emitted[i] = em;
    a.visible[i] = vis;
    a.is_large[i] = il;
    a.dx[i] = e.dx;
    a.dy[i] = e.dy;
    const bool leafish = em && np > 0;
    const bool innerish = em && np == 0 && nv > 0;
    c_nodes += em;
    c_inner += innerish;
    c_leaves += leafish;
    c_points += leafish ? static_cast<unsigned>(np) : 0u;
    c_voxels += innerish ? static_cast<unsigned>(nv) : 0u;
    if (a.pool_pt_cnt) {  // draw pool: budgets, split masks, takes
      const int budget = node_budget(u, e.dx, e.dy);
      const int pc = a.pool_pt_cnt[i], vc = a.pool_vx_cnt[i];
      const bool poolable_p = np <= a.draw_cap && (pc > 0 || np == 0);
      const bool poolable_v = nv <= a.draw_cap && (vc > 0 || nv == 0);
      a.take_p[i] = em && poolable_p ? min(pc, budget) : 0;
      a.take_v[i] = em && poolable_v ? min(vc, budget) : 0;
      a.exact_p[i] = em && np > 0 && !poolable_p;
      a.exact_v[i] = em && nv > 0 && !poolable_v;
    }
  }
  // the block's counts: warp sums, then warp 0 adds the block's warps and
  // writes them as the block's partial row
  __shared__ unsigned warp_counts[THREADS / 32][COUNTS];
  const unsigned mine[COUNTS] = {c_nodes, c_inner, c_leaves, c_points, c_voxels};
#pragma unroll
  for (int c = 0; c < COUNTS; ++c) {
    const unsigned s = __reduce_add_sync(FULL, mine[c]);
    if (lane == 0) warp_counts[warp][c] = s;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int c = 0; c < COUNTS; ++c) {
      const unsigned s =
          __reduce_add_sync(FULL, lane < THREADS / 32 ? warp_counts[lane][c] : 0u);
      if (lane == 0) a.partials[blockIdx.x * COUNTS + c] = static_cast<int>(s);
    }
  }
  cg::this_grid().sync();
  // block 0 adds the partial rows: warp c sums count c
  if (blockIdx.x == 0 && warp < COUNTS) {
    unsigned s = 0;
    for (unsigned b = lane; b < gridDim.x; b += 32)
      s += static_cast<unsigned>(a.partials[b * COUNTS + warp]);
    s = __reduce_add_sync(FULL, s);
    if (lane == 0) a.counts[warp] = static_cast<int>(s);
  }
}

// ---- plan_many --------------------------------------------------------------

constexpr int SCAN = 1024;    // segments a tile (one a thread): plan_many's block
constexpr int MAX_PLANS = 8;  // sets a launch plans (ops/ragged.py MAX_PLANS)

// One set's plan: simlod_plan_blocks_many reads the pointers and sizes from
// the wrapper's 16 words a set and derives WR, nt, tile0 and warp0.
struct PlanSet {
  const int* off;    // [S] segment start in the pool
  const int* cnt;    // [S] segment length
  const bool* mask;  // selection, or null: every segment
  const int* index;  // [S] mask index per segment, or null: mask[i]
  int* src_row;      // [WR] outputs
  int* pstart;
  int* pend;
  int* sr;
  int* mpos;   // [S]
  int* count;  // [1]: min(sum of selected counts, out_len)
  bool* r_ok;  // [WR]
  int* local;  // [S] scratch: exclusive row offset within the tile
  int* tsum;   // [2 nt + 1] scratch: tile row sums (then offsets), tile
               // sample sums, and the rows of all segments
  int S, mask_len, out_len, WR;
  int nt;            // tiles: ceil(S / SCAN)
  int tile0, warp0;  // the set's first tile and fill warp in the launch
};

struct PlanMany {
  PlanSet set[MAX_PLANS];
  int nsets, ntiles, nwarps;
};

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && (a < 0) != (b < 0)) ? q - 1 : q;
}

struct Seg {
  int c, row0, phase, rcnt;
};

// the frame's selection of the segment (ragged._select), then
// ragged.plan_blocks_reference's per-segment
// quantities (zero for an empty segment)
__device__ Seg segment(const PlanSet& a, int i) {
  Seg s;
  int c = a.cnt[i];
  if (a.mask) {
    bool sel;
    if (a.index) {
      const int k = a.index[i];
      sel = c > 0 && k >= 0 && a.mask[min(k, a.mask_len - 1)];
    } else {
      sel = a.mask[i];
    }
    if (!sel) c = 0;
  }
  s.c = c;
  if (c > 0) {
    const int o = a.off[i];
    s.row0 = floor_div(o, A);
    s.phase = o - s.row0 * A;
    s.rcnt = floor_div(o + c + A - 1, A) - s.row0;
  } else {
    s.row0 = s.phase = s.rcnt = 0;
  }
  return s;
}

// exclusive block scan of v over SCAN threads; returns the block total in tot
__device__ int block_scan(int v, int& tot) {
  __shared__ int warp_sums[SCAN / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, w, d);
      if (lane >= d) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  tot = warp_sums[SCAN / 32 - 1];
  const int before = warp ? warp_sums[warp - 1] : 0;
  __syncthreads();  // warp_sums is reused by the next call
  return before + x - v;
}

__device__ __forceinline__ void write_row(const PlanSet& a, int r, int src_row, int pstart,
                                          int c, bool ok, int seg) {
  a.src_row[r] = src_row;
  a.pstart[r] = pstart;
  a.pend[r] = pstart + c;
  a.r_ok[r] = ok;
  a.sr[r] = seg;
}

// the set of a tile (tiles) or of a fill warp (!tiles) of the launch
__device__ __forceinline__ int set_of(const PlanMany& p, int item, bool tiles) {
  int k = 0;
  while (k + 1 < p.nsets && item >= (tiles ? p.set[k + 1].tile0 : p.set[k + 1].warp0)) ++k;
  return k;
}

// Launched cooperatively (grid <= co-resident blocks): every thread reaches
// both grid barriers.
__global__ void __launch_bounds__(SCAN) plan_many(const __grid_constant__ PlanMany p) {
  cg::grid_group grid = cg::this_grid();
  // (a) per tile of every set: each segment's row offset within the tile,
  // and the tile's sums of rows and of selected samples
  for (int item = blockIdx.x; item < p.ntiles; item += gridDim.x) {
    const PlanSet& a = p.set[set_of(p, item, true)];
    const int t = item - a.tile0;
    const int i = t * SCAN + threadIdx.x;
    Seg s{0, 0, 0, 0};
    if (i < a.S) s = segment(a, i);
    int rows, samples;
    const int before = block_scan(s.rcnt, rows);
    block_scan(s.c, samples);
    if (i < a.S) a.local[i] = before;
    if (threadIdx.x == 0) {
      a.tsum[t] = rows;
      a.tsum[a.nt + t] = samples;
    }
  }
  grid.sync();
  // (b) one block per set: the tile sums into tile offsets, the set's rows
  // and its clamped sample count
  for (int k = blockIdx.x; k < p.nsets; k += gridDim.x) {
    const PlanSet& a = p.set[k];
    int carry = 0, samples = 0;
    for (int base = 0; base < a.nt; base += SCAN) {
      const int j = base + threadIdx.x;
      int tot, stot;
      const int before = block_scan(j < a.nt ? a.tsum[j] : 0, tot);
      block_scan(j < a.nt ? a.tsum[a.nt + j] : 0, stot);
      if (j < a.nt) a.tsum[j] = carry + before;
      carry += tot;
      samples += stot;
    }
    if (threadIdx.x == 0) {
      a.tsum[2 * a.nt] = carry;
      *a.count = min(samples, a.out_len);
    }
  }
  grid.sync();
  // (c) each warp writes the rows of 32 segments of one set (one segment at
  // a time, a row a lane) and their mpos
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (SCAN / 32);
  for (int w = blockIdx.x * (SCAN / 32) + (threadIdx.x >> 5); w < p.nwarps; w += warps) {
    const PlanSet& a = p.set[set_of(p, w, false)];
    const int seg0 = (w - a.warp0) * 32, i = seg0 + lane;
    Seg s{0, 0, 0, 0};
    int ro = 0;
    if (i < a.S) {
      s = segment(a, i);
      ro = a.local[i] + a.tsum[i / SCAN];
      a.mpos[i] = s.c > 0 ? ro * A + s.phase : a.out_len;
    }
    for (int k = 0; k < 32; ++k) {
      const int kro = __shfl_sync(FULL, ro, k);
      const int krc = __shfl_sync(FULL, s.rcnt, k);
      const int krow0 = __shfl_sync(FULL, s.row0, k);
      const int kstart = kro * A + __shfl_sync(FULL, s.phase, k);
      const int kc = __shfl_sync(FULL, s.c, k);
      const int end = min(kro + krc, a.WR);
      for (int r = kro + lane; r < end; r += 32)
        write_row(a, r, krow0 + (r - kro), kstart, kc, true, seg0 + k);
    }
  }
  // rows past each set's last segment, over the whole grid: the plain
  // version's values for them (segment S - 1, r_ok false)
  const long long threads = static_cast<long long>(gridDim.x) * SCAN;
  for (int k = 0; k < p.nsets; ++k) {
    const PlanSet& a = p.set[k];
    const int total = a.tsum[2 * a.nt];
    if (total >= a.WR) continue;
    const Seg last = segment(a, a.S - 1);
    const int ro = total - last.rcnt;
    for (long long r = total + static_cast<long long>(blockIdx.x) * SCAN + threadIdx.x;
         r < a.WR; r += threads) {
      const int ri = static_cast<int>(r);
      write_row(a, ri, last.row0 + (ri - ro), ro * A + last.phase, last.c, false, a.S - 1);
    }
  }
}

// ---- edl ----------------------------------------------------------------

// raster.edl: response = sum over the 4 neighbours (wrapping) of
// max(log2(d) - log2(d_n), 0), NaN -> 0; shade = exp(-(response / 50) * 300 *
// strength); each colour byte times shade, truncated; alpha 0xFF.
//
// What it replaces: the JAX frame's raster.edl (simlod_tpu/render/raster.py
// :259), which XLA fuses into the jitted frame, and this port's previous EDL
// kernel, a 1-D grid-stride loop of one thread per pixel that split each
// pixel index with a 64-bit divide and modulo and computed five log2f per
// pixel (its own and each of its 4 neighbours' again).
//
// What bounds it: memory. It reads colour and depth and writes colour, 12 B a
// pixel: 24.9 MB, 0.0074 ms at 3.35 TB/s at 1920x1080, and 99.5 MB, 0.0297 ms
// at 3840x2160. The 1080p planes fit the 50 MB L2 and are likely resident
// just after the splat that wrote them, so there the kernel may read under
// its HBM bound; at 4K they do not fit, and the HBM bound is the floor.
//
// What the design does about it: a 2-D grid of 128 x 8-pixel tiles, blocks of
// 32 x 8 threads, each thread 4 neighbouring pixels of a row; x and y from
// the block and thread indices in 32-bit ints (no 64-bit divide: the wrapper
// keeps width * height < 2^31). A thread first loads its 4 depths and 4
// colours, as one 16 B load each when the row width is a multiple of 4 and
// the pointers are 16 B aligned (scalar loads otherwise): 32 B in flight a
// thread before anything waits, which is what keeps HBM busy (on an H100
// 80GB HBM3, one pixel and one 4 B depth load a thread reached ~42% of the
// bound at 4K, this design ~68%). Each block puts log2f of its
// tile's depths and a one-pixel halo, (8 + 2) x (128 + 2) floats, in shared
// memory: the threads' own cells, then the 276 halo cells shared out over
// the block. The halo wraps as torch.roll does, column (x +- 1) mod W and
// row (y +- 1) mod H, for every edge and for images smaller than a tile.
// That is 1,300 log2f for 1,024 pixels (1.27 a pixel, not 5). After one
// barrier each thread reads its cells and the rows above and below as 16 B
// shared loads and shades its 4 pixels, stored as one 16 B store (or 4
// scalar ones). The strength is read from the device (Uniforms.edl_strength),
// so the launch takes no per-frame value. The arithmetic follows torch's op
// order (bit-equal to edl_reference on the card).
constexpr int EDL_PX = 4;                                   // pixels a thread
constexpr int EDL_THX = 32, EDL_THY = 8;                    // threads a block
constexpr int EDL_TX = EDL_THX * EDL_PX, EDL_TY = EDL_THY;  // pixels a tile
// the tile's column c (pixel x0 + c - 1, 0 <= c <= EDL_TX + 1) lies at
// EDL_PAD + c, so that each thread's 4 cells start on a 16 B boundary
constexpr int EDL_PAD = 3;
constexpr int EDL_SX = 136;  // >= EDL_PAD + EDL_TX + 2, a multiple of 4
constexpr int EDL_HALO = 2 * (EDL_TX + 2) + 2 * EDL_TY;
constexpr int EDL_MAX_GRID_Y = 65535;

// v in [-1, n + EDL_TX] mapped into the image as torch.roll wraps: v mod n
// for v in [-1, 2n); beyond that only cells of a tile larger than the image
// that no pixel reads, clamped to stay in bounds
__device__ __forceinline__ int edl_wrap(int v, int n) {
  v = v < 0 ? v + n : (v >= n ? v - n : v);
  return min(v, n - 1);
}

// a colour's bytes times shade, truncated; alpha 0xFF
__device__ __forceinline__ int edl_shade(int color, float shade) {
  const uint32_t c = static_cast<uint32_t>(color);
  long long v = 0xFF000000ll;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float ch = __fmul_rn(__int2float_rn(static_cast<int>((c >> (8 * k)) & 0xFFu)), shade);
    v |= static_cast<long long>(ch) << (8 * k);
  }
  return static_cast<int>(static_cast<uint32_t>(v));
}

template <bool VEC>
__global__ void __launch_bounds__(EDL_THX* EDL_THY)
    edl(const int* __restrict__ color, const int* __restrict__ depth, int width, int height,
        int tiles_y, const float* __restrict__ strength, int* __restrict__ out) {
  __shared__ __align__(16) float logd[EDL_TY + 2][EDL_SX];
  const int t = threadIdx.y * EDL_THX + threadIdx.x;
  const int x0 = blockIdx.x * EDL_TX;
  const int xs = x0 + EDL_PX * threadIdx.x;           // this thread's first pixel
  const int cx = EDL_PAD + 1 + EDL_PX * threadIdx.x;  // and its cell
  const int cy = threadIdx.y + 1;
  const float s = *strength;
  // more than 65,535 rows of tiles: each block takes every gridDim.y-th
  for (int ty = blockIdx.y; ty < tiles_y; ty += gridDim.y) {
    const int y0 = ty * EDL_TY, y = y0 + threadIdx.y;
    const bool whole = y < height && xs + EDL_PX <= width;
    int d[EDL_PX], c[EDL_PX];
    if (VEC && whole) {
      const int p = y * width + xs;
      const int4 dv = *reinterpret_cast<const int4*>(depth + p);
      const int4 cv = *reinterpret_cast<const int4*>(color + p);
      d[0] = dv.x, d[1] = dv.y, d[2] = dv.z, d[3] = dv.w;
      c[0] = cv.x, c[1] = cv.y, c[2] = cv.z, c[3] = cv.w;
    } else {
      // cells outside the image hold the wrapped depth (a pixel's neighbour
      // may read them); only pixels inside it have a colour
      const int gy = edl_wrap(y, height);
#pragma unroll
      for (int k = 0; k < EDL_PX; ++k) {
        d[k] = depth[gy * width + edl_wrap(xs + k, width)];
        c[k] = y < height && xs + k < width ? color[y * width + xs + k] : 0;
      }
    }
    *reinterpret_cast<float4*>(&logd[cy][cx]) =
        make_float4(log2f(__int_as_float(d[0])), log2f(__int_as_float(d[1])),
                    log2f(__int_as_float(d[2])), log2f(__int_as_float(d[3])));
    // the halo: rows 0 and EDL_TY + 1 whole, then columns 0 and EDL_TX + 1
    for (int i = t; i < EDL_HALO; i += EDL_THX * EDL_THY) {
      int r, col;
      if (i < 2 * (EDL_TX + 2)) {
        const bool last = i >= EDL_TX + 2;
        r = last ? EDL_TY + 1 : 0;
        col = last ? i - (EDL_TX + 2) : i;
      } else {
        const int j = i - 2 * (EDL_TX + 2);
        r = 1 + (j >> 1);
        col = (j & 1) ? EDL_TX + 1 : 0;
      }
      const int gx = edl_wrap(x0 + col - 1, width), gy = edl_wrap(y0 + r - 1, height);
      logd[r][EDL_PAD + col] = log2f(__int_as_float(depth[gy * width + gx]));
    }
    __syncthreads();
    if (y < height) {
      const float4 mid = *reinterpret_cast<const float4*>(&logd[cy][cx]);
      const float4 next = *reinterpret_cast<const float4*>(&logd[cy + 1][cx]);  // y + 1
      const float4 prev = *reinterpret_cast<const float4*>(&logd[cy - 1][cx]);  // y - 1
      const float row[EDL_PX + 2] = {logd[cy][cx - 1], mid.x, mid.y, mid.z, mid.w,
                                     logd[cy][cx + EDL_PX]};
      const float below[EDL_PX] = {next.x, next.y, next.z, next.w};
      const float above[EDL_PX] = {prev.x, prev.y, prev.z, prev.w};
      int o[EDL_PX];
#pragma unroll
      for (int k = 0; k < EDL_PX; ++k) {
        const float l = row[k + 1];
        // raster.edl's order: (dx, dy) = (0, 1), (1, 0), (0, -1), (-1, 0)
        const float nb[4] = {below[k], row[k + 2], above[k], row[k]};
        float resp = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float diff = __fsub_rn(l, nb[j]);
          resp = __fadd_rn(resp, diff != diff ? 0.0f : fmaxf(diff, 0.0f));
        }
        resp = __fmul_rn(resp, 1.0f / 50.0f);
        o[k] = edl_shade(c[k], expf(__fmul_rn(__fmul_rn(-resp, 300.0f), s)));
      }
      if (VEC && whole) {
        *reinterpret_cast<int4*>(out + y * width + xs) = make_int4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int k = 0; k < EDL_PX; ++k)
          if (xs + k < width) out[y * width + xs + k] = o[k];
      }
    }
    __syncthreads();  // the tile is read before the next one overwrites it
  }
}

// ---- the launch floor -----------------------------------------------------

__global__ void noop() {}

// ---- co-resident grids ----------------------------------------------------

constexpr int MAX_DEVICES = 64;
constexpr int COOP_PLAN = 0, COOP_VISIBILITY = 1, COOP_KERNELS = 2;
int coop_grids[COOP_KERNELS][MAX_DEVICES];  // 0: not computed yet

// The largest grid of a cooperative kernel that is co-resident on `device`
// (the current device): blocks per SM at its block size times the SMs,
// computed once per device. Threads that race here compute the same value.
int coop_grid(int kernel, int device, int* grid) {
  if (kernel < 0 || kernel >= COOP_KERNELS || device < 0 || device >= MAX_DEVICES)
    return static_cast<int>(cudaErrorInvalidValue);
  int g = __atomic_load_n(&coop_grids[kernel][device], __ATOMIC_RELAXED);
  if (g == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
    if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = kernel == COOP_PLAN
              ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, plan_many, SCAN, 0)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, visibility, THREADS, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    g = per_sm * sms;
    if (g < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    __atomic_store_n(&coop_grids[kernel][device], g, __ATOMIC_RELAXED);
  }
  *grid = g;
  return 0;
}

// The grid of the last launch of each cooperative kernel in this process,
// as simlod_last_grid reads it back.
int last_grids[COOP_KERNELS];

void note_grid(int kernel, int grid) {
  __atomic_store_n(&last_grids[kernel], grid, __ATOMIC_RELAXED);
}

}  // namespace

// C entry points (bound with ctypes in kernels/__init__.py). Each launches on
// `stream` (of `device`, made current for the launch), allocates nothing
// (outputs and scratch come from the caller), does not synchronise, and
// returns the first error of the launch (cudaGetLastError() included, and
// cleared).

// The co-resident grid of a cooperative kernel (0: plan_many, 1: visibility)
// on `device`, or minus a cudaError.
extern "C" int simlod_coop_grid(int kernel, int device) {
  const DeviceGuard guard(device);
  if (guard.error()) return -guard.error();
  int g = 0;
  const int rc = coop_grid(kernel, device, &g);
  return rc ? -rc : g;
}

// The grid (blocks) of the last launch of a cooperative kernel (0: plan_many,
// 1: visibility) in this process, on any device; 0 before its first launch,
// minus cudaErrorInvalidValue for another kernel number.
extern "C" int simlod_last_grid(int kernel) {
  if (kernel < 0 || kernel >= COOP_KERNELS) return -static_cast<int>(cudaErrorInvalidValue);
  return __atomic_load_n(&last_grids[kernel], __ATOMIC_RELAXED);
}

// visibility: `ptrs` is a host array of 24 device pointers in VisArgs' order
// (without a pool the two pool counts and the four pool outputs are null;
// partials holds blocks_for(n) rows of 5 ints, at least the grid),
// `uniforms` a device array of 44 floats (VisUniforms: m[16], planes[24],
// width, height, min_node_size, point_budget: config.Uniforms.vis). One
// cooperative launch of min(co-resident grid, blocks_for(n)) blocks; it
// takes no per-frame value by value.
extern "C" int simlod_visibility(const void* ptrs, const void* uniforms, int n, int draw_cap,
                                 int device, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  int grid = 0;
  int rc = coop_grid(COOP_VISIBILITY, device, &grid);
  if (rc) return rc;
  grid = std::min(grid, blocks_for(n));
  note_grid(COOP_VISIBILITY, grid);
  VisArgs a{};
  const long long* p = static_cast<const long long*>(ptrs);
  auto ptr = [&](int k) { return reinterpret_cast<void*>(p[k]); };
  a.nx = static_cast<const int*>(ptr(0));
  a.ny = static_cast<const int*>(ptr(1));
  a.nz = static_cast<const int*>(ptr(2));
  a.level = static_cast<const int*>(ptr(3));
  a.parent = static_cast<const int*>(ptr(4));
  a.child_base = static_cast<const int*>(ptr(5));
  a.num_points = static_cast<const int*>(ptr(6));
  a.num_voxels = static_cast<const int*>(ptr(7));
  a.num_nodes = static_cast<const int*>(ptr(8));
  a.box_min = static_cast<const float*>(ptr(9));
  a.cube_size = static_cast<const float*>(ptr(10));
  a.pool_pt_cnt = static_cast<const int*>(ptr(11));
  a.pool_vx_cnt = static_cast<const int*>(ptr(12));
  a.emitted = static_cast<bool*>(ptr(13));
  a.visible = static_cast<bool*>(ptr(14));
  a.is_large = static_cast<bool*>(ptr(15));
  a.dx = static_cast<float*>(ptr(16));
  a.dy = static_cast<float*>(ptr(17));
  a.counts = static_cast<int*>(ptr(18));
  a.take_p = static_cast<int*>(ptr(19));
  a.take_v = static_cast<int*>(ptr(20));
  a.exact_p = static_cast<bool*>(ptr(21));
  a.exact_v = static_cast<bool*>(ptr(22));
  a.partials = static_cast<int*>(ptr(23));
  a.uniforms = static_cast<const float*>(uniforms);
  a.n = n;
  a.draw_cap = draw_cap;
  void* args[] = {&a};
  return launch_error(cudaLaunchCooperativeKernel(reinterpret_cast<void*>(visibility), grid,
                                                  THREADS, args, 0,
                                                  static_cast<cudaStream_t>(stream)));
}

// plan_many: `words` is a host array of nsets x 16 int64 words, per set: the
// device pointers off, cnt, mask, index (mask and index may be null), src_row,
// pstart, pend, sr, mpos, count, r_ok, local ([S] ints of scratch), tsum
// ([2 ceil(S / 1024) + 1] ints of scratch), then S, mask_len, out_len.
// One cooperative launch of at most the co-resident grid.
extern "C" int simlod_plan_blocks_many(const void* words, int nsets, int device,
                                       void* stream) {
  if (nsets < 1 || nsets > MAX_PLANS) return static_cast<int>(cudaErrorInvalidValue);
  const DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  int grid = 0;
  int rc = coop_grid(COOP_PLAN, device, &grid);
  if (rc) return rc;
  PlanMany p{};
  const long long* w = static_cast<const long long*>(words);
  long long ntiles = 0, nwarps = 0, rows = 0;
  for (int k = 0; k < nsets; ++k, w += 16) {
    PlanSet& a = p.set[k];
    auto ptr = [&](int j) { return reinterpret_cast<void*>(w[j]); };
    a.off = static_cast<const int*>(ptr(0));
    a.cnt = static_cast<const int*>(ptr(1));
    a.mask = static_cast<const bool*>(ptr(2));
    a.index = static_cast<const int*>(ptr(3));
    a.src_row = static_cast<int*>(ptr(4));
    a.pstart = static_cast<int*>(ptr(5));
    a.pend = static_cast<int*>(ptr(6));
    a.sr = static_cast<int*>(ptr(7));
    a.mpos = static_cast<int*>(ptr(8));
    a.count = static_cast<int*>(ptr(9));
    a.r_ok = static_cast<bool*>(ptr(10));
    a.local = static_cast<int*>(ptr(11));
    a.tsum = static_cast<int*>(ptr(12));
    const long long S = w[13], out_len = w[15];
    if (S < 1 || S >= (1ll << 31) || out_len < 0 || out_len >= (1ll << 31) || out_len % A)
      return static_cast<int>(cudaErrorInvalidValue);
    a.S = static_cast<int>(S);
    a.mask_len = static_cast<int>(w[14]);
    a.out_len = static_cast<int>(out_len);
    a.WR = a.out_len / A;
    a.nt = static_cast<int>((S + SCAN - 1) / SCAN);
    a.tile0 = static_cast<int>(ntiles);
    a.warp0 = static_cast<int>(nwarps);
    ntiles += a.nt;
    nwarps += (S + 31) / 32;
    rows += a.WR;
  }
  if (nwarps >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  p.nsets = nsets;
  p.ntiles = static_cast<int>(ntiles);
  p.nwarps = static_cast<int>(nwarps);
  // as many blocks as the largest phase can use, never more than co-resident
  const long long work =
      std::max({ntiles, (rows + SCAN - 1) / SCAN, static_cast<long long>(nsets)});
  grid = static_cast<int>(std::min(static_cast<long long>(grid), work));
  note_grid(COOP_PLAN, grid);
  void* args[] = {&p};
  return launch_error(cudaLaunchCooperativeKernel(reinterpret_cast<void*>(plan_many), grid,
                                                  SCAN, args, 0,
                                                  static_cast<cudaStream_t>(stream)));
}

// The empty kernel: one block of 32 threads, launched plainly or (cooperative
// != 0) as a cooperative launch; the floor under every launch above.
extern "C" int simlod_noop(int cooperative, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  void* none[] = {nullptr};
  if (cooperative)
    return launch_error(
        cudaLaunchCooperativeKernel(reinterpret_cast<void*>(noop), 1, 32, none, 0, st));
  noop<<<1, 32, 0, st>>>();
  return launch_error(cudaSuccess);
}

// edl: color, depth bits and out are [width * height] int32 on the device
// (width * height < 2^31), strength a device float. One launch of
// ceil(W / 128) x ceil(H / 8) blocks of 32 x 8 threads (at most 65,535 rows
// of blocks, each then looping over its rows of tiles); 16 B loads and
// stores when W is a multiple of 4 and every plane is 16 B aligned.
extern "C" int simlod_edl(const void* color, const void* depth, int width, int height,
                          const void* strength, void* out, int device, void* stream) {
  if (width < 1 || height < 1 || static_cast<long long>(width) * height >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  const int tiles_x = static_cast<int>((static_cast<long long>(width) + EDL_TX - 1) / EDL_TX);
  const int tiles_y = static_cast<int>((static_cast<long long>(height) + EDL_TY - 1) / EDL_TY);
  const dim3 grid(tiles_x, std::min(tiles_y, EDL_MAX_GRID_Y)), block(EDL_THX, EDL_THY);
  const bool vec = width % EDL_PX == 0 && (reinterpret_cast<uintptr_t>(color) |
                                           reinterpret_cast<uintptr_t>(depth) |
                                           reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto c = static_cast<const int*>(color), d = static_cast<const int*>(depth);
  auto f = static_cast<const float*>(strength);
  auto o = static_cast<int*>(out);
  if (vec)
    edl<true><<<grid, block, 0, st>>>(c, d, width, height, tiles_y, f, o);
  else
    edl<false><<<grid, block, 0, st>>>(c, d, width, height, tiles_y, f, o);
  return launch_error(cudaSuccess);
}
