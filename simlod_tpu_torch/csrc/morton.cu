// Morton kernels of the build step for NVIDIA Hopper (sm_90a).
//
// They replace no TPU kernel: the JAX package jits the build step
// (simlod_tpu/octree/build.py) and XLA fuses these bit chains into its device
// loops, with no pallas_call among them. In the port each chain was a run of
// torch elementwise ops over whole columns, each its own kernel inside the
// build's replayed CUDA graphs: over the columns some 500 launches a
// 2M-point step that each read 4-8 B a row and wrote 4 B a row (about 11 GB),
// over the taken nodes and their children about 1,900 more, and the bitwise
// and shift kernels they made were 23-25% of a load's device time in the
// benchmark's traced breakdown. Each kernel here does one of those chains in
// one pass, one row a thread (four with 16 B loads and stores where every
// column is 16 B aligned), no shared memory:
//
//   route_keys    (ops/morton.route_keys; octree/build.route): quantize the
//                 f32 columns, encode the three Morton words, and the point
//                 keys of the routing sort (rows past `count` INT32_MAX).
//   decode_sorted (route): the merged stream's coordinates from its sorted
//                 words, and the point word 1 without its tag bit.
//   prefix_floor  (build._candidates): each row's first-in-cell emission
//                 floor from the common prefix with the row before it, and
//                 its count of candidate levels.
//   spill_floor   (build._leaves): the same over the spilled rows, decoded
//                 in registers, with each row's final leaf and level.
//   key_words     (build._candidates, build._cand_round): the voxel keys at
//                 level lo + r.
//   node_keys     (build._gather, _create_children, _child_rows): the first
//                 two Morton words of a node's interval start, or of the
//                 query just past its end, over the taken nodes and their
//                 children (1,024-8,192 rows a call, some 150 torch ops each,
//                 each op a launch of its own).
//
// What bounds them: bytes. Each reads its inputs once and writes its outputs
// once (the row before, where a kernel needs it, comes from the cache):
// 24-32 B a row, 50-106 MB a call at the main path's shapes (2,097,152-point
// steps), 15-32 us at 3.35 TB/s; a step's set, with its candidate rounds,
// moves about 0.4 GB, about 0.12 ms. node_keys moves 24 B a node row, a few
// hundred KB a call: the launch bounds it, and one launch replaces ~150.
//
// Every value that changes from call to call is read from device memory (the
// count, the domain, the spill count, the round), never passed by value, so a
// call recorded in a CUDA graph reads each replay's values; node_keys' `end`
// is fixed at each call site.
//
// Bit-equality with the plain versions (torch on the card): int32 math with
// arithmetic shifts, as torch's; the quantisation in torch's op order with one
// rounding an op (inv = 2^28 / cube_size by IEEE division, (x - min) * inv,
// floor), then float -> int32 as torch's CUDA cast (__float2int_rz: truncate,
// saturate, NaN -> 0) and the clamp. nvcc cannot contract anything here: the
// float ops are explicit __f*_rn intrinsics.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "launch.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 8192;
constexpr int I32_MAX = 0x7FFFFFFF;
constexpr int GRID_BITS = 7;       // constants.GRID_BITS
constexpr int FULL_GRID_BITS = 28;  // constants.FULL_GRID_BITS
constexpr int Q_MAX = (1 << FULL_GRID_BITS) - 1;

using simlod::DeviceGuard;
using simlod::launch_error;

// ---- rows: K consecutive rows a thread, 16 B accesses when K == 4 ----------

template <class T>
struct Vec4;
template <>
struct Vec4<int> {
  using type = int4;
};
template <>
struct Vec4<float> {
  using type = float4;
};
template <>
struct Vec4<unsigned char> {
  using type = uchar4;
};

template <int K, class T>
__device__ __forceinline__ void load(const T* __restrict__ p, long long r, T (&v)[K]) {
  if constexpr (K == 1) {
    v[0] = p[r];
  } else {
    static_assert(K == 4, "one row or four");
    const auto t = *reinterpret_cast<const typename Vec4<T>::type*>(p + r);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
}

template <int K, class T>
__device__ __forceinline__ void store(T* __restrict__ p, long long r, const T (&v)[K]) {
  if constexpr (K == 1) {
    p[r] = v[0];
  } else {
    typename Vec4<T>::type t;
    t.x = v[0];
    t.y = v[1];
    t.z = v[2];
    t.w = v[3];
    *reinterpret_cast<typename Vec4<T>::type*>(p + r) = t;
  }
}

// Each thread runs op.rows<K>(r) over groups of K rows, grid-stride; with
// K == 4 the last n % 4 rows go one a thread to block 0.
template <int K, class Op>
__global__ void __launch_bounds__(THREADS) rows_kernel(const Op op, const long long n) {
  const typename Op::Scalars s = op.scalars();
  const long long groups = n / K;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long g = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; g < groups;
       g += stride)
    op.template rows<K>(g * K, s);
  if constexpr (K > 1) {
    const long long r = groups * K + threadIdx.x;
    if (blockIdx.x == 0 && r < n) op.template rows<1>(r, s);
  }
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <class... P>
inline bool aligned16(const void* p, P... rest) {
  return aligned16(p) && aligned16(rest...);
}

template <class Op>
int launch_rows(const Op& op, long long n, bool vec, int device, void* stream) {
  if (n < 1 || n >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  const int k = vec ? 4 : 1;
  const long long b = (n / k + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(std::min<long long>(std::max<long long>(b, 1), MAX_BLOCKS));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    rows_kernel<4, Op><<<blocks, THREADS, 0, st>>>(op, n);
  else
    rows_kernel<1, Op><<<blocks, THREADS, 0, st>>>(op, n);
  return launch_error(cudaSuccess);
}

// ---- the codec (ops/morton.py's _spread3, _compact3, encode, decode) -------

// int32 sums that wrap as torch's do (signed overflow is undefined in C++)
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int spread3(int v) {
  v &= 0x3FF;
  v = (v | (v << 16)) & 0x030000FF;
  v = (v | (v << 8)) & 0x0300F00F;
  v = (v | (v << 4)) & 0x030C30C3;
  v = (v | (v << 2)) & 0x09249249;
  return v;
}

__device__ __forceinline__ int compact3(int v) {
  v &= 0x09249249;
  v = (v | (v >> 2)) & 0x030C30C3;
  v = (v | (v >> 4)) & 0x0300F00F;
  v = (v | (v >> 8)) & 0x030000FF;
  v = (v | (v >> 16)) & 0x000003FF;
  return v;
}

// one Morton word of morton.encode: bits [lo, lo + nlev) of each coordinate
__device__ __forceinline__ int encode_word(int qx, int qy, int qz, int lo, int nlev) {
  const int m = (1 << nlev) - 1;
  return (spread3((qx >> lo) & m) << 2) | (spread3((qy >> lo) & m) << 1) |
         spread3((qz >> lo) & m);
}

// morton.decode, arithmetic shifts as torch's
__device__ __forceinline__ void decode(int w0, int w1, int w2, int& qx, int& qy, int& qz) {
  qx = (compact3(w0 >> 2) << 18) | (compact3(w1 >> 2) << 8) | compact3(w2 >> 2);
  qy = (compact3(w0 >> 1) << 18) | (compact3(w1 >> 1) << 8) | compact3(w2 >> 1);
  qz = (compact3(w0) << 18) | (compact3(w1) << 8) | compact3(w2);
}

// morton.quantize_cols on one coordinate: floor((v - m) * inv), torch's CUDA
// float -> int32 cast, clamp to the grid
__device__ __forceinline__ int quantize(float v, float m, float inv) {
  const int q = __float2int_rz(floorf(__fmul_rn(__fsub_rn(v, m), inv)));
  return min(max(q, 0), Q_MAX);
}

// the emission floor of build._common_prefix_lo: the leading bits that xor3
// (the previous row's coordinates xor this row's, or -1) leaves zero at the
// top of 32 (32 where it is 0), less GRID_BITS - 1, at least 0
__device__ __forceinline__ int prefix_lo(int xor3) {
  const int n_common = __clz(static_cast<int>(static_cast<unsigned>(xor3) << (32 - FULL_GRID_BITS)));
  return max(n_common - (GRID_BITS - 1), 0);
}

// ---- route_keys -------------------------------------------------------------

struct RouteKeys {
  const float* x;
  const float* y;
  const float* z;
  const float* box_min;  // [3]
  const float* cube_size;
  const int* count;
  int* w2;
  int* pk0;
  int* pk1;

  struct Scalars {
    float m0, m1, m2, inv;
    int count;
  };
  __device__ Scalars scalars() const {
    return {box_min[0], box_min[1], box_min[2],
            __fdiv_rn(static_cast<float>(1 << FULL_GRID_BITS), *cube_size), *count};
  }
  template <int K>
  __device__ void rows(long long r, const Scalars& s) const {
    float vx[K], vy[K], vz[K];
    load<K>(x, r, vx);
    load<K>(y, r, vy);
    load<K>(z, r, vz);
    int o2[K], o0[K], o1[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int qx = quantize(vx[k], s.m0, s.inv), qy = quantize(vy[k], s.m1, s.inv),
                qz = quantize(vz[k], s.m2, s.inv);
      const bool valid = r + k < s.count;
      o0[k] = valid ? encode_word(qx, qy, qz, 18, 10) : I32_MAX;
      o1[k] = valid ? (encode_word(qx, qy, qz, 8, 10) << 1) | 1 : I32_MAX;
      o2[k] = encode_word(qx, qy, qz, 0, 8);
    }
    store<K>(w2, r, o2);
    store<K>(pk0, r, o0);
    store<K>(pk1, r, o1);
  }
};

// ---- decode_sorted ----------------------------------------------------------

struct DecodeSorted {
  const int* k0;
  const int* k1;
  const int* k2;
  int* w1;
  int* qx;
  int* qy;
  int* qz;

  struct Scalars {};
  __device__ Scalars scalars() const { return {}; }
  template <int K>
  __device__ void rows(long long r, const Scalars&) const {
    int a[K], b[K], c[K], ox[K], oy[K], oz[K];
    load<K>(k0, r, a);
    load<K>(k1, r, b);
    load<K>(k2, r, c);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      b[k] >>= 1;
      decode(a[k], b[k], c[k], ox[k], oy[k], oz[k]);
    }
    store<K>(w1, r, b);
    store<K>(qx, r, ox);
    store<K>(qy, r, oy);
    store<K>(qz, r, oz);
  }
};

// ---- prefix_floor -----------------------------------------------------------

struct PrefixFloor {
  const int* qx;
  const int* qy;
  const int* qz;
  const unsigned char* valid;  // torch.bool
  const int* lvl;
  int* lo;
  int* cnt;

  struct Scalars {};
  __device__ Scalars scalars() const { return {}; }
  template <int K>
  __device__ void rows(long long r, const Scalars&) const {
    int x[K], y[K], zz[K], l[K];
    unsigned char v[K];
    load<K>(qx, r, x);
    load<K>(qy, r, y);
    load<K>(qz, r, zz);
    load<K>(valid, r, v);
    load<K>(lvl, r, l);
    // the row before r (read where r > 0; row 0 has no previous row)
    int px = 0, py = 0, pz = 0;
    bool pv = false;
    if (r > 0) {
      px = qx[r - 1];
      py = qy[r - 1];
      pz = qz[r - 1];
      pv = valid[r - 1] != 0;
    }
    int olo[K], ocnt[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool prev_ok = pv && r + k != 0;
      const int xor3 = prev_ok ? (px ^ x[k]) | (py ^ y[k]) | (pz ^ zz[k]) : -1;
      olo[k] = prefix_lo(xor3);
      ocnt[k] = v[k] != 0 ? max(max(l[k], 1) - olo[k], 0) : 0;
      px = x[k];
      py = y[k];
      pz = zz[k];
      pv = v[k] != 0;
    }
    store<K>(lo, r, olo);
    store<K>(cnt, r, ocnt);
  }
};

// ---- spill_floor ------------------------------------------------------------

struct SpillFloor {
  const int* k0;
  const int* k1;
  const int* k2;
  const int* glvl;
  const int* cum;
  const int* n_spill;
  int* leaf;
  int* lo;
  int* cnt;

  struct Scalars {
    int n;
  };
  __device__ Scalars scalars() const { return {*n_spill}; }
  template <int K>
  __device__ void rows(long long r, const Scalars& s) const {
    int a[K], b[K], c[K], g[K], cs[K];
    load<K>(k0, r, a);
    load<K>(k1, r, b);
    load<K>(k2, r, c);
    load<K>(glvl, r, g);
    load<K>(cum, r, cs);
    // the row before r, decoded (where r > 0; row 0 has no previous row)
    int px = 0, py = 0, pz = 0;
    if (r > 0) decode(k0[r - 1], k1[r - 1], k2[r - 1], px, py, pz);
    int oleaf[K], olo[K], ocnt[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      int x, y, zz;
      decode(a[k], b[k], c[k], x, y, zz);
      const long long i = r + k;
      const bool valid = i < s.n;
      const bool prev_ok = valid && i - 1 < s.n && i > 0;
      const int xor3 = prev_ok ? (px ^ x) | (py ^ y) | (pz ^ zz) : -1;
      px = x;
      py = y;
      pz = zz;
      const int c1 = wrap_add(cs[k], -1);
      oleaf[k] = cs[k] > 0 ? c1 >> 5 : 0;
      const int flvl = cs[k] > 0 ? c1 & 31 : 0;
      olo[k] = max(prefix_lo(xor3), g[k]);
      ocnt[k] = valid ? max(flvl - olo[k], 0) : 0;
    }
    store<K>(leaf, r, oleaf);
    store<K>(lo, r, olo);
    store<K>(cnt, r, ocnt);
  }
};

// ---- key_words --------------------------------------------------------------

// morton.key_words_at_level's mask of one word: its top 3 * clamp(keep - off,
// 0, nlev) bits
__device__ __forceinline__ int keep_mask(int keep, int off, int nlev) {
  const int k = min(max(wrap_add(keep, -off), 0), nlev);
  return ~((1 << (3 * (nlev - k))) - 1);
}

struct KeyWords {
  const int* w0;
  const int* w1;
  const int* w2;
  const int* lo;
  const int* round;  // device scalar, or null: round 0
  int* k0;
  int* k1;
  int* k2l;

  struct Scalars {
    int r;
  };
  __device__ Scalars scalars() const { return {round != nullptr ? *round : 0}; }
  template <int K>
  __device__ void rows(long long r, const Scalars& s) const {
    int a[K], b[K], c[K], l[K];
    load<K>(w0, r, a);
    load<K>(w1, r, b);
    load<K>(w2, r, c);
    load<K>(lo, r, l);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int level = wrap_add(l[k], s.r);
      const int keep = wrap_add(level, GRID_BITS);
      a[k] &= keep_mask(keep, 0, 10);
      b[k] &= keep_mask(keep, 10, 10);
      c[k] = (c[k] & keep_mask(keep, 20, 8)) | level;
    }
    store<K>(k0, r, a);
    store<K>(k1, r, b);
    store<K>(k2l, r, c);
  }
};

// ---- node_keys --------------------------------------------------------------

// torch's int32 `a << b` with a tensor shift: 0 where b is negative or at
// least 32, else the bits shifted as unsigned
__device__ __forceinline__ int shift_left(int a, int b) {
  return b < 0 || b >= 32 ? 0 : static_cast<int>(static_cast<unsigned>(a) << b);
}

struct NodeKeys {
  const int* nx;
  const int* ny;
  const int* nz;
  const int* level;
  int* w0;
  int* w1;
  int end;  // 0: the interval's start key; 1: the query just past its end

  struct Scalars {};
  __device__ Scalars scalars() const { return {}; }
  template <int K>
  __device__ void rows(long long r, const Scalars&) const {
    int x[K], y[K], zz[K], l[K], o0[K], o1[K];
    load<K>(nx, r, x);
    load<K>(ny, r, y);
    load<K>(nz, r, zz);
    load<K>(level, r, l);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int shift = wrap_add(FULL_GRID_BITS, -l[k]);
      const int ones = end ? wrap_add(shift_left(1, shift), -1) : 0;
      const int qx = shift_left(x[k], shift) | ones, qy = shift_left(y[k], shift) | ones,
                qz = shift_left(zz[k], shift) | ones;
      o0[k] = encode_word(qx, qy, qz, 18, 10);
      o1[k] = wrap_add(encode_word(qx, qy, qz, 8, 10), end);
    }
    store<K>(w0, r, o0);
    store<K>(w1, r, o1);
  }
};

}  // namespace

extern "C" int simlod_route_keys(const void* x, const void* y, const void* z,
                                 const void* box_min, const void* cube_size,
                                 const void* count, void* w2, void* pk0, void* pk1,
                                 long long n, int device, void* stream) {
  const RouteKeys op{static_cast<const float*>(x), static_cast<const float*>(y),
                     static_cast<const float*>(z), static_cast<const float*>(box_min),
                     static_cast<const float*>(cube_size), static_cast<const int*>(count),
                     static_cast<int*>(w2), static_cast<int*>(pk0), static_cast<int*>(pk1)};
  return launch_rows(op, n, aligned16(x, y, z, w2, pk0, pk1), device, stream);
}

extern "C" int simlod_decode_sorted(const void* k0, const void* k1, const void* k2, void* w1,
                                    void* qx, void* qy, void* qz, long long n, int device,
                                    void* stream) {
  const DecodeSorted op{static_cast<const int*>(k0), static_cast<const int*>(k1),
                        static_cast<const int*>(k2), static_cast<int*>(w1),
                        static_cast<int*>(qx), static_cast<int*>(qy), static_cast<int*>(qz)};
  return launch_rows(op, n, aligned16(k0, k1, k2, w1, qx, qy, qz), device, stream);
}

extern "C" int simlod_prefix_floor(const void* qx, const void* qy, const void* qz,
                                   const void* valid, const void* lvl, void* lo, void* cnt,
                                   long long n, int device, void* stream) {
  const PrefixFloor op{static_cast<const int*>(qx), static_cast<const int*>(qy),
                       static_cast<const int*>(qz), static_cast<const unsigned char*>(valid),
                       static_cast<const int*>(lvl), static_cast<int*>(lo),
                       static_cast<int*>(cnt)};
  return launch_rows(op, n, aligned16(qx, qy, qz, valid, lvl, lo, cnt), device, stream);
}

extern "C" int simlod_spill_floor(const void* k0, const void* k1, const void* k2,
                                  const void* glvl, const void* cum, const void* n_spill,
                                  void* leaf, void* lo, void* cnt, long long n, int device,
                                  void* stream) {
  const SpillFloor op{static_cast<const int*>(k0), static_cast<const int*>(k1),
                      static_cast<const int*>(k2), static_cast<const int*>(glvl),
                      static_cast<const int*>(cum), static_cast<const int*>(n_spill),
                      static_cast<int*>(leaf), static_cast<int*>(lo), static_cast<int*>(cnt)};
  return launch_rows(op, n, aligned16(k0, k1, k2, glvl, cum, leaf, lo, cnt), device, stream);
}

extern "C" int simlod_key_words(const void* w0, const void* w1, const void* w2, const void* lo,
                                const void* round, void* k0, void* k1, void* k2l, long long n,
                                int device, void* stream) {
  const KeyWords op{static_cast<const int*>(w0), static_cast<const int*>(w1),
                    static_cast<const int*>(w2), static_cast<const int*>(lo),
                    static_cast<const int*>(round), static_cast<int*>(k0),
                    static_cast<int*>(k1), static_cast<int*>(k2l)};
  return launch_rows(op, n, aligned16(w0, w1, w2, lo, k0, k1, k2l), device, stream);
}

extern "C" int simlod_node_keys(const void* nx, const void* ny, const void* nz, const void* level,
                                int end, void* w0, void* w1, long long n, int device,
                                void* stream) {
  const NodeKeys op{static_cast<const int*>(nx), static_cast<const int*>(ny),
                    static_cast<const int*>(nz), static_cast<const int*>(level),
                    static_cast<int*>(w0), static_cast<int*>(w1), end != 0};
  return launch_rows(op, n, aligned16(nx, ny, nz, level, w0, w1), device, stream);
}
