// Shared by knn.cu (K2), moments.cu (K3) and sweep.cu (K4): the
// single-rounded squared distance that the plain versions use too, the
// 64-bit (distance, index) keys, the float64 radius-moment accumulators,
// and K3's and K4's class-major scan layout, block layout and fixed-order
// moment reduction.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dpm {

constexpr int kFeat = 10;  // [cnt | s(3) | S6(6)]
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// |c|^2 - 2 c.p + |p|^2 as ((c2 - 2*cross) + p2), every operation rounded
// on its own: the bits of ops/neighbors.pairwise_dist2, so all kernels
// agree on radius membership and ranking. c2 - 2*cross is one fmaf: 2*cross
// is exact, so fmaf(-2, cross, c2) rounds the same value once.
__device__ __forceinline__ float dist2(float c2, float cx, float cy, float cz,
                                       float p2, float x, float y, float z) {
  const float cross = __fadd_rn(
      __fadd_rn(__fmul_rn(cx, x), __fmul_rn(cy, y)), __fmul_rn(cz, z));
  return __fadd_rn(__fmaf_rn(-2.f, cross, c2), p2);
}

// Order-preserving bits of a float (unsigned compare = float compare).
__device__ __forceinline__ uint32_t mono_bits(float d) {
  const uint32_t u = __float_as_uint(d);
  return u ^ ((uint32_t)((int32_t)u >> 31) | 0x80000000u);
}

__device__ __forceinline__ float mono_float(uint32_t m) {
  return __uint_as_float(m & 0x80000000u ? m ^ 0x80000000u : ~m);
}

// (distance, index) as one 64-bit key: a total order on the pairs.
__device__ __forceinline__ uint64_t make_key(float d, int idx) {
  return ((uint64_t)mono_bits(d) << 32) | (uint32_t)idx;
}

// The nine non-constant features of a point, products taken in float64
// (exact for float32 inputs).
__device__ __forceinline__ void features(float x, float y, float z,
                                         double (&f)[kFeat - 1]) {
  const double xd = x, yd = y, zd = z;
  f[0] = xd;
  f[1] = yd;
  f[2] = zd;
  f[3] = xd * xd;
  f[4] = xd * yd;
  f[5] = xd * zd;
  f[6] = yd * yd;
  f[7] = yd * zd;
  f[8] = zd * zd;
}

__device__ __forceinline__ void add_point(double (&m)[kFeat],
                                          const double (&f)[kFeat - 1]) {
  m[0] += 1.0;
#pragma unroll
  for (int t = 1; t < kFeat; ++t) m[t] += f[t - 1];
}

// ---------------------------------------------------------------------
// K3's and K4's layout.
//
// The scan is packed once, class-major: the index-mod-128 class j holds the
// points j, j + 128, ... of a scan padded to n_pad = max(256, n rounded up
// to 128), so every class has m = n_pad / 128 >= 2 members. Its VALID
// points are stored first, compacted in ascending index order, as float4
// (x, y, z, |p|^2) with their indices beside them, then up to three pads
// (0, 0, 0, +inf) up to a multiple of four (a pad's distance is +inf: it is
// never a candidate and never inside a radius). Invalid points and the
// padding are never visited: each class keeps its valid count and its two
// lowest invalid indices (-1 if it has fewer), which is all K4 needs of
// them, since they all stand at 1e9.
//
// A block of kWarps warps owns kBlockCenters centers: lane l holds centers
// l and l + 32 in registers and reads every point as a warp-wide broadcast.
// Warp w walks the classes [w * kClassesPerWarp, (w + 1) * kClassesPerWarp)
// against all of them, so one point load serves 64 centers, and the block's
// warps split the scan by class without ever sharing a class.
constexpr int kClasses = 128;
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kPerLane = 2;
constexpr int kBlockCenters = 32 * kPerLane;
constexpr int kClassesPerWarp = kClasses / kWarps;

struct ClassScan {
  float4* pts;  // (b, kClasses, m4)
  int* idx;     // (b, kClasses, m4)
  int* cnt;     // (b, kClasses)
  int* inv;     // (b, kClasses, 2)
  int m, m4;
};

inline int class_members(int n) {
  return (n + kClasses - 1) / kClasses < 2 ? 2
                                           : (n + kClasses - 1) / kClasses;
}

// Bytes of scratch the layout takes; ops/sweep.py allocates the same.
inline long long class_scratch_bytes(int b, int n) {
  const long long m4 = (class_members(n) + 3) & ~3;
  return (long long)b * kClasses * (m4 * 20 + 12);
}

inline ClassScan class_scan(void* scratch, int b, int n) {
  ClassScan s;
  s.m = class_members(n);
  s.m4 = (s.m + 3) & ~3;
  const size_t slots = (size_t)b * kClasses * s.m4;
  s.pts = static_cast<float4*>(scratch);
  s.idx = reinterpret_cast<int*>(s.pts + slots);
  s.cnt = s.idx + slots;
  s.inv = s.cnt + (size_t)b * kClasses;
  return s;
}

// One warp a class: compact its valid points by ballot, pad, record the
// count and the two lowest invalid indices. Launch: grid (kClasses / 4, b),
// 128 threads.
__global__ void __launch_bounds__(128)
pack_classes(const float* __restrict__ points,
             const uint8_t* __restrict__ valid, int n, ClassScan s) {
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * 4 + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  const float* P = points + (size_t)b * n * 3;
  const uint8_t* V = valid + (size_t)b * n;
  const size_t cls = (size_t)b * kClasses + j;
  float4* out = s.pts + cls * s.m4;
  int* out_idx = s.idx + cls * s.m4;
  int filled = 0, inv0 = -1, inv1 = -1;
  for (int i0 = 0; i0 < s.m; i0 += 32) {
    const int i = i0 + lane;
    const int p = j + kClasses * i;
    const bool member = i < s.m;
    const bool ok = member && p < n && V[p];
    const unsigned vb = __ballot_sync(kFull, ok);
    unsigned ib = __ballot_sync(kFull, member && !ok);
    if (ok) {
      const float x = P[3 * (size_t)p], y = P[3 * (size_t)p + 1],
                  z = P[3 * (size_t)p + 2];
      const int at = filled + __popc(vb & ((1u << lane) - 1u));
      out[at] = make_float4(x, y, z, sq_norm(x, y, z));
      out_idx[at] = p;
    }
    filled += __popc(vb);
    if (inv0 < 0 && ib != 0u) {
      inv0 = j + kClasses * (i0 + __ffs(ib) - 1);
      ib &= ib - 1u;
    }
    if (inv1 < 0 && ib != 0u) inv1 = j + kClasses * (i0 + __ffs(ib) - 1);
  }
  for (int at = filled + lane; at < ((filled + 3) & ~3); at += 32) {
    out[at] = make_float4(0.f, 0.f, 0.f, INFINITY);
    out_idx[at] = 0;
  }
  if (lane == 0) {
    s.cnt[cls] = filled;
    s.inv[2 * cls] = inv0;
    s.inv[2 * cls + 1] = inv1;
  }
}

inline cudaError_t launch_pack(const float* points, const uint8_t* valid,
                               int b, int n, const ClassScan& s,
                               cudaStream_t stream) {
  pack_classes<<<dim3(kClasses / 4, b), 128, 0, stream>>>(points, valid, n,
                                                          s);
  return cudaGetLastError();
}

// Each warp stages its classes through a private double buffer in shared
// memory (kChunk slots of float4 each), with cp.async and no block barrier:
// the next chunk loads while this one is measured, so the loop reads every
// point as a shared-memory broadcast instead of waiting on L2.
constexpr int kChunk = 128;
constexpr int kStageBytes = kWarps * 2 * kChunk * (int)sizeof(float4);

__device__ __forceinline__ void stage_chunk(float4* dst, const float4* src,
                                            int len, int lane) {
  for (int i = lane; i < len; i += 32) {
    const unsigned at = (unsigned)__cvta_generic_to_shared(dst + i);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(at),
                 "l"(src + i));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Walk the warp's classes (warp w: classes w * kClassesPerWarp, ...) in
// order, and each class's slots in order, four at a time:
// begin(j) at the start of class j, visit(q, t) for slots t .. t + 3 (q
// holds their points), end(j) after its last slot. `stage` is the warp's
// 2 * kChunk float4 of shared memory. Every lane of the warp calls.
template <class Begin, class Visit, class End>
__device__ __forceinline__ void walk_classes(const ClassScan& s, int b,
                                             float4* stage, Begin begin,
                                             Visit visit, End end) {
  const int lane = threadIdx.x & 31;
  const int j0 = (threadIdx.x >> 5) * kClassesPerWarp;
  const size_t base = (size_t)b * kClasses + j0;
  // the warp's class lengths, rounded up to whole batches of four
  const int mine = lane < kClassesPerWarp ? (s.cnt[base + lane] + 3) & ~3
                                          : 0;
  int len = __shfl_sync(kFull, mine, 0);
  int j = 0, off = 0, buf = 0;
  stage_chunk(stage, s.pts + base * s.m4, min(kChunk, len), lane);
  while (j < kClassesPerWarp) {
    // the chunk after this one
    int nj = j, noff = off + kChunk;
    if (noff >= len) {
      nj = j + 1;
      noff = 0;
    }
    const int nlen = __shfl_sync(kFull, mine, min(nj, kClassesPerWarp - 1));
    stage_chunk(stage + (buf ^ 1) * kChunk,
                s.pts + (base + nj) * s.m4 + noff,
                nj < kClassesPerWarp ? min(kChunk, nlen - noff) : 0, lane);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncwarp();
    if (off == 0) begin(j0 + j);
    const float4* tile = stage + buf * kChunk;
    const int here = min(kChunk, len - off);
    for (int t = 0; t < here; t += 4) {
      float4 q[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) q[u] = tile[t + u];
      visit(q, off + t);
    }
    if (off + here >= len) end(j0 + j);
    __syncwarp();  // the buffer is refilled two chunks on
    j = nj;
    off = noff;
    len = nlen;
    buf ^= 1;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// The block's centers: lane l holds local centers l and l + 32 (clamped to
// n - 1 past the end of the scan; their rows are not written).
struct Centers {
  float x[kPerLane], y[kPerLane], z[kPerLane], c2[kPerLane];
};

__device__ __forceinline__ Centers load_centers(const float* P, int n,
                                                int c0, int lane) {
  Centers c;
#pragma unroll
  for (int g = 0; g < kPerLane; ++g) {
    const int ci = min(c0 + g * 32 + lane, n - 1);
    c.x[g] = P[3 * (size_t)ci];
    c.y[g] = P[3 * (size_t)ci + 1];
    c.z[g] = P[3 * (size_t)ci + 2];
    c.c2[g] = sq_norm(c.x[g], c.y[g], c.z[g]);
  }
  return c;
}

// The radius test of a batch, kept off the compare pipe: with r2n the
// float after r2, d <= r2 exactly when d - r2n rounds to a negative value
// (a difference of two floats is zero only when they are equal), so one
// subtraction a pair and an OR of sign bits a point say whether any of the
// lane's centers has the point inside the radius. hit[u] < 0: it does.
__device__ __forceinline__ int hit_bits(const float (&d)[kPerLane], float r2n) {
  unsigned bits = 0u;
#pragma unroll
  for (int g = 0; g < kPerLane; ++g)
    bits |= __float_as_uint(__fsub_rn(d[g], r2n));
  return (int)bits;
}

// Add the points of a batch that lie within r2 of the lane's centers to
// their float64 sums, in slot order. One vote a batch, then one a point:
// only the points some lane needs take the float64 path.
__device__ __forceinline__ void add_batch(const float4 (&q)[4],
                                          const float (&d)[4][kPerLane],
                                          const int (&hit)[4], float r2,
                                          double (&m)[kPerLane][kFeat]) {
  if (!__any_sync(kFull, (hit[0] | hit[1] | hit[2] | hit[3]) < 0)) return;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (!__any_sync(kFull, hit[u] < 0)) continue;
    double f[kFeat - 1];
    features(q[u].x, q[u].y, q[u].z, f);
#pragma unroll
    for (int g = 0; g < kPerLane; ++g)
      if (d[u][g] <= r2) add_point(m[g], f);
  }
}

// Add the warps' partial moments of every center in warp order (a fixed
// order), round once to float32 and store the block's first `rows` rows at
// `out`; cnt is clamped to >= 1. `red` holds kWarps * kBlockCenters * kFeat
// doubles. All threads call; shared memory written before the call is
// visible to the whole block after it (one block barrier inside).
__device__ __forceinline__ void reduce_moments(
    const double (&m)[kPerLane][kFeat], double* red, float* out, int rows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < kPerLane; ++g)
#pragma unroll
    for (int t = 0; t < kFeat; ++t)
      red[((size_t)warp * kBlockCenters + g * 32 + lane) * kFeat + t] =
          m[g][t];
  __syncthreads();
  for (int e = threadIdx.x; e < rows * kFeat; e += kThreads) {
    double v = red[e];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += red[(size_t)w * kBlockCenters * kFeat + e];
    const float r = __double2float_rn(v);
    out[e] = e % kFeat == 0 ? fmaxf(r, 1.f) : r;
  }
}

}  // namespace dpm
