// Shared by knn.cu (K2), moments.cu (K3) and sweep.cu (K4): the
// single-rounded squared distance that the plain versions use too, the
// float64 radius-moment accumulators, and K3's and K4's block layout with
// its fixed-order block reduction.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dpm {

// One block = kLanes threads and kCenters centers. Lane l visits the points
// l, l + kLanes, ... (its index-mod-128 class) and measures each against
// all of the block's centers, whose state it keeps in registers.
constexpr int kLanes = 128;
constexpr int kCenters = 4;
constexpr int kWarps = kLanes / 32;
constexpr int kFeat = 10;  // [cnt | s(3) | S6(6)]

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// |c|^2 - 2 c.p + |p|^2 as ((c2 - 2*cross) + p2), every operation rounded
// on its own (no FMA contraction): the bits of ops/neighbors.pairwise_dist2,
// so all kernels agree on radius membership and ranking.
__device__ __forceinline__ float dist2(float c2, float cx, float cy, float cz,
                                       float p2, float x, float y, float z) {
  const float cross = __fadd_rn(
      __fadd_rn(__fmul_rn(cx, x), __fmul_rn(cy, y)), __fmul_rn(cz, z));
  return __fadd_rn(__fsub_rn(c2, __fmul_rn(2.f, cross)), p2);
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

// Sum the lanes' partial moments in a fixed order (shuffle tree inside a
// warp, then the warps in order), round once to float32 and store the
// rows of the block's first `rows` centers; cnt is clamped to >= 1.
// `red` holds kWarps * kCenters * kFeat doubles. All threads must call.
__device__ __forceinline__ void reduce_store(double (&m)[kCenters][kFeat],
                                             double* red, float* out,
                                             int rows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < kCenters; ++c) {
#pragma unroll
    for (int t = 0; t < kFeat; ++t) {
      double v = m[c][t];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) red[(warp * kCenters + c) * kFeat + t] = v;
    }
  }
  __syncthreads();
  const int c = threadIdx.x / kFeat, t = threadIdx.x % kFeat;
  if (threadIdx.x < kCenters * kFeat && c < rows) {
    double v = red[c * kFeat + t];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += red[(w * kCenters + c) * kFeat + t];
    const float r = __double2float_rn(v);
    out[c * kFeat + t] = t == 0 ? fmaxf(r, 1.f) : r;
  }
}

}  // namespace dpm
