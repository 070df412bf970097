// Radius-PCA moments over all valid points within a radius of every point,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel deeppointmap_tpu/ops/pallas_moments.py
// (radius_moments_pallas, kernel _moments_kernel): for every point c of a
// scan, [cnt | s(3) | S6(6)] = sum over the valid points p with
// d2(c, p) <= r2 of [1 | p | xx xy xz yy yz zz], self included, cnt clamped
// to >= 1. Membership is decided on the single-rounded float32 distance of
// radius.cuh, the bits K2 and K4 see. The sums run in float64 with exact
// products and are rounded to float32 once: tighter than the TPU kernel's
// HIGHEST matmul, and independent of the summation order to within one
// float32 ulp, so the plain version (a float64 matrix product) agrees.
//
// Bound: operations. A scan is 196 KB in and 40 bytes a point out, against
// 8 FLOPs for each of the n^2 center-point pairs plus ~10 float64 additions
// for each pair inside the radius. Design: a block of 128 lanes owns four
// centers; lane l walks the points l, l + 128, ... straight from device
// memory (the scan stays in L2, and every point a lane loads serves four
// centers), keeps the four centers' ten sums in registers, and the block
// reduces them in a fixed order at the end. No shape limits.

#include "radius.cuh"

namespace {

using namespace dpm;

__global__ void __launch_bounds__(kLanes)
moments_kernel(const float* __restrict__ points,
               const uint8_t* __restrict__ valid, int n, float r2,
               float* __restrict__ mom_out) {
  __shared__ double red[kWarps * kCenters * kFeat];
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kCenters;
  const float* P = points + (size_t)b * n * 3;
  const uint8_t* V = valid + (size_t)b * n;

  float cx[kCenters], cy[kCenters], cz[kCenters], c2[kCenters];
  double m[kCenters][kFeat];
#pragma unroll
  for (int c = 0; c < kCenters; ++c) {
    const int ci = min(c0 + c, n - 1);
    cx[c] = P[3 * ci];
    cy[c] = P[3 * ci + 1];
    cz[c] = P[3 * ci + 2];
    c2[c] = sq_norm(cx[c], cy[c], cz[c]);
#pragma unroll
    for (int t = 0; t < kFeat; ++t) m[c][t] = 0.0;
  }

  for (int p = threadIdx.x; p < n; p += kLanes) {
    if (!V[p]) continue;
    const float x = P[3 * p], y = P[3 * p + 1], z = P[3 * p + 2];
    const float p2 = sq_norm(x, y, z);
    bool in[kCenters];
    bool any = false;
#pragma unroll
    for (int c = 0; c < kCenters; ++c) {
      in[c] = dist2(c2[c], cx[c], cy[c], cz[c], p2, x, y, z) <= r2;
      any |= in[c];
    }
    if (any) {
      double f[kFeat - 1];
      features(x, y, z, f);
#pragma unroll
      for (int c = 0; c < kCenters; ++c)
        if (in[c]) add_point(m[c], f);
    }
  }
  reduce_store(m, red, mom_out + ((size_t)b * n + c0) * kFeat,
               min(kCenters, n - c0));
}

}  // namespace

// points (b, n, 3) f32, valid (b, n) bool as bytes; mom (b, n, 10) f32 out.
// All contiguous on the device. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int dpm_moments(const void* points, const void* valid, int b,
                           int n, float r2, void* mom, void* stream) {
  if (b < 1 || n < 1 || b > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kCenters - 1) / kCenters, b);
  moments_kernel<<<grid, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const uint8_t*>(valid),
      n, r2, static_cast<float*>(mom));
  return (int)cudaGetLastError();
}
