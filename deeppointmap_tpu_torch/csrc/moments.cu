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
// 8 FLOPs for each of the (center, valid point) pairs plus ~20 for each
// pair inside the radius. What held the first version back (four centers a
// block of 128 lanes, every point read from L2 once per four centers,
// padding and invalid points visited) is gone:
//   * pack_classes (radius.cuh) compacts the valid points once, class-major,
//     as float4 (x, y, z, |p|^2), so invalid points and padding cost nothing;
//   * a block of 16 warps owns 64 centers (two a lane, in registers) and
//     each warp walks 8 of the 128 classes: one broadcast 16-byte read feeds
//     64 centers, and a pair costs the distance and a subtraction;
//   * each warp stages its classes through its own double buffer in shared
//     memory with cp.async (walk_classes, radius.cuh): reading the points
//     straight from L2 left the warps waiting on loads;
//   * the radius test is a subtraction and an OR of sign bits (hit_bits),
//     off the half-rate compare pipe; the float64 path runs only for the
//     points that some lane has inside its radius (one vote a batch, then
//     one a point);
//   * the warps' partial sums are added in warp order, a fixed order.
// The class order does not matter to K3; the layout is K4's, shared.

#include "radius.cuh"

namespace {

using namespace dpm;

// Shared memory: the warps' staging buffers, then (after a barrier) the
// moment reduction in the same bytes.
constexpr int kSmem = kStageBytes > kWarps * kBlockCenters * kFeat * 8
                          ? kStageBytes
                          : kWarps * kBlockCenters * kFeat * 8;

__global__ void __launch_bounds__(kThreads, 1)
moments_kernel(const float* __restrict__ points, ClassScan s, int n,
               float r2, float* __restrict__ mom_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kBlockCenters;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Centers c = load_centers(points + (size_t)b * n * 3, n, c0, lane);
  const float r2n = __uint_as_float(__float_as_uint(r2) + 1u);
  double m[kPerLane][kFeat];
#pragma unroll
  for (int g = 0; g < kPerLane; ++g)
#pragma unroll
    for (int t = 0; t < kFeat; ++t) m[g][t] = 0.0;

  walk_classes(
      s, b, reinterpret_cast<float4*>(smem) + warp * 2 * kChunk,
      [](int) {},
      [&](const float4(&q)[4], int) {
        float d[4][kPerLane];
        int hit[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int g = 0; g < kPerLane; ++g)
            d[u][g] = dist2(c.c2[g], c.x[g], c.y[g], c.z[g], q[u].w, q[u].x,
                            q[u].y, q[u].z);
          hit[u] = hit_bits(d[u], r2n);
        }
        add_batch(q, d, hit, r2, m);
      },
      [](int) {});
  __syncthreads();  // the staging buffers become the reduction's
  reduce_moments(m, reinterpret_cast<double*>(smem),
                 mom_out + ((size_t)b * n + c0) * kFeat,
                 min(kBlockCenters, n - c0));
}

}  // namespace

// points (b, n, 3) f32, valid (b, n) bool as bytes; scratch of at least
// dpm::class_scratch_bytes(b, n) bytes; mom (b, n, 10) f32 out. All
// contiguous on the device. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int dpm_moments(const void* points, const void* valid, int b,
                           int n, float r2, void* scratch,
                           long long scratch_bytes, void* mom, void* stream) {
  if (b < 1 || n < 1 || b > 65535 ||
      scratch_bytes < class_scratch_bytes(b, n))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto p = static_cast<const float*>(points);
  const ClassScan s = class_scan(scratch, b, n);
  cudaError_t err =
      launch_pack(p, static_cast<const uint8_t*>(valid), b, n, s, st);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(moments_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kBlockCenters - 1) / kBlockCenters, b);
  moments_kernel<<<grid, kThreads, kSmem, st>>>(p, s, n, r2,
                                               static_cast<float*>(mom));
  return (int)cudaGetLastError();
}
