// The fused preprocessing sweep for Hopper (sm_90a): one distance pass that
// gives every point of a scan its k nearest candidates and, optionally, its
// radius-PCA moments.
//
// Replaces the TPU kernel deeppointmap_tpu/ops/pallas_sweep.py
// (fused_sweep_pallas, kernel _sweep_kernel) and keeps its rule, not its
// tiling: a center's candidates are the two nearest points of each
// index-mod-128 class (ties to the lower index), invalid points standing at
// 1e9, and its neighbours are the k smallest of those 256 by (distance,
// index), ascending. The result is approximate where three of a center's k
// nearest share a class (recall >= 0.97 at k = 17 and 41). With fewer than
// k valid candidates the tail carries 1e9 and an index inside [0, n).
// Distances are the single-rounded float32 values of radius.cuh, so the
// kernel and ops/sweep.fused_sweep_plain give the same bits. With r2 > 0
// the same pass accumulates the moments of moments.cu (float64 sums,
// rounded once). The TPU version leaves the final top-k over the 256
// candidates to XLA; here it is fused into the kernel (a bitonic sort of
// the 256 keys in shared memory).
//
// Bound: operations (8 FLOPs for each of the n^2 pairs against 196 KB in
// and 12 k + 40 bytes a point out). Design: the class rule maps onto the
// card as it stands. A block of 128 lanes owns four centers; lane l walks
// the points of class l straight from device memory (L2-resident) and holds
// each center's best two in four registers, so no thread keeps a k-long
// list and the cost does not grow with k. The 256 winners of a center then
// become 64-bit keys (order-preserving distance bits, then the index),
// sorted by the block, and the first k are written out.

#include "radius.cuh"

namespace {

using namespace dpm;

constexpr int kCand = 2 * kLanes;
constexpr int kIdxBits = 31;

__device__ __forceinline__ long long make_key(float d, int idx) {
  const int bits = __float_as_int(d);
  const int mono = bits >= 0 ? bits : bits ^ 0x7fffffff;
  return ((long long)mono << kIdxBits) + idx;
}

template <bool MOMENTS>
__global__ void __launch_bounds__(kLanes)
sweep_kernel(const float* __restrict__ points,
             const uint8_t* __restrict__ valid, int n, int n_pad, int k,
             float r2, int64_t* __restrict__ idx_out,
             float* __restrict__ d2_out, float* __restrict__ mom_out) {
  __shared__ long long keys[kCenters][kCand];
  __shared__ double red[MOMENTS ? kWarps * kCenters * kFeat : 1];
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kCenters;
  const int lane = threadIdx.x;
  const float* P = points + (size_t)b * n * 3;
  const uint8_t* V = valid + (size_t)b * n;

  float cx[kCenters], cy[kCenters], cz[kCenters], c2[kCenters];
  float b1d[kCenters], b2d[kCenters];
  int b1i[kCenters], b2i[kCenters];
  double m[MOMENTS ? kCenters : 1][kFeat];
#pragma unroll
  for (int c = 0; c < kCenters; ++c) {
    const int ci = min(c0 + c, n - 1);
    cx[c] = P[3 * ci];
    cy[c] = P[3 * ci + 1];
    cz[c] = P[3 * ci + 2];
    c2[c] = sq_norm(cx[c], cy[c], cz[c]);
    b1d[c] = b2d[c] = INFINITY;
    b1i[c] = b2i[c] = 0x7fffffff;
    if constexpr (MOMENTS) {
#pragma unroll
      for (int t = 0; t < kFeat; ++t) m[c][t] = 0.0;
    }
  }

  // n_pad >= 256 is a multiple of 128: positions past n count as invalid
  // points, so every class fills both of its slots
  for (int p = lane; p < n_pad; p += kLanes) {
    const bool ok = p < n && V[p];
    float x = 0.f, y = 0.f, z = 0.f;
    if (ok) {
      x = P[3 * p];
      y = P[3 * p + 1];
      z = P[3 * p + 2];
    }
    const float p2 = sq_norm(x, y, z);
    bool in[kCenters];
    bool any = false;
#pragma unroll
    for (int c = 0; c < kCenters; ++c) {
      const float d =
          ok ? dist2(c2[c], cx[c], cy[c], cz[c], p2, x, y, z) : 1e9f;
      in[c] = MOMENTS && ok && d <= r2;
      any |= in[c];
      // a lane meets its points in ascending index order, so a tie never
      // displaces an earlier point
      const bool lt1 = d < b1d[c];
      const bool lt2 = d < b2d[c];
      b2d[c] = lt1 ? b1d[c] : (lt2 ? d : b2d[c]);
      b2i[c] = lt1 ? b1i[c] : (lt2 ? p : b2i[c]);
      b1d[c] = lt1 ? d : b1d[c];
      b1i[c] = lt1 ? p : b1i[c];
    }
    if constexpr (MOMENTS) {
      if (any) {
        double f[kFeat - 1];
        features(x, y, z, f);
#pragma unroll
        for (int c = 0; c < kCenters; ++c)
          if (in[c]) add_point(m[c], f);
      }
    }
  }

#pragma unroll
  for (int c = 0; c < kCenters; ++c) {
    keys[c][lane] = make_key(b1d[c], b1i[c]);
    keys[c][kLanes + lane] = make_key(b2d[c], b2i[c]);
  }
  __syncthreads();
  // bitonic sort, ascending, of each center's 256 keys: one
  // compare-exchange a lane, a center and a step
  for (int size = 2; size <= kCand; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const int lo = 2 * lane - (lane & (stride - 1));
      const int hi = lo + stride;
      const bool asc = (lo & size) == 0;
#pragma unroll
      for (int c = 0; c < kCenters; ++c) {
        const long long a = keys[c][lo], bb = keys[c][hi];
        if ((a > bb) == asc) {
          keys[c][lo] = bb;
          keys[c][hi] = a;
        }
      }
      __syncthreads();
    }
  }

  const int rows = min(kCenters, n - c0);
  if (lane < k) {
    for (int c = 0; c < rows; ++c) {
      const long long key = keys[c][lane];
      const int mono = (int)(key >> kIdxBits);
      const int bits = mono >= 0 ? mono : mono ^ 0x7fffffff;
      const size_t at = ((size_t)b * n + c0 + c) * k + lane;
      idx_out[at] = min((int)(key & 0x7fffffff), n - 1);
      d2_out[at] = __int_as_float(bits);
    }
  }
  if constexpr (MOMENTS)
    reduce_store(m, red, mom_out + ((size_t)b * n + c0) * kFeat, rows);
}

}  // namespace

// points (b, n, 3) f32, valid (b, n) bool as bytes; idx (b, n, k) int64 and
// d2 (b, n, k) f32 out; mom (b, n, 10) f32 out, or null for no moments
// (r2 is then ignored). All contiguous on the device; 1 <= k <= 128.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int dpm_sweep(const void* points, const void* valid, int b, int n,
                         int k, float r2, void* idx, void* d2, void* mom,
                         void* stream) {
  if (b < 1 || n < 1 || b > 65535 || k < 1 || k > kLanes)
    return (int)cudaErrorInvalidValue;
  const int n_pad = max(kCand, (n + kLanes - 1) / kLanes * kLanes);
  const dim3 grid((n + kCenters - 1) / kCenters, b);
  auto st = static_cast<cudaStream_t>(stream);
  auto p = static_cast<const float*>(points);
  auto v = static_cast<const uint8_t*>(valid);
  auto i = static_cast<int64_t*>(idx);
  auto d = static_cast<float*>(d2);
  if (mom != nullptr)
    sweep_kernel<true><<<grid, kLanes, 0, st>>>(p, v, n, n_pad, k, r2, i, d,
                                                static_cast<float*>(mom));
  else
    sweep_kernel<false><<<grid, kLanes, 0, st>>>(p, v, n, n_pad, k, r2, i, d,
                                                 nullptr);
  return (int)cudaGetLastError();
}
