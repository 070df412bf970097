// Exact k-nearest neighbours with optional radius moments, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel deeppointmap_tpu/ops/pallas_knn.py
// (fused_knn_moments, kernel _knn_kernel). Unlike the TPU kernel, which
// keeps one winner per index-mod-512 class (recall >= 0.95), this one is
// exact and agrees with ops/neighbors.knn_plain:
//   * squared distance |c|^2 - 2 c.p + |p|^2, evaluated as
//     ((c2 - 2*cross) + p2) with cross = (cx*px + cy*py) + cz*pz and each
//     operation rounded on its own, the plain version's order, so the two
//     give the same bits;
//   * invalid points sit at 1e9;
//   * neighbours ascend by (distance, index); with fewer than k valid
//     points the tail carries 1e9 and the lowest invalid indices, always
//     inside [0, n);
//   * with r2 > 0, the moments [cnt | s(3) | S6(6)] over the points with
//     distance <= r2 are summed in f32 in index order; cnt is clamped to
//     >= 1 as in ops/normals.filter_sweep.
// No shape limits: the ragged last tile and block are masked here.
//
// Bound: about 8 operations per (center, point) pair against 12-16 bytes
// per point and center, so operations bound it (the preprocess sweep is
// 16384 x 16384 pairs); what limits it in practice is the latency of one
// thread's serial scan and the insertion passes of its sorted list. Design:
// SPLIT threads per center, each scanning every SPLIT-th point of a tile
// staged through shared memory (each point is read from device memory
// once per block) and keeping its own k best as a sorted list in
// registers (templated k); a candidate pays for the insertion pass only
// when it beats the list's k-th. The SPLIT lists are merged through shared
// memory at the end: the k smallest by (distance, index) do not depend on
// the order they were found in. SPLIT > 1 gives small center counts
// enough blocks to fill the card; with moments SPLIT is 1, so that each
// center's sums keep the index order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;
constexpr int kTile = 2048;

template <int K, int SPLIT, bool MOMENTS>
__global__ void __launch_bounds__(kBlock)
knn_kernel(const float* __restrict__ points, const uint8_t* __restrict__ valid,
           const float* __restrict__ centers, int n, int s, int k_out,
           float r2, int64_t* __restrict__ idx_out,
           float* __restrict__ d2_out, float* __restrict__ mom_out) {
  static_assert(!MOMENTS || SPLIT == 1, "moments keep the index order");
  static_assert(kBlock * K * 8 <= kTile * 16, "merge lists fit the tile");
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  const int part = threadIdx.x % SPLIT;
  const int c = blockIdx.x * (kBlock / SPLIT) + threadIdx.x / SPLIT;
  const bool active = c < s;
  const float* P = points + (size_t)b * n * 3;
  const uint8_t* V = valid + (size_t)b * n;

  float cx = 0.f, cy = 0.f, cz = 0.f;
  if (active) {
    const float* C = centers + ((size_t)b * s + c) * 3;
    cx = C[0];
    cy = C[1];
    cz = C[2];
  }
  const float c2 = __fadd_rn(__fadd_rn(__fmul_rn(cx, cx), __fmul_rn(cy, cy)),
                             __fmul_rn(cz, cz));

  float bd[K];
  int bi[K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    bd[t] = INFINITY;
    bi[t] = 0x7fffffff;
  }
  float m[10];
#pragma unroll
  for (int t = 0; t < 10; ++t) m[t] = 0.f;

  for (int base = 0; base < n; base += kTile) {
    const int cnt = min(kTile, n - base);
    for (int j = threadIdx.x; j < cnt; j += kBlock) {
      const int p = base + j;
      const float x = P[3 * p], y = P[3 * p + 1], z = P[3 * p + 2];
      const float p2 = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                                 __fmul_rn(z, z));
      tile[j] = make_float4(x, y, z, V[p] ? p2 : -1.f);  // -1: invalid
    }
    __syncthreads();
    if (active) {
      for (int j = part; j < cnt; j += SPLIT) {
        const float4 q = tile[j];
        float d = 1e9f;
        if (q.w >= 0.f) {
          const float cross = __fadd_rn(
              __fadd_rn(__fmul_rn(cx, q.x), __fmul_rn(cy, q.y)),
              __fmul_rn(cz, q.z));
          d = __fadd_rn(__fsub_rn(c2, __fmul_rn(2.f, cross)), q.w);
        }
        if (MOMENTS && d <= r2) {
          // one rounding per operation, in index order: the plain
          // version's sequential sum gives the same bits
          m[0] = __fadd_rn(m[0], 1.f);
          m[1] = __fadd_rn(m[1], q.x);
          m[2] = __fadd_rn(m[2], q.y);
          m[3] = __fadd_rn(m[3], q.z);
          m[4] = __fadd_rn(m[4], __fmul_rn(q.x, q.x));
          m[5] = __fadd_rn(m[5], __fmul_rn(q.x, q.y));
          m[6] = __fadd_rn(m[6], __fmul_rn(q.x, q.z));
          m[7] = __fadd_rn(m[7], __fmul_rn(q.y, q.y));
          m[8] = __fadd_rn(m[8], __fmul_rn(q.y, q.z));
          m[9] = __fadd_rn(m[9], __fmul_rn(q.z, q.z));
        }
        // A thread meets its points in ascending index order, so a tie
        // with the k-th best never displaces it.
        if (d < bd[K - 1]) {
          float cd = d;
          int ci = base + j;
#pragma unroll
          for (int t = 0; t < K; ++t) {
            const bool swap = cd < bd[t] || (cd == bd[t] && ci < bi[t]);
            const float td = bd[t];
            const int ti = bi[t];
            bd[t] = swap ? cd : td;
            bi[t] = swap ? ci : ti;
            cd = swap ? td : cd;
            ci = swap ? ti : ci;
          }
        }
      }
    }
    __syncthreads();
  }

  const size_t row = (size_t)b * s + c;
  if (SPLIT > 1) {
    // merge the SPLIT sorted lists of a center, reusing the tile memory
    float* ld = reinterpret_cast<float*>(tile);
    int* li = reinterpret_cast<int*>(ld + kBlock * K);
#pragma unroll
    for (int t = 0; t < K; ++t) {
      ld[threadIdx.x * K + t] = bd[t];
      li[threadIdx.x * K + t] = bi[t];
    }
    __syncthreads();
    if (!active || part != 0) return;
    int head[SPLIT];
#pragma unroll
    for (int q = 0; q < SPLIT; ++q) head[q] = 0;
    const int first = threadIdx.x * K;  // this center's lists follow it
    for (int t = 0; t < k_out; ++t) {
      int best = 0;
      float best_d = INFINITY;
      int best_i = 0x7fffffff;
#pragma unroll
      for (int q = 0; q < SPLIT; ++q) {
        if (head[q] < K) {
          const float dq = ld[first + q * K + head[q]];
          const int iq = li[first + q * K + head[q]];
          if (dq < best_d || (dq == best_d && iq < best_i)) {
            best = q;
            best_d = dq;
            best_i = iq;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < SPLIT; ++q) head[q] += (q == best);
      idx_out[row * k_out + t] = best_i;
      d2_out[row * k_out + t] = best_d;
    }
    return;
  }

  if (!active) return;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    if (t < k_out) {
      idx_out[row * k_out + t] = bi[t];
      d2_out[row * k_out + t] = bd[t];
    }
  }
  if (MOMENTS) {
    float* M = mom_out + row * 10;
    M[0] = fmaxf(m[0], 1.f);
#pragma unroll
    for (int t = 1; t < 10; ++t) M[t] = m[t];
  }
}

template <int K, int SPLIT>
cudaError_t launch_split(const float* points, const uint8_t* valid,
                         const float* centers, int b, int n, int s, int k,
                         float r2, int64_t* idx, float* d2,
                         cudaStream_t stream) {
  constexpr int per_block = kBlock / SPLIT;
  const dim3 grid((s + per_block - 1) / per_block, b);
  knn_kernel<K, SPLIT, false><<<grid, kBlock, 0, stream>>>(
      points, valid, centers, n, s, k, r2, idx, d2, nullptr);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch(const float* points, const uint8_t* valid,
                   const float* centers, int b, int n, int s, int k,
                   float r2, int64_t* idx, float* d2, float* mom,
                   cudaStream_t stream) {
  if (mom != nullptr) {
    const dim3 grid((s + kBlock - 1) / kBlock, b);
    knn_kernel<K, 1, true><<<grid, kBlock, 0, stream>>>(
        points, valid, centers, n, s, k, r2, idx, d2, mom);
    return cudaGetLastError();
  }
  // enough blocks for the card's 132 SMs: split small center counts
  const long rows = (long)b * s;
  if (rows <= 2048)
    return launch_split<K, 8>(points, valid, centers, b, n, s, k, r2, idx,
                              d2, stream);
  if (rows <= 4096)
    return launch_split<K, 4>(points, valid, centers, b, n, s, k, r2, idx,
                              d2, stream);
  if (rows <= 8192)
    return launch_split<K, 2>(points, valid, centers, b, n, s, k, r2, idx,
                              d2, stream);
  return launch_split<K, 1>(points, valid, centers, b, n, s, k, r2, idx, d2,
                            stream);
}

}  // namespace

// points (b, n, 3) f32, valid (b, n) bool as bytes, centers (b, s, 3) f32;
// idx (b, s, k) int64 and d2 (b, s, k) f32 out; mom (b, s, 10) f32 out, or
// null for no moments. All contiguous on the device; 1 <= k <= min(n, 64).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int dpm_knn(const void* points, const void* valid,
                       const void* centers, int b, int n, int s, int k,
                       float r2, void* idx, void* d2, void* mom,
                       void* stream) {
  if (b < 1 || n < 1 || s < 1 || k < 1 || k > n || k > 64)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto p = static_cast<const float*>(points);
  auto v = static_cast<const uint8_t*>(valid);
  auto c = static_cast<const float*>(centers);
  auto i = static_cast<int64_t*>(idx);
  auto d = static_cast<float*>(d2);
  auto mo = static_cast<float*>(mom);
  // The list length is a template constant so it stays in registers; the
  // main path's k are 1, 3, 16, 17 and 32. Any other k runs the next
  // larger list and writes its first k entries (the list is sorted).
  if (k == 1) return (int)launch<1>(p, v, c, b, n, s, k, r2, i, d, mo, st);
  if (k <= 3) return (int)launch<3>(p, v, c, b, n, s, k, r2, i, d, mo, st);
  if (k <= 16) return (int)launch<16>(p, v, c, b, n, s, k, r2, i, d, mo, st);
  if (k == 17) return (int)launch<17>(p, v, c, b, n, s, k, r2, i, d, mo, st);
  if (k <= 32) return (int)launch<32>(p, v, c, b, n, s, k, r2, i, d, mo, st);
  return (int)launch<64>(p, v, c, b, n, s, k, r2, i, d, mo, st);
}
