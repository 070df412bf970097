// Batched weighted Kabsch solve for Hopper (sm_90a): K5.
//
// Replaces no TPU kernel. The JAX package solves with jnp.linalg.svd,
// which XLA keeps on the device. The port's plain solve
// (ops/kabsch._solve_rt_plain) calls torch.linalg.svd and
// torch.linalg.det: about 25-30 kernels a solve, cuSOLVER's included,
// and host syncs that drain the queue and bar a CUDA graph around
// registration. K5 computes the same function in one launch that never
// syncs and allocates nothing.
//
// Semantics, for each of b problems of k pairs (src, dst, w >= 0):
//   wsum = max(sum w, 1e-12); cs = sum w src / wsum; cd = sum w dst / wsum;
//   S = sum w (src - cs)(dst - cd)^T = U diag(s) V^T;
//   R = V diag(1, 1, det(V U^T)) U^T; t = cd - R cs.
// The sums and the decomposition run in float64; R and t are rounded to
// float32 once. A problem with no weight gets R = I, t = 0.
//
// Bound: bytes (28 a pair, read twice, the second time from L2) for the
// refine solves' long sets; for the RANSAC hypotheses (k = 3) the serial
// 3x3 decomposition of each problem.
// Design:
//   * A group of G threads takes a problem: one warp (four problems a
//     block) for short sets or many problems, a 256-thread block for a few
//     long sets. Each thread sums its strided share in float64, in two
//     passes as the plain version (the weighted centroids, then the
//     centred covariance); shuffles reduce a warp, shared memory the
//     block's warps.
//   * One thread then decomposes S in registers by one-sided (Hestenes)
//     Jacobi: rotations of S's columns, accumulated in V, until the
//     columns are orthogonal; their norms are the singular values (sorted
//     descending) and the first two give U1, U2. Working on S itself, not
//     on S^T S, keeps the small singular directions of a near-collinear
//     set. U3 = U1 x U2, which stays right where S has rank 2 (every
//     3-point hypothesis: its third singular value is 0), since the
//     reflection correction cancels U3's sign.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;   // problems a block in the warp layout
constexpr int kBlockThreads = 256;  // threads a problem in the block layout
constexpr int kJacobiSweeps = 16;   // a 3x3 converges in about 6
// columns count as orthogonal below this cosine
constexpr double kOrthogonal = 1e-15;

template <int G, int NV>
__device__ __forceinline__ void group_sum(double (&v)[NV], double* red) {
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[i] += __shfl_xor_sync(kFull, v[i], o);
  if (G == 32) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < NV; ++i) red[warp * NV + i] = v[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < G / 32; ++w) s += red[w * NV + i];
    v[i] = s;
  }
  __syncthreads();  // red is written again by the next sum
}

// One-sided Jacobi rotation of columns (p, q) of M, V <- V J: after it
// the two columns are orthogonal. -> whether a rotation was needed.
__device__ __forceinline__ bool jacobi_rotate(double (&M)[3][3],
                                              double (&V)[3][3], int p,
                                              int q) {
  double a = 0.0, b = 0.0, g = 0.0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    a += M[i][p] * M[i][p];
    b += M[i][q] * M[i][q];
    g += M[i][p] * M[i][q];
  }
  if (!(fabs(g) > kOrthogonal * sqrt(a * b))) return false;
  const double zeta = (b - a) / (2.0 * g);
  const double tt = (zeta >= 0.0 ? 1.0 : -1.0) /
                    (fabs(zeta) + sqrt(1.0 + zeta * zeta));
  const double c = 1.0 / sqrt(1.0 + tt * tt), s = c * tt;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const double mp = M[i][p], mq = M[i][q];
    M[i][p] = c * mp - s * mq;
    M[i][q] = s * mp + c * mq;
    const double vp = V[i][p], vq = V[i][q];
    V[i][p] = c * vp - s * vq;
    V[i][q] = s * vp + c * vq;
  }
  return true;
}

__device__ __forceinline__ double det3(const double (&M)[3][3]) {
  return M[0][0] * (M[1][1] * M[2][2] - M[1][2] * M[2][1]) -
         M[0][1] * (M[1][0] * M[2][2] - M[1][2] * M[2][0]) +
         M[0][2] * (M[1][0] * M[2][1] - M[1][1] * M[2][0]);
}

// R, t from the covariance S (row p, column q: sum w a_p b_q) and the
// centroids.
__device__ void solve3(const double (&S)[3][3], const double (&cs)[3],
                       const double (&cd)[3], float* R_out, float* t_out) {
  // M = S V with orthogonal columns: M = U diag(s), so S = U diag(s) V^T
  double M[3][3], V[3][3];
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      M[p][q] = S[p][q];
      V[p][q] = p == q ? 1.0 : 0.0;
    }
  for (int sweep = 0; sweep < kJacobiSweeps; ++sweep) {
    bool rotated = jacobi_rotate(M, V, 0, 1);
    rotated |= jacobi_rotate(M, V, 0, 2);
    rotated |= jacobi_rotate(M, V, 1, 2);
    if (!rotated) break;
  }
  // the singular values (column norms) in descending order
  double n[3];
  int order[3] = {0, 1, 2};
#pragma unroll
  for (int c = 0; c < 3; ++c)
    n[c] = sqrt(M[0][c] * M[0][c] + M[1][c] * M[1][c] + M[2][c] * M[2][c]);
#pragma unroll
  for (int pass = 0; pass < 2; ++pass)
#pragma unroll
    for (int i = 0; i < 2 - pass; ++i)
      if (n[order[i]] < n[order[i + 1]]) {
        const int tmp = order[i];
        order[i] = order[i + 1];
        order[i + 1] = tmp;
      }
  // U's first two columns from M's; the third is their cross product, so
  // det(U) = 1 and det(V U^T) = det(V). Where s3 > 0 that U3 may be -M3 /
  // s3: R below is the same either way, since the flip of U3 flips the
  // correction too. A rank below 2 (no weight, a pair) leaves U2 free:
  // any unit vector normal to U1 (U = I where S = 0).
  double Vs[3][3], u1[3], u2[3], u3[3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) Vs[r][c] = V[r][order[c]];
  const int c1 = order[0], c2 = order[1];
#pragma unroll
  for (int r = 0; r < 3; ++r) u1[r] = n[c1] > 0.0 ? M[r][c1] / n[c1]
                                                  : (r == 0 ? 1.0 : 0.0);
  int e = 0;  // the axis least along u1, for a free U2
  if (fabs(u1[1]) < fabs(u1[e])) e = 1;
  if (fabs(u1[2]) < fabs(u1[e])) e = 2;
#pragma unroll
  for (int r = 0; r < 3; ++r)
    u2[r] = n[c2] > 0.0 ? M[r][c2] / n[c2] : (r == e ? 1.0 : 0.0);
  // re-orthogonalise against u1 (Gram-Schmidt) and normalise
  const double proj = u1[0] * u2[0] + u1[1] * u2[1] + u1[2] * u2[2];
#pragma unroll
  for (int r = 0; r < 3; ++r) u2[r] -= proj * u1[r];
  const double n2 = sqrt(u2[0] * u2[0] + u2[1] * u2[1] + u2[2] * u2[2]);
#pragma unroll
  for (int r = 0; r < 3; ++r) u2[r] /= n2;
  u3[0] = u1[1] * u2[2] - u1[2] * u2[1];
  u3[1] = u1[2] * u2[0] - u1[0] * u2[2];
  u3[2] = u1[0] * u2[1] - u1[1] * u2[0];
  const double d = det3(Vs);  // det(V U^T)
  double R[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      R[i][j] = Vs[i][0] * u1[j] + Vs[i][1] * u2[j] + d * Vs[i][2] * u3[j];
      R_out[3 * i + j] = (float)R[i][j];
    }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    t_out[i] = (float)(cd[i] - (R[i][0] * cs[0] + R[i][1] * cs[1] +
                                R[i][2] * cs[2]));
}

template <int G>
__global__ void kabsch_kernel(const float* __restrict__ src,
                              const float* __restrict__ dst,
                              const float* __restrict__ w, int b, int k,
                              float* __restrict__ R, float* __restrict__ t) {
  __shared__ double red[G == 32 ? 1 : (G / 32) * 9];
  const int problem = G == 32
                          ? blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)
                          : blockIdx.x;
  const int r = G == 32 ? (threadIdx.x & 31) : threadIdx.x;
  if (problem >= b) return;  // a whole warp (G = 32: no block barrier)
  const float* s = src + (size_t)problem * k * 3;
  const float* d = dst + (size_t)problem * k * 3;
  const float* wp = w + (size_t)problem * k;

  double m[7] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int i = r; i < k; i += G) {
    const double wi = wp[i];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      m[1 + c] += wi * (double)s[3 * i + c];
      m[4 + c] += wi * (double)d[3 * i + c];
    }
    m[0] += wi;
  }
  group_sum<G, 7>(m, red);
  const double wsum = m[0] > 1e-12 ? m[0] : 1e-12;
  double cs[3], cd[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    cs[c] = m[1 + c] / wsum;
    cd[c] = m[4 + c] / wsum;
  }

  double cov[9] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int i = r; i < k; i += G) {
    const double wi = wp[i];
    double a[3], e[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a[c] = ((double)s[3 * i + c] - cs[c]) * wi;
      e[c] = (double)d[3 * i + c] - cd[c];
    }
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int q = 0; q < 3; ++q) cov[3 * p + q] += a[p] * e[q];
  }
  group_sum<G, 9>(cov, red);
  if (r != 0) return;
  double S[3][3];
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int q = 0; q < 3; ++q) S[p][q] = cov[3 * p + q];
  solve3(S, cs, cd, R + (size_t)problem * 9, t + (size_t)problem * 3);
}

}  // namespace

// src, dst (b, k, 3) f32, w (b, k) f32, R (b, 3, 3) f32 and t (b, 3) f32
// out; all contiguous on the device, 1 <= b, 1 <= k. Launches on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int dpm_kabsch(const void* src, const void* dst, const void* w,
                          int b, int k, void* R, void* t, void* stream) {
  if (b < 1 || k < 1 || (long long)b * k * 3 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto s = static_cast<const float*>(src);
  auto d = static_cast<const float*>(dst);
  auto wp = static_cast<const float*>(w);
  auto Ro = static_cast<float*>(R);
  auto to = static_cast<float*>(t);
  // a block a problem where the problems are few and long (the refine
  // and trimmed solves), else a warp a problem (the RANSAC hypotheses)
  if (k > 4 * 32 && b <= 264)
    kabsch_kernel<kBlockThreads><<<b, kBlockThreads, 0, st>>>(s, d, wp, b, k,
                                                             Ro, to);
  else
    kabsch_kernel<32><<<(b + kWarpsPerBlock - 1) / kWarpsPerBlock,
                        32 * kWarpsPerBlock, 0, st>>>(s, d, wp, b, k, Ro, to);
  return (int)cudaGetLastError();
}
