// Batched farthest-point sampling for Hopper (sm_90a).
//
// Replaces the TPU kernel deeppointmap_tpu/ops/pallas_fps.py
// (fps_pallas_batched, kernel _fps_kernel). Semantics are those of
// ops/sampling.farthest_point_sampling_plain, bit for bit:
//   * start at the first valid point (index 0 when none is valid);
//   * min-distance field starts at 3.4e38 for valid points and -1 for
//     invalid ones; the point just picked is set to -1;
//   * every step takes the argmax, ties going to the lowest index;
//   * squared distance is ((dx*dx + dy*dy) + dz*dz), each operation
//     rounded on its own (no FMA contraction), the plain version's order.
//
// Bound: the work is tiny (about 9 flops per point per step), so neither
// bytes nor flops bound it; the k-1 sequential steps, each ending in a
// block-wide argmax, do. Design: one block of 1024 threads per scan, so
// every step is one pass over the cloud by the whole block and a single
// __syncthreads (warp argmaxes go to a double-buffered slot, and every
// warp reduces the 32 of them itself). Coordinates sit in dynamic shared memory as x|y|z
// planes (16384 points = 192 KB: the whole cloud cannot also keep its
// min-distance field in shared memory, nor can 1024 threads hold four
// floats per point in the 64K-register file), and each thread keeps the
// min-distance of its own points in registers (point j belongs to
// thread j % 1024, so the plane reads of a warp are conflict-free).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// Butterfly argmax over a warp by (value, then lowest index), a total
// order, so every lane ends with the same winner.
__device__ __forceinline__ void argmax_warp(float& bv, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (ov > bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }
}

template <int PER>
__global__ void __launch_bounds__(kThreads, 1)
fps_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ valid,
           int n, int k, int64_t* __restrict__ out) {
  extern __shared__ float planes[];  // [3][n]
  float* sx = planes;
  float* sy = planes + n;
  float* sz = planes + 2 * n;
  __shared__ int s_first;
  __shared__ float s_val[2][kWarps];
  __shared__ int s_idx[2][kWarps];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* X = xyz + (size_t)b * n * 3;
  const uint8_t* V = valid + (size_t)b * n;
  int64_t* O = out + (size_t)b * k;

  if (tid == 0) s_first = n;
  __syncthreads();

  float md[PER];
  int my_first = n;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = tid + i * kThreads;
    md[i] = -INFINITY;  // beyond n: never picked
    if (j < n) {
      sx[j] = X[3 * j];
      sy[j] = X[3 * j + 1];
      sz[j] = X[3 * j + 2];
      const bool v = V[j] != 0;
      md[i] = v ? 3.4e38f : -1.0f;
      if (v && j < my_first) my_first = j;
    }
  }
  atomicMin(&s_first, my_first);
  __syncthreads();
  const int first = (s_first == n) ? 0 : s_first;
#pragma unroll
  for (int i = 0; i < PER; ++i)
    if (tid + i * kThreads == first) md[i] = -1.0f;
  if (tid == 0) O[0] = first;

  int last = first;
  for (int step = 1; step < k; ++step) {
    const float lx = sx[last], ly = sy[last], lz = sz[last];
    float bv = -INFINITY;
    int bi = 0x7fffffff;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int j = tid + i * kThreads;
      if (j < n) {
        const float dx = __fsub_rn(sx[j], lx);
        const float dy = __fsub_rn(sy[j], ly);
        const float dz = __fsub_rn(sz[j], lz);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                            __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        float m = fminf(md[i], d);
        if (j == last) m = -1.0f;
        md[i] = m;
        if (m > bv) {  // j ascends within a thread: first occurrence wins
          bv = m;
          bi = j;
        }
      }
    }
    argmax_warp(bv, bi);
    // one barrier a step: warps publish into the buffer of this step's
    // parity, and every warp reduces the 32 candidates itself
    const int buf = step & 1;
    if (lane == 0) {
      s_val[buf][warp] = bv;
      s_idx[buf][warp] = bi;
    }
    __syncthreads();
    bv = s_val[buf][lane];
    bi = s_idx[buf][lane];
    argmax_warp(bv, bi);
    last = bi;
    if (tid == 0) O[step] = bi;
  }
}

template <int PER>
cudaError_t launch(const float* xyz, const uint8_t* valid, int b, int n,
                   int k, int64_t* out, cudaStream_t stream) {
  const size_t smem = (size_t)3 * n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel<PER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  fps_kernel<PER><<<b, kThreads, smem, stream>>>(xyz, valid, n, k, out);
  return cudaGetLastError();
}

}  // namespace

// xyz (b, n, 3) f32, valid (b, n) bool as bytes, out (b, k) int64; all
// contiguous on the device. 1 <= k, 1 <= n <= 16384. Launches on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int dpm_fps(const void* xyz, const void* valid, int b, int n,
                       int k, void* out, void* stream) {
  if (b < 1 || n < 1 || k < 1 || n > 16 * kThreads)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const float*>(xyz);
  auto v = static_cast<const uint8_t*>(valid);
  auto o = static_cast<int64_t*>(out);
  if (n <= kThreads) return (int)launch<1>(x, v, b, n, k, o, s);
  if (n <= 4 * kThreads) return (int)launch<4>(x, v, b, n, k, o, s);
  return (int)launch<16>(x, v, b, n, k, o, s);
}
