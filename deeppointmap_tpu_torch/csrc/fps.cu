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
// bytes nor flops bound it; the k-1 sequential steps do, each ending in an
// argmax over the whole scan. A step costs a fixed part (the reductions and
// the exchange between warps) plus a part for each point a thread owns.
// Design:
//   * The scan is partitioned over the threads of one warp, one block or a
//     thread-block cluster of kCluster blocks on neighbouring SMs (one
//     source, the layout chosen by n in dpm_fps). Thread g of G owns the
//     points g, g + G, ..., 8 of them at most, and keeps their coordinates
//     and min-distances in registers.
//   * The argmax is a maximum over the total order (value, then lowest
//     index), so any partition gives the plain version's winner. A
//     candidate's min-distance is >= 0, so its float bits order as unsigned
//     integers: key = bits + 1, and 0 for picked and invalid points. A warp
//     reduces with two redux instructions (max of the keys, min of the
//     indices that hold it).
//   * ONE exchange a step and no barrier: every warp packs its winner into
//     one 64-bit message (key | step tag | index) and stores it into its
//     slot in the shared memory of every block of the cluster (distributed
//     shared memory; an 8-byte store lands whole). Every warp then polls
//     its own block's slots until all carry this step's tag and reduces
//     them itself. Slots alternate by the step's parity: a warp can only
//     be one step ahead of the slowest, so a message is read before its
//     slot is written again. A full cluster barrier in place of the tagged
//     messages cost about twice as much a step.
//   * Every block holds the whole scan's coordinates in shared memory
//     (192 KB at 16384 points), so the winner's coordinates are a local
//     lookup and the message stays one word.
//   * The first pick (the first valid point) is the same reduction over
//     the initial field, where all valid points tie.
// A cluster launch that the card refuses is returned as its error.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;   // blocks per scan in the cluster layout
constexpr int kIdxBits = 14;  // a message holds an index below 16384
constexpr int kMaxPoints = 1 << kIdxBits;
constexpr int kTagBits = 18;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = kMaxPoints - 1;  // loses every tie it could matter in

__device__ __forceinline__ uint64_t pack_msg(unsigned key, int tag, int idx) {
  return ((uint64_t)key << 32) | ((uint64_t)tag << kIdxBits) | (unsigned)idx;
}

__device__ __forceinline__ int msg_tag(uint64_t m) {
  return (int)((m >> kIdxBits) & ((1u << kTagBits) - 1u));
}

// Warp argmax by (key, then lowest index); every lane gets the winner.
__device__ __forceinline__ void argmax_warp(unsigned& bk, int& bi) {
  const unsigned mk = __reduce_max_sync(kFull, bk);
  bi = (int)__reduce_min_sync(kFull, bk == mk ? (unsigned)bi
                                              : (unsigned)kNone);
  bk = mk;
}

template <int THREADS, int PER, int CLUSTER>
__global__ void __launch_bounds__(THREADS, 1)
fps_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ valid,
           int n, int k, int64_t* __restrict__ out) {
  constexpr int kWarps = THREADS / 32;
  constexpr int kSlots = kWarps * CLUSTER;
  constexpr int kStride = THREADS * CLUSTER;
  constexpr int kPolls = (kSlots + 31) / 32;  // slots a lane polls
  extern __shared__ float planes[];  // [3][n]: the whole scan
  float* sx = planes;
  float* sy = planes + n;
  float* sz = planes + 2 * n;
  __shared__ unsigned long long s_msg[2][kSlots];

  const int b = blockIdx.y;
  const int rank = CLUSTER > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = rank * THREADS + tid;
  const float* X = xyz + (size_t)b * n * 3;
  const uint8_t* V = valid + (size_t)b * n;
  int64_t* O = out + (size_t)b * k;

  for (int j = tid; j < n; j += THREADS) {
    sx[j] = X[3 * j];
    sy[j] = X[3 * j + 1];
    sz[j] = X[3 * j + 2];
  }
  if (tid < 2 * kSlots) (&s_msg[0][0])[tid] = 0ull;  // tag 0: no step
  // nobody may send before every block has cleared its slots
  if (CLUSTER > 1) cg::this_cluster().sync();
  else __syncthreads();

  float px[PER], py[PER], pz[PER], md[PER];
  unsigned bk = 0;
  int bi = kNone;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = g + i * kStride;
    px[i] = py[i] = pz[i] = 0.f;
    md[i] = -1.0f;
    if (j < n) {
      px[i] = sx[j];
      py[i] = sy[j];
      pz[i] = sz[j];
      md[i] = V[j] ? 3.4e38f : -1.0f;
      // all valid points tie: the lowest index wins the first pick
      const unsigned key = md[i] < 0.f ? 0u : __float_as_uint(md[i]) + 1u;
      if (i == 0 || key > bk) {
        bk = key;
        bi = j;
      }
    }
  }

  for (int step = 0; step < k; ++step) {
    argmax_warp(bk, bi);  // the warp's winner
    if (kSlots > 1) {
      const int tag = step + 1;
      const uint64_t msg = pack_msg(bk, tag, bi);
      unsigned long long* slot = &s_msg[step & 1][rank * kWarps + warp];
      if (CLUSTER > 1) {
        if (lane < CLUSTER)
          *(volatile unsigned long long*)cg::this_cluster().map_shared_rank(
              slot, lane) = msg;
      } else if (lane == 0) {
        *(volatile unsigned long long*)slot = msg;
      }
      const volatile unsigned long long* slots = s_msg[step & 1];
      const uint64_t none = pack_msg(0u, tag, kNone);
      uint64_t m[kPolls];
      bool here;
      do {
        here = true;
#pragma unroll
        for (int p = 0; p < kPolls; ++p) {
          m[p] = lane + 32 * p < kSlots ? slots[lane + 32 * p] : none;
          here &= msg_tag(m[p]) == tag;
        }
      } while (!__all_sync(kFull, here));
      bk = (unsigned)(m[0] >> 32);
      bi = (int)(m[0] & (kMaxPoints - 1));
#pragma unroll
      for (int p = 1; p < kPolls; ++p) {
        const unsigned key = (unsigned)(m[p] >> 32);
        const int idx = (int)(m[p] & (kMaxPoints - 1));
        if (key > bk || (key == bk && idx < bi)) {
          bk = key;
          bi = idx;
        }
      }
      argmax_warp(bk, bi);  // the scan's winner, in every warp
    }
    const int last = bi;
    if (g == 0) O[step] = last;
    if (step + 1 == k) break;

    const float lx = sx[last], ly = sy[last], lz = sz[last];
    bk = 0;
    bi = kNone;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int j = g + i * kStride;
      if (j < n) {
        const float dx = __fsub_rn(px[i], lx);
        const float dy = __fsub_rn(py[i], ly);
        const float dz = __fsub_rn(pz[i], lz);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                            __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        float m = fminf(md[i], d);
        if (j == last) m = -1.0f;
        md[i] = m;
        const unsigned key = m < 0.f ? 0u : __float_as_uint(m) + 1u;
        if (i == 0 || key > bk) {  // j ascends within a thread
          bk = key;
          bi = j;
        }
      }
    }
  }
  // no block leaves while another may still store into its slots
  if (CLUSTER > 1) cg::this_cluster().sync();
}

template <int THREADS, int PER, int CLUSTER>
cudaError_t launch(const float* xyz, const uint8_t* valid, int b, int n,
                   int k, int64_t* out, cudaStream_t stream) {
  auto kernel = fps_kernel<THREADS, PER, CLUSTER>;
  const size_t smem = (size_t)3 * n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (CLUSTER > 8) {  // beyond the portable cluster size
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER, b);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, xyz, valid, n, k, out);
}

}  // namespace

// xyz (b, n, 3) f32, valid (b, n) bool as bytes, out (b, k) int64; all
// contiguous on the device. 1 <= k, 1 <= n <= 16384, b <= 65535. Launches
// on `stream` and returns the launch's error (0 on success).
extern "C" int dpm_fps(const void* xyz, const void* valid, int b, int n,
                       int k, void* out, void* stream) {
  if (b < 1 || b > 65535 || n < 1 || k < 1 || n > kMaxPoints)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const float*>(xyz);
  auto v = static_cast<const uint8_t*>(valid);
  auto o = static_cast<int64_t*>(out);
  // the fewest threads that hold the scan at 8 points each: the fixed cost
  // of a step grows with the warps that have to agree
  if (n <= 256) return (int)launch<32, 8, 1>(x, v, b, n, k, o, s);
  if (n <= 1024) return (int)launch<256, 4, 1>(x, v, b, n, k, o, s);
  if (n <= 4096) return (int)launch<256, 4, 4>(x, v, b, n, k, o, s);
  return (int)launch<256, 8, kCluster>(x, v, b, n, k, o, s);
}
