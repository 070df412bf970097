// The fused preprocessing sweep for Hopper (sm_90a): one distance pass that
// gives every point of a scan its k nearest candidates and, optionally, its
// radius-PCA moments.
//
// Replaces the TPU kernel deeppointmap_tpu/ops/pallas_sweep.py
// (fused_sweep_pallas, kernel _sweep_kernel) and keeps its rule, not its
// tiling: a center's candidates are the two smallest (distance, index) keys
// of each index-mod-128 class of the scan padded to n_pad = max(256, n
// rounded up to 128), invalid points and the padding standing at 1e9, and
// its neighbours are the k smallest of those 256 keys, ascending; an index
// from the padding is clamped to n - 1. The result is approximate where
// three of a center's k nearest share a class (recall >= 0.97 at k = 17
// and 41). Distances are the single-rounded float32 values of radius.cuh,
// so the kernel and ops/sweep.fused_sweep_plain give the same bits (for
// finite distances). With r2 > 0 the same pass accumulates the moments of
// moments.cu. The TPU version leaves the top-k over the 256 candidates to
// XLA; here it is fused.
//
// Bound: operations (8 FLOPs for each (center, valid point) pair against
// 196 KB in and 12 k + 40 bytes a point out). Per pair the kernel issues the
// distance (7 floating-point operations) and the best-two update (two
// compares and four predicated selects on the half-rate compare pipe), so
// the update, not the distance, sets the pace: about 14.5 instructions a
// pair in all (NVIDIA H100, PERF.md).
// Design (the first version gave a block of 128 lanes four centers, so
// every point was read from L2 once per four centers, padding and invalid
// points included, and sorted 4 x 256 keys with 36 block barriers):
//   * pack_classes (radius.cuh) compacts each class's valid points once, in
//     ascending index order, with the class's two lowest invalid indices
//     beside them. Invalid points are never visited: a class's candidates
//     are the best two of (its valid best two) and (its two lowest invalid
//     indices at 1e9), merged by key at the end of the class. That is
//     exactly the plain version's rule, including classes with fewer than
//     two valid points and the ties of a valid distance of 1e9.
//   * A block of 16 warps owns 64 centers, two a lane in registers; warp w
//     walks classes 8w .. 8w + 7 against all 64, staged through its own
//     double buffer in shared memory with cp.async (walk_classes). One
//     broadcast 16-byte read serves 64 centers, and the warps of a block
//     split the scan by class, so their best-two slots never need merging.
//     Inside a class the points come in ascending index order, so a strict
//     "less than" keeps the lower index on a tie at no cost; the loop
//     records a point's slot (a warp-uniform counter) and looks its index
//     up once, at the class end.
//   * Candidates go to shared memory as 64-bit keys, [256][64 + 1] (the
//     padding keeps the distance phase's stores and the selection's loads
//     free of bank conflicts). Selection: a group of 8 lanes a center, four
//     centers a warp at once. Each lane sorts its 16 classes' 32 keys in
//     registers by a fixed network (four runs of eight from sorted pairs,
//     then bitonic merges to 16 and 32) and writes the run back; then k
//     rounds: the group's smallest head (a butterfly of three shuffles over
//     its 8 lanes) is the next neighbour, and its lane advances. Keys are
//     unique (the index), so the result does not depend on any order. A
//     32-lane tournament over runs of eight (warp reductions) measured the
//     same in all, at twice the cost a round.
//   * With moments, the radius test is a subtraction and an OR of sign bits
//     (radius.cuh hit_bits), off the compare pipe that the update fills;
//     the float64 path runs only for points some lane has inside its radius,
//     and the warps' partial sums are added in warp order (radius.cuh).

#include "radius.cuh"

namespace {

using namespace dpm;

constexpr int kCand = 2 * kClasses;        // candidates a center
constexpr int kStride = kBlockCenters + 1;  // row of the candidate table
constexpr int kLaneKeys = kCand / 8;        // keys a lane of a group (32)
constexpr int kSelect = kBlockCenters / kWarps;  // centers a warp selects
constexpr uint64_t kMax = ~0ull;
static_assert(kSelect == 4 && kLaneKeys == 32, "the selection's layout");

__device__ __forceinline__ void cas(uint64_t& a, uint64_t& b) {
  const uint64_t lo = a < b ? a : b;
  b = a < b ? b : a;
  a = lo;
}

// Sort eight keys given as four sorted pairs (v0 <= v1, v2 <= v3, ...):
// Batcher's odd-even merge sort of eight without its first layer.
template <int O, int N>
__device__ __forceinline__ void sort_pairs8(uint64_t (&v)[N]) {
  cas(v[O + 0], v[O + 2]); cas(v[O + 1], v[O + 3]);
  cas(v[O + 4], v[O + 6]); cas(v[O + 5], v[O + 7]);
  cas(v[O + 1], v[O + 2]); cas(v[O + 5], v[O + 6]);
  cas(v[O + 0], v[O + 4]); cas(v[O + 1], v[O + 5]);
  cas(v[O + 2], v[O + 6]); cas(v[O + 3], v[O + 7]);
  cas(v[O + 2], v[O + 4]); cas(v[O + 3], v[O + 5]);
  cas(v[O + 1], v[O + 2]); cas(v[O + 3], v[O + 4]);
  cas(v[O + 5], v[O + 6]);
}

// Merge the sorted halves of v[O, O + L): compare each key of the first
// half with its mirror in the second (which makes both halves bitonic, the
// smaller keys in front), then half-cleaners down to stride 1.
template <int O, int L, int N>
__device__ __forceinline__ void merge_halves(uint64_t (&v)[N]) {
#pragma unroll
  for (int i = 0; i < L / 2; ++i) cas(v[O + i], v[O + L - 1 - i]);
#pragma unroll
  for (int st = L / 4; st > 0; st >>= 1)
#pragma unroll
    for (int i = 0; i < L; ++i)
      if ((i & st) == 0) cas(v[O + i], v[O + i + st]);
}

// Shared memory: the candidate table, then the warps' staging buffers,
// which become the moment reduction's after a barrier.
constexpr int kCandBytes = kCand * kStride * (int)sizeof(uint64_t);
constexpr int kRedBytes = kWarps * kBlockCenters * kFeat * (int)sizeof(double);
constexpr int kSmem =
    kCandBytes + (kStageBytes > kRedBytes ? kStageBytes : kRedBytes);

template <bool MOMENTS>
__global__ void __launch_bounds__(kThreads, 1)
sweep_kernel(const float* __restrict__ points, ClassScan s, int n, int k,
             float r2, int64_t* __restrict__ idx_out,
             float* __restrict__ d2_out, float* __restrict__ mom_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* cand = reinterpret_cast<uint64_t*>(smem);
  unsigned char* tail = smem + kCandBytes;
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

  // ---- distances: the best two of each class of the warp, as (distance,
  // slot); a slot's index is looked up at the class end
  float b1d[kPerLane], b2d[kPerLane];
  int b1t[kPerLane], b2t[kPerLane];
  walk_classes(
      s, b, reinterpret_cast<float4*>(tail) + warp * 2 * kChunk,
      [&](int) {
#pragma unroll
        for (int g = 0; g < kPerLane; ++g) {
          b1d[g] = b2d[g] = INFINITY;
          b1t[g] = b2t[g] = -1;
        }
      },
      [&](const float4(&q)[4], int t) {
        float d[4][kPerLane];
        int hit[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int g = 0; g < kPerLane; ++g) {
            const float e = dist2(c.c2[g], c.x[g], c.y[g], c.z[g], q[u].w,
                                  q[u].x, q[u].y, q[u].z);
            d[u][g] = e;
            // as selects the compiler predicates: two compares and four
            // selects a pair (min/max for the distances issue two more)
            const bool lt1 = e < b1d[g];
            const bool lt2 = e < b2d[g];
            b2d[g] = lt1 ? b1d[g] : (lt2 ? e : b2d[g]);
            b2t[g] = lt1 ? b1t[g] : (lt2 ? t + u : b2t[g]);
            b1d[g] = lt1 ? e : b1d[g];
            b1t[g] = lt1 ? t + u : b1t[g];
          }
          if (MOMENTS) hit[u] = hit_bits(d[u], r2n);
        }
        if (MOMENTS) add_batch(q, d, hit, r2, m);
      },
      [&](int j) {
        // the class's candidates: the two smallest of its valid best two
        // and its two lowest invalid members at 1e9 (both pairs sorted)
        const size_t cls = (size_t)b * kClasses + j;
        const int* slot_idx = s.idx + cls * s.m4;
        const int inv0 = s.inv[2 * cls], inv1 = s.inv[2 * cls + 1];
        const uint64_t ki0 = inv0 >= 0 ? make_key(1e9f, inv0) : kMax;
        const uint64_t ki1 = inv1 >= 0 ? make_key(1e9f, inv1) : kMax;
#pragma unroll
        for (int g = 0; g < kPerLane; ++g) {
          const uint64_t kv0 =
              b1t[g] >= 0 ? make_key(b1d[g], slot_idx[b1t[g]]) : kMax;
          const uint64_t kv1 =
              b2t[g] >= 0 ? make_key(b2d[g], slot_idx[b2t[g]]) : kMax;
          const uint64_t first = kv0 < ki0 ? kv0 : ki0;
          const uint64_t second = kv0 < ki0 ? (kv1 < ki0 ? kv1 : ki0)
                                            : (kv0 < ki1 ? kv0 : ki1);
          cand[(2 * j) * kStride + g * 32 + lane] = first;
          cand[(2 * j + 1) * kStride + g * 32 + lane] = second;
        }
      });
  __syncthreads();  // the candidates are complete; staging is over
  const int rows = min(kBlockCenters, n - c0);
  if (MOMENTS)
    reduce_moments(m, reinterpret_cast<double*>(tail),
                   mom_out + ((size_t)b * n + c0) * kFeat, rows);

  // ---- selection: warp w takes local centers 4w .. 4w + 3, one a group
  // of 8 lanes. Lane `sub` of a group owns the classes sub + 8 i (i < 16)
  // and sorts their 32 keys in registers: four runs of eight from four
  // pairs each, then two bitonic merges to 16 and one to 32 (a fixed
  // network: no data-dependent step). The run goes back to shared memory,
  // key p of lane sub at row 8 p + sub.
  const int sub = lane & 7;
  const int col = warp * kSelect + (lane >> 3);
  {
    uint64_t v[kLaneKeys];
#pragma unroll
    for (int e = 0; e < kLaneKeys; ++e)
      v[e] = cand[(2 * (sub + 8 * (e >> 1)) + (e & 1)) * kStride + col];
    sort_pairs8<0>(v);
    sort_pairs8<8>(v);
    sort_pairs8<16>(v);
    sort_pairs8<24>(v);
    merge_halves<0, 16>(v);
    merge_halves<16, 16>(v);
    merge_halves<0, 32>(v);
    __syncwarp();
#pragma unroll
    for (int e = 0; e < kLaneKeys; ++e)
      cand[(8 * e + sub) * kStride + col] = v[e];
  }
  __syncwarp();
  // k rounds: the group's smallest head (a butterfly over its 8 lanes) is
  // the next neighbour, and the lane that held it advances. Lane i % 8
  // keeps round i's key; the group stores 8 rounds at a time.
  int taken = 0;
  uint64_t head = cand[sub * kStride + col];
  uint64_t out = kMax;
  for (int i = 0; i < k; ++i) {
    uint64_t best = head;
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      const uint64_t other = __shfl_xor_sync(kFull, best, off);
      best = other < best ? other : best;
    }
    if (head == best) {
      ++taken;
      head = taken < kLaneKeys ? cand[(8 * taken + sub) * kStride + col]
                               : kMax;
    }
    const int at = i & 7;
    out = sub == at ? best : out;
    if ((at == 7 || i == k - 1) && sub <= at && col < rows) {
      const size_t o = ((size_t)b * n + c0 + col) * k + (i - at) + sub;
      idx_out[o] = min((int)(uint32_t)out, n - 1);
      d2_out[o] = mono_float((uint32_t)(out >> 32));
    }
  }
}

template <bool MOMENTS>
cudaError_t launch(const float* p, const ClassScan& s, int b, int n, int k,
                   float r2, int64_t* idx, float* d2, float* mom,
                   cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel<MOMENTS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBlockCenters - 1) / kBlockCenters, b);
  sweep_kernel<MOMENTS><<<grid, kThreads, kSmem, st>>>(p, s, n, k, r2, idx,
                                                       d2, mom);
  return cudaGetLastError();
}

}  // namespace

// points (b, n, 3) f32, valid (b, n) bool as bytes; scratch of at least
// dpm::class_scratch_bytes(b, n) bytes; idx (b, n, k) int64 and d2
// (b, n, k) f32 out; mom (b, n, 10) f32 out, or null for no moments (r2 is
// then ignored). All contiguous on the device; 1 <= k <= 128. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int dpm_sweep(const void* points, const void* valid, int b, int n,
                         int k, float r2, void* scratch,
                         long long scratch_bytes, void* idx, void* d2,
                         void* mom, void* stream) {
  if (b < 1 || n < 1 || b > 65535 || k < 1 || k > kClasses ||
      scratch_bytes < class_scratch_bytes(b, n))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto p = static_cast<const float*>(points);
  const ClassScan s = class_scan(scratch, b, n);
  cudaError_t err =
      launch_pack(p, static_cast<const uint8_t*>(valid), b, n, s, st);
  if (err != cudaSuccess) return (int)err;
  auto i = static_cast<int64_t*>(idx);
  auto d = static_cast<float*>(d2);
  if (mom != nullptr)
    return (int)launch<true>(p, s, b, n, k, r2, i, d,
                             static_cast<float*>(mom), st);
  return (int)launch<false>(p, s, b, n, k, r2, i, d, nullptr, st);
}
