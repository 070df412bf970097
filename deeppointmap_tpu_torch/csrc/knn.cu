// Exact k-nearest neighbours with optional radius moments, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel deeppointmap_tpu/ops/pallas_knn.py
// (fused_knn_moments, kernel _knn_kernel). Unlike the TPU kernel, which
// keeps one winner per index-mod-512 class (recall >= 0.95), this one is
// exact and agrees with ops/neighbors.knn_plain:
//   * squared distance dpm::dist2 (radius.cuh), the single-rounded
//     |c|^2 - 2 c.p + |p|^2 that K3, K4 and the plain versions share;
//   * invalid points sit at 1e9;
//   * neighbours ascend by (distance, index); with fewer than k valid
//     points the tail carries 1e9 and the lowest invalid indices, always
//     inside [0, n);
//   * with r2 > 0, the moments [cnt | s(3) | S6(6)] over the valid points
//     with distance <= r2, summed as K3 sums them: exact float64 products,
//     a fixed order, one rounding to float32; cnt is clamped to >= 1.
// No shape limits below k = kMaxK: the ragged ends of the points and of
// the center groups are masked here.
//
// Bound: about 8 operations per (center, point) pair against 16 bytes per
// point, so operations bound it (the preprocess sweep is 16384 x 16384
// pairs). What costs in practice is the selection, so the design keeps it
// off the scan's path:
//   * A small kernel packs the points once as float4 (x, y, z, |p|^2, or
//     -1 for an invalid point). A warp reads that copy with one 16-byte
//     load a lane, straight from L1/L2 (a scan is 256 KB and every warp
//     of an SM walks it), the next 32 points loading while these are
//     measured. Staging tiles through shared memory (cp.async, double
//     buffered, two block barriers a tile) measured slower: a warp that
//     merges held its block up at every barrier. 64 KB-256 KB of points do
//     not need TMA.
//   * A warp owns kGroup centers. Each lane measures its point against the
//     warp's centers, whose coordinates and warp-uniform thresholds sit in
//     registers. A pair costs the distance and one compare; one vote a
//     32-point step says whether any lane has a candidate at all, and a
//     step of invalid points is skipped once every run is full. Steps are
//     visited in a scattered order, so that a scan's sweep order cannot
//     make every point a candidate.
//   * Every (distance, index) pair is one 64-bit key (order-preserving
//     distance bits, then the index): a total order, so the k smallest do
//     not depend on the order, or the split, they were found in. A center's
//     k best live as a sorted run of keys in shared memory; the k-th is the
//     threshold. A lane whose candidate beats it appends the key to the
//     center's queue (ballot + popc for the slot). When a queue holds a
//     warp's worth, the warp merges it into the run by ranks: a key's place
//     is the number of queue keys and of run keys below it (a count over
//     the queue, a binary search in the run), so one pass scatters both
//     into the run's second buffer. After the first steps about
//     k ln(n / k) candidates ever pass, so the scan is what remains. At
//     k = 1 the run is the threshold itself, kept in registers.
//   * Small center counts split the points among `parts` warps of a block
//     that share the centers (32-point steps dealt in turn); their runs are
//     merged by the same routine at the end, and their float64 moment sums
//     added in warp order.
//   * Outputs are written by whole warps, k consecutive values a center.

#include <cuda_runtime.h>
#include <stdint.h>

#include "radius.cuh"

namespace {

using dpm::kFeat;
using dpm::kFull;
using dpm::make_key;
using dpm::mono_bits;
using dpm::mono_float;

constexpr int kGroup = 4;    // centers per warp
static_assert(kGroup == 4, "the scan reads four thresholds by name");
constexpr int kQueue = 64;   // candidate slots per center
constexpr int kMaxK = 512;
constexpr int kMaxWarps = 8;
// an empty slot of a run: distance +inf, the largest index
constexpr uint64_t kEmpty = 0xff8000007fffffffull;

// Merge the m keys at `cand` (any order, m <= kQueue, distinct unless
// kEmpty) into the sorted run `src` of k keys; the k smallest go, sorted,
// to `dst`. The whole warp calls; `src`, `dst` and `cand` do not overlap.
__device__ __forceinline__ void merge_keys(const uint64_t* src, uint64_t* dst,
                                           const uint64_t* cand, int m, int k,
                                           int lane) {
  for (int i = lane; i < m; i += 32) {
    const uint64_t key = cand[i];
    if (key == kEmpty) continue;  // the run's own empty slots fill the tail
    int pos = 0;
    for (int j = 0; j < m; ++j) pos += cand[j] < key;
    int lo = 0, hi = k;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (src[mid] < key) lo = mid + 1;
      else hi = mid;
    }
    pos += lo;
    if (pos < k) dst[pos] = key;
  }
  for (int i = lane; i < k; i += 32) {
    const uint64_t key = src[i];
    int pos = i;
    for (int j = 0; j < m; ++j) pos += cand[j] < key;
    if (pos < k) dst[pos] = key;
  }
  __syncwarp();
}

// One center's selection state: the threshold (its run's k-th key, as a
// distance and an index), the keys waiting in its queue, and which of the
// run's two buffers is current. Warp-uniform, in registers; the kernel
// names its four centers' states one by one so that none of them is ever
// indexed by a loop variable (which would move them to local memory).
struct Select {
  float thr_d = INFINITY;
  int thr_i = 0x7fffffff;
  int queued = 0;
  int cur = 0;
};

// Merge a center's queue into its run. `base` is the center's shared
// memory: two run buffers of kpad keys, then the queue.
__device__ __forceinline__ void flush(Select& st, uint64_t* base, int kpad,
                                      int k, int lane) {
  merge_keys(base + st.cur * kpad, base + (st.cur ^ 1) * kpad,
             base + 2 * kpad, st.queued, k, lane);
  st.cur ^= 1;
  st.queued = 0;
  const uint64_t kth = base[st.cur * kpad + k - 1];
  st.thr_d = mono_float((uint32_t)(kth >> 32));
  st.thr_i = (int)(uint32_t)kth;
}

// Queue this step's candidates of one center (the lanes whose key beats the
// threshold) and merge when the queue holds a warp's worth. ONE: k = 1.
template <bool ONE>
__device__ __forceinline__ void offer(Select& st, bool have, float d, int idx,
                                      uint64_t* base, int kpad, int k,
                                      int lane) {
  const bool pass = have && (d < st.thr_d ||
                             (d == st.thr_d && idx < st.thr_i));
  const unsigned hits = __ballot_sync(kFull, pass);
  if (hits == 0u) return;
  if (ONE) {
    // the run is the threshold itself: the best of the passing lanes
    // replaces it, and nothing is queued or merged
    const uint32_t mine = pass ? mono_bits(d) : 0xffffffffu;
    const uint32_t best = __reduce_min_sync(kFull, mine);
    st.thr_i = (int)__reduce_min_sync(
        kFull, pass && mine == best ? (unsigned)idx : 0x7fffffffu);
    st.thr_d = mono_float(best);
    return;
  }
  if (pass)
    base[2 * kpad + st.queued + __popc(hits & ((1u << lane) - 1u))] =
        make_key(d, idx);
  st.queued += __popc(hits);
  __syncwarp();
  if (st.queued >= 32) flush(st, base, kpad, k, lane);
}

// The lanes' moment sums of one center in a fixed order (shuffle tree);
// lane 0 stores the kFeat totals at `red`.
__device__ __forceinline__ void reduce_moments(const double (&m)[kFeat],
                                               double* red, int lane) {
#pragma unroll
  for (int t = 0; t < kFeat; ++t) {
    double v = m[t];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(kFull, v, off);
    if (lane == 0) red[t] = v;
  }
}

__global__ void pack_kernel(const float* __restrict__ points,
                            const uint8_t* __restrict__ valid, int total,
                            float4* __restrict__ packed) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const float x = points[3 * (size_t)i], y = points[3 * (size_t)i + 1],
              z = points[3 * (size_t)i + 2];
  packed[i] = make_float4(x, y, z, valid[i] ? dpm::sq_norm(x, y, z) : -1.f);
}

// Shared memory: per warp and center a run in two buffers of kpad keys and
// a queue of kQueue keys; per warp kGroup bytes saying which buffer holds
// the run; with moments, per warp kGroup * kFeat doubles.
// With moments the float64 sums want registers: two blocks an SM keep the
// compiler at 128 (it measured faster than more registers and fewer warps);
// without them one block's worth removes the cap and the spills. ONE is
// the kernel for k = 1 (its own instance, so that its path costs the
// others no registers).
template <bool MOMENTS, bool ONE>
__global__ void __launch_bounds__(kMaxWarps * 32, MOMENTS ? 2 : 1)
knn_kernel(const float4* __restrict__ packed,
           const float* __restrict__ centers, int n, int s, int k, int kpad,
           int parts, int stride, float r2, int64_t* __restrict__ idx_out,
           float* __restrict__ d2_out, float* __restrict__ mom_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const int per_center = 2 * kpad + kQueue;
  uint64_t* keys = reinterpret_cast<uint64_t*>(smem);
  double* red = reinterpret_cast<double*>(
      keys + (size_t)warps * kGroup * per_center);
  unsigned char* which = reinterpret_cast<unsigned char*>(
      red + (MOMENTS ? warps * kGroup * kFeat : 0));

  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int part = warp % parts;
  const int group = blockIdx.x * (warps / parts) + warp / parts;
  const int c0 = group * kGroup;
  const float4* P = packed + (size_t)b * n;
  uint64_t* wkeys = keys + (size_t)warp * kGroup * per_center;

  float cx[kGroup], cy[kGroup], cz[kGroup], c2[kGroup];
  Select s0, s1, s2, s3;
  double m0[kFeat], m1[kFeat], m2[kFeat], m3[kFeat];
#pragma unroll
  for (int c = 0; c < kGroup; ++c) {
    const float* C = centers + ((size_t)b * s + min(c0 + c, s - 1)) * 3;
    cx[c] = C[0];
    cy[c] = C[1];
    cz[c] = C[2];
    c2[c] = dpm::sq_norm(cx[c], cy[c], cz[c]);
  }
#pragma unroll
  for (int t = 0; t < kFeat; ++t) m0[t] = m1[t] = m2[t] = m3[t] = 0.0;
  for (int i = lane; i < kGroup * per_center; i += 32) wkeys[i] = kEmpty;
  __syncwarp();
  uint64_t* const b0 = wkeys;
  uint64_t* const b1 = wkeys + per_center;
  uint64_t* const b2 = wkeys + 2 * per_center;
  uint64_t* const b3 = wkeys + 3 * per_center;

  // The 32-point steps are visited in the order (u * stride) mod steps,
  // u = part, part + parts, ...: a scan arrives in the sensor's sweep
  // order, along which a center's distance falls for long stretches and
  // every point would be a candidate; a scattered order brings the
  // threshold down within the first steps. The result does not depend on
  // the order.
  const float4 nothing = make_float4(0.f, 0.f, 0.f, -1.f);
  const int steps = (n + 31) / 32;
  const int jump = (int)((long long)stride * parts % steps);
  int pos = (int)((long long)stride * part % steps);
  float4 next = part < steps && pos * 32 + lane < n ? P[pos * 32 + lane]
                                                    : nothing;
  for (int u = part; u < steps; u += parts) {
    const int idx = pos * 32 + lane;
    const bool have = idx < n;
    const float4 q = next;
    pos += jump;
    if (pos >= steps) pos -= steps;
    next = u + parts < steps && pos * 32 + lane < n ? P[pos * 32 + lane]
                                                   : nothing;
    const bool live = q.w >= 0.f;
    // an invalid point stands at 1e9: it matters only while a run has room
    const float widest = fmaxf(fmaxf(s0.thr_d, s1.thr_d),
                               fmaxf(s2.thr_d, s3.thr_d));
    if (widest < 1e9f && !__any_sync(kFull, live)) continue;
    float d[kGroup];
#pragma unroll
    for (int c = 0; c < kGroup; ++c)
      d[c] = live ? dpm::dist2(c2[c], cx[c], cy[c], cz[c], q.w, q.x, q.y, q.z)
                  : 1e9f;
    if (MOMENTS && live &&
        (d[0] <= r2 || d[1] <= r2 || d[2] <= r2 || d[3] <= r2)) {
      double f[kFeat - 1];
      dpm::features(q.x, q.y, q.z, f);
      if (d[0] <= r2) dpm::add_point(m0, f);
      if (d[1] <= r2) dpm::add_point(m1, f);
      if (d[2] <= r2) dpm::add_point(m2, f);
      if (d[3] <= r2) dpm::add_point(m3, f);
    }
    const bool maybe = d[0] <= s0.thr_d || d[1] <= s1.thr_d ||
                       d[2] <= s2.thr_d || d[3] <= s3.thr_d;
    if (!__any_sync(kFull, have && maybe)) continue;
    offer<ONE>(s0, have, d[0], idx, b0, kpad, k, lane);
    offer<ONE>(s1, have, d[1], idx, b1, kpad, k, lane);
    offer<ONE>(s2, have, d[2], idx, b2, kpad, k, lane);
    offer<ONE>(s3, have, d[3], idx, b3, kpad, k, lane);
  }

  if (ONE) {  // the thresholds are the runs (kEmpty if nothing passed)
    if (lane == 0) {
      b0[0] = make_key(s0.thr_d, s0.thr_i);
      b1[0] = make_key(s1.thr_d, s1.thr_i);
      b2[0] = make_key(s2.thr_d, s2.thr_i);
      b3[0] = make_key(s3.thr_d, s3.thr_i);
    }
    __syncwarp();
  }
  if (s0.queued > 0) flush(s0, b0, kpad, k, lane);
  if (s1.queued > 0) flush(s1, b1, kpad, k, lane);
  if (s2.queued > 0) flush(s2, b2, kpad, k, lane);
  if (s3.queued > 0) flush(s3, b3, kpad, k, lane);
  if (lane == 0) {
    which[warp * kGroup + 0] = (unsigned char)s0.cur;
    which[warp * kGroup + 1] = (unsigned char)s1.cur;
    which[warp * kGroup + 2] = (unsigned char)s2.cur;
    which[warp * kGroup + 3] = (unsigned char)s3.cur;
  }
  if (MOMENTS) {
    double* wred = red + warp * kGroup * kFeat;
    reduce_moments(m0, wred, lane);
    reduce_moments(m1, wred + kFeat, lane);
    reduce_moments(m2, wred + 2 * kFeat, lane);
    reduce_moments(m3, wred + 3 * kFeat, lane);
  }
  __syncthreads();

  // Warp `part` of a center group finishes the centers part, part + parts,
  // ...: it merges the other parts' runs into part 0's, adds the parts'
  // moment sums in order, and writes the center's rows.
  const int first = warp - part;  // the group's part 0
  for (int c = part; c < kGroup; c += parts) {
    if (c0 + c >= s) break;
    uint64_t* base = keys + ((size_t)first * kGroup + c) * per_center;
    int at = which[first * kGroup + c];
    for (int p = 1; p < parts; ++p) {
      const uint64_t* other =
          keys + ((size_t)(first + p) * kGroup + c) * per_center +
          which[(first + p) * kGroup + c] * kpad;
      for (int off = 0; off < k; off += kQueue) {
        merge_keys(base + at * kpad, base + (at ^ 1) * kpad, other + off,
                   min(kQueue, k - off), k, lane);
        at ^= 1;
      }
    }
    const uint64_t* run = base + at * kpad;
    const size_t row = (size_t)b * s + c0 + c;
    for (int i = lane; i < k; i += 32) {
      const uint64_t key = run[i];
      idx_out[row * k + i] = (int64_t)(uint32_t)key;
      d2_out[row * k + i] = mono_float((uint32_t)(key >> 32));
    }
    if (MOMENTS && lane < kFeat) {
      double v = 0.0;
      for (int p = 0; p < parts; ++p)
        v += red[((first + p) * kGroup + c) * kFeat + lane];
      const float r = __double2float_rn(v);
      mom_out[row * kFeat + lane] = lane == 0 ? fmaxf(r, 1.f) : r;
    }
  }
}

size_t smem_bytes(int warps, int kpad, bool moments) {
  return (size_t)warps * kGroup * (2 * kpad + kQueue) * sizeof(uint64_t) +
         (moments ? (size_t)warps * kGroup * kFeat * sizeof(double) : 0) +
         (size_t)warps * kGroup;
}

template <bool MOMENTS>
cudaError_t launch(const float4* packed, const float* centers, int b, int n,
                   int s, int k, float r2, int64_t* idx, float* d2,
                   float* mom, cudaStream_t stream) {
  const int kpad = (k + 31) & ~31;
  const int groups = (s + kGroup - 1) / kGroup;
  // enough warps for the card's 132 SMs to hide the loads: split a center
  // group's scan over up to 8 warps while there are fewer than ~16 warps
  // an SM (every part fills a run of its own, so more parts measured
  // slower at k = 32), and while a part still gets two steps of points
  int parts = 1;
  while (parts < kMaxWarps && (long)b * groups * parts < 2048 &&
         parts * 64 <= n)
    parts *= 2;
  int warps = parts == kMaxWarps ? kMaxWarps : 4;
  const size_t limit = 200 * 1024;
  if (smem_bytes(warps, kpad, MOMENTS) > limit) {  // wide runs: 4 warps
    warps = 4;
    parts = min(parts, 4);
  }
  // the multiplier of the visiting order: near steps / golden ratio, and
  // coprime to the step count so that every step is visited once
  const int steps = (n + 31) / 32;
  int stride = (int)(steps * 0.6180339887) | 1;
  auto gcd = [](int a, int c) {
    while (c) {
      const int r = a % c;
      a = c;
      c = r;
    }
    return a;
  };
  while (gcd(stride, steps) != 1) stride += 2;
  const size_t smem = smem_bytes(warps, kpad, MOMENTS);
  auto kernel = k == 1 ? knn_kernel<MOMENTS, true>
                        : knn_kernel<MOMENTS, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int per_block = warps / parts;
  const dim3 grid((groups + per_block - 1) / per_block, b);
  kernel<<<grid, warps * 32, smem, stream>>>(
      packed, centers, n, s, k, kpad, parts, stride, r2, idx, d2, mom);
  return cudaGetLastError();
}

}  // namespace

// points (b, n, 3) f32, valid (b, n) bool as bytes, centers (b, s, 3) f32;
// packed (b, n, 4) f32 scratch; idx (b, s, k) int64 and d2 (b, s, k) f32
// out; mom (b, s, 10) f32 out, or null for no moments. All contiguous on
// the device; 1 <= k <= min(n, 512), b <= 65535. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int dpm_knn(const void* points, const void* valid,
                       const void* centers, int b, int n, int s, int k,
                       float r2, void* packed, void* idx, void* d2,
                       void* mom, void* stream) {
  if (b < 1 || b > 65535 || n < 1 || s < 1 || k < 1 || k > n || k > kMaxK ||
      (long)b * n > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto pk = static_cast<float4*>(packed);
  const int total = b * n;
  pack_kernel<<<(total + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(points), static_cast<const uint8_t*>(valid),
      total, pk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto c = static_cast<const float*>(centers);
  auto i = static_cast<int64_t*>(idx);
  auto d = static_cast<float*>(d2);
  if (mom != nullptr)
    return (int)launch<true>(pk, c, b, n, s, k, r2, i, d,
                             static_cast<float*>(mom), st);
  return (int)launch<false>(pk, c, b, n, s, k, r2, i, d, nullptr, st);
}
