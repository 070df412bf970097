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
//
// That route was tuned at the paths' k (1-41). At wide k it filters little
// (every part fills a run of k keys from its share of the points), merges
// 64 keys at a time into runs of k, and its 2 * kpad keys a center leave a
// block four warps an SM: at (1, 4096, 1024) it took 1.98 ms for k = 512,
// 7.6 times torch.cdist + topk. From k = kWideK on a second route selects
// (the wide route, `wide_kernel`):
//   * A block of kWideThreads threads takes one center and keeps a list of
//     up to kList candidate keys in shared memory. A scan longer than the
//     list is first sampled: about 4kn / kList points in a scattered order
//     (i * stride mod n, the stride near n / golden ratio: regular runs of
//     points aliased with the scan's rings and measured twice as slow), and
//     a radix select finds a bound with at least k and at most 2k sampled
//     keys at or below it. The scan's k smallest keys lie below it too.
//   * One pass over the scan measures every point once (coalesced float4
//     loads, the next 256 in flight), adds the moments, and appends the
//     keys at or below the bound to the list (ballot, one atomic a warp):
//     about a quarter of the list. This pass is most of the route's time
//     at n = 16384 (about 16 bytes a pair from L2 for one center a block).
//   * Radix select over the list: kDigit bits a pass from the top of the
//     64-bit key, a histogram in shared memory (a warp adds the lanes that
//     share the first active lane's digit with one atomic: a center's
//     distances crowd into few digits), a block scan over the kBins counts
//     picks the bucket of the k-th key, until at most kp2 keys lie at or
//     below the bucket. Keys are distinct, so exact ties in distance are
//     settled by the index digits, as the key order says; the cost depends
//     on neither k nor the order of the points. If the sample misled and
//     the list overflowed, the same select runs over the scan itself,
//     measured again each pass.
//   * Those keys (kEmpty pads them to kp2, a power of two of at least 32)
//     are sorted by one warp in registers, a bitonic network with shuffles
//     (a kernel instance for each kp2, so that a short sort does not pay a
//     long one's registers), which writes the first k.
//   * The moments are float64 sums, each thread's in its own order,
//     reduced warp by warp in a fixed order and rounded once.
// kWideK = 42 is the lowest k above the widest a path asks for (41), so no
// path changes route. On the card (scripts/bench_torch_kernels.py; PERF.md)
// the wide route is about 3x faster than the other at (1, 4096, 1024) at
// every k from 42 on, and on the preprocess sweep's scan (N = S = 16384,
// moments at 0.5 m) the two are within 1.5% at k = 42-50, the wide one
// ahead from k = 56 on.

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
// the wide route: from k = kWideK on (ops/neighbors.py mirrors it as
// KNN_WIDE_K)
constexpr int kWideK = 42;
constexpr int kWideWarps = 8;
constexpr int kWideThreads = kWideWarps * 32;
constexpr int kDigit = 8;
constexpr int kBins = 1 << kDigit;
static_assert(kBins == kWideThreads, "a thread owns one bin of a histogram");
constexpr int kList = 4096;  // candidate keys a center keeps in shared memory

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

// A multiplier near count / golden ratio and coprime to count: i * it mod
// count visits 0 .. count - 1 once each, scattered.
int golden_stride(int count) {
  int stride = (int)(count * 0.6180339887) | 1;
  auto gcd = [](int a, int c) {
    while (c) {
      const int r = a % c;
      a = c;
      c = r;
    }
    return a;
  };
  while (gcd(stride, count) != 1) stride += 2;
  return stride;
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
  // the multiplier of the visiting order, so that every step is visited
  // once
  const int stride = golden_stride((n + 31) / 32);
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

// ------------------------------------------------------------ wide route

// Count the digit `bin` of each lane with `on` in the histogram. The whole
// warp calls: the lanes that share the first active lane's digit add with
// one atomic (a center's distances crowd into a few digits at the top),
// the others one each.
__device__ __forceinline__ void count_digit(unsigned* hist, bool on,
                                            unsigned bin, int lane) {
  const unsigned act = __ballot_sync(kFull, on);
  if (act == 0u) return;
  const int src = __ffs(act) - 1;
  const unsigned lead = __shfl_sync(kFull, bin, src);
  const unsigned same = __ballot_sync(kFull, on && bin == lead);
  if (lane == src) atomicAdd(&hist[lead], (unsigned)__popc(same));
  else if (on && bin != lead) atomicAdd(&hist[bin], 1u);
}

// Exclusive prefix sum over the block of one value a thread, in thread
// order. `tot` holds kWideWarps values; every thread calls, and the caller
// syncs before `tot` is written again.
__device__ __forceinline__ unsigned block_exclusive_sum(unsigned v,
                                                        unsigned* tot,
                                                        int lane, int warp) {
  unsigned x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) tot[warp] = x;
  __syncthreads();
  unsigned base = 0u;
  for (int w = 0; w < warp; ++w) base += tot[w];
  return base + x - v;
}

// Append the lanes' keys with `on` at the counter `*fill`, in any order,
// while the slots last (`*fill` counts them all). The whole warp calls.
__device__ __forceinline__ void append(uint64_t* dst, unsigned* fill,
                                       int cap, bool on, uint64_t key,
                                       int lane) {
  const unsigned hits = __ballot_sync(kFull, on);
  if (hits == 0u) return;
  unsigned base = 0u;
  if (lane == 0) base = atomicAdd(fill, (unsigned)__popc(hits));
  base = __shfl_sync(kFull, base, 0) + __popc(hits & ((1u << lane) - 1u));
  if (on && base < (unsigned)cap) dst[base] = key;
}

// The block's scratch in shared memory: a histogram of kBins counts, the
// warps' scan totals, and kPicks counters: the selected digit, the keys
// below it and its count, then the fills of the list and of the sort.
constexpr int kPicks = 5;
struct Scratch {
  unsigned* hist;
  unsigned* tot;
  unsigned* pick;
};

// Radix select over the `count` 64-bit keys get(0), ..., get(count - 1):
// the digits of the k-th smallest, kDigit bits a pass from the top, until
// the keys at or below the selected bucket number at most `room` (room >=
// k; the keys are distinct, so the last digit leaves exactly k) -> the
// bucket's largest key, `bound`: at least k and at most `room` keys are <=
// it, and they hold the k smallest. The histogram is zero on entry and on
// return. Every thread calls.
template <class Get>
__device__ uint64_t select_bound(int count, Get get, int k, int room,
                                 Scratch sc, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  uint64_t prefix = 0ull, mask = 0ull;
  int kk = k;
  for (int shift = 64 - kDigit;; shift -= kDigit) {
    for (int i0 = 0; i0 < count; i0 += kWideThreads) {
      const int i = i0 + tid;
      const bool on = i < count;
      const uint64_t key = on ? get(i) : 0ull;
      count_digit(sc.hist, on && (key & mask) == prefix,
                  (unsigned)(key >> shift) & (kBins - 1), lane);
    }
    __syncthreads();
    const unsigned c = sc.hist[tid];
    const unsigned below = block_exclusive_sum(c, sc.tot, lane, warp);
    sc.hist[tid] = 0u;
    if (below < (unsigned)kk && (unsigned)kk <= below + c) {
      sc.pick[0] = (unsigned)tid;
      sc.pick[1] = below;
      sc.pick[2] = c;
    }
    __syncthreads();
    kk -= (int)sc.pick[1];
    prefix |= (uint64_t)sc.pick[0] << shift;
    mask |= (uint64_t)(kBins - 1) << shift;
    if (k - kk + (int)sc.pick[2] <= room || shift == 0) {
      __syncthreads();  // pick is written again only after this
      return prefix | ~mask;
    }
  }
}

// One warp sorts the 32 * KPL keys at `sel` ascending by a bitonic network
// in registers (key r * 32 + lane in v[r]: partners 32 or more apart are
// the lane's own registers, nearer ones come by shuffle) and writes the
// first k as indices and distances.
template <int KPL>
__device__ __forceinline__ void sort_and_write(const uint64_t* sel, int k,
                                               int lane, int64_t* idx_row,
                                               float* d2_row) {
  uint64_t v[KPL];
#pragma unroll
  for (int r = 0; r < KPL; ++r) v[r] = sel[r * 32 + lane];
#pragma unroll
  for (int size = 2; size <= 32 * KPL; size <<= 1) {
#pragma unroll
    for (int half = size >> 1; half > 0; half >>= 1) {
#pragma unroll
      for (int r = 0; r < KPL; ++r) {
        const bool up = ((r * 32 + lane) & size) == 0;
        if (half >= 32) {
          const int h = half / 32;
          if (r & h) continue;
          const uint64_t x = v[r], y = v[r + h];
          if ((x > y) == up) {
            v[r] = y;
            v[r + h] = x;
          }
        } else {
          // the lower key of an ascending pair keeps the smaller one
          const uint64_t y = __shfl_xor_sync(kFull, v[r], half);
          const bool keep_min = ((lane & half) == 0) == up;
          v[r] = keep_min == (v[r] < y) ? v[r] : y;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < KPL; ++r) {
    const int e = r * 32 + lane;
    if (e < k) {
      idx_row[e] = (int64_t)(uint32_t)v[r];
      d2_row[e] = mono_float((uint32_t)(v[r] >> 32));
    }
  }
}

// One block a center (blockIdx.x) of scan blockIdx.y:
//   1. With n > list_cap, a sample: the points i * order mod n, i < m
//      (`m`, `order` from the host), go to `list` as keys, and
//      select_bound finds `tau`, with k to 2k sampled keys <= it: it bounds
//      the scan's k-th key from above. Without a sample tau is the largest
//      key.
//   2. One pass over the scan measures every point (the moments ride it)
//      and appends the keys <= tau to `list`, up to 2k * n / m of them.
//   3. select_bound over the list (or, if it overflowed, over the scan
//      measured again) leaves at most kp2 = 32 * KPL keys <= its bound;
//      they go to `sel`, and warp 0 sorts them and writes the first k
//      (sort_and_write).
// Shared memory: list_cap keys, kp2 keys, with moments kWideWarps * kFeat
// doubles, kBins + kWideWarps + kPicks counters.
template <bool MOMENTS, int KPL>
__global__ void __launch_bounds__(kWideThreads)
wide_kernel(const float4* __restrict__ packed,
            const float* __restrict__ centers, int n, int s, int k,
            int list_cap, int m, int order, float r2,
            int64_t* __restrict__ idx_out,
            float* __restrict__ d2_out, float* __restrict__ mom_out) {
  constexpr int kp2 = 32 * KPL;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* list = reinterpret_cast<uint64_t*>(smem);
  uint64_t* sel = list + list_cap;
  double* red = reinterpret_cast<double*>(sel + kp2);
  Scratch sc;
  sc.hist =
      reinterpret_cast<unsigned*>(red + (MOMENTS ? kWideWarps * kFeat : 0));
  sc.tot = sc.hist + kBins;
  sc.pick = sc.tot + kWideWarps;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = (size_t)blockIdx.y * s + blockIdx.x;
  const float4* P = packed + (size_t)blockIdx.y * n;
  const float cx = centers[row * 3], cy = centers[row * 3 + 1],
              cz = centers[row * 3 + 2];
  const float c2 = dpm::sq_norm(cx, cy, cz);
  auto key_of = [&](int j) -> uint64_t {
    const float4 q = P[j];
    const float d =
        q.w >= 0.f ? dpm::dist2(c2, cx, cy, cz, q.w, q.x, q.y, q.z) : 1e9f;
    return ((uint64_t)mono_bits(d) << 32) | (uint32_t)j;
  };

  sc.hist[tid] = 0u;
  if (tid < kPicks) sc.pick[tid] = 0u;
  uint64_t tau = ~0ull;
  if (m > 0) {
    for (int i = tid; i < m; i += kWideThreads)
      list[i] = key_of((int)((long long)i * order % n));
    __syncthreads();
    tau = select_bound(m, [&](int i) { return list[i]; }, k, 2 * k, sc, tid);
  } else {
    __syncthreads();
  }

  // every point: the moments, and the keys <= tau into the list
  double mom[kFeat];
#pragma unroll
  for (int t = 0; t < kFeat; ++t) mom[t] = 0.0;
  const float4 nothing = make_float4(0.f, 0.f, 0.f, -1.f);
  float4 next = tid < n ? P[tid] : nothing;
  for (int j0 = 0; j0 < n; j0 += kWideThreads) {
    const int j = j0 + tid;
    const bool on = j < n;
    const float4 q = next;
    next = j + kWideThreads < n ? P[j + kWideThreads] : nothing;
    const bool live = q.w >= 0.f;
    const float d =
        live ? dpm::dist2(c2, cx, cy, cz, q.w, q.x, q.y, q.z) : 1e9f;
    const uint64_t key = ((uint64_t)mono_bits(d) << 32) | (uint32_t)j;
    if (MOMENTS && on && live && d <= r2) {
      double f[kFeat - 1];
      dpm::features(q.x, q.y, q.z, f);
      dpm::add_point(mom, f);
    }
    append(list, &sc.pick[3], list_cap, on && key <= tau, key, lane);
  }
  if (MOMENTS) reduce_moments(mom, red + warp * kFeat, lane);
  __syncthreads();

  // at most kp2 keys <= bound, the k smallest among them, into sel
  const int listed = (int)sc.pick[3];
  if (listed <= list_cap) {
    auto get = [&](int i) { return list[i]; };
    const uint64_t bound = select_bound(listed, get, k, kp2, sc, tid);
    for (int i0 = 0; i0 < listed; i0 += kWideThreads) {
      const int i = i0 + tid;
      const uint64_t key = i < listed ? list[i] : kEmpty;
      append(sel, &sc.pick[4], kp2, i < listed && key <= bound, key, lane);
    }
  } else {  // the sample bounded badly: select over the scan itself
    const uint64_t bound = select_bound(n, key_of, k, kp2, sc, tid);
    for (int j0 = 0; j0 < n; j0 += kWideThreads) {
      const int j = j0 + tid;
      const uint64_t key = j < n ? key_of(j) : kEmpty;
      append(sel, &sc.pick[4], kp2, j < n && key <= bound, key, lane);
    }
  }
  __syncthreads();
  for (int i = (int)sc.pick[4] + tid; i < kp2; i += kWideThreads)
    sel[i] = kEmpty;
  __syncthreads();

  // warp 0 writes the moments, sorts the kp2 keys and writes the first k
  if (warp != 0) return;
  if (MOMENTS && lane < kFeat) {
    double v = 0.0;
    for (int w = 0; w < kWideWarps; ++w) v += red[w * kFeat + lane];
    const float r = __double2float_rn(v);
    mom_out[row * kFeat + lane] = lane == 0 ? fmaxf(r, 1.f) : r;
  }
  sort_and_write<KPL>(sel, k, lane, idx_out + row * k, d2_out + row * k);
}

size_t wide_smem_bytes(int list_cap, int kp2, bool moments) {
  return (size_t)(list_cap + kp2) * sizeof(uint64_t) +
         (moments ? (size_t)kWideWarps * kFeat * sizeof(double) : 0) +
         (size_t)(kBins + kWideWarps + kPicks) * sizeof(unsigned);
}

// The sample's size: 0 (no sample) when the list holds the whole scan;
// else 4kn / kList points (at least k, at most the list), so that about a
// quarter to a half of the list falls under its bound. It is taken in the
// order i * golden_stride(n) mod n, so that a scan's sweep order or its
// rings cannot make it one-sided (regular runs of points measured up to
// twice as slow: their bound overflowed the list).
int sample_size(int n, int k) {
  if (n <= kList) return 0;
  return (int)min((long long)kList,
                  max((long long)k, (4LL * k * n + kList - 1) / kList));
}


template <bool MOMENTS, int KPL>
cudaError_t launch_wide(const float4* packed, const float* centers, int b,
                        int n, int s, int k, float r2, int64_t* idx,
                        float* d2, float* mom, cudaStream_t stream) {
  const int list_cap = min(n, kList);
  const size_t smem = wide_smem_bytes(list_cap, 32 * KPL, MOMENTS);
  cudaError_t err = cudaFuncSetAttribute(
      wide_kernel<MOMENTS, KPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  wide_kernel<MOMENTS, KPL><<<dim3(s, b), kWideThreads, smem, stream>>>(
      packed, centers, n, s, k, list_cap, sample_size(n, k), golden_stride(n),
      r2, idx, d2, mom);
  return cudaGetLastError();
}

// The wide route's kernel for k: 32 * KPL sorted keys, the power of two
// at or above k (and at least a warp's worth), each its own instance so
// that a short sort does not pay a long one's registers.
template <bool MOMENTS>
cudaError_t launch_wide(const float4* packed, const float* centers, int b,
                        int n, int s, int k, float r2, int64_t* idx,
                        float* d2, float* mom, cudaStream_t stream) {
  if (k <= 32)
    return launch_wide<MOMENTS, 1>(packed, centers, b, n, s, k, r2, idx, d2,
                                   mom, stream);
  if (k <= 64)
    return launch_wide<MOMENTS, 2>(packed, centers, b, n, s, k, r2, idx, d2,
                                   mom, stream);
  if (k <= 128)
    return launch_wide<MOMENTS, 4>(packed, centers, b, n, s, k, r2, idx, d2,
                                   mom, stream);
  if (k <= 256)
    return launch_wide<MOMENTS, 8>(packed, centers, b, n, s, k, r2, idx, d2,
                                   mom, stream);
  return launch_wide<MOMENTS, 16>(packed, centers, b, n, s, k, r2, idx, d2,
                                  mom, stream);
}

}  // namespace

// points (b, n, 3) f32, valid (b, n) bool as bytes, centers (b, s, 3) f32;
// packed (b, n, 4) f32 scratch; idx (b, s, k) int64 and d2 (b, s, k) f32
// out; mom (b, s, 10) f32 out, or null for no moments. All contiguous on
// the device; 1 <= k <= min(n, 512), b <= 65535. `route` 0 takes the wide
// route from k = kWideK on, 1 the queue-and-merge route and 2 the wide
// route at any k (to time one against the other). Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int dpm_knn(const void* points, const void* valid,
                       const void* centers, int b, int n, int s, int k,
                       float r2, void* packed, void* idx, void* d2,
                       void* mom, int route, void* stream) {
  if (b < 1 || b > 65535 || n < 1 || s < 1 || k < 1 || k > n || k > kMaxK ||
      (long)b * n > 0x7fffffffL || route < 0 || route > 2)
    return (int)cudaErrorInvalidValue;
  const bool wide = route == 2 || (route == 0 && k >= kWideK);
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
  auto mo = static_cast<float*>(mom);
  if (wide)
    return (int)(mo != nullptr
                     ? launch_wide<true>(pk, c, b, n, s, k, r2, i, d, mo, st)
                     : launch_wide<false>(pk, c, b, n, s, k, r2, i, d, mo,
                                          st));
  return (int)(mo != nullptr
                   ? launch<true>(pk, c, b, n, s, k, r2, i, d, mo, st)
                   : launch<false>(pk, c, b, n, s, k, r2, i, d, mo, st));
}
