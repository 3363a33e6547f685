// bitserial_median: per-cluster bit-serial (majority-vote) medians for
// Hopper (sm_90a).
//
// Replaces the TPU kernel _kernel of src/repro/kernels/bitserial_median.py
// (launched by grouped_median_pallas): for every batch member m, cluster k
// and column d, the weighted lower median of the unsigned-ordered words of
// the points assigned to k, scanned MSB -> LSB.  At bit b
//     cnt1[k, d] = sum_{i: assign_i = k} w_i * eff_i,d
// and the median's bit is 1 iff 2 * cnt1 > total_k.  Clusters of total 0
// get the word 0; totals (sum of weights per cluster) come back too.
//
// The TPU kernel carries two (N, TD) planes per point (active, forced) and
// updates them with a second one-hot matmul per bit.  This kernel uses the
// equivalent radix-select form, which needs no per-point state: with the
// median's prefix m decided above bit b (bits <= b still 0), a point votes
// 1 at bit b exactly when its word is >= m | 2^b (an active point whose
// bit b is 1, or a point that already left the prefix upwards).  So
//     cnt1 = W(x >= m | 2^b),
// a monotone predicate of the threshold, and the median is the largest v
// with 2 W(x >= v) > total.  Only the low `bits` bits of a word count.
//
// Exactness: the sums are f32.  With integer-valued weights whose totals
// lie below 2^24 (unit weights, 0/1 masks, cluster counts: every caller in
// the repository) every summation order gives the same bits, so the result
// equals the plain version (core/bitserial.py) bit for bit.  Points of
// weight 0 are dropped: adding +0.0 leaves an f32 sum unchanged.
//
// Two forms, chosen by the wrapper (kernels/bitserial_median.py):
//  * resident (chunk == 0): one block per (member, tile of TD <= 32
//    columns), for the serve's absorb and compaction (N = 320, D = 128).
//    The block groups its points by cluster once, stably: one warp walks
//    the points 32 at a time (__match_any_sync gives each point its rank
//    among the equal keys of its round), an exclusive scan of the counts
//    gives each cluster's first row, and the member's words (low 32 bits
//    of the int64 words, 16-byte loads) are staged in shared memory with
//    each cluster's points in consecutive rows, in point order.  Then one
//    warp takes one cluster, lane = column, largest clusters first, and
//    runs all `bits` bits in registers: per bit, the sum of w * [x >= thr]
//    over the cluster's rows in point order.  A cluster of n <= bits
//    points (most of the serve's: 320 points, a third of weight 0, in 64
//    clusters) takes the same median in n^2 instead of n * bits steps: the
//    largest of its words x_j with 2 W(x >= x_j) > total.  No atomics, no
//    count array, no barrier after the grouping, and the same sums in the
//    same order in every run, whatever the weights.
//  * streamed (chunk > 0), for N too large to stage: the median is chosen
//    r bits (a digit) at a time, r = 4 where the histogram fits shared
//    memory.  Per digit one launch over (chunk of points, tile, member)
//    blocks builds, for the points whose prefix equals their cluster's
//    median prefix, the weighted histogram of their next digit (shared f32
//    atomics, exact under the condition above; integer atomics for unit
//    weights) and writes it as the chunk's partial; a second launch sums
//    the partials over chunks in a fixed order (four runs of consecutive
//    chunks side by side, then the four sums) and takes the largest digit
//    v with
//        2 (above + sum_{v' >= v} hist[v']) > total,
//    where `above` is the weight already left upwards, carried from digit
//    to digit.  The first digit's launch also writes the words' low 32
//    bits to a uint32 scratch, which the later digits read.  The last
//    digit is narrower when r does not divide `bits`.
//
// What bounds it: bytes.  The resident form reads each member's int64
// words once (points of weight 0 not at all, 8 loads in flight a thread)
// and keeps the votes, n^2 or n * bits shared-memory compare-and-adds per
// cluster and column, small beside that.  The streamed form reads the
// words once as int64 and ceil(bits / r) - 1 times as uint32, plus the
// chunk partials, at the rate its histogram's loads and shared atomics
// reach.

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int kThreads = 256;          // resident block
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 8;              // 16-byte loads in flight a thread
constexpr int kStreamThreads = 512;    // streamed histogram block
constexpr int kUnroll = 8;             // points a streamed thread loads at once
constexpr int kMaxDigit = 4;           // streamed digit width
constexpr int kMaxBins = 1 << kMaxDigit;
constexpr int kSelectCols = 16;        // columns per select block
constexpr int kSelectGroups = 4;       // chunk groups a select block sums
constexpr int kSelectThreads = kSelectGroups * kMaxBins * kSelectCols;

__device__ __forceinline__ uint32_t low_mask(int bits) {
  return bits >= 32 ? 0xFFFFFFFFu : (1u << bits) - 1u;
}

__global__ void __launch_bounds__(kThreads)
resident_kernel(const long long* __restrict__ u, const int* __restrict__ assign,
                const float* __restrict__ w, int N, int D, int K, int bits,
                int TD, long long* __restrict__ med,
                float* __restrict__ totals) {
  extern __shared__ uint32_t smem[];
  uint32_t* x_s = smem;                          // N * TD words, cluster rows
  float* wx_s = (float*)(x_s + (size_t)N * TD);  // N weights, cluster rows
  int* key_s = (int*)(wx_s + N);                 // N clusters; -1: no vote
  int* rank_s = key_s + N;                       // N rank within the cluster
  int* start_s = rank_s + N;                     // K + 1 first rows
  int* order_s = start_s + K + 1;                // K clusters, largest first

  const int m = blockIdx.y;
  const int d0 = blockIdx.x * TD;
  const int tw = min(TD, D - d0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long* um = u + (size_t)m * N * D;
  const uint32_t mask = low_mask(bits);

  for (int i = tid; i < N; i += kThreads) {
    const int c = assign[(size_t)m * N + i];
    const float wt = w ? w[(size_t)m * N + i] : 1.f;
    key_s[i] = c >= 0 && c < K && wt != 0.f ? c : -1;
  }
  __syncthreads();

  // ranks within clusters in point order, then the counts' exclusive scan
  if (warp == 0) {
    for (int k = lane; k < K; k += 32) start_s[k] = 0;
    __syncwarp();
    for (int base = 0; base < N; base += 32) {
      const int i = base + lane;
      const int key = i < N ? key_s[i] : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, key);
      if (key >= 0)
        rank_s[i] = start_s[key] + __popc(peers & ((1u << lane) - 1u));
      __syncwarp();
      if (key >= 0 && lane == __ffs(peers) - 1) start_s[key] += __popc(peers);
      __syncwarp();
    }
    int carry = 0;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + lane;
      const int c = k < K ? start_s[k] : 0;
      int x = c;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      if (k < K) start_s[k] = carry + x - c;
      carry += __shfl_sync(0xffffffffu, x, 31);
    }
    if (lane == 0) start_s[K] = carry;
  }
  __syncthreads();

  // largest clusters first (ties by index), so no warp starts a long
  // cluster last
  for (int k = tid; k < K; k += kThreads) {
    const int nk = start_s[k + 1] - start_s[k];
    int r = 0;
    for (int j = 0; j < K; ++j) {
      const int nj = start_s[j + 1] - start_s[j];
      r += nj > nk || (nj == nk && j < k);
    }
    order_s[r] = k;
  }
  for (int i = tid; i < N; i += kThreads) {
    const int key = key_s[i];
    if (key >= 0)
      wx_s[start_s[key] + rank_s[i]] = w ? w[(size_t)m * N + i] : 1.f;
  }
  if ((D & 1) == 0) {
    // 16-byte loads, two words each, kStage of them in flight per thread
    const int half = TD / 2, total = N * half;
    for (int e0 = tid; e0 < total; e0 += kThreads * kStage) {
      longlong2 v[kStage];
      int dst[kStage];
#pragma unroll
      for (int j = 0; j < kStage; ++j) {
        const int e = e0 + j * kThreads;
        const int i = e / half, d = 2 * (e - i * half);
        const int key = e < total ? key_s[i] : -1;
        dst[j] = key >= 0 && d < tw ? (start_s[key] + rank_s[i]) * TD + d : -1;
        if (dst[j] >= 0)
          v[j] = *reinterpret_cast<const longlong2*>(um + (size_t)i * D + d0 +
                                                     d);
      }
#pragma unroll
      for (int j = 0; j < kStage; ++j)
        if (dst[j] >= 0)
          *reinterpret_cast<uint2*>(x_s + dst[j]) =
              make_uint2((uint32_t)v[j].x & mask, (uint32_t)v[j].y & mask);
    }
  } else {
    for (int e = tid; e < N * TD; e += kThreads) {
      const int i = e / TD, d = e - i * TD;
      const int key = key_s[i];
      if (key < 0 || d >= tw) continue;
      x_s[(size_t)(start_s[key] + rank_s[i]) * TD + d] =
          (uint32_t)um[(size_t)i * D + d0 + d] & mask;
    }
  }
  __syncthreads();

  // one warp per cluster, lane = column, every bit in registers
  for (int j = warp; j < K; j += kWarps) {
    const int k = order_s[j];
    const int s = start_s[k], e = start_s[k + 1];
    float tot = 0.f;
    for (int r = s; r < e; ++r) tot += wx_s[r];
    uint32_t mv = 0u;
    if (lane < tw && e - s > bits) {
      const uint32_t* xc = x_s + lane;
      for (int b = bits - 1; b >= 0; --b) {
        const uint32_t thr = mv | (1u << b);
        float cnt = 0.f;
#pragma unroll 4
        for (int r = s; r < e; ++r)
          cnt += xc[(size_t)r * TD] >= thr ? wx_s[r] : 0.f;
        if (cnt * 2.f > tot) mv = thr;
      }
    } else if (lane < tw) {
      // no more members than bits: the largest v with 2 W(x >= v) > total
      // is the largest member word x_j that passes, found in n^2 steps
      const uint32_t* xc = x_s + lane;
      for (int q = s; q < e; ++q) {
        const uint32_t xq = xc[(size_t)q * TD];
        float cnt = 0.f;
        for (int r = s; r < e; ++r)
          cnt += xc[(size_t)r * TD] >= xq ? wx_s[r] : 0.f;
        if (cnt * 2.f > tot) mv = max(mv, xq);
      }
    }
    if (lane < tw) med[((size_t)m * K + k) * D + d0 + lane] = (long long)mv;
    if (blockIdx.x == 0 && lane == 0) totals[(size_t)m * K + k] = tot;
  }
}

// streamed form, one digit [lo, lo + log2(nb)): per chunk of points the
// weighted histogram of the digit over the points still on their
// cluster's median prefix.  The first digit (kFirst) reads the int64
// words, writes their low 32 bits to `words` and, in tile 0, the chunk's
// cluster totals; later digits read `words`.
template <bool kFirst>
__global__ void __launch_bounds__(kStreamThreads)
stream_hist_kernel(const long long* __restrict__ u,
                   uint32_t* __restrict__ words,
                   const int* __restrict__ assign, const float* __restrict__ w,
                   int N, int D, int K, int TD, int chunk, int bits, int lo,
                   int nb, const long long* __restrict__ med,
                   float* __restrict__ part, float* __restrict__ part_tot) {
  extern __shared__ float sh[];
  float* hist_s = sh;                                     // K * nb * TD
  uint32_t* base_s = (uint32_t*)(hist_s + (size_t)K * nb * TD);  // K * TD
  float* tot_s = (float*)(base_s + (size_t)K * TD);       // K

  const int c_idx = blockIdx.x, n_chunks = gridDim.x;
  const int d0 = blockIdx.y * TD;
  const int m = blockIdx.z;
  const int tw = min(TD, D - d0);
  const int tid = threadIdx.x;
  const int i_lo = c_idx * chunk, i_hi = min(N, i_lo + chunk);
  const bool totals_here = kFirst && blockIdx.y == 0;
  const uint32_t mask = low_mask(bits);

  for (int e = tid; e < K * nb * TD; e += kStreamThreads)
    hist_s[e] = 0.f;                             // also 0u for hist_u
  for (int e = tid; e < K * TD; e += kStreamThreads) {
    const int k = e / TD, d = e - k * TD;
    base_s[e] = kFirst || d >= tw
                    ? 0u
                    : (uint32_t)(med[((size_t)m * K + k) * D + d0 + d] >> lo);
  }
  if (totals_here)
    for (int k = tid; k < K; k += kStreamThreads) tot_s[k] = 0.f;
  __syncthreads();

  const int* am = assign + (size_t)m * N;
  const float* wm = w ? w + (size_t)m * N : nullptr;
  // unit weights count in integers (native shared atomics), exact
  uint32_t* hist_u = reinterpret_cast<uint32_t*>(hist_s);
  const int rows = kStreamThreads / TD;
  const int col = tid % TD, row0 = tid / TD;
  if (row0 < rows && col < tw) {
    // kUnroll points' loads in flight before their votes
    for (int i0 = i_lo + row0; i0 < i_hi; i0 += rows * kUnroll) {
      uint32_t x[kUnroll];
      int c[kUnroll];
      float wt[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int i = i0 + j * rows;
        c[j] = -1;
        if (i >= i_hi) continue;
        const size_t off = ((size_t)m * N + i) * D + d0 + col;
        if (kFirst) {
          x[j] = (uint32_t)u[off] & mask;
          words[off] = x[j];
        } else {
          x[j] = words[off];
        }
        c[j] = am[i];
        wt[j] = wm ? wm[i] : 1.f;
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        if (c[j] < 0 || c[j] >= K || wt[j] == 0.f) continue;
        const uint32_t dv = (x[j] >> lo) - base_s[c[j] * TD + col];
        if (dv >= (uint32_t)nb) continue;
        const int e = (c[j] * nb + dv) * TD + col;
        if (wm)
          atomicAdd(&hist_s[e], wt[j]);
        else
          atomicAdd(&hist_u[e], 1u);
      }
    }
  }
  if (totals_here) {
    uint32_t* tot_u = reinterpret_cast<uint32_t*>(tot_s);
    for (int i = i_lo + tid; i < i_hi; i += kStreamThreads) {
      const int c = am[i];
      if (c < 0 || c >= K) continue;
      if (wm)
        atomicAdd(&tot_s[c], wm[i]);
      else
        atomicAdd(&tot_u[c], 1u);
    }
  }
  __syncthreads();

  float* pm = part + ((size_t)m * n_chunks + c_idx) * K * nb * D;
  for (int e = tid; e < K * nb * TD; e += kStreamThreads) {
    const int kv = e / TD, d = e - kv * TD;
    if (d < tw) pm[(size_t)kv * D + d0 + d] = wm ? hist_s[e] : (float)hist_u[e];
  }
  if (totals_here && !wm)
    for (int k = tid; k < K; k += kStreamThreads)
      tot_s[k] = (float)reinterpret_cast<uint32_t*>(tot_s)[k];
  if (totals_here)
    for (int k = tid; k < K; k += kStreamThreads)
      part_tot[((size_t)m * n_chunks + c_idx) * K + k] = tot_s[k];
}

// streamed form, one digit: sum the chunk partials in chunk order and
// choose the digit.  Block (column group, cluster, member); thread (chunk
// group, bin, column) sums one bin over a quarter of the chunks, the
// quarters are added in order, then one thread per column picks the digit.
__global__ void __launch_bounds__(kSelectThreads)
stream_select_kernel(const float* __restrict__ part,
                     const float* __restrict__ part_tot, int K, int D,
                     int n_chunks, int lo, int nb, int first,
                     float* __restrict__ totals, float* __restrict__ above,
                     long long* __restrict__ med) {
  __shared__ float h_s[kSelectGroups][kMaxBins][kSelectCols];
  __shared__ float tot_s[kSelectGroups];
  const int k = blockIdx.y, m = blockIdx.z;
  const int grp = threadIdx.x / (kMaxBins * kSelectCols);
  const int v = threadIdx.x / kSelectCols % kMaxBins;
  const int dd = threadIdx.x % kSelectCols;
  const int d = blockIdx.x * kSelectCols + dd;
  const int per = (n_chunks + kSelectGroups - 1) / kSelectGroups;
  const int c0 = grp * per, c1 = min(n_chunks, c0 + per);
  if (v < nb && d < D) {
    float h = 0.f;
#pragma unroll 8
    for (int c = c0; c < c1; ++c)
      h += part[((((size_t)m * n_chunks + c) * K + k) * nb + v) * D + d];
    h_s[grp][v][dd] = h;
  }
  if (first && v == 0 && dd == 0) {
    float t = 0.f;
    for (int c = c0; c < c1; ++c)
      t += part_tot[((size_t)m * n_chunks + c) * K + k];
    tot_s[grp] = t;
  }
  __syncthreads();
  if (threadIdx.x < kSelectCols && d < D) {
    float tot;
    if (first) {
      tot = 0.f;
#pragma unroll
      for (int g = 0; g < kSelectGroups; ++g) tot += tot_s[g];
      if (blockIdx.x == 0 && dd == 0) totals[(size_t)m * K + k] = tot;
    } else {
      tot = totals[(size_t)m * K + k];
    }
    const size_t e = ((size_t)m * K + k) * D + d;
    // the largest digit whose suffix weight is a majority; digit 0 needs
    // no test.  cum ends as the weight above the chosen digit.
    float cum = first ? 0.f : above[e];
    int vstar = 0;
    for (int vv = nb - 1; vv >= 1; --vv) {
      float hv = 0.f;
#pragma unroll
      for (int g = 0; g < kSelectGroups; ++g) hv += h_s[g][vv][dd];
      const float nxt = cum + hv;
      if (nxt * 2.f > tot) {
        vstar = vv;
        break;
      }
      cum = nxt;
    }
    above[e] = cum;
    med[e] |= (long long)vstar << lo;
  }
}

// The streamed form's scratch, as offsets in 4-byte words: the words' low
// 32 bits (M * N * D) first, then each chunk's digit histograms (M *
// n_chunks * K * kMaxBins * D), each chunk's cluster totals (M * n_chunks
// * K) and the weight above each median prefix (M * K * D); `end` is the
// whole.  The launcher lays the scratch out by it and the wrapper
// allocates what bitserial_median_scratch_bytes returns from it.
struct StreamScratch {
  size_t part, part_tot, above, end;
};

inline StreamScratch stream_scratch(int M, int N, int D, int K, int chunk) {
  const size_t n_chunks = (N + chunk - 1) / chunk;
  StreamScratch l;
  l.part = (size_t)M * N * D;
  l.part_tot = l.part + (size_t)M * n_chunks * K * kMaxBins * D;
  l.above = l.part_tot + (size_t)M * n_chunks * K;
  l.end = l.above + (size_t)M * K * D;
  return l;
}

// shared memory of one streamed histogram block with nb bins
__host__ __device__ inline size_t stream_smem(int K, int TD, int nb) {
  return 4 * ((size_t)K * nb * TD + (size_t)K * TD + K);
}

}  // namespace repro

// Bytes of scratch the streamed form (chunk > 0) needs; 0 for the
// resident form.
extern "C" long long bitserial_median_scratch_bytes(int M, int N, int D,
                                                    int K, int chunk) {
  if (chunk <= 0 || M <= 0 || N <= 0 || D <= 0 || K <= 0) return 0;
  return 4 * (long long)repro::stream_scratch(M, N, D, K, chunk).end;
}

// u (M, N, D) int64 unsigned-ordered words (< 2^32), assign (M, N) int32,
// w (M, N) f32 or null (unit weights) -> med (M, K, D) int64, totals
// (M, K) f32.  chunk == 0: resident form; chunk > 0: streamed form over
// chunks of `chunk` points, with the scratch bitserial_median_scratch_bytes
// gives.
extern "C" int bitserial_median_launch(const void* u, const void* assign,
                                       const void* w, int M, int N, int D,
                                       int K, int bits, int chunk, void* med,
                                       void* totals, void* scratch,
                                       void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || D <= 0 || K <= 0) return 0;
  const int TD = D < 32 ? D : 32;
  const int tiles = (D + TD - 1) / TD;
  auto* u_p = static_cast<const long long*>(u);
  auto* a_p = static_cast<const int*>(assign);
  auto* w_p = static_cast<const float*>(w);
  auto* med_p = static_cast<long long*>(med);
  auto* tot_p = static_cast<float*>(totals);
  if (N <= 0) {
    cudaMemsetAsync(med_p, 0, sizeof(long long) * (size_t)M * K * D, s);
    cudaMemsetAsync(tot_p, 0, sizeof(float) * (size_t)M * K, s);
    return (int)cudaGetLastError();
  }
  if (chunk == 0) {
    const size_t smem =
        4 * ((size_t)N * TD + 3 * (size_t)N + 2 * (size_t)K + 1);
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(resident_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    resident_kernel<<<dim3(tiles, M), kThreads, smem, s>>>(
        u_p, a_p, w_p, N, D, K, bits, TD, med_p, tot_p);
    return (int)cudaGetLastError();
  }
  // the widest digit whose histogram fits a block's shared memory
  int r = kMaxDigit;
  while (r > 1 && stream_smem(K, TD, 1 << r) > 100 * 1024) --r;
  const size_t smem_max = stream_smem(K, TD, 1 << r);
  if (smem_max > 232448) return (int)cudaErrorInvalidValue;
  const int n_chunks = (N + chunk - 1) / chunk;
  const StreamScratch l = stream_scratch(M, N, D, K, chunk);
  uint32_t* words = static_cast<uint32_t*>(scratch);
  float* part = reinterpret_cast<float*>(words + l.part);
  float* part_tot = reinterpret_cast<float*>(words + l.part_tot);
  float* above = reinterpret_cast<float*>(words + l.above);
  if (smem_max > 48 * 1024) {
    cudaFuncSetAttribute(stream_hist_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem_max);
    cudaFuncSetAttribute(stream_hist_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem_max);
  }
  cudaMemsetAsync(med_p, 0, sizeof(long long) * (size_t)M * K * D, s);
  const dim3 grid(n_chunks, tiles, M);
  const dim3 sel_grid((D + kSelectCols - 1) / kSelectCols, K, M);
  for (int hi = bits; hi > 0;) {
    const int lo = hi > r ? hi - r : 0;
    const int nb = 1 << (hi - lo);
    const bool first = hi == bits;
    const size_t smem = stream_smem(K, TD, nb);
    if (first)
      stream_hist_kernel<true><<<grid, kStreamThreads, smem, s>>>(
          u_p, words, a_p, w_p, N, D, K, TD, chunk, bits, lo, nb, med_p, part,
          part_tot);
    else
      stream_hist_kernel<false><<<grid, kStreamThreads, smem, s>>>(
          u_p, words, a_p, w_p, N, D, K, TD, chunk, bits, lo, nb, med_p, part,
          part_tot);
    stream_select_kernel<<<sel_grid, kSelectThreads, 0, s>>>(
        part, part_tot, K, D, n_chunks, lo, nb, first, tot_p, above, med_p);
    hi = lo;
  }
  return (int)cudaGetLastError();
}
