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
// equivalent radix-select form, which needs no per-point state: before bit
// b a point is still active iff its word's bits above b equal its
// cluster's median prefix; otherwise it votes 1 when its prefix is greater
// than the median's and 0 when it is smaller (the bit it deviated on).
//
// Exactness: votes are summed in f32 by shared-memory atomic adds, in no
// fixed order within a block.  With integer-valued weights whose totals
// lie below 2^24 (unit weights, 0/1 masks, cluster counts: every caller in
// the repository) every summation order gives the same bits, so the result
// equals the plain version (core/bitserial.py) bit for bit and is the same
// from run to run.  Other weights may round differently in the last place.
//
// Two forms, chosen by the wrapper (kernels/bitserial_median.py):
//  * resident (chunk == 0): one block per (member, tile of TD <= 32
//    columns).  The member's N x TD words are staged in shared memory once
//    (low 32 bits of the int64 words, no copy of the tensor first) with the
//    assignments, weights, (K, TD) counts and the median prefix; all `bits`
//    passes run against the resident tile.  This is the TPU kernel's own
//    idea and covers the serve's absorb and compaction (N = 320, D = 128).
//  * streamed (chunk > 0), for N too large to stage: per bit one launch
//    over (chunk of points, tile, member) blocks, each writing its partial
//    (K, TD) counts to a scratch buffer, then one launch that sums the
//    partials of every chunk in a fixed order and sets the median bit.
//
// What bounds it: the vote loop, N * D * bits compare-and-add steps on the
// ALU and the shared-memory atomics; the words are read from device memory
// once (resident) or once per bit (streamed).

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int kThreads = 256;

// the vote of word x at bit b against its cluster's median prefix m (bits
// <= b of m are still 0); hi = mask of the bits above b
__device__ __forceinline__ bool vote(uint32_t x, uint32_t m, uint32_t hi,
                                     int b) {
  const uint32_t xp = x & hi;
  return xp == m ? ((x >> b) & 1u) != 0u : xp > m;
}

__device__ __forceinline__ uint32_t above(int b) {
  return (uint32_t)(0xFFFFFFFFull << (b + 1));
}

__global__ void __launch_bounds__(kThreads)
resident_kernel(const long long* __restrict__ u, const int* __restrict__ assign,
                const float* __restrict__ w, int N, int D, int K, int bits,
                int TD, long long* __restrict__ med,
                float* __restrict__ totals) {
  extern __shared__ uint32_t smem[];
  uint32_t* u_s = smem;                         // N * TD words
  uint32_t* med_s = u_s + (size_t)N * TD;       // K * TD prefix
  float* cnt_s = (float*)(med_s + K * TD);      // K * TD vote counts
  float* tot_s = cnt_s + K * TD;                // K totals
  int* a_s = (int*)(tot_s + K);                 // N assignments
  float* w_s = (float*)(a_s + N);               // N weights

  const int m = blockIdx.y;
  const int d0 = blockIdx.x * TD;
  const int tw = min(TD, D - d0);
  const int tid = threadIdx.x;
  const long long* um = u + (size_t)m * N * D;
  // each thread keeps one column and strides over the rows
  const int rows = kThreads / TD;
  const int col = tid % TD, row0 = tid / TD;
  const bool lane_on = row0 < rows && col < tw;

  for (int i = tid; i < N; i += kThreads) {
    a_s[i] = assign[(size_t)m * N + i];
    w_s[i] = w ? w[(size_t)m * N + i] : 1.f;
  }
  for (int e = tid; e < N * TD; e += kThreads) {
    const int i = e / TD, d = e - i * TD;
    u_s[e] = d < tw ? (uint32_t)um[(size_t)i * D + d0 + d] : 0u;
  }
  for (int e = tid; e < K * TD; e += kThreads) med_s[e] = 0u;
  for (int k = tid; k < K; k += kThreads) tot_s[k] = 0.f;
  __syncthreads();
  for (int i = tid; i < N; i += kThreads) {
    const int c = a_s[i];
    if (c >= 0 && c < K) atomicAdd(&tot_s[c], w_s[i]);
  }

  for (int b = bits - 1; b >= 0; --b) {
    for (int e = tid; e < K * TD; e += kThreads) cnt_s[e] = 0.f;
    __syncthreads();
    const uint32_t hi = above(b);
    if (lane_on) {
      for (int i = row0; i < N; i += rows) {
        const int c = a_s[i];
        if (c < 0 || c >= K) continue;
        if (vote(u_s[i * TD + col], med_s[c * TD + col], hi, b))
          atomicAdd(&cnt_s[c * TD + col], w_s[i]);
      }
    }
    __syncthreads();
    for (int e = tid; e < K * TD; e += kThreads) {
      if (cnt_s[e] * 2.f > tot_s[e / TD]) med_s[e] |= 1u << b;
    }
    __syncthreads();
  }

  for (int e = tid; e < K * TD; e += kThreads) {
    const int k = e / TD, d = e - k * TD;
    if (d < tw) med[((size_t)m * K + k) * D + d0 + d] = (long long)med_s[e];
  }
  if (blockIdx.x == 0)
    for (int k = tid; k < K; k += kThreads) totals[(size_t)m * K + k] = tot_s[k];
}

// streamed form, one bit: partial counts of one chunk of points.  With
// `with_totals` (the first bit) tile 0 also writes the chunk's totals.
__global__ void __launch_bounds__(kThreads)
stream_count_kernel(const long long* __restrict__ u,
                    const int* __restrict__ assign,
                    const float* __restrict__ w, int N, int D, int K, int TD,
                    int chunk, int b, const long long* __restrict__ med,
                    float* __restrict__ part, float* __restrict__ part_tot,
                    int with_totals) {
  extern __shared__ uint32_t smem[];
  uint32_t* med_s = smem;                       // K * TD prefix
  float* cnt_s = (float*)(med_s + K * TD);      // K * TD
  float* tot_s = cnt_s + K * TD;                // K

  const int c_idx = blockIdx.x, n_chunks = gridDim.x;
  const int d0 = blockIdx.y * TD;
  const int m = blockIdx.z;
  const int tw = min(TD, D - d0);
  const int tid = threadIdx.x;
  const int rows = kThreads / TD;
  const int col = tid % TD, row0 = tid / TD;
  const int i_lo = c_idx * chunk, i_hi = min(N, i_lo + chunk);
  const bool totals_here = with_totals && blockIdx.y == 0;

  for (int e = tid; e < K * TD; e += kThreads) {
    const int k = e / TD, d = e - k * TD;
    med_s[e] = d < tw ? (uint32_t)med[((size_t)m * K + k) * D + d0 + d] : 0u;
    cnt_s[e] = 0.f;
  }
  for (int k = tid; k < K; k += kThreads) tot_s[k] = 0.f;
  __syncthreads();

  const long long* um = u + (size_t)m * N * D;
  const int* am = assign + (size_t)m * N;
  const float* wm = w ? w + (size_t)m * N : nullptr;
  const uint32_t hi = above(b);
  if (row0 < rows && col < tw) {
    for (int i = i_lo + row0; i < i_hi; i += rows) {
      const int c = am[i];
      if (c < 0 || c >= K) continue;
      const float wt = wm ? wm[i] : 1.f;
      if (vote((uint32_t)um[(size_t)i * D + d0 + col], med_s[c * TD + col], hi,
               b))
        atomicAdd(&cnt_s[c * TD + col], wt);
    }
  }
  if (totals_here) {
    for (int i = i_lo + tid; i < i_hi; i += kThreads) {
      const int c = am[i];
      if (c >= 0 && c < K) atomicAdd(&tot_s[c], wm ? wm[i] : 1.f);
    }
  }
  __syncthreads();

  float* pm = part + ((size_t)m * n_chunks + c_idx) * K * D;
  for (int e = tid; e < K * TD; e += kThreads) {
    const int k = e / TD, d = e - k * TD;
    if (d < tw) pm[(size_t)k * D + d0 + d] = cnt_s[e];
  }
  if (totals_here)
    for (int k = tid; k < K; k += kThreads)
      part_tot[((size_t)m * n_chunks + c_idx) * K + k] = tot_s[k];
}

// totals[m, k] = sum over chunks, in chunk order
__global__ void stream_totals_kernel(const float* __restrict__ part_tot,
                                     int M, int K, int n_chunks,
                                     float* __restrict__ totals) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= M * K) return;
  const int m = e / K, k = e - m * K;
  float t = 0.f;
  for (int c = 0; c < n_chunks; ++c)
    t += part_tot[((size_t)m * n_chunks + c) * K + k];
  totals[e] = t;
}

// cnt1[m, k, d] = sum over chunks, in chunk order; set the median bit
__global__ void stream_reduce_kernel(const float* __restrict__ part,
                                     const float* __restrict__ totals, int M,
                                     int K, int D, int n_chunks, int b,
                                     long long* __restrict__ med) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t kd = (size_t)K * D;
  if (e >= (size_t)M * kd) return;
  const size_t m = e / kd, r = e - m * kd;
  float cnt = 0.f;
  for (int c = 0; c < n_chunks; ++c) cnt += part[(m * n_chunks + c) * kd + r];
  if (cnt * 2.f > totals[m * K + r / D]) med[e] |= 1ll << b;
}

}  // namespace repro

// u (M, N, D) int64 unsigned-ordered words (< 2^32), assign (M, N) int32,
// w (M, N) f32 or null (unit weights) -> med (M, K, D) int64, totals
// (M, K) f32.  chunk == 0: resident form; chunk > 0: streamed form over
// chunks of `chunk` points, with scratch of M * ceil(N / chunk) * K * (D + 1)
// floats.
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
  cudaMemsetAsync(med_p, 0, sizeof(long long) * (size_t)M * K * D, s);
  if (N <= 0) {
    cudaMemsetAsync(tot_p, 0, sizeof(float) * (size_t)M * K, s);
    return (int)cudaGetLastError();
  }
  if (chunk == 0) {
    const size_t smem = 4 * ((size_t)N * TD + 2 * (size_t)K * TD + K + 2 * N);
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(resident_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    resident_kernel<<<dim3(tiles, M), kThreads, smem, s>>>(
        u_p, a_p, w_p, N, D, K, bits, TD, med_p, tot_p);
    return (int)cudaGetLastError();
  }
  const int n_chunks = (N + chunk - 1) / chunk;
  float* part = static_cast<float*>(scratch);
  float* part_tot = part + (size_t)M * n_chunks * K * D;
  const size_t smem = 4 * (2 * (size_t)K * TD + K);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(stream_count_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  const size_t n_out = (size_t)M * K * D;
  const int red_blocks = (int)((n_out + kThreads - 1) / kThreads);
  for (int b = bits - 1; b >= 0; --b) {
    const int first = b == bits - 1;
    stream_count_kernel<<<dim3(n_chunks, tiles, M), kThreads, smem, s>>>(
        u_p, a_p, w_p, N, D, K, TD, chunk, b, med_p, part, part_tot, first);
    if (first)
      stream_totals_kernel<<<(M * K + kThreads - 1) / kThreads, kThreads, 0,
                             s>>>(part_tot, M, K, n_chunks, tot_p);
    stream_reduce_kernel<<<red_blocks, kThreads, 0, s>>>(
        part, tot_p, M, K, D, n_chunks, b, med_p);
  }
  return (int)cudaGetLastError();
}
