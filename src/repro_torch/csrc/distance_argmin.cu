// distance_argmin: closest centroid per point (the clustering assignment
// step) for Hopper (sm_90a).
//
// Replaces the TPU kernels _kernel_l2 and _kernel_l1 of
// src/repro/kernels/distance_argmin.py (launched by distance_argmin_pallas):
// for every point, the index of the nearest centroid and its distance.
// L2 is the squared distance by the reference's expansion and clamp,
// max(|x|^2 - 2 x.c + |c|^2, 0); L1 is sum |x - c|.  Ties keep the first
// index, a NaN distance never wins (L2's clamp, fmaxf, turns a NaN into
// 0 first), and a row with no finite distance gives (inf, 0).
//
// What bounds it on this card: FP32 instructions issued.  Per (point,
// centroid) L1 issues 2D + 1 (a subtract and an add with |.| folded into
// it per dim, the compare) and L2 D + 4 (one FFMA per dim; x2 - 2 xc, the
// add of |c|^2, the clamp, the compare) against 4 D + 8 bytes per point
// read once, far above the card's FP32 operation-per-byte balance at
// K = 64.  The FP32 pipe issues one warp instruction a cycle per SM
// sub-partition, so every other instruction in the inner loop costs the
// same as an FP32 one: shared-memory loads must not set the pace.
//
// Design: an SGEMM-shaped SIMT tile with an argmin for its epilogue.  The
// grid is persistent (as many blocks as fit on the card at once); a block
// of 128 threads walks point tiles of 128, and for each the centroids in
// tiles of 64, each tile's dims in chunks of up to 16.  Chunks are staged
// d-major in shared memory by 4-byte cp.async (zero-filled past the N, K
// and D edges; neighbouring threads read neighbouring words),
// double-buffered: the next iteration's copies (chunk, centroid tile or
// point tile) are in flight while this one computes, so the stream of
// points does not wait on cold loads.  Each thread keeps an 8 x 8
// micro-tile of accumulators in registers: per dim it reads two float4 of
// points and two float4 of centroids (a warp's loads are contiguous, so
// conflict-free) and issues 64 FP32 operations from them.  The footprint
// depends on the tile only, never on K or D, so any bank runs.  Widths 8,
// 12 and 16 (the fits' and the quickstart's) are compiled with a constant
// D: one chunk, each point tile staged once, and a bank of at most 64
// centroids staged once per block.  Every other width takes the runtime-D
// form of the same tile, which stages the points again for each centroid
// tile.  The runtime-D form alone, on an H100 80GB HBM3 at 700 W, was 5 %
// slower in L1 and 18 % in L2 at 2^20 x 16, K = 64, and 0.1-0.4 us a
// launch slower at the quickstart's 4,595 x 12 and 5,000 x 8 (PERF.md).
//
// Exactness: every (point, centroid) distance is one sequential chain over
// d = 0 .. D-1 with the operations of the first one-thread-per-point
// design (dist += fabsf(x - c); fmaf chains for x.c, |x|^2, |c|^2), so
// assign and mind are bit-equal to it.  Chunks are walked in order, and
// zero-padded dims add exactly 0.  A thread walks its centroids in
// increasing index with a strict <, starting from (inf, 0); the eight
// threads that share a point merge their (distance, index) pairs with
// the smaller distance winning and the smaller index breaking a tie,
// which is the sequential first-minimum rule.

#include <cuda_runtime.h>
#include <math.h>

namespace repro {

constexpr int kThreads = 128;          // threads per block: 16 x 8 groups
constexpr int kTP = 8;                 // points per thread (8 lanes share them)
constexpr int kTC = 8;                 // centroids per thread
constexpr int kPts = 16 * kTP;         // points per block, one per thread
constexpr int kCents = 8 * kTC;        // centroids per tile
constexpr int kChunk = 16;             // dims per staged chunk, at most
constexpr int kXStride = kPts + 4;     // padded d-major rows, 16-byte aligned
constexpr int kCStride = kCents + 4;
static_assert(kPts == kThreads && kCents * 2 == kThreads, "tile shape");

struct DistanceSmem {
  float x[2][kChunk][kXStride];        // two stages of a point chunk
  float c[2][kChunk][kCStride];        // two stages of a centroid chunk
  float x2[kPts];                      // |x|^2 of the block's points (L2)
  float c2[kCents];                    // |c|^2 of the tile's centroids (L2)
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Stage rows [row0, row0 + kRows) and dims [d0, d0 + kW) of a row-major
// (n_rows, D) matrix d-major into dst (row stride kStride), zero-filled past
// its edges (a zero-filled copy reads nothing at its source address).
// Neighbouring threads read neighbouring words.  kDense: D == kW, so the
// chunk is one contiguous run; else kW divides the block.
template <int kRows, int kW, int kStride, bool kDense>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      int n_rows, int D, int row0, int d0) {
  constexpr int kPer = kRows * kW / kThreads;
  static_assert(kPer * kThreads == kRows * kW, "tile shape");
  if constexpr (kDense) {
    const int lim = min(n_rows - row0, kRows) * kW;
    const float* s = src + (size_t)row0 * kW;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int e = r * kThreads + threadIdx.x;
      cp_async4(dst + (e % kW) * kStride + e / kW, s + e, e < lim);
    }
  } else {
    static_assert(kThreads % kW == 0, "tile shape");
    constexpr int kStep = kThreads / kW;
    const int d = threadIdx.x % kW, row = threadIdx.x / kW;
    const bool d_ok = d0 + d < D;
    const float* s = src + (size_t)(row0 + row) * D + d0 + d;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const bool ok = d_ok && row0 + row + r * kStep < n_rows;
      cp_async4(dst + d * kStride + row + r * kStep, s + (size_t)r * kStep * D,
                ok);
    }
  }
}

// (d, i) <- (d2, i2) if the latter is smaller, ties to the smaller index.
__device__ __forceinline__ void take_smaller(float& d, int& i, float d2,
                                             int i2) {
  if (d2 < d || (d2 == d && i2 < i)) {
    d = d2;
    i = i2;
  }
}

// One step of the merge across the eight lanes that share points: lane
// pairs `bit` apart split the 2 kH slots they hold, each keeping the
// smaller (distance, index) of its kH slots, moved to slots 0 .. kH-1.
template <int kH, int kN>
__device__ __forceinline__ void halve(float (&best_d)[kN], int (&best_i)[kN],
                                      bool upper, int bit) {
#pragma unroll
  for (int q = 0; q < kH; ++q) {
    float keep_d = upper ? best_d[q + kH] : best_d[q];
    int keep_i = upper ? best_i[q + kH] : best_i[q];
    const float send_d = upper ? best_d[q] : best_d[q + kH];
    const int send_i = upper ? best_i[q] : best_i[q + kH];
    take_smaller(keep_d, keep_i, __shfl_xor_sync(0xffffffffu, send_d, bit),
                 __shfl_xor_sync(0xffffffffu, send_i, bit));
    best_d[q] = keep_d;
    best_i[q] = keep_i;
  }
}

// A thread's point slot i is block point (i / 4) * 64 + pr + i % 4, its
// centroid slot j tile centroid (j / 4) * 32 + cr + j % 4: runs of four,
// so each is one float4 load, and a warp's loads are contiguous.
__device__ __forceinline__ int point_of(int i, int pr) {
  return (i / 4) * 64 + pr + i % 4;
}
__device__ __forceinline__ int cent_of(int j, int cr) {
  return (j / 4) * 32 + cr + j % 4;
}

// kL1: 1 = L1, 0 = squared L2.  kD: the width, staged as one chunk; 0: a
// runtime D walked in chunks of kChunk.  A block walks point tiles
// blockIdx.x, blockIdx.x + gridDim.x, ...; for each, the centroid tiles,
// and for each of those the chunks: one iteration per (point tile,
// centroid tile, chunk), whose successor's copies are in flight while it
// computes.
template <int kL1, int kD>
__global__ void __launch_bounds__(kThreads, 3)
distance_argmin_kernel(const float* __restrict__ x,
                       const float* __restrict__ cents, int N, int K, int D,
                       int* __restrict__ assign, float* __restrict__ mind) {
  constexpr bool kOne = kD != 0;         // one chunk holds every dim
  constexpr int kW = kOne ? kD : kChunk;  // staged width of a chunk
  __shared__ __align__(16) DistanceSmem sm;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int cg = lane & 7;                             // centroid group
  const int pr = ((tid >> 5) * 4 + (lane >> 3)) * 4;   // point group * 4
  const int cr = cg * 4;
  const int n_chunks = kOne ? 1 : max(1, (D + kChunk - 1) / kChunk);
  // K = 0 is one tile of dead centroids: every row gives (inf, 0)
  const int n_tiles = max(1, (K + kCents - 1) / kCents);
  const int per_pt = n_tiles * n_chunks;   // iterations per point tile
  const int n_pt = (N + kPts - 1) / kPts;
  const int my_pt = n_pt > (int)blockIdx.x
      ? (n_pt - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x : 0;
  const int n_iter = my_pt * per_pt;
  // a bank of one tile and one chunk is staged once and stays
  const bool c_resident = kOne && n_tiles == 1;

  // Issue iteration j's copies: its points at the start of a point tile
  // (every chunk for a runtime D), its centroids unless resident.
  auto stage_iter = [&](int j) {
    const int lp = j / per_pt, r = j - lp * per_pt;
    const int kt = r / n_chunks, d0 = (r - kt * n_chunks) * kW;
    if (!kOne || r == 0)
      stage<kPts, kW, kXStride, kOne>(&sm.x[kOne ? lp & 1 : j & 1][0][0], x,
                                      N, D,
                                      ((int)blockIdx.x + lp * (int)gridDim.x)
                                          * kPts, d0);
    if (!c_resident || j == 0)
      stage<kCents, kW, kCStride, kOne>(&sm.c[c_resident ? 0 : j & 1][0][0],
                                        cents, K, D, kt * kCents, d0);
  };

  float best_d[kTP];
  int best_i[kTP];
#pragma unroll
  for (int i = 0; i < kTP; ++i) {
    best_d[i] = INFINITY;
    best_i[i] = 0;
  }
  float acc[kTP][kTC];
  float x2r = 0.f, c2r = 0.f;  // |x|^2 of point tid, |c|^2 of centroid tid

  if (n_iter > 0) stage_iter(0);
  cp_async_commit();
  for (int it = 0; it < n_iter; ++it) {
    const int lp = it / per_pt, r = it - lp * per_pt;
    const int kt = r / n_chunks, ch = r - kt * n_chunks;
    if (it + 1 < n_iter) {
      stage_iter(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int xb = kOne ? lp & 1 : it & 1, cb = c_resident ? 0 : it & 1;
    const int width = kOne ? kD : min(kChunk, D - ch * kChunk);
    const bool new_c2 = !c_resident || it == 0;  // |c|^2 of this tile due
    if (!kL1) {
      // the norms' chains, one thread per point and per centroid, before
      // the tile's accumulators come to life
      if (r == 0) x2r = 0.f;
      if (ch == 0) c2r = 0.f;
      if (kt == 0)
        for (int d = 0; d < width; ++d)
          x2r = fmaf(sm.x[xb][d][tid], sm.x[xb][d][tid], x2r);
      if (new_c2 && tid < kCents)
        for (int d = 0; d < width; ++d)
          c2r = fmaf(sm.c[cb][d][tid], sm.c[cb][d][tid], c2r);
    }
    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < kTP; ++i)
#pragma unroll
        for (int j = 0; j < kTC; ++j) acc[i][j] = 0.f;
    }
#pragma unroll 2
    for (int d = 0; d < kW; ++d) {
      if (!kOne && d >= width) break;
      float xv[kTP], cv[kTC];
#pragma unroll
      for (int i = 0; i < kTP; i += 4) {
        const float4 v =
            *reinterpret_cast<const float4*>(&sm.x[xb][d][point_of(i, pr)]);
        xv[i] = v.x, xv[i + 1] = v.y, xv[i + 2] = v.z, xv[i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < kTC; j += 4) {
        const float4 v =
            *reinterpret_cast<const float4*>(&sm.c[cb][d][cent_of(j, cr)]);
        cv[j] = v.x, cv[j + 1] = v.y, cv[j + 2] = v.z, cv[j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < kTP; ++i)
#pragma unroll
        for (int j = 0; j < kTC; ++j) {
          if (kL1)
            acc[i][j] += fabsf(xv[i] - cv[j]);
          else
            acc[i][j] = fmaf(xv[i], cv[j], acc[i][j]);
        }
    }
    if (ch == n_chunks - 1) {
      // the tile's last chunk: finish its distances, fold into the best
      if (!kL1) {
        if (kt == 0) sm.x2[tid] = x2r;
        if (new_c2 && tid < kCents) sm.c2[tid] = c2r;
        __syncthreads();
      }
      float x2v[kTP];
#pragma unroll
      for (int i = 0; i < kTP; ++i) x2v[i] = kL1 ? 0.f : sm.x2[point_of(i, pr)];
      const int k0 = kt * kCents;
#pragma unroll
      for (int j = 0; j < kTC; ++j) {  // increasing centroid index
        const int k = k0 + cent_of(j, cr);
        const bool live = k < K;
        const float c2 = kL1 ? 0.f : sm.c2[cent_of(j, cr)];
#pragma unroll
        for (int i = 0; i < kTP; ++i) {
          const float dist =
              kL1 ? acc[i][j]
                  : fmaxf(fmaf(-2.f, acc[i][j], x2v[i]) + c2, 0.f);
          const bool better = live && dist < best_d[i];
          best_d[i] = better ? dist : best_d[i];
          best_i[i] = better ? k : best_i[i];
        }
      }
    }
    if (r == per_pt - 1) {
      // The point tile is done.  The eight lanes of a centroid group's row
      // share its eight points: halve the slots each lane holds at each
      // step, so lane cg ends with slot cg; then start the next tile.
      halve<4>(best_d, best_i, cg & 4, 4);
      halve<2>(best_d, best_i, cg & 2, 2);
      halve<1>(best_d, best_i, cg & 1, 1);
      const int n = ((int)blockIdx.x + lp * (int)gridDim.x) * kPts
                    + point_of(cg, pr);
      if (n < N) {
        assign[n] = best_i[0];
        mind[n] = best_d[0];
      }
#pragma unroll
      for (int i = 0; i < kTP; ++i) {
        best_d[i] = INFINITY;
        best_i[i] = 0;
      }
    }
    __syncthreads();
  }
}

// One launch of a persistent grid: as many blocks as fit on the card at
// once (queried once per kernel), fewer when there are fewer point tiles.
template <int kL1, int kD>
static void launch_width(const float* x, const float* cents, int N, int K,
                         int D, int* assign, float* mind, cudaStream_t s) {
  static int max_grid = 0;
  if (max_grid == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, distance_argmin_kernel<kL1, kD>, kThreads, 0);
    max_grid = max(1, sms * per_sm);
  }
  const int grid = min((N + kPts - 1) / kPts, max_grid);
  distance_argmin_kernel<kL1, kD><<<grid, kThreads, 0, s>>>(x, cents, N, K,
                                                            D, assign, mind);
}

template <int kL1>
static void launch_metric(const float* x, const float* cents, int N, int K,
                          int D, int* assign, float* mind, cudaStream_t s) {
  switch (D) {
    case 8:
      launch_width<kL1, 8>(x, cents, N, K, D, assign, mind, s);
      break;
    case 12:
      launch_width<kL1, 12>(x, cents, N, K, D, assign, mind, s);
      break;
    case 16:
      launch_width<kL1, 16>(x, cents, N, K, D, assign, mind, s);
      break;
    default:
      launch_width<kL1, 0>(x, cents, N, K, D, assign, mind, s);
  }
}

}  // namespace repro

// metric: 0 = squared L2, 1 = L1.  x (N, D) f32, cents (K, D) f32 ->
// assign (N,) int32, mind (N,) f32.
extern "C" int distance_argmin_launch(int metric, const void* x,
                                      const void* cents, int N, int K, int D,
                                      void* assign, void* mind, void* stream) {
  if (N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* cf = static_cast<const float*>(cents);
  if (metric == 1)
    repro::launch_metric<1>(xf, cf, N, K, D, static_cast<int*>(assign),
                            static_cast<float*>(mind), s);
  else
    repro::launch_metric<0>(xf, cf, N, K, D, static_cast<int*>(assign),
                            static_cast<float*>(mind), s);
  return (int)cudaGetLastError();
}

// Shared memory of one block, in bytes: the same for every K and D.
extern "C" long long distance_argmin_shared_bytes() {
  return (long long)sizeof(repro::DistanceSmem);
}
