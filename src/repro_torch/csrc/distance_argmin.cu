// distance_argmin: closest centroid per point (the clustering assignment
// step) for Hopper (sm_90a).
//
// Replaces the TPU kernels _kernel_l2 and _kernel_l1 of
// src/repro/kernels/distance_argmin.py (launched by distance_argmin_pallas):
// for every point, the index of the nearest centroid and its distance.
// L2 is the squared distance by the reference's expansion and clamp,
// max(|x|^2 - 2 x.c + |c|^2, 0), so both find the same minima; L1 is
// sum |x - c|.  Ties keep the first index: a centroid replaces the best
// only if strictly closer.
//
// What bounds it on this card: operations.  Each point is read once
// (D floats) and compared with all K centroids, K * (2D + 3) flops for L2
// and 3 K D for L1 per 4 D + 8 bytes, which at K = 64 is well above the
// card's f32 flop per byte balance.  So the design keeps the operands in
// on-chip memory: the (K, D) centroids (and |c|^2) are loaded into shared
// memory once per block of 256 points, each point is staged in shared
// memory with an odd stride (no bank conflicts), and one thread walks the
// centroids for its point with f32 FMAs.  K * D * 4 bytes must fit in
// shared memory; the wrapper refuses larger banks.

#include <cuda_runtime.h>
#include <math.h>

namespace repro {

constexpr int kPoints = 256;  // points (threads) per block

template <int kL1>
__global__ void __launch_bounds__(kPoints)
distance_argmin_kernel(const float* __restrict__ x,
                       const float* __restrict__ cents, int N, int K, int D,
                       int* __restrict__ assign, float* __restrict__ mind) {
  extern __shared__ float smem[];
  const int xs = D | 1;                  // odd stride: conflict-free rows
  float* c_s = smem;                     // K * D
  float* c2_s = c_s + K * D;             // K
  float* x_s = c2_s + K;                 // kPoints * xs
  const size_t base = (size_t)blockIdx.x * kPoints;

  for (int i = threadIdx.x; i < K * D; i += kPoints) c_s[i] = cents[i];
  for (int i = threadIdx.x; i < kPoints * D; i += kPoints) {
    const int p = i / D, d = i % D;
    const size_t n = base + p;
    x_s[p * xs + d] = n < (size_t)N ? x[n * D + d] : 0.f;
  }
  __syncthreads();
  if (!kL1) {
    for (int k = threadIdx.x; k < K; k += kPoints) {
      float c2 = 0.f;
      for (int d = 0; d < D; ++d) c2 = fmaf(c_s[k * D + d], c_s[k * D + d], c2);
      c2_s[k] = c2;
    }
    __syncthreads();
  }

  const size_t n = base + threadIdx.x;
  if (n >= (size_t)N) return;
  const float* xp = x_s + threadIdx.x * xs;
  float best = INFINITY;
  int best_k = 0;
  if (kL1) {
    for (int k = 0; k < K; ++k) {
      const float* c = c_s + k * D;
      float dist = 0.f;
      for (int d = 0; d < D; ++d) dist += fabsf(xp[d] - c[d]);
      if (dist < best) {
        best = dist;
        best_k = k;
      }
    }
  } else {
    float x2 = 0.f;
    for (int d = 0; d < D; ++d) x2 = fmaf(xp[d], xp[d], x2);
    for (int k = 0; k < K; ++k) {
      const float* c = c_s + k * D;
      float xc = 0.f;
      for (int d = 0; d < D; ++d) xc = fmaf(xp[d], c[d], xc);
      const float dist = fmaxf(x2 - 2.f * xc + c2_s[k], 0.f);
      if (dist < best) {
        best = dist;
        best_k = k;
      }
    }
  }
  assign[n] = best_k;
  mind[n] = best;
}

}  // namespace repro

// metric: 0 = squared L2, 1 = L1.  x (N, D) f32, cents (K, D) f32 ->
// assign (N,) int32, mind (N,) f32.
extern "C" int distance_argmin_launch(int metric, const void* x,
                                      const void* cents, int N, int K, int D,
                                      void* assign, void* mind, void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)K * D + K + (size_t)repro::kPoints * (D | 1));
  if (N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (N + repro::kPoints - 1) / repro::kPoints;
  if (metric == 1) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(repro::distance_argmin_kernel<1>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    repro::distance_argmin_kernel<1><<<grid, repro::kPoints, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(cents), N, K,
        D, static_cast<int*>(assign), static_cast<float*>(mind));
  } else {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(repro::distance_argmin_kernel<0>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    repro::distance_argmin_kernel<0><<<grid, repro::kPoints, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(cents), N, K,
        D, static_cast<int*>(assign), static_cast<float*>(mind));
  }
  return (int)cudaGetLastError();
}
