// flash_decode: one-token exact GQA attention over a (B, S, Hkv, Dh) cache
// for Hopper (sm_90a).
//
// Replaces the TPU kernel _kernel of src/repro/kernels/flash_decode.py
// (launched by flash_decode_pallas): each query head attends to the cache
// positions < t of its kv head, scores scaled, then soft-capped when a cap
// is given, positions >= t masked with NEG = -1e30 (never -inf), output
// acc / max(l, 1e-30) in q's dtype.  The cache is read in chunks of
// `chunk` positions; positions past S count as zero keys and values, as
// the reference's zero padding does.
//
// The TPU grid walks the chunks of one (batch, kv head) in sequence with
// the online-softmax state (m, l, acc) in VMEM.  On the card the chunks
// are independent blocks (flash-decoding): block (chunk, kv head, batch)
// computes its chunk's G = Hq / Hkv score rows into shared memory, their
// max m_c, l_c = sum exp(s - m_c) and acc_c = sum exp(s - m_c) v, all in
// f32, and writes them to a scratch buffer; a second launch merges the
// chunks of each query head in chunk order: M = max m_c, weights
// exp(m_c - M).  The result equals the sequential online softmax up to f32
// rounding.
//
// What bounds it: bytes.  Each (batch, kv head) reads its S keys and
// values once, 2 * Dh flops per (query head, position) for q . k and as
// many for p . v, far below the card's f32 flop per byte balance.  One
// warp scores one position at a time (lanes split Dh, shuffles reduce);
// one thread per head dim accumulates p . v.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace repro {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;       // query heads per kv head
constexpr int kMaxDh = 256;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float x, float* y) { *y = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* y) {
  *y = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, int S, int Hq, int Hkv, int Dh,
             int chunk, int t, float scale, float softcap,
             float* __restrict__ part_ml, float* __restrict__ part_acc) {
  extern __shared__ float smem[];
  const int G = Hq / Hkv;
  float* q_s = smem;                 // G * Dh
  float* s_s = q_s + G * Dh;         // G * chunk scores, then probabilities
  float* m_s = s_s + G * chunk;      // G
  float* l_s = m_s + G;              // G
  const int c = blockIdx.x, nc = gridDim.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int e = tid; e < G * Dh; e += kThreads)
    q_s[e] = to_f(q[((size_t)b * Hq + h * G) * Dh + e]);
  __syncthreads();

  // scores: one warp per position
  for (int p = warp; p < chunk; p += kWarps) {
    const int pos = c * chunk + p;
    float acc[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
    if (pos < S) {
      const T* kr = k + (((size_t)b * S + pos) * Hkv + h) * Dh;
      for (int d = lane; d < Dh; d += 32) {
        const float kd = to_f(kr[d]);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) acc[g] = fmaf(q_s[g * Dh + d], kd, acc[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      float x = acc[g];
      for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      if (lane == 0) {
        float s = x * scale;
        if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
        s_s[g * chunk + p] = pos < t ? s : kNeg;
      }
    }
  }
  __syncthreads();

  // per query head: max, then probabilities and their sum
  for (int g = warp; g < G; g += kWarps) {
    float* sg = s_s + g * chunk;
    float mx = kNeg;
    for (int p = lane; p < chunk; p += 32) mx = fmaxf(mx, sg[p]);
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int p = lane; p < chunk; p += 32) {
      const float e = expf(sg[p] - mx);
      sg[p] = e;
      sum += e;
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      m_s[g] = mx;
      l_s[g] = sum;
    }
  }
  __syncthreads();

  const size_t row = ((size_t)b * Hkv + h) * nc + c;   // (b, h, chunk)
  for (int g = tid; g < G; g += kThreads) {
    part_ml[(row * G + g) * 2] = m_s[g];
    part_ml[(row * G + g) * 2 + 1] = l_s[g];
  }
  // p . v: one thread per head dim
  const int p_end = min(chunk, S - c * chunk);
  for (int d = tid; d < Dh; d += kThreads) {
    float acc[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
    const T* vc = v + (((size_t)b * S + (size_t)c * chunk) * Hkv + h) * Dh + d;
    for (int p = 0; p < p_end; ++p) {
      const float vd = to_f(vc[(size_t)p * Hkv * Dh]);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] = fmaf(s_s[g * chunk + p], vd, acc[g]);
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) part_acc[(row * G + g) * Dh + d] = acc[g];
  }
}

// merge the chunks of query head (b, hq) in chunk order
template <typename T>
__global__ void merge_kernel(const float* __restrict__ part_ml,
                             const float* __restrict__ part_acc, int Hq,
                             int Hkv, int Dh, int nc, T* __restrict__ out) {
  const int b = blockIdx.y, hq = blockIdx.x;
  const int G = Hq / Hkv, h = hq / G, g = hq - h * G;
  const size_t row0 = ((size_t)b * Hkv + h) * nc;
  float mx = kNeg;
  for (int c = 0; c < nc; ++c)
    mx = fmaxf(mx, part_ml[((row0 + c) * G + g) * 2]);
  for (int d = threadIdx.x; d < Dh; d += blockDim.x) {
    float l = 0.f, acc = 0.f;
    for (int c = 0; c < nc; ++c) {
      const size_t r = (row0 + c) * G + g;
      const float w = expf(part_ml[r * 2] - mx);
      l = fmaf(part_ml[r * 2 + 1], w, l);
      acc = fmaf(part_acc[r * Dh + d], w, acc);
    }
    from_f(acc / fmaxf(l, 1e-30f), out + ((size_t)b * Hq + hq) * Dh + d);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, int B, int S, int Hq,
           int Hkv, int Dh, int chunk, int t, float scale, float softcap,
           void* scratch, void* out, cudaStream_t s) {
  const int G = Hq / Hkv;
  const int nc = (S + chunk - 1) / chunk;
  float* part_ml = static_cast<float*>(scratch);
  float* part_acc = part_ml + (size_t)B * Hkv * nc * G * 2;
  const size_t smem = sizeof(float) * ((size_t)G * Dh + (size_t)G * chunk + 2 * G);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(chunk_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  chunk_kernel<T><<<dim3(nc, Hkv, B), kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), S, Hq, Hkv, Dh, chunk, t, scale, softcap,
      part_ml, part_acc);
  merge_kernel<T><<<dim3(Hq, B), Dh < 128 ? Dh : 128, 0, s>>>(
      part_ml, part_acc, Hq, Hkv, Dh, nc, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace repro

// dtype: 0 = f32, 1 = bf16.  q (B, Hq, Dh), k/v (B, S, Hkv, Dh) -> out
// (B, Hq, Dh); scratch of B * Hkv * ceil(S / chunk) * (Hq / Hkv) * (2 + Dh)
// floats; softcap <= 0 means none.
extern "C" int flash_decode_launch(int dtype, const void* q, const void* k,
                                   const void* v, int B, int S, int Hq,
                                   int Hkv, int Dh, int chunk, int t,
                                   float scale, float softcap, void* scratch,
                                   void* out, void* stream) {
  using namespace repro;
  if (B <= 0 || Hq <= 0) return 0;
  if (Hq % Hkv || Hq / Hkv > kMaxG || Dh > kMaxDh || chunk <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, B, S, Hq, Hkv, Dh, chunk, t, scale,
                                 softcap, scratch, out, s);
  return launch<float>(q, k, v, B, S, Hq, Hkv, Dh, chunk, t, scale, softcap,
                       scratch, out, s);
}
