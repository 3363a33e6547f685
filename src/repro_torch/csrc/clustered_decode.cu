// clustered_decode: fused clustered-KV decode attention, mixed mode, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel _kernel of src/repro/kernels/clustered_decode.py
// (launched by clustered_decode_pallas, scoring in score_and_combine):
// joint softmax attention of each slot's query rows over C median centroids
// (logit + log(count); count 0 masked) and the R-entry exact tail ring
// (position in [cov, t + i], row i < chunk_len).  Output per row:
// (p_c . v_c + p_t . v_t) / max(sum p, 1e-30), math in f32, stored like q.
//
// What bounds it on this card: at the serving shapes the bytes (each (slot,
// kv head) reads its C + R keys and values once) and the f32 p . v products
// set about the same least time; the q . k products of bf16 operands are
// exact in f32, so bf16 tensor cores could take them at ~15x the f32 rate.
// chip_smoke.py reports the larger of the two for its inputs.  The design
// keeps every intermediate out of device memory: one block per (slot, kv
// head, tile of 16 query rows) stages the rows in shared memory once,
// streams the entries
// through shared memory in tiles of 32 (keys and values converted to f32 on
// load), and folds each tile into an online softmax (running max, sum and
// Dh accumulator per row, in registers).  The dot products run on the FMA
// pipes: tensor cores (wgmma) and TMA loads are later work.  Rows of one
// (slot, kv head) in different row tiles re-read the same entries, which
// then come from L2.  At the serving shapes the whole grid fits in one
// wave, so a call takes as long as one block's walk over the C + R
// entries: the tile loads are 16-byte vectors, all issued before any is
// converted, so a tile costs about one memory latency.
//
// Ring position of slot s with tw = t + chunk_len entries written:
// s while tw <= R, else tw - R + ((s - tw) mod R) with a floor mod.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "clustered_score.cuh"

namespace repro {

// Visibility and bias of entry e of the current tile for query row r.
struct DenseMask {
  const float* bias_s;  // [kTile] log(max(count, 1e-9)) of centroid entries
  const int* pos_s;     // [kTile] ring position, or -1 for a centroid entry
  const int* ok_s;      // [kTile] centroid count > 0 (centroid entries)
  int row0, g, t, cov, cl;

  __device__ __forceinline__ bool operator()(int r, int e, float& bias) const {
    const int i = (row0 + r) / g;  // chunk row of query row r
    const bool row_ok = i < cl;
    const int pos = pos_s[e];
    if (pos < 0) {                 // centroid
      bias = bias_s[e];
      return row_ok && ok_s[e];
    }
    bias = 0.f;
    return row_ok && pos < t + i + 1 && pos >= cov;
  }
};

// Entry ge of slot b, kv head h: centroid ge < C, else ring slot ge - C.
template <typename T>
struct DenseSrc {
  const T* kc;
  const T* vc;
  const T* kt;
  const T* vt;
  int b, h, Hkv, dh, C, R;

  __device__ __forceinline__ void operator()(int ge, const T*& k,
                                             const T*& v) const {
    if (ge < C) {
      const size_t off = ((size_t)(b * C + ge) * Hkv + h) * dh;
      k = kc + off;
      v = vc + off;
    } else {
      const size_t off = ((size_t)(b * R + ge - C) * Hkv + h) * dh;
      k = kt + off;
      v = vt + off;
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
clustered_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc,
                        const float* __restrict__ cnt,
                        const T* __restrict__ kt, const T* __restrict__ vt,
                        const int* __restrict__ t_vec,
                        const int* __restrict__ cov_vec,
                        const int* __restrict__ cl_vec, T* __restrict__ out,
                        int L, int Hq, int Hkv, int dh, int C, int R,
                        float scale, float softcap) {
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int g = Hq / Hkv;
  const int n_rows = L * g;
  const int row0 = blockIdx.y * kRows;

  extern __shared__ float4 smem4[];          // 16-byte aligned
  const BlockSmem sm = block_smem(reinterpret_cast<float*>(smem4), dh);

  const int t = t_vec[b];
  const int cov = cov_vec[b];
  const int cl = cl_vec[b];

  // query row r of this tile is chunk row i = row / g, head h * g + row % g
  for (int idx = threadIdx.x; idx < kRows * dh; idx += kThreads) {
    const int r = idx / dh, d = idx % dh, row = row0 + r;
    float v = 0.f;
    if (row < n_rows) {
      const int i = row / g, hq = h * g + row % g;
      v = to_f32(q[((size_t)(b * L + i) * Hq + hq) * dh + d]);
    }
    sm.q_s[idx] = v;
  }

  RowState st[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) row_state_init(st[i]);

  const DenseMask mask{sm.bias_s, sm.pos_s, sm.ok_s, row0, g, t, cov, cl};
  const DenseSrc<T> src{kc, vc, kt, vt, b, h, Hkv, dh, C, R};
  attend_entries<T>(sm, src, cnt + (size_t)b * C * Hkv + h, Hkv, C, R,
                    t + cl, dh, scale, softcap, mask, st);

  store_rows<T>(st, dh, [&](int r) -> T* {
    const int row = row0 + r;
    if (row >= n_rows) return nullptr;
    const int ci = row / g, hq = h * g + row % g;
    return out + ((size_t)(b * L + ci) * Hq + hq) * dh;
  });
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, const void* cnt,
           const void* kt, const void* vt, const void* t, const void* cov,
           const void* cl, void* out, int B, int L, int Hq, int Hkv, int dh,
           int C, int R, float scale, float softcap, cudaStream_t stream) {
  const size_t smem = block_smem_bytes(dh);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(clustered_decode_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  const dim3 grid(B * Hkv, (L * (Hq / Hkv) + kRows - 1) / kRows);
  clustered_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const float*>(cnt),
      static_cast<const T*>(kt), static_cast<const T*>(vt),
      static_cast<const int*>(t), static_cast<const int*>(cov),
      static_cast<const int*>(cl), static_cast<T*>(out), L, Hq, Hkv, dh, C,
      R, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16 (q, centroids, ring and out share it);
// counts are float32, t / cov / chunk_len int32 (B,).  softcap <= 0: none.
extern "C" int clustered_decode_launch(
    int dtype, const void* q, const void* kc, const void* vc, const void* cnt,
    const void* kt, const void* vt, const void* t, const void* cov,
    const void* cl, void* out, int B, int L, int Hq, int Hkv, int dh, int C,
    int R, float scale, float softcap, void* stream) {
  if (dh > repro::kMaxDh || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::launch<float>(q, kc, vc, cnt, kt, vt, t, cov, cl, out, B, L,
                                Hq, Hkv, dh, C, R, scale, softcap, s);
  if (dtype == 1)
    return repro::launch<__nv_bfloat16>(q, kc, vc, cnt, kt, vt, t, cov, cl,
                                        out, B, L, Hq, Hkv, dh, C, R, scale,
                                        softcap, s);
  return (int)cudaErrorInvalidValue;
}
