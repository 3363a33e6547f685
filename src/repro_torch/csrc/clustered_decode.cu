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
  float* q_s = reinterpret_cast<float*>(smem4);  // kRows * dh
  float* k_s = q_s + kRows * dh;              // kTile * k_stride(dh)
  float* v_s = k_s + kTile * k_stride(dh);    // kTile * dh
  float* s_s = v_s + kTile * dh;              // kRows * kTile
  float* bias_s = s_s + kRows * kTile;        // kTile
  int* pos_s = reinterpret_cast<int*>(bias_s + kTile);  // kTile
  int* ok_s = pos_s + kTile;                  // kTile

  const int t = t_vec[b];
  const int cov = cov_vec[b];
  const int cl = cl_vec[b];
  const int tw = t + cl;

  // query row r of this tile is chunk row i = row / g, head h * g + row % g
  for (int idx = threadIdx.x; idx < kRows * dh; idx += kThreads) {
    const int r = idx / dh, d = idx % dh, row = row0 + r;
    float v = 0.f;
    if (row < n_rows) {
      const int i = row / g, hq = h * g + row % g;
      v = to_f32(q[((size_t)(b * L + i) * Hq + hq) * dh + d]);
    }
    q_s[idx] = v;
  }

  RowState st[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) row_state_init(st[i]);

  const DenseMask mask{bias_s, pos_s, ok_s, row0, g, t, cov, cl};
  const int n_entries = C + R;
  for (int e0 = 0; e0 < n_entries; e0 += kTile) {
    const int n_tile = min(kTile, n_entries - e0);
    // stage the tile: entry e0 + e is centroid e0 + e, or ring slot
    // e0 + e - C.  16-byte vectors (kVec elements; the wrapper checks
    // dh % kVec == 0 and alignment), kBatch of each per thread issued
    // before any is converted into shared memory.
    constexpr int kVec = 16 / sizeof(T);
    constexpr int kBatch = 4;
    const int vpr = dh / kVec;  // vectors per entry
    const int n_vec = kTile * vpr;
    for (int base = 0; base < n_vec; base += kBatch * kThreads) {
      uint4 kr[kBatch], vr[kBatch];
#pragma unroll
      for (int it = 0; it < kBatch; ++it) {
        const int idx = base + it * kThreads + threadIdx.x;
        const int ge = e0 + idx / vpr;
        kr[it] = vr[it] = make_uint4(0u, 0u, 0u, 0u);
        if (idx < n_vec && ge < n_entries) {
          const int d0 = (idx % vpr) * kVec;
          const bool cent = ge < C;
          const size_t off =
              cent ? ((size_t)(b * C + ge) * Hkv + h) * dh + d0
                   : ((size_t)(b * R + ge - C) * Hkv + h) * dh + d0;
          kr[it] = *reinterpret_cast<const uint4*>((cent ? kc : kt) + off);
          vr[it] = *reinterpret_cast<const uint4*>((cent ? vc : vt) + off);
        }
      }
#pragma unroll
      for (int it = 0; it < kBatch; ++it) {
        const int idx = base + it * kThreads + threadIdx.x;
        if (idx < n_vec) {
          const int e = idx / vpr, d0 = (idx % vpr) * kVec;
          float kf[kVec], vf[kVec];
          unpack16<T>(kr[it], kf);
          unpack16<T>(vr[it], vf);
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            k_s[e * k_stride(dh) + d0 + j] = kf[j];
            v_s[e * dh + d0 + j] = vf[j];
          }
        }
      }
    }
    if (threadIdx.x < kTile) {
      const int ge = e0 + threadIdx.x;
      if (ge < C) {
        const float c = cnt[(b * C + ge) * Hkv + h];
        bias_s[threadIdx.x] = logf(fmaxf(c, 1e-9f));
        ok_s[threadIdx.x] = c > 0.f;
        pos_s[threadIdx.x] = -1;
      } else {
        const int s = ge - C;
        const int wrapped = tw - R + (((s - tw) % R) + R) % R;
        // a slot past C + R is never scored (n_tile); park it at -2
        pos_s[threadIdx.x] = ge < n_entries ? (tw <= R ? s : wrapped) : -2;
        bias_s[threadIdx.x] = 0.f;
        ok_s[threadIdx.x] = 0;
      }
    }
    __syncthreads();
    score_and_combine_tile(q_s, k_s, v_s, s_s, dh, n_tile, scale, softcap,
                           mask, st);
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = row0 + warp + kWarps * i;
    if (row >= n_rows) continue;
    const int ci = row / g, hq = h * g + row % g;
    const float l = fmaxf(st[i].l, 1e-30f);
    T* o = out + ((size_t)(b * L + ci) * Hq + hq) * dh;
#pragma unroll
    for (int j = 0; j < kDhPerLane; ++j) {
      const int d = lane + 32 * j;
      if (d < dh) o[d] = from_f32<T>(st[i].acc[j] / l);
    }
  }
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, const void* cnt,
           const void* kt, const void* vt, const void* t, const void* cov,
           const void* cl, void* out, int B, int L, int Hq, int Hkv, int dh,
           int C, int R, float scale, float softcap, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (kRows * dh + kTile * k_stride(dh) + kTile * dh +
                       kRows * kTile + kTile) +
      sizeof(int) * 2 * kTile;
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
