// paged_clustered_decode: clustered-KV decode attention over packed ragged
// rows with the exact tail ring in a block pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel _kernel of
// src/repro/kernels/paged_clustered_decode.py (launched by
// paged_clustered_decode_pallas): each packed row n is one real
// (slot, position) pair of an engine step.  Its G = Hq / Hkv query heads
// per kv head attend jointly over the C median centroids of slot
// row_slot[n] (logit + log(count); count 0 masked) and the R = T * bs
// ring offsets, offset s read from pool block row_bt[n, s / bs] at
// s % bs.  Offset s holds position s while tw <= R, else
// tw - R + ((s - tw) mod R) with a floor mod; it counts when
// pos < qpos1, pos >= cov and pos >= wlo.  Output per row:
// (p_c . v_c + p_t . v_t) / max(sum p, 1e-30), math in f32, stored like q.
//
// Bit-identity with clustered_decode: both kernels walk the entries with
// attend_entries (clustered_score.cuh) in the same order, C centroids then
// ring offsets 0..R-1 in tiles of 32, and score each tile with
// score_and_combine_tile.  A query row's arithmetic never depends on the
// other rows of its block, so a paged row equals the dense row of the same
// (slot, position) bit for bit; only the entry source (block table) and
// the mask (per-row qpos1 and wlo) differ.
//
// What bounds it on this card: the bytes (each row's slot centroids and
// mapped blocks, read once per (row, kv head) and shared through L2 by the
// rows of one slot) and the f32 p . v products, as for clustered_decode.
// The design is the simple one: one block of 128 threads per (packed row,
// kv head) holding the row's G query heads in 4 of its 16 query-row
// places (qwen3: G = 4), so 3/4 of the block's FMA work is on zero rows.
// Packing the rows of one slot into one block, so that a chunk's 64 rows
// share each staged tile, is later work (ROADMAP B2 redesign).  Padding
// rows (qpos1 == 0) write zeros and return: the engine discards them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "clustered_score.cuh"

namespace repro {

// Visibility and bias of entry e of the current tile for the block's row.
struct PagedMask {
  const float* bias_s;  // [kTile] log(max(count, 1e-9)) of centroid entries
  const int* pos_s;     // [kTile] ring position, or -1 for a centroid entry
  const int* ok_s;      // [kTile] centroid count > 0 (centroid entries)
  int qpos1, cov, wlo;

  __device__ __forceinline__ bool operator()(int, int e, float& bias) const {
    const int pos = pos_s[e];
    if (pos < 0) {                 // centroid
      bias = bias_s[e];
      return ok_s[e];
    }
    bias = 0.f;
    return pos < qpos1 && pos >= cov && pos >= wlo;
  }
};

// Entry ge of this row, kv head h: centroid ge < C of the row's slot, else
// ring offset ge - C through the row's block table.
template <typename T>
struct PagedSrc {
  const T* kc;
  const T* vc;
  const T* kp;
  const T* vp;
  const int* bt;  // the row's T block ids
  int slot, h, Hkv, dh, C, bs;

  __device__ __forceinline__ void operator()(int ge, const T*& k,
                                             const T*& v) const {
    if (ge < C) {
      const size_t off = ((size_t)(slot * C + ge) * Hkv + h) * dh;
      k = kc + off;
      v = vc + off;
    } else {
      const int s = ge - C;
      const size_t off =
          (((size_t)bt[s / bs] * bs + s % bs) * Hkv + h) * dh;
      k = kp + off;
      v = vp + off;
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_clustered_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ kc,
    const T* __restrict__ vc, const float* __restrict__ cnt,
    const T* __restrict__ kp, const T* __restrict__ vp,
    const int* __restrict__ row_slot, const int* __restrict__ row_bt,
    const int* __restrict__ qpos1_vec, const int* __restrict__ tw_vec,
    const int* __restrict__ cov_vec, const int* __restrict__ wlo_vec,
    T* __restrict__ out, int Hq, int Hkv, int dh, int C, int T_blocks,
    int bs, float scale, float softcap) {
  const int n = blockIdx.x;
  const int h = blockIdx.y;
  const int g = Hq / Hkv;
  T* o_row = out + ((size_t)n * Hq + h * g) * dh;  // the row's G heads
  const int qpos1 = qpos1_vec[n];
  if (qpos1 <= 0) {                // padding row
    for (int idx = threadIdx.x; idx < g * dh; idx += kThreads)
      o_row[idx] = from_f32<T>(0.f);
    return;
  }

  extern __shared__ float4 smem4[];          // 16-byte aligned
  const BlockSmem sm = block_smem(reinterpret_cast<float*>(smem4), dh);

  const int slot = row_slot[n];
  const T* q_row = q + ((size_t)n * Hq + h * g) * dh;
  for (int idx = threadIdx.x; idx < kRows * dh; idx += kThreads)
    sm.q_s[idx] = idx < g * dh ? to_f32(q_row[idx]) : 0.f;

  RowState st[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) row_state_init(st[i]);

  const PagedMask mask{sm.bias_s, sm.pos_s, sm.ok_s, qpos1, cov_vec[n],
                       wlo_vec[n]};
  const PagedSrc<T> src{kc, vc, kp, vp, row_bt + (size_t)n * T_blocks,
                        slot, h, Hkv, dh, C, bs};
  attend_entries<T>(sm, src, cnt + (size_t)slot * C * Hkv + h, Hkv, C,
                    T_blocks * bs, tw_vec[n], dh, scale, softcap, mask, st);

  store_rows<T>(st, dh, [&](int r) -> T* {
    return r < g ? o_row + (size_t)r * dh : nullptr;
  });
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, const void* cnt,
           const void* kp, const void* vp, const void* row_slot,
           const void* row_bt, const void* qpos1, const void* tw,
           const void* cov, const void* wlo, void* out, int N, int Hq,
           int Hkv, int dh, int C, int T_blocks, int bs, float scale,
           float softcap, cudaStream_t stream) {
  const size_t smem = block_smem_bytes(dh);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(paged_clustered_decode_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  const dim3 grid(N, Hkv);
  paged_clustered_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const float*>(cnt),
      static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<const int*>(row_slot), static_cast<const int*>(row_bt),
      static_cast<const int*>(qpos1), static_cast<const int*>(tw),
      static_cast<const int*>(cov), static_cast<const int*>(wlo),
      static_cast<T*>(out), Hq, Hkv, dh, C, T_blocks, bs, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16 (q, centroids, pools and out share it);
// counts are float32; row_slot, qpos1, tw, cov, wlo int32 (N,); row_bt
// int32 (N, T_blocks).  softcap <= 0: none.
extern "C" int paged_clustered_decode_launch(
    int dtype, const void* q, const void* kc, const void* vc, const void* cnt,
    const void* kp, const void* vp, const void* row_slot, const void* row_bt,
    const void* qpos1, const void* tw, const void* cov, const void* wlo,
    void* out, int N, int Hq, int Hkv, int dh, int C, int T_blocks, int bs,
    float scale, float softcap, void* stream) {
  if (dh > repro::kMaxDh || Hq % Hkv != 0 || Hq / Hkv > repro::kRows)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::launch<float>(q, kc, vc, cnt, kp, vp, row_slot, row_bt,
                                qpos1, tw, cov, wlo, out, N, Hq, Hkv, dh, C,
                                T_blocks, bs, scale, softcap, s);
  if (dtype == 1)
    return repro::launch<__nv_bfloat16>(q, kc, vc, cnt, kp, vp, row_slot,
                                        row_bt, qpos1, tw, cov, wlo, out, N,
                                        Hq, Hkv, dh, C, T_blocks, bs, scale,
                                        softcap, s);
  return (int)cudaErrorInvalidValue;
}
