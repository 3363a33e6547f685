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
// What bounds it on this card: the bytes, as for clustered_decode (each
// slot's centroids and mapped blocks once; a few operations per byte).
// The design is clustered_decode's, through the same device tile
// (clustered_score.cuh): four warps split the entries, two cp.async
// stages per warp, q . k and p . v on mma.sync tensor cores.  What is
// paged-specific:
// - a block takes one group of consecutive packed rows of one slot
//   (row_group: start row and count, at most 16 / G rows, so the G heads
//   of each fill the block's 16 row places).  The engine builds the table
//   with its packed rows (group_rows in kernels/paged_clustered_decode.py):
//   a 64-row prefill chunk shares each staged tile among 16 / G rows, as
//   in clustered_decode, instead of re-reading it once per row; a decode
//   row is a group of its own.  A group's rows share their slot, their
//   ring watermark tw and their block-table row (the first row's are
//   used); each row keeps its own qpos1, cov and wlo.
// - grid (N, Hkv): entries of row_group past the last group are -1, and
//   their blocks return at once; a group of padding rows (qpos1 == 0)
//   writes zeros and returns: the engine discards those rows.
// Bit identity with clustered_decode: a row's arithmetic depends only on
// its query, its entries and their indices (clustered_score.cuh), so a
// paged row equals the dense row of the same (slot, position) bit for bit
// whatever group it sits in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "clustered_score.cuh"

namespace repro {

// row_group entries: start row << kGroupShift | row count
constexpr int kGroupShift = 5;

// Entries of the group's slot, kv head h: centroid ge < C is row
// slot * C + ge of kc / vc, ring offset s = ge - C row bt[s / bs] * bs +
// s % bs of the pools (rows of Hkv * dh elements; see load_tile).
template <typename T>
struct PagedSrc {
  const T* kc;
  const T* vc;
  const T* kr;
  const T* vr;
  int row_elems, head_off;
  const int* bt;  // the group's T block ids
  int slot, C, bs;

  __device__ __forceinline__ int row(int ge) const {
    if (ge < C) return -(slot * C + ge) - 1;
    const int s = ge - C;
    return bt[s / bs] * bs + s % bs;
  }
};

template <typename T, int DhP>
__global__ void __launch_bounds__(kThreads)
paged_clustered_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ kc,
    const T* __restrict__ vc, const float* __restrict__ cnt,
    const T* __restrict__ kp, const T* __restrict__ vp,
    const int* __restrict__ row_slot, const int* __restrict__ row_bt,
    const int* __restrict__ qpos1_vec, const int* __restrict__ tw_vec,
    const int* __restrict__ cov_vec, const int* __restrict__ wlo_vec,
    const int* __restrict__ row_group, T* __restrict__ out, int N, int Hq,
    int Hkv, int dh, int C, int T_blocks, int bs, float scale,
    float softcap) {
  const int grp = row_group[blockIdx.x];
  if (grp < 0) return;                       // past the last group
  const int n0 = grp >> kGroupShift;
  const int h = blockIdx.y;
  const int g = Hq / Hkv;
  const int n_rows = (grp & ((1 << kGroupShift) - 1)) * g;
  if (n_rows > kRows || n0 + n_rows / g > N) __trap();   // malformed table

  // block row r is packed row n0 + r / g, head h * g + r % g
  auto out_row = [&](int r) -> T* {
    if (r >= n_rows) return nullptr;
    return out + ((size_t)(n0 + r / g) * Hq + h * g + r % g) * dh;
  };
  // the group's first row: read together, before the first branch
  const int qpos1_0 = qpos1_vec[n0];
  const int slot = row_slot[n0];
  const int tw = tw_vec[n0];
  if (qpos1_0 <= 0) {                        // a group of padding rows
    zero_rows<T>(dh, out_row);
    return;
  }
  auto row_mask = [&](int r) -> RowMask {
    if (r >= n_rows) return dead_row();
    const int n = n0 + r / g;
    const int qpos1 = qpos1_vec[n];
    if (qpos1 <= 0) return dead_row();
    return RowMask{1, max(cov_vec[n], wlo_vec[n]), qpos1, 1};
  };

  extern __shared__ float4 smem4[];          // 16-byte aligned
  const BlockSmem<T, DhP> sm(reinterpret_cast<unsigned char*>(smem4), C);
  const float* cnt_sh = cnt + (size_t)slot * C * Hkv + h;
  auto stage = [&]() {
    stage_block<T, DhP>(
        sm, dh, C,
        [&](int r) -> const T* {
          if (r >= n_rows) return nullptr;
          return q + ((size_t)(n0 + r / g) * Hq + h * g + r % g) * dh;
        },
        [&](int c) { return cnt_sh[(size_t)c * Hkv]; }, row_mask);
  };

  const int lane = threadIdx.x & 31;
  const RowMask rm[2] = {row_mask(lane >> 2), row_mask((lane >> 2) + 8)};
  WarpState<DhP> st;
  st.init();
  const PagedSrc<T> src{kc, vc, kp, vp, Hkv * dh, h * dh,
                        row_bt + (size_t)n0 * T_blocks, slot, C, bs};
  walk_entries<T, DhP>(sm, src, C, T_blocks * bs, tw, dh, scale, softcap,
                       rm, st, stage);
  finish_rows<T, DhP>(sm, st, dh, out_row);
}

template <typename T, int DhP>
int launch_dh(const void* q, const void* kc, const void* vc, const void* cnt,
              const void* kp, const void* vp, const void* row_slot,
              const void* row_bt, const void* qpos1, const void* tw,
              const void* cov, const void* wlo, const void* row_group,
              void* out, int N, int Hq, int Hkv, int dh, int C, int T_blocks,
              int bs, float scale, float softcap, cudaStream_t stream) {
  const size_t smem = Smem<T, DhP>::bytes(C);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(paged_clustered_decode_kernel<T, DhP>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  const dim3 grid(N, Hkv);
  paged_clustered_decode_kernel<T, DhP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const float*>(cnt),
      static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<const int*>(row_slot), static_cast<const int*>(row_bt),
      static_cast<const int*>(qpos1), static_cast<const int*>(tw),
      static_cast<const int*>(cov), static_cast<const int*>(wlo),
      static_cast<const int*>(row_group), static_cast<T*>(out), N, Hq, Hkv,
      dh, C, T_blocks, bs, scale, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, const void* cnt,
           const void* kp, const void* vp, const void* row_slot,
           const void* row_bt, const void* qpos1, const void* tw,
           const void* cov, const void* wlo, const void* row_group, void* out,
           int N, int Hq, int Hkv, int dh, int C, int T_blocks, int bs,
           float scale, float softcap, cudaStream_t stream) {
  if (dh <= 64)
    return launch_dh<T, 64>(q, kc, vc, cnt, kp, vp, row_slot, row_bt, qpos1,
                            tw, cov, wlo, row_group, out, N, Hq, Hkv, dh, C,
                            T_blocks, bs, scale, softcap, stream);
  if (dh <= 128)
    return launch_dh<T, 128>(q, kc, vc, cnt, kp, vp, row_slot, row_bt, qpos1,
                             tw, cov, wlo, row_group, out, N, Hq, Hkv, dh, C,
                             T_blocks, bs, scale, softcap, stream);
  return launch_dh<T, 256>(q, kc, vc, cnt, kp, vp, row_slot, row_bt, qpos1,
                           tw, cov, wlo, row_group, out, N, Hq, Hkv, dh, C,
                           T_blocks, bs, scale, softcap, stream);
}

}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16 (q, centroids, pools and out share it);
// counts are float32; row_slot, qpos1, tw, cov, wlo, row_group int32 (N,);
// row_bt int32 (N, T_blocks).  softcap <= 0: none.
extern "C" int paged_clustered_decode_launch(
    int dtype, const void* q, const void* kc, const void* vc, const void* cnt,
    const void* kp, const void* vp, const void* row_slot, const void* row_bt,
    const void* qpos1, const void* tw, const void* cov, const void* wlo,
    const void* row_group, void* out, int N, int Hq, int Hkv, int dh, int C,
    int T_blocks, int bs, float scale, float softcap, void* stream) {
  if (dh > repro::kMaxDh || Hq % Hkv != 0 || Hq / Hkv > repro::kRows)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::launch<float>(q, kc, vc, cnt, kp, vp, row_slot, row_bt,
                                qpos1, tw, cov, wlo, row_group, out, N, Hq,
                                Hkv, dh, C, T_blocks, bs, scale, softcap, s);
  if (dtype == 1)
    return repro::launch<__nv_bfloat16>(q, kc, vc, cnt, kp, vp, row_slot,
                                        row_bt, qpos1, tw, cov, wlo,
                                        row_group, out, N, Hq, Hkv, dh, C,
                                        T_blocks, bs, scale, softcap, s);
  return (int)cudaErrorInvalidValue;
}
