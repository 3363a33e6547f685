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
// What bounds it on this card: the bytes.  Each (slot, kv head) reads its
// C + R keys and values once (qwen3-4b at C + R = 320, Dh = 128 in bf16:
// 164 KB); the q . k and p . v products of 4 to 64 query rows per entry are
// a few operations per byte, far below the ~295 the tensor cores need
// before they are the limit.  So the design aims at bytes in flight and at
// keeping the math off the critical path:
// - one block per (slot, kv head, tile of 16 query rows); its four warps
//   split the entries (warp w takes the 16-entry tiles w, w + 4, ...), so
//   a block keeps four tiles' loads in flight, two stages deep per warp
//   (cp.async), instead of walking all C + R entries alone;
// - q . k and p . v on the tensor cores (mma.sync.m16n8k16, bf16 -> f32;
//   wgmma needs 64-row tiles and the one-token form has g = 4 rows per
//   (slot, kv head)), keys and values bf16 in shared memory;
// - a row tile whose rows all lie at chunk index >= chunk_len writes zeros
//   and returns at once: in the engine's mixed step most tiles are such.
// Rows of one (slot, kv head) in different row tiles re-read the same
// entries, which then come from L2.  The scoring tile is shared with
// paged_clustered_decode (clustered_score.cuh), so paged rows stay
// bit-identical to dense rows.
//
// Ring position of slot s with tw = t + chunk_len entries written:
// s while tw <= R, else tw - R + ((s - tw) mod R) with a floor mod.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "clustered_score.cuh"

namespace repro {

// Entries of slot b, kv head h: centroid ge < C is row b * C + ge of
// kc / vc, ring slot s = ge - C row b * R + s of kt / vt (rows of Hkv * dh
// elements; see load_tile).
template <typename T>
struct DenseSrc {
  const T* kc;
  const T* vc;
  const T* kr;
  const T* vr;
  int row_elems, head_off, b, C, R;

  __device__ __forceinline__ int row(int ge) const {
    return ge < C ? -(b * C + ge) - 1 : b * R + ge - C;
  }
};

template <typename T, int DhP>
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
  const int t = t_vec[b];
  const int cov = cov_vec[b];
  const int cl = cl_vec[b];

  // block row r is query row row0 + r: chunk row i = row / g, head
  // h * g + row % g
  auto out_row = [&](int r) -> T* {
    const int row = row0 + r;
    if (row >= n_rows) return nullptr;
    return out + ((size_t)(b * L + row / g) * Hq + h * g + row % g) * dh;
  };
  if (row0 / g >= cl) {            // every row past the chunk: nothing to do
    zero_rows<T>(dh, out_row);
    return;
  }
  auto row_mask = [&](int r) -> RowMask {
    const int row = row0 + r, i = row / g;
    if (row >= n_rows || i >= cl) return dead_row();
    return RowMask{1, cov, t + i + 1, 1};
  };

  extern __shared__ float4 smem4[];          // 16-byte aligned
  const BlockSmem<T, DhP> sm(reinterpret_cast<unsigned char*>(smem4), C);
  const float* cnt_bh = cnt + (size_t)b * C * Hkv + h;
  auto stage = [&]() {
    stage_block<T, DhP>(
        sm, dh, C,
        [&](int r) -> const T* {
          const int row = row0 + r;
          if (row >= n_rows) return nullptr;
          return q + ((size_t)(b * L + row / g) * Hq + h * g + row % g) * dh;
        },
        [&](int c) { return cnt_bh[(size_t)c * Hkv]; }, row_mask);
  };

  const int lane = threadIdx.x & 31;
  const RowMask rm[2] = {row_mask(lane >> 2), row_mask((lane >> 2) + 8)};
  WarpState<DhP> st;
  st.init();
  const DenseSrc<T> src{kc, vc, kt, vt, Hkv * dh, h * dh, b, C, R};
  walk_entries<T, DhP>(sm, src, C, R, t + cl, dh, scale, softcap, rm, st,
                       stage);
  finish_rows<T, DhP>(sm, st, dh, out_row);
}

template <typename T, int DhP>
int launch_dh(const void* q, const void* kc, const void* vc, const void* cnt,
              const void* kt, const void* vt, const void* t, const void* cov,
              const void* cl, void* out, int B, int L, int Hq, int Hkv,
              int dh, int C, int R, float scale, float softcap,
              cudaStream_t stream) {
  const size_t smem = Smem<T, DhP>::bytes(C);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(clustered_decode_kernel<T, DhP>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  const dim3 grid(B * Hkv, (L * (Hq / Hkv) + kRows - 1) / kRows);
  clustered_decode_kernel<T, DhP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const float*>(cnt),
      static_cast<const T*>(kt), static_cast<const T*>(vt),
      static_cast<const int*>(t), static_cast<const int*>(cov),
      static_cast<const int*>(cl), static_cast<T*>(out), L, Hq, Hkv, dh, C,
      R, scale, softcap);
  return (int)cudaGetLastError();
}

// head dims are padded with zeros to 64, 128 or 256 in shared memory
template <typename T>
int launch(const void* q, const void* kc, const void* vc, const void* cnt,
           const void* kt, const void* vt, const void* t, const void* cov,
           const void* cl, void* out, int B, int L, int Hq, int Hkv, int dh,
           int C, int R, float scale, float softcap, cudaStream_t stream) {
  if (dh <= 64)
    return launch_dh<T, 64>(q, kc, vc, cnt, kt, vt, t, cov, cl, out, B, L,
                            Hq, Hkv, dh, C, R, scale, softcap, stream);
  if (dh <= 128)
    return launch_dh<T, 128>(q, kc, vc, cnt, kt, vt, t, cov, cl, out, B, L,
                             Hq, Hkv, dh, C, R, scale, softcap, stream);
  return launch_dh<T, 256>(q, kc, vc, cnt, kt, vt, t, cov, cl, out, B, L, Hq,
                           Hkv, dh, C, R, scale, softcap, stream);
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
