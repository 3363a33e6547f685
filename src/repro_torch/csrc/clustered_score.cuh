// Shared [centroids (+) tail ring] joint-softmax scoring for the clustered
// decode kernels.
//
// Counterpart of score_and_combine in src/repro/kernels/clustered_decode.py:
// the dense clustered_decode kernel calls score_and_combine_tile below for
// every tile of entries, and the paged kernel must call the same function,
// because paged tokens have to be bit-identical to dense ones.  The caller
// stages one tile of entries in shared memory (keys and values as f32) and
// supplies a mask functor; this function scores the tile against the
// block's query rows and folds it into each row's online-softmax state.
//
// Order of operations per (row, entry), as in the reference:
//   s = (q . k) * scale;  s = tanh(s / softcap) * softcap  (if softcap > 0);
//   s = ok ? s + bias : NEG     (bias = log(max(count, 1e-9)) for centroids)
// NEG = -1e30, never -inf: a row whose entries are all masked becomes a
// harmless uniform average instead of NaN.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr float kNeg = -1e30f;
constexpr int kRows = 16;        // query rows per block
constexpr int kTile = 32;        // entries per tile: one per lane
constexpr int kThreads = 128;    // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kRows / kWarps;
static_assert(kRowsPerWarp == 4, "a warp's scores per entry are one float4");
constexpr int kMaxDh = 256;
constexpr int kDhPerLane = kMaxDh / 32;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 16 loaded bytes (4 f32 or 8 bf16 values) as f32; bf16 -> f32 is exact
// (the bf16 bits are the high half of the f32).
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& r, float* out);
template <>
__device__ __forceinline__ void unpack16<float>(const uint4& r, float* out) {
  out[0] = __uint_as_float(r.x);
  out[1] = __uint_as_float(r.y);
  out[2] = __uint_as_float(r.z);
  out[3] = __uint_as_float(r.w);
}
template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& r,
                                                        float* out) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    out[2 * k] = __uint_as_float(w[k] << 16);
    out[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// Online-softmax state of one query row: running max, running sum and the
// Dh accumulator (lane l holds dims l, l + 32, ...), all f32.
struct RowState {
  float m;
  float l;
  float acc[kDhPerLane];
};

__device__ __forceinline__ void row_state_init(RowState& st) {
  st.m = kNeg;
  st.l = 0.f;
#pragma unroll
  for (int j = 0; j < kDhPerLane; ++j) st.acc[j] = 0.f;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared-memory layout of one block (floats; every array 16-byte aligned
// when dh % 4 == 0, which the wrappers check).
__host__ __device__ constexpr int k_stride(int dh) { return dh + 4; }
__host__ __device__ constexpr int score_index(int warp, int i, int e) {
  return (warp * kTile + e) * kRowsPerWarp + i;
}

// Score one staged tile and fold it into the rows' online softmax.
//   q_s  [kRows][dh]              query rows, f32
//   k_s  [kTile][k_stride(dh)]    keys of the tile, f32
//   v_s  [kTile][dh]              values of the tile, f32
//   s_s  [kWarps][kTile][kRowsPerWarp]  scores, then probabilities
//   n_tile                        entries of this tile that exist
//   mask(r, e, &bias)             true if entry e is visible to row r
//   st[kRowsPerWarp]              this warp's rows: r = warp + kWarps * i
// Every thread of the block must call it; it synchronises the block.
// The smem traffic is register-blocked: a key vector is loaded once for
// the warp's rows, a value once for the warp's rows, and the query rows
// and probabilities are 16-byte broadcasts.  Per (row, entry) the dot
// product sums dims in order, and per (row, dim) the accumulator adds
// entries in order, so the arithmetic is that of the plain loop.
template <typename Mask>
__device__ __forceinline__ void score_and_combine_tile(
    const float* q_s, const float* k_s, const float* v_s, float* s_s, int dh,
    int n_tile, float scale, float softcap, const Mask& mask,
    RowState (&st)[kRowsPerWarp]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int e = lane;
  // scores: each lane takes one entry against the warp's rows
  {
    float dot[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) dot[i] = 0.f;
    const float4* ke = reinterpret_cast<const float4*>(k_s + e * k_stride(dh));
    for (int d4 = 0; d4 < dh / 4; ++d4) {
      const float4 kv = ke[d4];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 qv =
            reinterpret_cast<const float4*>(q_s + (warp + kWarps * i) * dh)[d4];
        dot[i] = fmaf(qv.x, kv.x, dot[i]);
        dot[i] = fmaf(qv.y, kv.y, dot[i]);
        dot[i] = fmaf(qv.z, kv.z, dot[i]);
        dot[i] = fmaf(qv.w, kv.w, dot[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      float s = kNeg;
      if (e < n_tile) {
        s = dot[i] * scale;
        if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
        float bias = 0.f;
        s = mask(warp + kWarps * i, e, bias) ? s + bias : kNeg;
      }
      s_s[score_index(warp, i, e)] = s;
    }
  }
  __syncwarp();
  // online softmax: each warp owns its rows
  float corr[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    RowState& rs = st[i];
    const float s = s_s[score_index(warp, i, lane)];
    const float m_new = fmaxf(rs.m, warp_max(s));
    corr[i] = expf(rs.m - m_new);
    const float p = lane < n_tile ? expf(s - m_new) : 0.f;
    rs.l = rs.l * corr[i] + warp_sum(p);
    rs.m = m_new;
    s_s[score_index(warp, i, lane)] = p;
  }
  __syncwarp();
  // p . v: lanes split the head dim; each value feeds the warp's rows
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < kDhPerLane; ++j) st[i].acc[j] *= corr[i];
  for (int ee = 0; ee < n_tile; ++ee) {
    const float4 p = reinterpret_cast<const float4*>(s_s)[warp * kTile + ee];
#pragma unroll
    for (int j = 0; j < kDhPerLane; ++j) {
      const int d = lane + 32 * j;
      if (d < dh) {
        const float v = v_s[ee * dh + d];
        st[0].acc[j] = fmaf(p.x, v, st[0].acc[j]);
        st[1].acc[j] = fmaf(p.y, v, st[1].acc[j]);
        st[2].acc[j] = fmaf(p.z, v, st[2].acc[j]);
        st[3].acc[j] = fmaf(p.w, v, st[3].acc[j]);
      }
    }
  }
  __syncthreads();
}

}  // namespace repro
