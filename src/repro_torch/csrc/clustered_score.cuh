// Shared [centroids (+) tail ring] joint-softmax scoring for the clustered
// decode kernels.
//
// Counterpart of score_and_combine in src/repro/kernels/clustered_decode.py:
// the dense clustered_decode kernel and the paged paged_clustered_decode
// kernel both walk their entries with attend_entries below, which stages
// each tile of entries in shared memory (keys and values as f32) and
// scores it with score_and_combine_tile against the block's query rows,
// folding it into each row's online-softmax state.  The kernels differ
// only in where an entry's bytes live (an entry-source functor) and which
// entries a row sees (a mask functor), so a paged row is bit-identical to
// the dense row of the same (slot, position).
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

// Strides of the shared arrays (layout: BlockSmem below).
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

// Shared memory of one block (floats; every array 16-byte aligned when
// dh % 4 == 0, which the wrappers check):
//   q_s [kRows][dh], k_s [kTile][k_stride(dh)], v_s [kTile][dh],
//   s_s [kRows][kTile], bias_s [kTile]; then ints pos_s, ok_s [kTile].
struct BlockSmem {
  float* q_s;
  float* k_s;
  float* v_s;
  float* s_s;
  float* bias_s;  // log(max(count, 1e-9)) of centroid entries
  int* pos_s;     // ring position, -1 for a centroid, -2 past the end
  int* ok_s;      // centroid count > 0
};

__host__ __device__ constexpr size_t block_smem_bytes(int dh) {
  return sizeof(float) * (kRows * dh + kTile * k_stride(dh) + kTile * dh +
                          kRows * kTile + kTile) +
         sizeof(int) * 2 * kTile;
}

__device__ __forceinline__ BlockSmem block_smem(float* base, int dh) {
  BlockSmem sm;
  sm.q_s = base;
  sm.k_s = sm.q_s + kRows * dh;
  sm.v_s = sm.k_s + kTile * k_stride(dh);
  sm.s_s = sm.v_s + kTile * dh;
  sm.bias_s = sm.s_s + kRows * kTile;
  sm.pos_s = reinterpret_cast<int*>(sm.bias_s + kTile);
  sm.ok_s = sm.pos_s + kTile;
  return sm;
}

// Walk the C + R entries [C centroids (+) ring offsets 0..R-1] in tiles of
// kTile and fold each into the rows' online softmax.
//   src(ge, k, v)   points k and v at entry ge's Dh row of this block's
//                   kv head (centroid ge < C, else ring offset ge - C)
//   cnt[c * cnt_stride]  count of centroid c (this block's slot and head)
//   tw              ring watermark: ring offset s holds position s while
//                   tw <= R, else tw - R + ((s - tw) mod R), a floor mod
//   mask            as for score_and_combine_tile, reading sm's arrays
// The caller has written the query rows to sm.q_s; the first tile's
// barrier publishes them.  Every thread of the block must call it.
// Tile loads are 16-byte vectors (kVec elements; the wrappers check
// dh % kVec == 0 and alignment), kBatch of each per thread issued before
// any is converted into shared memory.
template <typename T, typename Src, typename Mask>
__device__ __forceinline__ void attend_entries(
    const BlockSmem& sm, const Src& src, const float* cnt, int cnt_stride,
    int C, int R, int tw, int dh, float scale, float softcap,
    const Mask& mask, RowState (&st)[kRowsPerWarp]) {
  const int n_entries = C + R;
  for (int e0 = 0; e0 < n_entries; e0 += kTile) {
    const int n_tile = min(kTile, n_entries - e0);
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
          const T* kp;
          const T* vp;
          src(ge, kp, vp);
          kr[it] = __ldg(reinterpret_cast<const uint4*>(kp + d0));
          vr[it] = __ldg(reinterpret_cast<const uint4*>(vp + d0));
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
            sm.k_s[e * k_stride(dh) + d0 + j] = kf[j];
            sm.v_s[e * dh + d0 + j] = vf[j];
          }
        }
      }
    }
    if (threadIdx.x < kTile) {
      const int ge = e0 + threadIdx.x;
      if (ge < C) {
        const float c = cnt[ge * cnt_stride];
        sm.bias_s[threadIdx.x] = logf(fmaxf(c, 1e-9f));
        sm.ok_s[threadIdx.x] = c > 0.f;
        sm.pos_s[threadIdx.x] = -1;
      } else {
        const int s = ge - C;
        const int wrapped = tw - R + (((s - tw) % R) + R) % R;
        // a slot past C + R is never scored (n_tile); park it at -2
        sm.pos_s[threadIdx.x] =
            ge < n_entries ? (tw <= R ? s : wrapped) : -2;
        sm.bias_s[threadIdx.x] = 0.f;
        sm.ok_s[threadIdx.x] = 0;
      }
    }
    __syncthreads();
    score_and_combine_tile(sm.q_s, sm.k_s, sm.v_s, sm.s_s, dh, n_tile, scale,
                           softcap, mask, st);
  }
}

// Write each row's softmax average acc / max(l, 1e-30) in T.
// out_row(r) is the output row of block row r, or nullptr to skip it.
template <typename T, typename OutRow>
__device__ __forceinline__ void store_rows(
    const RowState (&st)[kRowsPerWarp], int dh, const OutRow& out_row) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    T* o = out_row(warp + kWarps * i);
    if (o == nullptr) continue;
    const float l = fmaxf(st[i].l, 1e-30f);
#pragma unroll
    for (int j = 0; j < kDhPerLane; ++j) {
      const int d = lane + 32 * j;
      if (d < dh) o[d] = from_f32<T>(st[i].acc[j] / l);
    }
  }
}

}  // namespace repro
