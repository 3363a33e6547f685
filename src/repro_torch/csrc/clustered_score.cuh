// The one device tile of the clustered decode kernels: [centroids (+) tail
// ring] joint-softmax scoring of up to 16 query rows of one (slot, kv head).
//
// Counterpart of score_and_combine in src/repro/kernels/clustered_decode.py.
// The dense clustered_decode kernel and the paged paged_clustered_decode
// kernel both walk their entries with walk_entries (which stages the
// block's query rows with stage_block once the first loads are in flight)
// and write their rows with finish_rows.  They differ only in where an
// entry's bytes live (an entry source), where a query row lives, and each
// row's visibility window (RowMask).  flash_decode walks one split of a
// plain cache with the same tile (no centroids) and keeps each row's
// unnormalised state (merge_warps) for its merge launch.
//
// Layout of the work.  A block holds kRows = 16 query-row places (the M of
// mma.m16n8k16) and kWarps warps.  The C + R entries are cut into tiles of
// kTile = 16; warp w takes tiles w, w + kWarps, w + 2 kWarps, ... and keeps
// its own online-softmax state (m, l, acc) for all 16 rows.  The warps'
// states are merged in warp order through shared memory.  A warp that gets
// no tile keeps (NEG, 0, 0) and adds nothing to the merge.  No thread-block
// cluster is used: the split stays inside one block.  (Carrying it across
// a cluster of 2 or 4 blocks, merged through distributed shared memory,
// was tried on an H100: the mixed form, with 2 or 4 times the blocks,
// each paying the staging and the merge, ran slower.)
//
// Each warp stages its tiles by 16-byte cp.async into its own ring of
// kStages buffers (two for bf16), so the next tile's load overlaps this
// tile's math.  bf16: keys and values stay bf16 in shared memory; q.k runs
// on mma.sync.m16n8k16 (bf16 x bf16 -> f32, operands by ldmatrix), whose
// products are exact in f32; p.v runs on the same instruction with p split
// as hi = bf16(p), lo = bf16(p - hi), which leaves p's relative error below
// 2^-17, far under the two-bf16-ulp tolerance of the bf16 output.  f32:
// the same fragment layout on the FMA pipes (held to 1e-5).  Softmax
// exponentials use __expf (2 ulp near 0, where the weights that matter
// are).
//
// Bit identity.  A row's arithmetic depends only on its query, its
// entries, each entry's index (which fixes its tile, its warp and its
// place in the mma) and its RowMask; never on the launch form, the row's
// place in its block or the block's other rows.  So a paged row equals the
// dense row of the same (slot, position) bit for bit.  Rows lane/4 and
// lane/4 + 8 run in unrolled copies of the same code, and the compiler
// may fuse a multiply and an add into an FMA in one copy and not in the
// other; so every product that meets a sum is written out (__fmul_rn,
// __fadd_rn, fmaf), which leaves the compiler no such choice.
//
// Order of operations per (row, entry), as in the reference:
//   s = (q . k) * scale;  s = tanh(s / softcap) * softcap  (if softcap > 0);
//   s = visible ? s + bias : NEG  (bias = log(max(count, 1e-9)) for
//   centroids, 0 for ring entries); output acc / max(l, 1e-30).
// NEG = -1e30, never -inf: a row whose entries are all masked becomes the
// uniform average over all C + R entries instead of NaN.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr float kNeg = -1e30f;
constexpr int kRows = 16;        // query rows per block: the mma's M
constexpr int kTile = 16;        // entries per tile: the K of one p.v mma
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxDh = 256;

template <typename T>
struct Traits;
template <>
struct Traits<__nv_bfloat16> {
  static constexpr int kStages = 2;
};
template <>
struct Traits<float> {
  static constexpr int kStages = 1;   // f32 tiles are twice the bytes
};

// Shared-memory row stride in elements: 16 bytes of padding per row keep
// the eight 16-byte rows of an ldmatrix on distinct banks.
template <typename T, int DhP>
__host__ __device__ constexpr int row_stride() {
  return DhP + 16 / (int)sizeof(T);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; zero-filled (nothing read) when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16x16, row) . b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo_col, float hi_col) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<unsigned*>(&v);
}

// ---------------------------------------------------------------------------
// Shared memory of one block (bytes, every region 16-byte aligned)
//   q_s    [kRows][ld] T          query rows, zero past dh and past the rows
//   bias_s [C] f32                log(max(count, 1e-9)) of each centroid,
//                                 -inf for a count of 0 (masked)
//   live_s [kRows] int            row is stored as the softmax average
//   ml_s   [kWarps][kRows][2] f32 each warp's (m, l) per row
//   fac_s  [kWarps][kRows] f32    merge factor exp(m_w - M) per row
//   den_s  [kRows] f32            max(sum_w l_w fac_w, 1e-30) per row
//   area   per warp kStages x (K, V) tiles [kTile][ld] T while walking;
//          then [kWarps][kRows][DhP] f32 accumulators for the merge
// ---------------------------------------------------------------------------

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

template <typename T, int DhP>
struct Smem {
  static constexpr int ld = row_stride<T, DhP>();
  static constexpr size_t kStageElems = 2 * kTile * ld;   // K then V
  static constexpr size_t kWalkBytes =
      (size_t)kWarps * Traits<T>::kStages * kStageElems * sizeof(T);
  static constexpr size_t kMergeBytes = (size_t)kWarps * kRows * DhP * 4;
  static constexpr size_t kAreaBytes =
      kWalkBytes > kMergeBytes ? kWalkBytes : kMergeBytes;
  static constexpr size_t kQ = 0;
  static constexpr size_t kCnt = align16(kRows * ld * sizeof(T));

  __host__ __device__ static size_t live(int C) {
    return kCnt + align16((size_t)C * 4);
  }
  __host__ __device__ static size_t ml(int C) {
    return live(C) + align16(kRows * 4);
  }
  __host__ __device__ static size_t fac(int C) {
    return ml(C) + align16(kWarps * kRows * 2 * 4);
  }
  __host__ __device__ static size_t den(int C) {
    return fac(C) + align16(kWarps * kRows * 4);
  }
  __host__ __device__ static size_t area(int C) {
    return den(C) + align16(kRows * 4);
  }
  __host__ __device__ static size_t bytes(int C) {
    return area(C) + kAreaBytes;
  }
};

template <typename T, int DhP>
struct BlockSmem {
  T* q_s;
  float* bias_s;
  int* live_s;
  float* ml_s;
  float* fac_s;
  float* den_s;
  unsigned char* area;

  __device__ BlockSmem(unsigned char* base, int C) {
    using S = Smem<T, DhP>;
    q_s = reinterpret_cast<T*>(base + S::kQ);
    bias_s = reinterpret_cast<float*>(base + S::kCnt);
    live_s = reinterpret_cast<int*>(base + S::live(C));
    ml_s = reinterpret_cast<float*>(base + S::ml(C));
    fac_s = reinterpret_cast<float*>(base + S::fac(C));
    den_s = reinterpret_cast<float*>(base + S::den(C));
    area = base + S::area(C);
  }
};

// Visibility of the entries for one query row: centroid entries with
// count > 0 when cent_ok; ring entries at positions lo <= pos < hi.  live:
// the row is stored as the softmax average (else zeros).
struct RowMask {
  int cent_ok;
  int lo;
  int hi;
  int live;
};

__device__ __forceinline__ RowMask dead_row() { return RowMask{0, 1, 0, 0}; }

// Stage the block's query rows, its centroids' log-count biases and each
// row's live flag.  q_row(r) is block row r's Dh query elements, or
// nullptr for an empty place (r < kRows); cnt_at(c) is the count of
// centroid c.  Query rows are read as 16-byte vectors (dh % kVec == 0 and
// 16-byte aligned rows, which the wrappers check).  Ends with a block
// barrier.
template <typename T, int DhP, typename QRow, typename CntAt, typename Mask>
__device__ __forceinline__ void stage_block(const BlockSmem<T, DhP>& sm,
                                            int dh, int C, const QRow& q_row,
                                            const CntAt& cnt_at,
                                            const Mask& row_mask) {
  constexpr int ld = row_stride<T, DhP>();
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVpr = DhP / kVec;
  for (int idx = threadIdx.x; idx < kRows * kVpr; idx += kThreads) {
    const int r = idx / kVpr, d0 = (idx % kVpr) * kVec;
    const T* q = q_row(r);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q != nullptr && d0 < dh) v = *reinterpret_cast<const uint4*>(q + d0);
    *reinterpret_cast<uint4*>(sm.q_s + r * ld + d0) = v;
  }
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float n = cnt_at(c);
    sm.bias_s[c] = n > 0.f ? logf(fmaxf(n, 1e-9f)) : -INFINITY;
  }
  if (threadIdx.x < kRows) sm.live_s[threadIdx.x] = row_mask(threadIdx.x).live;
  __syncthreads();
}

// One warp's online-softmax state for the 16 rows in the mma accumulator
// layout: lane holds rows lane/4 (index 0) and lane/4 + 8 (index 1), and
// dims 8 j + 2 (lane % 4) + {0, 1} of each in o[j][0..1] / o[j][2..3].
template <int DhP>
struct WarpState {
  float m[2];
  float l[2];
  float o[DhP / 8][4];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = kNeg;
      l[i] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < DhP / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[j][c] = 0.f;
  }
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Where an entry's Dh rows live.  A source carries the bases and strides
// and encodes each entry as one int, row(ge): -(r + 1) for centroid row r
// of kc / vc, r >= 0 for row r of kr / vr; an entry's keys start at
// base + row * row_elems + head_off.
//
// Issue one tile of kTile entries starting at entry e0 into a stage
// buffer (K rows then V rows, [kTile][ld] each).  Lane l < kTile holds in
// code the row code of entry e0 + l; the lanes loading an entry read it
// by a shuffle.  Entries past n_entries and dims past dh are zero-filled.
template <typename T, int DhP, typename Src>
__device__ __forceinline__ void load_tile(T* buf, const Src& src, int code,
                                          int e0, int n_entries, int dh) {
  constexpr int ld = row_stride<T, DhP>();
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVpr = DhP / kVec;               // 16-byte vectors per row
  static_assert(kTile * kVpr % 32 == 0, "whole rounds of the warp");
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kTile * kVpr / 32; ++k) {
    const int idx = lane + 32 * k;
    const int e = idx / kVpr, d0 = (idx % kVpr) * kVec;
    const int c = __shfl_sync(0xffffffffu, code, e);
    const bool ok = e0 + e < n_entries && d0 < dh;
    const bool cent = c < 0;
    const size_t off =
        (size_t)(cent ? -c - 1 : c) * src.row_elems + src.head_off + d0;
    const T* kp = ok ? (cent ? src.kc : src.kr) + off : src.kc;
    const T* vp = ok ? (cent ? src.vc : src.vr) + off : src.vc;
    cp_async16(buf + e * ld + d0, kp, ok);
    cp_async16(buf + (kTile + e) * ld + d0, vp, ok);
  }
}

// s[n][c] = q . k for the lane's accumulator places (n-block n of 8
// entries; c as in WarpState) over the staged tile.
template <int DhP>
__device__ __forceinline__ void tile_scores(const __nv_bfloat16* q_s,
                                            const __nv_bfloat16* k_s,
                                            float (&s)[2][4]) {
  constexpr int ld = row_stride<__nv_bfloat16, DhP>();
  const int lane = threadIdx.x & 31;
  const int mi = lane >> 3, ri = lane & 7;
  // A (query rows): matrices (rows 0-7 | 8-15) x (dims lo | hi)
  const __nv_bfloat16* qa = q_s + ((mi & 1) * 8 + ri) * ld + (mi >> 1) * 8;
  // B (keys): matrices (entries 0-7 | 8-15) x (dims lo | hi)
  const __nv_bfloat16* kb = k_s + ((mi >> 1) * 8 + ri) * ld + (mi & 1) * 8;
  // even and odd k-steps in two accumulators: two chains of dependent
  // mma instead of one, summed at the end
  float s2[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[n][c] = s2[n][c] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DhP / 16; ++ks) {
    unsigned a[4], b[4];
    ldmatrix_x4(a, qa + 16 * ks);
    ldmatrix_x4(b, kb + 16 * ks);
    float (&acc)[2][4] = ks % 2 ? s2 : s;
    mma_bf16(acc[0], a, b[0], b[1]);
    mma_bf16(acc[1], a, b[2], b[3]);
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[n][c] = __fadd_rn(s[n][c], s2[n][c]);
}

template <int DhP>
__device__ __forceinline__ void tile_scores(const float* q_s, const float* k_s,
                                            float (&s)[2][4]) {
  constexpr int ld = row_stride<float, DhP>();
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
  for (int d = 0; d < DhP; d += 4) {
    const float4 q0 = *reinterpret_cast<const float4*>(q_s + g * ld + d);
    const float4 q1 = *reinterpret_cast<const float4*>(q_s + (g + 8) * ld + d);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float4 k = *reinterpret_cast<const float4*>(
            k_s + (8 * n + 2 * t + j) * ld + d);
        float a0 = s[n][j], a1 = s[n][2 + j];
        a0 = fmaf(q0.x, k.x, a0);
        a0 = fmaf(q0.y, k.y, a0);
        a0 = fmaf(q0.z, k.z, a0);
        a0 = fmaf(q0.w, k.w, a0);
        a1 = fmaf(q1.x, k.x, a1);
        a1 = fmaf(q1.y, k.y, a1);
        a1 = fmaf(q1.z, k.z, a1);
        a1 = fmaf(q1.w, k.w, a1);
        s[n][j] = a0;
        s[n][2 + j] = a1;
      }
  }
}

// o += p . v over the staged tile, p in the accumulator layout of s.
template <int DhP>
__device__ __forceinline__ void tile_pv(const float (&p)[2][4],
                                        const __nv_bfloat16* v_s,
                                        WarpState<DhP>& st) {
  constexpr int ld = row_stride<__nv_bfloat16, DhP>();
  const int lane = threadIdx.x & 31;
  const int mi = lane >> 3, ri = lane & 7;
  // the score accumulators of n-blocks 0 and 1 are the A fragment of the
  // p . v product (k = the tile's 16 entries); p = hi + lo in bf16
  unsigned hi[4], lo[4];
  const float src[4][2] = {{p[0][0], p[0][1]}, {p[0][2], p[0][3]},
                           {p[1][0], p[1][1]}, {p[1][2], p[1][3]}};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat16 h0 = __float2bfloat16_rn(src[i][0]);
    const __nv_bfloat16 h1 = __float2bfloat16_rn(src[i][1]);
    hi[i] = pack_bf16(__bfloat162float(h0), __bfloat162float(h1));
    lo[i] = pack_bf16(src[i][0] - __bfloat162float(h0),
                      src[i][1] - __bfloat162float(h1));
  }
  // B (values, transposed): matrices (entries 0-7 | 8-15) x (dims 8j |
  // 8j + 8)
  const __nv_bfloat16* vb = v_s + ((mi & 1) * 8 + ri) * ld + (mi >> 1) * 8;
#pragma unroll
  for (int j = 0; j < DhP / 8; j += 2) {
    unsigned b[4];
    ldmatrix_x4_trans(b, vb + 8 * j);
    mma_bf16(st.o[j], hi, b[0], b[1]);
    mma_bf16(st.o[j], lo, b[0], b[1]);
    mma_bf16(st.o[j + 1], hi, b[2], b[3]);
    mma_bf16(st.o[j + 1], lo, b[2], b[3]);
  }
}

template <int DhP>
__device__ __forceinline__ void tile_pv(const float (&p)[2][4],
                                        const float* v_s,
                                        WarpState<DhP>& st) {
  constexpr int ld = row_stride<float, DhP>();
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int quad = lane & ~3;
  // entries in order; p of (row, entry e) lives in lane quad + (e % 8) / 2
#pragma unroll
  for (int e = 0; e < kTile; ++e) {
    const int n = e >> 3, j = e & 1;
    const float p0 = __shfl_sync(0xffffffffu, p[n][j], quad + ((e & 7) >> 1));
    const float p1 =
        __shfl_sync(0xffffffffu, p[n][2 + j], quad + ((e & 7) >> 1));
    const float* vr = v_s + e * ld + 2 * t;
#pragma unroll
    for (int jj = 0; jj < DhP / 8; ++jj) {
      const float2 v = *reinterpret_cast<const float2*>(vr + 8 * jj);
      st.o[jj][0] = fmaf(p0, v.x, st.o[jj][0]);
      st.o[jj][1] = fmaf(p0, v.y, st.o[jj][1]);
      st.o[jj][2] = fmaf(p1, v.x, st.o[jj][2]);
      st.o[jj][3] = fmaf(p1, v.y, st.o[jj][3]);
    }
  }
}

// Walk this warp's tiles of the C + R entries [C centroids (+) ring
// offsets 0..R-1] and fold each into st.
//   src            entry rows of this block's kv head (see load_tile)
//   tw             ring watermark: ring offset s holds position s while
//                  tw <= R, else tw - R + ((s - tw) mod R), a floor mod
//   rm[i]          the masks of the lane's rows lane/4 + 8 i
//   stage()        stages the block (stage_block); called by every
//                  thread once this warp's first loads are in flight, so
//                  their latency and the staging's overlap
// The row codes of a tile are computed one tile ahead of its loads, so a
// source that reads a block table has that read off the critical path.
template <typename T, int DhP, typename Src, typename Stage>
__device__ __forceinline__ void walk_entries(const BlockSmem<T, DhP>& sm,
                                             const Src& src, int C, int R,
                                             int tw, int dh, float scale,
                                             float softcap,
                                             const RowMask (&rm)[2],
                                             WarpState<DhP>& st,
                                             const Stage& stage) {
  constexpr int S = Traits<T>::kStages;
  constexpr int ld = row_stride<T, DhP>();
  constexpr size_t kStage = Smem<T, DhP>::kStageElems;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int n_entries = C + R;
  const int n_tiles = (n_entries + kTile - 1) / kTile;
  const int n_mine =
      n_tiles > warp ? (n_tiles - warp + kWarps - 1) / kWarps : 0;
  T* stage_buf = reinterpret_cast<T*>(sm.area) + (size_t)warp * S * kStage;
  // (s - tw) mod R = (s - tw_mod) mod R, and s - tw_mod lies in (-R, R)
  const int tw_mod = ((tw % R) + R) % R;
  auto code_of = [&](int i) {        // row code of entry lane % kTile
    const int ge = (warp + i * kWarps) * kTile + (lane & (kTile - 1));
    return i < n_mine && ge < n_entries ? src.row(ge) : 0;
  };
  auto issue = [&](int i, int code) {  // this warp's i-th tile -> i % S
    if (i < n_mine)
      load_tile<T, DhP>(stage_buf + (i % S) * kStage, src, code,
                        (warp + i * kWarps) * kTile, n_entries, dh);
    cp_async_commit();
  };
  int code = code_of(0);
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    issue(i, code);
    code = code_of(i + 1);
  }
  stage();
  for (int i = 0; i < n_mine; ++i) {
    issue(i + S - 1, code);
    code = code_of(i + S);
    const int e0 = (warp + i * kWarps) * kTile;
    // the lane's four entries: 8 n + 2 t + j
    int pos[2][2];
    float bias[2][2];
    bool ok[2][2];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ge = e0 + 8 * n + 2 * t + j;
        pos[n][j] = -2;                 // centroid; -3: past the end
        bias[n][j] = 0.f;
        ok[n][j] = false;
        if (ge < C) {
          bias[n][j] = sm.bias_s[ge];
          ok[n][j] = bias[n][j] > -INFINITY;
        } else if (ge < n_entries) {
          const int s = ge - C, v = s - tw_mod;
          pos[n][j] = tw <= R ? s : tw - R + (v < 0 ? v + R : v);
        } else {
          pos[n][j] = -3;
        }
      }
    cp_async_wait<S - 1>();
    __syncwarp();
    const T* k_s = stage_buf + (i % S) * kStage;
    const T* v_s = k_s + kTile * ld;
    float sc[2][4];
    tile_scores<DhP>(sm.q_s, k_s, sc);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = c & 1, r = c >> 1;
        float s = __fmul_rn(sc[n][c], scale);
        if (softcap > 0.f)
          s = __fmul_rn(tanhf(__fdiv_rn(s, softcap)), softcap);
        const int ps = pos[n][j];
        const bool vis = ps == -2 ? rm[r].cent_ok && ok[n][j]
                                  : ps >= 0 && rm[r].lo <= ps && ps < rm[r].hi;
        s = vis ? __fadd_rn(s, bias[n][j]) : kNeg;
        sc[n][c] = s;
        mx[r] = fmaxf(mx[r], s);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(st.m[r], quad_max(mx[r]));
      corr[r] = __expf(st.m[r] - m_new);
      st.m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1;
        const float p =
            pos[n][c & 1] == -3 ? 0.f : __expf(sc[n][c] - st.m[r]);
        sc[n][c] = p;
        sum[r] += p;
      }
    // l stays a per-lane partial sum (the quad's lanes share m), reduced
    // over the quad once, in finish_rows
#pragma unroll
    for (int r = 0; r < 2; ++r)
      st.l[r] = __fadd_rn(__fmul_rn(st.l[r], corr[r]), sum[r]);
    // a factor of 1 leaves acc as it is: skip the multiplies when the
    // running max of no row of the warp moved
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int jj = 0; jj < DhP / 8; ++jj) {
        st.o[jj][0] *= corr[0];
        st.o[jj][1] *= corr[0];
        st.o[jj][2] *= corr[1];
        st.o[jj][3] *= corr[1];
      }
    }
    tile_pv<DhP>(sc, v_s, st);
    __syncwarp();
  }
  cp_async_wait<0>();
}

// Merge the warps' states in warp order: per row r, M = max_w m_w,
// f_w = exp(m_w - M), l = sum_w l_w f_w (den_s[r] = max(l, 1e-30)), then
// row_stat(r, M, l) for r < kRows; and for each row with row_ok(r) and
// each group of kVec dims d0 < dh, emit(r, d0, a) with a[j] = sum_w
// acc_w[r][d0 + j] f_w, unnormalised.  Every thread of the block must call
// it.
template <typename T, int DhP, typename RowOk, typename RowStat,
          typename Emit>
__device__ __forceinline__ void merge_warps(const BlockSmem<T, DhP>& sm,
                                            const WarpState<DhP>& st, int dh,
                                            const RowOk& row_ok,
                                            const RowStat& row_stat,
                                            const Emit& emit) {
  constexpr int kVec = 16 / sizeof(T);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float* acc = reinterpret_cast<float*>(sm.area);   // [kWarps][kRows][DhP]
  __syncthreads();                                  // every walk is done
  float* mine = acc + (size_t)warp * kRows * DhP;
#pragma unroll
  for (int j = 0; j < DhP / 8; ++j) {
    const int d = 8 * j + 2 * t;
    *reinterpret_cast<float2*>(mine + g * DhP + d) =
        make_float2(st.o[j][0], st.o[j][1]);
    *reinterpret_cast<float2*>(mine + (g + 8) * DhP + d) =
        make_float2(st.o[j][2], st.o[j][3]);
  }
  const float l0 = quad_sum(st.l[0]), l1 = quad_sum(st.l[1]);
  if (t == 0) {
    float* ml = sm.ml_s + (size_t)warp * kRows * 2;
    ml[2 * g] = st.m[0];
    ml[2 * g + 1] = l0;
    ml[2 * (g + 8)] = st.m[1];
    ml[2 * (g + 8) + 1] = l1;
  }
  __syncthreads();
  if (threadIdx.x < kRows) {
    const int r = threadIdx.x;
    float m = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      m = fmaxf(m, sm.ml_s[(w * kRows + r) * 2]);
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = __expf(sm.ml_s[(w * kRows + r) * 2] - m);
      sm.fac_s[w * kRows + r] = f;
      l = __fmaf_rn(sm.ml_s[(w * kRows + r) * 2 + 1], f, l);
    }
    sm.den_s[r] = fmaxf(l, 1e-30f);
    row_stat(r, m, l);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kRows * (DhP / kVec); idx += kThreads) {
    const int r = idx / (DhP / kVec), d0 = (idx % (DhP / kVec)) * kVec;
    if (!row_ok(r) || d0 >= dh) continue;
    float a[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      a[j] = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        a[j] = __fmaf_rn(acc[((size_t)w * kRows + r) * DhP + d0 + j],
                         sm.fac_s[w * kRows + r], a[j]);
    }
    emit(r, d0, a);
  }
}

// Merge the warps' states and store each live row's acc / max(l, 1e-30)
// in T (rows not live: zeros).  out_row(r) is the output row of block row
// r, or nullptr to skip it.  Every thread of the block must call it.
template <typename T, int DhP, typename OutRow>
__device__ __forceinline__ void finish_rows(const BlockSmem<T, DhP>& sm,
                                            const WarpState<DhP>& st, int dh,
                                            const OutRow& out_row) {
  constexpr int kVec = 16 / sizeof(T);
  merge_warps<T, DhP>(
      sm, st, dh, [&](int r) { return out_row(r) != nullptr; },
      [](int, float, float) {},
      [&](int r, int d0, const float (&a)[kVec]) {
        alignas(16) T vals[kVec];
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          vals[j] = from_f32<T>(sm.live_s[r] ? a[j] / sm.den_s[r] : 0.f);
        *reinterpret_cast<uint4*>(out_row(r) + d0) =
            *reinterpret_cast<const uint4*>(vals);
      });
}

// Zeros for every stored row of a block that has nothing to score.
template <typename T, typename OutRow>
__device__ __forceinline__ void zero_rows(int dh, const OutRow& out_row) {
  constexpr int kVec = 16 / sizeof(T);
  const int vpr = dh / kVec;
  for (int idx = threadIdx.x; idx < kRows * vpr; idx += kThreads) {
    T* o = out_row(idx / vpr);
    if (o != nullptr)
      *reinterpret_cast<uint4*>(o + (idx % vpr) * kVec) =
          make_uint4(0u, 0u, 0u, 0u);
  }
}

}  // namespace repro
