// flash_decode: one-token exact GQA attention over a (B, S, Hkv, Dh) cache
// for Hopper (sm_90a).
//
// Replaces the TPU kernel _kernel of src/repro/kernels/flash_decode.py
// (launched by flash_decode_pallas): each query head attends to the cache
// positions < t of its kv head, scores scaled, then soft-capped when a cap
// is given, positions >= t masked with NEG = -1e30 (never -inf), output
// acc / max(l, 1e-30) in q's dtype.  The reference walks the cache in
// chunks of `chunk` positions, zero-padded to a multiple of `chunk`; the
// padded positions below t count as keys and values of zeros (score 0).
//
// The TPU grid walks the chunks of one (batch, kv head) in sequence with
// the online-softmax state in VMEM.  On the card this is flash-decoding,
// split finely enough to fill it: block (split, kv head, batch) takes
// `split` consecutive positions (the kernel's own size, not the caller's
// chunk) and writes its split's (m, l, acc) per query head; a second
// launch merges the splits of each query head in split order, so runs
// repeat bit for bit.  A block is the decode kernels' scoring tile
// (clustered_score.cuh): the G query heads of the kv head are rows of the
// 16-row mma tile, the block's four warps split its positions in tiles of
// 16, each staged by 16-byte cp.async two stages deep; q.k and p.v run on
// mma.sync (bf16) or the FMA pipes (f32), math in f32.
//
// The edges follow the reference without touching the padding:
//  * t >= 1: only the real positions below min(t, S) are read; splits at
//    or past them do not exist; every position a split reads is visible.
//    Padded positions in [S, min(t, S + pad)) have score exactly 0 and
//    value 0: the merge adds them as one term (m = 0, l = their count).
//  * t <= 0: every position is masked, so every weight is exp(0) = 1 and
//    the result is the mean of v over the S + pad positions: the splits
//    cover all S real positions (scores NEG) and the merge adds the pad
//    positions as a term (m = NEG, l = pad).
//
// What bounds it: bytes.  Each (batch, kv head) reads the keys and values
// of its visible positions once; q.k and p.v of G <= 8 query rows are a
// few operations per byte, far below the tensor cores' balance.  The
// split keeps several blocks on every SM with their loads in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "clustered_score.cuh"

namespace repro {

constexpr int kMaxG = 8;       // query heads per kv head

// Positions of one split of (batch b, kv head h): entry e is cache row
// row0 + e of k / v (rows of Hkv * dh elements; see load_tile).
template <typename T>
struct SplitSrc {
  const T* kc;
  const T* vc;
  const T* kr;
  const T* vr;
  int row_elems, head_off, row0;

  __device__ __forceinline__ int row(int ge) const { return row0 + ge; }
};

// Block (split, kv head, batch): the split's positions [p0, p0 + n) of
// n_real real positions; visible: t >= 1 (else every score is NEG).
template <typename T, int DhP>
__global__ void __launch_bounds__(kThreads)
split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, int S, int Hq, int Hkv, int dh,
             int split, int n_real, int visible, float scale, float softcap,
             float* __restrict__ part_ml, float* __restrict__ part_acc) {
  const int sp = blockIdx.x, n_sp = gridDim.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int p0 = sp * split;
  const int n = min(split, n_real - p0);
  auto row_mask = [&](int r) -> RowMask {
    return r < G ? RowMask{0, 0, visible ? n : 0, 1} : dead_row();
  };
  extern __shared__ float4 smem4[];          // 16-byte aligned
  const BlockSmem<T, DhP> sm(reinterpret_cast<unsigned char*>(smem4), 0);
  auto stage = [&]() {
    stage_block<T, DhP>(
        sm, dh, 0,
        [&](int r) -> const T* {
          return r < G ? q + ((size_t)b * Hq + h * G + r) * dh : nullptr;
        },
        [](int) { return 0.f; }, row_mask);
  };
  const int lane = threadIdx.x & 31;
  const RowMask rm[2] = {row_mask(lane >> 2), row_mask((lane >> 2) + 8)};
  WarpState<DhP> st;
  st.init();
  const SplitSrc<T> src{k, v, k, v, Hkv * dh, h * dh, b * S + p0};
  walk_entries<T, DhP>(sm, src, 0, n, n, dh, scale, softcap, rm, st, stage);
  // the split's m, l and unnormalised acc of each query head
  const size_t row = (((size_t)b * Hkv + h) * n_sp + sp) * G;
  constexpr int kVec = 16 / sizeof(T);
  merge_warps<T, DhP>(
      sm, st, dh, [&](int r) { return r < G; },
      [&](int r, float m, float l) {
        if (r < G) {
          part_ml[(row + r) * 2] = m;
          part_ml[(row + r) * 2 + 1] = l;
        }
      },
      [&](int r, int d0, const float (&a)[kVec]) {
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          part_acc[(row + r) * dh + d0 + j] = a[j];
      });
}

// merge the splits of query head (b, hq) in split order, then the padded
// positions as one term (m = pad_m, l = pad_l, acc = 0) when pad_l > 0
template <typename T>
__global__ void merge_kernel(const float* __restrict__ part_ml,
                             const float* __restrict__ part_acc, int Hq,
                             int Hkv, int dh, int n_sp, float pad_m,
                             float pad_l, T* __restrict__ out) {
  const int b = blockIdx.y, hq = blockIdx.x;
  const int G = Hq / Hkv, h = hq / G, g = hq - h * G;
  const size_t row0 = ((size_t)b * Hkv + h) * n_sp * G + g;
  float mx = pad_l > 0.f ? pad_m : kNeg;
  for (int c = 0; c < n_sp; ++c)
    mx = fmaxf(mx, part_ml[(row0 + (size_t)c * G) * 2]);
  for (int d = threadIdx.x; d < dh; d += blockDim.x) {
    float l = 0.f, acc = 0.f;
    for (int c = 0; c < n_sp; ++c) {
      const size_t r = row0 + (size_t)c * G;
      const float f = expf(part_ml[r * 2] - mx);
      l = fmaf(part_ml[r * 2 + 1], f, l);
      acc = fmaf(part_acc[r * dh + d], f, acc);
    }
    if (pad_l > 0.f) l = fmaf(pad_l, expf(pad_m - mx), l);
    out[((size_t)b * Hq + hq) * dh + d] = from_f32<T>(acc / fmaxf(l, 1e-30f));
  }
}

template <typename T, int DhP>
int launch_dh(const void* q, const void* k, const void* v, int B, int S,
              int Hq, int Hkv, int dh, int split, int n_real, int visible,
              float pad_m, float pad_l, float scale, float softcap,
              void* scratch, void* out, cudaStream_t s) {
  const size_t smem = Smem<T, DhP>::bytes(0);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(split_kernel<T, DhP>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  const int G = Hq / Hkv;
  const int n_sp = (n_real + split - 1) / split;
  float* part_ml = static_cast<float*>(scratch);
  float* part_acc = part_ml + (size_t)B * Hkv * n_sp * G * 2;
  split_kernel<T, DhP><<<dim3(n_sp, Hkv, B), kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), S, Hq, Hkv, dh, split, n_real, visible,
      scale, softcap, part_ml, part_acc);
  merge_kernel<T><<<dim3(Hq, B), dh < 128 ? dh : 128, 0, s>>>(
      part_ml, part_acc, Hq, Hkv, dh, n_sp, pad_m, pad_l,
      static_cast<T*>(out));
  return (int)cudaGetLastError();
}

// head dims are padded with zeros to 64, 128 or 256 in shared memory
template <typename T>
int launch(const void* q, const void* k, const void* v, int B, int S, int Hq,
           int Hkv, int dh, int split, int n_real, int visible, float pad_m,
           float pad_l, float scale, float softcap, void* scratch, void* out,
           cudaStream_t s) {
  if (dh <= 64)
    return launch_dh<T, 64>(q, k, v, B, S, Hq, Hkv, dh, split, n_real,
                            visible, pad_m, pad_l, scale, softcap, scratch,
                            out, s);
  if (dh <= 128)
    return launch_dh<T, 128>(q, k, v, B, S, Hq, Hkv, dh, split, n_real,
                             visible, pad_m, pad_l, scale, softcap, scratch,
                             out, s);
  return launch_dh<T, 256>(q, k, v, B, S, Hq, Hkv, dh, split, n_real, visible,
                           pad_m, pad_l, scale, softcap, scratch, out, s);
}

}  // namespace repro

// dtype: 0 = f32, 1 = bf16.  q (B, Hq, Dh), k/v (B, S, Hkv, Dh) -> out
// (B, Hq, Dh), rows 16-byte aligned (Dh a multiple of 16 bytes); `chunk`
// is the caller's (the reference's padding), `split` the positions of one
// block (a multiple of 16); scratch of B * Hkv * ceil(S / split) *
// (Hq / Hkv) * (2 + Dh) floats; softcap <= 0 means none.
extern "C" int flash_decode_launch(int dtype, const void* q, const void* k,
                                   const void* v, int B, int S, int Hq,
                                   int Hkv, int Dh, int chunk, int split,
                                   int t, float scale, float softcap,
                                   void* scratch, void* out, void* stream) {
  using namespace repro;
  if (B <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv || Hq / Hkv > kMaxG || Dh <= 0 || Dh > kMaxDh ||
      Dh * (dtype == 1 ? 2 : 4) % 16 || chunk <= 0 || S <= 0 || split <= 0 ||
      split % kTile)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c = chunk < S ? chunk : S;
  const long long s_pad = (long long)(S + c - 1) / c * c;   // S + pad
  const int visible = t > 0;
  const int n_real = visible ? (t < S ? t : S) : S;
  const long long top = visible ? (t < s_pad ? t : s_pad) : s_pad;
  const float pad_l = (float)(top > S ? top - S : 0);
  const float pad_m = visible ? 0.f : kNeg;
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, B, S, Hq, Hkv, Dh, split, n_real,
                                 visible, pad_m, pad_l, scale, softcap,
                                 scratch, out, s);
  return launch<float>(q, k, v, B, S, Hq, Hkv, Dh, split, n_real, visible,
                       pad_m, pad_l, scale, softcap, scratch, out, s);
}
