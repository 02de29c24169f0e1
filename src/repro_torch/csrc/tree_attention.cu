// Tree-masked attention of the staged draft tokens over each other, for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/tree_attention.py::tree_attention_partial
// (Pallas body `_kernel`), one TPU grid step per (batch, kv-head) with the
// whole padded tree bucket in VMEM.
//
// Bound on the H100: neither bytes nor flops at these sizes (a T = 32
// bucket is 32 KB of float32 K/V per head; B = 1 with 32 heads moves 2 MB
// in all, 0.6 us of HBM) but latency: one load of Q and K/V, one tile of products, one
// write, and enough CTAs in flight that no SM waits on a long tail.
//
// Design: the tensor-core row loop of attn_common.cuh (cp.async staging,
// mma.sync TF32, 3xTF32 for float32 operands) with rows tiled by 16: one
// CTA per (16-row tile, kv-head, batch), so B = 1, KV = 32, T = 32 runs 64
// CTAs (B = 4: 256) where 32-row tiles gave 32. The bucket's T <= 32 keys
// are one key tile; the (B, T, T) ancestor-or-self mask is read per (row,
// slot) with row r*T + t standing for tree node t, and the CTA writes
// un-normalised partials (acc, m, l) that the flash-decode combine merges
// with the cache partials. K/V are read through strides, so the staged
// (B, T, KV, hd) tensors are used in place.
//
// Carried draft KV (`draft_kv="carry"`): a call may take a second key
// segment, the N_s rows a draft scan carries from earlier steps, in their
// own (B, N_s, KV, hd) buffers with their own strides and a (B, T, N_s)
// visibility mask (positional validity folded in by the caller). The TPU
// kernel computes masked partials over a staged key block; here one launch
// walks N_s + T slots, the carried rows first, through one slot functor that
// addresses both pairs of buffers (attn_common.cuh: SHIFT_V), and writes one
// set of partials over both segments. At the draft's shapes (N_s = 5-32
// carried rows, T = 1-2 new ones) the call is latency-bound like the
// one-segment one.
#include "attn_common.cuh"

namespace {

using namespace attn;

struct TreeVis {
  const unsigned char* mask;   // (T, T) of this batch row
  int T;
  __device__ __forceinline__ bool operator()(int row, int s) const {
    return mask[(row % T) * T + s] != 0;
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 2) tree_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const unsigned char* __restrict__ mask, float* __restrict__ acc, float* __restrict__ m,
    float* __restrict__ l, int KV, int R, int Tn, long long k_sb, long long k_sg,
    long long k_st, float scale) {
  const int rt = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const long long bg = (long long)b * KV + g;
  const TreeVis vis{mask + (long long)b * Tn * Tn, Tn};
  rows_partials<T, HD, 1>(q + bg * R * HD, R, rt * 16, scale, k + b * k_sb + g * k_sg,
                          v + b * k_sb + g * k_sg, DenseSlots{k_st}, 0, Tn, vis,
                          acc + bg * R * HD, m + bg * R, l + bg * R);
}

// Elements from b to a (both 16-byte aligned rows of one element type).
template <typename T>
__device__ __forceinline__ long long elems_between(const T* a, const T* b) {
  return ((long long)reinterpret_cast<uintptr_t>(a) - (long long)reinterpret_cast<uintptr_t>(b)) /
         (long long)sizeof(T);
}

// Slots [0, n_s) are the carried rows (from their own buffers), slots
// [n_s, n_s + T) the new rows, all addressed from the new rows' K/V bases.
struct TwoSegSlots {
  static constexpr bool SHIFT_V = true;
  int n_s;
  long long k_st;       // new rows: slot stride
  long long s_st;       // carried rows: slot stride
  long long s_k;        // carried K base - new K base, elements
  long long s_dv;       // (carried V base - new V base) - s_k
  __device__ __forceinline__ long long operator()(int s) const {
    return s < n_s ? s_k + s * s_st : (long long)(s - n_s) * k_st;
  }
  __device__ __forceinline__ long long v_shift(int s) const { return s < n_s ? s_dv : 0; }
};

struct TwoSegVis {
  const unsigned char* smask;   // (T, N_s) of this batch row
  const unsigned char* mask;    // (T, T) of this batch row
  int T, n_s;
  __device__ __forceinline__ bool operator()(int row, int s) const {
    const int t = row % T;
    return s < n_s ? smask[t * n_s + s] != 0 : mask[t * T + s - n_s] != 0;
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 2) tree2_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const unsigned char* __restrict__ mask, const T* __restrict__ ks, const T* __restrict__ vs,
    const unsigned char* __restrict__ smask, float* __restrict__ acc, float* __restrict__ m,
    float* __restrict__ l, int KV, int R, int Tn, int n_s, long long k_sb, long long k_sg,
    long long k_st, long long s_sb, long long s_sg, long long s_st, float scale) {
  const int rt = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const long long bg = (long long)b * KV + g;
  const T* kb = k + b * k_sb + g * k_sg;
  const T* vb = v + b * k_sb + g * k_sg;
  const long long s_k = elems_between(ks + b * s_sb + g * s_sg, kb);
  const long long s_v = elems_between(vs + b * s_sb + g * s_sg, vb);
  const TwoSegSlots slots{n_s, k_st, s_st, s_k, s_v - s_k};
  const TwoSegVis vis{smask + (long long)b * Tn * n_s, mask + (long long)b * Tn * Tn, Tn, n_s};
  rows_partials<T, HD, 1>(q + bg * R * HD, R, rt * 16, scale, kb, vb, slots, 0, n_s + Tn, vis,
                          acc + bg * R * HD, m + bg * R, l + bg * R);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const unsigned char* mask,
                   const void* ks, const void* vs, const unsigned char* smask, float* acc,
                   float* m, float* l, int B, int KV, int R, int Tn, int n_s, long long k_sb,
                   long long k_sg, long long k_st, long long s_sb, long long s_sg, long long s_st,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = Tile<T, HD, 1>::SMEM;
  dim3 grid((R + 15) / 16, KV, B);
  if (n_s == 0) {
    static const cudaError_t smem_err = allow_smem(tree_kernel<T, HD>, smem);
    if (smem_err != cudaSuccess) return smem_err;
    tree_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask, acc,
        m, l, KV, R, Tn, k_sb, k_sg, k_st, scale);
  } else {
    static const cudaError_t smem_err = allow_smem(tree2_kernel<T, HD>, smem);
    if (smem_err != cudaSuccess) return smem_err;
    tree2_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
        static_cast<const T*>(ks), static_cast<const T*>(vs), smask, acc, m, l, KV, R, Tn, n_s,
        k_sb, k_sg, k_st, s_sb, s_sg, s_st, scale);
  }
  return cudaGetLastError();
}

template <typename T, typename... Args>
cudaError_t by_head_dim(int hd, Args... args) {
  switch (hd) {
    case 64: return launch<T, 64>(args...);
    case 128: return launch<T, 128>(args...);
    case 288: return launch<T, 288>(args...);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q (B, KV, R, hd) contiguous; k/v slot t
// of (b, g) at b*k_sb + g*k_sg + t*k_st; mask (B, T, T) bytes. With n_s > 0,
// the carried segment: ks/vs slot s of (b, g) at b*s_sb + g*s_sg + s*s_st,
// smask (B, T, n_s) bytes; with n_s = 0 ks, vs and smask are not read.
// Outputs acc (B, KV, R, hd), m and l (B, KV, R), float32, over both
// segments. hd is 64, 128 or 288 (kernels/flash_decode.py: HEAD_DIMS); any
// other is refused.
int tree_attn(int dtype, const void* q, const void* k, const void* v, const unsigned char* mask,
              const void* ks, const void* vs, const unsigned char* smask, float* acc, float* m,
              float* l, int B, int KV, int R, int Tn, int n_s, int hd, long long k_sb,
              long long k_sg, long long k_st, long long s_sb, long long s_sg, long long s_st,
              float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_s < 0 || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  if (dtype == 0) return by_head_dim<float>(hd, q, k, v, mask, ks, vs, smask, acc, m, l, B, KV, R,
                                            Tn, n_s, k_sb, k_sg, k_st, s_sb, s_sg, s_st, scale, st);
  return by_head_dim<__nv_bfloat16>(hd, q, k, v, mask, ks, vs, smask, acc, m, l, B, KV, R, Tn,
                                    n_s, k_sb, k_sg, k_st, s_sb, s_sg, s_st, scale, st);
}

}  // extern "C"
