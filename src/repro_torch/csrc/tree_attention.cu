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

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const unsigned char* mask,
                   float* acc, float* m, float* l, int B, int KV, int R, int Tn,
                   long long k_sb, long long k_sg, long long k_st, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = Tile<T, HD, 1>::SMEM;
  static const cudaError_t smem_err = allow_smem(tree_kernel<T, HD>, smem);
  if (smem_err != cudaSuccess) return smem_err;
  dim3 grid((R + 15) / 16, KV, B);
  tree_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask, acc,
      m, l, KV, R, Tn, k_sb, k_sg, k_st, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q (B, KV, R, hd) contiguous; k/v slot t
// of (b, g) at b*k_sb + g*k_sg + t*k_st; mask (B, T, T) bytes. Outputs
// acc (B, KV, R, hd), m and l (B, KV, R), float32. Only hd = 128
// (vicuna-7b) is instantiated.
int tree_attn(int dtype, const void* q, const void* k, const void* v, const unsigned char* mask,
              float* acc, float* m, float* l, int B, int KV, int R, int Tn, int hd,
              long long k_sb, long long k_sg, long long k_st, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd != 128) return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float, 128>(q, k, v, mask, acc, m, l, B, KV, R, Tn, k_sb, k_sg, k_st, scale,
                              st);
  if (dtype == 1)
    return launch<__nv_bfloat16, 128>(q, k, v, mask, acc, m, l, B, KV, R, Tn, k_sb, k_sg, k_st,
                                      scale, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
