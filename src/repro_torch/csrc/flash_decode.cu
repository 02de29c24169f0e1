// Flash-decode attention over a committed KV cache, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_decode.py::flash_decode_partial (Pallas
// body `_kernel`). The TPU kernel walks the (B, KV, S/block) grid in order
// and carries m/l/acc in VMEM from one KV block to the next.
//
// Bound on the H100: the bytes of K and V it reads. At B=1, 32 heads and
// T <= 32 query rows per head, each K/V element is used by at most 32 rows,
// far below the ~20 flops per byte at which float32 CUDA-core math would
// take over from the 3.35 TB/s of HBM.
//
// Design: flash-decoding. Blocks run in no order on Hopper, so S is split
// across CTAs, one CTA per (split, kv-head, batch x row-tile); each writes
// un-normalised partials (acc, m, l). A second small kernel combines the
// splits by logsumexp. When the caller hands it the staged-tree partials,
// the combine also performs the verify merge of kernels/ops.py (lines 83-91
// of the reference) and normalises, so the cache partials never make a
// second round trip. K/V are read through strides, so the cache's
// (B, S, KV, hd) layout is used in place and never transposed.
#include "attn_common.cuh"

namespace {

using namespace attn;

struct PosVis {
  const int* kv_pos;   // (S,) of this batch row
  const int* q_pos;    // (R,) of this batch row
  int kind, window, sink;
  __device__ __forceinline__ bool operator()(int row, int s) const {
    const int kp = kv_pos[s], qp = q_pos[row];
    bool ok = kp >= 0 && kp <= qp;
    if (kind == 1) ok = ok && kp > qp - window;
    else if (kind == 2) ok = ok && (kp < sink || kp > qp - window);
    return ok;
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) split_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ kv_pos, const int* __restrict__ q_pos,
    float* __restrict__ acc_p, float* __restrict__ m_p, float* __restrict__ l_p,
    int B, int KV, int R, int S, long long k_sb, long long k_sg, long long k_ss,
    int kind, int window, int sink, float scale, int split_len) {
  const int split = blockIdx.x, g = blockIdx.y;
  const int n_rt = (R + ROWS - 1) / ROWS;
  const int b = blockIdx.z / n_rt, rt = blockIdx.z - b * n_rt;
  const int s_begin = split * split_len;
  const int s_end = min(S, s_begin + split_len);
  const long long bg = (long long)b * KV + g;
  const long long out_row0 = ((long long)split * B * KV + bg) * R;
  const PosVis vis{kv_pos + (long long)b * S, q_pos + (long long)b * R, kind, window, sink};
  rows_partials<T, HD>(q + bg * R * HD, R, rt * ROWS, scale,
                       k + b * k_sb + g * k_sg, v + b * k_sb + g * k_sg, k_ss,
                       s_begin, s_end, vis,
                       acc_p + out_row0 * HD, m_p + out_row0, l_p + out_row0);
}

// One CTA per query row, one thread per head-dim element. Without tree
// partials (acc_d == nullptr) it writes the combined un-normalised partials
// (acc, m, l); with them it writes the merged, normalised output.
__global__ void combine_kernel(
    const float* __restrict__ acc_p, const float* __restrict__ m_p,
    const float* __restrict__ l_p, int n_split, long long rows, int hd,
    const float* __restrict__ acc_d, const float* __restrict__ m_d,
    const float* __restrict__ l_d,
    float* __restrict__ out, float* __restrict__ out_m, float* __restrict__ out_l) {
  const long long row = blockIdx.x;
  const int d = threadIdx.x;
  float m = acc_d ? m_d[row] : -INFINITY;
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, m_p[s * rows + row]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float w = expf(m_p[s * rows + row] - m);
    l = fmaf(l_p[s * rows + row], w, l);
    a = fmaf(acc_p[(s * rows + row) * hd + d], w, a);
  }
  if (acc_d) {
    const float wd = expf(m_d[row] - m);
    out[row * hd + d] = (a + acc_d[row * hd + d] * wd) / fmaxf(l + l_d[row] * wd, 1e-30f);
  } else {
    out[row * hd + d] = a;
    if (d == 0) {
      out_m[row] = m;
      out_l[row] = l;
    }
  }
}

template <typename T, int HD>
cudaError_t launch_split(const void* q, const void* k, const void* v, const int* kv_pos,
                         const int* q_pos, float* acc_p, float* m_p, float* l_p, int B,
                         int KV, int R, int S, long long k_sb, long long k_sg, long long k_ss,
                         int kind, int window, int sink, float scale, int n_split,
                         int split_len, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = allow_smem(split_kernel<T, HD>, smem);
  if (err != cudaSuccess) return err;
  const int n_rt = (R + ROWS - 1) / ROWS;
  dim3 grid(n_split, KV, B * n_rt);
  split_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kv_pos,
      q_pos, acc_p, m_p, l_p, B, KV, R, S, k_sb, k_sg, k_ss, kind, window, sink, scale,
      split_len);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k and v share it). kind: 0 causal,
// 1 window, 2 streaming. Partials are (n_split, B, KV, R[, hd]) float32.
// Only hd = 128 (vicuna-7b) is instantiated.
int fd_split(int dtype, const void* q, const void* k, const void* v, const int* kv_pos,
             const int* q_pos, float* acc_p, float* m_p, float* l_p, int B, int KV, int R,
             int S, int hd, long long k_sb, long long k_sg, long long k_ss, int kind,
             int window, int sink, float scale, int n_split, int split_len, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd != 128) return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_split<float, 128>(q, k, v, kv_pos, q_pos, acc_p, m_p, l_p, B, KV, R, S,
                                    k_sb, k_sg, k_ss, kind, window, sink, scale, n_split,
                                    split_len, st);
  if (dtype == 1)
    return launch_split<__nv_bfloat16, 128>(q, k, v, kv_pos, q_pos, acc_p, m_p, l_p, B, KV, R,
                                            S, k_sb, k_sg, k_ss, kind, window, sink, scale,
                                            n_split, split_len, st);
  return cudaErrorInvalidValue;
}

int fd_combine(const float* acc_p, const float* m_p, const float* l_p, int n_split,
               long long rows, int hd, const float* acc_d, const float* m_d, const float* l_d,
               float* out, float* out_m, float* out_l, void* stream) {
  if (hd > 1024) return cudaErrorInvalidValue;
  combine_kernel<<<(unsigned)rows, hd, 0, static_cast<cudaStream_t>(stream)>>>(
      acc_p, m_p, l_p, n_split, rows, hd, acc_d, m_d, l_d, out, out_m, out_l);
  return cudaGetLastError();
}

}  // extern "C"
