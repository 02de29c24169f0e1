// Online-softmax row partials shared by the flash-decode and tree-attention
// kernels (plain C interface, built by nvcc for sm_90a, loaded with ctypes).
//
// One CTA owns ROWS query rows of one (batch, kv-head) and walks a range of
// key slots in chunks of CH = 32 (one slot per lane). Each chunk of K and V
// is staged in shared memory as float32; K rows are padded to HD + 1 floats
// so that lane j reading slot j's row is free of bank conflicts. Each warp
// keeps the running (m, l, acc) of RPW rows in registers, so K/V are read
// from device memory once per CTA, not once per row.
//
// Masking contract of the reference (kernels/flash_decode.py::_kernel):
// a masked score is NEG_INF = -1e30, never -inf, so a row with no visible
// slot yet still carries finite (m, l, acc) and no NaN can arise. Slots past
// the range end are not inputs at all and take no part.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace attn {

constexpr float NEG_INF = -1e30f;
constexpr int CH = 32;              // key slots per chunk (one per lane)
constexpr int WARPS = 4;
constexpr int RPW = 8;              // query rows per warp
constexpr int ROWS = WARPS * RPW;   // query rows per CTA
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(ROWS) * HD + size_t(CH) * (HD + 1) + size_t(CH) * HD);
}

// Partials (acc, m, l) of rows [row0, row0 + ROWS) ∩ [0, R) over key slots
// [s_begin, s_end). q: (R, HD) contiguous rows of this (batch, kv-head);
// k/v: slot s at k[s * s_stride + d]; vis(row, s) is the visibility test.
// Outputs are indexed by row: acc[row * HD + d], m[row], l[row].
template <typename T, int HD, class Vis>
__device__ __forceinline__ void rows_partials(
    const T* __restrict__ q, int R, int row0, float scale,
    const T* __restrict__ k, const T* __restrict__ v, long long s_stride,
    int s_begin, int s_end, const Vis& vis,
    float* __restrict__ acc, float* __restrict__ m_out, float* __restrict__ l_out) {
  static_assert(HD % 32 == 0, "head_dim must be a multiple of 32");
  constexpr int NV = HD / 32;
  extern __shared__ float smem[];
  float* qs = smem;                      // ROWS x HD, pre-scaled
  float* ks = qs + ROWS * HD;            // CH x (HD + 1)
  float* vs = ks + CH * (HD + 1);        // CH x HD
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < ROWS * HD; i += THREADS) {
    const int r = i / HD, d = i - r * HD, row = row0 + r;
    qs[i] = row < R ? to_f(q[(long long)row * HD + d]) * scale : 0.f;
  }

  float m_r[RPW], l_r[RPW], a_r[RPW][NV];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m_r[rr] = NEG_INF;
    l_r[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) a_r[rr][i] = 0.f;
  }

  for (int c0 = s_begin; c0 < s_end; c0 += CH) {
    __syncthreads();
    for (int i = tid; i < CH * HD; i += THREADS) {
      const int j = i / HD, d = i - j * HD, s = c0 + j;
      float kk = 0.f, vv = 0.f;
      if (s < s_end) {
        kk = to_f(k[(long long)s * s_stride + d]);
        vv = to_f(v[(long long)s * s_stride + d]);
      }
      ks[j * (HD + 1) + d] = kk;
      vs[j * HD + d] = vv;
    }
    __syncthreads();

    const int s = c0 + lane;
    const bool in_range = s < s_end;
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr, row = row0 + r;
      if (row < R) {                       // uniform across the warp
        float sc = NEG_INF;
        if (in_range && vis(row, s)) {
          float dot = 0.f;
#pragma unroll 8
          for (int d = 0; d < HD; ++d) dot = fmaf(qs[r * HD + d], ks[lane * (HD + 1) + d], dot);
          sc = dot;
        }
        const float c_max = warp_max(in_range ? sc : -INFINITY);
        const float m_new = fmaxf(m_r[rr], c_max);
        const float p = in_range ? expf(sc - m_new) : 0.f;
        const float corr = expf(m_r[rr] - m_new);
        l_r[rr] = l_r[rr] * corr + warp_sum(p);
#pragma unroll
        for (int i = 0; i < NV; ++i) a_r[rr][i] *= corr;
        for (int j = 0; j < CH; ++j) {
          const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
          for (int i = 0; i < NV; ++i) a_r[rr][i] = fmaf(pj, vs[j * HD + lane + 32 * i], a_r[rr][i]);
        }
        m_r[rr] = m_new;
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int row = row0 + warp * RPW + rr;
    if (row < R) {
#pragma unroll
      for (int i = 0; i < NV; ++i) acc[(long long)row * HD + lane + 32 * i] = a_r[rr][i];
      if (lane == 0) {
        m_out[row] = m_r[rr];
        l_out[row] = l_r[rr];
      }
    }
  }
}

// Opts a kernel into the dynamic shared memory it needs (above 48 KB only
// after this attribute is set).
template <class K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace attn
