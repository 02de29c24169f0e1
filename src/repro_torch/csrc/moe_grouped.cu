// Grouped expert GEMM of the dropless mixture-of-experts dispatch, for Hopper
// (sm_90a): every routed expert's product in one launch, with the experts'
// row offsets read on the device.
//
// Replaces: no Pallas kernel. The reference's serving path
// (src/repro/models/moe.py::_dropless_ragged, l.143) sorts the (token,
// expert) pairs by expert and runs `jax.lax.ragged_dot` over the group sizes,
// an XLA op. PyTorch has no float32 grouped GEMM that takes its group sizes on
// the device: a loop of one matmul per expert reads the sizes on the host (a
// sync inside every model call, which a captured round cannot hold), and one
// fixed-shape product of every expert over every row costs E / K times the
// operations (15x for qwen2-moe's 60 experts, top-4).
//
// One launch computes, for each expert e and each of its rows
// [offs[e], offs[e+1]) of x (P, K) (the rows sorted by expert):
//   out = act(x W0[e]) * (x W1[e])     (the gated up projection, W0 = W_gate)
//   out = act(x W0[e])                 (2-matrix experts; the down projection
//                                       with act = identity)
// W0 and W1 are (E, K, N), row-major; offs is (E + 1,) int32 on the device.
//
// Bound on the H100: bytes at the decode path's row counts. A CTA applies its
// expert's (K, 64) weight slice to all of the expert's rows, so each routed
// expert's weights are read once per 32-row tile; a float32 weight element
// feeds 2 operations per row, and the float32 ridge is 67 TFLOP/s / 3.35 TB/s
// = 20 operations a byte, so the product stays below it while an expert has
// fewer than ~40 rows (qwen2-moe's 60 experts at B=4 x T=20 tokens, top-4:
// ~5 rows each).
//
// Design (a first version that is right; wgmma and TMA come later):
//  1. Grid (N / 64 column strips, E experts). A CTA reads its expert's two
//     offsets and exits before it reads any weight when the expert has no
//     row; otherwise it walks the expert's rows in tiles of 32.
//  2. A 3-stage cp.async ring of (32 k) x (64 n) weight tiles (two for the
//     gated product) and (32 rows) x (32 k) row tiles; rows past the
//     expert's segment and k or n past the matrix are zero-filled.
//  3. SIMT float32 fused multiply-adds, 2 rows x 4 columns a thread. Every
//     output element is one thread's chain fmaf(x[k], w[k], acc) over
//     k = 0 .. K-1 in order, whatever the row's position, the row count P or
//     the other experts' rows: the product is batch-invariant by
//     construction, the property lossless verification needs
//     (src/repro/models/moe.py, module docstring). Threads whose rows are
//     all past the segment skip the arithmetic.
//  4. The epilogue applies the activation in float32 (SiLU, or GeLU with the
//     tanh approximation, as jax.nn.gelu) and rounds once to the output type.
//
// Plain C entry points returning cudaError_t, loaded with ctypes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32, BN = 64, BK = 32, THREADS = 256, STAGES = 3;
constexpr int TM = 2, TN = 4;               // outputs of a thread: rows x columns
constexpr int TX = BN / TN;                 // 16 threads across a row tile's columns
static_assert(TX * (BM / TM) == THREADS, "one output block per thread");

enum Act { ACT_NONE = 0, ACT_SILU = 1, ACT_GELU = 2 };

template <typename T>
struct Tile {
  static constexpr int VEC = 16 / sizeof(T);       // elements of one 16-byte copy
  static constexpr int A_LD = BK + VEC;            // padded row tile: 16-byte rows, no bank conflicts
  static constexpr int W_ELEMS = BK * BN;
  static constexpr int A_ELEMS = BM * A_LD;
};

template <typename T, int NW>
__host__ __device__ constexpr int stage_elems() { return NW * Tile<T>::W_ELEMS + Tile<T>::A_ELEMS; }

template <typename T, int NW>
__host__ __device__ constexpr int smem_bytes() { return STAGES * stage_elems<T, NW>() * (int)sizeof(T); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void zero16(void* smem) {
  *reinterpret_cast<uint4*>(smem) = make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// TN = 4 consecutive weights of one k row as floats.
__device__ __forceinline__ void load4(const float* p, float (&w)[TN]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&w)[TN]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  w[0] = lo.x; w[1] = lo.y; w[2] = hi.x; w[3] = hi.y;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[TN]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[TN]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if (ACT == ACT_SILU) return v / (1.0f + expf(-v));
  if (ACT == ACT_GELU) {
    // jax.nn.gelu's default, torch's gelu(approximate="tanh")
    const float inner = 0.7978845608028654f * (v + 0.044715f * v * v * v);
    return 0.5f * v * (1.0f + tanhf(inner));
  }
  return v;
}

// Copy k tile [k0, k0 + BK) of the weight slice (columns [n0, n0 + BN)) of
// each of the NW matrices and of the row tile (rows [row0, row0 + rows))
// into one ring stage; what lies outside is zero-filled.
template <typename T, int NW>
__device__ __forceinline__ void load_stage(T* stage, const T* w0, const T* w1, const T* x, int k0,
                                           int K, int N, int n0, long long row0, int rows,
                                           int tid) {
  using G = Tile<T>;
  constexpr int W_CHUNKS = BK * BN / G::VEC, W_ROW = BN / G::VEC;
#pragma unroll
  for (int it = 0; it < (W_CHUNKS + THREADS - 1) / THREADS; ++it) {
    const int c = tid + it * THREADS;
    if (c >= W_CHUNKS) break;
    const int r = c / W_ROW, ch = c % W_ROW;
    const int k = k0 + r, n = n0 + ch * G::VEC;
    const bool ok = k < K && n < N;
    const long long src = (long long)k * N + n;
    T* dst = stage + r * BN + ch * G::VEC;
    if (ok) cp_async16(dst, w0 + src); else zero16(dst);
    if (NW == 2) {
      if (ok) cp_async16(dst + G::W_ELEMS, w1 + src); else zero16(dst + G::W_ELEMS);
    }
  }
  constexpr int A_CHUNKS = BM * BK / G::VEC, A_ROW = BK / G::VEC;
  T* as = stage + NW * G::W_ELEMS;
#pragma unroll
  for (int it = 0; it < (A_CHUNKS + THREADS - 1) / THREADS; ++it) {
    const int c = tid + it * THREADS;
    if (c >= A_CHUNKS) break;
    const int r = c / A_ROW, ch = c % A_ROW;
    const int k = k0 + ch * G::VEC;
    T* dst = as + r * G::A_LD + ch * G::VEC;
    if (r < rows && k < K) cp_async16(dst, x + (row0 + r) * K + k); else zero16(dst);
  }
}

template <typename T, int NW, int ACT>
__global__ void __launch_bounds__(THREADS) grouped_kernel(
    const T* __restrict__ x, const T* __restrict__ w0, const T* __restrict__ w1,
    const int* __restrict__ offs, T* __restrict__ out, int P, int K, int N) {
  using G = Tile<T>;
  constexpr int STAGE = stage_elems<T, NW>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int e = blockIdx.y;
  const int begin = min(max(offs[e], 0), P);
  const int end = min(max(offs[e + 1], begin), P);
  if (begin >= end) return;                       // no row: no weight is read
  const int n0 = blockIdx.x * BN;
  const long long mat = (long long)K * N;
  const T* we0 = w0 + e * mat;
  const T* we1 = NW == 2 ? w1 + e * mat : nullptr;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int k_tiles = (K + BK - 1) / BK;

  for (int m0 = begin; m0 < end; m0 += BM) {
    const int rows = min(BM, end - m0);
    const bool active = ty * TM < rows;
    float acc[NW][TM][TN];
#pragma unroll
    for (int m = 0; m < NW; ++m)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[m][i][j] = 0.0f;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < k_tiles)
        load_stage<T, NW>(smem + s * STAGE, we0, we1, x, s * BK, K, N, n0, m0, rows, tid);
      cp_async_commit();
    }
    for (int kt = 0; kt < k_tiles; ++kt) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();                              // tile kt landed; stage kt-1 is free
      const int nxt = kt + STAGES - 1;
      if (nxt < k_tiles)
        load_stage<T, NW>(smem + (nxt % STAGES) * STAGE, we0, we1, x, nxt * BK, K, N, n0, m0,
                          rows, tid);
      cp_async_commit();
      if (active) {
        const T* ws = smem + (kt % STAGES) * STAGE;
        const T* as = ws + NW * G::W_ELEMS + ty * TM * G::A_LD;
#pragma unroll 8
        for (int k = 0; k < BK; ++k) {
          float a[TM];
#pragma unroll
          for (int i = 0; i < TM; ++i) a[i] = to_float(as[i * G::A_LD + k]);
#pragma unroll
          for (int m = 0; m < NW; ++m) {
            float w[TN];
            load4(ws + m * G::W_ELEMS + k * BN + tx * TN, w);
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
              for (int j = 0; j < TN; ++j) acc[m][i][j] = fmaf(a[i], w[j], acc[m][i][j]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();                                // the ring is free for the next row tile

    const int n = n0 + tx * TN;
    if (active && n < N) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = ty * TM + i;
        if (r >= rows) continue;
        float v[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j)
          v[j] = NW == 2 ? activate<ACT>(acc[0][i][j]) * acc[NW - 1][i][j]
                         : activate<ACT>(acc[0][i][j]);
        store4(out + (long long)(m0 + r) * N + n, v);
      }
    }
  }
}

template <typename T, int NW, int ACT>
cudaError_t launch(const void* x, const void* w0, const void* w1, const int* offs, void* out,
                   int P, int K, int N, int E, cudaStream_t stream) {
  // set once, at the first launch, so that a later launch can be captured
  static const cudaError_t attr = cudaFuncSetAttribute(
      grouped_kernel<T, NW, ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<T, NW>());
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + BN - 1) / BN, E);
  grouped_kernel<T, NW, ACT><<<grid, THREADS, smem_bytes<T, NW>(), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w0), static_cast<const T*>(w1), offs,
      static_cast<T*>(out), P, K, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w0, const void* w1, const int* offs, void* out,
                     int P, int K, int N, int E, int gated, int act, cudaStream_t s) {
  if (gated) {
    if (act == ACT_SILU) return launch<T, 2, ACT_SILU>(x, w0, w1, offs, out, P, K, N, E, s);
    if (act == ACT_GELU) return launch<T, 2, ACT_GELU>(x, w0, w1, offs, out, P, K, N, E, s);
    return cudaErrorInvalidValue;
  }
  if (act == ACT_NONE) return launch<T, 1, ACT_NONE>(x, w0, w1, offs, out, P, K, N, E, s);
  if (act == ACT_SILU) return launch<T, 1, ACT_SILU>(x, w0, w1, offs, out, P, K, N, E, s);
  if (act == ACT_GELU) return launch<T, 1, ACT_GELU>(x, w0, w1, offs, out, P, K, N, E, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x (P, K), w0 and (gated) w1 (E, K, N), out (P, N), all of one type
// (dtype 0: float32, 1: bfloat16), contiguous and 16-byte aligned, K and N
// multiples of 8; offs (E + 1,) int32 on the device, non-decreasing, with
// offs[E] <= P. act 0: identity, 1: SiLU, 2: GeLU (tanh); gated needs an
// activation. Rows outside every expert's segment are not written.
int moe_grouped(const void* x, const void* w0, const void* w1, const int* offs, void* out, int P,
                int K, int N, int E, int dtype, int gated, int act, void* stream) {
  if (P < 0 || K < 1 || N < 1 || E < 1 || E > 65535 || K % 8 || N % 8 || (gated && !w1))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(x, w0, w1, offs, out, P, K, N, E, gated, act, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(x, w0, w1, offs, out, P, K, N, E, gated, act, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
