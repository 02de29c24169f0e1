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
// Sums are float32; the activation is applied in float32 (SiLU, or GeLU with
// the tanh approximation, as jax.nn.gelu) and the result rounded once to the
// output type. Rows outside every segment are not written.
//
// Bound on the H100: bytes at the decode path's row counts. Each routed
// expert's weights are read once for up to 64 of its rows; a weight element
// feeds 2 operations a row, so an expert with r rows does r operations a
// weight byte in bfloat16 (r / 2 in float32), far below the ridges of ~295
// (bfloat16 tensor cores, 989 TFLOP/s over 3.35 TB/s) and 20 (float32 FMA,
// 67 TFLOP/s): qwen2-moe at B=4 x T=5 has ~1-5 rows an expert, mixtral at
// 128 tokens ~32. What bounds the kernel is the bytes it keeps in flight.
//
// Batch invariance, the property lossless verification needs
// (src/repro/models/moe.py, module docstring): an output element's sum is
// fixed by (K, N, E, dtype) alone. Both kernels reduce k = 0 .. K-1 in fixed
// chunks in order, with one instruction shape, no split of K and no atomics,
// whatever the row's position in its tile, the row count P or the other
// experts' rows; rows past a segment's end share the tile but never a sum.
//
// bfloat16 (grouped_wgmma_kernel): tensor cores fed by the Tensor Memory
// Accelerator.
//  1. Swap-AB: out^T = W^T x^T. A 64-column strip of W^T is wgmma's M = 64
//     operand, read from shared memory in N-major order (W's own layout, no
//     transpose); 64 rows of x are its n = 64 operand, K-major. One
//     instruction shape, wgmma.m64n64k16 bf16 x bf16 -> f32, for every
//     shape; a CTA's strip is 128 columns (two wgmmas a k step, four
//     warps x 16 columns each), and the launch plan
//     (kernels/moe_grouped.py::_plan, from K, N, E and the type only) picks
//     the ring's depth.
//  2. Grid (N / 128, E). A CTA reads its expert's two offsets and exits
//     before any load when the expert has no row. One producer warp issues
//     cp.async.bulk.tensor loads (128-byte swizzle) into a ring of stages of
//     64 k: the weight tiles (64 k x 64 n, 8 KB each) through a 3-D tensor
//     map over (E, K, N), so k or n past the matrix is zero-filled and never
//     reads the next expert, and the row tile (64 rows x 64 k) at row offs[e]
//     through a 2-D map over x; rows past P are zero-filled, rows past the
//     segment belong to the next expert and only feed outputs never stored.
//     Full and empty mbarriers hand the stages between the producer and the
//     consumer warpgroup, which issues the wgmmas of a stage and waits for
//     them before it frees the stage.
//  3. Experts with more than 64 rows loop over row tiles and stream their
//     weights once a tile (prefill; the decode and verify row counts fit
//     one tile).
//  4. The epilogue applies the activation to the float32 accumulators in
//     registers and stores bfloat16 elements masked to [begin, end) x [0, N):
//     a whole-tile store would overwrite the next expert's rows, which
//     another CTA writes.
//  5. The tensor maps are encoded on the host (cuTensorMapEncodeTiled,
//     reached through cudaGetDriverEntryPoint, no -lcuda) and passed as
//     __grid_constant__ parameters; the weights' maps are cached by (pointer,
//     shape), the rows' map is encoded each launch. A captured launch bakes
//     both into its graph node, which is right because capture replays on
//     the same buffers.
//
// float32 (grouped_kernel): SIMT FMA chains. A float32 sum within 1e-4 of
// the plain version needs float32 products; TF32 tensor cores (10-bit
// mantissas) would miss that tolerance, and the kernel reaches 0.7-0.9 of
// its byte bound on an H100 at the decode row counts (PERF.md).
//  1. Grid (N / 64 column strips, E experts). A CTA reads its expert's two
//     offsets and exits before it reads any weight when the expert has no
//     row; otherwise it walks the expert's rows in tiles of 32.
//  2. A 3-stage cp.async ring of (32 k) x (64 n) weight tiles (two for the
//     gated product) and (32 rows) x (32 k) row tiles; rows past the
//     expert's segment and k or n past the matrix are zero-filled.
//  3. Float32 fused multiply-adds, 2 rows x 4 columns a thread. Every output
//     element is one thread's chain fmaf(x[k], w[k], acc) over k = 0 .. K-1
//     in order. Threads whose rows are all past the segment skip the
//     arithmetic.
//  4. The epilogue applies the activation in float32 and stores float4s.
//
// Plain C entry points returning cudaError_t, loaded with ctypes.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <unordered_map>

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

// TN = 4 consecutive weights of one k row as floats.
__device__ __forceinline__ void load4(const float* p, float (&w)[TN]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[TN]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
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

// ---------------------------------------------------------------- bfloat16: wgmma over TMA
namespace wg {

constexpr int RN = 64;                    // rows of x a tile: wgmma's n, fixed
constexpr int BK = 64;                    // k a stage: one 128-byte swizzle row of bfloat16
constexpr int CHUNK = 64;                 // output columns a wgmma: its m
constexpr int MC = 2;                     // wgmmas a k step: a CTA's strip of 128 columns
constexpr int STRIP = MC * CHUNK;
constexpr int CONSUMERS = 128;            // one warpgroup issues the wgmmas
constexpr int THREADS = CONSUMERS + 32;   // and one warp the loads
constexpr uint32_t W_TILE = BK * CHUNK * 2;   // 8 KB: 64 k x 64 n, 128-byte rows
constexpr uint32_t X_TILE = RN * BK * 2;      // 8 KB: 64 rows x 64 k
constexpr uint32_t SWIZZLE_ATOM = 1024;       // 8 rows of 128 bytes
constexpr int MAX_SMEM = 232448;              // 227 KB, a block's most on sm_90

template <int NW>
__host__ __device__ constexpr uint32_t stage_bytes() { return NW * MC * W_TILE + X_TILE; }

// the ring's stages, their full and empty barriers, and room to align the
// ring to the 1024 bytes that the 128-byte swizzle repeats over
template <int NW>
__host__ __device__ constexpr size_t smem_bytes(int stages) {
  return SWIZZLE_ATOM + (size_t)stages * (stage_bytes<NW>() + 16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// D (64 x 64, f32) += A (64 x 16, from an N-major tile) * B (16 x 64, K-major).
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// keeps the compiler from moving accumulator reads and writes across the
// asynchronous wgmmas
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

}  // namespace wg

template <int NW, int ACT>
__global__ void __launch_bounds__(wg::THREADS, 1) grouped_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w0,
    const __grid_constant__ CUtensorMap tm_w1, const int* __restrict__ offs,
    __nv_bfloat16* __restrict__ out, int P, int K, int N, int stages) {
  using namespace wg;
  constexpr int BK = wg::BK;                      // not the SIMT kernel's
  constexpr uint32_t STAGE = stage_bytes<NW>();
  const int e = blockIdx.y;
  const int begin = min(max(offs[e], 0), P);
  const int end = min(max(offs[e + 1], begin), P);
  if (begin >= end) return;                       // no row: no weight is read

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + SWIZZLE_ATOM - 1) & ~(SWIZZLE_ATOM - 1);
  const uint32_t full = ring + stages * STAGE;    // stages barriers, then the empty ones
  const uint32_t empty = full + 8 * stages;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);                 // the producer's arrival and the bytes
      mbar_init(empty + 8 * s, CONSUMERS);        // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n0 = blockIdx.x * STRIP;
  const int k_tiles = (K + BK - 1) / BK;
  const int steps = (end - begin + RN - 1) / RN * k_tiles;

  if (tid >= CONSUMERS) {                         // the producer warp: one thread loads
    if (tid == CONSUMERS) {
      int s = 0;
      uint32_t phase = 0;
      for (int it = 0; it < steps; ++it) {
        const int rt = it / k_tiles, k0 = (it - rt * k_tiles) * BK;
        mbar_wait(empty + 8 * s, phase ^ 1);
        const uint32_t st = ring + s * STAGE, bar = full + 8 * s;
        mbar_expect_tx(bar, STAGE);
#pragma unroll
        for (int c = 0; c < MC; ++c) {
          tma_load_3d(st + c * W_TILE, &tm_w0, bar, n0 + c * CHUNK, k0, e);
          if (NW == 2) tma_load_3d(st + (MC + c) * W_TILE, &tm_w1, bar, n0 + c * CHUNK, k0, e);
        }
        tma_load_2d(st + NW * MC * W_TILE, &tm_x, bar, k0, begin + rt * RN);
        if (++s == stages) { s = 0; phase ^= 1; }
      }
    }
    return;
  }

  const int warp = tid / 32, lane = tid % 32;
  int s = 0;
  uint32_t phase = 0;
  for (int row0 = begin; row0 < end; row0 += RN) {
    float acc[NW][MC][32];
#pragma unroll
    for (int m = 0; m < NW; ++m)
#pragma unroll
      for (int c = 0; c < MC; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[m][c][i] = 0.0f;
    for (int kt = 0; kt < k_tiles; ++kt) {
      mbar_wait(full + 8 * s, phase);
      const uint32_t st = ring + s * STAGE;
#pragma unroll
      for (int m = 0; m < NW; ++m)
#pragma unroll
        for (int c = 0; c < MC; ++c) fence_acc(acc[m][c]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // rows: K-major, 16 k = 32 bytes along each swizzled 128-byte row
        const uint64_t b = desc(st + NW * MC * W_TILE + kk * 32, 16, SWIZZLE_ATOM);
#pragma unroll
        for (int m = 0; m < NW; ++m)
#pragma unroll
          for (int c = 0; c < MC; ++c) {
            // weights: N-major, 16 k = 16 rows of 128 bytes; the next 8 k
            // rows one swizzle atom on, the next 64 columns one tile on
            const uint64_t a = desc(st + (m * MC + c) * W_TILE + kk * 16 * 128, W_TILE,
                                    SWIZZLE_ATOM);
            wgmma_m64n64k16(acc[m][c], a, b);
          }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int m = 0; m < NW; ++m)
#pragma unroll
        for (int c = 0; c < MC; ++c) fence_acc(acc[m][c]);
      mbar_arrive(empty + 8 * s);
      if (++s == stages) { s = 0; phase ^= 1; }
    }

    // accumulator i of a thread: column 16 warp + lane / 4 + 8 ((i / 2) % 2) of
    // the 64-column chunk, row 8 (i / 4) + 2 (lane % 4) + i % 2 of the tile
#pragma unroll
    for (int c = 0; c < MC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = n0 + c * CHUNK + 16 * warp + lane / 4 + 8 * ((i >> 1) & 1);
        const int row = row0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        if (row < end && col < N) {
          const float v = NW == 2 ? activate<ACT>(acc[0][c][i]) * acc[NW - 1][c][i]
                                  : activate<ACT>(acc[0][c][i]);
          out[(long long)row * N + col] = __float2bfloat16_rn(v);
        }
      }
  }
}

namespace wg {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime: no link to libcuda.
EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bfloat16 tensor map with 64 x 64 boxes (of the innermost two dims) and
// the 128-byte swizzle; what lies outside the tensor is zero-filled.
bool encode(CUtensorMap* map, const void* base, cuuint32_t rank, const cuuint64_t* dims,
            const cuuint64_t* strides) {
  const EncodeTiled fn = encoder();
  const cuuint32_t box[3] = {64, 64, 1}, ones[3] = {1, 1, 1};
  return fn && fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
                  strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct WeightKey {
  const void* ptr;
  int E, K, N;
  bool operator==(const WeightKey& o) const {
    return ptr == o.ptr && E == o.E && K == o.K && N == o.N;
  }
};

struct WeightKeyHash {
  size_t operator()(const WeightKey& k) const {
    size_t h = std::hash<const void*>()(k.ptr);
    for (int v : {k.E, k.K, k.N}) h = h * 1000003u ^ std::hash<int>()(v);
    return h;
  }
};

// An (E, K, N) weight's map, over dims (N, K, E), cached by pointer and
// shape: the same pair always encodes the same map. ctypes calls drop the
// GIL, so the cache takes a lock.
bool weight_map(CUtensorMap* map, const void* w, int E, int K, int N) {
  static std::mutex mu;
  static std::unordered_map<WeightKey, CUtensorMap, WeightKeyHash> cache;
  const WeightKey key{w, E, K, N};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return true;
  }
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)N * 2, (cuuint64_t)K * N * 2};
  if (!encode(map, w, 3, dims, strides)) return false;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return true;
}

template <int NW, int ACT>
cudaError_t launch(const void* x, const void* w0, const void* w1, const int* offs, void* out,
                   int P, int K, int N, int E, int stages, cudaStream_t stream) {
  // set once, at the first launch, so that a later launch can be captured
  static const cudaError_t attr = cudaFuncSetAttribute(
      grouped_wgmma_kernel<NW, ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return attr;
  const size_t smem = smem_bytes<NW>(stages);
  if (stages < 2 || smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  CUtensorMap tx, t0, t1;
  const cuuint64_t x_dims[2] = {(cuuint64_t)K, (cuuint64_t)P};
  const cuuint64_t x_strides[1] = {(cuuint64_t)K * 2};
  if (!encode(&tx, x, 2, x_dims, x_strides) || !weight_map(&t0, w0, E, K, N) ||
      (NW == 2 && !weight_map(&t1, w1, E, K, N)))
    return cudaErrorInvalidValue;
  if (NW == 1) t1 = t0;
  const dim3 grid((N + STRIP - 1) / STRIP, E);
  grouped_wgmma_kernel<NW, ACT><<<grid, THREADS, smem, stream>>>(
      tx, t0, t1, offs, static_cast<__nv_bfloat16*>(out), P, K, N, stages);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* x, const void* w0, const void* w1, const int* offs, void* out,
                     int P, int K, int N, int E, int gated, int act, int stages, cudaStream_t s) {
  if (gated) {
    if (act == ACT_SILU) return launch<2, ACT_SILU>(x, w0, w1, offs, out, P, K, N, E, stages, s);
    if (act == ACT_GELU) return launch<2, ACT_GELU>(x, w0, w1, offs, out, P, K, N, E, stages, s);
    return cudaErrorInvalidValue;
  }
  if (act == ACT_NONE) return launch<1, ACT_NONE>(x, w0, w1, offs, out, P, K, N, E, stages, s);
  if (act == ACT_SILU) return launch<1, ACT_SILU>(x, w0, w1, offs, out, P, K, N, E, stages, s);
  if (act == ACT_GELU) return launch<1, ACT_GELU>(x, w0, w1, offs, out, P, K, N, E, stages, s);
  return cudaErrorInvalidValue;
}

}  // namespace wg

}  // namespace

extern "C" {

// x (P, K), w0 and (gated) w1 (E, K, N), out (P, N), all of one type
// (dtype 0: float32, 1: bfloat16), contiguous and 16-byte aligned, K and N
// multiples of 8; offs (E + 1,) int32 on the device, non-decreasing, with
// offs[E] <= P. act 0: identity, 1: SiLU, 2: GeLU (tanh); gated needs an
// activation. stages is the bfloat16 kernel's ring depth, the launch plan
// (kernels/moe_grouped.py::_plan): at least 2, and the ring must fit in
// shared memory; float32 ignores it (the SIMT kernel's ring is fixed). Rows
// outside every expert's segment are not written; P = 0 launches nothing.
int moe_grouped(const void* x, const void* w0, const void* w1, const int* offs, void* out, int P,
                int K, int N, int E, int dtype, int gated, int act, int stages, void* stream) {
  if (P < 0 || K < 1 || N < 1 || E < 1 || E > 65535 || K % 8 || N % 8 || (gated && !w1))
    return cudaErrorInvalidValue;
  if (P == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(x, w0, w1, offs, out, P, K, N, E, gated, act, s);
  if (dtype == 1) return wg::dispatch(x, w0, w1, offs, out, P, K, N, E, gated, act, stages, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
