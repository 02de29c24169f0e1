// W8A8 matrix product for Hopper (sm_90a): int8 x int8 -> int32 on the
// tensor cores, scaled to float32 in the epilogue.
//
// Replaces: src/repro/kernels/int8_matmul.py::int8_matmul (Pallas body
// `_kernel`), which accumulates each 128-wide K tile's int32 product into a
// float32 VMEM accumulator.
//
// Bound on the H100: at the decode shapes (M = 32 rows against a 4096 x
// 11008 weight) the bytes of the int8 weight, ~45 MB, against 2.9 G int8
// operations: 13.5 us of HBM traffic versus 1.5 us of tensor-core work.
//
// Design: CTA tile 32 (M) x 64 (N), K walked in steps of 64 through shared
// memory, four warps each owning a 32 x 16 output block computed with
// mma.sync.m16n8k32 (s8 operands, s32 accumulators). The sum is kept in
// int32 over the whole K: |acc| <= 127 * 127 * K, which for K = 11008 is
// 1.8e8 < 2^31. So this kernel rounds once, at the int32 -> float32
// conversion, where the reference rounds at each tile; the two differ by
// float32 rounding only, and this kernel's result equals the exact integer
// product scaled as ref_int8_matmul does. The weight arrives (K, N) with N
// contiguous while the MMA's B operand wants 4 consecutive k per register,
// so the B tile is transposed on its way into shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32, BN = 64, BK = 64, THREADS = 128;
constexpr int A_LD = BK + 16;   // bytes per A row in shared memory (16-byte aligned)
constexpr int B_LD = BK + 4;    // bytes per transposed B row (n-major, k contiguous)

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(THREADS) int8_mm_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ xs,
    const float* __restrict__ ws, float* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int8_t As[BM * A_LD];
  __shared__ __align__(16) int8_t Bs[BN * B_LD];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  int acc[2][2][4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
    {  // A tile: 32 rows x 64 bytes, one 16-byte load per thread
      const int r = tid >> 2, c = (tid & 3) * 16;
      int4 val = make_int4(0, 0, 0, 0);
      if (m0 + r < M) val = *reinterpret_cast<const int4*>(x + (long long)(m0 + r) * K + k0 + c);
      *reinterpret_cast<int4*>(As + r * A_LD + c) = val;
    }
#pragma unroll
    for (int it = 0; it < 2; ++it) {  // B tile: 64 k x 64 n, stored n-major
      const int idx = tid + it * THREADS;
      const int kr = idx >> 2, nc = (idx & 3) * 16;
      const int4 val = *reinterpret_cast<const int4*>(w + (long long)(k0 + kr) * N + n0 + nc);
      const int8_t* bytes = reinterpret_cast<const int8_t*>(&val);
#pragma unroll
      for (int i = 0; i < 16; ++i) Bs[(nc + i) * B_LD + kr] = bytes[i];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int8_t* a_lo = As + (mt * 16 + g) * A_LD + kk + t * 4;
        const int8_t* a_hi = a_lo + 8 * A_LD;
        const int a[4] = {*reinterpret_cast<const int*>(a_lo), *reinterpret_cast<const int*>(a_hi),
                          *reinterpret_cast<const int*>(a_lo + 16),
                          *reinterpret_cast<const int*>(a_hi + 16)};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int8_t* bp = Bs + (warp * 16 + nt * 8 + g) * B_LD + kk + t * 4;
          mma_s8(acc[mt][nt], a, *reinterpret_cast<const int*>(bp),
                 *reinterpret_cast<const int*>(bp + 16));
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + mt * 16 + g + (i >= 2 ? 8 : 0);
        const int col = n0 + warp * 16 + nt * 8 + t * 2 + (i & 1);
        if (row < M) out[(long long)row * N + col] = (float)acc[mt][nt][i] * xs[row] * ws[col];
      }
}

}  // namespace

extern "C" {

// x (M, K) int8, w (K, N) int8, xs (M,) and ws (N,) float32, all contiguous
// and 16-byte aligned; K and N multiples of 64. out (M, N) float32.
int int8_mm(const int8_t* x, const int8_t* w, const float* xs, const float* ws, float* out,
            int M, int N, int K, void* stream) {
  if (K % BK || N % BN) return cudaErrorInvalidValue;
  dim3 grid(N / BN, (M + BM - 1) / BM);
  int8_mm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(x, w, xs, ws, out, M,
                                                                        N, K);
  return cudaGetLastError();
}

}  // extern "C"
