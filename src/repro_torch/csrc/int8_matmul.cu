// W8A8 matrix product for Hopper (sm_90a): int8 x int8 -> int32 on the
// tensor cores, scaled to float32 in the epilogue.
//
// Replaces: src/repro/kernels/int8_matmul.py::int8_matmul (Pallas body
// `_kernel`), which accumulates each 128-wide K tile's int32 product into a
// float32 VMEM accumulator.
//
// Bound on the H100: bytes. An int8 product does 2M operations per weight
// byte, and the card's int8 ridge is 1979 TOP/s / 3.35 TB/s ~ 590 per byte,
// so the product is bound by the weight's bytes while M < ~295. Every row
// count of the decode path (1-4 chain steps, 16-20 tree steps and B=4 x T=5
// verifies, 32, 64) is far below that. At the MLP shapes the weight is 45 MB
// (4096 x 11008 or 11008 x 4096): 13.5 us at 3.35 TB/s (13.9 us with x, the
// scales and the float32 output at M = 32), against 1.5 us of tensor-core
// work at M = 32.
//
// Why mma.sync and not wgmma: the work needs bytes in flight and enough CTAs,
// not tensor-core rate; mma.sync m16n8k32 s8 has ample headroom at M <= 64.
// wgmma with s8 operands needs both operands K-major in shared memory, which
// for the weight's (K, N) layout means a transposed copy of every weight.
//
// Design, and what each point fixes in the first version (one CTA per 64
// columns walking all of K with synchronous loads):
//  1. Split-K weight streaming. A CTA owns a strip of BN = 128 columns, a
//     row tile and a contiguous range of K tiles (split s of S takes tiles
//     [s*T/S, (s+1)*T/S), mirrored by kernels/int8_matmul.py::k_range). The
//     S splits of a strip form one thread-block cluster; the wrapper picks
//     the largest S <= 16 for which the card holds every cluster in one wave
//     (on a 132-SM H100 at M = 32: 344 CTAs for 4096 -> 11008, 288 for
//     11008 -> 4096, against 172 and 64 before; a second wave costs a third
//     more time). Partial sums are int32 and exact: each CTA leaves its
//     partial tile in its own shared memory, and every CTA of the cluster
//     sums a share of the tile over all of them through distributed shared
//     memory and writes (float)acc * xs[row] * ws[col], in the plain
//     version's order. No workspace, no atomics, no second launch.
//     |acc| <= 127 * 127 * K < 2^31 for K <= 133,000 (the wrapper refuses a
//     larger K).
//  2. A pipelined ring. Weight and activation tiles (BK = 64 rows of k) are
//     copied by 16-byte cp.async (LDGSTS) through a ring of 6 stages (5 for
//     64-row tiles); all but one are in flight while one is multiplied:
//     40 KB of weight per CTA, ~120 KB per SM at three CTAs, where ~20 KB
//     covers HBM latency at 3.35 TB/s.
//  3. B fragments without byte stores. The weight tile stays N-major in
//     shared memory (128 bytes a row, 16-byte chunks XOR-swizzled by k so
//     the reads below are conflict-free). A thread reads four 4-byte words
//     of four consecutive k rows (four columns each) and transposes the 4x4
//     bytes in registers with 8 prmt: one B register (four consecutive k of
//     one column) for each of four n8 tiles. The MMA's n index is a
//     permutation of the columns (fragment column c of n8 tile j is column
//     4c + j of the warp's 32), undone in the epilogue, where each thread
//     then holds 8 consecutive columns of a row.
//  4. A row tile that follows M: BM = 16, 32 or 64 (the smallest covering
//     M; several row tiles past 64). Rows past M are neither loaded nor
//     stored: their shared rows hold stale bytes whose products land in
//     accumulator rows that are never written out.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// CTAS_PER_SM bounds the registers (__launch_bounds__); with 57-67 KB of
// shared memory a CTA, three CTAs fit an SM at every row tile.
constexpr int BN = 128, BK = 64, THREADS = 128, CTAS_PER_SM = 3;
constexpr int A_LD = BK + 16;            // bytes per A row in shared memory: conflict-free fragment loads
constexpr int B_STAGE = BK * BN;         // bytes of one weight tile
constexpr int MAX_K = 133000;            // 127 * 127 * K < 2^31
constexpr int MAX_SPLITS = 16;           // the largest (non-portable) cluster on Hopper
constexpr int P_LD = BN + 4;             // int32 per row of the partial tile: conflict-free int4 stores

// Ring stages: 6, or 5 for 64-row tiles so that three CTAs still fit an SM.
template <int BM>
__host__ __device__ constexpr int stages() { return BM == 64 ? 5 : 6; }
template <int BM>
__host__ __device__ constexpr int smem_bytes() { return stages<BM>() * (B_STAGE + BM * A_LD); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// r[i] holds byte j of column j, k row i; on return c[j] holds byte i = k row i of column j.
__device__ __forceinline__ void transpose4x4(const int (&r)[4], int (&c)[4]) {
  const unsigned t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[0], r[1], 0x7362);
  const unsigned t2 = __byte_perm(r[2], r[3], 0x5140), t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ void store_scaled(float* dst, int a0, int a1, int a2, int a3, float xr,
                                             const float* ws) {
  // (float)acc * x_scale * w_scale, in the plain version's order
  *reinterpret_cast<float4*>(dst) = make_float4((float)a0 * xr * ws[0], (float)a1 * xr * ws[1],
                                                (float)a2 * xr * ws[2], (float)a3 * xr * ws[3]);
}

// 16-byte chunk index of weight row k in shared memory.
__device__ __forceinline__ int b_chunk(int k, int chunk) { return chunk ^ (((k >> 2) & 3) << 1); }

template <int BM>
__global__ void __launch_bounds__(THREADS, CTAS_PER_SM) int8_mm_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ xs,
    const float* __restrict__ ws, float* __restrict__ out, int M, int N, int K, int splits) {
  constexpr int MT = BM / 16, STAGES = stages<BM>();
  static_assert(BM * P_LD * 4 <= smem_bytes<BM>(), "the partial tile reuses the ring");
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* Bs = smem;                                  // STAGES x BK x BN, swizzled
  int8_t* As = smem + STAGES * B_STAGE;               // STAGES x BM x A_LD
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int strip = blockIdx.x, split = blockIdx.y;
  const int n0 = strip * BN, m0 = blockIdx.z * BM;
  const int k_tiles = K / BK;
  const int kt0 = (int)((long long)split * k_tiles / splits);
  const int nt = (int)((long long)(split + 1) * k_tiles / splits) - kt0;
  const int rows = min(BM, M - m0);

  auto load = [&](int i, int stage) {
    const int k0 = (kt0 + i) * BK;
    int8_t* bs = Bs + stage * B_STAGE;
#pragma unroll
    for (int it = 0; it < B_STAGE / 16 / THREADS; ++it) {
      const int c = tid + it * THREADS, r = c >> 3, ch = c & 7;
      if (n0 + ch * 16 < N)
        cp_async16(bs + r * BN + b_chunk(r, ch) * 16, w + (long long)(k0 + r) * N + n0 + ch * 16);
    }
    int8_t* as = As + stage * BM * A_LD;
#pragma unroll
    for (int it = 0; it < (BM * BK / 16 + THREADS - 1) / THREADS; ++it) {
      const int c = tid + it * THREADS, r = c >> 2, ch = c & 3;
      if (c < BM * BK / 16 && r < rows)
        cp_async16(as + r * A_LD + ch * 16, x + (long long)(m0 + r) * K + k0 + ch * 16);
    }
  };

  int acc[MT][4][4] = {};
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nt) load(s, s);
    cp_async_commit();
  }
  // this thread's weight word: column 32 * warp + 4 * g of rows 4t.. (the
  // swizzle of those rows is 2t whatever the k step)
  const int b_off = (((2 * warp + (g >> 2)) ^ (2 * t)) << 4) + 4 * (g & 3);
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();                  // tile i landed; every warp is done with tile i - 1
    if (i + STAGES - 1 < nt) load(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();
    const int8_t* bs = Bs + (i % STAGES) * B_STAGE;
    const int8_t* as = As + (i % STAGES) * BM * A_LD;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      int b[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int8_t* p = bs + (kk + 16 * h + 4 * t) * BN + b_off;
        const int r[4] = {*reinterpret_cast<const int*>(p), *reinterpret_cast<const int*>(p + BN),
                          *reinterpret_cast<const int*>(p + 2 * BN),
                          *reinterpret_cast<const int*>(p + 3 * BN)};
        transpose4x4(r, b[h]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int8_t* a_lo = as + (mt * 16 + g) * A_LD + kk + 4 * t;
        const int8_t* a_hi = a_lo + 8 * A_LD;
        const int a[4] = {*reinterpret_cast<const int*>(a_lo), *reinterpret_cast<const int*>(a_hi),
                          *reinterpret_cast<const int*>(a_lo + 16),
                          *reinterpret_cast<const int*>(a_hi + 16)};
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[mt][j], a, b[0][j], b[1][j]);
      }
    }
  }
  cp_async_wait<0>();

  // Epilogue. Element i of acc[mt][j] is row mt*16 + g + 8*(i>>1), column
  // 32*warp + 8*t + 4*(i&1) + j: for each (mt, row half, i&1) four
  // consecutive columns.
  const float* xs_m = xs + m0;
  // The cluster holds the strip's splits (one CTA without a split). Each CTA
  // leaves its partial tile in its own shared memory (the ring is free now),
  // then sums a 1/splits share of the tile's valid rows over every CTA of
  // the cluster, in rank order, and writes it out scaled.
  __syncthreads();
  int* part = reinterpret_cast<int*>(smem);           // BM x P_LD int32
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = mt * 16 + g + 8 * (i >> 1), c = 32 * warp + 8 * t + 4 * (i & 1);
      *reinterpret_cast<int4*>(part + r * P_LD + c) =
          make_int4(acc[mt][0][i], acc[mt][1][i], acc[mt][2][i], acc[mt][3][i]);
    }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = (int)cluster.block_rank();
  const int chunks = rows * (BN / 4);                 // int4 chunks of the valid rows
  const int c1 = (rank + 1) * chunks / splits;
  for (int c = rank * chunks / splits + tid; c < c1; c += THREADS) {
    const int r = c / (BN / 4), col_l = 4 * (c % (BN / 4));
    if (n0 + col_l >= N) continue;
    int4 sum = make_int4(0, 0, 0, 0);
    for (int q = 0; q < splits; ++q) {
      const int4 v = *cluster.map_shared_rank(reinterpret_cast<int4*>(part + r * P_LD + col_l), q);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    store_scaled(out + (long long)(m0 + r) * N + n0 + col_l, sum.x, sum.y, sum.z, sum.w, xs_m[r],
                 ws + n0 + col_l);
  }
  cluster.sync();                     // every CTA has read this CTA's partial tile
}

// Kernel attributes, set before every launch (per device, and legal while a
// CUDA graph is captured): the dynamic shared memory and clusters above 8.
template <int BM>
cudaError_t configure() {
  cudaError_t err = cudaFuncSetAttribute(int8_mm_kernel<BM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes<BM>());
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(int8_mm_kernel<BM>, cudaFuncAttributeNonPortableClusterSizeAllowed,
                              1);
}

// One cluster of `splits` CTAs along y per (strip, row tile).
template <int BM>
cudaLaunchConfig_t cluster_config(dim3 grid, int splits, cudaLaunchAttribute* attr,
                                  cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes<BM>();
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = splits;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int BM>
cudaError_t launch(const int8_t* x, const int8_t* w, const float* xs, const float* ws, float* out,
                   int M, int N, int K, int splits, cudaStream_t stream) {
  cudaError_t err = configure<BM>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<BM>(
      dim3((N + BN - 1) / BN, splits, (M + BM - 1) / BM), splits, &attr, stream);
  err = cudaLaunchKernelEx(&cfg, int8_mm_kernel<BM>, x, w, xs, ws, out, M, N, K, splits);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int BM>
cudaError_t max_clusters(int splits, int* count) {
  cudaError_t err = configure<BM>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<BM>(dim3(1, splits, 1), splits, &attr, nullptr);
  return cudaOccupancyMaxActiveClusters(count, int8_mm_kernel<BM>, &cfg);
}

}  // namespace

extern "C" {

// x (M, K) int8, w (K, N) int8, xs (M,) and ws (N,) float32, all contiguous
// and 16-byte aligned; K and N multiples of 64, K <= 133,000. out (M, N)
// float32. bm is the row tile (16, 32 or 64), splits the number of K ranges
// and the cluster size (1 <= splits <= min(16, K / 64)).
int int8_mm(const int8_t* x, const int8_t* w, const float* xs, const float* ws, float* out,
            int M, int N, int K, int bm, int splits, void* stream) {
  if (K % BK || N % 64 || K > MAX_K || M < 1 || splits < 1 || splits > MAX_SPLITS ||
      splits > K / BK)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 16: return launch<16>(x, w, xs, ws, out, M, N, K, splits, s);
    case 32: return launch<32>(x, w, xs, ws, out, M, N, K, splits, s);
    case 64: return launch<64>(x, w, xs, ws, out, M, N, K, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

// How many clusters of `splits` CTAs with row tile bm the current device
// holds at once (one wave), in *count.
int int8_mm_max_clusters(int bm, int splits, int* count) {
  if (splits < 1 || splits > MAX_SPLITS) return cudaErrorInvalidValue;
  switch (bm) {
    case 16: return max_clusters<16>(splits, count);
    case 32: return max_clusters<32>(splits, count);
    case 64: return max_clusters<64>(splits, count);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
