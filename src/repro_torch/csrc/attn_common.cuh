// Online-softmax row partials on tensor cores, shared by the flash-decode
// and tree-attention kernels (plain C interface, built by nvcc for sm_90a,
// loaded with ctypes).
//
// One CTA of four warps owns ROWS = 16 * MT query rows of one (batch,
// kv-head) and walks a range of key slots in tiles of KT = 32 slots. Where
// slot s lives is the caller's: a functor maps it to an element offset from
// the K/V base pointer (a stride for a dense cache, a page-table lookup for
// a paged one). Each slot's head-dim row is contiguous, so a tile is staged
// by 16-byte `cp.async` copies, one slot address per copy, into a ring of
// STAGES K/V tiles in shared memory: tile j + STAGES - 1 is in flight while
// tile j is computed. Slots past the range end are zero-filled, never read.
//
// Products: `mma.sync.m16n8k8` TF32 with an f32 sum. Warp w takes slots
// [8w, 8w + 8) of every tile against all ROWS rows, so one 16x8 score tile
// per m-tile: S = Q K^T over hd in 16 k-steps, then O += P V with P taken
// straight from the score registers (the k index of the P.V product is
// permuted so that the score fragment is the A fragment; V's rows are read
// in the same permuted order). Precision is not traded for speed, since the
// port is held to 1e-4 of float32 math:
//   float32 operands are split x = hi + lo into two TF32 numbers and each
//     product is hi.hi + hi.lo + lo.hi (3xTF32, ~2^-22 relative);
//   bfloat16 operands are exact in TF32, so Q K^T is one pass;
//   P in [0, 1] is always split, since one TF32 rounding of P costs ~3e-5
//     of the output, and P V is P_hi.V_hi + P_hi.V_lo + P_lo.V_hi in
//     float32, P_hi.V + P_lo.V in bfloat16.
// Q is multiplied unscaled and `scale` is applied to the f32 score; it is
// split once per CTA into shared memory, so a key tile reads each thread's
// hi/lo fragment words in one 16-byte (8-byte for bfloat16) load. The Q.K^T
// contraction index is permuted alike for Q and K (k t <-> d 2t, t + 4 <->
// 2t + 1), so a K fragment pair is one load too. Rows are padded to 16
// (zero Q, masked); ragged keys are masked per slot.
//
// Each warp keeps its own running (m, l, acc) of its slot slices; at the end
// the four warps are merged through shared memory in a fixed order, so the
// arithmetic does not depend on where a slot lives: a paged cache gives
// bitwise the partials of the dense cache it gathers to.
//
// Head dims: any multiple of 8 whose 16-byte copies per row split evenly
// over the CTA's threads (64, 128 and 288 are instantiated). Each thread
// holds MT * HD / 2 accumulator floats, so above hd 128 a CTA takes one
// m16 tile only (row_tiles): two tiles at hd 288 would hold 288 floats a
// thread and spill.
//
// Bound on the H100: the bytes of K and V. At R <= 32 rows a K/V element
// takes part in at most 2 * 32 multiply-adds (x3 TF32 passes in float32),
// far below the ~150 TF32 flops per byte at which the tensor cores would
// take over from the 3.35 TB/s of HBM.
//
// Masking contract of the reference (kernels/flash_decode.py::_kernel): a
// masked score is NEG_INF = -1e30, never -inf, and the running max starts
// at -1e30, so a row with no visible slot averages V over the scanned
// slots and no NaN can arise. Slots past the range end are not inputs at
// all and take no part (score -inf, weight exactly 0).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace attn {

constexpr float NEG_INF = -1e30f;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int KT = 32;              // key slots per tile: 8 per warp, 1 per lane
constexpr int MAX_ROWS = 32;        // MT <= 2

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// Elements p[0] and p[1] as float, in one shared-memory load.
__device__ __forceinline__ float2 pair(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32; with EXACT (bfloat16 input) x is TF32 already.
template <bool EXACT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (EXACT) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    hi = tf32(x);
    lo = tf32(x - __uint_as_float(hi));
  }
}

// d += a . b, one m16n8k8 TF32 tile (row.col), f32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Slot s of a dense cache: element offset s * stride.
struct DenseSlots {
  long long stride;
  __device__ __forceinline__ long long operator()(int s) const { return s * stride; }
};

// A slot functor maps slot s to the element offset of its K row from `k`,
// and the same offset from `v` is its V row. One that reads slots from
// several pairs of buffers (the carried and the new staged rows of one
// tree-attention call) declares `SHIFT_V = true` and gives `v_shift(s)`, the
// V row's offset from `v` minus its K row's offset from `k`.
template <class S, class = void>
struct shifts_v : std::false_type {};
template <class S>
struct shifts_v<S, std::void_t<decltype(S::SHIFT_V)>> : std::integral_constant<bool, S::SHIFT_V> {};

// Shared-memory geometry of one (T, HD, MT) instantiation. K/V rows are
// padded by 16 bytes and split Q rows by 4 * QW words, so that the fragment
// reads (8 rows x 4 column pairs, or 4 row pairs x 8 columns) hit
// different banks. The raw Q tile lands in the ring's last stage, which
// the prologue does not fill, and is split from there.
template <typename T, int HD, int MT>
struct Tile {
  static constexpr int ROWS = 16 * MT;
  static constexpr int EPC = 16 / sizeof(T);             // elements per 16-byte copy
  static constexpr int CPR = HD / EPC;                   // copies per row
  static constexpr int PITCH = HD + EPC;                 // elements per staged row
  // ring depth: 4 bfloat16 tiles, or 2 where a tile's rows are long (float32,
  // or a head dim above 128, where 4 would leave room for one CTA an SM)
  static constexpr int STAGES = sizeof(T) == 2 && HD <= 128 ? 4 : 2;
  static constexpr int SLAB = HD + 4;                    // floats per merge row
  static constexpr int QW = sizeof(T) == 2 ? 2 : 4;       // words per (row, k-step, t)
  static constexpr int QPITCH = HD / 8 * 4 * QW + 4 * QW;  // words per split Q row
  static constexpr size_t Q_BYTES = sizeof(uint32_t) * ROWS * QPITCH;
  static constexpr size_t RING_BYTES = sizeof(T) * STAGES * 2 * KT * PITCH;
  static constexpr size_t MERGE_BYTES = sizeof(float) * WARPS * ROWS * SLAB;
  static constexpr size_t SMEM =
      Q_BYTES + (RING_BYTES > MERGE_BYTES ? RING_BYTES : MERGE_BYTES);
};

// Partials (acc, m, l) of rows [row0, row0 + ROWS) ∩ [0, R) over key slots
// [s_begin, s_end). q: (R, HD) contiguous rows of this (batch, kv-head);
// k/v: slot s at k[slot(s) + d]; vis(row, s) is the visibility test.
// Outputs are indexed by row: acc[row * HD + d], m[row], l[row]. Every
// global address must be 16-byte aligned (the wrappers check it).
template <typename T, int HD, int MT, class Slots, class Vis>
__device__ __forceinline__ void rows_partials(
    const T* __restrict__ q, int R, int row0, float scale,
    const T* __restrict__ k, const T* __restrict__ v, const Slots& slot,
    int s_begin, int s_end, const Vis& vis,
    float* __restrict__ acc, float* __restrict__ m_out, float* __restrict__ l_out) {
  using G = Tile<T, HD, MT>;
  constexpr int ROWS = G::ROWS, PITCH = G::PITCH, EPC = G::EPC, CPR = G::CPR;
  constexpr int STAGES = G::STAGES, NB = HD / 8;
  constexpr bool EXACT = sizeof(T) == 2;
  static_assert(HD % 8 == 0 && HD % EPC == 0, "head_dim must be a multiple of 8");
  static_assert(KT == 32 && KT * CPR % THREADS == 0, "one slot per lane, equal copies per thread");
  static_assert(MT == 1 || HD <= 128, "one row tile above hd 128 (row_tiles)");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float m_w[WARPS][MAX_ROWS], l_w[WARPS][MAX_ROWS];
  constexpr int QW = G::QW, QPITCH = G::QPITCH;
  uint32_t* qsp = reinterpret_cast<uint32_t*>(smem_raw);  // ROWS x QPITCH, split
  T* ring = reinterpret_cast<T*>(smem_raw + G::Q_BYTES);  // STAGES x {K, V} x KT x PITCH
  T* qs = ring + (STAGES - 1) * 2 * KT * PITCH;            // raw Q, in the last stage
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  for (int i = tid; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR, c = i % CPR, row = row0 + r;
    cp16(qs + r * PITCH + c * EPC, q + (long long)(row < R ? row : 0) * HD + c * EPC, row < R);
  }
  const int n_tiles = (s_end - s_begin + KT - 1) / KT;
  auto load_tile = [&](int j) {   // lane l maps slot l of the tile, once
    T* kd = ring + (j % STAGES) * 2 * KT * PITCH;
    T* vd = kd + KT * PITCH;
    const int s_lane = s_begin + j * KT + lane;
    const long long off_lane = s_lane < s_end ? slot(s_lane) : 0;
    long long dv_lane = 0;
    if constexpr (shifts_v<Slots>::value) dv_lane = s_lane < s_end ? slot.v_shift(s_lane) : 0;
    for (int i = tid; i < KT * CPR; i += THREADS) {   // the same trip count in every lane
      const int r = i / CPR, c = i % CPR, s = s_begin + j * KT + r;
      const bool ok = s < s_end;
      const long long off = __shfl_sync(0xffffffffu, off_lane, r) + c * EPC;
      long long v_off = off;
      if constexpr (shifts_v<Slots>::value) v_off += __shfl_sync(0xffffffffu, dv_lane, r);
      cp16(kd + r * PITCH + c * EPC, k + off, ok);
      cp16(vd + r * PITCH + c * EPC, v + v_off, ok);
    }
  };
  cp_commit();
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < n_tiles) load_tile(j);
    cp_commit();
  }
  // split Q once: (row, k-step, t) -> {hi(d), hi(d + 1)[, lo(d), lo(d + 1)]}, d = kk + 2t
  cp_wait<STAGES - 1>();
  __syncthreads();
  for (int u = tid; u < ROWS * HD / 2; u += THREADS) {
    const int r = u / (HD / 2), e = u % (HD / 2), d = 2 * e;
    const float2 x = pair(qs + r * PITCH + d);
    uint32_t* w = qsp + r * QPITCH + (e >> 2) * 4 * QW + (e & 3) * QW;
    uint32_t h0, h1, l0, l1;
    split<EXACT>(x.x, h0, l0);
    split<EXACT>(x.y, h1, l1);
    w[0] = h0;
    w[1] = h1;
    if (!EXACT) {
      w[2] = l0;
      w[3] = l1;
    }
  }

  float o[MT][NB][4], m_r[MT][2], l_r[MT][2];  // l_r: this thread's share of the row sum
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_r[mt][h] = NEG_INF;
      l_r[mt][h] = 0.f;
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[mt][nb][i] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    cp_wait<STAGES - 2>();
    __syncthreads();                           // tile j landed; tile j - 1 is free
    if (j + STAGES - 1 < n_tiles) load_tile(j + STAGES - 1);
    cp_commit();
    const T* ks = ring + (j % STAGES) * 2 * KT * PITCH + warp * 8 * PITCH;
    const T* vs = ks + KT * PITCH;

    // S = Q K^T for this warp's 8 slots: sc[mt] = rows (g, g+8) x slots (2t, 2t+1)
    float sc[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[mt][i] = 0.f;
    // the contraction index is permuted (k t <-> d 2t, k t + 4 <-> d 2t + 1)
    // for Q and K alike, so each thread's two elements are one 8- or 4-byte load
#pragma unroll
    for (int kk = 0; kk < HD; kk += 8) {
      uint32_t bh[2], bl[2];
      const float2 kp = pair(ks + g * PITCH + kk + 2 * t);
      split<EXACT>(kp.x, bh[0], bl[0]);
      split<EXACT>(kp.y, bh[1], bl[1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint32_t* qw = qsp + (mt * 16 + g) * QPITCH + (kk >> 3) * 4 * QW + t * QW;
        uint32_t ah[4], al[4];
        if (EXACT) {
          const uint2 a = *reinterpret_cast<const uint2*>(qw);
          const uint2 b = *reinterpret_cast<const uint2*>(qw + 8 * QPITCH);
          ah[0] = a.x, ah[1] = b.x, ah[2] = a.y, ah[3] = b.y;
        } else {
          const uint4 a = *reinterpret_cast<const uint4*>(qw);
          const uint4 b = *reinterpret_cast<const uint4*>(qw + 8 * QPITCH);
          ah[0] = a.x, ah[1] = b.x, ah[2] = a.y, ah[3] = b.y;
          al[0] = a.z, al[1] = b.z, al[2] = a.w, al[3] = b.w;
        }
        if (!EXACT) {
          mma(sc[mt], al, bh);
          mma(sc[mt], ah, bl);
        }
        mma(sc[mt], ah, bh);
      }
    }

    // mask, online softmax update, P split into TF32 hi + lo
    const int s0 = s_begin + j * KT + warp * 8 + 2 * t;
    uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + mt * 16 + h * 8 + g;
        float x[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int s = s0 + e;
          x[e] = s >= s_end ? -INFINITY
                 : (row < R && vis(row, s)) ? sc[mt][2 * h + e] * scale : NEG_INF;
        }
        float c_max = fmaxf(x[0], x[1]);
        c_max = fmaxf(c_max, __shfl_xor_sync(0xffffffffu, c_max, 1));
        c_max = fmaxf(c_max, __shfl_xor_sync(0xffffffffu, c_max, 2));
        const float m_new = fmaxf(m_r[mt][h], c_max);
        const float corr = expf(m_r[mt][h] - m_new);
        const float p0 = expf(x[0] - m_new), p1 = expf(x[1] - m_new);
        l_r[mt][h] = l_r[mt][h] * corr + (p0 + p1);
        m_r[mt][h] = m_new;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          o[mt][nb][2 * h] *= corr;
          o[mt][nb][2 * h + 1] *= corr;
        }
        // A fragment of P V with k index t <-> slot 2t, t + 4 <-> slot 2t + 1
        split<false>(p0, ph[mt][h], pl[mt][h]);
        split<false>(p1, ph[mt][h + 2], pl[mt][h + 2]);
      }
    }

    // O += P V: V rows 2t and 2t + 1, columns nb * 8 + g
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      uint32_t bh[2], bl[2];
      split<EXACT>(to_f(vs[2 * t * PITCH + nb * 8 + g]), bh[0], bl[0]);
      split<EXACT>(to_f(vs[(2 * t + 1) * PITCH + nb * 8 + g]), bh[1], bl[1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma(o[mt][nb], pl[mt], bh);
        if (!EXACT) mma(o[mt][nb], ph[mt], bl);
        mma(o[mt][nb], ph[mt], bh);
      }
    }
  }

  // merge the four warps' partials through shared memory, in warp order
  cp_wait<0>();
  __syncthreads();                             // the ring is free for the merge slabs
  float* slab = reinterpret_cast<float*>(ring);  // WARPS x ROWS x SLAB
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_r[mt][h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      if (t == 0) {
        m_w[warp][mt * 16 + h * 8 + g] = m_r[mt][h];
        l_w[warp][mt * 16 + h * 8 + g] = l;
      }
    }
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + h * 8 + g;
      float M = m_w[0][r];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) M = fmaxf(M, m_w[w][r]);
      const float f = expf(m_r[mt][h] - M);
      float* dst = slab + (warp * ROWS + r) * G::SLAB + 2 * t;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        *reinterpret_cast<float2*>(dst + nb * 8) =
            make_float2(o[mt][nb][2 * h] * f, o[mt][nb][2 * h + 1] * f);
    }
  if (tid < ROWS && row0 + tid < R) {
    float M = m_w[0][tid];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) M = fmaxf(M, m_w[w][tid]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) L += l_w[w][tid] * expf(m_w[w][tid] - M);
    m_out[row0 + tid] = M;
    l_out[row0 + tid] = L;
  }
  __syncthreads();
  for (int i = tid; i < ROWS * HD / 4; i += THREADS) {
    const int r = i / (HD / 4), d = (i % (HD / 4)) * 4;
    if (row0 + r >= R) continue;
    float4 s = *reinterpret_cast<const float4*>(slab + r * G::SLAB + d);
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      const float4 x = *reinterpret_cast<const float4*>(slab + (w * ROWS + r) * G::SLAB + d);
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
    *reinterpret_cast<float4*>(acc + (long long)(row0 + r) * HD + d) = s;
  }
}

// Opts a kernel into the dynamic shared memory it needs (above 48 KB only
// after this attribute is set). Callers keep the result in a function-local
// static, so the attribute is set at the first launch only and a later
// launch can be captured into a CUDA graph.
template <class K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Row tiles of a CTA for R rows per (batch, kv-head) at head dim hd: one
// m16 tile for R <= 16 or hd > 128, two otherwise
// (kernels/flash_decode.py::rows_per_cta mirrors it).
inline int row_tiles(int R, int hd) { return R <= 16 || hd > 128 ? 1 : 2; }

}  // namespace attn
