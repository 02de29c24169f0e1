// Flash-decode attention over a committed KV cache, dense or block-paged,
// for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_decode.py::flash_decode_partial (Pallas
// body `_kernel`) and ::flash_decode_paged_partial (`_paged_kernel`). The
// TPU kernels walk the (B, KV, S/block) grid in order and carry m/l/acc in
// VMEM from one KV block to the next; the paged one scalar-prefetches the
// page table so that block j of slot b is pool page table[b, j].
//
// Bound on the H100: the bytes of K and V it reads (3.35 TB/s). At R <= 32
// query rows per kv-head a K/V element takes part in at most 64 flops, x3
// TF32 passes in float32: far below the tensor cores' ~150 TF32 flops per
// byte of HBM.
//
// Design: flash-decoding on tensor cores (attn_common.cuh). Blocks run in no
// order on Hopper, so S is split across CTAs, one CTA per (split, kv-head,
// batch x row-tile of 16 or 32 rows); the split count is chosen so that
// the CTAs that fit the SMs at once are in flight, and split lengths are
// multiples of the 32-slot key tile. Each CTA streams its K/V range through
// a cp.async ring (2 float32 or 4 bfloat16 tiles deep, 2 at hd 288), with
// the split Q in shared memory: at hd 128 100 KB (float32) or 85 KB
// (bfloat16), two CTAs per SM; at hd 64 52 or 45 KB; at hd 288, one 16-row
// tile, 183 KB in float32, one CTA per SM, and 92.5 KB in bfloat16, two. It
// computes both products with mma.sync TF32 (3xTF32 where the operands are
// float32) and writes un-normalised partials (acc, m, l). A
// second small kernel combines the splits by logsumexp. When the caller
// hands it the staged-tree partials, the combine also performs the verify
// merge of kernels/ops.py (lines 83-91 of the reference) and normalises, so
// the cache partials never make a second round trip. K/V are read through
// strides, so the dense cache's (B, S, KV, hd) layout is used in place.
//
// The paged kernel is the dense one with another slot -> address map: slot
// s of batch row b is row s % P of pool page table[b, s / P] (a -1 entry,
// an unallocated page, reads page 0; the caller's kv_pos = -1 masks it),
// read in the model's (NP, P, KV, hd) pool layout through strides; each
// slot's head-dim row is contiguous, so the 16-byte copies follow one row
// address per slot (any page size). The split boundaries are a
// function of the live length, so a paged call and a dense call over
// the gathered view run the same tiles in the same order: bitwise the same
// partials.
//
// The live length is read on the device, so that a call can be captured in
// a CUDA graph and replayed as the cache grows: given the committed lengths
// (`bound`, the cache's pos), it is L = max(1, max(bound)) clipped to S, and
// every CTA and the combine compute the split plan from it (live_plan: the
// host plan's formula). The grid is sized for the most splits any L <= S
// asks for; the splits past L exit at once and the combine reads only the
// ones that ran. A call over the whole cache with its bound therefore runs
// exactly the tiles of a call over the cache cut to L on the host.
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

// Slot s of a paged cache: row s % P of pool page table[s / P] (clamped to
// [0, NP - 1]), offsets in elements from the kv-head's base pointer.
struct PagedSlots {
  const int* table;    // (n_pp,) page-table row of this batch row
  int page_size, last_page;
  long long page_stride, row_stride;
  __device__ __forceinline__ long long operator()(int s) const {
    const int j = s / page_size;
    const int page = min(max(table[j], 0), last_page);
    return page * page_stride + (long long)(s - j * page_size) * row_stride;
  }
};

struct Launch {        // what every split CTA needs besides K/V addressing
  int B, KV, R, S, kind, window, sink, cap, n_bound;
  const int* bound;    // (n_bound,) committed lengths, or null: the live length is S
  float scale;
};

// The split plan, a function of the live length L only: L's key tiles go to
// max(1, min(tiles, cap)) splits of whole tiles (cap: the split count that
// fills one wave of the card), and the splits covering [0, L) run.
struct Plan {
  int live, split_len, n_run;
};

__device__ __forceinline__ Plan live_plan(const int* bound, int n_bound, int S, int cap) {
  int live = S;
  if (bound != nullptr) {
    int m = 1;
    for (int i = 0; i < n_bound; ++i) m = max(m, bound[i]);
    live = min(m, S);
  }
  const int tiles = (live + KT - 1) / KT;
  const int n_split = max(1, min(tiles, cap));
  const int split_len = (tiles + n_split - 1) / n_split * KT;
  return {live, split_len, (live + split_len - 1) / split_len};
}

template <typename T, int HD, int MT, class Slots>
__device__ __forceinline__ void split_body(
    const Launch& a, const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const Slots& slots, const int* __restrict__ kv_pos,
    const int* __restrict__ q_pos, float* __restrict__ acc_p, float* __restrict__ m_p,
    float* __restrict__ l_p, int b, int rt) {
  const Plan plan = live_plan(a.bound, a.n_bound, a.S, a.cap);
  const int split = blockIdx.x, g = blockIdx.y;
  if (split >= plan.n_run) return;     // past the live length: the combine skips it
  const int s_begin = split * plan.split_len;
  const int s_end = min(plan.live, s_begin + plan.split_len);
  const long long bg = (long long)b * a.KV + g;
  const long long out_row0 = ((long long)split * a.B * a.KV + bg) * a.R;
  const PosVis vis{kv_pos + (long long)b * a.S, q_pos + (long long)b * a.R, a.kind, a.window,
                   a.sink};
  rows_partials<T, HD, MT>(q + bg * a.R * HD, a.R, rt * 16 * MT, a.scale, k, v, slots, s_begin,
                           s_end, vis, acc_p + out_row0 * HD, m_p + out_row0, l_p + out_row0);
}

template <typename T, int HD, int MT>
__global__ void __launch_bounds__(THREADS, 2) split_kernel(
    Launch a, const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ kv_pos, const int* __restrict__ q_pos,
    float* __restrict__ acc_p, float* __restrict__ m_p, float* __restrict__ l_p,
    long long k_sb, long long k_sg, long long k_ss) {
  const int n_rt = (a.R + 16 * MT - 1) / (16 * MT);
  const int b = blockIdx.z / n_rt, rt = blockIdx.z - b * n_rt;
  const long long base = b * k_sb + blockIdx.y * k_sg;
  split_body<T, HD, MT>(a, q, k + base, v + base, DenseSlots{k_ss}, kv_pos, q_pos, acc_p, m_p,
                        l_p, b, rt);
}

template <typename T, int HD, int MT>
__global__ void __launch_bounds__(THREADS, 2) paged_split_kernel(
    Launch a, const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ table, int n_pp, int page_size,
    int num_pages, long long p_sp, long long p_sr, long long p_sg,
    const int* __restrict__ kv_pos, const int* __restrict__ q_pos,
    float* __restrict__ acc_p, float* __restrict__ m_p, float* __restrict__ l_p) {
  const int n_rt = (a.R + 16 * MT - 1) / (16 * MT);
  const int b = blockIdx.z / n_rt, rt = blockIdx.z - b * n_rt;
  const long long base = blockIdx.y * p_sg;
  const PagedSlots slots{table + (long long)b * n_pp, page_size, num_pages - 1, p_sp, p_sr};
  split_body<T, HD, MT>(a, q, k_pages + base, v_pages + base, slots, kv_pos, q_pos, acc_p, m_p,
                        l_p, b, rt);
}

// One CTA per query row, one thread per head-dim element, over the splits
// that ran (the split kernel's plan). Without tree partials (acc_d ==
// nullptr) it writes the combined un-normalised partials (acc, m, l); with
// them it writes the merged, normalised output.
__global__ void combine_kernel(
    const float* __restrict__ acc_p, const float* __restrict__ m_p,
    const float* __restrict__ l_p, long long rows, int hd, int S, int cap,
    const int* __restrict__ bound, int n_bound,
    const float* __restrict__ acc_d, const float* __restrict__ m_d,
    const float* __restrict__ l_d,
    float* __restrict__ out, float* __restrict__ out_m, float* __restrict__ out_l) {
  const long long row = blockIdx.x;
  const int d = threadIdx.x;
  const int n_split = live_plan(bound, n_bound, S, cap).n_run;
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

dim3 split_grid(const Launch& a, int n_split, int mt) {
  return dim3(n_split, a.KV, a.B * ((a.R + 16 * mt - 1) / (16 * mt)));
}

template <typename T, int HD, int MT>
cudaError_t launch_split(const Launch& a, int n_split, const void* q, const void* k,
                         const void* v, const int* kv_pos, const int* q_pos, float* acc_p,
                         float* m_p, float* l_p, long long k_sb, long long k_sg,
                         long long k_ss, cudaStream_t stream) {
  constexpr size_t smem = Tile<T, HD, MT>::SMEM;
  static const cudaError_t smem_err = allow_smem(split_kernel<T, HD, MT>, smem);
  if (smem_err != cudaSuccess) return smem_err;
  split_kernel<T, HD, MT><<<split_grid(a, n_split, MT), THREADS, smem, stream>>>(
      a, static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kv_pos,
      q_pos, acc_p, m_p, l_p, k_sb, k_sg, k_ss);
  return cudaGetLastError();
}

template <typename T, int HD, int MT>
cudaError_t launch_paged(const Launch& a, int n_split, const void* q, const void* k_pages,
                         const void* v_pages, const int* table, int n_pp, int page_size,
                         int num_pages, long long p_sp, long long p_sr, long long p_sg,
                         const int* kv_pos, const int* q_pos, float* acc_p, float* m_p,
                         float* l_p, cudaStream_t stream) {
  constexpr size_t smem = Tile<T, HD, MT>::SMEM;
  static const cudaError_t smem_err = allow_smem(paged_split_kernel<T, HD, MT>, smem);
  if (smem_err != cudaSuccess) return smem_err;
  paged_split_kernel<T, HD, MT><<<split_grid(a, n_split, MT), THREADS, smem, stream>>>(
      a, static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), table, n_pp, page_size, num_pages, p_sp, p_sr, p_sg,
      kv_pos, q_pos, acc_p, m_p, l_p);
  return cudaGetLastError();
}

// The instantiation for (head dim, row tiles) of element type T.
template <template <typename, int, int> class F, typename T, typename... Args>
cudaError_t by_head_dim(int hd, int R, Args... args) {
  const int mt = row_tiles(R, hd);
  switch (hd) {
    case 64: return mt == 1 ? F<T, 64, 1>::run(args...) : F<T, 64, 2>::run(args...);
    case 128: return mt == 1 ? F<T, 128, 1>::run(args...) : F<T, 128, 2>::run(args...);
    case 288: return F<T, 288, 1>::run(args...);
    default: return cudaErrorInvalidValue;
  }
}

// dtype: 0 = float32, 1 = bfloat16.
template <template <typename, int, int> class F, typename... Args>
cudaError_t dispatch(int dtype, int hd, int R, Args... args) {
  if (dtype == 0) return by_head_dim<F, float>(hd, R, args...);
  if (dtype == 1) return by_head_dim<F, __nv_bfloat16>(hd, R, args...);
  return cudaErrorInvalidValue;
}

template <typename T, int HD, int MT>
struct DenseLaunch {
  template <typename... Args>
  static cudaError_t run(Args... args) { return launch_split<T, HD, MT>(args...); }
};

template <typename T, int HD, int MT>
struct PagedLaunch {
  template <typename... Args>
  static cudaError_t run(Args... args) { return launch_paged<T, HD, MT>(args...); }
};

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k and v share it). kind: 0 causal,
// 1 window, 2 streaming. Partials are (n_grid, B, KV, R[, hd]) float32,
// n_grid the most splits the plan asks for at any live length up to S;
// split i scans slots [i * split_len, min(L, (i + 1) * split_len)), L the
// live length read from `bound` (n_bound ints; null: L = S). hd is 64, 128
// or 288 (kernels/flash_decode.py: HEAD_DIMS); any other is refused.
int fd_split(int dtype, const void* q, const void* k, const void* v, const int* kv_pos,
             const int* q_pos, float* acc_p, float* m_p, float* l_p, int B, int KV, int R,
             int S, int hd, long long k_sb, long long k_sg, long long k_ss, int kind,
             int window, int sink, float scale, int n_grid, int cap, const int* bound,
             int n_bound, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Launch a{B, KV, R, S, kind, window, sink, cap, n_bound, bound, scale};
  return dispatch<DenseLaunch>(dtype, hd, R, a, n_grid, q, k, v, kv_pos, q_pos, acc_p, m_p, l_p,
                               k_sb, k_sg, k_ss, st);
}

// The paged twin of fd_split: pools (NP, P, KV, hd) with element strides
// p_sp (page), p_sr (row in page) and p_sg (kv-head), hd contiguous; table
// (B, n_pp) int32; S = n_pp * P slots (kv_pos is (B, S)).
int fd_paged_split(int dtype, const void* q, const void* k_pages, const void* v_pages,
                   const int* table, const int* kv_pos, const int* q_pos, float* acc_p,
                   float* m_p, float* l_p, int B, int KV, int R, int n_pp, int page_size,
                   int num_pages, int hd, long long p_sp, long long p_sr, long long p_sg,
                   int kind, int window, int sink, float scale, int n_grid, int cap,
                   const int* bound, int n_bound, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_pages < 1) return cudaErrorInvalidValue;
  const Launch a{B, KV, R, n_pp * page_size, kind, window, sink, cap, n_bound, bound, scale};
  return dispatch<PagedLaunch>(dtype, hd, R, a, n_grid, q, k_pages, v_pages, table, n_pp,
                               page_size, num_pages, p_sp, p_sr, p_sg, kv_pos, q_pos, acc_p,
                               m_p, l_p, st);
}

// S, cap, bound and n_bound as the split launch's: both run one plan.
int fd_combine(const float* acc_p, const float* m_p, const float* l_p, long long rows, int hd,
               int S, int cap, const int* bound, int n_bound, const float* acc_d,
               const float* m_d, const float* l_d, float* out, float* out_m, float* out_l,
               void* stream) {
  if (hd > 1024) return cudaErrorInvalidValue;
  combine_kernel<<<(unsigned)rows, hd, 0, static_cast<cudaStream_t>(stream)>>>(
      acc_p, m_p, l_p, rows, hd, S, cap, bound, n_bound, acc_d, m_d, l_d, out, out_m, out_l);
  return cudaGetLastError();
}

}  // extern "C"
