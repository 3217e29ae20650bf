// Flash attention for Hopper (sm_90a), forward and backward, on the tensor
// cores in 3xTF32: the port of the Pallas kernel
// repro/kernels/flash_attention.py::flash_attention_pallas (_flash_kernel),
// plus the backward that the TPU kernel lacks (there the learner
// differentiates repro/kernels/ref.py::chunked_attention).
//
// float32 in and out, layouts as the reference's public function:
//     q [B, Sq, H, D], k / v [B, Sk, KV, D], o [B, Sq, H, D],
//     lse [B, H, Sq] (per-row logsumexp of the scaled scores, +inf for a
//     row with no visible key);
//     query head h reads kv head h / g, g = H / KV (GQA);
//     key j is visible from query row i (position q_offset + i) iff
//     j < Sk, (!causal || j <= q_offset + i) and
//     (!window || j > q_offset + i - window);
//     o[i] = sum_j p_ij v_j with p the softmax of scale * q_i . k_j over the
//     visible keys (scale = 1/sqrt(D)); a row with no visible key is 0.
// The backward takes dO and returns dQ, dK, dV.  D is 32, 64 or 128.
//
// Precision: 3xTF32.  Every operand x of every product (Q, K, V, P, dO, dS)
// is split into big = x rounded to TF32 and small = x - big, and small*big +
// big*small + big*big is accumulated in fp32 by mma.sync m16n8k8 TF32; only
// small*small and small's own rounding (about 2^-21 relative) are lost, so
// the results stay within the port's fp32 tolerances (1e-5 forward, 1e-4
// gradients).  One TF32 pass
// would not: its ~2^-11 relative error per operand misses 1e-5 by two orders
// of magnitude.  It is the route of PyTorch's memory-efficient attention in
// fp32 (CUTLASS's OpMultiplyAddFastF32).
//
// Bound on the H100: 3 tensor-core products per product at 495 TFLOP/s
// (TF32 dense), or the bytes at 3.35 TB/s.  The forward does 4 * D flops per
// visible (query, key) pair and head, the backward 10 (S, dP, dV, dK, dQ);
// this backward recomputes S and dP in both of its passes, 14, so it can
// reach at most 10/14 of its bound.  At the learner's [128, 256, 20, 128]
// causal forward: 43 GFLOP (130 GFLOP on the tensor cores, 0.26 ms) against
// 1.34 GB of inputs and outputs (0.40 ms): bytes bound it there, operations
// at Phi-3.5-MoE's [2, 4096, 32/8, 128].  Splitting operands costs integer
// and fp32 instructions beside each MMA; on an H100 they, not the tensor
// cores, set the pace, so the split is as cheap as it can be (below).
// `python -m repro_torch.kernels.flash_variants` times this source against
// the variants it replaced.
//
// Design (FlashAttention-2 on mma.sync):
//   * A block is 4 warps; each warp owns 16 rows of the block's 64-row tile
//     (queries in the forward and dQ, keys in dK/dV) and keeps its score
//     fragments and its output accumulators in registers.  The other
//     operand streams through shared memory in tiles of BN rows, loaded with
//     16-byte cp.async two stages deep, so tile j + 1 lands while tile j
//     computes.  Shared rows are padded to D + 4 floats: 16-byte aligned for
//     cp.async, and every fragment load of a warp hits 32 distinct banks.
//     Tiles of 64 rows and BN = 16 (D = 128), 64 / 32 (D <= 64, forward /
//     backward) keep shared memory at 37-102 KB a block, two or more blocks
//     on an SM.
//   * The product of the score tile with the next operand (P V, dS K,
//     P^T dO, dS^T Q) takes the score accumulators as its A fragments as
//     they stand: its contraction index is permuted (A column t <-> key 2t,
//     t + 4 <-> 2t + 1) and the B rows are read in the same order, so no
//     shuffle and no shared-memory round trip.  Row max and row sum reduce
//     over the four lanes of a quad; the row sum stays a per-lane partial
//     until the end.
//   * Masking: scores of invisible pairs become -1e30 before the row max,
//     and the probabilities are re-masked after the exp (the Pallas kernel
//     is not, flash_attention.py:83): a row whose first visited tile is
//     fully masked carries no phantom mass, so the result does not depend on
//     the tile order.  Only the tiles that hold a visible key of the block
//     (causal frontier, window, q_offset) are visited; ragged edges load as
//     zeros and are masked; a warp's tile that is visible throughout skips
//     the mask.  Exponentials are exp2 of scores in log2 units.
//   * Backward: D_i = rowsum(dO_i * O_i) first (D / 4 lanes per row, a
//     float4 of O and of dO each); then one
//     block per (k tile, kv head, b) accumulates dK and dV over the g query
//     heads of its group and every q tile that sees the k tile, recomputing
//     P from Q, K and the saved lse, and one block per (q tile, h, b)
//     accumulates dQ over its k tiles.  No atomics: every gradient element
//     is summed by one lane in a fixed order, so results are the same from
//     run to run.
//   * Grids put the tile index in z, the slowest dimension, so the longest
//     causal blocks start first: q tiles from the last down (forward, dQ),
//     k tiles from the first up (dK/dV).
// Each kernel launches on the caller's stream and allocates nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // rows of a block's own tile

// Rows of a streamed tile: keys in the forward, keys (dQ) or queries (dK/dV)
// in the backward.
template <int D>
__host__ __device__ constexpr int fwd_cols() {
  return D == 128 ? 16 : 64;
}

template <int D>
__host__ __device__ constexpr int bwd_cols() {
  return D == 128 ? 16 : 32;
}

struct Geometry {
  int Sq, Sk, H, KV, g;
  int causal, window, q_offset;
  float scale;
};

__device__ __forceinline__ bool visible(const Geometry& geo, int qi, int kj) {
  const int qp = geo.q_offset + qi;
  return qi < geo.Sq && kj < geo.Sk && (!geo.causal || kj <= qp) &&
         (!geo.window || kj > qp - geo.window);
}

// Whether every key of [k_lo, k_hi) is visible from every query row of
// [q_lo, q_hi): such a tile needs no mask.
__device__ __forceinline__ bool all_visible(const Geometry& geo, int q_lo, int q_hi, int k_lo,
                                            int k_hi) {
  return q_hi <= geo.Sq && k_hi <= geo.Sk && (!geo.causal || k_hi - 1 <= geo.q_offset + q_lo) &&
         (!geo.window || k_lo > geo.q_offset + q_hi - 1 - geo.window);
}

// Bit 4n + c set where element c of fragment n (row g + 8 (c >> 1), column
// 8n + 2t + (c & 1) of a 16 x 8 NT tile) is visible; rows are queries, or
// keys when `keys_are_rows`.
template <int NT>
__device__ __forceinline__ uint32_t visible_bits(const Geometry& geo, int row, int col0, int t,
                                                 bool keys_are_rows) {
  static_assert(NT * 4 <= 32, "one bit per element");
  uint32_t bits = 0;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = row + 8 * (c >> 1);
      const int col = col0 + 8 * n + 2 * t + (c & 1);
      if (keys_are_rows ? visible(geo, col, r) : visible(geo, r, col)) bits |= 1u << (4 * n + c);
    }
  return bits;
}

// First key and one past the last key any of query rows [r0, r1) can see.
__device__ __forceinline__ void key_range(const Geometry& geo, int r0, int r1, int* k_begin,
                                          int* k_end) {
  *k_end = geo.causal ? min(geo.Sk, geo.q_offset + r1) : geo.Sk;
  *k_begin = geo.window ? max(0, geo.q_offset + r0 - geo.window + 1) : 0;
}

// First and one past the last query row that can see any of keys [c0, c1).
__device__ __forceinline__ void query_range(const Geometry& geo, int c0, int c1, int* r_begin,
                                            int* r_end) {
  *r_begin = geo.causal ? max(0, c0 - geo.q_offset) : 0;
  *r_end = geo.window ? min(geo.Sq, c1 - 1 + geo.window - geo.q_offset) : geo.Sq;
}

// Number of BN-row tiles from the one holding `begin` to the one holding
// `end - 1`, and the first of them.
template <int BN>
__device__ __forceinline__ int tile_span(int begin, int end, int* first) {
  *first = begin / BN;
  return end > begin ? (end + BN - 1) / BN - *first : 0;
}

// ------------------------------------------------------- async copies, MMA
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + ROWS) of a [.., rows, heads, D] tensor (row stride
// `stride` floats, head already applied to `base`) into a [ROWS][D + 4]
// shared tile; rows at or past `nrows` become zeros.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* tile, const float* __restrict__ base,
                                          size_t stride, int row0, int nrows) {
  constexpr int kC4 = D / 4;
  for (int idx = threadIdx.x; idx < ROWS * kC4; idx += kThreads) {
    const int r = idx / kC4;
    const int c = (idx % kC4) * 4;
    const bool in = row0 + r < nrows;
    cp_async16(tile + r * (D + 4) + c, in ? base + static_cast<size_t>(row0 + r) * stride + c : base,
               in);
  }
}

// src[i0 .. i0 + N) into dst, zeros at or past n.
template <int N>
__device__ __forceinline__ void load_vec(float* dst, const float* __restrict__ src, int i0, int n) {
  for (int i = threadIdx.x; i < N; i += kThreads) {
    const bool in = i0 + i < n;
    cp_async4(dst + i, in ? src + i0 + i : src, in);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) x[i][c] = 0.f;
}

// x = big + small: big is x rounded to TF32 (to nearest, ties away from
// zero: cvt.rna.tf32.f32 for finite x, in two integer operations where
// cvt.rna takes four SASS instructions; flash_variants' cvt_split), small =
// x - big in fp32, which the tensor cores read truncated to TF32 (its 19
// high bits).  Together they hold
// x to about 2^-21 relative; a NaN in x stays a NaN in small.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One k-step of 3xTF32: big * big into `big`, the cross terms small * big
// and big * small into `small`.  Each product sums its contraction in these
// two tensor-core accumulators only over one tile (all of D for S and dP,
// the BN streamed rows for the products with P or dS), and adds them into
// the running sum in fp32: one accumulator over a whole row of tiles
// drifted on an H100, past the gradients' 1e-4 at Phi-3.5-MoE's shape
// (flash_variants' one_accumulator).
__device__ __forceinline__ void mma_3xtf32(float (&big)[4], float (&small)[4],
                                           const uint32_t (&ab)[4], const uint32_t (&as)[4],
                                           const uint32_t (&bb)[2], const uint32_t (&bs)[2]) {
  mma_tf32(small, as, bb);
  mma_tf32(small, ab, bs);
  mma_tf32(big, ab, bb);
}

// s[n] = A B^T over d in [0, D): A is the warp's 16 rows of a [.][D + 4]
// shared tile, B the NT * 8 rows of another; s[n] is the 16 x 8 block of
// columns [8n, 8n + 8), lane (g, t) holding rows g, g + 8 and columns 2t,
// 2t + 1.
template <int D, int NT>
__device__ __forceinline__ void mma_abt(float (&s)[NT][4], const float* As, const float* Bs,
                                        int g, int t) {
  constexpr int LD = D + 4;
  float small[NT][4];
  zero(s);
  zero(small);
#pragma unroll
  for (int ks = 0; ks < D; ks += 8) {
    uint32_t ab[4], as[4];
    const float* a = As + g * LD + ks + t;
    split(a[0], ab[0], as[0]);
    split(a[8 * LD], ab[1], as[1]);
    split(a[4], ab[2], as[2]);
    split(a[8 * LD + 4], ab[3], as[3]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float* b = Bs + (8 * n + g) * LD + ks + t;
      uint32_t bb[2], bs[2];
      split(b[0], bb[0], bs[0]);
      split(b[4], bb[1], bs[1]);
      mma_3xtf32(s[n], small[n], ab, as, bb, bs);
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[n][c] += small[n][c];
}

// acc[n] += P B: P is 16 x (8 KT) in mma_abt's fragments, B a [8 KT][D + 4]
// shared tile, acc[n] columns [8n, 8n + 8) of D.  The contraction index is
// permuted (A column t <-> row 2t of B, t + 4 <-> 2t + 1), so P's
// accumulator fragment is its A fragment as it stands.
template <int D, int KT>
__device__ __forceinline__ void mma_pb(float (&acc)[D / 8][4], const float (&p)[KT][4],
                                       const float* Bs, int g, int t) {
  constexpr int LD = D + 4;
  uint32_t ab[KT][4], as[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    split(p[kk][0], ab[kk][0], as[kk][0]);
    split(p[kk][2], ab[kk][1], as[kk][1]);
    split(p[kk][1], ab[kk][2], as[kk][2]);
    split(p[kk][3], ab[kk][3], as[kk][3]);
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    float big[4] = {0.f, 0.f, 0.f, 0.f}, small[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      const float* b = Bs + (8 * kk + 2 * t) * LD + 8 * n + g;
      uint32_t bb[2], bs[2];
      split(b[0], bb[0], bs[0]);
      split(b[LD], bb[1], bs[1]);
      mma_3xtf32(big, small, ab[kk], as[kk], bb, bs);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] += big[c] + small[c];
  }
}

// The warp's 16 rows of `acc` (lane rows row0 + g and row0 + g + 8, which
// hold fragment elements c >> 1 = 0 and 1) times mul[0] and mul[1] into
// out[row * stride + column], rows at or past `nrows` skipped.
template <int D>
__device__ __forceinline__ void store_rows(float* __restrict__ out, size_t stride, int row0,
                                           int nrows, const float (&acc)[D / 8][4],
                                           const float (&mul)[2], int g, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + 8 * half;
    if (r >= nrows) continue;
    float* dst = out + static_cast<size_t>(r) * stride + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(acc[n][2 * half] * mul[half], acc[n][2 * half + 1] * mul[half]);
    }
  }
}

// ------------------------------------------------------------------ forward
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                     Geometry geo) {
  constexpr int LD = D + 4;
  constexpr int BN = fwd_cols<D>();
  constexpr int NT = BN / 8;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // [kRows][LD]
  float* Ks = Qs + kRows * LD;    // [2][BN][LD]
  float* Vs = Ks + 2 * BN * LD;   // [2][BN][LD]

  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) >> 2;
  const int t = threadIdx.x & 3;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;
  const int kvh = h / geo.g;
  const size_t q_stride = static_cast<size_t>(geo.H) * D;
  const size_t kv_stride = static_cast<size_t>(geo.KV) * D;
  const float* kb = k + (static_cast<size_t>(b) * geo.Sk * geo.KV + kvh) * D;
  const float* vb = v + (static_cast<size_t>(b) * geo.Sk * geo.KV + kvh) * D;

  int k_begin, k_end, first;
  key_range(geo, q0, min(q0 + kRows, geo.Sq), &k_begin, &k_end);
  const int n_tiles = tile_span<BN>(k_begin, k_end, &first);
  load_tile<D, kRows>(Qs, q + (static_cast<size_t>(b) * geo.Sq * geo.H + h) * D, q_stride, q0,
                      geo.Sq);
  if (n_tiles > 0) {
    load_tile<D, BN>(Ks, kb, kv_stride, first * BN, geo.Sk);
    load_tile<D, BN>(Vs, vb, kv_stride, first * BN, geo.Sk);
  }
  cp_async_commit();

  const int row = q0 + 16 * warp + g;  // this lane's rows: row, row + 8
  const float* Qw = Qs + 16 * warp * LD;
  const float scale_log2 = geo.scale * kLog2e;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
  zero(acc);

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) {
      load_tile<D, BN>(Ks + (stage ^ 1) * BN * LD, kb, kv_stride, (first + j + 1) * BN, geo.Sk);
      load_tile<D, BN>(Vs + (stage ^ 1) * BN * LD, vb, kv_stride, (first + j + 1) * BN, geo.Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Kt = Ks + stage * BN * LD;
    const float* Vt = Vs + stage * BN * LD;
    const int k0 = (first + j) * BN;

    float s[NT][4];
    mma_abt<D, NT>(s, Qw, Kt, g, t);
    // Scores in log2 units (scale * log2 e folded in), so p = 2^(s - m).
    const bool full = all_visible(geo, row - g, row - g + 16, k0, k0 + BN);
    const uint32_t bits = full ? ~0u : visible_bits<NT>(geo, row, k0, t, false);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[n][c] = (bits >> (4 * n + c)) & 1u ? s[n][c] * scale_log2 : kNegInf;
        mx[c >> 1] = fmaxf(mx[c >> 1], s[n][c]);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = (bits >> (4 * n + c)) & 1u ? exp2f(s[n][c] - m[c >> 1]) : 0.f;  // re-masked
        s[n][c] = p;
        l[c >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n][c] *= alpha[c >> 1];
    mma_pb<D, NT>(acc, s, Vt, g, t);
    __syncthreads();  // stage j is consumed before tile j + 2 overwrites it
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;  // a row with no visible key is 0
    const int r = row + 8 * i;
    if (t == 0 && r < geo.Sq) {
      lse[(static_cast<size_t>(b) * geo.H + h) * geo.Sq + r] =
          l[i] > 0.f ? (m[i] + log2f(l[i])) * kLn2 : INFINITY;
    }
  }
  store_rows<D>(o + (static_cast<size_t>(b) * geo.Sq * geo.H + h) * D, q_stride, q0 + 16 * warp,
                geo.Sq, acc, inv, g, t);
}

// --------------------------------------------------------------- backward
// D_i = sum_d dO_i,d * O_i,d for every (b, s, h) row, written [B, H, Sq]:
// D / 4 lanes per row, one float4 of O and of dO each.
template <int D>
__global__ void flash_bwd_rowdot_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                                        float* __restrict__ delta, int rows, int Sq, int H) {
  constexpr int kLanes = D / 4;
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / kLanes;
  const int c = (threadIdx.x % kLanes) * 4;
  float acc = 0.f;
  if (row < rows) {
    const float4 x = *reinterpret_cast<const float4*>(o + static_cast<size_t>(row) * D + c);
    const float4 y = *reinterpret_cast<const float4*>(dout + static_cast<size_t>(row) * D + c);
    acc = x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && c == 0) {
    const int h = row % H;
    const int s = (row / H) % Sq;
    const int b = row / (H * Sq);
    delta[(static_cast<size_t>(b) * H + h) * Sq + s] = acc;
  }
}

// dK and dV for one (k tile, kv head, b): the warp's 16 keys are the rows,
// queries the streamed columns; S^T and dP^T are recomputed per q tile.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, Geometry geo) {
  constexpr int LD = D + 4;
  constexpr int BN = bwd_cols<D>();
  constexpr int NT = BN / 8;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;               // [kRows][LD]
  float* Vs = Ks + kRows * LD;    // [kRows][LD]
  float* Qs = Vs + kRows * LD;    // [2][BN][LD]
  float* Gs = Qs + 2 * BN * LD;   // [2][BN][LD], dO
  float* Ls = Gs + 2 * BN * LD;   // [2][BN], lse
  float* Ds = Ls + 2 * BN;        // [2][BN], delta

  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) >> 2;
  const int t = threadIdx.x & 3;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kRows;
  const size_t q_stride = static_cast<size_t>(geo.H) * D;
  const size_t kv_stride = static_cast<size_t>(geo.KV) * D;
  const size_t kv_off = (static_cast<size_t>(b) * geo.Sk * geo.KV + kvh) * D;

  int r_begin, r_end, first;
  query_range(geo, k0, min(k0 + kRows, geo.Sk), &r_begin, &r_end);
  const int per_head = tile_span<BN>(r_begin, r_end, &first);
  const int n_tiles = geo.g * per_head;  // (head of the group, q tile), head major

  auto load_q_tile = [&](int i, int stage) {
    const int h = kvh * geo.g + i / per_head;
    const int r0 = (first + i % per_head) * BN;
    const size_t q_off = (static_cast<size_t>(b) * geo.Sq * geo.H + h) * D;
    const size_t row_off = (static_cast<size_t>(b) * geo.H + h) * geo.Sq;
    load_tile<D, BN>(Qs + stage * BN * LD, q + q_off, q_stride, r0, geo.Sq);
    load_tile<D, BN>(Gs + stage * BN * LD, dout + q_off, q_stride, r0, geo.Sq);
    load_vec<BN>(Ls + stage * BN, lse + row_off, r0, geo.Sq);
    load_vec<BN>(Ds + stage * BN, delta + row_off, r0, geo.Sq);
  };

  load_tile<D, kRows>(Ks, k + kv_off, kv_stride, k0, geo.Sk);
  load_tile<D, kRows>(Vs, v + kv_off, kv_stride, k0, geo.Sk);
  if (n_tiles > 0) load_q_tile(0, 0);
  cp_async_commit();

  const int key = k0 + 16 * warp + g;  // this lane's keys: key, key + 8
  const float scale_log2 = geo.scale * kLog2e;
  const float* Kw = Ks + 16 * warp * LD;
  const float* Vw = Vs + 16 * warp * LD;
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) {
      load_q_tile(j + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Qt = Qs + stage * BN * LD;
    const float* Gt = Gs + stage * BN * LD;
    const float* Lt = Ls + stage * BN;
    const float* Dt = Ds + stage * BN;
    const int r0 = (first + j % per_head) * BN;

    float s[NT][4], dp[NT][4];  // S^T and dP^T: rows keys, columns queries
    mma_abt<D, NT>(s, Kw, Qt, g, t);
    mma_abt<D, NT>(dp, Vw, Gt, g, t);
    const bool full = all_visible(geo, r0, r0 + BN, key - g, key - g + 16);
    const uint32_t bits = full ? ~0u : visible_bits<NT>(geo, key, r0, t, true);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 8 * n + 2 * t + (c & 1);
        const float p = (bits >> (4 * n + c)) & 1u
                            ? exp2f(fmaf(s[n][c], scale_log2, -Lt[col] * kLog2e))
                            : 0.f;
        dp[n][c] = p * (dp[n][c] - Dt[col]);  // dS^T, the gradient of the scaled score
        s[n][c] = p;
      }
    mma_pb<D, NT>(dv_acc, s, Gt, g, t);   // dV += P^T dO
    mma_pb<D, NT>(dk_acc, dp, Qt, g, t);  // dK += dS^T Q (times scale at the end)
    __syncthreads();
  }
  cp_async_wait<0>();

  const float one[2] = {1.f, 1.f};
  const float scale[2] = {geo.scale, geo.scale};
  const int krow0 = k0 + 16 * warp;
  store_rows<D>(dk + kv_off, kv_stride, krow0, geo.Sk, dk_acc, scale, g, t);
  store_rows<D>(dv + kv_off, kv_stride, krow0, geo.Sk, dv_acc, one, g, t);
}

// dQ for one (q tile, h, b).
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, Geometry geo) {
  constexpr int LD = D + 4;
  constexpr int BN = bwd_cols<D>();
  constexpr int NT = BN / 8;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // [kRows][LD]
  float* Gs = Qs + kRows * LD;    // [kRows][LD], dO
  float* Ks = Gs + kRows * LD;    // [2][BN][LD]
  float* Vs = Ks + 2 * BN * LD;   // [2][BN][LD]

  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) >> 2;
  const int t = threadIdx.x & 3;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;
  const int kvh = h / geo.g;
  const size_t q_stride = static_cast<size_t>(geo.H) * D;
  const size_t kv_stride = static_cast<size_t>(geo.KV) * D;
  const size_t q_off = (static_cast<size_t>(b) * geo.Sq * geo.H + h) * D;
  const float* kb = k + (static_cast<size_t>(b) * geo.Sk * geo.KV + kvh) * D;
  const float* vb = v + (static_cast<size_t>(b) * geo.Sk * geo.KV + kvh) * D;

  int k_begin, k_end, first;
  key_range(geo, q0, min(q0 + kRows, geo.Sq), &k_begin, &k_end);
  const int n_tiles = tile_span<BN>(k_begin, k_end, &first);
  load_tile<D, kRows>(Qs, q + q_off, q_stride, q0, geo.Sq);
  load_tile<D, kRows>(Gs, dout + q_off, q_stride, q0, geo.Sq);
  if (n_tiles > 0) {
    load_tile<D, BN>(Ks, kb, kv_stride, first * BN, geo.Sk);
    load_tile<D, BN>(Vs, vb, kv_stride, first * BN, geo.Sk);
  }
  cp_async_commit();

  const int row = q0 + 16 * warp + g;  // this lane's rows: row, row + 8
  const float* lb = lse + (static_cast<size_t>(b) * geo.H + h) * geo.Sq;
  const float* db = delta + (static_cast<size_t>(b) * geo.H + h) * geo.Sq;
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row + 8 * i < geo.Sq;
    row_lse[i] = in ? lb[row + 8 * i] * kLog2e : 0.f;  // log2 units
    row_delta[i] = in ? db[row + 8 * i] : 0.f;
  }
  const float* Qw = Qs + 16 * warp * LD;
  const float* Gw = Gs + 16 * warp * LD;
  const float scale_log2 = geo.scale * kLog2e;
  float dq_acc[D / 8][4];
  zero(dq_acc);

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) {
      load_tile<D, BN>(Ks + (stage ^ 1) * BN * LD, kb, kv_stride, (first + j + 1) * BN, geo.Sk);
      load_tile<D, BN>(Vs + (stage ^ 1) * BN * LD, vb, kv_stride, (first + j + 1) * BN, geo.Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Kt = Ks + stage * BN * LD;
    const float* Vt = Vs + stage * BN * LD;
    const int k0 = (first + j) * BN;

    float s[NT][4], dp[NT][4];
    mma_abt<D, NT>(s, Qw, Kt, g, t);
    mma_abt<D, NT>(dp, Gw, Vt, g, t);
    const bool full = all_visible(geo, row - g, row - g + 16, k0, k0 + BN);
    const uint32_t bits = full ? ~0u : visible_bits<NT>(geo, row, k0, t, false);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c >> 1;
        const float p = (bits >> (4 * n + c)) & 1u
                            ? exp2f(fmaf(s[n][c], scale_log2, -row_lse[i]))
                            : 0.f;
        s[n][c] = p * (dp[n][c] - row_delta[i]);  // dS
      }
    mma_pb<D, NT>(dq_acc, s, Kt, g, t);  // dQ += dS K (times scale at the end)
    __syncthreads();
  }
  cp_async_wait<0>();

  const float scale[2] = {geo.scale, geo.scale};
  store_rows<D>(dq + q_off, q_stride, q0 + 16 * warp, geo.Sq, dq_acc, scale, g, t);
}

template <int D>
constexpr size_t fwd_smem() {
  return static_cast<size_t>(kRows + 4 * fwd_cols<D>()) * (D + 4) * sizeof(float);
}

template <int D>
constexpr size_t dq_smem() {
  return static_cast<size_t>(2 * kRows + 4 * bwd_cols<D>()) * (D + 4) * sizeof(float);
}

template <int D>
constexpr size_t dkdv_smem() {
  return dq_smem<D>() + 4 * bwd_cols<D>() * sizeof(float);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

int tiles(int n) { return (n + kRows - 1) / kRows; }

Geometry make_geometry(int Sq, int Sk, int H, int KV, int causal, int window, int q_offset,
                       float scale) {
  Geometry geo;
  geo.Sq = Sq;
  geo.Sk = Sk;
  geo.H = H;
  geo.KV = KV;
  geo.g = H / KV;
  geo.causal = causal;
  geo.window = window;
  geo.q_offset = q_offset;
  geo.scale = scale;
  return geo;
}

template <int D>
cudaError_t fwd(const float* q, const float* k, const float* v, float* o, float* lse, int B,
                const Geometry& geo, cudaStream_t stream) {
  const size_t bytes = fwd_smem<D>();
  cudaError_t err = allow_smem(flash_fwd_kernel<D>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(geo.H, B, tiles(geo.Sq));
  flash_fwd_kernel<D><<<grid, kThreads, bytes, stream>>>(q, k, v, o, lse, geo);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd(const float* q, const float* k, const float* v, const float* o, const float* dout,
                const float* lse, float* delta, float* dq, float* dk, float* dv, int B,
                const Geometry& geo, cudaStream_t stream) {
  const int rows = B * geo.Sq * geo.H;
  constexpr int kRowThreads = 256;
  const int row_blocks = static_cast<int>((static_cast<int64_t>(rows) * (D / 4) + kRowThreads - 1) /
                                          kRowThreads);
  flash_bwd_rowdot_kernel<D><<<row_blocks, kRowThreads, 0, stream>>>(o, dout, delta, rows, geo.Sq,
                                                                     geo.H);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = allow_smem(flash_bwd_dkdv_kernel<D>, dkdv_smem<D>());
  if (err == cudaSuccess) err = allow_smem(flash_bwd_dq_kernel<D>, dq_smem<D>());
  if (err != cudaSuccess) return err;
  const dim3 grid_kv(geo.KV, B, tiles(geo.Sk));
  flash_bwd_dkdv_kernel<D><<<grid_kv, kThreads, dkdv_smem<D>(), stream>>>(q, k, v, dout, lse,
                                                                         delta, dk, dv, geo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q(geo.H, B, tiles(geo.Sq));
  flash_bwd_dq_kernel<D><<<grid_q, kThreads, dq_smem<D>(), stream>>>(q, k, v, dout, lse, delta,
                                                                    dq, geo);
  return cudaGetLastError();
}

bool bad_shape(int B, int Sq, int Sk, int H, int KV, int D) {
  return B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 || B > 65535 ||
         tiles(Sq) > 65535 || tiles(Sk) > 65535 || !(D == 32 || D == 64 || D == 128);
}

}  // namespace

// Forward: q [B,Sq,H,D], k/v [B,Sk,KV,D] -> o [B,Sq,H,D], lse [B,H,Sq].
extern "C" int flash_attention_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                          void* lse, int B, int Sq, int Sk, int H, int KV, int D,
                                          int causal, int window, int q_offset, float scale,
                                          void* stream) {
  if (bad_shape(B, Sq, Sk, H, KV, D)) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry geo = make_geometry(Sq, Sk, H, KV, causal, window, q_offset, scale);
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  auto* op = static_cast<float*>(o);
  auto* lp = static_cast<float*>(lse);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 32) err = fwd<32>(qp, kp, vp, op, lp, B, geo, st);
  else if (D == 64) err = fwd<64>(qp, kp, vp, op, lp, B, geo, st);
  else err = fwd<128>(qp, kp, vp, op, lp, B, geo, st);
  return static_cast<int>(err);
}

// Backward: from q, k, v, o, dO and the forward's lse, with `delta` a
// [B,H,Sq] scratch buffer, write dq [B,Sq,H,D] and dk, dv [B,Sk,KV,D].
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          void* delta, void* dq, void* dk, void* dv, int B,
                                          int Sq, int Sk, int H, int KV, int D, int causal,
                                          int window, int q_offset, float scale, void* stream) {
  if (bad_shape(B, Sq, Sk, H, KV, D)) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry geo = make_geometry(Sq, Sk, H, KV, causal, window, q_offset, scale);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  const auto* op = static_cast<const float*>(o);
  const auto* gp = static_cast<const float*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  auto* dp = static_cast<float*>(delta);
  auto* dqp = static_cast<float*>(dq);
  auto* dkp = static_cast<float*>(dk);
  auto* dvp = static_cast<float*>(dv);
  cudaError_t err;
  if (D == 32) err = bwd<32>(qp, kp, vp, op, gp, lp, dp, dqp, dkp, dvp, B, geo, st);
  else if (D == 64) err = bwd<64>(qp, kp, vp, op, gp, lp, dp, dqp, dkp, dvp, B, geo, st);
  else err = bwd<128>(qp, kp, vp, op, gp, lp, dp, dqp, dkp, dvp, B, geo, st);
  return static_cast<int>(err);
}
