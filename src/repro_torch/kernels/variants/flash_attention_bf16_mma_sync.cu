// The bf16 flash-attention design that csrc/flash_attention_bf16.cu
// replaced, kept to be timed beside it (python -m
// repro_torch.kernels.flash_variants --bf16) and never linked into the
// library: FlashAttention-2 on the warp-level mma.sync m16n8k16, 64 query
// rows a block, K and V staged by every thread's 16-byte cp.async two
// stages deep.  Its entry points, flash_attention_bf16_mma_sync_fwd_launch
// and flash_attention_bf16_mma_sync_bwd_launch, take the arguments of the
// shipped flash_attention_bf16_fwd_launch and flash_attention_bf16_bwd_launch.
//
// Flash attention forward for Hopper (sm_90a) at bfloat16: the port of the
// Pallas kernel repro/kernels/flash_attention.py::flash_attention_pallas
// (_flash_kernel) in the dtype the reference's models run it at (every
// configuration defaults to bfloat16, repro/configs/base.py), where the TPU
// kernel widens its bf16 operands to fp32, accumulates in fp32 and rounds
// its output back to bf16 (flash_attention.py:73-75,95).
//
// bf16 in and out, fp32 statistics, layouts as flash_attention.cu:
//     q [B, Sq, H, D], k / v [B, Sk, KV, D], o [B, Sq, H, D] bf16,
//     lse [B, H, Sq] fp32 (+inf for a row with no visible key);
//     query head h reads kv head h / g, g = H / KV (GQA); the same
//     visibility (causal, window, q_offset) and the same zero row.
// D is 32, 64 or 128.  The backward (flash_attention_bf16_bwd_launch, the
// counterpart of jax.grad through repro/kernels/ref.py::chunked_attention
// at bf16) takes bf16 q, k, v, o and dO and the forward's fp32 lse and
// writes bf16 dq, dk, dv.
//
// Precision: a product of two bf16 values is exact in fp32, so one bf16
// tensor-core pass with an fp32 accumulator (mma.sync m16n8k16) computes
// S = Q K^T as the reference's dot_general of the widened operands does, up
// to the order of the sum; no operand split is needed.  P V multiplies the
// fp32 probabilities by bf16 V: P is rounded to bf16 for one pass (about
// 2^-9 relative a weight), which is what the reference's dot_general at
// default precision computes on a TPU and what its plain CPU path
// (ref.chunked_attention: p.astype(v.dtype)) computes too.  The row sum l
// adds the unrounded fp32 weights.  As in the float32 kernel, each tile of
// the contraction over keys is summed from zero on the tensor cores and then
// added into the fp32 running sum; the output is rounded to bf16 once.
//
// Bound on the H100: 4 * D flops per visible (query, key) pair and head at
// 989 TFLOP/s (bf16 dense), or the bytes (2 a bf16 element, 4 an lse) at
// 3.35 TB/s.  At the serve prefills' [2, 512, 48/8, 128] causal that is 6.5
// GFLOP (0.0065 ms) against 29.4 MB (0.0088 ms): bytes bound it there, and
// operations at Qwen3-14B's [2, 4096, 40/8, 128].
//
// Design (FlashAttention-2 on mma.sync, as flash_attention.cu's forward): a
// block of 4 warps owns 64 query rows, 16 a warp, with its scores and its
// output accumulators in registers; K and V stream through shared memory in
// tiles of 64 keys, 16-byte cp.async two stages deep.  Shared rows are
// padded to D + 8 bf16 (16 bytes): every 32-bit fragment load of a warp and
// every ldmatrix phase hits 32 distinct banks.  The score accumulators are
// P's A fragments as they stand (the m16n8k16 accumulator and A layouts
// line up), packed to bf16 pairs; V's B fragments come from ldmatrix.trans.
// Masking, the visited tiles, the re-masked probabilities, exp2 in log2
// units and the grid order are flash_attention.cu's.
//
// Backward: flash_attention.cu's three launches and its order of sums, on
// the same mma.sync m16n8k16 bf16 products as the forward.  (1) delta_i =
// sum_d dO_i,d O_i,d in fp32 from the bf16 O and dO, D / 8 lanes a row.
// (2) One block per (64-key tile, kv head, b), 16 keys a warp, streams the
// query tiles of each of the group's g query heads (BN = 64 queries, 16 at
// D = 128, two stages of cp.async); per tile it recomputes S^T = K Q^T and
// P^T = exp(S^T scale - lse) in fp32 from the forward's fp32 logsumexp,
// dP^T = V dO^T in fp32, and dS^T = P^T o (dP^T - delta); dV += P^T dO with
// P^T rounded to bf16 (the reference rounds P to v's dtype,
// ref.py:53,97, and differentiates through that rounding), dK += dS^T Q
// with dS^T rounded to bf16.  (3) One block per (64-query tile, h, b)
// streams 64-key tiles and sums dQ += dS K the same way.  Each streamed
// tile's product is summed from zero and then added into the fp32 running
// sums; a kv head's dK and dV sum over its g query heads in fp32; dK and dQ
// take the scale at the end, and each gradient is rounded to bf16 once.
// No atomics: every element is summed by one lane in a fixed order, so two
// calls give the same bits.  Bound: 10 * D flops a visible (query, key)
// pair and head (S, dP, dV, dK, dQ; 2.5x the forward's 4 D), or the bytes.
// Each kernel launches on the caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows of a block
constexpr int kCols = 64;           // keys of a streamed tile
constexpr int kNT = kCols / 8;      // 8-key fragments of a tile
constexpr int kPad = 8;             // bf16 of padding a shared row

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
// keys when `keys_are_rows` (dK/dV).
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

// First key and one past the last key any of query rows [r0, r1) can see.
__device__ __forceinline__ void key_range(const Geometry& geo, int r0, int r1, int* k_begin,
                                          int* k_end) {
  *k_end = geo.causal ? min(geo.Sk, geo.q_offset + r1) : geo.Sk;
  *k_begin = geo.window ? max(0, geo.q_offset + r0 - geo.window + 1) : 0;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 4 : 0));
}

// src[i0 .. i0 + N) (fp32) into dst, zeros at or past n.
template <int N>
__device__ __forceinline__ void load_vec(float* dst, const float* __restrict__ src, int i0, int n) {
  for (int i = threadIdx.x; i < N; i += kThreads) {
    const bool in = i0 + i < n;
    cp_async4(dst + i, in ? src + i0 + i : src, in);
  }
}

// Rows [row0, row0 + ROWS) of a [.., rows, heads, D] bf16 tensor (row
// stride `stride` elements, head already applied to `base`) into a
// [ROWS][D + kPad] shared tile; rows at or past `nrows` become zeros.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* __restrict__ base,
                                          size_t stride, int row0, int nrows) {
  constexpr int kC8 = D / 8;  // 16-byte chunks a row
  for (int idx = threadIdx.x; idx < ROWS * kC8; idx += kThreads) {
    const int r = idx / kC8;
    const int c = (idx % kC8) * 8;
    const bool in = row0 + r < nrows;
    cp_async16(tile + r * (D + kPad) + c,
               in ? base + static_cast<size_t>(row0 + r) * stride + c : base, in);
  }
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two fp32 values rounded to a bf16 pair, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Four 8x8 bf16 matrices from shared memory, transposed: lane l gives the
// row address of row l & 7 of matrix l >> 3.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) x[i][c] = 0.f;
}

// s[n] = A B^T over all of D for a warp's 16 rows of A (Aw: query rows in
// the forward and dQ, key rows in dK/dV) and the NT * 8 rows of a streamed
// tile B (keys, or queries in dK/dV), both [.][D + kPad] shared tiles: s[n]
// holds B rows [8n, 8n + 8), lane (g, t) rows g and g + 8, B rows 2t and
// 2t + 1.
template <int D, int NT>
__device__ __forceinline__ void mma_abt(float (&s)[NT][4], const bf16* Aw, const bf16* Bt, int g,
                                        int t) {
  constexpr int LD = D + kPad;
  zero(s);
#pragma unroll
  for (int ks = 0; ks < D; ks += 16) {
    const bf16* qa = Aw + g * LD + ks + 2 * t;
    const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * LD), ld32(qa + 8), ld32(qa + 8 * LD + 8)};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const bf16* kb = Bt + (8 * n + g) * LD + ks + 2 * t;
      const uint32_t b[2] = {ld32(kb), ld32(kb + 8)};
      mma_bf16(s[n], a, b);
    }
  }
}

// acc[n] += P B over a streamed tile's NT * 8 rows: P 16 x (NT * 8) in
// mma_abt's layout, rounded to bf16 (the probabilities in the forward and
// in dV, dS in dK and dQ); B a [NT * 8][D + kPad] shared tile (V, dO, Q or
// K).  Each pair of 8-column blocks of D is summed over the tile from zero,
// then added into acc.
template <int D, int NT>
__device__ __forceinline__ void mma_pb(float (&acc)[D / 8][4], const float (&p)[NT][4],
                                       const bf16* Bt, int lane) {
  constexpr int LD = D + kPad;
  static_assert(NT % 2 == 0, "a tile of whole 16-row k-steps");
  uint32_t a[NT / 2][4];
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    a[kk][0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    a[kk][1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    a[kk][2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
  }
  // Matrix l >> 3 of an ldmatrix: rows + 8 ((l >> 3) & 1), columns + 8 (l >> 4).
  const bf16* base = Bt + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
  for (int n = 0; n < D / 8; n += 2) {
    float part[2][4];
    zero(part);
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, base + 16 * kk * LD + 8 * n);
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      mma_bf16(part[0], a[kk], b0);
      mma_bf16(part[1], a[kk], b1);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[n][c] += part[0][c];
      acc[n + 1][c] += part[1][c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse, Geometry geo) {
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kRows][LD]
  bf16* Ks = Qs + kRows * LD;                     // [2][kCols][LD]
  bf16* Vs = Ks + 2 * kCols * LD;                 // [2][kCols][LD]

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;
  const int kvh = h / geo.g;
  const size_t q_stride = static_cast<size_t>(geo.H) * D;
  const size_t kv_stride = static_cast<size_t>(geo.KV) * D;
  const bf16* kb = k + (static_cast<size_t>(b) * geo.Sk * geo.KV + kvh) * D;
  const bf16* vb = v + (static_cast<size_t>(b) * geo.Sk * geo.KV + kvh) * D;

  int k_begin, k_end, first;
  key_range(geo, q0, min(q0 + kRows, geo.Sq), &k_begin, &k_end);
  const int n_tiles = tile_span<kCols>(k_begin, k_end, &first);
  load_tile<D, kRows>(Qs, q + (static_cast<size_t>(b) * geo.Sq * geo.H + h) * D, q_stride, q0,
                      geo.Sq);
  if (n_tiles > 0) {
    load_tile<D, kCols>(Ks, kb, kv_stride, first * kCols, geo.Sk);
    load_tile<D, kCols>(Vs, vb, kv_stride, first * kCols, geo.Sk);
  }
  cp_async_commit();

  const int row = q0 + 16 * warp + g;  // this lane's rows: row, row + 8
  const bf16* Qw = Qs + 16 * warp * LD;
  const float scale_log2 = geo.scale * kLog2e;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
  zero(acc);

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) {
      load_tile<D, kCols>(Ks + (stage ^ 1) * kCols * LD, kb, kv_stride, (first + j + 1) * kCols,
                          geo.Sk);
      load_tile<D, kCols>(Vs + (stage ^ 1) * kCols * LD, vb, kv_stride, (first + j + 1) * kCols,
                          geo.Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + stage * kCols * LD;
    const bf16* Vt = Vs + stage * kCols * LD;
    const int k0 = (first + j) * kCols;

    float s[kNT][4];
    mma_abt<D, kNT>(s, Qw, Kt, g, t);
    // Scores in log2 units (scale * log2 e folded in), so p = 2^(s - m).
    const bool full = all_visible(geo, row - g, row - g + 16, k0, k0 + kCols);
    const uint32_t bits = full ? ~0u : visible_bits<kNT>(geo, row, k0, t, false);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kNT; ++n)
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
    for (int n = 0; n < kNT; ++n)
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
    mma_pb<D, kNT>(acc, s, Vt, lane);
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
  bf16* ob = o + (static_cast<size_t>(b) * geo.Sq * geo.H + h) * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + 8 * half;
    if (r >= geo.Sq) continue;
    bf16* dst = ob + static_cast<size_t>(r) * q_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dst + 8 * n) =
          pack_bf16(acc[n][2 * half] * inv[half], acc[n][2 * half + 1] * inv[half]);
    }
  }
}

// --------------------------------------------------------------- backward
// Query rows of a streamed tile in dK/dV: 16 at D = 128 keeps the dK and dV
// accumulators (128 fp32 a lane) and the tile's S^T and dP^T in registers
// (32 spilled 52 bytes at 255 registers on an H100's ptxas).
template <int D>
__host__ __device__ constexpr int bwd_kv_cols() {
  return D == 128 ? 16 : 64;
}

// A warp's 16 rows x D of an fp32 accumulator, times scale, rounded to bf16
// into rows [row0, row0 + 16) of a [.., rows, heads, D] tensor (row stride
// `stride`); rows at or past `nrows` are not written.
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, size_t stride, int row0, int nrows,
                                           const float (&acc)[D / 8][4], float scale, int g,
                                           int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + 8 * half;
    if (r >= nrows) continue;
    bf16* dst = base + static_cast<size_t>(r) * stride + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dst + 8 * n) =
          pack_bf16(acc[n][2 * half] * scale, acc[n][2 * half + 1] * scale);
    }
  }
}

// delta_i = sum_d dO_i,d * O_i,d for every (b, s, h) row, written [B, H, Sq]:
// D / 8 lanes per row, 16 bytes of O and of dO each, summed in fp32.
template <int D>
__global__ void flash_bwd_bf16_rowdot_kernel(const bf16* __restrict__ o,
                                             const bf16* __restrict__ dout,
                                             float* __restrict__ delta, int rows, int Sq, int H) {
  constexpr int kLanes = D / 8;
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / kLanes;
  const int c = (threadIdx.x % kLanes) * 8;
  float acc = 0.f;
  if (row < rows) {
    const uint4 x = *reinterpret_cast<const uint4*>(o + static_cast<size_t>(row) * D + c);
    const uint4 y = *reinterpret_cast<const uint4*>(dout + static_cast<size_t>(row) * D + c);
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ys[i]));
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
    }
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
    flash_bwd_bf16_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const bf16* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               bf16* __restrict__ dk, bf16* __restrict__ dv, Geometry geo) {
  constexpr int LD = D + kPad;
  constexpr int BN = bwd_kv_cols<D>();
  constexpr int NT = BN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);       // [kRows][LD]
  bf16* Vs = Ks + kRows * LD;                          // [kRows][LD]
  bf16* Qs = Vs + kRows * LD;                          // [2][BN][LD]
  bf16* Gs = Qs + 2 * BN * LD;                         // [2][BN][LD], dO
  float* Ls = reinterpret_cast<float*>(Gs + 2 * BN * LD);  // [2][BN], lse
  float* Ds = Ls + 2 * BN;                             // [2][BN], delta

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane >> 2;
  const int t = lane & 3;
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
  const bf16* Kw = Ks + 16 * warp * LD;
  const bf16* Vw = Vs + 16 * warp * LD;
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
    const bf16* Qt = Qs + stage * BN * LD;
    const bf16* Gt = Gs + stage * BN * LD;
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
    mma_pb<D, NT>(dv_acc, s, Gt, lane);   // dV += P^T dO, P^T rounded to bf16
    mma_pb<D, NT>(dk_acc, dp, Qt, lane);  // dK += dS^T Q, dS^T rounded (times scale at the end)
    __syncthreads();
  }
  cp_async_wait<0>();

  const int krow0 = k0 + 16 * warp;
  store_rows<D>(dk + kv_off, kv_stride, krow0, geo.Sk, dk_acc, geo.scale, g, t);
  store_rows<D>(dv + kv_off, kv_stride, krow0, geo.Sk, dv_acc, 1.f, g, t);
}

// dQ for one (q tile, h, b): the warp's 16 queries are the rows, keys the
// streamed columns (tiles of kCols).
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_bf16_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             bf16* __restrict__ dq, Geometry geo) {
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kRows][LD]
  bf16* Gs = Qs + kRows * LD;                     // [kRows][LD], dO
  bf16* Ks = Gs + kRows * LD;                     // [2][kCols][LD]
  bf16* Vs = Ks + 2 * kCols * LD;                 // [2][kCols][LD]

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;
  const int kvh = h / geo.g;
  const size_t q_stride = static_cast<size_t>(geo.H) * D;
  const size_t kv_stride = static_cast<size_t>(geo.KV) * D;
  const size_t q_off = (static_cast<size_t>(b) * geo.Sq * geo.H + h) * D;
  const bf16* kb = k + (static_cast<size_t>(b) * geo.Sk * geo.KV + kvh) * D;
  const bf16* vb = v + (static_cast<size_t>(b) * geo.Sk * geo.KV + kvh) * D;

  int k_begin, k_end, first;
  key_range(geo, q0, min(q0 + kRows, geo.Sq), &k_begin, &k_end);
  const int n_tiles = tile_span<kCols>(k_begin, k_end, &first);
  load_tile<D, kRows>(Qs, q + q_off, q_stride, q0, geo.Sq);
  load_tile<D, kRows>(Gs, dout + q_off, q_stride, q0, geo.Sq);
  if (n_tiles > 0) {
    load_tile<D, kCols>(Ks, kb, kv_stride, first * kCols, geo.Sk);
    load_tile<D, kCols>(Vs, vb, kv_stride, first * kCols, geo.Sk);
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
  const bf16* Qw = Qs + 16 * warp * LD;
  const bf16* Gw = Gs + 16 * warp * LD;
  const float scale_log2 = geo.scale * kLog2e;
  float dq_acc[D / 8][4];
  zero(dq_acc);

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) {
      load_tile<D, kCols>(Ks + (stage ^ 1) * kCols * LD, kb, kv_stride, (first + j + 1) * kCols,
                          geo.Sk);
      load_tile<D, kCols>(Vs + (stage ^ 1) * kCols * LD, vb, kv_stride, (first + j + 1) * kCols,
                          geo.Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + stage * kCols * LD;
    const bf16* Vt = Vs + stage * kCols * LD;
    const int k0 = (first + j) * kCols;

    float s[kNT][4], dp[kNT][4];
    mma_abt<D, kNT>(s, Qw, Kt, g, t);
    mma_abt<D, kNT>(dp, Gw, Vt, g, t);
    const bool full = all_visible(geo, row - g, row - g + 16, k0, k0 + kCols);
    const uint32_t bits = full ? ~0u : visible_bits<kNT>(geo, row, k0, t, false);
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c >> 1;
        const float p = (bits >> (4 * n + c)) & 1u
                            ? exp2f(fmaf(s[n][c], scale_log2, -row_lse[i]))
                            : 0.f;
        s[n][c] = p * (dp[n][c] - row_delta[i]);  // dS
      }
    mma_pb<D, kNT>(dq_acc, s, Kt, lane);  // dQ += dS K, dS rounded to bf16 (times scale at the end)
    __syncthreads();
  }
  cp_async_wait<0>();

  store_rows<D>(dq + q_off, q_stride, q0 + 16 * warp, geo.Sq, dq_acc, geo.scale, g, t);
}

template <int D>
constexpr size_t fwd_smem() {
  return static_cast<size_t>(kRows + 4 * kCols) * (D + kPad) * sizeof(bf16);
}

template <int D>
cudaError_t fwd(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int B,
                const Geometry& geo, cudaStream_t stream) {
  constexpr size_t bytes = fwd_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(geo.H, B, (geo.Sq + kRows - 1) / kRows);
  flash_fwd_bf16_kernel<D><<<grid, kThreads, bytes, stream>>>(q, k, v, o, lse, geo);
  return cudaGetLastError();
}

template <int D>
constexpr size_t dkdv_smem() {
  return static_cast<size_t>(2 * kRows + 4 * bwd_kv_cols<D>()) * (D + kPad) * sizeof(bf16) +
         4 * bwd_kv_cols<D>() * sizeof(float);
}

template <int D>
constexpr size_t dq_smem() {
  return static_cast<size_t>(2 * kRows + 4 * kCols) * (D + kPad) * sizeof(bf16);
}

template <int D>
cudaError_t bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
                const float* lse, float* delta, bf16* dq, bf16* dk, bf16* dv, int B,
                const Geometry& geo, cudaStream_t stream) {
  const int rows = B * geo.Sq * geo.H;
  constexpr int kRowThreads = 256;
  const int row_blocks = static_cast<int>((static_cast<int64_t>(rows) * (D / 8) + kRowThreads - 1) /
                                          kRowThreads);
  flash_bwd_bf16_rowdot_kernel<D><<<row_blocks, kRowThreads, 0, stream>>>(o, dout, delta, rows,
                                                                          geo.Sq, geo.H);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_bf16_dkdv_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dkdv_smem<D>()));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_bf16_dq_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dq_smem<D>()));
  if (err != cudaSuccess) return err;
  const dim3 grid_kv(geo.KV, B, (geo.Sk + kRows - 1) / kRows);
  flash_bwd_bf16_dkdv_kernel<D><<<grid_kv, kThreads, dkdv_smem<D>(), stream>>>(
      q, k, v, dout, lse, delta, dk, dv, geo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q(geo.H, B, (geo.Sq + kRows - 1) / kRows);
  flash_bwd_bf16_dq_kernel<D><<<grid_q, kThreads, dq_smem<D>(), stream>>>(q, k, v, dout, lse,
                                                                         delta, dq, geo);
  return cudaGetLastError();
}

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

bool bad_shape(int B, int Sq, int Sk, int H, int KV, int D) {
  return B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 || B > 65535 ||
         (Sq + kRows - 1) / kRows > 65535 || (Sk + kRows - 1) / kRows > 65535 ||
         !(D == 32 || D == 64 || D == 128);
}

}  // namespace

// Forward: q [B,Sq,H,D], k/v [B,Sk,KV,D] bf16 -> o [B,Sq,H,D] bf16, lse
// [B,H,Sq] fp32.  Needs H % KV == 0, D in {32, 64, 128}, B and the query
// tiles at most 65535, and 16-byte aligned tensors (the Python wrapper
// checks).
extern "C" int flash_attention_bf16_mma_sync_fwd_launch(const void* q, const void* k,
                                                        const void* v, void* o, void* lse, int B,
                                                        int Sq, int Sk, int H, int KV, int D,
                                                        int causal, int window, int q_offset,
                                                        float scale, void* stream) {
  if (bad_shape(B, Sq, Sk, H, KV, D)) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry geo = make_geometry(Sq, Sk, H, KV, causal, window, q_offset, scale);
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  auto* op = static_cast<bf16*>(o);
  auto* lp = static_cast<float*>(lse);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 32) err = fwd<32>(qp, kp, vp, op, lp, B, geo, st);
  else if (D == 64) err = fwd<64>(qp, kp, vp, op, lp, B, geo, st);
  else err = fwd<128>(qp, kp, vp, op, lp, B, geo, st);
  return static_cast<int>(err);
}

// Backward: from bf16 q, k, v, o, dO and the forward's fp32 lse, with
// `delta` a [B,H,Sq] fp32 scratch buffer, write bf16 dq [B,Sq,H,D] and dk,
// dv [B,Sk,KV,D].  The same shape limits as the forward.
extern "C" int flash_attention_bf16_mma_sync_bwd_launch(const void* q, const void* k,
                                                        const void* v, const void* o,
                                                        const void* dout, const void* lse,
                                                        void* delta, void* dq, void* dk, void* dv,
                                                        int B, int Sq, int Sk, int H, int KV,
                                                        int D, int causal, int window,
                                                        int q_offset, float scale, void* stream) {
  if (bad_shape(B, Sq, Sk, H, KV, D)) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry geo = make_geometry(Sq, Sk, H, KV, causal, window, q_offset, scale);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  const auto* op = static_cast<const bf16*>(o);
  const auto* gp = static_cast<const bf16*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  auto* dp = static_cast<float*>(delta);
  auto* dqp = static_cast<bf16*>(dq);
  auto* dkp = static_cast<bf16*>(dk);
  auto* dvp = static_cast<bf16*>(dv);
  cudaError_t err;
  if (D == 32) err = bwd<32>(qp, kp, vp, op, gp, lp, dp, dqp, dkp, dvp, B, geo, st);
  else if (D == 64) err = bwd<64>(qp, kp, vp, op, gp, lp, dp, dqp, dkp, dvp, B, geo, st);
  else err = bwd<128>(qp, kp, vp, op, gp, lp, dp, dqp, dkp, dvp, B, geo, st);
  return static_cast<int>(err);
}
