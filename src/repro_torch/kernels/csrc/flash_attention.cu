// Flash attention for Hopper (sm_90a), forward and backward: the port of the
// Pallas kernel repro/kernels/flash_attention.py::flash_attention_pallas
// (_flash_kernel), plus the backward that the TPU kernel lacks (there the
// learner differentiates repro/kernels/ref.py::chunked_attention).
//
// float32 throughout, layouts as the reference's public function:
//     q [B, Sq, H, D], k / v [B, Sk, KV, D], o [B, Sq, H, D],
//     lse [B, H, Sq] (per-row logsumexp of the scaled scores, +inf for a
//     row with no visible key);
//     query head h reads kv head h / g, g = H / KV (GQA);
//     key j is visible from query row i (position q_offset + i) iff
//     j < Sk, (!causal || j <= q_offset + i) and
//     (!window || j > q_offset + i - window);
//     o[i] = sum_j p_ij v_j with p the softmax of scale * q_i . k_j over the
//     visible keys (scale = 1/sqrt(D)); a row with no visible key is 0.
// The backward takes dO and returns dQ, dK, dV.
//
// Bound on the H100: operations.  The forward does 4 * B * H * D flops per
// visible (query, key) pair, the backward 10 (S, dP, dV, dK, dQ, with S
// recomputed): at the learner's [128, 256, 20, 128] causal forward that is
// 43 GFLOP against 134 MB of inputs and outputs, 320 flops per byte, far
// above the 20 flops per byte at which 67 TFLOP/s fp32 meets 3.35 TB/s.
// The kernels run in fp32 on the CUDA cores (no TF32: the port's parity
// tolerance is 1e-5), so the bound is flops / 67 TFLOP/s.
//
// Design (FlashAttention-2 on CUDA cores):
//   * Forward: one block of 256 threads per (q tile of 64 rows, h, b).  The
//     TPU kernel's sequential grid axis over K tiles becomes a loop inside
//     the block over 64-key tiles, running only over the tiles that hold a
//     visible key of the q tile (causal frontier and window), and masking
//     the ragged edge of Sq and Sk.  Q, K, V and the probability tile live
//     in shared memory (116 KB at D = 128, hence the dynamic shared-memory
//     opt-in); each thread keeps a 4 x 4 score tile and a 4 x D/16 slice of
//     the output accumulator in registers, with the row max and sum reduced
//     over the 16 threads of a row by warp shuffles.  The probabilities are
//     re-masked after the exp (the Pallas kernel is not, flash_attention.py
//     :83): a row whose first visited tile is fully masked then carries no
//     phantom mass, so the result does not depend on the tile order.
//   * Backward: D_i = rowsum(dO_i * O_i) first (one warp per row); then one
//     block per (k tile, kv head, b) accumulates dK and dV in registers over
//     the g query heads of its group and every q tile that sees the k tile,
//     recomputing P from Q, K and the saved lse; and one block per (q tile,
//     h, b) accumulates dQ over its k tiles.  No atomics: every gradient
//     element is summed by one thread in a fixed order, so the results are
//     the same from run to run.
// Each kernel launches on the caller's stream and allocates nothing.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;  // query rows per tile
constexpr int kBK = 64;  // keys per tile
constexpr int kThreads = 256;
constexpr int kPLD = kBK + 1;  // row stride of the probability tile in shared memory

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

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy rows [row0, row0 + 64) of a [.., rows, heads, D] tensor (row stride
// `stride` floats, head already applied to `base`) into a [64][D + 1] tile;
// rows at or past `nrows` become zeros.
template <int D>
__device__ __forceinline__ void load_tile(float* tile, const float* __restrict__ base,
                                          size_t stride, int row0, int nrows) {
  constexpr int kC4 = D / 4;
  for (int idx = threadIdx.x; idx < 64 * kC4; idx += kThreads) {
    const int r = idx / kC4;
    const int c = (idx % kC4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < nrows) {
      val = *reinterpret_cast<const float4*>(base + static_cast<size_t>(row0 + r) * stride + c);
    }
    float* dst = tile + r * (D + 1) + c;
    dst[0] = val.x;
    dst[1] = val.y;
    dst[2] = val.z;
    dst[3] = val.w;
  }
}

// ------------------------------------------------------------------ forward
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                     Geometry geo) {
  constexpr int LD = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ps = Vs + kBK * LD;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / geo.g;
  const size_t q_stride = static_cast<size_t>(geo.H) * D;
  const size_t kv_stride = static_cast<size_t>(geo.KV) * D;
  const float* qb = q + (static_cast<size_t>(b) * geo.Sq * geo.H + h) * D;
  const float* kb = k + (static_cast<size_t>(b) * geo.Sk * geo.KV + kvh) * D;
  const float* vb = v + (static_cast<size_t>(b) * geo.Sk * geo.KV + kvh) * D;

  load_tile<D>(Qs, qb, q_stride, q0, geo.Sq);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  int k_begin, k_end;
  key_range(geo, q0, min(q0 + kBQ, geo.Sq), &k_begin, &k_end);
  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile<D>(Ks, kb, kv_stride, k0, geo.Sk);
    load_tile<D>(Vs, vb, kv_stride, k0, geo.Sk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = visible(geo, q0 + r, k0 + tx + 16 * j);
        s[i][j] = ok[j] ? s[i][j] * geo.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max16(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;  // re-masked
        Ps[r * kPLD + tx + 16 * j] = p;
        rs += p;
      }
      rs = row_sum16(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * kPLD + c];
#pragma unroll
      for (int kk = 0; kk < NC; ++kk) vv[kk] = Vs[c * LD + tx + 16 * kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int kk = 0; kk < NC; ++kk) acc[i][kk] = fmaf(p[i], vv[kk], acc[i][kk]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= geo.Sq) continue;
    float* orow = o + (static_cast<size_t>(b) * geo.Sq + r) * q_stride + static_cast<size_t>(h) * D;
    const bool any = l[i] > 0.f;
#pragma unroll
    for (int kk = 0; kk < NC; ++kk) orow[tx + 16 * kk] = any ? acc[i][kk] / l[i] : 0.f;
    if (tx == 0) {
      lse[(static_cast<size_t>(b) * geo.H + h) * geo.Sq + r] = any ? m[i] + logf(l[i]) : INFINITY;
    }
  }
}

// --------------------------------------------------------------- backward
// D_i = sum_d dO_i,d * O_i,d, one warp per (b, s, h) row, written [B, H, Sq].
__global__ void flash_bwd_rowdot_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                                        float* __restrict__ delta, int rows, int Sq, int H,
                                        int D) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* orow = o + static_cast<size_t>(row) * D;
  const float* grow = dout + static_cast<size_t>(row) * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(orow[d], grow[d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % H;
    const int s = (row / H) % Sq;
    const int b = row / (H * Sq);
    delta[(static_cast<size_t>(b) * H + h) * Sq + s] = acc;
  }
}

// S and dP for a 64 x 64 tile: rows from A (Q) and A2 (dO), columns from
// B (K) and B2 (V), each a [64][D + 1] shared tile.
template <int D>
__device__ __forceinline__ void scores_and_dp(const float* As, const float* A2s, const float* Bs,
                                              const float* B2s, int ty, int tx, float s[4][4],
                                              float dp[4][4]) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = 0.f;
      dp[i][j] = 0.f;
    }
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], a2[4], bk[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = As[(ty + 16 * i) * LD + d];
      a2[i] = A2s[(ty + 16 * i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bk[j] = Bs[(tx + 16 * j) * LD + d];
      bv[j] = B2s[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], bk[j], s[i][j]);
        dp[i][j] = fmaf(a2[i], bv[j], dp[i][j]);
      }
  }
}

// dK and dV for one (k tile, kv head, b).
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, Geometry geo) {
  constexpr int LD = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBK * LD;
  float* Qs = Vs + kBK * LD;
  float* Gs = Qs + kBQ * LD;  // dO tile
  float* Ps = Gs + kBQ * LD;  // P, then dS
  float* Ls = Ps + kBQ * kPLD;
  float* Ds = Ls + kBQ;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * kBK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const size_t q_stride = static_cast<size_t>(geo.H) * D;
  const size_t kv_stride = static_cast<size_t>(geo.KV) * D;
  load_tile<D>(Ks, k + (static_cast<size_t>(b) * geo.Sk * geo.KV + kvh) * D, kv_stride, k0, geo.Sk);
  load_tile<D>(Vs, v + (static_cast<size_t>(b) * geo.Sk * geo.KV + kvh) * D, kv_stride, k0, geo.Sk);

  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk_acc[i][c] = 0.f;
      dv_acc[i][c] = 0.f;
    }

  int r_begin, r_end;
  query_range(geo, k0, min(k0 + kBK, geo.Sk), &r_begin, &r_end);
  for (int hh = 0; hh < geo.g; ++hh) {
    const int h = kvh * geo.g + hh;
    const float* qb = q + (static_cast<size_t>(b) * geo.Sq * geo.H + h) * D;
    const float* gb = dout + (static_cast<size_t>(b) * geo.Sq * geo.H + h) * D;
    const float* lb = lse + (static_cast<size_t>(b) * geo.H + h) * geo.Sq;
    const float* db = delta + (static_cast<size_t>(b) * geo.H + h) * geo.Sq;
    for (int q0 = (r_begin / kBQ) * kBQ; q0 < r_end; q0 += kBQ) {
      __syncthreads();  // the previous tile's Q, dO and dS are consumed
      load_tile<D>(Qs, qb, q_stride, q0, geo.Sq);
      load_tile<D>(Gs, gb, q_stride, q0, geo.Sq);
      for (int r = threadIdx.x; r < kBQ; r += kThreads) {
        const bool in = q0 + r < geo.Sq;
        Ls[r] = in ? lb[q0 + r] : INFINITY;
        Ds[r] = in ? db[q0 + r] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      scores_and_dp<D>(Qs, Gs, Ks, Vs, ty, tx, s, dp);
      // Rows i are queries, columns j keys.
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const float p = visible(geo, q0 + r, k0 + c) ? expf(s[i][j] * geo.scale - Ls[r]) : 0.f;
          Ps[r * kPLD + c] = p;
          dp[i][j] = p * (dp[i][j] - Ds[r]);  // dS, the gradient of the scaled score
        }
      }
      __syncthreads();
      // dV[c] += sum_r P[r, c] dO[r]; this thread owns key rows c = ty + 16 i.
#pragma unroll 4
      for (int r = 0; r < kBQ; ++r) {
        float p[4], gg[NC];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = Ps[r * kPLD + ty + 16 * i];
#pragma unroll
        for (int kk = 0; kk < NC; ++kk) gg[kk] = Gs[r * LD + tx + 16 * kk];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int kk = 0; kk < NC; ++kk) dv_acc[i][kk] = fmaf(p[i], gg[kk], dv_acc[i][kk]);
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * kPLD + tx + 16 * j] = dp[i][j];
      __syncthreads();
      // dK[c] += sum_r dS[r, c] Q[r] (times scale at the end).
#pragma unroll 4
      for (int r = 0; r < kBQ; ++r) {
        float ds[4], qq[NC];
#pragma unroll
        for (int i = 0; i < 4; ++i) ds[i] = Ps[r * kPLD + ty + 16 * i];
#pragma unroll
        for (int kk = 0; kk < NC; ++kk) qq[kk] = Qs[r * LD + tx + 16 * kk];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int kk = 0; kk < NC; ++kk) dk_acc[i][kk] = fmaf(ds[i], qq[kk], dk_acc[i][kk]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= geo.Sk) continue;
    const size_t off = (static_cast<size_t>(b) * geo.Sk + c) * kv_stride + static_cast<size_t>(kvh) * D;
#pragma unroll
    for (int kk = 0; kk < NC; ++kk) {
      dk[off + tx + 16 * kk] = dk_acc[i][kk] * geo.scale;
      dv[off + tx + 16 * kk] = dv_acc[i][kk];
    }
  }
}

// dQ for one (q tile, h, b).
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, Geometry geo) {
  constexpr int LD = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Gs = Qs + kBQ * LD;
  float* Ks = Gs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ps = Vs + kBK * LD;  // dS
  float* Ls = Ps + kBQ * kPLD;
  float* Ds = Ls + kBQ;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / geo.g;
  const size_t q_stride = static_cast<size_t>(geo.H) * D;
  const size_t kv_stride = static_cast<size_t>(geo.KV) * D;
  const size_t q_off = (static_cast<size_t>(b) * geo.Sq * geo.H + h) * D;
  const float* kb = k + (static_cast<size_t>(b) * geo.Sk * geo.KV + kvh) * D;
  const float* vb = v + (static_cast<size_t>(b) * geo.Sk * geo.KV + kvh) * D;
  load_tile<D>(Qs, q + q_off, q_stride, q0, geo.Sq);
  load_tile<D>(Gs, dout + q_off, q_stride, q0, geo.Sq);
  const float* lb = lse + (static_cast<size_t>(b) * geo.H + h) * geo.Sq;
  const float* db = delta + (static_cast<size_t>(b) * geo.H + h) * geo.Sq;
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const bool in = q0 + r < geo.Sq;
    Ls[r] = in ? lb[q0 + r] : INFINITY;
    Ds[r] = in ? db[q0 + r] : 0.f;
  }

  float dq_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq_acc[i][c] = 0.f;

  int k_begin, k_end;
  key_range(geo, q0, min(q0 + kBQ, geo.Sq), &k_begin, &k_end);
  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();
    load_tile<D>(Ks, kb, kv_stride, k0, geo.Sk);
    load_tile<D>(Vs, vb, kv_stride, k0, geo.Sk);
    __syncthreads();
    float s[4][4], dp[4][4];
    scores_and_dp<D>(Qs, Gs, Ks, Vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = visible(geo, q0 + r, k0 + c) ? expf(s[i][j] * geo.scale - Ls[r]) : 0.f;
        Ps[r * kPLD + c] = p * (dp[i][j] - Ds[r]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float ds[4], kk_[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = Ps[(ty + 16 * i) * kPLD + c];
#pragma unroll
      for (int kk = 0; kk < NC; ++kk) kk_[kk] = Ks[c * LD + tx + 16 * kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int kk = 0; kk < NC; ++kk) dq_acc[i][kk] = fmaf(ds[i], kk_[kk], dq_acc[i][kk]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= geo.Sq) continue;
    float* row = dq + (static_cast<size_t>(b) * geo.Sq + r) * q_stride + static_cast<size_t>(h) * D;
#pragma unroll
    for (int kk = 0; kk < NC; ++kk) row[tx + 16 * kk] = dq_acc[i][kk] * geo.scale;
  }
}

template <int D>
constexpr size_t fwd_smem() {
  return (3 * 64 * (D + 1) + kBQ * kPLD) * sizeof(float);
}

template <int D>
constexpr size_t bwd_smem() {
  return (4 * 64 * (D + 1) + kBQ * kPLD + 2 * kBQ) * sizeof(float);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
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

template <int D>
cudaError_t fwd(const float* q, const float* k, const float* v, float* o, float* lse, int B,
                const Geometry& geo, cudaStream_t stream) {
  const size_t bytes = fwd_smem<D>();
  cudaError_t err = allow_smem(flash_fwd_kernel<D>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((geo.Sq + kBQ - 1) / kBQ, geo.H, B);
  flash_fwd_kernel<D><<<grid, kThreads, bytes, stream>>>(q, k, v, o, lse, geo);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd(const float* q, const float* k, const float* v, const float* dout,
                const float* lse, const float* delta, float* dq, float* dk, float* dv, int B,
                const Geometry& geo, cudaStream_t stream) {
  const size_t bytes = bwd_smem<D>();
  cudaError_t err = allow_smem(flash_bwd_dkdv_kernel<D>, bytes);
  if (err == cudaSuccess) err = allow_smem(flash_bwd_dq_kernel<D>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((geo.Sk + kBK - 1) / kBK, geo.KV, B);
  flash_bwd_dkdv_kernel<D><<<grid_kv, kThreads, bytes, stream>>>(q, k, v, dout, lse, delta, dk,
                                                                 dv, geo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q((geo.Sq + kBQ - 1) / kBQ, geo.H, B);
  flash_bwd_dq_kernel<D><<<grid_q, kThreads, bytes, stream>>>(q, k, v, dout, lse, delta, dq, geo);
  return cudaGetLastError();
}

bool bad_shape(int B, int Sq, int Sk, int H, int KV, int D) {
  return B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 || H > 65535 || B > 65535 ||
         !(D == 32 || D == 64 || D == 128);
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
  const int rows = B * Sq * H;
  constexpr int kRowsPerBlock = 8;
  flash_bwd_rowdot_kernel<<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, kRowsPerBlock * 32, 0,
                            st>>>(static_cast<const float*>(o), static_cast<const float*>(dout),
                                  static_cast<float*>(delta), rows, Sq, H, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  const auto* gp = static_cast<const float*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dp = static_cast<const float*>(delta);
  auto* dqp = static_cast<float*>(dq);
  auto* dkp = static_cast<float*>(dk);
  auto* dvp = static_cast<float*>(dv);
  if (D == 32) err = bwd<32>(qp, kp, vp, gp, lp, dp, dqp, dkp, dvp, B, geo, st);
  else if (D == 64) err = bwd<64>(qp, kp, vp, gp, lp, dp, dqp, dkp, dvp, B, geo, st);
  else err = bwd<128>(qp, kp, vp, gp, lp, dp, dqp, dkp, dvp, B, geo, st);
  return static_cast<int>(err);
}
