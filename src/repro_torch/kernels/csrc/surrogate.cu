// Fused PPO clipped-surrogate terms for Hopper (sm_90a): the port of the
// Pallas kernels repro/kernels/surrogate.py::ppo_surrogate_pallas
// (_fwd_kernel and the hand-written backward _bwd_kernel under the
// _surrogate_terms custom VJP).
//
// Per row i of float32 logits [B, A], int64 actions [B] and float32 values,
// behaviour logp, advantages and returns [B]:
//     lp_j  = logits_j - logsumexp(logits)          (log-softmax)
//     logp  = lp_{action}    (0 when the action is outside [0, A), as the
//                             reference's one-hot contraction gives)
//     ratio = exp(logp - blp)
//     pg    = -min(ratio * adv, min(max(ratio, lo), hi) * adv)
//     vf    = (value - ret)^2
//     ent   = -sum_j exp(lp_j) * lp_j
//     kl    = blp - logp
// The batch means and pg + vf_coef*vf - ent_coef*ent stay in the Python
// wrapper, shared with the plain version.
//
// The forward also writes each row's logsumexp, lse [B], which the
// autograd Function saves with ent for the backward.
//
// The backward takes the cotangents of the four per-row terms and the saved
// lse and ent, and returns d logits [B, A] and d values, d blp, d adv,
// d ret [B].  It follows JAX's subgradient rule for min/max exactly: at a
// tie each argument gets half (the "balanced_eq" rule of _balanced in the
// TPU kernel).  This matters: inside the clip band ratio*adv and
// clip(ratio)*adv are the same number, so the min ties on most rows.
//
// Bound on the H100: memory.  Forward reads B*(A+5) floats-or-ints and
// writes 5*B floats; backward reads B*(A+11) and writes B*(A+4); the
// arithmetic is a few tens of flops and A+1 exps per row, far below the
// card's rate, so the least time is bytes / 3.35 TB/s.
//
// Design, two variants chosen by A:
//   * A < kRowsMinA (RL action spaces): the forward takes one thread per
//     row and loops over A twice in registers (max, then the exp sum and
//     the entropy); the TPU kernel's [A, 128] lane panels become one row per
//     thread.  A thread reads its A logits contiguously, which for small A
//     lands in the same or neighbouring cache lines as its warp's
//     neighbours.  The backward forms one row's scalars per thread into
//     shared memory, then its block writes d logits of its rows with
//     neighbouring threads on neighbouring logits: one read and one write.
//   * A >= kRowsMinA (a language model's vocabulary): both directions tile
//     [B, A] in chunks of kMapCols columns of one row, a block of
//     kMapThreads threads each, B x ceil(A / kMapCols) blocks, many waves
//     over the SMs, with kMapVec 128-bit loads in flight per thread (scalar
//     loads for a row that is not 16-byte aligned, and for the tail).
//     Forward: a block keeps its chunk in registers, reduces the chunk's
//     max m_k across the block, and from the same registers forms
//     s_k = sum_j e_j and t_k = sum_j e_j (x_j - m_k), e_j = exp(x_j - m_k):
//     one read of the logits and one exp per logit (no online rescale,
//     which made the pass compute-bound).  It writes (m_k, s_k, t_k) to a
//     work buffer [B, chunks, 3] (and, in the chunk holding the action,
//     that logit to a [B] tail of the buffer); the last block of the row,
//     known by an atomic ticket that it resets, merges the partials in
//     chunk order: m = max_k m_k, s = sum_k s_k f_k and
//     t = sum_k f_k (t_k + s_k (m_k - m)), f_k = exp(m_k - m); then
//     lse = m + log s and H = log s - t / s, and it writes the row's terms.
//     One launch, no float atomics, bitwise repeatable.  Backward: each
//     block forms its row's scalars (g_logp, and the row sum of the
//     log-softmax cotangent from the saved entropy, sum_j p_j (lp_j + 1) =
//     1 - H) from lse, ent, row[action] and the [B] vectors while its loads
//     of the logits are in flight, and writes d logits once: one read and
//     one write of the logits, the bound's own traffic.  The block of
//     column 0 writes the four [B] gradients.
// The wrapper allocates the forward's work buffer and keeps its tickets
// zeroed; the kernels allocate nothing and launch on the caller's stream.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct RowSoftmax {
  float lse;   // logsumexp of the row
  float logp;  // log-prob of the taken action (0 if out of range)
  bool valid;  // action in [0, A)
};

__device__ __forceinline__ RowSoftmax row_softmax(const float* __restrict__ row, int A,
                                                  int64_t action) {
  float m = row[0];
  for (int j = 1; j < A; ++j) m = fmaxf(m, row[j]);
  float s = 0.f;
  for (int j = 0; j < A; ++j) s += expf(row[j] - m);
  RowSoftmax out;
  out.lse = m + logf(s);
  out.valid = action >= 0 && action < A;
  out.logp = out.valid ? row[action] - out.lse : 0.f;
  return out;
}

// d/dx of min/max(x, y) evaluated at result z: 1 off-tie, 0.5 on a tie.
__device__ __forceinline__ float balanced(float x, float z, float y) {
  return x == z ? (y == z ? 0.5f : 1.f) : 0.f;
}

// Row i's terms from its logsumexp, entropy and the action's log-prob, and
// its behaviour log-prob b, advantage a, value and return.
__device__ __forceinline__ void write_row_terms(int i, float row_lse, float row_ent, float logp,
                                                float b, float a, float value, float ret_i,
                                                float* __restrict__ pg, float* __restrict__ vf,
                                                float* __restrict__ ent, float* __restrict__ kl,
                                                float* __restrict__ lse, float lo, float hi) {
  const float ratio = expf(logp - b);
  const float unclipped = ratio * a;
  const float clipped = fminf(fmaxf(ratio, lo), hi) * a;
  pg[i] = -fminf(unclipped, clipped);
  const float dv = value - ret_i;
  vf[i] = dv * dv;
  ent[i] = row_ent;
  kl[i] = b - logp;
  lse[i] = row_lse;
}

__global__ void surrogate_fwd_kernel(const float* __restrict__ logits,
                                     const int64_t* __restrict__ actions,
                                     const float* __restrict__ values,
                                     const float* __restrict__ blp, const float* __restrict__ adv,
                                     const float* __restrict__ ret, float* __restrict__ pg,
                                     float* __restrict__ vf, float* __restrict__ ent,
                                     float* __restrict__ kl, float* __restrict__ lse, int B, int A,
                                     float lo, float hi) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const float* row = logits + static_cast<size_t>(i) * A;
  const RowSoftmax sm = row_softmax(row, A, actions[i]);
  float entropy = 0.f;
  for (int j = 0; j < A; ++j) {
    const float lp = row[j] - sm.lse;
    entropy -= expf(lp) * lp;
  }
  write_row_terms(i, sm.lse, entropy, sm.logp, blp[i], adv[i], values[i], ret[i], pg, vf, ent, kl,
                  lse, lo, hi);
}

// The row's scalars of the backward, from the saved lse and ent: the
// cotangent of logp and the row sum of the log-softmax cotangent t_j =
// [j == action] g_logp - g_ent p_j (lp_j + 1), which is g_logp [valid]
// - g_ent (1 - H) since sum_j p_j = 1.  With `write`, also the four [B]
// gradients of row i.
struct RowCotangent {
  float lse;
  float g_logp;
  float g_ent;
  float t_sum;
  int64_t action;
};

__device__ __forceinline__ RowCotangent row_cotangent(
    int i, const float* __restrict__ row, int A, float lse, float ent,
    const int64_t* __restrict__ actions, const float* __restrict__ values,
    const float* __restrict__ blp, const float* __restrict__ adv, const float* __restrict__ ret,
    const float* __restrict__ gpg, const float* __restrict__ gvf, const float* __restrict__ gent,
    const float* __restrict__ gkl, float lo, float hi, bool write, float* __restrict__ dvalues,
    float* __restrict__ dblp, float* __restrict__ dadv, float* __restrict__ dret) {
  RowCotangent out;
  out.action = actions[i];
  out.lse = lse;
  const bool valid = out.action >= 0 && out.action < A;
  const float logp = valid ? row[out.action] - out.lse : 0.f;
  const float a = adv[i];
  const float ratio = expf(logp - blp[i]);
  const float mx = fmaxf(ratio, lo);
  const float rc = fminf(mx, hi);  // == clip(ratio, lo, hi)
  const float u = ratio * a;
  const float c = rc * a;
  const float mn = fminf(u, c);
  const float du = balanced(u, mn, c);
  const float dc = balanced(c, mn, u);
  // d clip / d ratio through max-then-min, each with the balanced tie rule.
  const float dcl = balanced(ratio, mx, lo) * balanced(mx, rc, hi);
  const float g_pg = gpg[i];
  const float g_kl = gkl[i];
  const float g_ratio = -g_pg * (du * a + dc * a * dcl);
  out.g_ent = gent[i];
  out.g_logp = g_ratio * ratio - g_kl;
  out.t_sum = (valid ? out.g_logp : 0.f) - out.g_ent * (1.f - ent);
  if (write) {
    const float dv = gvf[i] * 2.f * (values[i] - ret[i]);
    dvalues[i] = dv;
    dret[i] = -dv;
    dblp[i] = -g_ratio * ratio + g_kl;
    dadv[i] = -g_pg * (du * ratio + dc * rc);
  }
  return out;
}

// d logits_j = t_j - p_j sum(t): the log-softmax VJP of the action gather
// plus the entropy term dH/dlp_j = -p_j (lp_j + 1).
__device__ __forceinline__ float dlogit(const RowCotangent& rc, float x, int j) {
  const float lp = x - rc.lse;
  const float p = expf(lp);
  const float t = (j == rc.action ? rc.g_logp : 0.f) - rc.g_ent * p * (lp + 1.f);
  return t - p * rc.t_sum;
}

constexpr int kThreads = 128;

// One block per kThreads rows: a thread forms its row's scalars into shared
// memory, then the block walks the rows' A * kThreads contiguous logits with
// neighbouring threads on neighbouring logits.
__global__ void __launch_bounds__(kThreads) surrogate_bwd_kernel(
    const float* __restrict__ logits, const int64_t* __restrict__ actions,
    const float* __restrict__ values, const float* __restrict__ blp,
    const float* __restrict__ adv, const float* __restrict__ ret, const float* __restrict__ lse,
    const float* __restrict__ ent, const float* __restrict__ gpg, const float* __restrict__ gvf,
    const float* __restrict__ gent, const float* __restrict__ gkl, float* __restrict__ dlogits,
    float* __restrict__ dvalues, float* __restrict__ dblp, float* __restrict__ dadv,
    float* __restrict__ dret, int B, int A, float lo, float hi) {
  __shared__ RowCotangent s_rc[kThreads];
  const int r0 = blockIdx.x * kThreads;
  const int i = r0 + threadIdx.x;
  if (i < B) {
    s_rc[threadIdx.x] =
        row_cotangent(i, logits + static_cast<size_t>(i) * A, A, lse[i], ent[i], actions, values,
                      blp, adv, ret, gpg, gvf, gent, gkl, lo, hi, true, dvalues, dblp, dadv, dret);
  }
  __syncthreads();
  const size_t base = static_cast<size_t>(r0) * A;
  const int n = min(kThreads, B - r0) * A;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int r = e / A;
    dlogits[base + e] = dlogit(s_rc[r], logits[base + e], e - r * A);
  }
}

constexpr int kRowsMinA = 1024;

inline int blocks_for(int B) { return (B + kThreads - 1) / kThreads; }

constexpr int kMapThreads = 256;
constexpr int kMapVec = 4;  // float4 loads in flight per thread
constexpr int kMapCols = kMapThreads * 4 * kMapVec;
constexpr int kMapWarps = kMapThreads / 32;
// The forward's chunk: kFwdVec float4s a thread, kFwdCols columns a block
// (the backward's kMapCols; kernels/surrogate_variants.py times others).
constexpr int kFwdVec = kMapVec;
constexpr int kFwdCols = kMapThreads * 4 * kFwdVec;

// Chunks of a row in the forward's work buffer; 0 below kRowsMinA.
inline int fwd_chunks(int A) { return A >= kRowsMinA ? (A + kFwdCols - 1) / kFwdCols : 0; }

// Max over the block's kMapThreads threads; every thread gets it.  Each
// call needs its own scratch[kMapWarps], or a barrier before reusing one.
__device__ __forceinline__ float block_max(float x, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = x;
  __syncthreads();
  x = scratch[threadIdx.x % kMapWarps];
#pragma unroll
  for (int o = kMapWarps / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Sums of s and t over the block, in a fixed order, to thread 0 (the other
// threads get garbage).  scratch holds 2 * kMapWarps floats.
__device__ __forceinline__ float2 block_sum2(float s, float t, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    t += __shfl_xor_sync(0xffffffffu, t, o);
  }
  if (threadIdx.x % 32 == 0) {
    scratch[threadIdx.x / 32] = s;
    scratch[kMapWarps + threadIdx.x / 32] = t;
  }
  __syncthreads();
  float2 out = make_float2(0.f, 0.f);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kMapWarps; ++w) {
      out.x += scratch[w];
      out.y += scratch[kMapWarps + w];
    }
  }
  return out;
}

// s += e and t += e (x - m), e = exp(x - m).
__device__ __forceinline__ void exp_sums(float x, float m, float& s, float& t) {
  const float d = x - m;
  const float e = expf(d);
  s += e;
  t = fmaf(e, d, t);
}

// Shared memory of the forward's merge.
struct MergeScratch {
  float max[kMapWarps];
  float a[kMapThreads];
  float b[kMapThreads];
};

// Row i's statistics from its chunks' partials part[k] = (m_k, s_k, t_k):
// m = max_k m_k, s = sum_k s_k f_k and t = sum_k f_k (t_k + s_k (m_k - m)),
// f_k = exp(m_k - m), each sum in chunk order: thread j takes chunk j and
// thread 0 adds the threads' terms in order.  (Past kMapThreads chunks,
// thread j first merges a run of per chunks in order.)  Thread 0 then
// writes the row's terms; act_logit is the action's logit, written by the
// block whose chunk holds the action and read only when the action is in
// [0, A).  Thread 0's loads of the row's inputs go out first, so they land
// while the merge runs; the partials come from other blocks, so they are
// read past L1 (__ldcg).
__device__ __forceinline__ void merge_row(
    int i, int A, int chunks, const float* part, const float* act_logit,
    const int64_t* __restrict__ actions, const float* __restrict__ values,
    const float* __restrict__ blp, const float* __restrict__ adv, const float* __restrict__ ret,
    float* __restrict__ pg, float* __restrict__ vf, float* __restrict__ ent,
    float* __restrict__ kl, float* __restrict__ lse, float lo, float hi, MergeScratch& sh) {
  int64_t action = -1;
  float x_act = 0.f, b = 0.f, a = 0.f, value = 0.f, ret_i = 0.f;
  if (threadIdx.x == 0) {
    action = actions[i];
    x_act = __ldcg(act_logit);
    b = blp[i];
    a = adv[i];
    value = values[i];
    ret_i = ret[i];
  }
  const int per = (chunks + kMapThreads - 1) / kMapThreads;
  const int k0 = min(chunks, static_cast<int>(threadIdx.x) * per);
  const int k1 = min(chunks, k0 + per);
  float mj = -INFINITY, sj = 0.f, tj = 0.f;
  for (int k = k0; k < k1; ++k) {
    const float mk = __ldcg(part + 3 * k);
    const float sk = __ldcg(part + 3 * k + 1);
    const float tk = __ldcg(part + 3 * k + 2);
    if (k == k0) {
      mj = mk;
      sj = sk;
      tj = tk;
      continue;
    }
    const float m2 = fmaxf(mj, mk);
    const float fj = expf(mj - m2);
    const float fk = expf(mk - m2);
    tj = fj * (tj + sj * (mj - m2)) + fk * (tk + sk * (mk - m2));
    sj = sj * fj + sk * fk;
    mj = m2;
  }
  const float m = block_max(mj, sh.max);
  float sa = 0.f, sb = 0.f;
  if (k0 < k1) {
    const float d = mj - m;
    const float f = expf(d);
    sa = sj * f;
    sb = f * (tj + sj * d);
  }
  sh.a[threadIdx.x] = sa;
  sh.b[threadIdx.x] = sb;
  __syncthreads();
  if (threadIdx.x != 0) return;
  float s = 0.f, t = 0.f;
  for (int j = 0; j * per < chunks; ++j) {
    s += sh.a[j];
    t += sh.b[j];
  }
  const float log_s = logf(s);
  const float row_lse = m + log_s;
  const bool valid = action >= 0 && action < A;
  write_row_terms(i, row_lse, log_s - t / s, valid ? x_act - row_lse : 0.f, b, a, value, ret_i, pg,
                  vf, ent, kl, lse, lo, hi);
}

// Block (i, k) of the forward: chunk k of row i.  work holds the partials
// [B, chunks, 3] and then each row's action logit [B]; tickets[i] counts
// the row's finished chunks and is left at 0.
__global__ void __launch_bounds__(kMapThreads) surrogate_fwd_map_kernel(
    const float* __restrict__ logits, const int64_t* __restrict__ actions,
    const float* __restrict__ values, const float* __restrict__ blp,
    const float* __restrict__ adv, const float* __restrict__ ret, float* __restrict__ pg,
    float* __restrict__ vf, float* __restrict__ ent, float* __restrict__ kl,
    float* __restrict__ lse, float* __restrict__ work, unsigned* __restrict__ tickets, int A,
    float lo, float hi) {
  __shared__ float s_sum[2 * kMapWarps];
  __shared__ MergeScratch s_merge;
  __shared__ bool s_last;
  const int i = blockIdx.x;  // the row
  const int k = blockIdx.y;  // its chunk
  const int B = gridDim.x;
  const int chunks = gridDim.y;
  const int c0 = k * kFwdCols;
  const int cols = min(kFwdCols, A - c0);
  const float* row = logits + static_cast<size_t>(i) * A;
  // Thread 0 of the block whose chunk holds the action keeps that logit.
  const int64_t action = threadIdx.x == 0 ? actions[i] : -1;
  const bool holds_action = action >= c0 && action < c0 + cols;
  float x_act = 0.f;
  float m = -INFINITY, s = 0.f, t = 0.f;
  if ((reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    const int vecs = cols / 4;
    const float4* x4 = reinterpret_cast<const float4*>(row + c0);
    float4 x[kFwdVec];
#pragma unroll
    for (int u = 0; u < kFwdVec; ++u) {
      const int e = threadIdx.x + u * kMapThreads;
      x[u] = e < vecs ? x4[e] : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    }
    const int j = 4 * vecs + threadIdx.x;  // the last cols % 4 columns
    const float xt = j < cols ? row[c0 + j] : -INFINITY;
    if (holds_action) x_act = row[action];
#pragma unroll
    for (int u = 0; u < kFwdVec; ++u) {
      m = fmaxf(m, fmaxf(fmaxf(x[u].x, x[u].y), fmaxf(x[u].z, x[u].w)));
    }
    m = block_max(fmaxf(m, xt), s_merge.max);
#pragma unroll
    for (int u = 0; u < kFwdVec; ++u) {
      if (threadIdx.x + u * kMapThreads < vecs) {
        exp_sums(x[u].x, m, s, t);
        exp_sums(x[u].y, m, s, t);
        exp_sums(x[u].z, m, s, t);
        exp_sums(x[u].w, m, s, t);
      }
    }
    if (j < cols) exp_sums(xt, m, s, t);
  } else {
    float x[4 * kFwdVec];
#pragma unroll
    for (int u = 0; u < 4 * kFwdVec; ++u) {
      const int e = threadIdx.x + u * kMapThreads;
      x[u] = e < cols ? row[c0 + e] : -INFINITY;
      m = fmaxf(m, x[u]);
    }
    if (holds_action) x_act = row[action];
    m = block_max(m, s_merge.max);
#pragma unroll
    for (int u = 0; u < 4 * kFwdVec; ++u) {
      if (threadIdx.x + u * kMapThreads < cols) exp_sums(x[u], m, s, t);
    }
  }
  const float2 st = block_sum2(s, t, s_sum);
  float* act_logit = work + static_cast<size_t>(B) * chunks * 3 + i;
  if (threadIdx.x == 0) {
    float* part = work + (static_cast<size_t>(i) * chunks + k) * 3;
    part[0] = m;
    part[1] = st.x;
    part[2] = st.y;
    if (holds_action) *act_logit = x_act;
    // The last block of the row to finish merges; every block has taken its
    // ticket once the count reaches chunks, so the last resets it.
    __threadfence();
    s_last = atomicAdd(tickets + i, 1u) == static_cast<unsigned>(chunks - 1);
    if (s_last) tickets[i] = 0u;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  merge_row(i, A, chunks, work + static_cast<size_t>(i) * chunks * 3, act_logit, actions, values,
            blp, adv, ret, pg, vf, ent, kl, lse, lo, hi, s_merge);
}

__global__ void __launch_bounds__(kMapThreads) surrogate_bwd_map_kernel(
    const float* __restrict__ logits, const int64_t* __restrict__ actions,
    const float* __restrict__ values, const float* __restrict__ blp,
    const float* __restrict__ adv, const float* __restrict__ ret, const float* __restrict__ lse,
    const float* __restrict__ ent, const float* __restrict__ gpg, const float* __restrict__ gvf,
    const float* __restrict__ gent, const float* __restrict__ gkl, float* __restrict__ dlogits,
    float* __restrict__ dvalues, float* __restrict__ dblp, float* __restrict__ dadv,
    float* __restrict__ dret, int A, float lo, float hi) {
  const int i = blockIdx.x;
  const int c0 = blockIdx.y * kMapCols;
  const int cols = min(kMapCols, A - c0);
  const float* row = logits + static_cast<size_t>(i) * A;
  float* drow = dlogits + static_cast<size_t>(i) * A;
  const bool write = blockIdx.y == 0 && threadIdx.x == 0;
  if (((reinterpret_cast<uintptr_t>(row) | reinterpret_cast<uintptr_t>(drow)) & 15) == 0) {
    // Whole float4s of the block's columns; the loads go out before the
    // row's scalars are formed.
    const int vecs = cols / 4;
    const float4* x4 = reinterpret_cast<const float4*>(row + c0);
    float4 x[kMapVec];
#pragma unroll
    for (int u = 0; u < kMapVec; ++u) {
      const int e = threadIdx.x + u * kMapThreads;
      x[u] = e < vecs ? x4[e] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const RowCotangent rc = row_cotangent(i, row, A, lse[i], ent[i], actions, values, blp, adv,
                                          ret, gpg, gvf, gent, gkl, lo, hi, write, dvalues, dblp,
                                          dadv, dret);
    float4* d4 = reinterpret_cast<float4*>(drow + c0);
#pragma unroll
    for (int u = 0; u < kMapVec; ++u) {
      const int e = threadIdx.x + u * kMapThreads;
      if (e < vecs) {
        const int j = c0 + 4 * e;
        d4[e] = make_float4(dlogit(rc, x[u].x, j), dlogit(rc, x[u].y, j + 1),
                            dlogit(rc, x[u].z, j + 2), dlogit(rc, x[u].w, j + 3));
      }
    }
    const int j = c0 + 4 * vecs + threadIdx.x;  // the last cols % 4 columns
    if (j < c0 + cols) drow[j] = dlogit(rc, row[j], j);
  } else {
    float x[4 * kMapVec];
#pragma unroll
    for (int u = 0; u < 4 * kMapVec; ++u) {
      const int e = threadIdx.x + u * kMapThreads;
      x[u] = e < cols ? row[c0 + e] : 0.f;
    }
    const RowCotangent rc = row_cotangent(i, row, A, lse[i], ent[i], actions, values, blp, adv,
                                          ret, gpg, gvf, gent, gkl, lo, hi, write, dvalues, dblp,
                                          dadv, dret);
#pragma unroll
    for (int u = 0; u < 4 * kMapVec; ++u) {
      const int e = threadIdx.x + u * kMapThreads;
      if (e < cols) drow[c0 + e] = dlogit(rc, x[u], c0 + e);
    }
  }
}

}  // namespace

// Chunks of a row in the forward's work buffer at width A (0: the forward
// takes no work buffer); the buffer holds B * (3 * chunks + 1) floats.
extern "C" int ppo_surrogate_fwd_chunks(int A) { return fwd_chunks(A); }

// logits [B, A] float32, actions [B] int64, values, blp, adv, ret [B]
// float32; writes pg, vf, ent, kl and lse [B].  From A = kRowsMinA, work is
// B * (3 * chunks + 1) floats of scratch and tickets B zeroed unsigned ints,
// left zeroed; below it both may be null.
extern "C" int ppo_surrogate_fwd_launch(const void* logits, const void* actions,
                                        const void* values, const void* blp, const void* adv,
                                        const void* ret, void* pg, void* vf, void* ent, void* kl,
                                        void* lse, void* work, void* tickets, int B, int A,
                                        float lo, float hi, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* lg = static_cast<const float*>(logits);
  const auto* ac = static_cast<const int64_t*>(actions);
  const auto* va = static_cast<const float*>(values);
  const auto* bl = static_cast<const float*>(blp);
  const auto* ad = static_cast<const float*>(adv);
  const auto* re = static_cast<const float*>(ret);
  auto* o_pg = static_cast<float*>(pg);
  auto* o_vf = static_cast<float*>(vf);
  auto* o_ent = static_cast<float*>(ent);
  auto* o_kl = static_cast<float*>(kl);
  auto* o_lse = static_cast<float*>(lse);
  const int chunks = fwd_chunks(A);
  if (chunks > 0) {
    if (work == nullptr || tickets == nullptr || chunks > 65535) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    surrogate_fwd_map_kernel<<<dim3(B, chunks), kMapThreads, 0, st>>>(
        lg, ac, va, bl, ad, re, o_pg, o_vf, o_ent, o_kl, o_lse, static_cast<float*>(work),
        static_cast<unsigned*>(tickets), A, lo, hi);
  } else {
    surrogate_fwd_kernel<<<blocks_for(B), kThreads, 0, st>>>(lg, ac, va, bl, ad, re, o_pg, o_vf,
                                                             o_ent, o_kl, o_lse, B, A, lo, hi);
  }
  return static_cast<int>(cudaGetLastError());
}

// The forward's inputs, its saved lse and ent, and the cotangents of pg,
// vf, ent, kl [B]; writes d logits [B, A] and d values, d blp, d adv,
// d ret [B].
extern "C" int ppo_surrogate_bwd_launch(const void* logits, const void* actions,
                                        const void* values, const void* blp, const void* adv,
                                        const void* ret, const void* lse, const void* ent,
                                        const void* gpg, const void* gvf, const void* gent,
                                        const void* gkl, void* dlogits, void* dvalues, void* dblp,
                                        void* dadv, void* dret, int B, int A, float lo, float hi,
                                        void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* lg = static_cast<const float*>(logits);
  const auto* ac = static_cast<const int64_t*>(actions);
  const auto* va = static_cast<const float*>(values);
  const auto* bl = static_cast<const float*>(blp);
  const auto* ad = static_cast<const float*>(adv);
  const auto* re = static_cast<const float*>(ret);
  const auto* ls = static_cast<const float*>(lse);
  const auto* en = static_cast<const float*>(ent);
  const auto* g1 = static_cast<const float*>(gpg);
  const auto* g2 = static_cast<const float*>(gvf);
  const auto* g3 = static_cast<const float*>(gent);
  const auto* g4 = static_cast<const float*>(gkl);
  auto* d_lg = static_cast<float*>(dlogits);
  auto* d_v = static_cast<float*>(dvalues);
  auto* d_b = static_cast<float*>(dblp);
  auto* d_a = static_cast<float*>(dadv);
  auto* d_r = static_cast<float*>(dret);
  if (A >= kRowsMinA) {
    const dim3 grid(B, (A + kMapCols - 1) / kMapCols);
    surrogate_bwd_map_kernel<<<grid, kMapThreads, 0, st>>>(lg, ac, va, bl, ad, re, ls, en, g1, g2,
                                                           g3, g4, d_lg, d_v, d_b, d_a, d_r, A,
                                                           lo, hi);
  } else {
    surrogate_bwd_kernel<<<blocks_for(B), kThreads, 0, st>>>(
        lg, ac, va, bl, ad, re, ls, en, g1, g2, g3, g4, d_lg, d_v, d_b, d_a, d_r, B, A, lo, hi);
  }
  return static_cast<int>(cudaGetLastError());
}
