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
// The backward takes the cotangents of the four per-row terms and returns
// d logits [B, A] and d values, d blp, d adv, d ret [B].  It follows JAX's
// subgradient rule for min/max exactly: at a tie each argument gets half
// (the "balanced_eq" rule of _balanced in the TPU kernel).  This matters:
// inside the clip band ratio*adv and clip(ratio)*adv are the same number,
// so the min ties on most rows.
//
// Bound on the H100: memory.  Forward reads B*(A+5) floats-or-ints and
// writes 4*B floats; backward reads B*(A+9) and writes B*(A+4); the
// arithmetic is a few tens of flops and A+1 exps per row, far below the
// card's rate, so the least time is bytes / 3.35 TB/s.
//
// Design, two variants chosen by A:
//   * A < kRowsMinA (RL action spaces): one thread per row, two loops over A
//     kept in registers (max, then the exp sum and the entropy); the TPU
//     kernel's [A, 128] lane panels become one row per thread.  The [B]
//     vectors are read coalesced; a thread reads its A logits contiguously,
//     which for small A lands in the same or neighbouring cache lines as its
//     warp's neighbours.
//   * A >= kRowsMinA (a language model's vocabulary): one block of 1024
//     threads per row.  Neighbouring threads read neighbouring logits, so
//     every pass over the row is coalesced, and the max, the exp sum and
//     sum_j e_j (x_j - max) are tree-reduced (warp shuffles, then shared
//     memory) instead of summed serially by one thread.  The entropy comes
//     from the two sums, H = log s - t / s, and the backward's row sum of the
//     log-softmax cotangent from H (sum_j p_j (lp_j + 1) = 1 - H), so the
//     forward reads the row twice and the backward three times.
// Nothing is allocated; the kernels launch on the caller's stream.

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

__global__ void surrogate_fwd_kernel(const float* __restrict__ logits,
                                     const int64_t* __restrict__ actions,
                                     const float* __restrict__ values,
                                     const float* __restrict__ blp, const float* __restrict__ adv,
                                     const float* __restrict__ ret, float* __restrict__ pg,
                                     float* __restrict__ vf, float* __restrict__ ent,
                                     float* __restrict__ kl, int B, int A, float lo, float hi) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const float* row = logits + static_cast<size_t>(i) * A;
  const RowSoftmax sm = row_softmax(row, A, actions[i]);
  float entropy = 0.f;
  for (int j = 0; j < A; ++j) {
    const float lp = row[j] - sm.lse;
    entropy -= expf(lp) * lp;
  }
  const float b = blp[i];
  const float a = adv[i];
  const float ratio = expf(sm.logp - b);
  const float unclipped = ratio * a;
  const float clipped = fminf(fmaxf(ratio, lo), hi) * a;
  pg[i] = -fminf(unclipped, clipped);
  const float dv = values[i] - ret[i];
  vf[i] = dv * dv;
  ent[i] = entropy;
  kl[i] = b - sm.logp;
}

__global__ void surrogate_bwd_kernel(
    const float* __restrict__ logits, const int64_t* __restrict__ actions,
    const float* __restrict__ values, const float* __restrict__ blp,
    const float* __restrict__ adv, const float* __restrict__ ret, const float* __restrict__ gpg,
    const float* __restrict__ gvf, const float* __restrict__ gent,
    const float* __restrict__ gkl, float* __restrict__ dlogits, float* __restrict__ dvalues,
    float* __restrict__ dblp, float* __restrict__ dadv, float* __restrict__ dret, int B, int A,
    float lo, float hi) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const float* row = logits + static_cast<size_t>(i) * A;
  const int64_t action = actions[i];
  const RowSoftmax sm = row_softmax(row, A, action);
  const float a = adv[i];
  const float ratio = expf(sm.logp - blp[i]);
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
  const float g_ent = gent[i];
  const float g_kl = gkl[i];
  const float g_ratio = -g_pg * (du * a + dc * a * dcl);
  const float g_logp = g_ratio * ratio - g_kl;

  // Cotangent into lp_j: the action gather plus the entropy term
  // dH/dlp_j = -p_j (lp_j + 1); then the log-softmax VJP t - p * sum(t).
  float t_sum = 0.f;
  for (int j = 0; j < A; ++j) {
    const float lp = row[j] - sm.lse;
    const float p = expf(lp);
    const float t = (j == action ? g_logp : 0.f) - g_ent * p * (lp + 1.f);
    t_sum += t;
  }
  float* drow = dlogits + static_cast<size_t>(i) * A;
  for (int j = 0; j < A; ++j) {
    const float lp = row[j] - sm.lse;
    const float p = expf(lp);
    const float t = (j == action ? g_logp : 0.f) - g_ent * p * (lp + 1.f);
    drow[j] = t - p * t_sum;
  }
  const float dv = gvf[i] * 2.f * (values[i] - ret[i]);
  dvalues[i] = dv;
  dret[i] = -dv;
  dblp[i] = -g_ratio * ratio + g_kl;
  dadv[i] = -g_pg * (du * ratio + dc * rc);
}

constexpr int kThreads = 128;
constexpr int kRowThreads = 1024;
constexpr int kRowsMinA = 1024;

inline int blocks_for(int B) { return (B + kThreads - 1) / kThreads; }

// Block-wide reduction over kRowThreads threads; every thread gets the result.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  __syncthreads();  // scratch is free (an earlier reduction may still read it)
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  x = scratch[lane];  // kRowThreads / 32 == 32 partials
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  return x;
}

struct RowStats {
  float lse;  // logsumexp of the row
  float ent;  // entropy of its softmax
};

// Two coalesced passes over one row: the max, then s = sum_j e_j and
// t = sum_j e_j (x_j - max) with e_j = exp(x_j - max).
__device__ __forceinline__ RowStats block_row_stats(const float* __restrict__ row, int A,
                                                    float* scratch) {
  float m = -INFINITY;
  for (int j = threadIdx.x; j < A; j += kRowThreads) m = fmaxf(m, row[j]);
  m = block_reduce<true>(m, scratch);
  float s = 0.f, t = 0.f;
  for (int j = threadIdx.x; j < A; j += kRowThreads) {
    const float x = row[j] - m;
    const float e = expf(x);
    s += e;
    t = fmaf(e, x, t);
  }
  s = block_reduce<false>(s, scratch);
  t = block_reduce<false>(t, scratch);
  const float log_s = logf(s);
  RowStats out;
  out.lse = m + log_s;
  out.ent = log_s - t / s;
  return out;
}

__global__ void __launch_bounds__(kRowThreads) surrogate_fwd_rows_kernel(
    const float* __restrict__ logits, const int64_t* __restrict__ actions,
    const float* __restrict__ values, const float* __restrict__ blp,
    const float* __restrict__ adv, const float* __restrict__ ret, float* __restrict__ pg,
    float* __restrict__ vf, float* __restrict__ ent, float* __restrict__ kl, int A, float lo,
    float hi) {
  __shared__ float scratch[32];
  const int i = blockIdx.x;
  const float* row = logits + static_cast<size_t>(i) * A;
  const RowStats st = block_row_stats(row, A, scratch);
  if (threadIdx.x != 0) return;
  const int64_t action = actions[i];
  const bool valid = action >= 0 && action < A;
  const float logp = valid ? row[action] - st.lse : 0.f;
  const float b = blp[i];
  const float a = adv[i];
  const float ratio = expf(logp - b);
  pg[i] = -fminf(ratio * a, fminf(fmaxf(ratio, lo), hi) * a);
  const float dv = values[i] - ret[i];
  vf[i] = dv * dv;
  ent[i] = st.ent;
  kl[i] = b - logp;
}

__global__ void __launch_bounds__(kRowThreads) surrogate_bwd_rows_kernel(
    const float* __restrict__ logits, const int64_t* __restrict__ actions,
    const float* __restrict__ values, const float* __restrict__ blp,
    const float* __restrict__ adv, const float* __restrict__ ret, const float* __restrict__ gpg,
    const float* __restrict__ gvf, const float* __restrict__ gent,
    const float* __restrict__ gkl, float* __restrict__ dlogits, float* __restrict__ dvalues,
    float* __restrict__ dblp, float* __restrict__ dadv, float* __restrict__ dret, int A,
    float lo, float hi) {
  __shared__ float scratch[32];
  const int i = blockIdx.x;
  const float* row = logits + static_cast<size_t>(i) * A;
  const RowStats st = block_row_stats(row, A, scratch);
  const int64_t action = actions[i];
  const bool valid = action >= 0 && action < A;
  const float logp = valid ? row[action] - st.lse : 0.f;
  const float a = adv[i];
  const float ratio = expf(logp - blp[i]);
  const float mx = fmaxf(ratio, lo);
  const float rc = fminf(mx, hi);
  const float u = ratio * a;
  const float c = rc * a;
  const float mn = fminf(u, c);
  const float du = balanced(u, mn, c);
  const float dc = balanced(c, mn, u);
  const float dcl = balanced(ratio, mx, lo) * balanced(mx, rc, hi);
  const float g_pg = gpg[i];
  const float g_ent = gent[i];
  const float g_kl = gkl[i];
  const float g_ratio = -g_pg * (du * a + dc * a * dcl);
  const float g_logp = g_ratio * ratio - g_kl;
  // sum_j t_j with t_j = [j == action] g_logp - g_ent p_j (lp_j + 1).
  const float t_sum = (valid ? g_logp : 0.f) - g_ent * (1.f - st.ent);
  float* drow = dlogits + static_cast<size_t>(i) * A;
  for (int j = threadIdx.x; j < A; j += kRowThreads) {
    const float lp = row[j] - st.lse;
    const float p = expf(lp);
    const float t = (j == action ? g_logp : 0.f) - g_ent * p * (lp + 1.f);
    drow[j] = t - p * t_sum;
  }
  if (threadIdx.x != 0) return;
  const float dv = gvf[i] * 2.f * (values[i] - ret[i]);
  dvalues[i] = dv;
  dret[i] = -dv;
  dblp[i] = -g_ratio * ratio + g_kl;
  dadv[i] = -g_pg * (du * ratio + dc * rc);
}

}  // namespace

extern "C" int ppo_surrogate_fwd_launch(const void* logits, const void* actions,
                                        const void* values, const void* blp, const void* adv,
                                        const void* ret, void* pg, void* vf, void* ent, void* kl,
                                        int B, int A, float lo, float hi, void* stream) {
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
  if (A >= kRowsMinA) {
    surrogate_fwd_rows_kernel<<<B, kRowThreads, 0, st>>>(lg, ac, va, bl, ad, re, o_pg, o_vf,
                                                         o_ent, o_kl, A, lo, hi);
  } else {
    surrogate_fwd_kernel<<<blocks_for(B), kThreads, 0, st>>>(lg, ac, va, bl, ad, re, o_pg, o_vf,
                                                             o_ent, o_kl, B, A, lo, hi);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ppo_surrogate_bwd_launch(const void* logits, const void* actions,
                                        const void* values, const void* blp, const void* adv,
                                        const void* ret, const void* gpg, const void* gvf,
                                        const void* gent, const void* gkl, void* dlogits,
                                        void* dvalues, void* dblp, void* dadv, void* dret, int B,
                                        int A, float lo, float hi, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* lg = static_cast<const float*>(logits);
  const auto* ac = static_cast<const int64_t*>(actions);
  const auto* va = static_cast<const float*>(values);
  const auto* bl = static_cast<const float*>(blp);
  const auto* ad = static_cast<const float*>(adv);
  const auto* re = static_cast<const float*>(ret);
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
    surrogate_bwd_rows_kernel<<<B, kRowThreads, 0, st>>>(lg, ac, va, bl, ad, re, g1, g2, g3, g4,
                                                         d_lg, d_v, d_b, d_a, d_r, A, lo, hi);
  } else {
    surrogate_bwd_kernel<<<blocks_for(B), kThreads, 0, st>>>(lg, ac, va, bl, ad, re, g1, g2, g3,
                                                             g4, d_lg, d_v, d_b, d_a, d_r, B, A,
                                                             lo, hi);
  }
  return static_cast<int>(cudaGetLastError());
}
