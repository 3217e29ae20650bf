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
// Design: one thread per row, two loops over A kept in registers (max, then
// the exp sum and the entropy); the TPU kernel's [A, 128] lane panels become
// one row per thread.  The [B] vectors are read coalesced; a thread reads
// its A logits contiguously, which for the small A of RL action spaces
// lands in the same or neighbouring cache lines as its warp's neighbours.
// Nothing is allocated; the kernels launch on the caller's stream.

#include <cuda_runtime.h>
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

inline int blocks_for(int B) { return (B + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int ppo_surrogate_fwd_launch(const void* logits, const void* actions,
                                        const void* values, const void* blp, const void* adv,
                                        const void* ret, void* pg, void* vf, void* ent, void* kl,
                                        int B, int A, float lo, float hi, void* stream) {
  surrogate_fwd_kernel<<<blocks_for(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const int64_t*>(actions),
      static_cast<const float*>(values), static_cast<const float*>(blp),
      static_cast<const float*>(adv), static_cast<const float*>(ret), static_cast<float*>(pg),
      static_cast<float*>(vf), static_cast<float*>(ent), static_cast<float*>(kl), B, A, lo, hi);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ppo_surrogate_bwd_launch(const void* logits, const void* actions,
                                        const void* values, const void* blp, const void* adv,
                                        const void* ret, const void* gpg, const void* gvf,
                                        const void* gent, const void* gkl, void* dlogits,
                                        void* dvalues, void* dblp, void* dadv, void* dret, int B,
                                        int A, float lo, float hi, void* stream) {
  surrogate_bwd_kernel<<<blocks_for(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const int64_t*>(actions),
      static_cast<const float*>(values), static_cast<const float*>(blp),
      static_cast<const float*>(adv), static_cast<const float*>(ret),
      static_cast<const float*>(gpg), static_cast<const float*>(gvf),
      static_cast<const float*>(gent), static_cast<const float*>(gkl),
      static_cast<float*>(dlogits), static_cast<float*>(dvalues), static_cast<float*>(dblp),
      static_cast<float*>(dadv), static_cast<float*>(dret), B, A, lo, hi);
  return static_cast<int>(cudaGetLastError());
}
