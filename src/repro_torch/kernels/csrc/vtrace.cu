// Fused V-trace for Hopper (sm_90a): the port of the Pallas kernel
// repro/kernels/advantages.py::vtrace_pallas (_vtrace_kernel, _reverse_scan).
//
// Computes, over time-major float32 [T, B] behaviour and target log-probs
// blp, tlp, rewards r, values v, dones d and a [B] bootstrap value `last`:
//     rho_t  = exp(tlp_t - blp_t)
//     crho_t = min(rho_clip, rho_t),  c_t = min(c_clip, rho_t)
//     disc_t = gamma * (1 - d_t)
//     acc_t  = crho_t * (r_t + disc_t * v_{t+1} - v_t) + disc_t * c_t * acc_{t+1}
//     vs_t   = acc_t + v_t                                (v_T = last, acc_T = 0)
//     pg_t   = crho_t * (r_t + disc_t * vs_{t+1} - v_t)   (vs_T = last)
//
// Bound on the H100: memory.  The work is 5 reads and 2 writes of T*B
// floats plus B floats of `last`, about 20 operations per element (one of
// them an exp), so the least time is bytes / 3.35 TB/s; the operation count
// is three orders of magnitude below the card's rate.  At the IMPALA
// learner's [32, 16] the kernel is bound by its launch, not by either.
//
// Design: one thread per batch column, looping t = T-1 .. 0 with the
// running acc = vs - v and the next vs in registers.  The reference's two
// passes (the reverse scan for vs, then pg_adv from next_vs) become one:
// pg_t needs only vs_{t+1}, which the loop carried from the step before.
// Row-major [T, B] makes the loads and stores of one time step contiguous
// across a warp, so every access is coalesced.  The operation order is the
// reference's, and exp is the accurate expf, so the result agrees with the
// plain loop to float32 rounding.  No padding: threads past B return, any
// T >= 1.  Nothing is allocated; the kernel launches on the caller's stream.

#include <cuda_runtime.h>

namespace {

__global__ void vtrace_kernel(const float* __restrict__ blp, const float* __restrict__ tlp,
                              const float* __restrict__ r, const float* __restrict__ v,
                              const float* __restrict__ d, const float* __restrict__ last,
                              float* __restrict__ vs, float* __restrict__ pg, int T, int B,
                              float gamma, float rho_clip, float c_clip) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float acc = 0.f;
  float next_v = last[b];
  float next_vs = next_v;
  for (int t = T - 1; t >= 0; --t) {
    const size_t i = static_cast<size_t>(t) * B + b;
    const float rho = expf(tlp[i] - blp[i]);
    const float crho = fminf(rho_clip, rho);
    const float c = fminf(c_clip, rho);
    const float disc = gamma * (1.f - d[i]);
    const float r_t = r[i];
    const float v_t = v[i];
    const float delta = crho * (r_t + disc * next_v - v_t);
    acc = delta + disc * c * acc;
    const float vs_t = acc + v_t;
    vs[i] = vs_t;
    pg[i] = crho * (r_t + disc * next_vs - v_t);
    next_v = v_t;
    next_vs = vs_t;
  }
}

}  // namespace

extern "C" int vtrace_launch(const void* blp, const void* tlp, const void* r, const void* v,
                             const void* d, const void* last, void* vs, void* pg, int T, int B,
                             float gamma, float rho_clip, float c_clip, void* stream) {
  constexpr int kThreads = 128;
  const int blocks = (B + kThreads - 1) / kThreads;
  vtrace_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(blp), static_cast<const float*>(tlp),
      static_cast<const float*>(r), static_cast<const float*>(v), static_cast<const float*>(d),
      static_cast<const float*>(last), static_cast<float*>(vs), static_cast<float*>(pg), T, B,
      gamma, rho_clip, c_clip);
  return static_cast<int>(cudaGetLastError());
}
