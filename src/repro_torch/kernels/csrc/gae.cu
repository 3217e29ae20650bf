// Fused GAE for Hopper (sm_90a): the port of the Pallas kernel
// repro/kernels/advantages.py::gae_pallas (_gae_kernel, _reverse_scan).
//
// Computes, over time-major float32 [T, B] rewards r, values v, dones d and
// a [B] bootstrap value `last`:
//     delta_t = r_t + gamma * (1 - d_t) * v_{t+1} - v_t      (v_T = last)
//     adv_t   = delta_t + gamma * lam * (1 - d_t) * adv_{t+1} (adv_T = 0)
//     ret_t   = adv_t + v_t
//
// Bound on the H100: memory.  The work is 3 reads and 2 writes of T*B floats
// plus B floats of `last`, about 8 flops per element, so the least time is
// bytes / 3.35 TB/s; the operation count is four orders of magnitude below
// the card's rate.
//
// Design: one thread per batch column, looping t = T-1 .. 0 with the
// running advantage and the next value in registers: the TPU kernel's
// sequential reverse scan over a VMEM panel becomes a loop inside the
// thread, and its grid over 128-lane batch panels becomes the thread grid.
// Row-major [T, B] makes the loads and stores of one time step contiguous
// across the threads of a warp, so every access is coalesced.  No padding:
// threads past B return, T >= 1 is any length.  Nothing is allocated; the
// kernel launches on the caller's stream.

#include <cuda_runtime.h>

namespace {

__global__ void gae_kernel(const float* __restrict__ r, const float* __restrict__ v,
                           const float* __restrict__ d, const float* __restrict__ last,
                           float* __restrict__ adv, float* __restrict__ ret, int T, int B,
                           float gamma, float gamma_lam) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float carry = 0.f;
  float next_v = last[b];
  for (int t = T - 1; t >= 0; --t) {
    const size_t i = static_cast<size_t>(t) * B + b;
    const float v_t = v[i];
    const float nd = 1.f - d[i];
    const float delta = r[i] + gamma * nd * next_v - v_t;
    carry = delta + gamma_lam * nd * carry;
    adv[i] = carry;
    ret[i] = carry + v_t;
    next_v = v_t;
  }
}

}  // namespace

extern "C" int gae_launch(const void* r, const void* v, const void* d, const void* last,
                          void* adv, void* ret, int T, int B, float gamma, float gamma_lam,
                          void* stream) {
  constexpr int kThreads = 128;
  const int blocks = (B + kThreads - 1) / kThreads;
  gae_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(v), static_cast<const float*>(d),
      static_cast<const float*>(last), static_cast<float*>(adv), static_cast<float*>(ret), T, B,
      gamma, gamma_lam);
  return static_cast<int>(cudaGetLastError());
}
