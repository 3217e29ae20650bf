// The GAE kernel that csrc/gae.cu's staged panels replaced, built by
// kernels/gae_variants.py and timed there beside it; never part of the
// port's library.  One thread per batch column walks t = T-1 .. 0 with the
// running advantage and the next value in registers, loading r, v and d
// from global memory at every step (coalesced across the warp's columns):
// at the RL paths' [T, 8] that is 8 threads on the card, each paying a
// load's latency T times in sequence.  Same arguments as gae_launch.

#include <cuda_runtime.h>

namespace {

__global__ void gae_thread_per_column_kernel(const float* __restrict__ r,
                                             const float* __restrict__ v,
                                             const float* __restrict__ d,
                                             const float* __restrict__ last,
                                             float* __restrict__ adv, float* __restrict__ ret,
                                             int T, int B, float gamma, float gamma_lam) {
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

extern "C" int gae_thread_per_column_launch(const void* r, const void* v, const void* d,
                                            const void* last, void* adv, void* ret, int T, int B,
                                            float gamma, float gamma_lam, void* stream) {
  constexpr int kThreads = 128;
  const int blocks = (B + kThreads - 1) / kThreads;
  gae_thread_per_column_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(v), static_cast<const float*>(d),
      static_cast<const float*>(last), static_cast<float*>(adv), static_cast<float*>(ret), T, B,
      gamma, gamma_lam);
  return static_cast<int>(cudaGetLastError());
}
