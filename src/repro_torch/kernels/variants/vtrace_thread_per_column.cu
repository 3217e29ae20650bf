// The V-trace kernel that csrc/vtrace.cu's staged panels replaced, built by
// kernels/vtrace_variants.py and timed there beside it; never part of the
// port's library.  One thread per batch column walks t = T-1 .. 0 with the
// running acc = vs - v and the next vs in registers, loading blp, tlp, r, v
// and d from global memory at every step (coalesced across the warp's
// columns), so a call pays about T dependent global-load latencies.  The
// reference's two passes are one: pg_t needs only vs_{t+1}, which the loop
// carried from the step before.  Same arguments as vtrace_launch.

#include <cuda_runtime.h>

namespace {

__global__ void vtrace_thread_per_column_kernel(
    const float* __restrict__ blp, const float* __restrict__ tlp, const float* __restrict__ r,
    const float* __restrict__ v, const float* __restrict__ d, const float* __restrict__ last,
    float* __restrict__ vs, float* __restrict__ pg, int T, int B, float gamma, float rho_clip,
    float c_clip) {
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

extern "C" int vtrace_thread_per_column_launch(const void* blp, const void* tlp, const void* r,
                                               const void* v, const void* d, const void* last,
                                               void* vs, void* pg, int T, int B, float gamma,
                                               float rho_clip, float c_clip, void* stream) {
  constexpr int kThreads = 128;
  const int blocks = (B + kThreads - 1) / kThreads;
  vtrace_thread_per_column_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(blp), static_cast<const float*>(tlp),
      static_cast<const float*>(r), static_cast<const float*>(v), static_cast<const float*>(d),
      static_cast<const float*>(last), static_cast<float*>(vs), static_cast<float*>(pg), T, B,
      gamma, rho_clip, c_clip);
  return static_cast<int>(cudaGetLastError());
}
