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
// the card's rate.  At the RL paths' [T <= 64, B <= 8] both bounds are
// below 0.00001 ms, so what a call costs is its launch and its chain of
// dependent latencies.
//
// Design: the TPU kernel's VMEM panel becomes a panel in shared memory.
// One block of kThreads threads takes kPanel columns and stages the panel
// at once, coalesced (a row of the panel is contiguous in [T, B]): one
// thread per element loads r_t, v_t, d_t and v_{t+1} together and stores
// delta_t, the decay a_t = gamma * lam * (1 - d_t) and v_t; the reverse scan
// acc_t = delta_t + a_t * acc_{t+1} runs in shared memory, with no global
// round trip per step; then adv_t and ret_t = adv_t + v_t go back
// coalesced.  A rollout longer than kTileT rows goes tile by tile from the
// end, the scan's carry crossing from tile to tile.
// The scan (reverse_scan.cuh) gives each column a warp: each lane composes
// its contiguous piece of rows into an affine map acc -> add + mul * acc, a
// reverse scan of the maps across the warp (5 shuffle steps) gives each
// lane its incoming carry, and each lane walks its piece again.  This sums
// in another order than the reference (float32 rounding, within 1e-5).
// kernels/gae_variants.py times it beside one thread per column walking the
// staged rows in the reference's order (variants/gae_serial_scan.cu) and the
// thread-per-column kernel this design replaced
// (variants/gae_thread_per_column.cu): on an H100 the warp order was 6-8 %
// faster than the serial one at CartPole's [64, 8], within 3 % at [32, 8]
// and [32, 4], 5-6 % slower at [128, 4096] and 17 % faster at [1000, 4]
// (PERF.md).
// Any T >= 1 and B >= 1; the last panel may be partial.  Nothing is
// allocated; the kernel launches on the caller's stream; sums run in a
// fixed order, so calls are bitwise repeatable.

#include <cuda_runtime.h>

#include "reverse_scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPanel = kThreads / 32;  // columns a block: a warp each
constexpr int kTileT = 128;            // rows staged at once
constexpr int kStride = kPanel + 1;    // padded panel row: a warp's pieces spread over banks

__global__ void __launch_bounds__(kThreads) gae_kernel(
    const float* __restrict__ r, const float* __restrict__ v, const float* __restrict__ d,
    const float* __restrict__ last, float* __restrict__ adv, float* __restrict__ ret, int T,
    int B, float gamma, float gamma_lam) {
  __shared__ float s_x[kTileT * kStride];  // delta, then adv
  __shared__ float s_a[kTileT * kStride];  // the decay
  __shared__ float s_v[kTileT * kStride];
  const int b0 = blockIdx.x * kPanel;
  const int P = min(kPanel, B - b0);
  const int tid = static_cast<int>(threadIdx.x);
  const int col = tid / 32;  // the column this thread's warp scans
  float carry = 0.f;
  for (int t0 = ((T - 1) / kTileT) * kTileT; t0 >= 0; t0 -= kTileT) {
    const int rows = min(kTileT, T - t0);
    // Stage the tile, one thread per element: delta and the decay from r,
    // v, d and the next value (the row after, or `last`), all loaded at once.
    for (int e = tid; e < rows * kPanel; e += kThreads) {
      const int row = e / kPanel;
      const int c = e % kPanel;
      if (c < P) {
        const int t = t0 + row;
        const size_t g = static_cast<size_t>(t) * B + b0 + c;
        const float v_t = v[g];
        const float nv = t + 1 < T ? v[g + B] : last[b0 + c];
        const float nd = 1.f - d[g];
        const int k = row * kStride + c;
        s_x[k] = r[g] + gamma * nd * nv - v_t;
        s_a[k] = gamma_lam * nd;
        s_v[k] = v_t;
      }
    }
    __syncthreads();
    if (col < P) carry = reverse_scan_warp(s_x, s_a, rows, kStride, col, carry);
    __syncthreads();
    for (int e = tid; e < rows * kPanel; e += kThreads) {
      const int row = e / kPanel;
      const int c = e % kPanel;
      if (c < P) {
        const size_t g = static_cast<size_t>(t0 + row) * B + b0 + c;
        const float x = s_x[row * kStride + c];
        adv[g] = x;
        ret[g] = x + s_v[row * kStride + c];
      }
    }
    __syncthreads();  // the next tile overwrites the panel
  }
}

}  // namespace

extern "C" int gae_launch(const void* r, const void* v, const void* d, const void* last,
                          void* adv, void* ret, int T, int B, float gamma, float gamma_lam,
                          void* stream) {
  const int blocks = (B + kPanel - 1) / kPanel;
  gae_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(v), static_cast<const float*>(d),
      static_cast<const float*>(last), static_cast<float*>(adv), static_cast<float*>(ret), T, B,
      gamma, gamma_lam);
  return static_cast<int>(cudaGetLastError());
}
