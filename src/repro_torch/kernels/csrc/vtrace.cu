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
// learner's [32, 16] and [32, 512] both bounds are below 0.00015 ms, so what
// a call costs is its launch and its chain of dependent latencies.
//
// Design: GAE's (gae.cu).  One block of kThreads threads takes kPanel
// columns, a warp each, and stages kTileT rows of the panel at a time from
// the end, coalesced (a row of the panel is contiguous in [T, B]): one
// thread per element loads blp, tlp, r, v, d and v_{t+1} (the row after, or
// `last`) together and stores the scan's delta_t and decay a_t = disc_t * c_t
// beside the operands of pg_t (crho_t, disc_t, r_t, v_t), in the reference's
// order of operations, with the accurate expf.  The reverse scan
// acc_t = delta_t + a_t * acc_{t+1} then runs in shared memory, a warp per
// column (reverse_scan.cuh: each lane composes its piece of rows into an
// affine map, the maps are scanned across the warp in 5 shuffle steps, each
// lane walks its piece again), with no global round trip per step.  The
// write pass fuses the reference's second pass: vs_t = acc_t + v_t and
// pg_t from vs_{t+1}, both written coalesced.  Two carries cross from tile
// to tile, each column's acc and vs of the later tile's first row (`last`
// for the latest tile), the latter through s_next_vs.  The scan sums in
// another order than the reference (float32 rounding, within 1e-5); with
// c_clip > 1 a decay can exceed 1, which the composed maps carry as they
// are.
// kernels/vtrace_variants.py times it beside one thread per column walking
// the staged rows in the reference's order (variants/vtrace_serial_scan.cu)
// and the thread-per-column kernel this design replaced
// (variants/vtrace_thread_per_column.cu).  On an H100 (700 W, profiler ms,
// PERF.md): at the IMPALA paths' [32, 16] and [32, 512] the serial walk was
// 2-4 % faster (0.00182-0.00188 / 0.00193-0.00196 against 0.00190 /
// 0.00201), the warp 3 % faster at [64, 16], 6 % at [128, 16] and 14 % at
// [1000, 4]; by queued events the serial walk also led by 7 % at
// [128, 4096]; the old kernel read 0.00685 at [32, 16].  The warp order
// ships alone: at T = 32 the two sit within 0.0001 ms of each other and
// 0.001 ms of an empty kernel, while every longer narrow trace favours the
// warp, and GAE scans with the same function.
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

__global__ void __launch_bounds__(kThreads) vtrace_kernel(
    const float* __restrict__ blp, const float* __restrict__ tlp, const float* __restrict__ r,
    const float* __restrict__ v, const float* __restrict__ d, const float* __restrict__ last,
    float* __restrict__ vs, float* __restrict__ pg, int T, int B, float gamma, float rho_clip,
    float c_clip) {
  __shared__ float s_x[kTileT * kStride];  // delta, then acc
  __shared__ float s_a[kTileT * kStride];  // the decay disc * c
  __shared__ float s_crho[kTileT * kStride];
  __shared__ float s_disc[kTileT * kStride];
  __shared__ float s_r[kTileT * kStride];
  __shared__ float s_v[kTileT * kStride];
  __shared__ float s_next_vs[kPanel];  // vs of the row after the tile
  const int b0 = blockIdx.x * kPanel;
  const int P = min(kPanel, B - b0);
  const int tid = static_cast<int>(threadIdx.x);
  const int col = tid / 32;  // the column this thread's warp scans
  float carry = 0.f;
  float next_vs = col < P ? last[b0 + col] : 0.f;
  for (int t0 = ((T - 1) / kTileT) * kTileT; t0 >= 0; t0 -= kTileT) {
    const int rows = min(kTileT, T - t0);
    // Stage the tile, one thread per element, all six loads at once.
    for (int e = tid; e < rows * kPanel; e += kThreads) {
      const int row = e / kPanel;
      const int c = e % kPanel;
      if (c < P) {
        const int t = t0 + row;
        const size_t g = static_cast<size_t>(t) * B + b0 + c;
        const float rho = expf(tlp[g] - blp[g]);
        const float r_t = r[g];
        const float v_t = v[g];
        const float nv = t + 1 < T ? v[g + B] : last[b0 + c];
        const float disc = gamma * (1.f - d[g]);
        const float crho = fminf(rho_clip, rho);
        const int k = row * kStride + c;
        s_x[k] = crho * (r_t + disc * nv - v_t);
        s_a[k] = disc * fminf(c_clip, rho);
        s_crho[k] = crho;
        s_disc[k] = disc;
        s_r[k] = r_t;
        s_v[k] = v_t;
      }
    }
    __syncthreads();
    if (col < P) {
      if (tid % 32 == 0) s_next_vs[col] = next_vs;
      carry = reverse_scan_warp(s_x, s_a, rows, kStride, col, carry);
      next_vs = carry + s_v[col];  // vs of the tile's first row
    }
    __syncthreads();
    for (int e = tid; e < rows * kPanel; e += kThreads) {
      const int row = e / kPanel;
      const int c = e % kPanel;
      if (c < P) {
        const size_t g = static_cast<size_t>(t0 + row) * B + b0 + c;
        const int k = row * kStride + c;
        const float v_t = s_v[k];
        const float nvs = row + 1 < rows ? s_x[k + kStride] + s_v[k + kStride] : s_next_vs[c];
        vs[g] = s_x[k] + v_t;
        pg[g] = s_crho[k] * (s_r[k] + s_disc[k] * nvs - v_t);
      }
    }
    __syncthreads();  // the next tile overwrites the panel
  }
}

}  // namespace

extern "C" int vtrace_launch(const void* blp, const void* tlp, const void* r, const void* v,
                             const void* d, const void* last, void* vs, void* pg, int T, int B,
                             float gamma, float rho_clip, float c_clip, void* stream) {
  const int blocks = (B + kPanel - 1) / kPanel;
  vtrace_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(blp), static_cast<const float*>(tlp),
      static_cast<const float*>(r), static_cast<const float*>(v), static_cast<const float*>(d),
      static_cast<const float*>(last), static_cast<float*>(vs), static_cast<float*>(pg), T, B,
      gamma, rho_clip, c_clip);
  return static_cast<int>(cudaGetLastError());
}
