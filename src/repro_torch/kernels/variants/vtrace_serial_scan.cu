// V-trace with csrc/vtrace.cu's staged panels but the serial scan order,
// built by kernels/vtrace_variants.py and timed there beside the shipped
// warp scan; never part of the port's library.  The staging and the fused
// write pass are vtrace.cu's; the scan gives each column one thread, which
// walks the tile's rows in the reference's order, 8 rows' shared-memory
// loads issued ahead of their steps (variants/gae_serial_scan.cu's walk).
// Same arguments as vtrace_launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPanel = kThreads / 32;  // columns a block, as vtrace.cu
constexpr int kTileT = 128;
constexpr int kStride = kPanel + 1;

// acc_t = x_t + a_t * acc_{t+1} down column c, written over x_t; returns acc_0.
__device__ __forceinline__ float reverse_scan_serial(float* x, const float* a, int rows,
                                                     int stride, int c, float carry) {
  int row = rows - 1;
  for (; row >= 7; row -= 8) {
    float xs[8], as[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      xs[j] = x[(row - j) * stride + c];
      as[j] = a[(row - j) * stride + c];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      carry = xs[j] + as[j] * carry;
      x[(row - j) * stride + c] = carry;
    }
  }
  for (; row >= 0; --row) {
    carry = x[row * stride + c] + a[row * stride + c] * carry;
    x[row * stride + c] = carry;
  }
  return carry;
}

__global__ void __launch_bounds__(kThreads) vtrace_serial_scan_kernel(
    const float* __restrict__ blp, const float* __restrict__ tlp, const float* __restrict__ r,
    const float* __restrict__ v, const float* __restrict__ d, const float* __restrict__ last,
    float* __restrict__ vs, float* __restrict__ pg, int T, int B, float gamma, float rho_clip,
    float c_clip) {
  __shared__ float s_x[kTileT * kStride];
  __shared__ float s_a[kTileT * kStride];
  __shared__ float s_crho[kTileT * kStride];
  __shared__ float s_disc[kTileT * kStride];
  __shared__ float s_r[kTileT * kStride];
  __shared__ float s_v[kTileT * kStride];
  __shared__ float s_next_vs[kPanel];
  const int b0 = blockIdx.x * kPanel;
  const int P = min(kPanel, B - b0);
  const int tid = static_cast<int>(threadIdx.x);
  float carry = 0.f;
  float next_vs = tid < P ? last[b0 + tid] : 0.f;
  for (int t0 = ((T - 1) / kTileT) * kTileT; t0 >= 0; t0 -= kTileT) {
    const int rows = min(kTileT, T - t0);
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
    if (tid < P) {
      s_next_vs[tid] = next_vs;
      carry = reverse_scan_serial(s_x, s_a, rows, kStride, tid, carry);
      next_vs = carry + s_v[tid];
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
    __syncthreads();
  }
}

}  // namespace

extern "C" int vtrace_serial_scan_launch(const void* blp, const void* tlp, const void* r,
                                         const void* v, const void* d, const void* last,
                                         void* vs, void* pg, int T, int B, float gamma,
                                         float rho_clip, float c_clip, void* stream) {
  const int blocks = (B + kPanel - 1) / kPanel;
  vtrace_serial_scan_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(blp), static_cast<const float*>(tlp),
      static_cast<const float*>(r), static_cast<const float*>(v), static_cast<const float*>(d),
      static_cast<const float*>(last), static_cast<float*>(vs), static_cast<float*>(pg), T, B,
      gamma, rho_clip, c_clip);
  return static_cast<int>(cudaGetLastError());
}
