// GAE with csrc/gae.cu's staged panels but the serial scan order, built by
// kernels/gae_variants.py and timed there beside the shipped warp scan;
// never part of the port's library.  The staging and write-back are
// gae.cu's; the scan gives each column one thread, which walks the tile's
// rows in the reference's order, 8 rows' shared-memory loads issued ahead
// of their steps.  Same arguments as gae_launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPanel = kThreads / 32;  // columns a block, as gae.cu
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

__global__ void __launch_bounds__(kThreads) gae_serial_scan_kernel(
    const float* __restrict__ r, const float* __restrict__ v, const float* __restrict__ d,
    const float* __restrict__ last, float* __restrict__ adv, float* __restrict__ ret, int T,
    int B, float gamma, float gamma_lam) {
  __shared__ float s_x[kTileT * kStride];
  __shared__ float s_a[kTileT * kStride];
  __shared__ float s_v[kTileT * kStride];
  const int b0 = blockIdx.x * kPanel;
  const int P = min(kPanel, B - b0);
  const int tid = static_cast<int>(threadIdx.x);
  float carry = 0.f;
  for (int t0 = ((T - 1) / kTileT) * kTileT; t0 >= 0; t0 -= kTileT) {
    const int rows = min(kTileT, T - t0);
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
    if (tid < P) carry = reverse_scan_serial(s_x, s_a, rows, kStride, tid, carry);
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
    __syncthreads();
  }
}

}  // namespace

extern "C" int gae_serial_scan_launch(const void* r, const void* v, const void* d,
                                      const void* last, void* adv, void* ret, int T, int B,
                                      float gamma, float gamma_lam, void* stream) {
  const int blocks = (B + kPanel - 1) / kPanel;
  gae_serial_scan_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(v), static_cast<const float*>(d),
      static_cast<const float*>(last), static_cast<float*>(adv), static_cast<float*>(ret), T, B,
      gamma, gamma_lam);
  return static_cast<int>(cudaGetLastError());
}
