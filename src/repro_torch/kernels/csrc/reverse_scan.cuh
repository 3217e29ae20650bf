// The reverse linear recurrence over a panel staged in shared memory, the
// scan of the advantage kernels (gae.cu; V-trace's acc_t has the same form):
//     acc_t = x_t + a_t * acc_{t+1},   t = rows - 1 .. 0,   acc_rows = carry,
// down column c of a panel whose row t holds x_t and a_t at t * stride + c.
// It writes acc_t over x_t and returns acc_0, the carry into the rows
// before the panel.  It sums in a fixed order, so results are bitwise
// repeatable.

#pragma once

#include <cuda_runtime.h>

namespace {

// A whole warp walks the column (every lane calls this with the same
// arguments; every lane gets acc_0).  Lane L takes the contiguous piece of
// rows [L n, L n + n), n = ceil(rows / 32), and composes it into the affine
// map acc_{hi} -> add + mul * acc_{hi}; a reverse inclusive scan of the maps
// across the warp (5 shuffle steps, lane L taking lane L + o's map) leaves
// lane L with the map of rows [L n, rows), so lane L + 1's map applied to
// the carry is lane L's incoming acc; each lane then walks its piece again.
// The sums run in another order than the reference's (float32 rounding).
__device__ __forceinline__ float reverse_scan_warp(float* x, const float* a, int rows, int stride,
                                                   int c, float carry) {
  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int n = (rows + 31) / 32;
  const int lo = min(rows, lane * n);
  const int hi = min(rows, lo + n);
  float mul = 1.f, add = 0.f;
  for (int row = hi - 1; row >= lo; --row) {
    const float ak = a[row * stride + c];
    add = x[row * stride + c] + ak * add;
    mul = ak * mul;
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float mul2 = __shfl_down_sync(0xffffffffu, mul, o);
    const float add2 = __shfl_down_sync(0xffffffffu, add, o);
    if (lane + o < 32) {
      add = add + mul * add2;
      mul = mul * mul2;
    }
  }
  const float mul1 = __shfl_down_sync(0xffffffffu, mul, 1);
  const float add1 = __shfl_down_sync(0xffffffffu, add, 1);
  float acc = lane == 31 ? carry : add1 + mul1 * carry;
  for (int row = hi - 1; row >= lo; --row) {
    acc = x[row * stride + c] + a[row * stride + c] * acc;
    x[row * stride + c] = acc;
  }
  return __shfl_sync(0xffffffffu, acc, 0);
}

}  // namespace
