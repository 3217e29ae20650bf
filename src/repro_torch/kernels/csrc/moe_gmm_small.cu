// Grouped matrix product at small groups for Hopper (sm_90a): the port of
// the Pallas kernel repro/kernels/moe_gmm.py::moe_gmm_pallas (_gmm_kernel)
// in its small-block configuration.  repro/models/moe.py::_gmm_matmul
// passes block_m = B * C whenever B * C <= 128: at every MoE decode step
// (batch 2, capacity 1) each expert's group is 2 rows.  moe_gmm.cu's
// 128-row tiles are the port of the other configuration, block_m = 128.
//
// float32, x [T, D] with its rows sorted into E expert-contiguous groups,
// w [E, D, F]: out[t] = x[t] @ w[e(t)], e(t) the group that holds row t.
// `ends` [E] (int32, on the device) are the groups' running row ends cut at
// T, so groups that run past row T are cut there; rows past the last group
// come out zero; an empty group writes nothing.  Needs D % 4 == 0,
// F % 4 == 0 and 16-byte aligned tensors (16-byte loads).
//
// Bound on the H100: bytes.  A call reads x and w once and writes out,
// 4 * (T * D + E * D * F + T * F) bytes, against 2 * T * D * F flops, about
// one flop a byte at 2-row groups.  At DeepSeek-V2-Lite's decode step,
// [128, 2048] x [64, 2048, 1408], that is 0.740 GB, 0.2209 ms at 3.35 TB/s,
// against 0.011 ms of fp32 FMAs at 67 TFLOP/s; at Jamba's [32, 4096] x
// [16, 4096, 14336], 3.76 GB and 1.1225 ms against 0.056 ms.  The tensor
// cores buy nothing here: moe_gmm.cu splits a whole D x 128 slab of w_e
// into TF32 parts and runs 12 wgmma products for every 2 valid rows.
//
// Design: stream each w_e once, with the group's rows in registers.  A
// block of 8 warps owns one (expert, slab of 128 columns of F): lane l of
// every warp owns columns 4l..4l+3 of the slab, and warp j takes the depths
// four at a time, 4j, 4j + 32, ... (32 depths a block step), so a warp
// reads four whole 512-byte row segments of w a step, with 16-byte
// streaming loads (ld.global.cs: read once, evicted first, so that x stays
// in L2).  A lane keeps an R x 4 chunk of sums in registers and,
// each step, reads each row's four x values (one 16-byte load at the same
// address across the warp: x is the small operand, read from L1 and L2)
// and does 16 R fp32 FMAs: exact fp32, tighter than 3xTF32.  The 8 warps'
// sums are added through shared memory in a fixed tree (warp w + warp
// w + 4, then + 2, then + 1), and warp 0 writes the chunk.  A group of more
// rows than RMAX is taken in chunks of RMAX, each streaming w_e again; a
// chunk's R is the least power of two at or above the rows it holds, at most
// RMAX, the kernel's template argument, which the wrapper takes from the
// caller's block_m (kernels/moe_gmm.py::small_rows).  Each block finds its
// group's rows from `ends` on the device, so the launch never waits to
// learn the sizes, and a row block of E + 1 writes the zeros of the rows
// past the last group.  The decode steps' products give 512-1,792 blocks,
// 4-14 for each of 132 SMs, so D is not split.  Every sum runs in a fixed
// order, with no floating-point atomics, so two calls are bitwise equal.
// The kernel launches on the caller's stream and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 128;         // columns of F a block owns, 4 a lane
constexpr int kStep = 4 * kWarps;  // depths of w a block reads a step

__device__ __forceinline__ float4 load_w(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void fma4(float (&acc)[4], float x, const float4& w) {
  acc[0] = fmaf(x, w.x, acc[0]);
  acc[1] = fmaf(x, w.y, acc[1]);
  acc[2] = fmaf(x, w.z, acc[2]);
  acc[3] = fmaf(x, w.w, acc[3]);
}

// One chunk of `rows` <= R rows (x and o at the chunk's first row): o[r] =
// x[r] @ w in this block's columns.  `red`
// holds 4 x R x kCols floats.
template <int R>
__device__ void gmm_chunk(const float* __restrict__ x, int D, int rows,
                          const float* __restrict__ wg, int F, int col, bool col_ok,
                          float* __restrict__ o, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
  for (int d = 4 * warp; d < D; d += kStep) {
    float4 wv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wv[k] = col_ok ? load_w(wg + static_cast<size_t>(d + k) * F + col) : zero;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 xv = r < rows ? __ldg(reinterpret_cast<const float4*>(
                                       x + static_cast<size_t>(r) * D + d))
                                 : zero;
      fma4(acc[r], xv.x, wv[0]);
      fma4(acc[r], xv.y, wv[1]);
      fma4(acc[r], xv.z, wv[2]);
      fma4(acc[r], xv.w, wv[3]);
    }
  }
  // The warps' sums in a fixed tree: w += w + half, half = 4, 2, 1.
#pragma unroll
  for (int half = kWarps / 2; half >= 1; half /= 2) {
    if (warp >= half && warp < 2 * half) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        *reinterpret_cast<float4*>(red + ((warp - half) * R + r) * kCols + 4 * lane) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
    __syncthreads();
    if (warp < half) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 v =
            *reinterpret_cast<const float4*>(red + (warp * R + r) * kCols + 4 * lane);
        acc[r][0] += v.x;
        acc[r][1] += v.y;
        acc[r][2] += v.z;
        acc[r][3] += v.w;
      }
    }
    __syncthreads();
  }
  if (warp == 0 && col_ok) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < rows)
        *reinterpret_cast<float4*>(o + static_cast<size_t>(r) * F + col) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

// gmm_chunk at the least power of two R >= rows, R <= RMAX.
template <int R, int RMAX>
__device__ void gmm_chunk_at(const float* x, int D, int rows, const float* wg, int F, int col,
                             bool col_ok, float* o, float* red) {
  if constexpr (R > 1) {
    if (rows <= R / 2) {
      gmm_chunk_at<R / 2, RMAX>(x, D, rows, wg, F, col, col_ok, o, red);
      return;
    }
  }
  gmm_chunk<R>(x, D, rows, wg, F, col, col_ok, o, red);
}

// Block (column slab, group); group E (the last row of blocks) writes the
// zeros of the rows past the last group.  A thread holds RMAX x 4 sums, a
// step's 16 w values and the rows' x values: within 64 registers (4 blocks
// an SM) at RMAX 2, 85 at 4 and 8, 128 at 16.
template <int RMAX>
__global__ void __launch_bounds__(kThreads, RMAX <= 2 ? 4 : RMAX <= 8 ? 3 : 2)
    gmm_small_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const int* __restrict__ ends, float* __restrict__ out, int T, int D, int F,
                     int E) {
  __shared__ __align__(16) float red[4 * RMAX * kCols];
  const int col = blockIdx.x * kCols + 4 * (threadIdx.x % 32);
  const bool col_ok = col < F;
  const int e = blockIdx.y;
  if (e == E) {  // the zeros of rows [ends[E - 1], T)
    if (col_ok)
      for (int r = ends[E - 1] + threadIdx.x / 32; r < T; r += kWarps)
        *reinterpret_cast<float4*>(out + static_cast<size_t>(r) * F + col) =
            make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const int begin = e ? ends[e - 1] : 0, end = ends[e];
  const float* wg = w + static_cast<size_t>(e) * D * F;
  for (int r0 = begin; r0 < end; r0 += RMAX)
    gmm_chunk_at<RMAX, RMAX>(x + static_cast<size_t>(r0) * D, D, min(RMAX, end - r0), wg, F, col,
                             col_ok, out + static_cast<size_t>(r0) * F, red);
}

template <int RMAX>
cudaError_t launch(const float* x, const float* w, const int* ends, float* out, int T, int D,
                   int F, int E, cudaStream_t stream) {
  const dim3 grid((F + kCols - 1) / kCols, E + 1);
  gmm_small_kernel<RMAX><<<grid, kThreads, 0, stream>>>(x, w, ends, out, T, D, F, E);
  return cudaGetLastError();
}

}  // namespace

// out [T, F] = x [T, D] grouped by `ends` times w [E, D, F]: `ends` [E] are
// the groups' running row ends cut at T (int32, on the device); `rmax`
// (1, 2, 4, 8 or 16) the most rows a chunk holds.
extern "C" int moe_gmm_small_launch(const void* x, const void* w, const void* ends, void* out,
                                    int T, int D, int F, int E, int rmax, void* stream) {
  if (T < 0 || D < 1 || F < 1 || E < 1 || D % 4 || F % 4 || E > 65534)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(w);
  const auto* ei = static_cast<const int*>(ends);
  float* of = static_cast<float*>(out);
  switch (rmax) {
    case 1: return static_cast<int>(launch<1>(xf, wf, ei, of, T, D, F, E, s));
    case 2: return static_cast<int>(launch<2>(xf, wf, ei, of, T, D, F, E, s));
    case 4: return static_cast<int>(launch<4>(xf, wf, ei, of, T, D, F, E, s));
    case 8: return static_cast<int>(launch<8>(xf, wf, ei, of, T, D, F, E, s));
    case 16: return static_cast<int>(launch<16>(xf, wf, ei, of, T, D, F, E, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
