// Grouped matrix product for Hopper (sm_90a), the MoE expert FFN: the port
// of the Pallas kernel repro/kernels/moe_gmm.py::moe_gmm_pallas (_gmm_kernel).
//
// float32: x [T, D] with its rows sorted into E expert-contiguous groups of
// group_sizes[e] rows (in expert order), w [E, D, F]; out [T, F] with
//     out[t] = x[t] @ w[e(t)],  e(t) the group that holds row t,
// accumulated in float32.  Rows past the last group are left as the caller
// set them; groups that run past row T are cut at T.  Needs D % 4 == 0, F % 4 == 0 and 16-byte aligned x, w and out
// (float4 loads and stores).
//
// Bound on the H100: operations.  2 * T * D * F flops against 4 * (T * D +
// E * D * F + T * F) bytes: at the LM path's [20480, 4096] x [16, 4096,
// 6400] that is 1.07 TFLOP and 0.99 GB, 1,080 flops per byte, far above the
// 20 at which 67 TFLOP/s of fp32 on the CUDA cores meets 3.35 TB/s; so the
// bound is flops / 67 TFLOP/s, 16.0 ms.  (The tensor cores would need TF32,
// which the port's 1e-4 tolerance for sums of thousands of products does
// not allow yet.)
//
// Design: a tiled SGEMM on the CUDA cores.  Each block of 256 threads
// computes one 128 x 128 output tile, each thread an 8 x 8 register tile
// (rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, likewise columns, so the
// float4 reads of the shared tiles are broadcasts or conflict-free), over
// K tiles of 8 staged in double-buffered shared memory: the next K tile is
// loaded into registers while the current one is multiplied, one barrier
// per K tile.  The grid enumerates (row tile within a group, column tile):
// the wrapper computes on the device the groups' row ends and the running
// count of row tiles per group (ceil(size / 128) each), and each block finds
// its own group from these, the counterpart of the TPU kernel's scalar
// prefetch of expert ids.  So no row tile straddles two experts whatever
// the group sizes; the ragged last tile of a group is masked.  The TPU
// kernel needs groups padded to its block size (the reference's _gmm_ok
// gate falls back to an einsum otherwise); this kernel takes any sizes.
// The grid's row dimension is an upper bound (ceil(T / 128) + E tiles), so
// the wrapper never waits for the device to learn the sizes; blocks past
// the last tile return at once.  Launches on the caller's stream and
// allocates nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;  // rows per tile
constexpr int kBN = 128;  // columns per tile
constexpr int kBK = 8;    // depth per staged K tile
constexpr int kThreads = 256;
constexpr int kAPad = 4;  // row padding of the transposed A tile: conflict-free stores

__global__ void __launch_bounds__(kThreads)
    moe_gmm_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const int* __restrict__ ends, const int* __restrict__ tile_ends,
                   float* __restrict__ out, int T, int D, int F, int E) {
  __shared__ __align__(16) float As[2][kBK][kBM + kAPad];  // A tile, transposed: [k][m]
  __shared__ __align__(16) float Bs[2][kBK][kBN];

  const int tile = blockIdx.x;
  int g = 0;
  while (g < E && tile >= tile_ends[g]) ++g;
  if (g == E) return;  // past the last row tile
  const int g_begin = g ? ends[g - 1] : 0;
  const int row0 = g_begin + (tile - (g ? tile_ends[g - 1] : 0)) * kBM;
  // Clamped to T as well: group sizes that sum past x's rows read and
  // write nothing beyond them.
  const int rows = min(min(kBM, ends[g] - row0), T - row0);
  if (rows <= 0) return;
  const int col0 = blockIdx.y * kBN;
  const float* wg = w + static_cast<size_t>(g) * D * F;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  // Global -> shared load assignment: A rows tid / 2, k tid % 2 * 4 .. +3;
  // B row tid / 32, columns tid % 32 * 4 .. +3.
  const int a_m = tid >> 1, a_k = (tid & 1) * 4;
  const int b_k = tid >> 5, b_n = (tid & 31) * 4;
  const bool a_row_ok = a_m < rows;
  const bool b_col_ok = col0 + b_n < F;
  const float* a_src = x + static_cast<size_t>(row0 + a_m) * D + a_k;
  const float* b_src = wg + static_cast<size_t>(b_k) * F + col0 + b_n;

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  auto load_a = [&](int k0) {
    return a_row_ok && k0 + a_k < D ? *reinterpret_cast<const float4*>(a_src + k0) : zero;
  };
  auto load_b = [&](int k0) {
    return b_col_ok && k0 + b_k < D
               ? *reinterpret_cast<const float4*>(b_src + static_cast<size_t>(k0) * F)
               : zero;
  };
  auto store = [&](int buf, float4 a, float4 b) {
    As[buf][a_k + 0][a_m] = a.x;
    As[buf][a_k + 1][a_m] = a.y;
    As[buf][a_k + 2][a_m] = a.z;
    As[buf][a_k + 3][a_m] = a.w;
    *reinterpret_cast<float4*>(&Bs[buf][b_k][b_n]) = b;
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  store(0, load_a(0), load_b(0));
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < D; k0 += kBK) {
    const bool more = k0 + kBK < D;
    float4 a_next = zero, b_next = zero;
    if (more) {
      a_next = load_a(k0 + kBK);
      b_next = load_b(k0 + kBK);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * b[j];
    }
    if (more) store(buf ^ 1, a_next, b_next);
    __syncthreads();  // the next tile is stored; every thread is done with this one
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
    if (m >= rows) continue;
    float* dst = out + static_cast<size_t>(row0 + m) * F + col0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = half * 64 + tx * 4;
      if (col0 + n < F) {
        *reinterpret_cast<float4*>(dst + n) =
            make_float4(acc[i][half * 4 + 0], acc[i][half * 4 + 1], acc[i][half * 4 + 2],
                        acc[i][half * 4 + 3]);
      }
    }
  }
}

}  // namespace

// out [T, F] = x [T, D] grouped by `ends` (the [E] running row ends) times
// w [E, D, F]; `tile_ends` [E] are the running counts of 128-row tiles per
// group.  Both int32 on the device.
extern "C" int moe_gmm_launch(const void* x, const void* w, const void* ends,
                              const void* tile_ends, void* out, int T, int D, int F, int E,
                              void* stream) {
  if (T < 0 || D < 1 || F < 1 || E < 1 || D % 4 || F % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((T + kBM - 1) / kBM + E, (F + kBN - 1) / kBN);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  moe_gmm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const int*>(ends),
      static_cast<const int*>(tile_ends), static_cast<float*>(out), T, D, F, E);
  return static_cast<int>(cudaGetLastError());
}
