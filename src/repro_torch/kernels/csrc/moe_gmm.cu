// Grouped matrix products for Hopper (sm_90a), the MoE expert FFN, on the
// tensor cores in 3xTF32 with wgmma: the port of the Pallas kernel
// repro/kernels/moe_gmm.py::moe_gmm_pallas (_gmm_kernel), plus the two
// products of its backward, which the reference leaves to einsums
// (repro/models/moe.py::_gmm_matmul_bwd).
//
// float32, x [T, D] with its rows sorted into E expert-contiguous groups of
// group_sizes[e] rows (in expert order), w [E, D, F], e(t) the group that
// holds row t:
//   forward  out [T, F]:    out[t] = x[t] @ w[e(t)];
//   dX       dx [T, D]:     dx[t] = dy[t] @ w[e(t)]^T, from dy [T, F];
//   dW       dw [E, D, F]:  dw[e] = sum over the rows t of group e of
//                                   x[t]^T dy[t] (zeros for an empty group).
// Groups that run past row T are cut at T; the forward and dX write zeros
// in the rows past the last group.  Needs D % 4 == 0, F % 4 == 0 and
// 16-byte aligned tensors (16-byte cp.async copies).
//
// Precision: 3xTF32, as flash_attention.cu.  Every operand x is split into
// big = x rounded to TF32 and small = x - big, and small*big + big*small +
// big*big is accumulated in fp32 on the tensor cores: only small*small and
// small's truncation (about 2^-21 relative) are lost, against one TF32
// pass's ~2^-11, which misses the port's 1e-4 for sums of 4,096 to 6,400
// products (tests/test_torch_moe.py emulates both).  The tensor cores add
// into their accumulator with truncation, so one accumulator kept over a
// whole contraction drifts past 1e-4 at the path's shapes
// (moe_gmm_variants.py's one_accumulator): each K tile of 32 is summed from
// zero and added into an fp32 running sum.
//
// Bound on the H100: operations.  2 * T * D * F flops against 4 * (T * D +
// E * D * F + T * F) bytes: at the LM path's [20480, 4096] x [16, 4096,
// 6400] that is 1.07 TFLOP and 2.54 GB, 423 flops per byte, above the 148
// at which 3 x 1.07 TFLOP of TF32 at 495 TFLOP/s meets 3.35 TB/s; so the
// bound is 3 * flops / 495 TFLOP/s, 6.51 ms (fp32 on the CUDA cores: flops /
// 67 TFLOP/s, 16.0 ms).  The same holds for dX and dW, which do the same
// flops.
//
// Design: one main loop for all three products.  A block of two warpgroups
// computes a 128 x 128 output tile, each warpgroup 64 rows of it with
// wgmma.m64n128k8 TF32 (A from registers, B from shared memory), over K
// tiles of 32 staged by 16-byte cp.async in a ring of 4 shared-memory
// stages.  For each K tile the block splits B once into a big and a small
// K-major tile of 8 x 16-byte core matrices (no swizzle), and each lane
// splits its own A fragments in registers; then each warpgroup runs the
// tile's 12 products from zero into a partial sum, waits for them and adds
// the partial into its running sum.  Staged tiles are laid out as their
// source, K-major ([rows][32 + 4]) where the contraction is contiguous in
// device memory (x and dy in the forward and dX, w in dX) and MN-major
// ([32][cols + 8]) where the rows or columns are (w in the forward, x and
// dy in dW), so that every A fragment load of a warp hits 32 distinct banks.
// What the H100 showed (PERF.md): with mma.sync m16n8k8 in place of wgmma,
// the MMAs alone took 13.5 ms of that design's 16.5 at the path shape;
// these products run at about 58 % of 495 TFLOP/s even with no split at
// all (moe_gmm_variants.py's products_only); preparing the next tile under
// the current one's products needs 64 more live accumulators, and at
// 244-255 registers it saved 2-5 %, so the loop stays serial.
//   * Forward and dX: a block finds its (group, column tile, row tile) from
//     the groups' row ends and running counts of 128-row tiles, computed by
//     the wrapper on the device (the counterpart of the TPU kernel's scalar
//     prefetch of expert ids), so the launch never waits to learn the sizes
//     and no row tile straddles two experts.  Row tiles are the fastest
//     index, then column tiles, then groups: the blocks on the card at once
//     share one expert's rows (21 MB at the path shape) in L2 while its
//     weights stream through once.  The TPU kernel needs groups padded to its
//     block size (the reference's _gmm_ok gate falls back to an einsum
//     otherwise); this one takes any sizes.  The grid is an upper bound,
//     ceil(T / 128) + E row tiles per column tile; the blocks past the last
//     group's tiles write the zeros of the rows past it and return.
//   * dW: one block per (row tile of D, column tile of F, expert) sums its
//     group's rows in K tiles of 32; no atomics, so every element is summed
//     in a fixed order and dW is the same from run to run.
// Each kernel launches on the caller's stream and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;  // rows of an output tile
constexpr int kBN = 128;  // columns of an output tile
constexpr int kBK = 32;   // depth of a staged K tile
constexpr int kStages = 4;
constexpr int kThreads = 256;  // two warpgroups, 64 rows each
constexpr int kSteps = kBK / 8;  // wgmma k-steps of a K tile
constexpr int kSplitFloats = kBN * kBK;  // a split B tile

// An operand tile of kRows (m or n) x kBK (k) in shared memory, K-major
// ([kRows][kBK + 4]) or MN-major ([kBK][kRows + 8]).
template <bool KMajor, int kRows>
struct Tile {
  static constexpr int kLd = KMajor ? kBK + 4 : kRows + 8;
  static constexpr int kFloats = KMajor ? kRows * kLd : kBK * kLd;
  __device__ static int at(int r, int k) { return KMajor ? r * kLd + k : k * kLd + r; }
};

// The ring of staged A and B tiles, then B's split big and small tiles.
template <bool AK, bool BK>
constexpr size_t smem_bytes() {
  return (static_cast<size_t>(kStages) * (Tile<AK, kBM>::kFloats + Tile<BK, kBN>::kFloats) +
          2 * kSplitFloats) * sizeof(float);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = big + small, as flash_attention.cu's split: big is x rounded to TF32
// (to nearest, ties away from zero) in two integer operations, small = x -
// big, which the tensor cores read truncated to TF32.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// d (+)= a b for a warpgroup: a its 64 rows x 8 k, each warp's 16 rows in
// registers in mma.m16n8k8's A fragment layout; b [128 n][8 k] K-major in
// shared memory, described by `desc`; scale_d 0 overwrites d.  Lane (g, t)
// of warp q holds rows 16 q + g (+ 8), columns 8 j + 2 t (+ 1) of d in
// d[4 j .. 4 j + 3].
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %69, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(desc));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Shared-memory stores made visible to wgmma's reads (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Pins a register that wgmma reads or writes asynchronously: the compiler
// may not move or reuse it across this point.
__device__ __forceinline__ void keep(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void keep(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// Descriptor of a K-major shared tile without swizzle: 8-row x 16-byte core
// matrices, `lbo` bytes apart along K and `sbo` bytes apart along the rows.
__device__ __forceinline__ uint64_t smem_desc(const float* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// Element (n, k) of a split [128 n][32 k] tile: core matrices of 8 n x 4 k,
// the 16 along n 128 bytes apart, the 8 along k 2,048 bytes apart.
__device__ __forceinline__ int split_at(int n, int k) {
  return ((k >> 2) * 16 + (n >> 3)) * 32 + (n & 7) * 4 + (k & 3);
}

// Rows [0, R) x columns [0, C) of a row-major source (row stride `ld`
// floats) into a shared tile of row stride LD: 16-byte copies, zeros at or
// past `rows` rows or `cols` columns (`cols` a multiple of 4).  `base` is a
// valid address for the copies that read nothing.
template <int R, int C, int LD>
__device__ __forceinline__ void load_block(float* dst, const float* src, size_t ld, int rows,
                                           int cols, const float* base) {
  constexpr int kC4 = C / 4;
  static_assert((R * kC4) % kThreads == 0, "whole copies per thread");
#pragma unroll
  for (int i = 0; i < R * kC4 / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kC4;
    const int c = (idx % kC4) * 4;
    const bool in = r < rows && c < cols;
    cp_async16(dst + r * LD + c, in ? src + r * ld + c : base, in);
  }
}

// K tile `kt` of an operand into its shared tile.  `src` is the operand's
// element (0, 0): (r, k) lies at src[r * ld + k] when K-major, src[k * ld +
// r] when MN-major; `rows` of its kRows and `depth` of the contraction are
// real.
template <bool KMajor, int kRows>
__device__ __forceinline__ void load_operand(float* dst, const float* src, size_t ld, int rows,
                                             int depth, int kt, const float* base) {
  using T = Tile<KMajor, kRows>;
  const int k0 = kt * kBK;
  if constexpr (KMajor) {
    load_block<kRows, kBK, T::kLd>(dst, src + k0, ld, rows, depth - k0, base);
  } else {
    load_block<kBK, kRows, T::kLd>(dst, src + static_cast<size_t>(k0) * ld, ld, depth - k0, rows,
                                   base);
  }
}

// Elements (r, k .. k + 3) of a staged tile (k a multiple of 4).
template <bool KMajor, int kRows>
__device__ __forceinline__ float4 read4(const float* tile, int r, int k) {
  using T = Tile<KMajor, kRows>;
  if constexpr (KMajor) {
    return *reinterpret_cast<const float4*>(tile + T::at(r, k));
  } else {
    return make_float4(tile[T::at(r, k)], tile[T::at(r, k + 1)], tile[T::at(r, k + 2)],
                       tile[T::at(r, k + 3)]);
  }
}

// acc += A B over the contraction [0, depth) for the block's 128 x 128
// tile, in wgmma_tf32's layout for the lane's warpgroup (rows 64 w ..
// 64 w + 63).  A's row m is the tile's row, B's row n its column (see
// load_operand); `a_rows` / `b_rows` of them are real, the rest read zeros.
template <bool AK, bool BK>
__device__ __forceinline__ void gemm_tile(float (&acc)[64], float* smem, const float* a,
                                          size_t lda, int a_rows, const float* b, size_t ldb,
                                          int b_rows, int depth, const float* a_base,
                                          const float* b_base) {
  using TA = Tile<AK, kBM>;
  using TB = Tile<BK, kBN>;
  constexpr int kStageFloats = TA::kFloats + TB::kFloats;
  float* b_big = smem + kStages * kStageFloats;
  float* b_small = b_big + kSplitFloats;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row = threadIdx.x / 32 * 16 + g;  // warpgroup w's warp q: 64 w + 16 q
  const int ktiles = (depth + kBK - 1) / kBK;

  auto load = [&](int kt) {
    float* stage = smem + (kt % kStages) * kStageFloats;
    load_operand<AK, kBM>(stage, a, lda, a_rows, depth, kt, a_base);
    load_operand<BK, kBN>(stage + TA::kFloats, b, ldb, b_rows, depth, kt, b_base);
  };

#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt has landed; tile kt - 1's products are done
    if (kt + kStages - 1 < ktiles) load(kt + kStages - 1);
    cp_async_commit();
    const float* As = smem + (kt % kStages) * kStageFloats;
    const float* Bs = As + TA::kFloats;
    // B split into its big and small tiles: each thread runs of (n, 4 k),
    // one 16-byte store per part.
#pragma unroll
    for (int i = 0; i < kBN * kBK / 4 / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int n = idx % kBN, k = idx / kBN * 4;
      const float4 v = read4<BK, kBN>(Bs, n, k);
      uint4 bg, sm;
      split(v.x, bg.x, sm.x);
      split(v.y, bg.y, sm.y);
      split(v.z, bg.z, sm.z);
      split(v.w, bg.w, sm.w);
      *reinterpret_cast<uint4*>(b_big + split_at(n, k)) = bg;
      *reinterpret_cast<uint4*>(b_small + split_at(n, k)) = sm;
    }
    uint32_t ab[kSteps][4], as[kSteps][4];
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        split(As[TA::at(row + 8 * (c & 1), 8 * s + t + 4 * (c >> 1))], ab[s][c], as[s][c]);
    fence_proxy_async();
    __syncthreads();  // B's split tiles are written
    float part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) keep(part[i]);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      // k-step s: the split tiles' core matrices 2 s and 2 s + 1 along k.
      const uint64_t big = smem_desc(b_big + s * 2 * 16 * 32, 16 * 128, 128);
      const uint64_t small = smem_desc(b_small + s * 2 * 16 * 32, 16 * 128, 128);
      wgmma_tf32(part, as[s], big, s);
      wgmma_tf32(part, ab[s], small, 1);
      wgmma_tf32(part, ab[s], big, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < 64; ++i) keep(part[i]);
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        keep(ab[s][c]);
        keep(as[s][c]);
      }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }
  cp_async_wait<0>();
}

// The block's tile of acc into out (row stride ldo), `rows` x `cols` of it.
__device__ __forceinline__ void store_tile(const float (&acc)[64], float* out, size_t ldo,
                                           int rows, int cols) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = threadIdx.x / 32 * 16 + g + 8 * h;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * t;
      if (c < cols)
        *reinterpret_cast<float2*>(out + r * ldo + c) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// Forward (B_KMAJOR false: b = w [E, K, N]) and dX (true: b = w [E, N, K],
// read transposed): out [T, N] = a [T, K] grouped by `ends` times b[e].
// `ends` [E] are the groups' running row ends cut at T, `tile_ends` [E] the
// running counts of 128-row tiles of those cut groups.
template <bool B_KMAJOR>
__global__ void __launch_bounds__(kThreads, 1)
    gmm_rows_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const int* __restrict__ ends, const int* __restrict__ tile_ends,
                    float* __restrict__ out, int T, int K, int N, int E) {
  extern __shared__ __align__(16) float smem[];
  const int nc = (N + kBN - 1) / kBN;
  const int used = tile_ends[E - 1] * nc;
  const int tile = blockIdx.x;
  if (tile >= used) {  // the zeros of rows [ends[E - 1], T)
    const int row0 = ends[E - 1] + (tile - used) / nc * kBM;
    const int col0 = (tile - used) % nc * kBN;
    const int rows = min(kBM, T - row0), cols = min(kBN, N - col0);
    for (int idx = threadIdx.x; idx < kBM * kBN / 4; idx += kThreads) {
      const int r = idx / (kBN / 4), c = idx % (kBN / 4) * 4;
      if (r < rows && c < cols)
        *reinterpret_cast<float4*>(out + static_cast<size_t>(row0 + r) * N + col0 + c) =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  int g = 0;
  while (tile >= tile_ends[g] * nc) ++g;
  const int t_begin = g ? tile_ends[g - 1] : 0;
  const int row_tiles = tile_ends[g] - t_begin;
  const int local = tile - t_begin * nc;
  const int col0 = local / row_tiles * kBN;
  const int row0 = (g ? ends[g - 1] : 0) + local % row_tiles * kBM;
  const int rows = min(kBM, ends[g] - row0);
  const float* bg = b + static_cast<size_t>(g) * K * N;
  float acc[64];
  if constexpr (B_KMAJOR) {
    gemm_tile<true, true>(acc, smem, a + static_cast<size_t>(row0) * K, K, rows,
                          bg + static_cast<size_t>(col0) * K, K, N - col0, K, a, b);
  } else {
    gemm_tile<true, false>(acc, smem, a + static_cast<size_t>(row0) * K, K, rows, bg + col0, N,
                           N - col0, K, a, b);
  }
  store_tile(acc, out + static_cast<size_t>(row0) * N + col0, N, rows, N - col0);
}

// dW: dw [E, K, N], dw[e] = x_e^T dy_e over group e's rows of x [T, K] and
// dy [T, N]; `ends` as gmm_rows_kernel's.  Block (m tile + mc * n tile, e).
__global__ void __launch_bounds__(kThreads, 1)
    gmm_dw_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                  const int* __restrict__ ends, float* __restrict__ dw, int K, int N) {
  extern __shared__ __align__(16) float smem[];
  const int mc = (K + kBM - 1) / kBM;
  const int m0 = blockIdx.x % mc * kBM;
  const int n0 = blockIdx.x / mc * kBN;
  const int e = blockIdx.y;
  const int begin = e ? ends[e - 1] : 0;
  float acc[64];
  gemm_tile<false, false>(acc, smem, x + static_cast<size_t>(begin) * K + m0, K, K - m0,
                          dy + static_cast<size_t>(begin) * N + n0, N, N - n0, ends[e] - begin,
                          x, dy);
  store_tile(acc, dw + (static_cast<size_t>(e) * K + m0) * N + n0, N, K - m0, N - n0);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

bool bad_shape(int T, int D, int F, int E) {
  return T < 0 || D < 1 || F < 1 || E < 1 || D % 4 || F % 4;
}

template <bool B_KMAJOR>
int launch_rows(const void* a, const void* w, const void* ends, const void* tile_ends, void* out,
                int T, int K, int N, int E, void* stream) {
  if (T == 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks =
      (static_cast<int64_t>(T + kBM - 1) / kBM + E) * ((N + kBN - 1) / kBN);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t bytes = smem_bytes<true, B_KMAJOR>();
  cudaError_t err = allow_smem(gmm_rows_kernel<B_KMAJOR>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  gmm_rows_kernel<B_KMAJOR><<<static_cast<unsigned>(blocks), kThreads, bytes,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(w), static_cast<const int*>(ends),
      static_cast<const int*>(tile_ends), static_cast<float*>(out), T, K, N, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out [T, F] = x [T, D] grouped by `ends` times w [E, D, F]: `ends` [E] are
// the groups' running row ends cut at T, `tile_ends` [E] the running counts
// of 128-row tiles of the cut groups, both int32 on the device.
extern "C" int moe_gmm_launch(const void* x, const void* w, const void* ends,
                              const void* tile_ends, void* out, int T, int D, int F, int E,
                              void* stream) {
  if (bad_shape(T, D, F, E)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_rows<false>(x, w, ends, tile_ends, out, T, D, F, E, stream);
}

// dx [T, D] = dy [T, F] grouped as moe_gmm_launch's x, times w[e]^T.
extern "C" int moe_gmm_dx_launch(const void* dy, const void* w, const void* ends,
                                 const void* tile_ends, void* dx, int T, int D, int F, int E,
                                 void* stream) {
  if (bad_shape(T, D, F, E)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_rows<true>(dy, w, ends, tile_ends, dx, T, F, D, E, stream);
}

// dw [E, D, F]: dw[e] = x_e^T dy_e over group e's rows of x [T, D] and dy
// [T, F]; `ends` as moe_gmm_launch's.
extern "C" int moe_gmm_dw_launch(const void* x, const void* dy, const void* ends, void* dw, int T,
                                 int D, int F, int E, void* stream) {
  if (bad_shape(T, D, F, E) || E > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = static_cast<int64_t>((D + kBM - 1) / kBM) * ((F + kBN - 1) / kBN);
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t bytes = smem_bytes<false, false>();
  cudaError_t err = allow_smem(gmm_dw_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(tiles), E);
  gmm_dw_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy), static_cast<const int*>(ends),
      static_cast<float*>(dw), D, F);
  return static_cast<int>(cudaGetLastError());
}
