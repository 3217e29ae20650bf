// The bf16 grouped-matmul tile kernel that csrc/moe_gmm_bf16.cu replaced,
// kept to be timed beside it (python -m repro_torch.kernels.moe_gmm_variants
// --bf16) and never linked into the library: wgmma with A from registers,
// w's tile staged MN-major by every thread's 16-byte cp.async and rewritten
// each K tile into no-swizzle K-major core matrices, one block of two
// warpgroups an SM, each K tile waited for before the next.  Its entry point,
// moe_gmm_bf16_core_matrices_launch, takes the arguments of the shipped
// moe_gmm_bf16_launch.
//
// Grouped matrix product for Hopper (sm_90a) at bfloat16, the MoE expert
// FFN's forward on the tensor cores with wgmma: the port of the Pallas
// kernel repro/kernels/moe_gmm.py::moe_gmm_pallas (_gmm_kernel) in its
// 128-row configuration and in the dtype the reference's models run it at:
// bf16 x and w, widened to fp32, summed in fp32, the output rounded to bf16
// once (moe_gmm.py:27-31).
//
// bf16, x [T, D] with its rows sorted into E expert-contiguous groups of
// group_sizes[e] rows (in expert order), w [E, D, F], e(t) the group that
// holds row t: out [T, F] bf16, out[t] = x[t] @ w[e(t)].  Groups that run
// past row T are cut at T; the rows past the last group come out zero.
// Needs D % 8 == 0, F % 8 == 0 and 16-byte aligned tensors (16-byte
// cp.async copies of 8 bf16).  There is no backward here (the bf16 training
// slice): moe_gmm.cu's dX and dW take float32.
//
// Precision: a product of two bf16 values is exact in fp32, so one bf16
// wgmma pass with an fp32 accumulator computes the reference's dot_general
// of the widened operands, up to the order of the sum: none of moe_gmm.cu's
// 3xTF32 split.  As there, each K tile (64 deep here) is summed from zero on
// the tensor cores and then added into an fp32 running sum.
//
// Bound on the H100: 2 * T * D * F flops at 989 TFLOP/s (bf16 dense), or
// 2 * (T * D + E * D * F + T * F) bytes at 3.35 TB/s.  At DeepSeek-V2-Lite's
// serve prefill, [49152, 2048] x [64, 2048, 1408], that is 283 GFLOP
// (0.2866 ms) against 0.71 GB (0.2116 ms): operations bound it.
//
// Design: moe_gmm.cu's forward with bf16 operands.  A block of two
// warpgroups computes a 128 x 128 output tile, each warpgroup 64 rows of it
// with wgmma.m64n128k16 (A from registers, B from shared memory), over K
// tiles of 64 staged by 16-byte cp.async in a ring of 4 shared-memory
// stages: x's tile K-major ([128][64 + 8]), w's MN-major ([64][128 + 8]) as
// they lie in device memory.  For each K tile the block rewrites w's tile
// once into the K-major layout of 8-row x 16-byte core matrices (no swizzle)
// that wgmma reads, each lane loads its A fragments (the m16n8k16 layout),
// and each warpgroup runs the tile's 4 k-steps from zero into a partial sum,
// waits for them and adds the partial into its running sum.  Every row
// padding keeps a warp's fragment loads on 32 distinct banks.  A block finds
// its (group, column tile, row tile) from the groups' row ends and running
// counts of 128-row tiles, computed by the wrapper on the device; row tiles
// are the fastest index, then column tiles, then groups; the blocks past the
// last group's tiles write the zeros of the rows past it.  The kernel
// launches on the caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;  // rows of an output tile
constexpr int kBN = 128;  // columns of an output tile
constexpr int kBK = 64;   // depth of a staged K tile
constexpr int kStages = 4;
constexpr int kThreads = 256;      // two warpgroups, 64 rows each
constexpr int kSteps = kBK / 16;   // wgmma k-steps of a K tile
constexpr int kLdA = kBK + 8;      // x's staged tile, K-major
constexpr int kLdB = kBN + 8;      // w's staged tile, MN-major
constexpr int kTileA = kBM * kLdA;
constexpr int kTileB = kBK * kLdB;
constexpr int kStage = kTileA + kTileB;
constexpr int kCoreB = kBN * kBK;  // w's tile in core matrices

constexpr size_t smem_bytes() {
  return (static_cast<size_t>(kStages) * kStage + kCoreB) * sizeof(bf16);
}

__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool in) {
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

// d (+)= a b for a warpgroup: a its 64 rows x 16 k, each warp's 16 rows in
// registers in mma.m16n8k16's A layout; b [128 n][16 k] K-major in shared
// memory, described by `desc`; scale_d 0 overwrites d.  Lane (g, t) of warp
// q holds rows 16 q + g (+ 8), columns 8 j + 2 t (+ 1) of d in
// d[4 j .. 4 j + 3].
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %69, p, 1, 1, 0;\n}\n"
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
__device__ __forceinline__ uint64_t smem_desc(const bf16* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// Element (n, k) of w's [128 n][64 k] tile in core matrices of 8 n x 8 k:
// the 16 along n 128 bytes apart, the 8 along k 2,048 bytes apart.
__device__ __forceinline__ int core_at(int n, int k) {
  return ((k >> 3) * 16 + (n >> 3)) * 64 + (n & 7) * 8 + (k & 7);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Rows [0, R) x columns [0, C) of a row-major bf16 source (row stride `ld`
// elements) into a shared tile of row stride LD: 16-byte copies, zeros at or
// past `rows` rows or `cols` columns (`cols` a multiple of 8).  `base` is a
// valid address for the copies that read nothing.
template <int R, int C, int LD>
__device__ __forceinline__ void load_block(bf16* dst, const bf16* src, size_t ld, int rows,
                                           int cols, const bf16* base) {
  constexpr int kC8 = C / 8;
  static_assert((R * kC8) % kThreads == 0, "whole copies per thread");
#pragma unroll
  for (int i = 0; i < R * kC8 / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kC8;
    const int c = (idx % kC8) * 8;
    const bool in = r < rows && c < cols;
    cp_async16(dst + r * LD + c, in ? src + r * ld + c : base, in);
  }
}

// acc = x_tile w_e over the contraction [0, K) for the block's 128 x 128
// tile, in wgmma_bf16's layout for the lane's warpgroup (rows 64 w ..
// 64 w + 63).  `a` is x's row 0 of the tile (row stride K, `a_rows` rows
// real), `b` w_e's column 0 of the tile (row stride N, `b_cols` columns
// real); the rest read zeros.
__device__ __forceinline__ void gemm_tile(float (&acc)[64], bf16* smem, const bf16* a, int a_rows,
                                          const bf16* b, int N, int b_cols, int K,
                                          const bf16* a_base, const bf16* b_base) {
  bf16* b_core = smem + kStages * kStage;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row = threadIdx.x / 32 * 16 + g;  // warpgroup w's warp q: 64 w + 16 q
  const int ktiles = (K + kBK - 1) / kBK;

  auto load = [&](int kt) {
    bf16* stage = smem + (kt % kStages) * kStage;
    const int k0 = kt * kBK;
    load_block<kBM, kBK, kLdA>(stage, a + k0, K, a_rows, K - k0, a_base);
    load_block<kBK, kBN, kLdB>(stage + kTileA, b + static_cast<size_t>(k0) * N, N, K - k0,
                               b_cols, b_base);
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
    const bf16* As = smem + (kt % kStages) * kStage;
    const bf16* Bs = As + kTileA;
    // w's tile into core matrices: each thread 8 k of one n, one 16-byte
    // store; a warp's 32 lanes read 32 neighbouring n of each k.
#pragma unroll
    for (int i = 0; i < kBN * kBK / 8 / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int n = idx % kBN, k = idx / kBN * 8;
      uint32_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t lo = __bfloat16_as_ushort(Bs[(k + 2 * j) * kLdB + n]);
        const uint32_t hi = __bfloat16_as_ushort(Bs[(k + 2 * j + 1) * kLdB + n]);
        v[j] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(b_core + core_at(n, k)) = make_uint4(v[0], v[1], v[2], v[3]);
    }
    uint32_t af[kSteps][4];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const bf16* p = As + row * kLdA + 16 * s + 2 * t;
      af[s][0] = ld32(p);
      af[s][1] = ld32(p + 8 * kLdA);
      af[s][2] = ld32(p + 8);
      af[s][3] = ld32(p + 8 * kLdA + 8);
    }
    fence_proxy_async();
    __syncthreads();  // w's core-matrix tile is written
    float part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) keep(part[i]);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      // k-step s: the core matrices 2 s and 2 s + 1 along k.
      wgmma_bf16(part, af[s], smem_desc(b_core + s * 2 * 16 * 64, 16 * 128, 128), s);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < 64; ++i) keep(part[i]);
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
#pragma unroll
      for (int c = 0; c < 4; ++c) keep(af[s][c]);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }
  cp_async_wait<0>();
}

// The block's tile of acc, rounded to bf16, into out (row stride ldo),
// `rows` x `cols` of it.
__device__ __forceinline__ void store_tile(const float (&acc)[64], bf16* out, size_t ldo,
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
        *reinterpret_cast<__nv_bfloat162*>(out + r * ldo + c) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// out [T, N] = x [T, K] grouped by `ends` times w[e] [K, N].  `ends` [E] are
// the groups' running row ends cut at T, `tile_ends` [E] the running counts
// of 128-row tiles of those cut groups.
__global__ void __launch_bounds__(kThreads, 1)
    gmm_rows_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                         const int* __restrict__ ends, const int* __restrict__ tile_ends,
                         bf16* __restrict__ out, int T, int K, int N, int E) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int nc = (N + kBN - 1) / kBN;
  const int used = tile_ends[E - 1] * nc;
  const int tile = blockIdx.x;
  if (tile >= used) {  // the zeros of rows [ends[E - 1], T)
    const int row0 = ends[E - 1] + (tile - used) / nc * kBM;
    const int col0 = (tile - used) % nc * kBN;
    const int rows = min(kBM, T - row0), cols = min(kBN, N - col0);
    for (int idx = threadIdx.x; idx < kBM * kBN / 8; idx += kThreads) {
      const int r = idx / (kBN / 8), c = idx % (kBN / 8) * 8;
      if (r < rows && c < cols)
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(row0 + r) * N + col0 + c) =
            make_uint4(0u, 0u, 0u, 0u);
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
  float acc[64];
  gemm_tile(acc, smem, x + static_cast<size_t>(row0) * K, rows,
            w + static_cast<size_t>(g) * K * N + col0, N, N - col0, K, x, w);
  store_tile(acc, out + static_cast<size_t>(row0) * N + col0, N, rows, N - col0);
}

}  // namespace

// out [T, F] = x [T, D] grouped by `ends` times w [E, D, F], all bf16:
// `ends` [E] are the groups' running row ends cut at T, `tile_ends` [E] the
// running counts of 128-row tiles of the cut groups, both int32 on the
// device.
extern "C" int moe_gmm_bf16_core_matrices_launch(const void* x, const void* w, const void* ends,
                                                 const void* tile_ends, void* out, int T, int D,
                                                 int F, int E, void* stream) {
  if (T < 0 || D < 1 || F < 1 || E < 1 || D % 8 || F % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (static_cast<int64_t>(T + kBM - 1) / kBM + E) * ((F + kBN - 1) / kBN);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t bytes = smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(gmm_rows_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  gmm_rows_bf16_kernel<<<static_cast<unsigned>(blocks), kThreads, bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const int*>(ends),
      static_cast<const int*>(tile_ends), static_cast<bf16*>(out), T, D, F, E);
  return static_cast<int>(cudaGetLastError());
}
