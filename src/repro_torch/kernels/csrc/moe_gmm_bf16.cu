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
// Needs D % 8 == 0, F % 8 == 0 (the tensor maps' row strides are multiples
// of 16 bytes) and 16-byte aligned tensors; D and F need not be multiples
// of the tiles.  There is no backward here: at bf16 the reference's einsums
// compute dX and dW (models/moe.py's gmm_bwd_einsums).
//
// Precision: a product of two bf16 values is exact in fp32, so one bf16
// wgmma pass with an fp32 accumulator computes the reference's dot_general
// of the widened operands, up to the order of the sum.  Each K tile (64
// deep) is summed from zero on the tensor cores into a partial and then
// added into an fp32 running sum; the output is rounded to bf16 once.
//
// Bound on the H100: 2 * T * D * F flops at 989 TFLOP/s (bf16 dense), or
// 2 * (T * D + E * D * F + T * F) bytes at 3.35 TB/s.  At DeepSeek-V2-Lite's
// serve prefill, [49152, 2048] x [64, 2048, 1408], that is 283 GFLOP
// (0.2866 ms) against 0.71 GB (0.2116 ms): operations bound it.
//
// Design (Hopper's: wgmma on tiles that TMA lands swizzled, warp
// specialised).  A block of three warpgroups computes 128 x kBN output
// tiles: two consumer warpgroups of 64 rows each and one producer
// warpgroup, of which one thread issues every copy.  The producer walks the
// block's tiles and their K tiles of 64 into a ring of kStages stages, each
// with a full and an empty mbarrier: x's tile is one TMA box of 128 rows x
// 64 k from a 2-D map over [T, D], K-major; w's is kBN / 64 boxes of 64 f x
// 64 d from a 3-D map over (F, D, E), MN-major as it lies.  64 bf16 are 128
// bytes, so every box lands 128-byte swizzled.  A tile's rows start at its
// group's own row; rows past T and depths or columns past D or F land as
// zeros, and the map's expert dimension keeps one expert's K edge from
// reading the next expert's rows.  A consumer runs wgmma.m64n128k16 with
// both operands read from shared memory as they landed: A = x's tile
// K-major, B = w's tile MN-major by the transpose bit (leading offset: the
// 8 KB between w's two 64-column boxes), so no tile is rewritten and no A
// fragment goes through registers.  A product unit is one K tile, summed
// from zero into one of two partials; unit u + 1 is issued before unit u's
// partial is added into the running sum (wgmma.wait_group 1), so the
// tensor cores do not wait for the adds, and a unit's stage goes back to
// the producer once it has been waited for.  The steady loop is written
// without a branch between a unit's wait and the next unit's products:
// with one, ptxas serialises every wgmma (its warning C7514) and the
// kernel ran 16 % slower on an H100.  setmaxnreg gives each consumer
// thread 232 registers (the running sum and two partials: 192) and the
// producer 40.  The epilogue goes through shared memory: each warpgroup
// writes its 64 rows as bf16 pairs to a padded staging tile, then stores
// whole 16-byte pieces of its rows (7-15 % faster at DeepSeek's and Phi's
// products than each lane's 4-byte pairs straight from the accumulator,
// 2-6 % slower at Jamba's).  The grid is persistent: one block an SM walks
// the tiles blockIdx.x, + gridDim.x, ..., the producer running ahead into
// the next tile's K tiles while the consumers store the last, so the ring
// never drains between tiles.  A block finds a tile's (group, column tile,
// row tile) from the groups' row ends and running counts of 128-row tiles,
// computed by the wrapper on the device; row tiles are the fastest index,
// then column tiles, then groups (a group's w slab is read by neighbouring
// blocks at once); the tiles past the last group's write the zeros of the
// rows past it.  A tile writes only the rows of its own group, each element
// by one thread: no atomics, so two calls give the same bits.  The tensor
// maps are encoded on the host by cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, and passed as __grid_constant__
// parameters.  The kernel launches on the caller's stream and allocates
// nothing.
//
// The choices against their sweeps (PERF.md; kernels/moe_gmm_variants.py
// --bf16 times the stages and the grid): 4 stages (3 and 5 slower), a
// persistent grid (a block a tile 3-12 % slower), 128 columns (256 columns,
// one partial and each unit's adds waited for, won only at DeepSeek's down
// products), a from-zero partial 64 deep (128 deep, two units in flight
// hold the whole ring: 1.5x slower).  What holds it at about 55 % of the
// bound (1.3-1.5x torch.bmm) is shared memory: at the tensor cores' rate
// the products read 96 bytes a clock of the SM's 128 (each warpgroup reads
// its A and all of B) and TMA writes 64, so the tiles cannot be fed faster
// than 80 % of that rate; a wider product that reads A once (m64n256)
// would need a 128-register partial beside a 128-register running sum.

#include <cuda.h>  // CUtensorMap and its enums (types only: the driver is reached at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;  // rows of an output tile, 64 a consumer warpgroup
constexpr int kBN = 128;  // columns of an output tile
constexpr int kBK = 64;   // depth of a K tile: one TMA box, 128 bytes of bf16
constexpr int kStages = 4;
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);  // and the producer warpgroup
constexpr int kBox = 64;                          // columns of one of w's TMA boxes
constexpr int kSteps = kBK / 16;                  // wgmma k-steps of a K tile
constexpr int kABytes = kBM * kBK * 2;
constexpr int kBBytes = kBK * kBN * 2;
constexpr int kStageBytes = kABytes + kBBytes;
// setmaxnreg: 2 x 128 x 232 + 128 x 40 of an SM's 65,536 registers.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(kBN == 128, "one m64n128k16 product a K tile");
// A consumer warpgroup's 64 output rows, bf16, rows padded by 16 bytes so
// that the accumulator's stores and the rows' 16-byte reads keep to
// distinct banks.
constexpr int kOutLd = kBN + 8;
constexpr int kOutBytes = kConsumers * 64 * kOutLd * 2;

constexpr size_t smem_bytes() {
  return static_cast<size_t>(kStages) * kStageBytes + kOutBytes +
         2 * kStages * sizeof(uint64_t) + 1024;
}

// ------------------------------------------------ barriers, TMA and wgmma
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory from its first 1024-byte boundary (a swizzled
// box's pattern repeats every 1024 bytes and wgmma reads it from there).
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` from the copies that name the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of x's 2-D map at (k, row), into shared memory; completion
// counted on `bar`.
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int k,
                                       int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row), "r"(smem_u32(bar))
      : "memory");
}

// One box of w's 3-D map at (f, d, expert).
__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int f,
                                       int d, int e) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(f), "r"(d), "r"(e), "r"(smem_u32(bar))
      : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading offset `lbo` (MN-major: from one 64-element box to the
// next along N; unused K-major), 8-row groups 1,024 bytes apart.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// x's tile, K-major: rows [64 wg, 64 wg + 64), k-step kk (k 16 kk .. 16 kk
// + 15): within the 128-byte swizzled row the step moves the start 32 bytes.
__device__ __forceinline__ uint64_t desc_a(uint32_t tile, int wg, int kk) {
  return smem_desc(tile + wg * 64 * 128 + 32 * kk, 16);
}

// w's tile, MN-major (transpose bit): k-step kk (rows 16 kk .. 16 kk + 15
// of each box), the 128 columns of w's two 64-column boxes.
__device__ __forceinline__ uint64_t desc_b(uint32_t tile, int kk) {
  constexpr uint32_t kBoxBytes = kBK * kBox * 2;
  return smem_desc(tile + 16 * kk * 128, kBoxBytes);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N of this warpgroup's commit groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers that wgmma writes asynchronously: the compiler may not
// move or reuse them across this point.
__device__ __forceinline__ void keep(float (&r)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (+)= a b, m64n128k16: a K-major and b MN-major (transposed) in shared
// memory; scale_d 0 overwrites d.  Lane (g, t) of warp q of the warpgroup
// holds rows 16 q + g (+ 8), columns 8 j + 2 t (+ 1) of d in d[4 j .. 4 j +
// 3].
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// ------------------------------------------------------------------ tiles
// An output tile: rows [row0, row0 + rows) of group g (g < 0: rows past the
// last group, zeros), columns [col0, col0 + kBN).
struct Tile {
  int row0, rows, col0, g;
};

// The tiles of a call: tile_ends[E - 1] x nc of the groups, then the zero
// rows' tiles.
__device__ __forceinline__ int tile_count(const int* ends, const int* tile_ends, int T, int E,
                                          int nc) {
  const int last = __ldg(ends + E - 1);
  return (__ldg(tile_ends + E - 1) + (T - last + kBM - 1) / kBM) * nc;
}

__device__ __forceinline__ Tile tile_at(int tile, const int* ends, const int* tile_ends, int E,
                                        int nc) {
  Tile tl;
  const int used = __ldg(tile_ends + E - 1) * nc;
  if (tile >= used) {  // the zeros of rows [ends[E - 1], T)
    tl.g = -1;
    tl.row0 = __ldg(ends + E - 1) + (tile - used) / nc * kBM;
    tl.col0 = (tile - used) % nc * kBN;
    tl.rows = kBM;
    return tl;
  }
  int g = 0;
  while (tile >= __ldg(tile_ends + g) * nc) ++g;
  const int t_begin = g ? __ldg(tile_ends + g - 1) : 0;
  const int row_tiles = __ldg(tile_ends + g) - t_begin;
  const int local = tile - t_begin * nc;
  tl.g = g;
  tl.col0 = local / row_tiles * kBN;
  tl.row0 = (g ? __ldg(ends + g - 1) : 0) + local % row_tiles * kBM;
  tl.rows = min(kBM, __ldg(ends + g) - tl.row0);
  return tl;
}

// Synchronises the 128 threads of consumer warpgroup wg (named barrier
// 1 + wg; 0 is __syncthreads').
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// One warpgroup's 64 rows of a tile's sums, rounded to bf16, into out,
// through `stage` (64 x kOutLd bf16): rows [0, rows) and columns [0, cols)
// of the tile at `o` (row stride N), the warpgroup's first row `row0` (0 or
// 64), each thread 16 bytes of a row a store.
__device__ __forceinline__ void store_staged(const float (&acc)[64], bf16* stage,
                                             bf16* o, size_t N, int wg, int row0, int rows,
                                             int cols) {
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  wg_sync(wg);  // the last tile's rows are read out
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + g + 8 * h;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<__nv_bfloat162*>(stage + r * kOutLd + 8 * j + 2 * t) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
  wg_sync(wg);
  constexpr int kChunks = kBN / 8;  // 16-byte pieces of a row
#pragma unroll 4
  for (int idx = tid; idx < 64 * kChunks; idx += 128) {
    const int r = idx / kChunks, c = idx % kChunks * 8;
    if (row0 + r < rows && c < cols)
      *reinterpret_cast<uint4*>(o + static_cast<size_t>(row0 + r) * N + c) =
          *reinterpret_cast<const uint4*>(stage + r * kOutLd + c);
  }
}

// out [T, N] = x [T, K] grouped by `ends` times w[e] [K, N] (tx, tw: their
// tensor maps).  `ends` [E] are the groups' running row ends cut at T,
// `tile_ends` [E] the running counts of 128-row tiles of those cut groups.
__global__ void __launch_bounds__(kThreads, 1)
    gmm_tile_bf16_kernel(const __grid_constant__ CUtensorMap tx,
                         const __grid_constant__ CUtensorMap tw, const int* __restrict__ ends,
                         const int* __restrict__ tile_ends, bf16* __restrict__ out, int T, int K,
                         int N, int E) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  bf16* out_stage = reinterpret_cast<bf16*>(smem + kStages * kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes + kOutBytes);
  uint64_t* empty = full + kStages;
  const int nc = (N + kBN - 1) / kBN;
  const int ktiles = (K + kBK - 1) / kBK;
  const int n_tiles = tile_count(ends, tile_ends, T, E, nc);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kConsumers);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // Producer: one thread issues every copy, kStages K tiles ahead of the
    // consumers, across tile boundaries.
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 128 * kConsumers) {
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const Tile tl = tile_at(tile, ends, tile_ends, E, nc);
        if (tl.g < 0) continue;
        for (int j = 0; j < ktiles; ++j, ++it) {
          const int s = it % kStages;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          unsigned char* stage = smem + s * kStageBytes;
          mbar_expect_tx(&full[s], kStageBytes);
          tma_2d(stage, &tx, &full[s], j * kBK, tl.row0);
#pragma unroll
          for (int hb = 0; hb < kBN / kBox; ++hb)
            tma_3d(stage + kABytes + hb * (kBK * kBox * 2), &tw, &full[s], tl.col0 + hb * kBox,
                   j * kBK, tl.g);
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int lane = threadIdx.x % 32;
    const uint32_t smem_base = smem_u32(smem);
    int it = 0;  // K tiles this block has consumed, as the producer counts them
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const Tile tl = tile_at(tile, ends, tile_ends, E, nc);
      bf16* o = out + static_cast<size_t>(tl.row0) * N + tl.col0;
      const int cols = N - tl.col0;
      if (tl.g < 0) {  // zeros, 16 bytes a store, rows past T untouched
        const int rows = T - tl.row0;
        for (int idx = threadIdx.x; idx < kBM * kBN / 8; idx += 128 * kConsumers) {
          const int r = idx / (kBN / 8), c = idx % (kBN / 8) * 8;
          if (r < rows && c < cols)
            *reinterpret_cast<uint4*>(o + static_cast<size_t>(r) * N + c) = make_uint4(0, 0, 0, 0);
        }
        continue;
      }
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;

      // Unit u: K tile u, summed from zero.  Its stage is waited for before
      // the fence, so no branch falls between a unit's products.
      auto issue = [&](float(&part)[64], int u) {
        const int s = (it + u) % kStages;
        mbar_wait(&full[s], ((it + u) / kStages) & 1);
        const uint32_t a = smem_base + s * kStageBytes;
        keep(part);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk)
          wgmma_ss(part, desc_a(a, wg, kk), desc_b(a + kABytes, kk), kk);
        wgmma_commit();
      };
      // Unit u's partial into the running sum, its stage back to the
      // producer (every earlier product is done).
      auto finish = [&](float(&part)[64], int u) {
        keep(part);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += part[i];
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(it + u) % kStages]);
      };
      // Unit u + 1 is issued before unit u's adds; p0 holds the even units.
      float p0[64], p1[64];
      issue(p0, 0);
      int u = 0;
      for (; u + 2 < ktiles; u += 2) {
        issue(p1, u + 1);
        wgmma_wait<1>();
        finish(p0, u);
        issue(p0, u + 2);
        wgmma_wait<1>();
        finish(p1, u + 1);
      }
      if (u + 1 < ktiles) {
        issue(p1, u + 1);
        wgmma_wait<1>();
        finish(p0, u);
        wgmma_wait<0>();
        finish(p1, u + 1);
      } else {
        wgmma_wait<0>();
        finish(p0, u);
      }
      it += ktiles;
      store_staged(acc, out_stage + wg * 64 * kOutLd, o, N, wg, 64 * wg, tl.rows, cols);
    }
  }
}

// ------------------------------------------------------------------- host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 tensor of `rank` dimensions (innermost first) as a tensor map read
// in `box`es that land 128-byte swizzled; reads out of bounds give zeros.
cudaError_t make_map(CUtensorMap* map, const void* base, cuuint32_t rank, const cuuint64_t* dims,
                     const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
                            dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// out [T, F] = x [T, D] grouped by `ends` times w [E, D, F], all bf16:
// `ends` [E] are the groups' running row ends cut at T, `tile_ends` [E] the
// running counts of 128-row tiles of the cut groups, both int32 on the
// device.
extern "C" int moe_gmm_bf16_launch(const void* x, const void* w, const void* ends,
                                   const void* tile_ends, void* out, int T, int D, int F, int E,
                                   void* stream) {
  if (T < 0 || D < 1 || F < 1 || E < 1 || D % 8 || F % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return static_cast<int>(cudaSuccess);
  const int64_t tiles = (static_cast<int64_t>(T + kBM - 1) / kBM + E) * ((F + kBN - 1) / kBN);
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  // A runtime call first: it makes the device's context current on this
  // thread (an autograd thread may have none), which the encoder needs.
  constexpr size_t bytes = smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(gmm_tile_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  CUtensorMap tx, tw;
  if (err == cudaSuccess) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(T)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * 2};
    const cuuint32_t box[2] = {kBK, kBM};
    err = make_map(&tx, x, 2, dims, strides, box);
  }
  if (err == cudaSuccess) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(F), static_cast<cuuint64_t>(D),
                                static_cast<cuuint64_t>(E)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(F) * 2,
                                   static_cast<cuuint64_t>(D) * F * 2};
    const cuuint32_t box[3] = {kBox, kBK, 1};
    err = make_map(&tw, w, 3, dims, strides, box);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t grid = tiles < sms ? tiles : sms;  // persistent: one block an SM
  gmm_tile_bf16_kernel<<<static_cast<unsigned>(grid), kThreads, bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      tx, tw, static_cast<const int*>(ends), static_cast<const int*>(tile_ends),
      static_cast<bf16*>(out), T, D, F, E);
  return static_cast<int>(cudaGetLastError());
}
