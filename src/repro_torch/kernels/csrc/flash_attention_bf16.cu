// Flash attention forward for Hopper (sm_90a) at bfloat16: the port of the
// Pallas kernel repro/kernels/flash_attention.py::flash_attention_pallas
// (_flash_kernel) in the dtype the reference's models run it at (every
// configuration defaults to bfloat16, repro/configs/base.py), where the TPU
// kernel widens its bf16 operands to fp32, accumulates in fp32 and rounds
// its output back to bf16 (flash_attention.py:73-75,95).
//
// bf16 in and out, fp32 statistics, layouts as flash_attention.cu:
//     q [B, Sq, H, D], k / v [B, Sk, KV, D], o [B, Sq, H, D] bf16,
//     lse [B, H, Sq] fp32 (+inf for a row with no visible key);
//     query head h reads kv head h / g, g = H / KV (GQA); the same
//     visibility (causal, window, q_offset) and the same zero row.
// D is 32, 64 or 128.  The backward (flash_attention_bf16_bwd_launch, the
// counterpart of jax.grad through repro/kernels/ref.py::chunked_attention
// at bf16) takes bf16 q, k, v, o and dO and the forward's fp32 lse and
// writes bf16 dq, dk, dv.
//
// Precision: a product of two bf16 values is exact in fp32, so one bf16
// tensor-core pass with an fp32 accumulator computes S = Q K^T as the
// reference's dot_general of the widened operands does, up to the order of
// the sum.  P V multiplies the fp32 probabilities by bf16 V: P is rounded to
// bf16 for one pass (about 2^-9 relative a weight), which is what the
// reference's dot_general at default precision computes on a TPU and what
// its plain CPU path (ref.chunked_attention: p.astype(v.dtype)) computes
// too.  The row sum l adds the unrounded fp32 weights.  Each key tile's
// P V is summed from zero on the tensor cores and then added into the fp32
// running sum; the output is rounded to bf16 once.
//
// Bound on the H100: 4 * D flops per visible (query, key) pair and head at
// 989 TFLOP/s (bf16 dense), or the bytes (2 a bf16 element, 4 an lse) at
// 3.35 TB/s.  At the serve prefills' [2, 512, 48/8, 128] causal that is 6.5
// GFLOP (0.0065 ms) against 29.4 MB (0.0088 ms): bytes bound it there, and
// operations at Qwen3-14B's [2, 4096, 40/8, 128] (344 GFLOP, 0.3475 ms).
//
// Design (Hopper's: wgmma on tiles that TMA lands swizzled).  A block of
// three warpgroups owns 128 query rows of one head: two consumer
// warpgroups of 64 rows each and one producer warpgroup, of which one
// thread issues every copy.  The producer loads the block's Q once, and K
// and V in tiles of 128 keys into a ring of three stages, each stage with
// its own full mbarrier for K and for V and one empty mbarrier; each tile
// is a set of TMA boxes of 64 rows x 64 columns (128 bytes, 128-byte
// swizzle; 32 columns and 64-byte swizzle at D = 32), read from the
// [B, S, heads, D] tensors through 4-D tensor maps whose out-of-bounds rows
// land as zeros (the ragged edge).  A consumer warpgroup computes
// S = Q K^T with wgmma.m64n128k16, Q and K read K-major from shared memory
// as they landed (the descriptors name the swizzle, so no tile is
// rewritten); masks (-inf) and takes the row max on the raw scores, and
// p = 2^(s scale log2 e - m scale log2 e) in one FFMA and ex2; packs P to
// bf16 pairs, which is the wgmma A-fragment layout of the accumulator it
// came from; and computes P V with wgmma.m64n64k16 (m64n32k16 at D = 32),
// P from registers and V read MN-major (the transpose bit), one product a
// 64-column box of D, each summed from zero into a 32-register partial and
// added into the output.  The products run one tile behind the softmax:
// tile j's S is issued, then tile j - 1's P V, and tile j's softmax runs
// while they do, so O = alpha_j (O + P_{j-1} V_{j-1}).  setmaxnreg gives
// the consumers 240 registers a thread and the producer 24 (a producer
// warpgroup of one warp, which would leave the consumers 248, hangs at
// setmaxnreg on an H100).  A lane masks its tile against the visible key
// range of each of its two rows, [lo, hi), computed once.  Masking, the
// visited tiles, the re-masked probabilities (a masked weight is 0, also in
// a row that has seen no key yet) and the grid order (the last query
// tiles, which see the most keys, first) are flash_attention.cu's.  The
// two consumer warpgroups taking turns on named barriers (ping-pong) was
// slower at the paths' shapes on an H100 and is not kept.
//
// Backward: delta_i = sum_d dO_i,d O_i,d in fp32 from the bf16 O and dO,
// then two warp-specialised kernels of the forward's shape.  dK/dV: a
// block owns 128 keys of one kv head (64 a consumer warpgroup), loads K and
// V once, and streams 64-query tiles of each of the group's g query heads
// (Q, dO, and the tile's lse and delta) through the ring; per tile it
// computes S^T = K Q^T and dP^T = V dO^T (wgmma.m64n64k16, both operands
// K-major), P^T = exp(S^T scale - lse) in fp32 from the forward's fp32
// logsumexp and dS^T = P^T o (dP^T - delta); then dV += P^T dO with P^T
// rounded to bf16 (the reference rounds P to v's dtype, ref.py:53,97, and
// differentiates through that rounding) and dK += dS^T Q with dS^T rounded
// to bf16, both from registers against dO and Q read MN-major.  dQ: a block
// owns 128 queries of one head and streams 64-key tiles of K and V; per
// tile S = Q K^T and dP = dO V^T, dS, and dQ += dS K with K read MN-major.
// Each streamed tile's product is summed from zero, a 64-column half of D
// at a time, and then added into the fp32 running sums; a kv head's dK and
// dV sum over its g query heads in fp32; dK and dQ take the scale at the
// end, and each gradient is rounded to bf16 once.  No atomics: every
// element is summed by one lane in a fixed order, so two calls give the
// same bits.  Bound: 10 * D flops a visible (query, key) pair and head (S,
// dP, dV, dK, dQ; 2.5x the forward's 4 D), or the bytes; the two kernels
// compute S and dP twice (14 * D).
//
// The tensor maps are encoded on the host by cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint (no -lcuda on the link line), and
// passed as __grid_constant__ parameters.  Each kernel launches on the
// caller's stream and allocates nothing.

#include <cuda.h>  // CUtensorMap and its enums (types only: the driver is reached at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kConsumers = 2;                    // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1); // and the producer warpgroup
constexpr int kBlockRows = 64 * kConsumers;      // queries (forward, dQ) or keys (dK/dV) a block
constexpr int kBox = 64;                         // rows of a TMA box
constexpr int kFwdCols = 128;                    // keys of a forward tile
constexpr int kBwdCols = 64;                     // rows of a streamed backward tile
constexpr int kStages = 3;
// setmaxnreg: 2 x 128 x 240 + 128 x 24 of an SM's 65,536 registers.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kNone = -0x40000000;  // an empty range's bound

// How a [rows][D] bf16 tile lies in shared memory: as D / NC boxes side by
// side, each [rows][NC] with rows of RB bytes, swizzled by TMA over RB
// bytes (128, or 64 at D = 32); a box's 8-row group is 8 RB bytes.
template <int D>
struct Tile {
  static constexpr int NC = D < 64 ? D : 64;
  static constexpr int RB = 2 * NC;
  static constexpr int kHalves = D / NC;
  static constexpr uint64_t kLayout = NC == 64 ? 1 : 2;  // wgmma: 128-byte / 64-byte swizzle
  static constexpr int kGroup = 8 * RB;
  static_assert(NC == 64 || NC == 32, "D is 32, 64 or 128");
};

struct Geometry {
  int Sq, Sk, H, KV, g;
  int causal, window, q_offset;
  float scale;
};

// Whether every key of [k_lo, k_hi) is visible from every query row of
// [q_lo, q_hi): such a tile needs no mask.
__device__ __forceinline__ bool all_visible(const Geometry& geo, int q_lo, int q_hi, int k_lo,
                                            int k_hi) {
  return q_hi <= geo.Sq && k_hi <= geo.Sk && (!geo.causal || k_hi - 1 <= geo.q_offset + q_lo) &&
         (!geo.window || k_lo > geo.q_offset + q_hi - 1 - geo.window);
}

// The keys [lo, hi) that query row qi sees (empty past Sq).
__device__ __forceinline__ void key_bounds(const Geometry& geo, int qi, int* lo, int* hi) {
  const int qp = geo.q_offset + qi;
  *lo = geo.window ? qp - geo.window + 1 : kNone;
  *hi = qi >= geo.Sq ? kNone : geo.causal ? min(geo.Sk, qp + 1) : geo.Sk;
}

// The query rows [lo, hi) that see key kj (empty past Sk).
__device__ __forceinline__ void query_bounds(const Geometry& geo, int kj, int* lo, int* hi) {
  *lo = geo.causal ? kj - geo.q_offset : kNone;
  *hi = kj >= geo.Sk ? kNone : geo.window ? min(geo.Sq, kj - geo.q_offset + geo.window) : geo.Sq;
}

// First and one past the last query row that can see any of keys [c0, c1).
__device__ __forceinline__ void query_range(const Geometry& geo, int c0, int c1, int* r_begin,
                                            int* r_end) {
  *r_begin = geo.causal ? max(0, c0 - geo.q_offset) : 0;
  *r_end = geo.window ? min(geo.Sq, c1 - 1 + geo.window - geo.q_offset) : geo.Sq;
}

// Number of BN-row tiles from the one holding `begin` to the one holding
// `end - 1`, and the first of them.
template <int BN>
__device__ __forceinline__ int tile_span(int begin, int end, int* first) {
  *first = begin / BN;
  return end > begin ? (end + BN - 1) / BN - *first : 0;
}

// First key and one past the last key any of query rows [r0, r1) can see.
__device__ __forceinline__ void key_range(const Geometry& geo, int r0, int r1, int* k_begin,
                                          int* k_end) {
  *k_end = geo.causal ? min(geo.Sk, geo.q_offset + r1) : geo.Sk;
  *k_begin = geo.window ? max(0, geo.q_offset + r0 - geo.window + 1) : 0;
}

// ------------------------------------------------ barriers, TMA and wgmma
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory, from its first 1024-byte boundary (a swizzled
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

// One TMA box of a [B, S, heads, D] tensor map, at (column, head, row, b),
// into shared memory; completion counted on `bar`.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, uint64_t* bar, int col,
                                        int head, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(head), "r"(row), "r"(b),
      "r"(smem_u32(bar))
      : "memory");
}

// Rows [row0, row0 + R) of head `head`, batch b, all of D, into an R-row
// tile (Tile<D>'s layout): R / 64 x D / NC boxes.
template <int D, int R>
__device__ __forceinline__ void tma_tile(void* tile, const CUtensorMap* map, uint64_t* bar,
                                         int head, int row0, int b) {
  using L = Tile<D>;
#pragma unroll
  for (int hh = 0; hh < L::kHalves; ++hh)
#pragma unroll
    for (int rb = 0; rb < R / kBox; ++rb)
      tma_box(static_cast<unsigned char*>(tile) + (hh * R + rb * kBox) * L::RB, map, bar,
              hh * L::NC, head, row0 + rb * kBox, b);
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// A wgmma shared-memory descriptor: start address, leading offset 16
// bytes (unused by these layouts), 8-row groups 8 RB apart, the swizzle.
template <int D>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  using L = Tile<D>;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(L::kGroup >> 4) << 32) | (L::kLayout << 62);
}

// K-major operand: rows [row0, row0 + 64 or the tile's N) of an R-row tile,
// contraction over D, k-step kk (columns 16 kk .. 16 kk + 15): within a
// box the step moves the start 32 bytes along the swizzled row.
template <int D, int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int row0, int kk) {
  using L = Tile<D>;
  const int col = 16 * kk;
  return smem_desc<D>(tile + ((col / L::NC) * R + row0) * L::RB + (col % L::NC) * 2);
}

// MN-major operand: contraction over an R-row tile's rows (k-step kk: rows
// 16 kk .. 16 kk + 15), N the NC columns of box hh (transpose bit set).
template <int D, int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int hh, int kk) {
  using L = Tile<D>;
  return smem_desc<D>(tile + (hh * R + 16 * kk) * L::RB);
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

// Waits until at most N of this warpgroup's commit groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers that wgmma reads or writes asynchronously: the compiler
// may not move or reuse them across this point.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) asm volatile("" : "+r"(r[i][c])::"memory");
}

// d (+)= a b, m64n128k16: a and b K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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

// d (+)= a b, m64n64k16: a and b K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (+)= a b, m64n64k16: a from registers, b MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (+)= a b, m64n32k16: a from registers, b MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// 2^x on the special-function unit (ex2.approx: about 2^-22 relative).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The forward's softmax, one key tile of raw scores sc (rows g and g + 8 of
// a warp's 16, masked scores -inf) at a time.  row_max: the rows' new
// running max m (raw) and alpha = 2^((m_old - m) scale_log2), which
// rescales what was summed against m_old (0 where nothing was).
template <int N>
__device__ __forceinline__ void row_max(const float (&sc)[N], float (&m)[2], float (&alpha)[2],
                                        float scale_log2) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < N; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    alpha[i] = m[i] == -INFINITY ? 0.f : ex2((m[i] - mx[i]) * scale_log2);
    m[i] = mx[i];
  }
}

// exp_rows: sc becomes p = 2^(s scale_log2 - m scale_log2) (0 for a masked
// score, also in a row that has seen no key), and l = alpha l + the lane's
// part of the row sums of the unrounded p.
template <int N>
__device__ __forceinline__ void exp_rows(float (&sc)[N], const float (&m)[2], float (&l)[2],
                                         const float (&alpha)[2], float scale_log2) {
  float ms[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    ms[i] = m[i] == -INFINITY ? 0.f : m[i] * scale_log2;
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    sc[i] = ex2(fmaf(sc[i], scale_log2, -ms[(i >> 1) & 1]));
    l[(i >> 1) & 1] += sc[i];
  }
}

// Two fp32 values rounded to a bf16 pair, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// An m64nN accumulator (N = 4 K) rounded to bf16 as the A operand of K / 16
// k-steps: the accumulator's layout (lane (g, t) of warp w holds rows
// 16 w + g (+ 8), columns 8 n + 2 t (+ 1) in d[4 n .. 4 n + 3]) is the
// A-fragment layout, two 8-column blocks a k-step.
template <int K>
__device__ __forceinline__ void to_a(uint32_t (&a)[K / 16][4], const float (&d)[K / 2]) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int c = 0; c < 4; ++c) a[kk][c] = pack_bf16(d[8 * kk + 2 * c], d[8 * kk + 2 * c + 1]);
}

// acc[hh] += a B for each box hh of D's columns: a [64][K] in registers
// (K / 16 k-steps), B the first K rows of the R-row tile at `tile`, read
// MN-major; each box's product is summed from zero, then added.
template <int D, int R, int K>
__device__ __forceinline__ void add_product(float (&acc)[Tile<D>::kHalves][Tile<D>::NC / 2],
                                            uint32_t (&a)[K / 16][4], uint32_t tile) {
  using L = Tile<D>;
#pragma unroll
  for (int hh = 0; hh < L::kHalves; ++hh) {
    float part[L::NC / 2];
    keep(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) wgmma_rs(part, a[kk], desc_mn<D, R>(tile, hh, kk), kk);
    wgmma_commit();
    wgmma_wait_all();
    keep(part);
    keep(a);
#pragma unroll
    for (int i = 0; i < L::NC / 2; ++i) acc[hh][i] += part[i];
  }
}

// Rows of a warp's 16 x D accumulator (acc[hh][4 n + c]: row g + 8 (c >> 1),
// column hh NC + 8 n + 2 t + (c & 1)), times scale, rounded to bf16 into
// rows [row0, row0 + 16) of a [.., rows, heads, D] tensor (row stride
// `stride`); rows at or past `nrows` are not written.
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, size_t stride, int row0, int nrows,
                                           const float (&acc)[Tile<D>::kHalves][Tile<D>::NC / 2],
                                           const float (&scale)[2], int g, int t) {
  using L = Tile<D>;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + 8 * half;
    if (r >= nrows) continue;
    bf16* dst = base + static_cast<size_t>(r) * stride + 2 * t;
#pragma unroll
    for (int hh = 0; hh < L::kHalves; ++hh)
#pragma unroll
      for (int n = 0; n < L::NC / 8; ++n)
        *reinterpret_cast<uint32_t*>(dst + hh * L::NC + 8 * n) =
            pack_bf16(acc[hh][4 * n + 2 * half] * scale[half],
                      acc[hh][4 * n + 2 * half + 1] * scale[half]);
  }
}

template <int D>
__device__ __forceinline__ void zero(float (&acc)[Tile<D>::kHalves][Tile<D>::NC / 2]) {
#pragma unroll
  for (int hh = 0; hh < Tile<D>::kHalves; ++hh)
#pragma unroll
    for (int i = 0; i < Tile<D>::NC / 2; ++i) acc[hh][i] = 0.f;
}

// ---------------------------------------------------------------- forward
template <int D>
constexpr int fwd_smem() {
  return kBlockRows * D * 2 + 2 * kStages * kFwdCols * D * 2 + 128 + 1024;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                          float* __restrict__ lse, Geometry geo) {
  using L = Tile<D>;
  constexpr int kQBytes = kBlockRows * D * 2;
  constexpr int kKVBytes = kFwdCols * D * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* Qs = smem;                                 // [kBlockRows][D]
  unsigned char* Ks = Qs + kQBytes;                         // [kStages][kFwdCols][D]
  unsigned char* Vs = Ks + kStages * kKVBytes;              // [kStages][kFwdCols][D]
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + kStages * kKVBytes);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + kStages;
  uint64_t* empty = bars + 1 + 2 * kStages;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlockRows;
  int k_begin, k_end, first;
  key_range(geo, q0, min(q0 + kBlockRows, geo.Sq), &k_begin, &k_end);
  const int n_tiles = tile_span<kFwdCols>(k_begin, k_end, &first);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 4 * kConsumers);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // Producer: one thread issues every copy; K and V of a stage on their
    // own barriers, so S can start before V has landed.
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 128 * kConsumers && n_tiles > 0) {
      const int kvh = h / geo.g;
      mbar_expect_tx(q_full, kQBytes);
      tma_tile<D, kBlockRows>(Qs, &tq, q_full, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        const int k0 = (first + j) * kFwdCols;
        mbar_expect_tx(&k_full[s], kKVBytes);
        tma_tile<D, kFwdCols>(Ks + s * kKVBytes, &tk, &k_full[s], kvh, k0, b);
        mbar_expect_tx(&v_full[s], kKVBytes);
        tma_tile<D, kFwdCols>(Vs + s * kKVBytes, &tv, &v_full[s], kvh, k0, b);
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int warp = threadIdx.x / 32 % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int row = q0 + 64 * wg + 16 * warp + g;  // this lane's rows: row, row + 8
    const float scale_log2 = geo.scale * kLog2e;
    const uint32_t q_addr = smem_u32(Qs);
    float m[2] = {-INFINITY, -INFINITY};  // the rows' running max of the raw scores
    float l[2] = {0.f, 0.f};
    float acc[L::kHalves][L::NC / 2];
    zero<D>(acc);
    float sc[kFwdCols / 2];      // S of tile j: rows row (+ 8), keys k0 + 8 n + 2 t (+ 1)
    uint32_t pa[kFwdCols / 16][4];  // P of tile j - 1, bf16, as wgmma's A operand
    float part[L::NC / 2];       // P V of tile j - 1 for one box of D, from zero

    // S_j = Q K_j^T, one commit group.  Q's descriptors are rebuilt each
    // time (an opaque copy of its address), not held in registers.
    auto issue_s = [&](int j) {
      const int s = j % kStages;
      uint32_t qa = q_addr;
      asm volatile("" : "+r"(qa));
      mbar_wait(&k_full[s], (j / kStages) & 1);
      keep(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(sc, desc_k<D, kBlockRows>(qa, 64 * wg, kk),
                 desc_k<D, kFwdCols>(smem_u32(Ks + s * kKVBytes), 0, kk), kk);
      wgmma_commit();
    };
    // part = P_j V_j for box hh of D's columns, one commit group.
    auto issue_pv = [&](int j, int hh) {
      const int s = j % kStages;
      if (hh == 0) mbar_wait(&v_full[s], (j / kStages) & 1);
      keep(part);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kFwdCols / 16; ++kk)
        wgmma_rs(part, pa[kk], desc_mn<D, kFwdCols>(smem_u32(Vs + s * kKVBytes), hh, kk), kk);
      wgmma_commit();
    };
    auto add_part = [&](int hh) {
      keep(part);
      keep(pa);
#pragma unroll
      for (int i = 0; i < L::NC / 2; ++i) acc[hh][i] += part[i];
    };
    // Masked scores of tile j become -inf.
    int lo[2], hi[2];
    key_bounds(geo, row, &lo[0], &hi[0]);
    key_bounds(geo, row + 8, &lo[1], &hi[1]);
    auto mask = [&](int j) {
      const int k0 = (first + j) * kFwdCols;
      if (!all_visible(geo, row - g, row - g + 16, k0, k0 + kFwdCols)) {
#pragma unroll
        for (int i = 0; i < kFwdCols / 2; ++i) {
          const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
          if (col < lo[(i >> 1) & 1] || col >= hi[(i >> 1) & 1]) sc[i] = -INFINITY;
        }
      }
    };
    auto release = [&](int j) {  // this warp has read stage j's K and V
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[j % kStages]);
    };

    if (n_tiles > 0) {
      mbar_wait(q_full, 0);
      float alpha[2];
      issue_s(0);
      wgmma_wait<0>();
      keep(sc);
      mask(0);
      row_max(sc, m, alpha, scale_log2);
      exp_rows(sc, m, l, alpha, scale_log2);
      to_a<kFwdCols>(pa, sc);
      // Tile j's S and softmax beside tile j - 1's P V on the tensor cores.
      for (int j = 1; j < n_tiles; ++j) {
        issue_s(j);
        issue_pv(j - 1, 0);
        wgmma_wait<1>();
        keep(sc);
        mask(j);
        row_max(sc, m, alpha, scale_log2);
        wgmma_wait<0>();
        add_part(0);
        if constexpr (L::kHalves == 2) issue_pv(j - 1, 1);
        exp_rows(sc, m, l, alpha, scale_log2);
        if constexpr (L::kHalves == 2) {
          wgmma_wait<0>();
          add_part(1);
        }
        release(j - 1);
        // O = alpha (O + P_{j-1} V_{j-1}): both were summed against the old max.
#pragma unroll
        for (int hh = 0; hh < L::kHalves; ++hh)
#pragma unroll
          for (int i = 0; i < L::NC / 2; ++i) acc[hh][i] *= alpha[(i >> 1) & 1];
        to_a<kFwdCols>(pa, sc);
      }
#pragma unroll
      for (int hh = 0; hh < L::kHalves; ++hh) {
        issue_pv(n_tiles - 1, hh);
        wgmma_wait<0>();
        add_part(hh);
      }
      release(n_tiles - 1);
    }

    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;  // a row with no visible key is 0
      const int r = row + 8 * i;
      if (t == 0 && r < geo.Sq) {
        lse[(static_cast<size_t>(b) * geo.H + h) * geo.Sq + r] =
            l[i] > 0.f ? (m[i] * scale_log2 + log2f(l[i])) * kLn2 : INFINITY;
      }
    }
    bf16* ob = o + (static_cast<size_t>(b) * geo.Sq * geo.H + h) * D;
    store_rows<D>(ob, static_cast<size_t>(geo.H) * D, row - g, geo.Sq, acc, inv, g, t);
  }
}

// --------------------------------------------------------------- backward
// delta_i = sum_d dO_i,d * O_i,d for every (b, s, h) row, written [B, H, Sq]:
// D / 8 lanes per row, 16 bytes of O and of dO each, summed in fp32.
template <int D>
__global__ void flash_bwd_bf16_rowdot_kernel(const bf16* __restrict__ o,
                                             const bf16* __restrict__ dout,
                                             float* __restrict__ delta, int rows, int Sq, int H) {
  constexpr int kLanes = D / 8;
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / kLanes;
  const int c = (threadIdx.x % kLanes) * 8;
  float acc = 0.f;
  if (row < rows) {
    const uint4 x = *reinterpret_cast<const uint4*>(o + static_cast<size_t>(row) * D + c);
    const uint4 y = *reinterpret_cast<const uint4*>(dout + static_cast<size_t>(row) * D + c);
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ys[i]));
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && c == 0) {
    const int h = row % H;
    const int s = (row / H) % Sq;
    const int b = row / (H * Sq);
    delta[(static_cast<size_t>(b) * H + h) * Sq + s] = acc;
  }
}

template <int D>
constexpr int bwd_smem() {
  return 2 * kBlockRows * D * 2 + kStages * 2 * kBwdCols * D * 2 + kStages * 2 * kBwdCols * 4 +
         64 + 1024;
}

// dK and dV for one (128-key block, kv head, b): each consumer warpgroup's
// 64 keys are the rows, queries the streamed columns; S^T and dP^T are
// recomputed per query tile.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_bf16_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               bf16* __restrict__ dk, bf16* __restrict__ dv, Geometry geo) {
  using L = Tile<D>;
  constexpr int kKVBytes = kBlockRows * D * 2;
  constexpr int kTileBytes = kBwdCols * D * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* Ks = smem;                          // [kBlockRows][D]
  unsigned char* Vs = Ks + kKVBytes;                 // [kBlockRows][D]
  unsigned char* Qs = Vs + kKVBytes;                 // [kStages][kBwdCols][D]
  unsigned char* Gs = Qs + kStages * kTileBytes;     // [kStages][kBwdCols][D], dO
  float* Ls = reinterpret_cast<float*>(Gs + kStages * kTileBytes);  // [kStages][kBwdCols], lse
  float* Ds = Ls + kStages * kBwdCols;                               // [kStages][kBwdCols], delta
  uint64_t* bars = reinterpret_cast<uint64_t*>(Ds + kStages * kBwdCols);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kBlockRows;
  int r_begin, r_end, first;
  query_range(geo, k0, min(k0 + kBlockRows, geo.Sk), &r_begin, &r_end);
  const int per_head = tile_span<kBwdCols>(r_begin, r_end, &first);
  const int n_tiles = geo.g * per_head;  // (head of the group, q tile), head major

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);               // the producer warp's lanes
      mbar_init(&empty[s], 4 * kConsumers);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // Producer: its first warp; lane 0 issues the copies, every lane stages
    // two of the tile's lse and delta values.
    setmaxnreg_dec<kProducerRegs>();
    const int lane = threadIdx.x % 32;
    if (threadIdx.x < 128 * kConsumers + 32 && n_tiles > 0) {
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * kKVBytes);
        tma_tile<D, kBlockRows>(Ks, &tk, kv_full, kvh, k0, b);
        tma_tile<D, kBlockRows>(Vs, &tv, kv_full, kvh, k0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const int h = kvh * geo.g + j / per_head;
        const int r0 = (first + j % per_head) * kBwdCols;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        const size_t row_off = (static_cast<size_t>(b) * geo.H + h) * geo.Sq;
        for (int i = lane; i < kBwdCols; i += 32) {
          const bool in = r0 + i < geo.Sq;
          Ls[s * kBwdCols + i] = in ? lse[row_off + r0 + i] * kLog2e : 0.f;  // log2 units
          Ds[s * kBwdCols + i] = in ? delta[row_off + r0 + i] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * kTileBytes);
          tma_tile<D, kBwdCols>(Qs + s * kTileBytes, &tq, &full[s], h, r0, b);
          tma_tile<D, kBwdCols>(Gs + s * kTileBytes, &tdo, &full[s], h, r0, b);
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int warp = threadIdx.x / 32 % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int key = k0 + 64 * wg + 16 * warp + g;  // this lane's keys: key, key + 8
    const float scale_log2 = geo.scale * kLog2e;
    int lo[2], hi[2];  // the queries that see each of the lane's keys
    query_bounds(geo, key, &lo[0], &hi[0]);
    query_bounds(geo, key + 8, &lo[1], &hi[1]);
    const uint32_t k_addr = smem_u32(Ks);
    const uint32_t v_addr = smem_u32(Vs);
    float dk_acc[L::kHalves][L::NC / 2], dv_acc[L::kHalves][L::NC / 2];
    zero<D>(dk_acc);
    zero<D>(dv_acc);
    if (n_tiles > 0) mbar_wait(kv_full, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      mbar_wait(&full[s], (j / kStages) & 1);
      const uint32_t q_addr = smem_u32(Qs + s * kTileBytes);
      const uint32_t g_addr = smem_u32(Gs + s * kTileBytes);
      const float* Lt = Ls + s * kBwdCols;
      const float* Dt = Ds + s * kBwdCols;
      const int r0 = (first + j % per_head) * kBwdCols;

      float st[kBwdCols / 2], dpt[kBwdCols / 2];  // S^T and dP^T: rows keys, columns queries
      keep(st);
      keep(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(st, desc_k<D, kBlockRows>(k_addr, 64 * wg, kk),
                 desc_k<D, kBwdCols>(q_addr, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(dpt, desc_k<D, kBlockRows>(v_addr, 64 * wg, kk),
                 desc_k<D, kBwdCols>(g_addr, 0, kk), kk);
      wgmma_commit();
      wgmma_wait_all();
      keep(st);
      keep(dpt);

      // Element i = 4 n + c: key key + 8 (c >> 1), query r0 + 8 n + 2 t + (c & 1).
#pragma unroll
      for (int i = 0; i < kBwdCols / 2; ++i)
        st[i] = ex2(fmaf(st[i], scale_log2, -Lt[8 * (i >> 2) + 2 * t + (i & 1)]));
      if (!all_visible(geo, r0, r0 + kBwdCols, key - g, key - g + 16)) {
#pragma unroll
        for (int i = 0; i < kBwdCols / 2; ++i) {
          const int col = r0 + 8 * (i >> 2) + 2 * t + (i & 1);
          if (col < lo[(i >> 1) & 1] || col >= hi[(i >> 1) & 1]) st[i] = 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < kBwdCols / 2; ++i)  // dS^T, the gradient of the scaled score
        dpt[i] = st[i] * (dpt[i] - Dt[8 * (i >> 2) + 2 * t + (i & 1)]);
      uint32_t pa[kBwdCols / 16][4], sa[kBwdCols / 16][4];
      to_a<kBwdCols>(pa, st);   // P^T rounded to bf16
      to_a<kBwdCols>(sa, dpt);  // dS^T rounded to bf16 (times scale at the end)
      add_product<D, kBwdCols, kBwdCols>(dv_acc, pa, g_addr);  // dV += P^T dO
      add_product<D, kBwdCols, kBwdCols>(dk_acc, sa, q_addr);  // dK += dS^T Q
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    const size_t kv_off = (static_cast<size_t>(b) * geo.Sk * geo.KV + kvh) * D;
    const size_t kv_stride = static_cast<size_t>(geo.KV) * D;
    const float scale[2] = {geo.scale, geo.scale}, one[2] = {1.f, 1.f};
    store_rows<D>(dk + kv_off, kv_stride, key - g, geo.Sk, dk_acc, scale, g, t);
    store_rows<D>(dv + kv_off, kv_stride, key - g, geo.Sk, dv_acc, one, g, t);
  }
}

// dQ for one (128-query block, h, b): each consumer warpgroup's 64 queries
// are the rows, keys the streamed columns (tiles of 64).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_bf16_dq_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             bf16* __restrict__ dq, Geometry geo) {
  using L = Tile<D>;
  constexpr int kQBytes = kBlockRows * D * 2;
  constexpr int kTileBytes = kBwdCols * D * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* Qs = smem;                       // [kBlockRows][D]
  unsigned char* Gs = Qs + kQBytes;               // [kBlockRows][D], dO
  unsigned char* Ks = Gs + kQBytes;               // [kStages][kBwdCols][D]
  unsigned char* Vs = Ks + kStages * kTileBytes;  // [kStages][kBwdCols][D]
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + kStages * kTileBytes);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlockRows;
  int k_begin, k_end, first;
  key_range(geo, q0, min(q0 + kBlockRows, geo.Sq), &k_begin, &k_end);
  const int n_tiles = tile_span<kBwdCols>(k_begin, k_end, &first);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 128 * kConsumers && n_tiles > 0) {
      const int kvh = h / geo.g;
      mbar_expect_tx(q_full, 2 * kQBytes);
      tma_tile<D, kBlockRows>(Qs, &tq, q_full, h, q0, b);
      tma_tile<D, kBlockRows>(Gs, &tdo, q_full, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * kTileBytes);
        const int c0 = (first + j) * kBwdCols;
        tma_tile<D, kBwdCols>(Ks + s * kTileBytes, &tk, &full[s], kvh, c0, b);
        tma_tile<D, kBwdCols>(Vs + s * kTileBytes, &tv, &full[s], kvh, c0, b);
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int warp = threadIdx.x / 32 % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int row = q0 + 64 * wg + 16 * warp + g;  // this lane's rows: row, row + 8
    const float* lb = lse + (static_cast<size_t>(b) * geo.H + h) * geo.Sq;
    const float* db = delta + (static_cast<size_t>(b) * geo.H + h) * geo.Sq;
    float row_lse[2], row_delta[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool in = row + 8 * i < geo.Sq;
      row_lse[i] = in ? lb[row + 8 * i] * kLog2e : 0.f;  // log2 units
      row_delta[i] = in ? db[row + 8 * i] : 0.f;
    }
    const float scale_log2 = geo.scale * kLog2e;
    int lo[2], hi[2];  // the keys each of the lane's rows sees
    key_bounds(geo, row, &lo[0], &hi[0]);
    key_bounds(geo, row + 8, &lo[1], &hi[1]);
    const uint32_t q_addr = smem_u32(Qs);
    const uint32_t g_addr = smem_u32(Gs);
    float dq_acc[L::kHalves][L::NC / 2];
    zero<D>(dq_acc);
    if (n_tiles > 0) mbar_wait(q_full, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      mbar_wait(&full[s], (j / kStages) & 1);
      const uint32_t k_addr = smem_u32(Ks + s * kTileBytes);
      const uint32_t v_addr = smem_u32(Vs + s * kTileBytes);
      const int c0 = (first + j) * kBwdCols;

      float sc[kBwdCols / 2], dp[kBwdCols / 2];
      keep(sc);
      keep(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(sc, desc_k<D, kBlockRows>(q_addr, 64 * wg, kk),
                 desc_k<D, kBwdCols>(k_addr, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(dp, desc_k<D, kBlockRows>(g_addr, 64 * wg, kk),
                 desc_k<D, kBwdCols>(v_addr, 0, kk), kk);
      wgmma_commit();
      wgmma_wait_all();
      keep(sc);
      keep(dp);

      // Element i = 4 n + c: query row + 8 (c >> 1), key c0 + 8 n + 2 t + (c & 1).
#pragma unroll
      for (int i = 0; i < kBwdCols / 2; ++i)
        sc[i] = ex2(fmaf(sc[i], scale_log2, -row_lse[(i >> 1) & 1]));
      if (!all_visible(geo, row - g, row - g + 16, c0, c0 + kBwdCols)) {
#pragma unroll
        for (int i = 0; i < kBwdCols / 2; ++i) {
          const int col = c0 + 8 * (i >> 2) + 2 * t + (i & 1);
          if (col < lo[(i >> 1) & 1] || col >= hi[(i >> 1) & 1]) sc[i] = 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < kBwdCols / 2; ++i)  // dS
        sc[i] = sc[i] * (dp[i] - row_delta[(i >> 1) & 1]);
      uint32_t sa[kBwdCols / 16][4];
      to_a<kBwdCols>(sa, sc);  // dS rounded to bf16 (times scale at the end)
      add_product<D, kBwdCols, kBwdCols>(dq_acc, sa, k_addr);  // dQ += dS K
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    const float scale[2] = {geo.scale, geo.scale};
    store_rows<D>(dq + (static_cast<size_t>(b) * geo.Sq * geo.H + h) * D,
                  static_cast<size_t>(geo.H) * D, row - g, geo.Sq, dq_acc, scale, g, t);
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

// A [B, S, heads, D] bf16 tensor as a 4-D tensor map (innermost first: D,
// heads, S, B), read in boxes of NC columns x 1 head x 64 rows that land
// swizzled as the wgmma descriptors read them; rows past S read zeros.
template <int D>
cudaError_t make_map(CUtensorMap* map, const void* base, int B, int S, int heads) {
  using L = Tile<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(heads) * D * 2,
                                 static_cast<cuuint64_t>(S) * heads * D * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(L::NC), 1, kBox, 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  const CUresult r =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
             steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
             L::NC == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t fwd(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int B,
                const Geometry& geo, cudaStream_t stream) {
  // A runtime call first: it makes the device's context current on this
  // thread (an autograd thread may have none), which the encoder needs.
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, fwd_smem<D>());
  CUtensorMap tq, tk, tv;
  if (err == cudaSuccess) err = make_map<D>(&tq, q, B, geo.Sq, geo.H);
  if (err == cudaSuccess) err = make_map<D>(&tk, k, B, geo.Sk, geo.KV);
  if (err == cudaSuccess) err = make_map<D>(&tv, v, B, geo.Sk, geo.KV);
  if (err != cudaSuccess) return err;
  const dim3 grid(geo.H, B, (geo.Sq + kBlockRows - 1) / kBlockRows);
  flash_fwd_bf16_kernel<D><<<grid, kThreads, fwd_smem<D>(), stream>>>(tq, tk, tv, o, lse, geo);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
                const float* lse, float* delta, bf16* dq, bf16* dk, bf16* dv, int B,
                const Geometry& geo, cudaStream_t stream) {
  const int rows = B * geo.Sq * geo.H;
  constexpr int kRowThreads = 256;
  const int row_blocks = static_cast<int>((static_cast<int64_t>(rows) * (D / 8) + kRowThreads - 1) /
                                          kRowThreads);
  // Runtime calls first, as in fwd: the encoder needs a current context.
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_bf16_dkdv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bwd_smem<D>());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_bf16_dq_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bwd_smem<D>());
  CUtensorMap tq, tk, tv, tdo;
  if (err == cudaSuccess) err = make_map<D>(&tq, q, B, geo.Sq, geo.H);
  if (err == cudaSuccess) err = make_map<D>(&tdo, dout, B, geo.Sq, geo.H);
  if (err == cudaSuccess) err = make_map<D>(&tk, k, B, geo.Sk, geo.KV);
  if (err == cudaSuccess) err = make_map<D>(&tv, v, B, geo.Sk, geo.KV);
  if (err != cudaSuccess) return err;
  flash_bwd_bf16_rowdot_kernel<D><<<row_blocks, kRowThreads, 0, stream>>>(o, dout, delta, rows,
                                                                          geo.Sq, geo.H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_kv(geo.KV, B, (geo.Sk + kBlockRows - 1) / kBlockRows);
  flash_bwd_bf16_dkdv_kernel<D><<<grid_kv, kThreads, bwd_smem<D>(), stream>>>(
      tq, tk, tv, tdo, lse, delta, dk, dv, geo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q(geo.H, B, (geo.Sq + kBlockRows - 1) / kBlockRows);
  flash_bwd_bf16_dq_kernel<D><<<grid_q, kThreads, bwd_smem<D>(), stream>>>(tq, tk, tv, tdo, lse,
                                                                           delta, dq, geo);
  return cudaGetLastError();
}

Geometry make_geometry(int Sq, int Sk, int H, int KV, int causal, int window, int q_offset,
                       float scale) {
  Geometry geo;
  geo.Sq = Sq;
  geo.Sk = Sk;
  geo.H = H;
  geo.KV = KV;
  geo.g = H / KV;
  geo.causal = causal;
  geo.window = window;
  geo.q_offset = q_offset;
  geo.scale = scale;
  return geo;
}

bool bad_shape(int B, int Sq, int Sk, int H, int KV, int D) {
  return B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 || B > 65535 ||
         (Sq + kBlockRows - 1) / kBlockRows > 65535 || (Sk + kBlockRows - 1) / kBlockRows > 65535 ||
         !(D == 32 || D == 64 || D == 128);
}

}  // namespace

// Forward: q [B,Sq,H,D], k/v [B,Sk,KV,D] bf16 -> o [B,Sq,H,D] bf16, lse
// [B,H,Sq] fp32.  Needs H % KV == 0, D in {32, 64, 128}, B and the query
// tiles at most 65535, and 16-byte aligned tensors (the Python wrapper
// checks).
extern "C" int flash_attention_bf16_fwd_launch(const void* q, const void* k, const void* v,
                                               void* o, void* lse, int B, int Sq, int Sk, int H,
                                               int KV, int D, int causal, int window,
                                               int q_offset, float scale, void* stream) {
  if (bad_shape(B, Sq, Sk, H, KV, D)) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry geo = make_geometry(Sq, Sk, H, KV, causal, window, q_offset, scale);
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  auto* op = static_cast<bf16*>(o);
  auto* lp = static_cast<float*>(lse);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 32) err = fwd<32>(qp, kp, vp, op, lp, B, geo, st);
  else if (D == 64) err = fwd<64>(qp, kp, vp, op, lp, B, geo, st);
  else err = fwd<128>(qp, kp, vp, op, lp, B, geo, st);
  return static_cast<int>(err);
}

// Backward: from bf16 q, k, v, o, dO and the forward's fp32 lse, with
// `delta` a [B,H,Sq] fp32 scratch buffer, write bf16 dq [B,Sq,H,D] and dk,
// dv [B,Sk,KV,D].  The same shape limits as the forward.
extern "C" int flash_attention_bf16_bwd_launch(const void* q, const void* k, const void* v,
                                               const void* o, const void* dout, const void* lse,
                                               void* delta, void* dq, void* dk, void* dv, int B,
                                               int Sq, int Sk, int H, int KV, int D, int causal,
                                               int window, int q_offset, float scale,
                                               void* stream) {
  if (bad_shape(B, Sq, Sk, H, KV, D)) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry geo = make_geometry(Sq, Sk, H, KV, causal, window, q_offset, scale);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  const auto* op = static_cast<const bf16*>(o);
  const auto* gp = static_cast<const bf16*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  auto* dp = static_cast<float*>(delta);
  auto* dqp = static_cast<bf16*>(dq);
  auto* dkp = static_cast<bf16*>(dk);
  auto* dvp = static_cast<bf16*>(dv);
  cudaError_t err;
  if (D == 32) err = bwd<32>(qp, kp, vp, op, gp, lp, dp, dqp, dkp, dvp, B, geo, st);
  else if (D == 64) err = bwd<64>(qp, kp, vp, op, gp, lp, dp, dqp, dkp, dvp, B, geo, st);
  else err = bwd<128>(qp, kp, vp, op, gp, lp, dp, dqp, dkp, dvp, B, geo, st);
  return static_cast<int>(err);
}
