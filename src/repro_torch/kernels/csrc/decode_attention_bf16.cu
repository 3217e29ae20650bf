// Single-token decode attention for Hopper (sm_90a) at bfloat16: the port of
// the Pallas kernel repro/kernels/decode_attention.py::decode_attention_pallas
// (_decode_kernel, :29, launched by its pallas_call at :104) in the dtype the
// reference's models run it at (every configuration defaults to bfloat16),
// where the TPU kernel widens its operands to fp32, sums in fp32 and rounds
// its output back to bf16 (decode_attention.py:50-52,78).
//
//     q [B, 1, H, D], k_cache / v_cache [B, W, KV, D], out [B, 1, H, D] bf16;
//     valid [B, W] bytes (row stride 0 broadcasts one [W] mask);
//     query head h reads kv head h / g, g = H / KV (GQA);
//     out[b, h] = sum_w p_w v[b, w, h / g],  p = softmax over the valid w of
//     scale * q . k (scale = 1/sqrt(D)); a row with no valid slot gives
//     exact zeros (the reference's empty-cache rule).
// D is a multiple of 8 from 64 to 128 (the zoo's 64 and 128).
//
// Precision: a product of two bf16 values is exact in fp32, so S = Q K^T on
// the tensor cores (bf16 operands, fp32 accumulator) is the reference's
// dot_general of the widened operands up to the order of the sum.  P V
// rounds P to bf16 for one pass, as the bf16 flash forward does (about 2^-9
// relative a weight); the row sum l adds the unrounded fp32 weights; the
// output is rounded to bf16 once.
//
// Bound on the H100: bytes, 2 an element.  A call reads q, the K and V rows
// of the valid slots and the mask once and writes out: at Nemotron-4's
// serve step [2, 1, 48/8, 128], W 528, all valid, 4.3 MB, 0.001123 ms at
// 3.35 TB/s, against 4 * H * D * W = 26 MFLOP (0.00003 ms on the tensor
// cores).  An empty kernel takes 0.00087 ms (the launch floor; NVIDIA H100
// 80GB HBM3 at 700.00 W, as every time in this note).  So a call is neither
// bytes nor operations: it is latency.  The design it replaces
// (kernels/variants/decode_attention_bf16_simt.cu) took 0.01415 ms there, in
// about six dependent device-memory round trips and a dozen block
// barriers: a warp's rows in registers U at a time, 5 shuffle rounds a
// score, a merge of 8 warps a head at a time, then a workspace, a fence, a
// ticket and a second read of every split by the last block.  This design
// cuts the critical path to one round trip for q and the mask, one for all
// of a block's K and V tiles, the products, and a merge inside a cluster:
//
// * Grid and clusters.  A cluster of `cluster` blocks (launched with
//   cudaLaunchKernelEx and a cluster-dimension attribute; the rank is the
//   block's %cluster_ctarank) serves one (b, kv head, chunk of up to 16
//   query heads) group.  The window is cut into tiles of 64 slots, and rank
//   r takes tiles [r T / cluster, (r + 1) T / cluster).  Each block carries
//   all the query heads of its chunk, so a K or V row is read once for all
//   the heads that share it.  kernels/decode_attention.py::bf16_decode_plan
//   picks the cluster size (one wave on 132 SMs, every rank at least one
//   tile) and the stages.
// * Loads.  All 160 threads read the chunk's q rows (16-byte loads, zeros
//   past the heads and D) and the rank's mask bytes (ballots into one 64-bit
//   word a tile) at once: the mask's bytes lie at any offset, which a bulk
//   copy does not take.  Then one thread of the producer warp issues each
//   tile that holds a valid slot as TMA boxes of [64 slots, 64 columns] of
//   K and of V (a 4-D tensor map over [B, W, KV, D]: slot stride KV * D,
//   128 contiguous bytes a box row; rows past W and columns past D land as
//   zeros), 128-byte swizzled, into a ring of `stages` stages, each tile
//   against its stage's full mbarrier.  At the serve steps every tile of a
//   block is in flight at once; a longer share cycles the ring, the
//   consumers releasing a stage through its empty mbarrier.  A tile with no
//   valid slot (a ragged prefix's tail, a ring buffer's unused arc) is
//   never loaded.  The tensor maps are encoded on the host for each call by
//   cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (no
//   -lcuda), and passed as __grid_constant__ parameters.
// * Products.  Four consumer warps take 16 slots of each tile apiece.  A
//   warp computes S = Q K^T for [16 heads, 16 slots] on mma.sync m16n8k16
//   (the chunk's heads padded to 16 rows with zeros, Q's A fragments read
//   once by ldmatrix, K's B fragments by ldmatrix from the swizzled tile),
//   masks and folds it into its online softmax in fp32 registers (exp2 of
//   scores pre-scaled by scale * log2 e), packs P to bf16 pairs, which is
//   the A-fragment layout of the accumulators it came from, and computes
//   P V on mma.sync with V's B fragments by ldmatrix.trans.  wgmma would
//   waste 58 of its 64 rows at g = 6 (and 63 at g = 1), and its products
//   are not what bounds a call, so mma.sync is the unit here.  A warp whose
//   16 slots of a tile are all invalid skips the tile's products.
// * Merge.  The four warps' states (m, l, acc [16, D]) go through shared
//   memory (the stage area, free once the last tile is consumed) and are
//   merged in warp order; the block leaves its merged state in its own
//   shared memory, then one cluster barrier (barrier.cluster arrive.release
//   / wait.acquire).  Rank r merges its 1/cluster share of the chunk's
//   [heads, D] output from every rank's state through distributed shared
//   memory (mapa, ld.shared::cluster), in rank order, and writes it as bf16
//   once; one more cluster barrier keeps every block's shared memory alive
//   until all have read it.  No device-memory workspace, no ticket, no
//   fence and no atomic: the wrapper allocates only the output.  Every sum
//   runs in a fixed order, so a call is bitwise repeatable.  A block with
//   no valid slot carries m = -1e30, l = 0; a row whose every l is 0 gives
//   exact zeros.  The kernel launches on the caller's stream and allocates
//   nothing.

#include <cuda.h>  // CUtensorMap and its enums (types only: the driver is reached at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;       // slots of a tile, and rows of a TMA box
constexpr int kBox = 64;        // columns of a TMA box: 128 bytes, swizzled over 128
constexpr int kRows = 16;       // query heads of a chunk: the m16n8k16 rows
constexpr int kConsumers = 4;   // warps, 16 slots of each tile apiece
constexpr int kThreads = 32 * (kConsumers + 1);  // and the producer warp
constexpr int kMaxCluster = 16;
constexpr int kMaxStages = 8;
constexpr int kBlockSmem = 232448;  // 227 KB, the most a block may ask for
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// The dynamic shared memory of a block, from its first 1024-byte boundary:
// the ring's stages (a K tile then a V tile, each DP / 64 swizzled boxes of
// 8 KB), the block's merged acc [16][DP] fp32, the warps' and the block's m
// and l, Q [16][DP + 8] bf16, the rank's mask words (one a tile) and the
// stages' full and empty mbarriers (kernels/decode_attention.py::
// bf16_decode_smem mirrors it).
template <int DP>
struct Layout {
  static constexpr int kStage = 2 * kTile * DP * 2;
  static constexpr int kMerged = kRows * DP * 4;
  static constexpr int kStats = (2 * kConsumers + 2) * kRows * 4;
  static constexpr int kQPitch = DP + 8;
  static constexpr int kQ = kRows * kQPitch * 2;
  static_assert(kStage >= kConsumers * kRows * DP * 4, "the warps' states reuse one stage");

  static constexpr size_t bytes(int stages, int per_rank) {
    return 1024 + static_cast<size_t>(stages) * kStage + kMerged + kStats + kQ + 8 * per_rank +
           16 * stages;
  }
};

// ------------------------------------------------ barriers, TMA, mma
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A swizzled box's pattern repeats every 1024 bytes, counted from there.
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

// One TMA box of a [B, W, KV, D] tensor map, at (column, kv head, slot, b).
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, uint64_t* bar, int col,
                                        int head, int slot, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(head), "r"(slot), "r"(b),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}

// The address of `addr` (this block's shared memory) in rank `rank`'s.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float2 ld_cluster2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a b on mma.sync m16n8k16 (bf16 operands, fp32 accumulator).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The byte address of (slot, column) of a [kTile][DP] tile that landed as
// DP / 64 boxes of [64 slots][128 bytes], each 16-byte chunk c of a row
// stored at chunk c ^ (slot % 8) (TMA's 128-byte swizzle).
__device__ __forceinline__ uint32_t tile_addr(uint32_t tile, int slot, int col) {
  return tile + (col >> 6) * (kTile * 128) + slot * 128 +
         ((((col >> 3) & 7) ^ (slot & 7)) << 4) + (col & 7) * 2;
}

// A warp's state rows through shared memory: element pair c2 of row j at
// pair c2 ^ 4 (j % 8), so that the 8 rows a store touches hit 2 wavefronts.
__device__ __forceinline__ int state_pair(int j, int c2) { return c2 ^ ((j & 7) << 2); }

// ------------------------------------------------------------------ kernel
template <int DP>
__global__ void __launch_bounds__(kThreads, 2)
    decode_bf16_kernel(const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const bf16* __restrict__ q,
                       const uint8_t* __restrict__ valid, bf16* __restrict__ out, int W, int H,
                       int KV, int D, int valid_row_stride, int cluster, int stages,
                       int per_rank, float scale_log2) {
  using L = Layout<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* stage_base = aligned_smem(smem_raw);
  float* merged = reinterpret_cast<float*>(stage_base + static_cast<size_t>(stages) * L::kStage);
  float* warp_m = merged + kRows * DP;  // [kConsumers][kRows]
  float* warp_l = warp_m + kConsumers * kRows;
  float* block_m = warp_l + kConsumers * kRows;  // [kRows]
  float* block_l = block_m + kRows;
  bf16* qs = reinterpret_cast<bf16*>(block_l + kRows);
  uint64_t* words = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(qs) + L::kQ);
  uint64_t* full = words + per_rank;
  uint64_t* empty = full + stages;

  const int g = H / KV;
  const int chunks = (g + kRows - 1) / kRows;
  const int rank = blockIdx.x % cluster;
  const int group = blockIdx.x / cluster;  // (b * KV + kv head) * chunks + chunk
  const int pair = group / chunks;
  const int kvh = pair % KV;
  const int b = pair / KV;
  const int j0 = group % chunks * kRows;  // first head of the chunk, within the group
  const int nh = min(kRows, g - j0);
  const int h0 = kvh * g + j0;
  const int tiles = (W + kTile - 1) / kTile;
  const int t0 = static_cast<int>(static_cast<long long>(rank) * tiles / cluster);
  const int nt = static_cast<int>(static_cast<long long>(rank + 1) * tiles / cluster) - t0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  // The chunk's q rows, zeros past its heads and past D.
  const bf16* qb = q + (static_cast<size_t>(b) * H + h0) * D;
  for (int i = threadIdx.x; i < kRows * DP / 8; i += kThreads) {
    const int r = i / (DP / 8), c = i % (DP / 8);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < nh && 8 * c < D) v = *reinterpret_cast<const uint4*>(qb + static_cast<size_t>(r) * D + 8 * c);
    *reinterpret_cast<uint4*>(qs + r * L::kQPitch + 8 * c) = v;
  }
  // The rank's mask words: half h of the share (32 slots) is one ballot,
  // eight halves' bytes a warp in flight at once.
  const uint8_t* mrow = valid + static_cast<size_t>(b) * valid_row_stride;
  uint32_t* halves = reinterpret_cast<uint32_t*>(words);
  for (int h8 = warp; h8 < 2 * nt; h8 += 8 * (kConsumers + 1)) {
    bool on[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int h = h8 + u * (kConsumers + 1);
      const int slot = 2 * t0 * 32 + h * 32 + lane;
      on[u] = h < 2 * nt && slot < W && mrow[slot] != 0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int h = h8 + u * (kConsumers + 1);
      const unsigned bits = __ballot_sync(0xffffffffu, on[u]);
      if (lane == 0 && h < 2 * nt) halves[h] = bits;  // little-endian: word h / 2, half h % 2
    }
  }
  __syncthreads();

  if (warp == kConsumers) {
    // The producer: every tile with a valid slot, through the ring.
    if (lane == 0) {
      int i = 0;
      for (int t = 0; t < nt; ++t) {
        if (words[t] == 0) continue;
        const int s = i % stages;
        if (i >= stages) mbar_wait(&empty[s], (i / stages + 1) & 1);
        mbar_expect_tx(&full[s], L::kStage);
        unsigned char* kt = stage_base + static_cast<size_t>(s) * L::kStage;
        unsigned char* vt = kt + L::kStage / 2;
        const int slot = (t0 + t) * kTile;
#pragma unroll
        for (int c = 0; c < DP / kBox; ++c) {
          tma_box(kt + c * kTile * 128, &tk, &full[s], c * kBox, kvh, slot, b);
          tma_box(vt + c * kTile * 128, &tv, &full[s], c * kBox, kvh, slot, b);
        }
        ++i;
      }
    }
    __syncwarp();
    __syncthreads();  // the consumers are done with the stages
    __syncthreads();  // and have left their states there
  } else {
    // Q's A fragments: rows (mi & 1) * 8 + lane % 8, columns 16 ks + (mi >> 1) * 8.
    const int mi = lane >> 3;
    uint32_t qa[DP / 16][4];
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks)
      ldmatrix_x4(qa[ks], smem_u32(qs + ((mi & 1) * 8 + (lane & 7)) * L::kQPitch + 16 * ks +
                                   (mi >> 1) * 8));
    float acc[DP / 8][4];
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // rows lane / 4 and lane / 4 + 8
    const int slot0 = 16 * warp;
    int i = 0;
    for (int t = 0; t < nt; ++t) {
      const uint64_t word = words[t];
      if (word == 0) continue;
      const int s = i % stages;
      mbar_wait(&full[s], (i / stages) & 1);
      const uint32_t bits = static_cast<uint32_t>(word >> slot0) & 0xffffu;
      if (bits) {
        const uint32_t kt = smem_u32(stage_base + static_cast<size_t>(s) * L::kStage);
        const uint32_t vt = kt + L::kStage / 2;
        // S [16 heads, 16 slots]: K's B fragments, slots slot0 + (mi >> 1) * 8 + lane % 8.
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int ks = 0; ks < DP / 16; ++ks) {
          uint32_t kb[4];
          ldmatrix_x4(kb, tile_addr(kt, slot0 + (mi >> 1) * 8 + (lane & 7), 16 * ks + (mi & 1) * 8));
          mma_bf16(sc[0], qa[ks], kb[0], kb[1]);
          mma_bf16(sc[1], qa[ks], kb[2], kb[3]);
        }
        // The masked online softmax of rows lane / 4 (e < 2) and + 8.
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * n + 2 * (lane & 3) + (e & 1);
            sc[n][e] = (bits >> col) & 1u ? sc[n][e] * scale_log2 : -INFINITY;
            mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
          }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          alpha[r] = exp2f(m[r] - mx[r]);
          m[r] = mx[r];
          l[r] *= alpha[r];
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sc[n][e] = exp2f(sc[n][e] - m[e >> 1]);  // 0 where masked
            l[e >> 1] += sc[n][e];
          }
#pragma unroll
        for (int n = 0; n < DP / 8; ++n) {
          acc[n][0] *= alpha[0];
          acc[n][1] *= alpha[0];
          acc[n][2] *= alpha[1];
          acc[n][3] *= alpha[1];
        }
        // P as the A fragment over the 16 slots, rounded to bf16.
        const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
                                pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};
        // P V: V's B fragments by ldmatrix.trans, slots slot0 + (mi & 1) * 8 + lane % 8.
#pragma unroll
        for (int n2 = 0; n2 < DP / 16; ++n2) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, tile_addr(vt, slot0 + (mi & 1) * 8 + (lane & 7), 16 * n2 + (mi >> 1) * 8));
          mma_bf16(acc[2 * n2], pa, vb[0], vb[1]);
          mma_bf16(acc[2 * n2 + 1], pa, vb[2], vb[3]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      ++i;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    __syncthreads();  // every warp is done with the stages
    float* ws = reinterpret_cast<float*>(stage_base) + warp * kRows * DP;
    const int r0 = lane >> 2;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int c2 = 4 * n + (lane & 3);
      *reinterpret_cast<float2*>(ws + r0 * DP + 2 * state_pair(r0, c2)) = make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(ws + (r0 + 8) * DP + 2 * state_pair(r0 + 8, c2)) =
          make_float2(acc[n][2], acc[n][3]);
    }
    if ((lane & 3) == 0) {
      warp_m[warp * kRows + r0] = m[0];
      warp_m[warp * kRows + r0 + 8] = m[1];
      warp_l[warp * kRows + r0] = l[0];
      warp_l[warp * kRows + r0 + 8] = l[1];
    }
    __syncthreads();
  }

  // The block's state: the warps' merged in warp order, D's pairs a thread.
  const int pairs = D / 2;
  const float* ws = reinterpret_cast<const float*>(stage_base);
  for (int p = threadIdx.x; p < nh * pairs; p += kThreads) {
    const int j = p / pairs, c2 = p % pairs;
    float mb = kNegInf;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) mb = fmaxf(mb, warp_m[w * kRows + j]);
    float lb = 0.f;
    float2 a = make_float2(0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) {
      const float f = exp2f(warp_m[w * kRows + j] - mb);
      lb += f * warp_l[w * kRows + j];
      const float2 x = *reinterpret_cast<const float2*>(ws + (w * kRows + j) * DP + 2 * state_pair(j, c2));
      a.x += f * x.x;
      a.y += f * x.y;
    }
    *reinterpret_cast<float2*>(merged + j * DP + 2 * c2) = a;
    if (c2 == 0) {
      block_m[j] = mb;
      block_l[j] = lb;
    }
  }
  __syncwarp();
  cluster_sync();

  // Rank `rank`'s share of the chunk's output, merged over the ranks in
  // rank order through distributed shared memory, rounded to bf16 once.
  const int total = nh * pairs;
  const int p0 = static_cast<int>(static_cast<long long>(rank) * total / cluster);
  const int p1 = static_cast<int>(static_cast<long long>(rank + 1) * total / cluster);
  bf16* ob = out + (static_cast<size_t>(b) * H + h0) * D;
  for (int p = p0 + threadIdx.x; p < p1; p += kThreads) {
    const int j = p / pairs, c2 = p % pairs;
    const uint32_t at_m = smem_u32(block_m + j), at_l = smem_u32(block_l + j);
    const uint32_t at_a = smem_u32(merged + j * DP + 2 * c2);
    float mx = kNegInf;
    for (int r = 0; r < cluster; ++r) mx = fmaxf(mx, ld_cluster(map_rank(at_m, r)));
    float lt = 0.f;
    float2 o = make_float2(0.f, 0.f);
    for (int r = 0; r < cluster; ++r) {
      const float f = exp2f(ld_cluster(map_rank(at_m, r)) - mx);
      lt += f * ld_cluster(map_rank(at_l, r));
      const float2 a = ld_cluster2(map_rank(at_a, r));
      o.x += f * a.x;
      o.y += f * a.y;
    }
    // l == 0 iff no slot was valid: attention over an empty cache is zeros.
    reinterpret_cast<__nv_bfloat162*>(ob)[p] =
        lt > 0.f ? __floats2bfloat162_rn(o.x / lt, o.y / lt) : __floats2bfloat162_rn(0.f, 0.f);
  }
  __syncwarp();
  cluster_sync();  // no block leaves while another may read its state
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

// A [B, W, KV, D] bf16 cache as a 4-D tensor map (innermost first: D, KV,
// W, B), read in boxes of 64 columns x 1 head x 64 slots that land 128-byte
// swizzled; slots past W and columns past D read zeros.
cudaError_t make_map(CUtensorMap* map, const void* base, int B, int W, int KV, int D) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(KV),
                              static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(KV) * D * 2,
                                 static_cast<cuuint64_t>(W) * KV * D * 2};
  const cuuint32_t box[4] = {kBox, 1, kTile, 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  const CUresult r =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
             steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DP>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const uint8_t* valid, bf16* out,
                   int B, int W, int H, int KV, int D, int valid_row_stride, int cluster,
                   int stages, float scale, cudaStream_t stream) {
  const int g = H / KV;
  const long long blocks = static_cast<long long>(B) * KV * ((g + kRows - 1) / kRows) * cluster;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int tiles = (W + kTile - 1) / kTile;
  const int per_rank = (tiles + cluster - 1) / cluster;
  const size_t smem = Layout<DP>::bytes(stages, per_rank);
  if (smem > static_cast<size_t>(kBlockSmem)) return cudaErrorInvalidValue;
  const auto kernel = decode_bf16_kernel<DP>;
  // A runtime call first: it makes the device's context current on this
  // thread, which the encoder needs.  The limit is the same on every call
  // (the most a block may ask for), never this call's size: the attribute is
  // the kernel's, shared by every thread, so a size set for one shape could
  // refuse another thread's launch of a larger one between its set and its
  // launch.
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBlockSmem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  CUtensorMap tk, tv;
  if (err == cudaSuccess) err = make_map(&tk, k, B, W, KV, D);
  if (err == cudaSuccess) err = make_map(&tv, v, B, W, KV, D);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(blocks));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, tk, tv, q, valid, out, W, H, KV, D, valid_row_stride,
                           cluster, stages, per_rank, scale * kLog2e);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// q [B,1,H,D], k/v [B,W,KV,D] bf16, valid [B,W] uint8 (row stride 0 or W),
// out [B,1,H,D] bf16.  Needs H % KV == 0, D % 8 == 0, 64 <= D <= 128,
// 1 <= cluster <= 16, 1 <= stages <= 8, shared memory within 227 KB and
// 16-byte-aligned q, k, v (the Python wrapper checks, and picks cluster and
// stages: decode_attention.py::bf16_decode_plan).
extern "C" int decode_attention_bf16_launch(const void* q, const void* k, const void* v,
                                            const void* valid, void* out, int B, int W, int H,
                                            int KV, int D, int valid_row_stride, int cluster,
                                            int stages, float scale, void* stream) {
  if (B <= 0 || W <= 0 || KV <= 0 || H % KV != 0 || D % 8 != 0 || D < 64 || D > 128 ||
      cluster < 1 || cluster > kMaxCluster || stages < 1 || stages > kMaxStages) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  const auto* mp = static_cast<const uint8_t*>(valid);
  auto* op = static_cast<bf16*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      D <= 64 ? launch<64>(qp, kp, vp, mp, op, B, W, H, KV, D, valid_row_stride, cluster, stages,
                           scale, st)
              : launch<128>(qp, kp, vp, mp, op, B, W, H, KV, D, valid_row_stride, cluster, stages,
                            scale, st);
  return static_cast<int>(err);
}
