// Design (b) of the bf16 flash backward's dQ, kept to be timed beside the
// shipped design (python -m repro_torch.kernels.flash_variants --bf16) and
// never linked into the library.  The shipped backward computes S and dP
// twice, once in its dK/dV kernel and again in its own dQ kernel (14 * D
// flops a visible pair).  Here the dK/dV kernel also computes dQ: it writes
// each tile's dS^T, rounded to bf16, to shared memory (128 keys x 64
// queries, 128-byte swizzled), and each consumer warpgroup multiplies it by
// one 64-column box of the block's K (wgmma, both operands MN-major), a
// fp32 partial of dQ for the tile's 64 queries from the block's 128 keys.
// The partials are added into an fp32 workspace in a fixed key-block order,
// so that two calls give the same bits: a semaphore for each (b, h, 64-query
// tile) counts the key blocks that have added theirs, and a block waits
// until every key block before it that visits the tile has.  The blocks
// stream their query tiles in query order, a group's heads inner, so a
// block trails the one before it by a tile.  A last pass rounds dQ x scale
// to bf16.  10 * D flops a visible pair, against 64 x D x 8 bytes of fp32
// read and written a tile.  D is 64 or 128 (the boxes of D are the
// warpgroups' dQ columns; D = 32 is refused).  The workspace (fp32 dQ and
// the semaphores) is the one allocation: cudaMalloc'd on the first call
// that needs more and kept, zeroed on the caller's stream each call.
//
// Its entry point, flash_attention_bf16_dq_fused_bwd_launch, takes the
// arguments of the shipped flash_attention_bf16_bwd_launch; the forward is
// the shipped one (this source includes it).

#include "../csrc/flash_attention_bf16.cu"

namespace {

// d (+)= a b, m64n64k16: a and b both MN-major in shared memory.
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// Shared-memory stores made visible to wgmma's reads (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The two consumer warpgroups (256 threads) meet.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Whether the key block at k0 visits query tile r0 (kBwdCols rows).
__device__ __forceinline__ bool visits(const Geometry& geo, int k0, int r0) {
  int r_begin, r_end, first;
  query_range(geo, k0, min(k0 + kBlockRows, geo.Sk), &r_begin, &r_end);
  const int n = tile_span<kBwdCols>(r_begin, r_end, &first);
  return r0 / kBwdCols >= first && r0 / kBwdCols < first + n;
}

template <int D>
constexpr int fused_smem() {
  return bwd_smem<D>() + kBlockRows * kBwdCols * 2;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_bf16_fused_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tdo,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                bf16* __restrict__ dk, bf16* __restrict__ dv,
                                float* __restrict__ dq_acc, int* __restrict__ sems,
                                Geometry geo) {
  using L = Tile<D>;
  static_assert(L::NC == 64, "dQ's columns are 64-column boxes");
  constexpr int kKVBytes = kBlockRows * D * 2;
  constexpr int kTileBytes = kBwdCols * D * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* Ks = smem;
  unsigned char* Vs = Ks + kKVBytes;
  unsigned char* Qs = Vs + kKVBytes;
  unsigned char* Gs = Qs + kStages * kTileBytes;
  unsigned char* Ss = Gs + kStages * kTileBytes;  // dS^T [kBlockRows keys][kBwdCols queries]
  float* Ls = reinterpret_cast<float*>(Ss + kBlockRows * kBwdCols * 2);
  float* Ds = Ls + kStages * kBwdCols;
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
  const int n_tiles = geo.g * per_head;  // (q tile, head of the group), heads inner

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 4 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
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
        const int h = kvh * geo.g + j % geo.g;
        const int r0 = (first + j / geo.g) * kBwdCols;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        const size_t row_off = (static_cast<size_t>(b) * geo.H + h) * geo.Sq;
        for (int i = lane; i < kBwdCols; i += 32) {
          const bool in = r0 + i < geo.Sq;
          Ls[s * kBwdCols + i] = in ? lse[row_off + r0 + i] * kLog2e : 0.f;
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
    const int key = k0 + 64 * wg + 16 * warp + g;
    const float scale_log2 = geo.scale * kLog2e;
    int lo[2], hi[2];
    query_bounds(geo, key, &lo[0], &hi[0]);
    query_bounds(geo, key + 8, &lo[1], &hi[1]);
    const uint32_t k_addr = smem_u32(Ks);
    const uint32_t v_addr = smem_u32(Vs);
    const uint32_t s_addr = smem_u32(Ss);
    const int n_qtiles = (geo.Sq + kBwdCols - 1) / kBwdCols;
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
      const int h = kvh * geo.g + j % geo.g;
      const int r0 = (first + j / geo.g) * kBwdCols;

      float st[kBwdCols / 2], dpt[kBwdCols / 2];
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
      for (int i = 0; i < kBwdCols / 2; ++i)
        dpt[i] = st[i] * (dpt[i] - Dt[8 * (i >> 2) + 2 * t + (i & 1)]);
      uint32_t pa[kBwdCols / 16][4], sa[kBwdCols / 16][4];
      to_a<kBwdCols>(pa, st);
      to_a<kBwdCols>(sa, dpt);
      // dS^T into shared memory, 128-byte swizzled rows of 64 queries: a
      // lane's pair (key r, queries c, c + 1) at r 128 + ((c / 8) ^ (r % 8)) 16 + (c % 8) 2.
#pragma unroll
      for (int kk = 0; kk < kBwdCols / 16; ++kk)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = 64 * wg + 16 * warp + g + 8 * (c & 1);
          const int col = 16 * kk + 8 * (c >> 1) + 2 * t;
          *reinterpret_cast<uint32_t*>(Ss + r * 128 + (((col >> 3) ^ (r & 7)) << 4) +
                                       (col & 7) * 2) = sa[kk][c];
        }
      add_product<D, kBwdCols, kBwdCols>(dv_acc, pa, g_addr);
      add_product<D, kBwdCols, kBwdCols>(dk_acc, sa, q_addr);
      fence_proxy_async();
      consumers_sync();  // both warpgroups' dS^T written; stage s read
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);

      // dQ partial for queries [r0, r0 + 64), columns of box wg: dS (64 x
      // 128 keys, read transposed from dS^T) times K's box.
      float part[32];
      const bool has_box = wg < L::kHalves;
      if (has_box) {
        keep(part);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlockRows / 16; ++kk)
          wgmma_ss_tt(part, smem_desc<D>(s_addr + 16 * kk * 128),
                      desc_mn<D, kBlockRows>(k_addr, wg, kk), kk);
        wgmma_commit();
        wgmma_wait_all();
        keep(part);
      }
      // Add it in key-block order.
      int* sem = sems + (static_cast<size_t>(b) * geo.H + h) * n_qtiles + r0 / kBwdCols;
      if (threadIdx.x == 0) {
        int before = 0;
        for (int c0 = 0; c0 < k0; c0 += kBlockRows) before += visits(geo, c0, r0);
        while (load_acquire(sem) != before) {
        }
      }
      consumers_sync();
      if (has_box) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int q = r0 + 16 * warp + g + 8 * half;
          if (q < geo.Sq) {
            float* row = dq_acc + (static_cast<size_t>(b) * geo.Sq + q) * geo.H * D +
                         static_cast<size_t>(h) * D + wg * 64 + 2 * t;
#pragma unroll
            for (int n = 0; n < 8; ++n) {
              float2* p = reinterpret_cast<float2*>(row + 8 * n);
              float2 x = __ldcg(p);  // past L1: another block wrote it
              x.x += part[4 * n + 2 * half];
              x.y += part[4 * n + 2 * half + 1];
              *p = x;
            }
          }
        }
      }
      __threadfence();
      consumers_sync();  // every add is done, and dS^T may be overwritten
      if (threadIdx.x == 0) store_release(sem, load_acquire(sem) + 1);
    }

    const size_t kv_off = (static_cast<size_t>(b) * geo.Sk * geo.KV + kvh) * D;
    const size_t kv_stride = static_cast<size_t>(geo.KV) * D;
    const float scale[2] = {geo.scale, geo.scale}, one[2] = {1.f, 1.f};
    store_rows<D>(dk + kv_off, kv_stride, key - g, geo.Sk, dk_acc, scale, g, t);
    store_rows<D>(dv + kv_off, kv_stride, key - g, geo.Sk, dv_acc, one, g, t);
  }
}

// dq = dq_acc x scale, rounded to bf16 once.
__global__ void dq_round_kernel(const float* __restrict__ acc, bf16* __restrict__ dq, size_t n,
                                float scale) {
  const size_t i = (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 2;
  if (i < n)
    *reinterpret_cast<__nv_bfloat162*>(dq + i) =
        __floats2bfloat162_rn(acc[i] * scale, acc[i + 1] * scale);
}

template <int D>
cudaError_t fused_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                      const bf16* dout, const float* lse, float* delta, bf16* dq, bf16* dk,
                      bf16* dv, int B, const Geometry& geo, cudaStream_t stream) {
  static void* ws = nullptr;
  static size_t ws_bytes = 0;
  const size_t n = static_cast<size_t>(B) * geo.Sq * geo.H * D;
  const size_t n_sems = static_cast<size_t>(B) * geo.H * ((geo.Sq + kBwdCols - 1) / kBwdCols);
  const size_t bytes = n * 4 + n_sems * 4;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_bf16_fused_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         fused_smem<D>());
  if (err == cudaSuccess && bytes > ws_bytes) {
    if (ws) cudaFree(ws);
    err = cudaMalloc(&ws, bytes);
    ws_bytes = err == cudaSuccess ? bytes : 0;
  }
  if (err == cudaSuccess) err = cudaMemsetAsync(ws, 0, bytes, stream);
  CUtensorMap tq, tk, tv, tdo;
  if (err == cudaSuccess) err = make_map<D>(&tq, q, B, geo.Sq, geo.H);
  if (err == cudaSuccess) err = make_map<D>(&tdo, dout, B, geo.Sq, geo.H);
  if (err == cudaSuccess) err = make_map<D>(&tk, k, B, geo.Sk, geo.KV);
  if (err == cudaSuccess) err = make_map<D>(&tv, v, B, geo.Sk, geo.KV);
  if (err != cudaSuccess) return err;
  float* dq_acc = static_cast<float*>(ws);
  int* sems = reinterpret_cast<int*>(dq_acc + n);
  const int rows = B * geo.Sq * geo.H;
  const int row_blocks = static_cast<int>((static_cast<int64_t>(rows) * (D / 8) + 255) / 256);
  flash_bwd_bf16_rowdot_kernel<D><<<row_blocks, 256, 0, stream>>>(o, dout, delta, rows, geo.Sq,
                                                                  geo.H);
  const dim3 grid(geo.KV, B, (geo.Sk + kBlockRows - 1) / kBlockRows);
  flash_bwd_bf16_fused_kernel<D><<<grid, kThreads, fused_smem<D>(), stream>>>(
      tq, tk, tv, tdo, lse, delta, dk, dv, dq_acc, sems, geo);
  dq_round_kernel<<<static_cast<unsigned>((n / 2 + 255) / 256), 256, 0, stream>>>(dq_acc, dq, n,
                                                                                  geo.scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_bf16_dq_fused_bwd_launch(const void* q, const void* k,
                                                        const void* v, const void* o,
                                                        const void* dout, const void* lse,
                                                        void* delta, void* dq, void* dk, void* dv,
                                                        int B, int Sq, int Sk, int H, int KV,
                                                        int D, int causal, int window,
                                                        int q_offset, float scale, void* stream) {
  if (bad_shape(B, Sq, Sk, H, KV, D) || D == 32) return static_cast<int>(cudaErrorInvalidValue);
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
  const cudaError_t err =
      D == 64 ? fused_bwd<64>(qp, kp, vp, op, gp, lp, dp, dqp, dkp, dvp, B, geo, st)
              : fused_bwd<128>(qp, kp, vp, op, gp, lp, dp, dqp, dkp, dvp, B, geo, st);
  return static_cast<int>(err);
}
