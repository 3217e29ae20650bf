// Grouped matrix product at small groups for Hopper (sm_90a): the port of
// the Pallas kernel repro/kernels/moe_gmm.py::moe_gmm_pallas (_gmm_kernel)
// in its small-block configuration.  repro/models/moe.py::_gmm_matmul
// passes block_m = B * C whenever B * C <= 128: at every MoE decode step
// (batch 2, capacity 1) each expert's group is 2 rows.  moe_gmm.cu's
// 128-row tiles are the port of the other configuration, block_m = 128.
//
// x [T, D] with its rows sorted into E expert-contiguous groups, w [E, D,
// F]: out[t] = x[t] @ w[e(t)], e(t) the group that holds row t.  `ends` [E]
// (int32, on the device) are the groups' running row ends cut at T, so
// groups that run past row T are cut there; rows past the last group come
// out zero; an empty group writes nothing.  float32 (moe_gmm_small_launch)
// or bfloat16 (moe_gmm_small_bf16_launch: the dtype the reference's models
// run it at, bf16 operands widened to fp32, summed in fp32 and the output
// rounded to bf16 once, moe_gmm.py:27-31).  Needs D % 4 == 0 (bf16:
// D % 8 == 0), F % 4 == 0 and 16-byte aligned tensors.
//
// Bound on the H100: bytes.  A call reads x and w once and writes out,
// 4 * (T * D + E * D * F + T * F) bytes, against 2 * T * D * F flops, about
// one flop a byte at 2-row groups.  At DeepSeek-V2-Lite's decode step,
// [128, 2048] x [64, 2048, 1408], that is 0.740 GB, 0.2209 ms at 3.35 TB/s,
// against 0.011 ms of fp32 FMAs at 67 TFLOP/s; at Jamba's [32, 4096] x
// [16, 4096, 14336], 3.76 GB and 1.1225 ms against 0.056 ms.  The tensor
// cores buy nothing here: moe_gmm.cu splits a whole D x 128 slab of w_e
// into TF32 parts and runs 12 wgmma products for every 2 valid rows.
// At bf16 the bytes are half: 0.370 GB, 0.1105 ms, at DeepSeek's step and
// 1.88 GB, 0.5612 ms, at Jamba's.
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
// learn the sizes, and the slabs blocks past the work units write the zeros
// of the rows past the last group.  At 4 rows a chunk or fewer, D is split
// over the last, partial wave as in the bf16 kernel (below, pick_chunks);
// unsplit, each (expert, slab) is one block: the decode steps' products give
// 512-1,792 blocks, 4-14 for each of 132 SMs.  Every sum runs in a fixed
// order, with no floating-point atomics, so two calls are bitwise equal.  The kernel
// launches on the caller's stream and allocates nothing.
//
// bf16 (Elem<bf16>): a lane reads its four columns of eight depths of w a
// step, each one 8-byte streaming load (64 bytes in flight a lane, as the
// float32 kernel's four 16-byte loads; with four depths a step, half those
// bytes in flight, DeepSeek's up product ran no faster on an H100 than the
// float32 kernel, PERF.md), and each row's eight x values as one 16-byte
// load, widens them exactly to fp32 and does 32 R fp32 FMAs.  The two
// element types share every line of the design but these loads and the
// store, and have kernels of their own names (ptxas and the SASS name each).
// bf16 halves the bytes a block streams, so a grid of one block an (expert,
// slab) leaves the last wave short: DeepSeek's up product's 704 blocks are
// 1.33 waves of the 528 that fit at RMAX 2 (4 an SM), and the second wave
// leaves most SMs too few bytes in flight (1.18x torch.bmm, PR 30).  So the
// bf16 kernel gives the pairs of the full waves (a wave: the blocks every
// SM holds at once, 528 at RMAX 2 on an H100) one unit each, and splits
// each pair of the last, partial wave into `chunks` runs of whole block
// steps of D, as many as fit the last wave (pick_chunks): at DeepSeek's up
// product 528 whole pairs, then 176 pairs in 3 chunks, 528 units of a
// third; at Jamba's up product 1,584 whole, then 208 in 2; the down
// products fill their waves already and are not split.  A split pair's
// unit writes its fp32 partial sums to a work buffer [chunks][T][F]; the
// last of the pair's units to take its ticket (an atomic counter it resets
// to 0) adds the partials in chunk order and rounds once, so which unit
// finishes last does not change the bits.  The partials add 8 x rows x F x
// chunks bytes at most (2.2 MB at DeepSeek's up product, against 370 MB of
// w).  Splitting every pair into 2 chunks, and a persistent grid of equal
// shares of all the steps, were both slower on an H100 (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 128;  // columns of F a block owns, 4 a lane

// What differs by element type: the depths of w a warp reads a step, a
// lane's four columns of one depth as loaded (Raw) and widened, a row's
// x values of a step's depths, and the store of four sums.
template <typename Elt>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kDepth = 4;
  using Raw = float4;
  static __device__ __forceinline__ float4 load_w(const float* p) {
    return __ldcs(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ float4 zero_w() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ float4 widen(const float4& w) { return w; }
  static __device__ __forceinline__ void load_x(const float* p, bool in, float (&xs)[kDepth]) {
    const float4 v = in ? __ldg(reinterpret_cast<const float4*>(p)) : zero_w();
    xs[0] = v.x;
    xs[1] = v.y;
    xs[2] = v.z;
    xs[3] = v.w;
  }
  static __device__ __forceinline__ void store4(float* p, const float (&a)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  }
};

template <>
struct Elem<bf16> {
  static constexpr int kDepth = 8;
  using Raw = uint2;
  static __device__ __forceinline__ uint2 load_w(const bf16* p) {
    return __ldcs(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ uint2 zero_w() { return make_uint2(0u, 0u); }
  // Four bf16 values widened (exactly) to fp32.
  static __device__ __forceinline__ float4 widen(const uint2& u) {
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  }
  static __device__ __forceinline__ void load_x(const bf16* p, bool in, float (&xs)[kDepth]) {
    const uint4 u = in ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0u, 0u, 0u, 0u);
    const float4 lo = widen(make_uint2(u.x, u.y)), hi = widen(make_uint2(u.z, u.w));
    xs[0] = lo.x;
    xs[1] = lo.y;
    xs[2] = lo.z;
    xs[3] = lo.w;
    xs[4] = hi.x;
    xs[5] = hi.y;
    xs[6] = hi.z;
    xs[7] = hi.w;
  }
  // Four fp32 values rounded to bf16 at p.
  static __device__ __forceinline__ void store4(bf16* p, const float (&a)[4]) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(a[0], a[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(a[2], a[3]);
    *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                              *reinterpret_cast<const uint32_t*>(&hi));
  }
};

__device__ __forceinline__ void fma4(float (&acc)[4], float x, const float4& w) {
  acc[0] = fmaf(x, w.x, acc[0]);
  acc[1] = fmaf(x, w.y, acc[1]);
  acc[2] = fmaf(x, w.z, acc[2]);
  acc[3] = fmaf(x, w.w, acc[3]);
}

// One chunk of `rows` <= R rows (x and o at the chunk's first row): o[r] =
// the sum over depths [d0, d1) of x[r, d] w[d] in this block's columns, o
// bf16 or float as Out (a chunk of D's fp32 partial sums).  `red` holds 4 x
// R x kCols floats.
template <int R, typename Elt, typename Out>
__device__ void gmm_chunk(const Elt* __restrict__ x, int D, int d0, int d1, int rows,
                          const Elt* __restrict__ wg, int F, int col, bool col_ok,
                          Out* __restrict__ o, float* red) {
  using E = Elem<Elt>;
  constexpr int kStep = E::kDepth * kWarps;  // depths of w a block reads a step
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
#pragma unroll 1
  for (int d = d0 + E::kDepth * warp; d < d1; d += kStep) {
    typename E::Raw wr[E::kDepth];  // the step's rows of w, as loaded
#pragma unroll
    for (int k = 0; k < E::kDepth; ++k)
      wr[k] = col_ok ? E::load_w(wg + static_cast<size_t>(d + k) * F + col) : E::zero_w();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float xs[E::kDepth];
      E::load_x(x + static_cast<size_t>(r) * D + d, r < rows, xs);
#pragma unroll
      for (int k = 0; k < E::kDepth; ++k) fma4(acc[r], xs[k], E::widen(wr[k]));
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
      if (r < rows) Elem<Out>::store4(o + static_cast<size_t>(r) * F + col, acc[r]);
  }
}

// gmm_chunk at the least power of two R >= rows, R <= RMAX.
template <int R, int RMAX, typename Elt, typename Out>
__device__ void gmm_chunk_at(const Elt* x, int D, int d0, int d1, int rows, const Elt* wg, int F,
                             int col, bool col_ok, Out* o, float* red) {
  if constexpr (R > 1) {
    if (rows <= R / 2) {
      gmm_chunk_at<R / 2, RMAX>(x, D, d0, d1, rows, wg, F, col, col_ok, o, red);
      return;
    }
  }
  gmm_chunk<R>(x, D, d0, d1, rows, wg, F, col, col_ok, o, red);
}

// Whether a kernel holds the split path: the float32 kernels at more than
// 4 rows a chunk spill with it (ptxas, sm_90a), so pick_chunks gives them
// one chunk.
template <int RMAX, typename Elt>
constexpr bool kCanSplit = std::is_same_v<Elt, bf16> || RMAX <= 4;

// Work units: the first `whole` (group, slab) pairs (unsplit: all of
// them, whole = E x slabs) one unit each, in pair order, slab fastest;
// then each remaining pair split into `chunks` runs of D's block steps,
// chunk fastest; then slabs blocks that write the zeros of the rows past
// the last group.  A whole pair's unit writes its rows of out.  A split
// pair's unit writes its fp32 partial sums to work [chunks][T][F],
// and the last of the pair's units to take its ticket adds the chunks'
// partials in chunk order and rounds once, so the bits do not depend on
// which unit finishes last.
template <int RMAX, typename Elt>
__device__ __forceinline__ void gmm_small(const Elt* __restrict__ x, const Elt* __restrict__ w,
                                          const int* __restrict__ ends, Elt* __restrict__ out,
                                          float* __restrict__ work, unsigned* __restrict__ tickets,
                                          int T, int D, int F, int E, int whole, int chunks) {
  __shared__ __align__(16) float red[4 * RMAX * kCols];
  __shared__ bool s_last;
  constexpr int kStep = Elem<Elt>::kDepth * kWarps;
  const int slabs = (F + kCols - 1) / kCols;
  const int units = whole + (E * slabs - whole) * chunks;
  const int unit = blockIdx.x;
  const int lane_col = 4 * (threadIdx.x % 32);
  if (unit >= units) {  // the zeros of rows [ends[E - 1], T)
    const int col = (unit - units) * kCols + lane_col;
    const float zero[4] = {0.f, 0.f, 0.f, 0.f};
    if (col < F)
      for (int r = ends[E - 1] + threadIdx.x / 32; r < T; r += kWarps)
        Elem<Elt>::store4(out + static_cast<size_t>(r) * F + col, zero);
    return;
  }
  const bool split = unit >= whole;
  const int chunk = split ? (unit - whole) % chunks : 0;
  const int pair = split ? whole + (unit - whole) / chunks : unit;
  const int e = pair / slabs;
  const int col = pair % slabs * kCols + lane_col;
  const bool col_ok = col < F;
  const int begin = e ? ends[e - 1] : 0, end = ends[e];
  if (begin == end) return;  // an empty group: every unit of the pair leaves here
  const Elt* wg = w + static_cast<size_t>(e) * D * F;
  if (!kCanSplit<RMAX, Elt> || !split) {
    for (int r0 = begin; r0 < end; r0 += RMAX)
      gmm_chunk_at<RMAX, RMAX>(x + static_cast<size_t>(r0) * D, D, 0, D, min(RMAX, end - r0), wg,
                               F, col, col_ok, out + static_cast<size_t>(r0) * F, red);
    return;
  }
  const int steps = (D + kStep - 1) / kStep;
  const int d0 = chunk * steps / chunks * kStep;
  const int d1 = min(D, (chunk + 1) * steps / chunks * kStep);
  float* part = work + static_cast<size_t>(chunk) * T * F;
  for (int r0 = begin; r0 < end; r0 += RMAX)
    gmm_chunk_at<RMAX, RMAX>(x + static_cast<size_t>(r0) * D, D, d0, d1, min(RMAX, end - r0), wg,
                             F, col, col_ok, part + static_cast<size_t>(r0) * F, red);
  // Each unit takes the pair's ticket once; the last resets it to 0.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(tickets + pair, 1u) == static_cast<unsigned>(chunks - 1);
    if (s_last) tickets[pair] = 0u;
  }
  __syncthreads();
  if (!s_last || !col_ok) return;
  __threadfence();
  for (int r = begin + threadIdx.x / 32; r < end; r += kWarps) {
    const size_t at = static_cast<size_t>(r) * F + col;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c = 0; c < chunks; ++c) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(work + c * static_cast<size_t>(T) * F + at));
      sum[0] += v.x;
      sum[1] += v.y;
      sum[2] += v.z;
      sum[3] += v.w;
    }
    Elem<Elt>::store4(out + at, sum);
  }
}

// A thread holds RMAX x 4 sums, a step's 16 w values and the rows' x
// values: within 64 registers (4 blocks an SM) at RMAX 2, 85 at 4 and 8,
// 128 at 16.
template <int RMAX>
__global__ void __launch_bounds__(kThreads, RMAX <= 2 ? 4 : RMAX <= 8 ? 3 : 2)
    gmm_small_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const int* __restrict__ ends, float* __restrict__ out,
                     float* __restrict__ work, unsigned* __restrict__ tickets, int T, int D,
                     int F, int E, int whole, int chunks) {
  gmm_small<RMAX>(x, w, ends, out, work, tickets, T, D, F, E, whole, chunks);
}

// At bf16 a step's 32 w values take 16 registers (widened as used): within
// 64 registers at RMAX 2, 128 at 4 and 8 and 255 at 16 (capped at 85,
// RMAX 8 spilled, and RMAX 4 with a share's depth range 8 bytes; at 128
// RMAX 16, even reading four depths a step).  A decode step's groups take
// RMAX 2.
template <int RMAX>
__global__ void __launch_bounds__(kThreads, RMAX <= 2 ? 4 : RMAX <= 8 ? 2 : 1)
    gmm_small_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                          const int* __restrict__ ends, bf16* __restrict__ out,
                          float* __restrict__ work, unsigned* __restrict__ tickets, int T, int D,
                          int F, int E, int whole, int chunks) {
  gmm_small<RMAX>(x, w, ends, out, work, tickets, T, D, F, E, whole, chunks);
}

// The kernel of an element type.
template <int RMAX, typename Elt>
auto entry() {
  if constexpr (std::is_same_v<Elt, bf16>) return gmm_small_bf16_kernel<RMAX>;
  else return gmm_small_kernel<RMAX>;
}

constexpr int kMaxChunks = 8;

// Blocks of the kernel that the current device's SMs hold at once (its
// wave), cached by device.
template <int RMAX, typename Elt>
cudaError_t wave(int* blocks) {
  static int cached[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && cached[device] > 0) {
    *blocks = cached[device];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, entry<RMAX, Elt>(), kThreads, 0);
  if (err != cudaSuccess) return err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (device < 64) cached[device] = *blocks;
  return cudaSuccess;
}

// The pairs that take one unit each: those of the full waves.  The rest
// (the last, partial wave's) are the ones split into chunks.
int whole_pairs(int pairs, int wave_blocks) {
  return pairs % wave_blocks == 0 ? pairs : pairs - pairs % wave_blocks;
}

// The chunks of D for a call: the pairs past the full waves are each
// split into as many chunks as fit their units in one wave (wave / rest),
// at most kMaxChunks and at most one a block step of depths.
template <int RMAX, typename Elt>
cudaError_t pick_chunks(int D, int F, int E, int* chunks) {
  if constexpr (!kCanSplit<RMAX, Elt>) {
    *chunks = 1;
    return cudaSuccess;
  }
  int blocks = 0;
  const cudaError_t err = wave<RMAX, Elt>(&blocks);
  if (err != cudaSuccess) return err;
  const int pairs = E * ((F + kCols - 1) / kCols);
  const int rest = pairs - whole_pairs(pairs, blocks);
  const int steps = (D + Elem<Elt>::kDepth * kWarps - 1) / (Elem<Elt>::kDepth * kWarps);
  int c = rest > 0 ? blocks / rest : 1;
  c = c < 1 ? 1 : c > kMaxChunks ? kMaxChunks : c;
  *chunks = c < steps ? c : steps;
  return cudaSuccess;
}

template <int RMAX, typename Elt>
cudaError_t launch(const Elt* x, const Elt* w, const int* ends, Elt* out, float* work,
                   unsigned* tickets, int T, int D, int F, int E, int chunks, cudaStream_t stream) {
  const int64_t slabs = (F + kCols - 1) / kCols;
  const int64_t pairs = slabs * E;
  int whole = static_cast<int>(pairs);
  if (chunks > 1 && !kCanSplit<RMAX, Elt>) return cudaErrorInvalidValue;
  if (chunks > 1) {
    int blocks = 0;
    const cudaError_t err = wave<RMAX, Elt>(&blocks);
    if (err != cudaSuccess) return err;
    whole = whole_pairs(static_cast<int>(pairs), blocks);
  }
  const int64_t units = whole + (pairs - whole) * chunks;
  if (units + slabs > 0x7fffffff) return cudaErrorInvalidValue;
  const auto kernel = entry<RMAX, Elt>();
  kernel<<<static_cast<unsigned>(units + slabs), kThreads, 0, stream>>>(
      x, w, ends, out, work, tickets, T, D, F, E, whole, chunks);
  return cudaGetLastError();
}

template <typename Elt>
int launch_rows(const void* x, const void* w, const void* ends, void* out, void* work,
                void* tickets, int T, int D, int F, int E, int rmax, int chunks, void* stream) {
  if (T == 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xt = static_cast<const Elt*>(x);
  const auto* wt = static_cast<const Elt*>(w);
  const auto* ei = static_cast<const int*>(ends);
  Elt* ot = static_cast<Elt*>(out);
  auto* wk = static_cast<float*>(work);
  auto* tk = static_cast<unsigned*>(tickets);
  switch (rmax) {
    case 1: return static_cast<int>(launch<1>(xt, wt, ei, ot, wk, tk, T, D, F, E, chunks, s));
    case 2: return static_cast<int>(launch<2>(xt, wt, ei, ot, wk, tk, T, D, F, E, chunks, s));
    case 4: return static_cast<int>(launch<4>(xt, wt, ei, ot, wk, tk, T, D, F, E, chunks, s));
    case 8: return static_cast<int>(launch<8>(xt, wt, ei, ot, wk, tk, T, D, F, E, chunks, s));
    case 16: return static_cast<int>(launch<16>(xt, wt, ei, ot, wk, tk, T, D, F, E, chunks, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename Elt>
int chunks_for(int D, int F, int E, int rmax, int* chunks) {
  switch (rmax) {
    case 1: return static_cast<int>(pick_chunks<1, Elt>(D, F, E, chunks));
    case 2: return static_cast<int>(pick_chunks<2, Elt>(D, F, E, chunks));
    case 4: return static_cast<int>(pick_chunks<4, Elt>(D, F, E, chunks));
    case 8: return static_cast<int>(pick_chunks<8, Elt>(D, F, E, chunks));
    case 16: return static_cast<int>(pick_chunks<16, Elt>(D, F, E, chunks));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool bad_shape(int T, int D, int F, int E, int align) {
  return T < 0 || D < 1 || F < 1 || E < 1 || D % align || F % 4 || E > 65534;
}

}  // namespace

// out [T, F] = x [T, D] grouped by `ends` times w [E, D, F]: `ends` [E] are
// the groups' running row ends cut at T (int32, on the device); `rmax`
// (1, 2, 4, 8 or 16) the most rows a chunk holds; float32, D split into
// `chunks` (1 to 8, and 1 at rmax 8 or 16; from moe_gmm_small_chunks):
// with more than one, `work`
// holds chunks x T x F floats of scratch and `tickets` E x ceil(F / 128)
// zeroed unsigned ints, which the call leaves at 0.
extern "C" int moe_gmm_small_launch(const void* x, const void* w, const void* ends, void* out,
                                    void* work, void* tickets, int T, int D, int F, int E,
                                    int rmax, int chunks, void* stream) {
  if (bad_shape(T, D, F, E, 4) || chunks < 1 || chunks > kMaxChunks ||
      (chunks > 1 && (work == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_rows<float>(x, w, ends, out, work, tickets, T, D, F, E, rmax, chunks, stream);
}

// The chunks of D (1 to 8) that fill the float32 kernel's last wave for a
// call on the current device, into *chunks; returns a cudaError_t.
extern "C" int moe_gmm_small_chunks(int D, int F, int E, int rmax, void* chunks) {
  if (bad_shape(0, D, F, E, 4) || chunks == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return chunks_for<float>(D, F, E, rmax, static_cast<int*>(chunks));
}

// The chunks of D (1 to 8) the bf16 kernel takes for a call on the current
// device, into *chunks; returns a cudaError_t.
extern "C" int moe_gmm_small_bf16_chunks(int D, int F, int E, int rmax, void* chunks) {
  if (bad_shape(0, D, F, E, 8) || chunks == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return chunks_for<bf16>(D, F, E, rmax, static_cast<int*>(chunks));
}

// The same at bf16 (x, w and out), D split into `chunks` (1 to 8; from
// moe_gmm_small_bf16_chunks): with more than one, `work` holds chunks x T x
// F floats of scratch and `tickets` E x ceil(F / 128) zeroed unsigned ints,
// which the call leaves at 0.
extern "C" int moe_gmm_small_bf16_launch(const void* x, const void* w, const void* ends,
                                         void* out, void* work, void* tickets, int T, int D,
                                         int F, int E, int rmax, int chunks, void* stream) {
  if (bad_shape(T, D, F, E, 8) || chunks < 1 || chunks > kMaxChunks ||
      (chunks > 1 && (work == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_rows<bf16>(x, w, ends, out, work, tickets, T, D, F, E, rmax, chunks, stream);
}
