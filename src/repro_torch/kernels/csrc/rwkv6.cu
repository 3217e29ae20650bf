// RWKV-6 WKV recurrence for Hopper (sm_90a), forward and backward: the port
// of the Pallas kernel repro/kernels/rwkv6.py::rwkv6_pallas (_wkv_kernel),
// plus the backward that the TPU kernel lacks (there the learner takes
// jax.grad through repro/kernels/ref.py::rwkv6_ref).
//
// float32, in the reference's layout: r, k, v, w [B, T, H, N] (w the decay
// in (0, 1]), u [H, N], states [B, H, N, N] (key x value).  From the start
// state S_0 (zeros when none is given), for t = 1 .. T:
//     o_t[j] = sum_i r_t[i] S_{t-1}[i, j] + v_t[j] sum_i r_t[i] u[i] k_t[i]
//     S_t[i, j] = w_t[i] S_{t-1}[i, j] + k_t[i] v_t[j]
// and the final state S_T.  The backward takes dO (and the gradient G_T of
// the final state, zero when absent) and walks t = T .. 1 with
// G_t = dL/dS_t:
//     dr_t[i] = sum_j do_t[j] S_{t-1}[i, j] + u[i] k_t[i] (do_t . v_t)
//     dk_t[i] = sum_j G_t[i, j] v_t[j] + u[i] r_t[i] (do_t . v_t)
//     dv_t[j] = sum_i G_t[i, j] k_t[i] + do_t[j] sum_i r_t[i] u[i] k_t[i]
//     dw_t[i] = sum_j G_t[i, j] S_{t-1}[i, j]
//     du[i]  += r_t[i] k_t[i] (do_t . v_t)
//     G_{t-1}[i, j] = w_t[i] G_t[i, j] + r_t[i] do_t[j]
// ending with G_0, the gradient of the start state.
//
// What bounds it on the H100.  The recurrences are independent element by
// element: S_t[i, j] and G_{t-1}[i, j] each depend on the step before only
// through one FMA of their own, a chain of about 4 cycles a step (8 us over
// the LM path's 4,096 steps).  Every sum over i or j (o, dr, dk, dv, dw, du)
// is an output that feeds no later step.  So the recurrence has no latency
// floor near 1 ms: the first layout of these kernels (one block of N = 64
// threads per (b, h) pair, two warps on each of 128 SMs, each thread walking
// a whole row or column of the state every step, the backward's states
// written to device memory and read back, about 17 GB a call at
// [2, 4096, 64, 64]) took 2.3 and 12.9 ms.  What is left is the work of one
// SM per pair, since B * H = 128 pairs fill 128 of the 132 SMs: the
// instructions each SM issues.  At [2, 4096, 64, 64] the bytes take 0.24 ms
// (forward: 5 streams and the chunk-start states) and 0.45 ms (backward: 9
// streams and the states) at 3.35 TB/s; the kernels issue about 40
// (forward) and 150 (backward, recompute and forward pass included)
// instructions per thread and step, 0.33 and 1.2 ms of issue slots at 1.98
// GHz, plus what the dependent chains leave unhidden with 16 warps an SM
// (see PERF.md for the measured times).
//
// Both kernels launch one block of N * N / 8 threads per (h, b) pair (512 at
// N = 64), 8 state elements a thread, and stage r, k, v, w (and dO) a tile
// ahead in shared memory with 4-byte cp.async (any alignment),
// double-buffered, so the loads overlap the walk.  Sums over j stay inside a
// warp; sums over i cross warps through shared memory, reduced once per tile
// behind the tile's barrier.  Every sum has a fixed order.
//
//   * Forward: thread (q, c) owns the 4 x 2 tile of rows 4q .. 4q + 3 and
//     columns 2c, 2c + 1 of the state, in registers for the whole sequence;
//     the N / 2 threads of a row quad are consecutive lanes.  Per step it
//     reads its rows' r, k, w as one broadcast float4 each and its columns'
//     v as a float2, adds its rows' r_t[i] S_{t-1}[i, j] for its two columns
//     and writes the two partial sums to a [tile step][quad][N] buffer;
//     after the tile, o_t[j] is the sum over quads in order plus v_t[j]
//     times sum_i r_t[i] u[i] k_t[i], that bonus taken once per step (by one
//     warp per step, before the walk) instead of once per element.  Two
//     barriers per tile of 32 steps, none per step; a full tile walks
//     unrolled by 4 when checkpoints fall on tile starts.  When a gradient is
//     wanted, the state at the start of every chunk of `chunk` steps is
//     written to ckpt [B, H, ceil(T / chunk), N, N] straight from registers:
//     each warp writes whole rows, so the stores are coalesced (the
//     counterpart of the reference's chunked remat, models/scan_utils.py).
//   * Backward: thread (p, c) owns the 2 x 4 tile of rows 2p, 2p + 1 and
//     columns 4c .. 4c + 3 of G_t and of S_{t-1}; the N / 4 threads of a row
//     pair are consecutive lanes, so a warp holds whole rows.  The chunks
//     are walked in reverse.  dw_t needs S_{t-1}, produced going forward,
//     beside G_t, produced going backward, so the states are rematerialised
//     on chip, in two levels:
//       1. from the chunk's saved start state (staged into shared memory by
//          cp.async), walk the chunk forward once and keep the state at
//          the start of each sub-chunk of kSub = 16 steps in shared memory
//          (at most 4 states of N x N floats, 64 KB at N = 64);
//       2. for each sub-chunk in reverse, recompute its states kReg = 8 at a
//          time into registers (8 x 8 floats a thread) from its start state,
//          then walk them back.
//     The backward is a pipeline of such units (a forward pass over one
//     sub-chunk, or the reverse walk of one), each staged one unit ahead,
//     with two barriers per unit.  dw_t[i] = sum_j G_t[i, j] S_{t-1}[i, j]
//     starts as a product inside a thread.  Each step a thread's sums of dr,
//     dk and dw over its 4 columns (6 values) are reduced over the row
//     pair's N / 4 lanes by a butterfly that scatters as it sums (8
//     shuffles at N = 64, each lane keeping one sum), and written to a
//     [sub-chunk step][3][N] tile; its sums of dv over its 2 rows are
//     reduced over the warp's row pairs the same way and go to a [sub-chunk
//     step][warp][N] buffer.  do_t . v_t and sum_i r_t[i] u[i] k_t[i] are
//     taken once per step before the walk.  After the sub-chunk, behind its
//     barrier, dv is summed over the warps in order, the u terms are added,
//     and dr, dk, dv, dw are written with coalesced stores.  S_{t-1} is
//     never rebuilt as (S_t - k v) / w: w reaches 6.17e-4 (the decay clip of
//     models/ssm.py), and the division would amplify rounding.  du is summed
//     with compensation per (b, h), in reverse time, and summed over b by
//     the caller; there are no atomics, so gradients are the same from run to
//     run.
// Loops over the slots of a register array take their trip counts from
// template arguments: a loop left rolled over such an array puts it in local
// memory (it made an earlier build of the backward three times slower).
//
// bfloat16 (rwkv6_bf16_fwd_launch, rwkv6_bf16_bwd_launch, below): r, k, v,
// w, dO and the outputs o, dr, dk, dv, dw are bf16; u, the states (start,
// final, chunk-start checkpoints, the start state's gradient) and du stay
// fp32, as the model passes them (models/ssm.py, the reference's
// rwkv6_pallas widening every operand to fp32, rwkv6.py:50-54).  The
// arithmetic is the float32 kernels', on the same fp32 staged tiles: each
// thread copies pairs of bf16 elements (4 bytes) into a bf16 staging tile
// with cp.async, and widens exactly the pairs it copied into the fp32 tile
// once they have landed, before the barrier that publishes the tile; each
// output is rounded to bf16 once.  A decay that rounds to exactly 1.0 in
// bf16 is no special case: the state is fp32 and the step is the same FMA.
// Each body is one template on the element type, instantiated by two
// kernels of their own names (rwkv6_fwd_kernel / rwkv6_fwd_bf16_kernel,
// rwkv6_bwd_kernel / rwkv6_bwd_bf16_kernel) with the same launch bounds.
// Each kernel launches on the caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxChunk = 64;               // steps per saved chunk-start state, at most
constexpr int kTile = 32;                   // forward: steps staged at once
constexpr int kSub = 16;                    // backward: steps per sub-chunk
constexpr int kMarks = kMaxChunk / kSub;    // backward: sub-chunk start states kept per chunk
constexpr int kReg = 8;                     // backward: states held in registers at once

template <int N>
struct Shape {
  static constexpr int kThreads = N * N / 8;  // 8 elements of the state per thread
  static constexpr int kWarps = kThreads / 32;
  // Forward: a 4 x 2 tile per thread, the N / 2 threads of a row quad
  // consecutive lanes.
  static constexpr int kQuadLanes = N / 2;
  static constexpr int kQuads = N / 4;
  // Backward: a 2 x 4 tile per thread, the N / 4 threads of a row pair
  // consecutive lanes; a warp holds 128 / N row pairs.
  static constexpr int kPairLanes = N / 4;
};

// r, k or w of rows i .. i + 3 of a staged step (forward), the same for a
// whole warp: one float4 load (as fast as four scalar ones, measured).
__device__ __forceinline__ void rows4(const float* p, float (&x)[4]) {
  const float4 y = *reinterpret_cast<const float4*>(p);
  x[0] = y.x, x[1] = y.y, x[2] = y.z, x[3] = y.w;
}

// One step of the recurrence on a thread's 2 x 4 tile (backward): S = w S +
// k v, from step m of a staged tile.
template <int N>
__device__ __forceinline__ void advance(float (&dst)[2][4], const float (&src)[2][4], const float* bk,
                                        const float* bw, const float* bv, int m, int i0, int j0) {
  const float2 k2 = *reinterpret_cast<const float2*>(bk + m * N + i0);
  const float2 w2 = *reinterpret_cast<const float2*>(bw + m * N + i0);
  const float4 v4 = *reinterpret_cast<const float4*>(bv + m * N + j0);
  const float kk[2] = {k2.x, k2.y}, ww[2] = {w2.x, w2.y}, vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
  for (int ri = 0; ri < 2; ++ri)
#pragma unroll
    for (int c = 0; c < 4; ++c) dst[ri][c] = fmaf(ww[ri], src[ri][c], kk[ri] * vv[c]);
}

__device__ __forceinline__ void copy_tile(float (&dst)[2][4], const float (&src)[2][4]) {
#pragma unroll
  for (int ri = 0; ri < 2; ++ri)
#pragma unroll
    for (int c = 0; c < 4; ++c) dst[ri][c] = src[ri][c];
}

// A thread's 2 x 4 tile of an N x N state in shared memory, and back.
template <int N>
__device__ __forceinline__ void load_tile(float (&S)[2][4], const float* src, int i0, int j0) {
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const float4 x = *reinterpret_cast<const float4*>(src + (i0 + ri) * N + j0);
    S[ri][0] = x.x, S[ri][1] = x.y, S[ri][2] = x.z, S[ri][3] = x.w;
  }
}

template <int N>
__device__ __forceinline__ void store_tile(float* dst, const float (&S)[2][4], int i0, int j0) {
#pragma unroll
  for (int ri = 0; ri < 2; ++ri)
    *reinterpret_cast<float4*>(dst + (i0 + ri) * N + j0) =
        make_float4(S[ri][0], S[ri][1], S[ri][2], S[ri][3]);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// An fp32 output as the element type (a bf16 output rounded once).
template <typename E>
__device__ __forceinline__ E narrow(float x) {
  if constexpr (std::is_same_v<E, bf16>) return __float2bfloat16_rn(x);
  else return x;
}

template <typename E>
constexpr bool kIsBf16 = std::is_same_v<E, bf16>;

// Stage steps [t0, t0 + L) of the streams picked by `mask` (bit a: src[a],
// each [B, T, H, N] with its pair's step 0 at src[a]) into dst[a][kSteps][N].
// Each thread copies a fixed set of elements: no loop to run at run time.
// bf16 streams land in raw[a][kSteps][N], a pair of elements a copy, and
// unpack_tile widens them into dst.
template <typename E, int N, int kSteps, int kStreams>
__device__ __forceinline__ void stage_tile(float* dst, E* raw, const E* const (&src)[kStreams],
                                           int mask, size_t step, int t0, int L) {
  constexpr int kThreads = Shape<N>::kThreads;
  if constexpr (kIsBf16<E>) {
    static_assert(kSteps * N / 2 % kThreads == 0, "a tile's pairs split evenly over the block");
#pragma unroll
    for (int e = 0; e < kSteps * N / 2 / kThreads; ++e) {
      const int idx = 2 * (threadIdx.x + e * kThreads), m = idx / N;
      if (m < L) {
        const size_t off = static_cast<size_t>(t0 + m) * step + idx % N;
#pragma unroll
        for (int a = 0; a < kStreams; ++a)
          if (mask & (1 << a)) cp_async4(raw + a * kSteps * N + idx, src[a] + off);
      }
    }
  } else {
    static_assert(kSteps * N % kThreads == 0, "a tile splits evenly over the block");
#pragma unroll
    for (int e = 0; e < kSteps * N / kThreads; ++e) {
      const int idx = threadIdx.x + e * kThreads, m = idx / N;
      if (m < L) {
        const size_t off = static_cast<size_t>(t0 + m) * step + idx % N;
#pragma unroll
        for (int a = 0; a < kStreams; ++a)
          if (mask & (1 << a)) cp_async4(dst + a * kSteps * N + idx, src[a] + off);
      }
    }
  }
}

// After the thread's copies have landed (cp.async.wait_all), widen the
// pairs it staged from raw into dst; nothing to do for float32 streams.
// The barrier that follows publishes dst to the block.
template <typename E, int N, int kSteps, int kStreams>
__device__ __forceinline__ void unpack_tile(float* dst, const E* raw, int mask, int L) {
  if constexpr (kIsBf16<E>) {
    constexpr int kThreads = Shape<N>::kThreads;
#pragma unroll
    for (int e = 0; e < kSteps * N / 2 / kThreads; ++e) {
      const int idx = 2 * (threadIdx.x + e * kThreads), m = idx / N;
      if (m < L) {
#pragma unroll
        for (int a = 0; a < kStreams; ++a)
          if (mask & (1 << a)) {
            const float2 x = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(raw + a * kSteps * N + idx));
            *reinterpret_cast<float2*>(dst + a * kSteps * N + idx) = x;
          }
      }
    }
  }
}

// Sum over all 32 lanes of a warp, in a fixed order.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

// Per step of a staged tile, one warp per step: sum_x a[s][x] * b[s][x]
// (times c[x] when given) into out[s].
template <int N>
__device__ __forceinline__ void step_dots(float* out, const float* a, const float* b, const float* c,
                                          int L) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int s = warp; s < L; s += Shape<N>::kWarps) {
    float acc = 0.f;
#pragma unroll
    for (int x = lane; x < N; x += 32) {
      acc += c != nullptr ? a[s * N + x] * c[x] * b[s * N + x] : a[s * N + x] * b[s * N + x];
    }
    acc = warp_sum(acc);
    if (lane == 0) out[s] = acc;
  }
}

// p ? a : b as one selp.  A plain select between two elements of an array
// can be turned into a load from a computed index, which puts the array in
// local memory.
__device__ __forceinline__ float select(bool p, float a, float b) {
  float r;
  asm("{\n .reg .pred q;\n setp.ne.s32 q, %3, 0;\n selp.f32 %0, %1, %2, q;\n}"
      : "=f"(r) : "f"(a), "f"(b), "r"(static_cast<int>(p)));
  return r;
}

// One level of a reduce-scatter over lanes: lanes whose bit kMask is set
// keep the upper kHalf of their slots, the others the lower, each adding the
// partner lane's copy; `base` gathers the first slot a lane keeps.  The trip
// count is a template argument, so the loop unrolls and v stays in registers.
template <int kHalf, int kMask, int kSize>
__device__ __forceinline__ void halve(float (&v)[kSize], int lane, int& base) {
  const bool upper = (lane & kMask) != 0;
#pragma unroll
  for (int k = 0; k < kHalf; ++k) {
    const float lo = v[k], hi = v[k + kHalf];
    v[k] = select(upper, hi, lo) + __shfl_xor_sync(0xffffffffu, select(upper, lo, hi), kMask);
  }
  base += upper ? kHalf : 0;
}

// The backward's sums over j: v[0..7] summed over the N / 4 lanes of a row
// pair (masks N / 8, N / 16, ...), each lane keeping slots v[0 .. kRowHeld)
// from the returned slot on; at N = 64 lanes 2s and 2s + 1 both hold slot s.
template <int N>
constexpr int kRowHeld = N == 16 ? 2 : 1;

template <int N>
__device__ __forceinline__ int row_reduce(float (&v)[8], int lane) {
  int base = 0;
  halve<4, N / 8>(v, lane, base);
  halve<2, N / 16>(v, lane, base);
  if constexpr (N >= 32) halve<1, N / 32>(v, lane, base);
  if constexpr (N == 64) v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
  return base;
}

// The backward's sums over i inside a warp: v[0..3] (four columns) summed
// over the warp's 128 / N row pairs (masks N / 4, N / 2, ...), each lane
// keeping columns v[0 .. kColHeld) from the returned one on; at N = 16 lanes
// l and l ^ 16 both hold the same column.
template <int N>
constexpr int kColHeld = N == 64 ? 2 : 1;

template <int N>
__device__ __forceinline__ int col_reduce(float (&v)[4], int lane) {
  int base = 0;
  halve<2, N / 4>(v, lane, base);
  if constexpr (N <= 32) halve<1, N / 2>(v, lane, base);
  if constexpr (N == 16) v[0] += __shfl_xor_sync(0xffffffffu, v[0], 16);
  return base;
}

// ------------------------------------------------------------------ forward
template <typename E, int N>
__device__ __forceinline__ void fwd_body(const E* __restrict__ r, const E* __restrict__ k,
                                         const E* __restrict__ v, const E* __restrict__ w,
                                         const float* __restrict__ u,
                                         const float* __restrict__ s0, E* __restrict__ o,
                                         float* __restrict__ s_out, float* __restrict__ ckpt,
                                         int T, int H, int chunk) {
  using Sh = Shape<N>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* buf = smem;                             // [2][4: r, k, v, w][kTile][N]
  float* part = buf + 2 * 4 * kTile * N;         // [kTile][kQuads][N]: o's partial sums by quad
  float* ruk = part + kTile * Sh::kQuads * N;    // [2][kTile]: sum_i r u k per step
  float* su = ruk + 2 * kTile;                   // [N]
  E* raw = reinterpret_cast<E*>(su + N);         // bf16: [4][kTile][N], the staged copies

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int q = tid / Sh::kQuadLanes, i0 = 4 * q, j0 = 2 * (tid % Sh::kQuadLanes);
  const size_t step = static_cast<size_t>(H) * N;
  const size_t base = static_cast<size_t>(b) * T * step + static_cast<size_t>(h) * N;
  const size_t pair = static_cast<size_t>(b) * H + h;
  const int nc = (T + chunk - 1) / chunk;
  const int ntiles = (T + kTile - 1) / kTile;
  const E* const streams[4] = {r + base, k + base, v + base, w + base};
  // Checkpoints fall only on tile starts when a chunk is whole tiles long
  // (the LM path's 64): then a full tile's walk has no branch in it.
  const bool ck_at_tiles = ckpt == nullptr || chunk % kTile == 0;

  for (int x = tid; x < N; x += Sh::kThreads) su[x] = u[h * N + x];
  float S[4][2];
#pragma unroll
  for (int ri = 0; ri < 4; ++ri)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      S[ri][c] = s0 != nullptr ? s0[pair * N * N + (i0 + ri) * N + j0 + c] : 0.f;
  auto save_state = [&](int t) {
    float* dst = ckpt + (pair * nc + t / chunk) * N * N;
#pragma unroll
    for (int ri = 0; ri < 4; ++ri)
      *reinterpret_cast<float2*>(dst + (i0 + ri) * N + j0) = make_float2(S[ri][0], S[ri][1]);
  };
  // o of a walked tile: its partial sums by quad in order, plus v times the bonus.
  auto flush = [&](int t0, int L, const float* bv, const float* rk) {
#pragma unroll
    for (int e = 0; e < kTile * N / Sh::kThreads; ++e) {
      const int idx = tid + e * Sh::kThreads, s = idx / N, x = idx % N;
      if (s < L) {
        float acc = 0.f;
#pragma unroll
        for (int qq = 0; qq < Sh::kQuads; ++qq) acc += part[(s * Sh::kQuads + qq) * N + x];
        o[base + static_cast<size_t>(t0 + s) * step + x] = narrow<E>(fmaf(bv[idx], rk[s], acc));
      }
    }
  };

  stage_tile<E, N, kTile>(buf, raw, streams, 0xf, step, 0, min(kTile, T));
  cp_async_commit();
  cp_async_wait_all();
  unpack_tile<E, N, kTile, 4>(buf, raw, 0xf, min(kTile, T));
  __syncthreads();

  int next_ck = 0;  // the next step whose start state goes to ckpt
  for (int n = 0; n < ntiles; ++n) {
    const int p = n & 1, t0 = n * kTile, L = min(kTile, T - t0);
    const float* cur = buf + p * 4 * kTile * N;
    const float *br = cur, *bk = cur + kTile * N, *bv = cur + 2 * kTile * N,
                *bw = cur + 3 * kTile * N;
    if (n > 0) {
      flush(t0 - kTile, kTile, buf + (p ^ 1) * 4 * kTile * N + 2 * kTile * N, ruk + (p ^ 1) * kTile);
    }
    step_dots<N>(ruk + p * kTile, br, bk, su, L);
    __syncthreads();  // the bonus is in; the previous tile's buffers are free

    if (n + 1 < ntiles) {
      stage_tile<E, N, kTile>(buf + (p ^ 1) * 4 * kTile * N, raw, streams, 0xf, step, t0 + kTile,
                              min(kTile, T - t0 - kTile));
      cp_async_commit();
    }
    auto walk = [&](int s) {
      float rr[4], kk[4], ww[4];
      rows4(br + s * N + i0, rr);
      rows4(bk + s * N + i0, kk);
      rows4(bw + s * N + i0, ww);
      const float2 v2 = *reinterpret_cast<const float2*>(bv + s * N + j0);
      const float vv[2] = {v2.x, v2.y};
      float acc[2] = {0.f, 0.f};
#pragma unroll
      for (int ri = 0; ri < 4; ++ri)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          acc[c] = fmaf(rr[ri], S[ri][c], acc[c]);
          S[ri][c] = fmaf(ww[ri], S[ri][c], kk[ri] * vv[c]);
        }
      *reinterpret_cast<float2*>(part + (s * Sh::kQuads + q) * N + j0) = make_float2(acc[0], acc[1]);
    };
    if (ck_at_tiles && L == kTile) {
      if (ckpt != nullptr && t0 == next_ck) {
        save_state(t0);
        next_ck += chunk;
      }
#pragma unroll 4
      for (int s = 0; s < kTile; ++s) walk(s);
    } else {
      for (int s = 0; s < L; ++s) {
        if (ckpt != nullptr && t0 + s == next_ck) {
          save_state(t0 + s);
          next_ck += chunk;
        }
        walk(s);
      }
    }
    cp_async_wait_all();
    if (n + 1 < ntiles) {
      unpack_tile<E, N, kTile, 4>(buf + (p ^ 1) * 4 * kTile * N, raw, 0xf,
                                  min(kTile, T - t0 - kTile));
    }
    __syncthreads();  // the next tile is staged; this tile's partial sums are complete
  }
  {
    const int p = (ntiles - 1) & 1, t0 = (ntiles - 1) * kTile;
    flush(t0, T - t0, buf + p * 4 * kTile * N + 2 * kTile * N, ruk + p * kTile);
  }
#pragma unroll
  for (int ri = 0; ri < 4; ++ri)
    *reinterpret_cast<float2*>(s_out + pair * N * N + (i0 + ri) * N + j0) =
        make_float2(S[ri][0], S[ri][1]);
}

template <int N>
__global__ void __launch_bounds__(Shape<N>::kThreads, 1)
    rwkv6_fwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u, const float* __restrict__ s0,
                     float* __restrict__ o, float* __restrict__ s_out,
                     float* __restrict__ ckpt, int T, int H, int chunk) {
  fwd_body<float, N>(r, k, v, w, u, s0, o, s_out, ckpt, T, H, chunk);
}

template <int N>
__global__ void __launch_bounds__(Shape<N>::kThreads, 1)
    rwkv6_fwd_bf16_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ w,
                          const float* __restrict__ u, const float* __restrict__ s0,
                          bf16* __restrict__ o, float* __restrict__ s_out,
                          float* __restrict__ ckpt, int T, int H, int chunk) {
  fwd_body<bf16, N>(r, k, v, w, u, s0, o, s_out, ckpt, T, H, chunk);
}

// ----------------------------------------------------------------- backward
// One unit of the backward's pipeline: a forward pass over sub-chunk s of
// chunk c that leaves the start state of sub-chunk s + 1 in shared memory
// (fwd), or the reverse walk of sub-chunk s (!fwd).  For each chunk, from
// the last: forward passes over sub-chunks 0 .. ns - 2, then the reverse
// walks of ns - 1 .. 0.  `first` marks a chunk's first unit, whose staging
// also brings the chunk's saved start state.
struct Unit {
  int c, s;
  bool fwd, first;
};

__device__ __forceinline__ int n_sub(int c, int T, int chunk) {
  return (min(chunk, T - c * chunk) + kSub - 1) / kSub;
}

__device__ __forceinline__ Unit chunk_start(int c, int T, int chunk) {
  return n_sub(c, T, chunk) > 1 ? Unit{c, 0, true, true} : Unit{c, 0, false, true};
}

__device__ __forceinline__ bool next_unit(Unit& u, int T, int chunk) {
  const int ns = n_sub(u.c, T, chunk);
  if (u.fwd) {
    u = u.s + 1 < ns - 1 ? Unit{u.c, u.s + 1, true, false} : Unit{u.c, ns - 1, false, false};
    return true;
  }
  if (u.s > 0) {
    u = Unit{u.c, u.s - 1, false, false};
    return true;
  }
  if (u.c == 0) return false;
  u = chunk_start(u.c - 1, T, chunk);
  return true;
}

template <typename E, int N>
__device__ __forceinline__ void bwd_body(const E* __restrict__ r, const E* __restrict__ k,
                                         const E* __restrict__ v, const E* __restrict__ w,
                                         const float* __restrict__ u,
                                         const E* __restrict__ dout,
                                         const float* __restrict__ ckpt,
                                         const float* __restrict__ ds_final,
                                         E* __restrict__ dr, E* __restrict__ dk,
                                         E* __restrict__ dv, E* __restrict__ dw,
                                         float* __restrict__ du_part, float* __restrict__ ds0,
                                         int T, int H, int chunk) {
  using Sh = Shape<N>;
  constexpr int kRes = N + 4;  // padded row of the dr / dk / dw tile
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* marks = smem;                            // [kMarks][N][N]: sub-chunk start states
  float* buf = marks + kMarks * N * N;            // [2][5: r, k, v, w, dO][kSub][N]
  float* dvp = buf + 2 * 5 * kSub * N;            // [kSub][kWarps][N]: dv's partial sums by warp
  float* res = dvp + kSub * Sh::kWarps * N;       // [kSub][3: dr, dk, dw][kRes]
  float* dots = res + kSub * 3 * kRes;            // [2][2: do . v, sum r u k][kSub]
  float* su = dots + 2 * 2 * kSub;                // [N]
  E* raw = reinterpret_cast<E*>(su + N);          // bf16: [5][kSub][N], the staged copies

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int i0 = 2 * (tid / Sh::kPairLanes), j0 = 4 * (tid % Sh::kPairLanes);
  const size_t step = static_cast<size_t>(H) * N;
  const size_t base = static_cast<size_t>(b) * T * step + static_cast<size_t>(h) * N;
  const size_t pair = static_cast<size_t>(b) * H + h;
  const int nc = (T + chunk - 1) / chunk;
  const E* const streams[5] = {r + base, k + base, v + base, w + base, dout + base};

  for (int x = tid; x < N; x += Sh::kThreads) su[x] = u[h * N + x];
  float G[2][4];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      G[ri][c] = ds_final != nullptr ? ds_final[pair * N * N + (i0 + ri) * N + j0 + c] : 0.f;
  // du sums 4,096 steps per row at the LM path's shape: compensated (Kahan)
  // summation keeps its rounding near one ulp of the result, where a plain
  // running sum of partial sums that wander far from the result would lose
  // about 1e-4.  Thread x < N owns du[x].
  float du_acc = 0.f, du_err = 0.f;

  // A unit's first step and its number of steps.
  auto start = [&](const Unit& un) { return un.c * chunk + un.s * kSub; };
  auto length = [&](const Unit& un) {
    return min(kSub, min(chunk, T - un.c * chunk) - un.s * kSub);
  };
  // A unit's streams (a forward pass needs k, v, w only) and, for a chunk's
  // first unit, the chunk's saved start state into marks[0].
  auto mask = [](const Unit& un) { return un.fwd ? 0xe : 0x1f; };
  auto stage = [&](const Unit& un, float* dst) {
    stage_tile<E, N, kSub>(dst, raw, streams, mask(un), step, start(un), length(un));
    if (un.first) {
      const float* src = ckpt + (pair * nc + un.c) * N * N;
#pragma unroll
      for (int e = 0; e < N * N / Sh::kThreads; ++e) {
        const int idx = tid + e * Sh::kThreads;
        cp_async4(marks + idx, src + idx);
      }
    }
    cp_async_commit();
  };
  // dr, dk, dv, dw of a walked sub-chunk, and its du terms.
  auto flush = [&](const Unit& un, const float* st, const float* dd) {
    const int ts = start(un), L = length(un);
    const float *br = st, *bk = st + kSub * N, *bo = st + 4 * kSub * N;
#pragma unroll
    for (int e = 0; e < kSub * N / Sh::kThreads; ++e) {
      const int idx = tid + e * Sh::kThreads, m = idx / N, x = idx % N;
      if (m < L) {
        float acc = 0.f;
#pragma unroll
        for (int wq = 0; wq < Sh::kWarps; ++wq) acc += dvp[(m * Sh::kWarps + wq) * N + x];
        const float dov = dd[m], ux = su[x];
        const size_t off = base + static_cast<size_t>(ts + m) * step + x;
        dv[off] = narrow<E>(fmaf(bo[idx], dd[kSub + m], acc));
        dr[off] = narrow<E>(fmaf(ux * bk[idx], dov, res[(m * 3 + 0) * kRes + x]));
        dk[off] = narrow<E>(fmaf(ux * br[idx], dov, res[(m * 3 + 1) * kRes + x]));
        dw[off] = narrow<E>(res[(m * 3 + 2) * kRes + x]);
      }
    }
    if (tid < N) {
      for (int m = L - 1; m >= 0; --m) {
        const float du_term = br[m * N + tid] * bk[m * N + tid] * dd[m] - du_err;
        const float du_next = du_acc + du_term;
        du_err = (du_next - du_acc) - du_term;
        du_acc = du_next;
      }
    }
  };

  Unit cur = chunk_start(nc - 1, T, chunk);
  stage(cur, buf);
  cp_async_wait_all();
  __syncthreads();

  Unit prev{0, 0, true, false};
  int n = 0;
  for (;;) {
    const int p = n & 1;
    if constexpr (kIsBf16<E>) {
      // The unit's bf16 copies, widened by the threads that staged them (each
      // waited for its own before the last barrier), then published.  Here,
      // with only the loop's own state live, rather than after the walk.
      unpack_tile<E, N, kSub, 5>(buf + p * 5 * kSub * N, raw, mask(cur), length(cur));
      __syncthreads();
    }
    const float* st = buf + p * 5 * kSub * N;
    const float *br = st, *bk = st + kSub * N, *bv = st + 2 * kSub * N, *bw = st + 3 * kSub * N,
                *bo = st + 4 * kSub * N;
    const int L = length(cur);
    if (!prev.fwd) flush(prev, buf + (p ^ 1) * 5 * kSub * N, dots + (p ^ 1) * 2 * kSub);

    if (!cur.fwd) {
      step_dots<N>(dots + p * 2 * kSub, bo, bv, nullptr, L);
      step_dots<N>(dots + p * 2 * kSub + kSub, br, bk, su, L);
    }
    // The unit's start state, read before the barrier: the staging that
    // follows it may bring the next chunk's start state into marks[0].
    float M[2][4];
    load_tile<N>(M, marks + cur.s * N * N, i0, j0);
    __syncthreads();  // the step dots are in; the previous unit's buffers are free

    Unit nxt = cur;
    const bool more = next_unit(nxt, T, chunk);
    if (more) stage(nxt, buf + (p ^ 1) * 5 * kSub * N);

    if (cur.fwd) {
      for (int m = 0; m < L; ++m) advance<N>(M, M, bk, bw, bv, m, i0, j0);
      store_tile<N>(marks + (cur.s + 1) * N * N, M, i0, j0);
    } else {
      // kReg steps at a time, from the last: S[m] is the state before the
      // sub-chunk's step hs + m, recomputed from its start state.
      for (int hs = (L - 1) / kReg * kReg; hs >= 0; hs -= kReg) {
        float S[kReg][2][4];
        copy_tile(S[0], M);
        for (int m = 0; m < hs; ++m) advance<N>(S[0], S[0], bk, bw, bv, m, i0, j0);
#pragma unroll
        for (int m = 1; m < kReg; ++m)
          if (hs + m < L) advance<N>(S[m], S[m - 1], bk, bw, bv, hs + m - 1, i0, j0);
#pragma unroll
        for (int m = kReg - 1; m >= 0; --m) {
          const int ms = hs + m;  // the step within the sub-chunk
          if (ms >= L) continue;
          const float2 r2 = *reinterpret_cast<const float2*>(br + ms * N + i0);
          const float2 k2 = *reinterpret_cast<const float2*>(bk + ms * N + i0);
          const float2 w2 = *reinterpret_cast<const float2*>(bw + ms * N + i0);
          const float4 v4 = *reinterpret_cast<const float4*>(bv + ms * N + j0);
          const float4 o4 = *reinterpret_cast<const float4*>(bo + ms * N + j0);
          const float rr[2] = {r2.x, r2.y}, kk[2] = {k2.x, k2.y}, ww[2] = {w2.x, w2.y},
                      vv[4] = {v4.x, v4.y, v4.z, v4.w}, oo[4] = {o4.x, o4.y, o4.z, o4.w};
          // dr, dk, dw of rows i0, i0 + 1 over this thread's 4 columns, in
          // slot 2 q + row; dv of its columns over its 2 rows.
          float sums[8], dvs[4];
#pragma unroll
          for (int ri = 0; ri < 2; ++ri) {
            const float(&s4)[4] = S[m][ri];
            const float(&g4)[4] = G[ri];
            float a = oo[0] * s4[0], bb = g4[0] * vv[0], c = g4[0] * s4[0];
#pragma unroll
            for (int x = 1; x < 4; ++x) {
              a = fmaf(oo[x], s4[x], a);
              bb = fmaf(g4[x], vv[x], bb);
              c = fmaf(g4[x], s4[x], c);
            }
            sums[ri] = a;
            sums[2 + ri] = bb;
            sums[4 + ri] = c;
          }
#pragma unroll
          for (int x = 0; x < 4; ++x) dvs[x] = fmaf(G[1][x], kk[1], G[0][x] * kk[0]);
#pragma unroll
          for (int ri = 0; ri < 2; ++ri)
#pragma unroll
            for (int x = 0; x < 4; ++x) G[ri][x] = fmaf(ww[ri], G[ri][x], rr[ri] * oo[x]);
          sums[6] = sums[7] = 0.f;
          const int slot = row_reduce<N>(sums, lane);
          const bool row_leader = N != 64 || (lane & 1) == 0;
#pragma unroll
          for (int x = 0; x < kRowHeld<N>; ++x) {
            const int sl = slot + x;
            if (row_leader && sl < 6) res[(ms * 3 + sl / 2) * kRes + i0 + sl % 2] = sums[x];
          }
          const int col = j0 + col_reduce<N>(dvs, lane);
          float* dst = dvp + (ms * Sh::kWarps + warp) * N + col;
          if constexpr (N == 64) {
            *reinterpret_cast<float2*>(dst) = make_float2(dvs[0], dvs[1]);
          } else if (N == 32 || lane < 16) {
            *dst = dvs[0];
          }
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();  // the next unit is staged; this unit's sums are complete

    prev = cur;
    if (!more) break;
    cur = nxt;
    ++n;
  }
  flush(prev, buf + (n & 1) * 5 * kSub * N, dots + (n & 1) * 2 * kSub);
  if (tid < N) du_part[pair * N + tid] = du_acc;
  if (ds0 != nullptr) {
#pragma unroll
    for (int ri = 0; ri < 2; ++ri)
#pragma unroll
      for (int c = 0; c < 4; ++c) ds0[pair * N * N + (i0 + ri) * N + j0 + c] = G[ri][c];
  }
}

template <int N>
__global__ void __launch_bounds__(Shape<N>::kThreads, 1)
    rwkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u, const float* __restrict__ dout,
                     const float* __restrict__ ckpt, const float* __restrict__ ds_final,
                     float* __restrict__ dr, float* __restrict__ dk, float* __restrict__ dv,
                     float* __restrict__ dw, float* __restrict__ du_part,
                     float* __restrict__ ds0, int T, int H, int chunk) {
  bwd_body<float, N>(r, k, v, w, u, dout, ckpt, ds_final, dr, dk, dv, dw, du_part, ds0, T, H,
                     chunk);
}

template <int N>
__global__ void __launch_bounds__(Shape<N>::kThreads, 1)
    rwkv6_bwd_bf16_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ w,
                          const float* __restrict__ u, const bf16* __restrict__ dout,
                          const float* __restrict__ ckpt, const float* __restrict__ ds_final,
                          bf16* __restrict__ dr, bf16* __restrict__ dk, bf16* __restrict__ dv,
                          bf16* __restrict__ dw, float* __restrict__ du_part,
                          float* __restrict__ ds0, int T, int H, int chunk) {
  bwd_body<bf16, N>(r, k, v, w, u, dout, ckpt, ds_final, dr, dk, dv, dw, du_part, ds0, T, H,
                    chunk);
}

// Dynamic shared memory of each kernel, in bytes (bf16: and its staging
// tile of bf16 copies).
template <typename E, int N>
constexpr size_t fwd_smem() {
  return (2 * 4 * kTile * N + kTile * Shape<N>::kQuads * N + 2 * kTile + N) * sizeof(float) +
         (kIsBf16<E> ? 4 * kTile * N * sizeof(E) : 0);
}

template <typename E, int N>
constexpr size_t bwd_smem() {
  return (kMarks * N * N + 2 * 5 * kSub * N + kSub * Shape<N>::kWarps * N + kSub * 3 * (N + 4) +
          2 * 2 * kSub + N) * sizeof(float) +
         (kIsBf16<E> ? 5 * kSub * N * sizeof(E) : 0);
}

bool bad_shape(int B, int T, int H, int N, int chunk) {
  return B < 1 || B > 65535 || T < 1 || H < 1 || chunk < 1 || chunk > kMaxChunk ||
         !(N == 16 || N == 32 || N == 64);
}

template <typename E, int N>
cudaError_t fwd(const E* r, const E* k, const E* v, const E* w, const float* u, const float* s0,
                E* o, float* s_out, float* ckpt, int B, int T, int H, int chunk, cudaStream_t st) {
  constexpr size_t smem = fwd_smem<E, N>();
  auto* kernel = [] {
    if constexpr (kIsBf16<E>) return rwkv6_fwd_bf16_kernel<N>;
    else return rwkv6_fwd_kernel<N>;
  }();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, B), Shape<N>::kThreads, smem, st>>>(r, k, v, w, u, s0, o, s_out, ckpt, T, H,
                                                        chunk);
  return cudaGetLastError();
}

template <typename E, int N>
cudaError_t bwd(const E* r, const E* k, const E* v, const E* w, const float* u, const E* dout,
                const float* ckpt, const float* ds_final, E* dr, E* dk, E* dv, E* dw,
                float* du_part, float* ds0, int B, int T, int H, int chunk, cudaStream_t st) {
  constexpr size_t smem = bwd_smem<E, N>();
  auto* kernel = [] {
    if constexpr (kIsBf16<E>) return rwkv6_bwd_bf16_kernel<N>;
    else return rwkv6_bwd_kernel<N>;
  }();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, B), Shape<N>::kThreads, smem, st>>>(
      r, k, v, w, u, dout, ckpt, ds_final, dr, dk, dv, dw, du_part, ds0, T, H, chunk);
  return cudaGetLastError();
}

template <typename E>
int fwd_launch(const void* r, const void* k, const void* v, const void* w, const void* u,
               const void* s0, void* o, void* s_out, void* ckpt, int B, int T, int H, int N,
               int chunk, void* stream) {
  if (bad_shape(B, T, H, N, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* rp = static_cast<const E*>(r);
  const auto* kp = static_cast<const E*>(k);
  const auto* vp = static_cast<const E*>(v);
  const auto* wp = static_cast<const E*>(w);
  const auto* up = static_cast<const float*>(u);
  const auto* sp = static_cast<const float*>(s0);
  auto* op = static_cast<E*>(o);
  auto* outp = static_cast<float*>(s_out);
  auto* cp = static_cast<float*>(ckpt);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (N == 16) err = fwd<E, 16>(rp, kp, vp, wp, up, sp, op, outp, cp, B, T, H, chunk, st);
  else if (N == 32) err = fwd<E, 32>(rp, kp, vp, wp, up, sp, op, outp, cp, B, T, H, chunk, st);
  else err = fwd<E, 64>(rp, kp, vp, wp, up, sp, op, outp, cp, B, T, H, chunk, st);
  return static_cast<int>(err);
}

template <typename E>
int bwd_launch(const void* r, const void* k, const void* v, const void* w, const void* u,
               const void* dout, const void* ckpt, const void* ds_final, void* dr, void* dk,
               void* dv, void* dw, void* du_part, void* ds0, int B, int T, int H, int N,
               int chunk, void* stream) {
  if (bad_shape(B, T, H, N, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* rp = static_cast<const E*>(r);
  const auto* kp = static_cast<const E*>(k);
  const auto* vp = static_cast<const E*>(v);
  const auto* wp = static_cast<const E*>(w);
  const auto* up = static_cast<const float*>(u);
  const auto* gp = static_cast<const E*>(dout);
  const auto* cp = static_cast<const float*>(ckpt);
  const auto* fp = static_cast<const float*>(ds_final);
  auto* drp = static_cast<E*>(dr);
  auto* dkp = static_cast<E*>(dk);
  auto* dvp = static_cast<E*>(dv);
  auto* dwp = static_cast<E*>(dw);
  auto* dup = static_cast<float*>(du_part);
  auto* d0p = static_cast<float*>(ds0);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (N == 16)
    err = bwd<E, 16>(rp, kp, vp, wp, up, gp, cp, fp, drp, dkp, dvp, dwp, dup, d0p, B, T, H, chunk,
                     st);
  else if (N == 32)
    err = bwd<E, 32>(rp, kp, vp, wp, up, gp, cp, fp, drp, dkp, dvp, dwp, dup, d0p, B, T, H, chunk,
                     st);
  else
    err = bwd<E, 64>(rp, kp, vp, wp, up, gp, cp, fp, drp, dkp, dvp, dwp, dup, d0p, B, T, H, chunk,
                     st);
  return static_cast<int>(err);
}

}  // namespace

// Forward: o [B,T,H,N] and the final state s_out [B,H,N,N] from r, k, v, w,
// u and the start state s0 (null: zeros); with a non-null ckpt
// [B,H,ceil(T/chunk),N,N], also the state at the start of every chunk.
extern "C" int rwkv6_fwd_launch(const void* r, const void* k, const void* v, const void* w,
                                const void* u, const void* s0, void* o, void* s_out, void* ckpt,
                                int B, int T, int H, int N, int chunk, void* stream) {
  return fwd_launch<float>(r, k, v, w, u, s0, o, s_out, ckpt, B, T, H, N, chunk, stream);
}

// Backward: from r, k, v, w, u, dout, the forward's ckpt and the final
// state's gradient ds_final (null: zeros), write dr, dk, dv, dw [B,T,H,N],
// du_part [B,H,N] (du summed over b by the caller) and, when ds0 is
// non-null, the start state's gradient [B,H,N,N].
extern "C" int rwkv6_bwd_launch(const void* r, const void* k, const void* v, const void* w,
                                const void* u, const void* dout, const void* ckpt,
                                const void* ds_final, void* dr, void* dk, void* dv, void* dw,
                                void* du_part, void* ds0, int B, int T, int H, int N, int chunk,
                                void* stream) {
  return bwd_launch<float>(r, k, v, w, u, dout, ckpt, ds_final, dr, dk, dv, dw, du_part, ds0, B,
                           T, H, N, chunk, stream);
}

// The same with r, k, v, w, dout and o, dr, dk, dv, dw bf16 (4-byte
// aligned); u, the states, ckpt and du_part stay float32.
extern "C" int rwkv6_bf16_fwd_launch(const void* r, const void* k, const void* v, const void* w,
                                     const void* u, const void* s0, void* o, void* s_out,
                                     void* ckpt, int B, int T, int H, int N, int chunk,
                                     void* stream) {
  return fwd_launch<bf16>(r, k, v, w, u, s0, o, s_out, ckpt, B, T, H, N, chunk, stream);
}

extern "C" int rwkv6_bf16_bwd_launch(const void* r, const void* k, const void* v, const void* w,
                                     const void* u, const void* dout, const void* ckpt,
                                     const void* ds_final, void* dr, void* dk, void* dv, void* dw,
                                     void* du_part, void* ds0, int B, int T, int H, int N,
                                     int chunk, void* stream) {
  return bwd_launch<bf16>(r, k, v, w, u, dout, ckpt, ds_final, dr, dk, dv, dw, du_part, ds0, B,
                          T, H, N, chunk, stream);
}
