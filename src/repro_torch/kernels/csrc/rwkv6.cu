// RWKV-6 WKV recurrence for Hopper (sm_90a), forward and backward: the port
// of the Pallas kernel repro/kernels/rwkv6.py::rwkv6_pallas (_wkv_kernel),
// plus the backward that the TPU kernel lacks (there the learner takes
// jax.grad through repro/kernels/ref.py::rwkv6_ref).
//
// float32, in the reference's layout: r, k, v, w [B, T, H, N] (w the decay
// in (0, 1]), u [H, N], states [B, H, N, N] (key x value).  From the start
// state S_0 (zeros when none is given), for t = 1 .. T:
//     o_t[j] = sum_i r_t[i] (S_{t-1}[i, j] + u[i] k_t[i] v_t[j])
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
// Bound on the H100: neither bytes nor operations, but the dependent chain
// in t.  At the LM path's [2, 4096, 64, 64] the training forward moves 5
// streams of 134 MB and 134 MB of chunk-start states (about 0.24 ms at
// 3.35 TB/s) and does 7 N^2 flops per (b, t, h), 15 GFLOP (0.22 ms at
// 67 TFLOP/s); but each of the B * H = 128 (b, h)
// pairs walks 4,096 steps that each depend on the step before, so one block
// per pair on 128 of the 132 SMs runs some hundreds of cycles per step:
// a latency floor near 1 ms that no layout of the same recurrence avoids.
//
// Design:
//   * Forward: one block of N threads per (h, b).  Thread j owns column j
//     of the state, N floats in registers, for the whole sequence; so o_t[j]
//     and the update need no exchange between threads.  The TPU kernel's
//     sequential grid axis over T chunks becomes a loop inside the block
//     over tiles of 32 steps: r, k, v, w of a tile are loaded once, with
//     coalesced reads of the [B, T, H, N] rows at their strides (the Pallas
//     wrapper's transposes to [B, H, T, N] and back are not needed), into
//     shared memory, where every thread reads r_t[i], k_t[i], w_t[i] as a
//     broadcast.  Any T; an optional start state (one more pointer).  When a
//     gradient is wanted, the state at the start of every chunk of `chunk`
//     steps is written to ckpt [B, H, ceil(T / chunk), N, N]: the
//     counterpart of the reference's chunked remat (models/scan_utils.py).
//   * Backward: one block of N threads per (h, b), thread i owning row i of
//     G_t, so dr, dk, dw and du are sums inside a thread and only dv is a
//     sum across threads (through a padded N x (N + 1) tile in shared
//     memory, double-buffered: one barrier per step).  dw_t needs S_{t-1},
//     produced going forward, beside G_t, produced going backward.  So the
//     block walks the chunks in reverse; for each chunk it stages the
//     chunk's r, k, v, w, dO in shared memory, recomputes the chunk's states
//     forward from its saved start state into a per-block global scratch of
//     chunk x N x N floats (each thread writes and later reads only its own
//     row, so the scratch needs no barrier), then runs the reverse steps.
//     S_{t-1} is never rebuilt as (S_t - k v) / w: w reaches 6e-4 (the
//     decay clip of models/ssm.py), and the division would amplify rounding.
//     du is summed with compensation, written per (b, h) and summed over b
//     by the caller; there are no atomics, so gradients are the same from
//     run to run.
// Each kernel launches on the caller's stream and allocates nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;      // forward: time steps staged in shared memory at once
constexpr int kMaxChunk = 64;  // backward: steps per recomputed chunk

template <int N>
__global__ void __launch_bounds__(N)
    rwkv6_fwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u, const float* __restrict__ s0,
                     float* __restrict__ o, float* __restrict__ s_out,
                     float* __restrict__ ckpt, int T, int H, int chunk) {
  __shared__ float sr[kTile][N], sk[kTile][N], sv[kTile][N], sw[kTile][N];
  __shared__ float su[N];
  const int h = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  const size_t step = static_cast<size_t>(H) * N;  // stride of one time step
  const size_t base = static_cast<size_t>(b) * T * step + static_cast<size_t>(h) * N;
  const size_t pair = static_cast<size_t>(b) * H + h;
  const int nc = (T + chunk - 1) / chunk;

  float S[N];
#pragma unroll
  for (int i = 0; i < N; ++i) S[i] = s0 != nullptr ? s0[pair * N * N + i * N + j] : 0.f;
  su[j] = u[h * N + j];

  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int L = min(kTile, T - t0);
    __syncthreads();  // every thread is done with the previous tile
#pragma unroll 8
    for (int s = 0; s < L; ++s) {
      const size_t off = base + static_cast<size_t>(t0 + s) * step + j;
      sr[s][j] = r[off];
      sk[s][j] = k[off];
      sv[s][j] = v[off];
      sw[s][j] = w[off];
    }
    __syncthreads();
    for (int s = 0; s < L; ++s) {
      const int t = t0 + s;
      if (ckpt != nullptr && t % chunk == 0) {
        float* c = ckpt + (pair * nc + t / chunk) * N * N + j;
#pragma unroll
        for (int i = 0; i < N; ++i) c[i * N] = S[i];
      }
      const float vj = sv[s][j];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};  // four chains: the sum is a short dependent chain
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float kv = sk[s][i] * vj;
        acc[i & 3] += sr[s][i] * (S[i] + su[i] * kv);
        S[i] = sw[s][i] * S[i] + kv;
      }
      o[base + static_cast<size_t>(t) * step + j] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) s_out[pair * N * N + i * N + j] = S[i];
}

template <int N>
__global__ void __launch_bounds__(N)
    rwkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u, const float* __restrict__ dout,
                     const float* __restrict__ ckpt, const float* __restrict__ ds_final,
                     float* __restrict__ scratch, float* __restrict__ dr, float* __restrict__ dk,
                     float* __restrict__ dv, float* __restrict__ dw, float* __restrict__ du_part,
                     float* __restrict__ ds0, int T, int H, int chunk) {
  extern __shared__ float smem[];
  float* sr = smem;  // [chunk][N] each
  float* sk = sr + chunk * N;
  float* sv = sk + chunk * N;
  float* sw = sv + chunk * N;
  float* sdo = sw + chunk * N;
  float* su = sdo + chunk * N;  // [N]
  float* P = su + N;            // [2][N][N + 1]: G_t[i, j] k_t[i] at P[j * (N + 1) + i]

  const int h = blockIdx.x, b = blockIdx.y, i = threadIdx.x;
  const size_t step = static_cast<size_t>(H) * N;
  const size_t base = static_cast<size_t>(b) * T * step + static_cast<size_t>(h) * N;
  const size_t pair = static_cast<size_t>(b) * H + h;
  const int nc = (T + chunk - 1) / chunk;
  float* scr = scratch + pair * chunk * N * N + i;  // S_{t-1}[i, j] at scr[(s * N + j) * N]

  su[i] = u[h * N + i];
  const float ui = u[h * N + i];
  float G[N];
#pragma unroll
  for (int j = 0; j < N; ++j) G[j] = ds_final != nullptr ? ds_final[pair * N * N + i * N + j] : 0.f;
  // du sums 4,096 steps per thread at the LM path's shape: compensated
  // (Kahan) summation keeps its rounding near one ulp of the result, where a
  // plain running sum of partial sums that wander far from the result
  // would lose about 1e-4.
  float du_acc = 0.f, du_err = 0.f;
  int parity = 0;

  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * chunk;
    const int L = min(chunk, T - t0);
    __syncthreads();  // every thread is done with the previous chunk's tiles
    for (int s = 0; s < L; ++s) {
      const size_t off = base + static_cast<size_t>(t0 + s) * step + i;
      sr[s * N + i] = r[off];
      sk[s * N + i] = k[off];
      sv[s * N + i] = v[off];
      sw[s * N + i] = w[off];
      sdo[s * N + i] = dout[off];
    }
    __syncthreads();

    // The chunk's states S_{t-1}, row i, forward from its saved start state.
    {
      float S[N];
      const float* cp = ckpt + (pair * nc + c) * N * N + static_cast<size_t>(i) * N;
#pragma unroll
      for (int j = 0; j < N; ++j) S[j] = cp[j];
      for (int s = 0; s < L; ++s) {
        float* dst = scr + static_cast<size_t>(s) * N * N;
        const float ki = sk[s * N + i], wi = sw[s * N + i];
#pragma unroll
        for (int j = 0; j < N; ++j) {
          dst[j * N] = S[j];
          const float kv = ki * sv[s * N + j];
          S[j] = wi * S[j] + kv;
        }
      }
    }

    for (int s = L - 1; s >= 0; --s) {
      const float* ps = scr + static_cast<size_t>(s) * N * N;
      const float* rs = sr + s * N;
      const float* ks = sk + s * N;
      const float* vs = sv + s * N;
      const float* dos = sdo + s * N;
      const float ri = rs[i], ki = ks[i], wi = sw[s * N + i];
      float dov = 0.f, ruk = 0.f;  // do_t . v_t and sum_q r_t[q] u[q] k_t[q], the same in every thread
#pragma unroll
      for (int q = 0; q < N; ++q) {
        dov += dos[q] * vs[q];
        ruk += rs[q] * su[q] * ks[q];
      }
      float* Pc = P + parity * N * (N + 1);
      float a = 0.f, bsum = 0.f, csum = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float sij = ps[j * N];
        const float gj = G[j];
        const float doj = dos[j];
        a += doj * sij;
        bsum += gj * vs[j];
        csum += gj * sij;
        Pc[j * (N + 1) + i] = gj * ki;
        G[j] = wi * gj + ri * doj;
      }
      const size_t off = base + static_cast<size_t>(t0 + s) * step + i;
      dr[off] = a + ui * ki * dov;
      dk[off] = bsum + ui * ri * dov;
      dw[off] = csum;
      const float du_term = ri * ki * dov - du_err;
      const float du_next = du_acc + du_term;
      du_err = (du_next - du_acc) - du_term;
      du_acc = du_next;
      __syncthreads();  // P of this step is complete
      float dvi = 0.f;  // thread i sums column i of P: dv_t[i]
#pragma unroll 8
      for (int q = 0; q < N; ++q) dvi += Pc[i * (N + 1) + q];
      dv[off] = dvi + dos[i] * ruk;
      parity ^= 1;  // the next step writes the other buffer
    }
  }
  du_part[pair * N + i] = du_acc;
  if (ds0 != nullptr) {
#pragma unroll
    for (int j = 0; j < N; ++j) ds0[pair * N * N + static_cast<size_t>(i) * N + j] = G[j];
  }
}

bool bad_shape(int B, int T, int H, int N, int chunk) {
  return B < 1 || B > 65535 || T < 1 || H < 1 || chunk < 1 || chunk > kMaxChunk ||
         !(N == 16 || N == 32 || N == 64);
}

template <int N>
cudaError_t fwd(const float* r, const float* k, const float* v, const float* w, const float* u,
                const float* s0, float* o, float* s_out, float* ckpt, int B, int T, int H,
                int chunk, cudaStream_t st) {
  rwkv6_fwd_kernel<N><<<dim3(H, B), N, 0, st>>>(r, k, v, w, u, s0, o, s_out, ckpt, T, H, chunk);
  return cudaGetLastError();
}

template <int N>
cudaError_t bwd(const float* r, const float* k, const float* v, const float* w, const float* u,
                const float* dout, const float* ckpt, const float* ds_final, float* scratch,
                float* dr, float* dk, float* dv, float* dw, float* du_part, float* ds0, int B,
                int T, int H, int chunk, cudaStream_t st) {
  const size_t smem = (5 * static_cast<size_t>(chunk) * N + N + 2 * N * (N + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(rwkv6_bwd_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  rwkv6_bwd_kernel<N><<<dim3(H, B), N, smem, st>>>(r, k, v, w, u, dout, ckpt, ds_final, scratch,
                                                   dr, dk, dv, dw, du_part, ds0, T, H, chunk);
  return cudaGetLastError();
}

}  // namespace

// Forward: o [B,T,H,N] and the final state s_out [B,H,N,N] from r, k, v, w,
// u and the start state s0 (null: zeros); with a non-null ckpt
// [B,H,ceil(T/chunk),N,N], also the state at the start of every chunk.
extern "C" int rwkv6_fwd_launch(const void* r, const void* k, const void* v, const void* w,
                                const void* u, const void* s0, void* o, void* s_out, void* ckpt,
                                int B, int T, int H, int N, int chunk, void* stream) {
  if (bad_shape(B, T, H, N, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* rp = static_cast<const float*>(r);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  const auto* wp = static_cast<const float*>(w);
  const auto* up = static_cast<const float*>(u);
  const auto* sp = static_cast<const float*>(s0);
  auto* op = static_cast<float*>(o);
  auto* outp = static_cast<float*>(s_out);
  auto* cp = static_cast<float*>(ckpt);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (N == 16) err = fwd<16>(rp, kp, vp, wp, up, sp, op, outp, cp, B, T, H, chunk, st);
  else if (N == 32) err = fwd<32>(rp, kp, vp, wp, up, sp, op, outp, cp, B, T, H, chunk, st);
  else err = fwd<64>(rp, kp, vp, wp, up, sp, op, outp, cp, B, T, H, chunk, st);
  return static_cast<int>(err);
}

// Backward: from r, k, v, w, u, dout, the forward's ckpt and the final
// state's gradient ds_final (null: zeros), with `scratch` a
// [B,H,chunk,N,N] buffer, write dr, dk, dv, dw [B,T,H,N], du_part [B,H,N]
// (du summed over b by the caller) and, when ds0 is non-null, the start
// state's gradient [B,H,N,N].
extern "C" int rwkv6_bwd_launch(const void* r, const void* k, const void* v, const void* w,
                                const void* u, const void* dout, const void* ckpt,
                                const void* ds_final, void* scratch, void* dr, void* dk,
                                void* dv, void* dw, void* du_part, void* ds0, int B, int T, int H,
                                int N, int chunk, void* stream) {
  if (bad_shape(B, T, H, N, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* rp = static_cast<const float*>(r);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  const auto* wp = static_cast<const float*>(w);
  const auto* up = static_cast<const float*>(u);
  const auto* gp = static_cast<const float*>(dout);
  const auto* cp = static_cast<const float*>(ckpt);
  const auto* fp = static_cast<const float*>(ds_final);
  auto* scr = static_cast<float*>(scratch);
  auto* drp = static_cast<float*>(dr);
  auto* dkp = static_cast<float*>(dk);
  auto* dvp = static_cast<float*>(dv);
  auto* dwp = static_cast<float*>(dw);
  auto* dup = static_cast<float*>(du_part);
  auto* d0p = static_cast<float*>(ds0);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (N == 16)
    err = bwd<16>(rp, kp, vp, wp, up, gp, cp, fp, scr, drp, dkp, dvp, dwp, dup, d0p, B, T, H,
                  chunk, st);
  else if (N == 32)
    err = bwd<32>(rp, kp, vp, wp, up, gp, cp, fp, scr, drp, dkp, dvp, dwp, dup, d0p, B, T, H,
                  chunk, st);
  else
    err = bwd<64>(rp, kp, vp, wp, up, gp, cp, fp, scr, drp, dkp, dvp, dwp, dup, d0p, B, T, H,
                  chunk, st);
  return static_cast<int>(err);
}
