// Backward designs of the PPO surrogate at vocabulary width that the map of
// csrc/surrogate.cu replaced, built beside it (this file includes it through
// surrogate_fwd_rows.cu, whose block reductions it shares) by
// kernels/surrogate_variants.py and timed there; never part of the port's
// library.  Both take one block of 1024 threads per row and recompute the
// row's logsumexp and entropy from the logits instead of taking the
// forward's saved lse and ent:
//   * three_read (online = 0): a pass for the max, a pass for the exp sums
//     (block_row_stats, as that file's forward), then the write pass: three reads
//     and one write of the logits;
//   * two_read (online = 1): one online pass, each thread carrying a
//     running max m with s = sum_j e_j and t = sum_j e_j (x_j - m),
//     e_j = exp(x_j - m), rescaled as m grows, merged across the block;
//     then the write pass: two reads and one write.

#include "surrogate_fwd_rows.cu"

namespace {

struct OnlineStats {
  float m, s, t;
};

__device__ __forceinline__ OnlineStats merge_stats(OnlineStats a, OnlineStats b) {
  if (b.s == 0.f) return a;  // s is 0 only for a thread that saw no logit
  if (a.s == 0.f) return b;
  const float m = fmaxf(a.m, b.m);
  const float fa = expf(a.m - m);
  const float fb = expf(b.m - m);
  return {m, a.s * fa + b.s * fb, fa * (a.t + a.s * (a.m - m)) + fb * (b.t + b.s * (b.m - m))};
}

__device__ __forceinline__ OnlineStats warp_merge(OnlineStats x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const OnlineStats y = {__shfl_xor_sync(0xffffffffu, x.m, o),
                           __shfl_xor_sync(0xffffffffu, x.s, o),
                           __shfl_xor_sync(0xffffffffu, x.t, o)};
    x = merge_stats(x, y);
  }
  return x;
}

__device__ __forceinline__ RowStats block_row_stats_online(const float* __restrict__ row, int A,
                                                           float* scratch) {
  OnlineStats st = {-INFINITY, 0.f, 0.f};
  for (int j = threadIdx.x; j < A; j += kRowThreads) {
    const float x = row[j];
    if (x > st.m) {
      if (st.s > 0.f) {
        const float f = expf(st.m - x);
        st.t = f * (st.t + st.s * (st.m - x));
        st.s *= f;
      }
      st.m = x;
    }
    const float e = expf(x - st.m);
    st.s += e;
    st.t = fmaf(e, x - st.m, st.t);
  }
  st = warp_merge(st);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    scratch[warp] = st.m;
    scratch[32 + warp] = st.s;
    scratch[64 + warp] = st.t;
  }
  __syncthreads();
  st = warp_merge({scratch[lane], scratch[32 + lane], scratch[64 + lane]});
  const float log_s = logf(st.s);
  RowStats out;
  out.lse = st.m + log_s;
  out.ent = log_s - st.t / st.s;
  return out;
}

template <bool kOnline>
__global__ void __launch_bounds__(kRowThreads) surrogate_bwd_rows_kernel(
    const float* __restrict__ logits, const int64_t* __restrict__ actions,
    const float* __restrict__ values, const float* __restrict__ blp,
    const float* __restrict__ adv, const float* __restrict__ ret, const float* __restrict__ gpg,
    const float* __restrict__ gvf, const float* __restrict__ gent,
    const float* __restrict__ gkl, float* __restrict__ dlogits, float* __restrict__ dvalues,
    float* __restrict__ dblp, float* __restrict__ dadv, float* __restrict__ dret, int A,
    float lo, float hi) {
  __shared__ float scratch[3 * 32];
  const int i = blockIdx.x;
  const float* row = logits + static_cast<size_t>(i) * A;
  RowStats st;
  if constexpr (kOnline) {
    st = block_row_stats_online(row, A, scratch);
  } else {
    st = block_row_stats(row, A, scratch);
  }
  const RowCotangent rc =
      row_cotangent(i, row, A, st.lse, st.ent, actions, values, blp, adv, ret, gpg, gvf, gent,
                    gkl, lo, hi, threadIdx.x == 0, dvalues, dblp, dadv, dret);
  float* drow = dlogits + static_cast<size_t>(i) * A;
  for (int j = threadIdx.x; j < A; j += kRowThreads) drow[j] = dlogit(rc, row[j], j);
}

}  // namespace

// The arguments of ppo_surrogate_bwd_launch without lse and ent, and
// `online` choosing two_read (1) or three_read (0).
extern "C" int ppo_surrogate_bwd_rows_launch(const void* logits, const void* actions,
                                             const void* values, const void* blp, const void* adv,
                                             const void* ret, const void* gpg, const void* gvf,
                                             const void* gent, const void* gkl, void* dlogits,
                                             void* dvalues, void* dblp, void* dadv, void* dret,
                                             int B, int A, float lo, float hi, int online,
                                             void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* lg = static_cast<const float*>(logits);
  const auto* ac = static_cast<const int64_t*>(actions);
  const auto* va = static_cast<const float*>(values);
  const auto* bl = static_cast<const float*>(blp);
  const auto* ad = static_cast<const float*>(adv);
  const auto* re = static_cast<const float*>(ret);
  const auto* g1 = static_cast<const float*>(gpg);
  const auto* g2 = static_cast<const float*>(gvf);
  const auto* g3 = static_cast<const float*>(gent);
  const auto* g4 = static_cast<const float*>(gkl);
  auto* d_lg = static_cast<float*>(dlogits);
  auto* d_v = static_cast<float*>(dvalues);
  auto* d_b = static_cast<float*>(dblp);
  auto* d_a = static_cast<float*>(dadv);
  auto* d_r = static_cast<float*>(dret);
  if (online) {
    surrogate_bwd_rows_kernel<true><<<B, kRowThreads, 0, st>>>(
        lg, ac, va, bl, ad, re, g1, g2, g3, g4, d_lg, d_v, d_b, d_a, d_r, A, lo, hi);
  } else {
    surrogate_bwd_rows_kernel<false><<<B, kRowThreads, 0, st>>>(
        lg, ac, va, bl, ad, re, g1, g2, g3, g4, d_lg, d_v, d_b, d_a, d_r, A, lo, hi);
  }
  return static_cast<int>(cudaGetLastError());
}
