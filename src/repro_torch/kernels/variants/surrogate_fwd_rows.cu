// The forward design of the PPO surrogate at vocabulary width that the
// chunked map of csrc/surrogate.cu replaced, built beside it (this file
// includes it) by kernels/surrogate_variants.py and timed there; never part
// of the port's library.  One block of 1024 threads per row makes two
// coalesced passes over the row: the max, then s = sum_j e_j and
// t = sum_j e_j (x_j - max) with e_j = exp(x_j - max), each tree-reduced
// (warp shuffles, then shared memory); H = log s - t / s.  At [128, 151936]
// that is 128 blocks on 132 SMs, and the second pass finds most of the 78 MB
// of logits gone from the 50 MB L2.

#include "../csrc/surrogate.cu"

namespace {

constexpr int kRowThreads = 1024;

// Block-wide reduction over kRowThreads threads; every thread gets the result.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  __syncthreads();  // scratch is free (an earlier reduction may still read it)
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  x = scratch[lane];  // kRowThreads / 32 == 32 partials
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  return x;
}

struct RowStats {
  float lse;  // logsumexp of the row
  float ent;  // entropy of its softmax
};

// Two coalesced passes over one row: the max, then s = sum_j e_j and
// t = sum_j e_j (x_j - max) with e_j = exp(x_j - max).
__device__ __forceinline__ RowStats block_row_stats(const float* __restrict__ row, int A,
                                                    float* scratch) {
  float m = -INFINITY;
  for (int j = threadIdx.x; j < A; j += kRowThreads) m = fmaxf(m, row[j]);
  m = block_reduce<true>(m, scratch);
  float s = 0.f, t = 0.f;
  for (int j = threadIdx.x; j < A; j += kRowThreads) {
    const float x = row[j] - m;
    const float e = expf(x);
    s += e;
    t = fmaf(e, x, t);
  }
  s = block_reduce<false>(s, scratch);
  t = block_reduce<false>(t, scratch);
  const float log_s = logf(s);
  RowStats out;
  out.lse = m + log_s;
  out.ent = log_s - t / s;
  return out;
}

__global__ void __launch_bounds__(kRowThreads) surrogate_fwd_rows_kernel(
    const float* __restrict__ logits, const int64_t* __restrict__ actions,
    const float* __restrict__ values, const float* __restrict__ blp,
    const float* __restrict__ adv, const float* __restrict__ ret, float* __restrict__ pg,
    float* __restrict__ vf, float* __restrict__ ent, float* __restrict__ kl,
    float* __restrict__ lse, int A, float lo, float hi) {
  __shared__ float scratch[32];
  const int i = blockIdx.x;
  const float* row = logits + static_cast<size_t>(i) * A;
  const RowStats st = block_row_stats(row, A, scratch);
  if (threadIdx.x != 0) return;
  const int64_t action = actions[i];
  const bool valid = action >= 0 && action < A;
  write_row_terms(i, st.lse, st.ent, valid ? row[action] - st.lse : 0.f, blp[i], adv[i], values[i],
                  ret[i], pg, vf, ent, kl, lse, lo, hi);
}

}  // namespace

// The arguments of ppo_surrogate_fwd_launch without work and tickets.
extern "C" int ppo_surrogate_fwd_rows_launch(const void* logits, const void* actions,
                                             const void* values, const void* blp, const void* adv,
                                             const void* ret, void* pg, void* vf, void* ent,
                                             void* kl, void* lse, int B, int A, float lo, float hi,
                                             void* stream) {
  surrogate_fwd_rows_kernel<<<B, kRowThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const int64_t*>(actions),
      static_cast<const float*>(values), static_cast<const float*>(blp),
      static_cast<const float*>(adv), static_cast<const float*>(ret), static_cast<float*>(pg),
      static_cast<float*>(vf), static_cast<float*>(ent), static_cast<float*>(kl),
      static_cast<float*>(lse), A, lo, hi);
  return static_cast<int>(cudaGetLastError());
}
