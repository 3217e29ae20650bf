// Single-token decode attention for Hopper (sm_90a): the port of the Pallas
// kernel repro/kernels/decode_attention.py::decode_attention_pallas
// (_decode_kernel).
//
// One query token per sequence against a KV cache, float32 throughout:
//     q [B, 1, H, D], k_cache / v_cache [B, W, KV, D], valid [B, W] bytes
//     (row stride 0 broadcasts one [W] mask over the batch);
//     query head h reads kv head h / g, g = H / KV (GQA);
//     out[b, h] = sum_w p_w v[b, w, h / g],  p = softmax over the valid w of
//     scale * q . k (scale = 1/sqrt(D)); a row with no valid slot gives
//     exact zeros (the reference's empty-cache rule, ref.py:121-123).
//
// Bound on the H100: memory.  A call reads the two caches once,
// 2 * B * W * KV * D * 4 bytes (42 MB at the RLHF path's [8, 256, 20, 128]),
// and does 4 * B * W * H * D flops, two orders of magnitude below the
// card's fp32 rate; the least time is bytes / 3.35 TB/s.
//
// Design: one block per (b, kv head, chunk of up to HEADS query heads of the
// group).  The TPU kernel's sequential grid axis over W becomes a loop
// inside the block: each of the 8 warps takes every 8th cache slot, reads
// its K and V rows once as float4 per lane (a D = 128 row is one coalesced
// 512-byte load per warp), and keeps the online-softmax state (m, l and the
// [HEADS, D] accumulator) of every head of its chunk in registers, so each
// cache row is read once for all the heads that share it.  Invalid slots
// are skipped (the probabilities are masked, not only the scores), and any
// W is taken, ragged or not.  The 8 warps' partial states are merged at the
// end through shared memory.  A kernel launches on the caller's stream and
// allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;
constexpr int kMaxD = 256;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float4 axpby4(float4 acc, float alpha, float p, float4 v) {
  return make_float4(acc.x * alpha + p * v.x, acc.y * alpha + p * v.y, acc.z * alpha + p * v.z,
                     acc.w * alpha + p * v.w);
}

// HEADS: query heads per block; CHUNKS: float4 chunks per lane (D <= 128 * CHUNKS).
template <int HEADS, int CHUNKS>
__global__ void __launch_bounds__(kWarps * 32)
    decode_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const uint8_t* __restrict__ valid,
                            float* __restrict__ out, int W, int H, int KV, int D, int g,
                            int valid_row_stride, float scale) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int head0 = blockIdx.z * HEADS;  // first head of this chunk, within the group
  const int nh = min(HEADS, g - head0);
  const int h0 = kvh * g + head0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nchunk = D / 4;

  float4 qr[HEADS][CHUNKS];
  float4 acc[HEADS][CHUNKS];
  float m[HEADS], l[HEADS];
  const float* qb = q + (static_cast<size_t>(b) * H + h0) * D;
#pragma unroll
  for (int j = 0; j < HEADS; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int ci = lane + 32 * c;
      qr[j][c] = (j < nh && ci < nchunk) ? reinterpret_cast<const float4*>(qb + j * D)[ci]
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
      acc[j][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  const uint8_t* vrow = valid + static_cast<size_t>(b) * valid_row_stride;
  const size_t slot_stride = static_cast<size_t>(KV) * D;
  const float* kb = k + (static_cast<size_t>(b) * W * KV + kvh) * D;
  const float* vb = v + (static_cast<size_t>(b) * W * KV + kvh) * D;
  for (int w = warp; w < W; w += kWarps) {
    if (!vrow[w]) continue;  // warp-uniform: the slot's probability is 0
    const float4* kw = reinterpret_cast<const float4*>(kb + w * slot_stride);
    const float4* vw = reinterpret_cast<const float4*>(vb + w * slot_stride);
    float4 kr[CHUNKS], vr[CHUNKS];
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int ci = lane + 32 * c;
      const bool in = ci < nchunk;
      kr[c] = in ? kw[ci] : make_float4(0.f, 0.f, 0.f, 0.f);
      vr[c] = in ? vw[ci] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < HEADS; ++j) {
      if (j >= nh) break;  // block-uniform
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) part += dot4(qr[j][c], kr[c]);
      const float s = warp_sum(part) * scale;
      const float m_new = fmaxf(m[j], s);
      const float alpha = expf(m[j] - m_new);
      const float p = expf(s - m_new);
      l[j] = l[j] * alpha + p;
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) acc[j][c] = axpby4(acc[j][c], alpha, p, vr[c]);
      m[j] = m_new;
    }
  }

  // Merge the warps' partial softmax states, one head at a time.
  __shared__ float4 s_acc[kWarps][kMaxD / 4];
  __shared__ float s_m[kWarps], s_l[kWarps];
  float* ob = out + (static_cast<size_t>(b) * H + h0) * D;
#pragma unroll
  for (int j = 0; j < HEADS; ++j) {
    if (j >= nh) break;
    if (lane == 0) {
      s_m[warp] = m[j];
      s_l[warp] = l[j];
    }
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int ci = lane + 32 * c;
      if (ci < nchunk) s_acc[warp][ci] = acc[j][c];
    }
    __syncthreads();
    for (int ci = threadIdx.x; ci < nchunk; ci += blockDim.x) {
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w]);
      float lt = 0.f;
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(s_m[w] - mx);
        lt += s_l[w] * f;
        o = axpby4(o, 1.f, f, s_acc[w][ci]);
      }
      // l == 0 iff no slot was valid: attention over an empty cache is zeros.
      const float4 res = lt > 0.f ? make_float4(o.x / lt, o.y / lt, o.z / lt, o.w / lt)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
      reinterpret_cast<float4*>(ob + j * D)[ci] = res;
    }
    __syncthreads();
  }
}

template <int HEADS, int CHUNKS>
cudaError_t launch(const float* q, const float* k, const float* v, const uint8_t* valid,
                   float* out, int B, int W, int H, int KV, int D, int valid_row_stride,
                   float scale, cudaStream_t stream) {
  const int g = H / KV;
  const dim3 grid(B, KV, (g + HEADS - 1) / HEADS);
  decode_attention_kernel<HEADS, CHUNKS><<<grid, kWarps * 32, 0, stream>>>(
      q, k, v, valid, out, W, H, KV, D, g, valid_row_stride, scale);
  return cudaGetLastError();
}

template <int CHUNKS>
cudaError_t launch_heads(const float* q, const float* k, const float* v, const uint8_t* valid,
                         float* out, int B, int W, int H, int KV, int D, int valid_row_stride,
                         float scale, cudaStream_t stream) {
  const int g = H / KV;
  if (g == 1) return launch<1, CHUNKS>(q, k, v, valid, out, B, W, H, KV, D, valid_row_stride, scale, stream);
  if (g == 2) return launch<2, CHUNKS>(q, k, v, valid, out, B, W, H, KV, D, valid_row_stride, scale, stream);
  if (g <= 4) return launch<4, CHUNKS>(q, k, v, valid, out, B, W, H, KV, D, valid_row_stride, scale, stream);
  return launch<8, CHUNKS>(q, k, v, valid, out, B, W, H, KV, D, valid_row_stride, scale, stream);
}

}  // namespace

// q [B,1,H,D], k/v [B,W,KV,D] float32, valid [B,W] uint8 (row stride 0 or
// W), out [B,1,H,D].  Needs H % KV == 0, D % 4 == 0, 4 <= D <= 256 and
// 16-byte-aligned tensors (the Python wrapper checks).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* valid, void* out, int B, int W, int H, int KV,
                                       int D, int valid_row_stride, float scale, void* stream) {
  if (B <= 0 || W <= 0 || KV <= 0 || H % KV != 0 || D % 4 != 0 || D < 4 || D > kMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  const auto* mp = static_cast<const uint8_t*>(valid);
  auto* op = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      D <= 128 ? launch_heads<1>(qp, kp, vp, mp, op, B, W, H, KV, D, valid_row_stride, scale, st)
               : launch_heads<2>(qp, kp, vp, mp, op, B, W, H, KV, D, valid_row_stride, scale, st);
  return static_cast<int>(err);
}
