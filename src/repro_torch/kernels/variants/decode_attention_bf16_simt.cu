// The bf16 decode-attention kernel the port first shipped (the float32
// kernel's design with the cache read as bf16), kept beside the redesign that replaced it
// (csrc/decode_attention_bf16.cu) so that kernels/decode_variants.py --bf16
// can time the two in one run.  It is never linked into the package's
// library.  Its entry point, decode_attention_bf16_simt_launch, takes the
// parameter list of csrc/decode_attention.cu's decode_attention_launch
// (q, k, v, valid, out, work, tickets, B, W, H, KV, D, valid_row_stride,
// splits, scale, stream), with q, k/v and out bf16 and the split workspace
// float32; decode_variants picks the splits with decode_splits and
// allocates the workspace and the zeroed tickets as that wrapper does.
//
// The design, as the float32 kernel's note tells it: the grid is (B, KV,
// chunks of up to HEADS query heads of a group, splits of the window W); a
// block of 8 warps walks its split, warp w the slots w, w + 8, ..., its
// valid ones only, the K and V rows of U valid slots in flight in registers
// (an 8-byte load of four bf16 a lane, widened exactly to fp32), folded
// into the online softmax of every head of its chunk (scores by a 5-level
// shuffle reduction); the 8 warps' states merged through shared memory a
// head at a time; with more than one split each block writes its state to
// the workspace [B, KV, splits, g, D + 2], and the last block of the group
// to take its ticket (after a __threadfence) merges the splits in split
// order.  Scores, softmax and sums in fp32, the output rounded to bf16
// once; bitwise repeatable.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 256;

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float4 axpby4(float4 acc, float alpha, float p, float4 v) {
  return make_float4(acc.x * alpha + p * v.x, acc.y * alpha + p * v.y, acc.z * alpha + p * v.z,
                     acc.w * alpha + p * v.w);
}

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// Elements 4 ci .. 4 ci + 3 of a row, as fp32 (a bf16 value widens exactly).
__device__ __forceinline__ float4 load4(const float* row, int ci) {
  return reinterpret_cast<const float4*>(row)[ci];
}

__device__ __forceinline__ float4 load4(const bf16* row, int ci) {
  const uint2 u = reinterpret_cast<const uint2*>(row)[ci];
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// x into elements 4 ci .. 4 ci + 3 of a row (rounded to bf16 once).
__device__ __forceinline__ void store4(float* row, int ci, float4 x) {
  reinterpret_cast<float4*>(row)[ci] = x;
}

__device__ __forceinline__ void store4(bf16* row, int ci, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  reinterpret_cast<uint2*>(row)[ci] = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                                 *reinterpret_cast<const uint32_t*>(&hi));
}

// x into elements 2 c, 2 c + 1 of a row.
__device__ __forceinline__ void store2(float* row, int c, float2 x) {
  reinterpret_cast<float2*>(row)[c] = x;
}

__device__ __forceinline__ void store2(bf16* row, int c, float2 x) {
  reinterpret_cast<__nv_bfloat162*>(row)[c] = __floats2bfloat162_rn(x.x, x.y);
}

// Slots whose K and V rows a warp keeps in flight in registers,
// and the blocks per SM its registers are capped for: fewer rows for a
// wider state (heads x float4 chunks a lane of accumulators), so that the
// grid of the RLHF path (320 blocks of one head) fits one wave on 132 SMs.
__host__ __device__ constexpr int unroll_for(int heads, int chunks) {
  return heads * chunks <= 8 ? 4 : 2;
}

__host__ __device__ constexpr int min_blocks(int heads, int chunks) {
  return heads * chunks == 1 ? 3 : heads * chunks <= 8 ? 2 : 1;
}

// The valid slots of one warp, in order: candidate j is the slot kWarps * j
// past `mask`, for j < n.  The mask is read 32 candidates at a time, one
// byte a lane, the next 32 a step ahead.  Every call is warp-uniform.
struct SlotCursor {
  const uint8_t* mask;
  int n;          // candidates
  int j0;         // first candidate of `bits`
  unsigned bits;  // valid candidates of j0 .. j0 + 31 not yet taken
  bool ahead;     // this lane's candidate of the next 32

  __device__ __forceinline__ void init(const uint8_t* m, int count, int lane) {
    mask = m;
    n = count;
    j0 = 0;
    const bool now = lane < n && mask[kWarps * lane];
    ahead = 32 + lane < n && mask[kWarps * (32 + lane)];
    bits = __ballot_sync(0xffffffffu, now);
  }

  // Offset in slots of the next valid slot past `mask`, or -1.
  __device__ __forceinline__ int next(int lane) {
    while (bits == 0) {
      if (j0 + 32 >= n) return -1;
      j0 += 32;
      bits = __ballot_sync(0xffffffffu, ahead);
      const int j = j0 + 32 + lane;
      ahead = j < n && mask[kWarps * j];
    }
    const int bit = __ffs(bits) - 1;
    bits &= bits - 1;
    return kWarps * (j0 + bit);
  }
};

// Fold U slots' rows (on[u] false: no slot) into the online state of the
// chunk's heads: one rescale for the U slots.
template <int HEADS, int CHUNKS, int U>
__device__ __forceinline__ void fold(const float4 (*qs)[32 * CHUNKS], int lane,
                                     const float4 (&kr)[U][CHUNKS], const float4 (&vr)[U][CHUNKS],
                                     const bool (&on)[U], float4 (&acc)[HEADS][CHUNKS],
                                     float (&m)[HEADS], float (&l)[HEADS], int nh, float scale) {
#pragma unroll
  for (int j = 0; j < HEADS; ++j) {
    if (j >= nh) break;  // block-uniform
    float s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      s[u] = 0.f;
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) s[u] += dot4(qs[j][lane + 32 * c], kr[u][c]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
    }
    float m_new = m[j];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      s[u] *= scale;
      if (on[u]) m_new = fmaxf(m_new, s[u]);
    }
    const float alpha = expf(m[j] - m_new);
    float lj = l[j] * alpha;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      acc[j][c] = make_float4(acc[j][c].x * alpha, acc[j][c].y * alpha, acc[j][c].z * alpha,
                              acc[j][c].w * alpha);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float p = on[u] ? expf(s[u] - m_new) : 0.f;
      lj += p;
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) acc[j][c] = axpby4(acc[j][c], 1.f, p, vr[u][c]);
    }
    l[j] = lj;
    m[j] = m_new;
  }
}

// Take U valid slots, load all their rows, then fold.
template <int HEADS, int CHUNKS, typename Elt>
__device__ __forceinline__ void walk_registers(SlotCursor& cur, const Elt* kb, const Elt* vb,
                                               size_t slot_stride, int nchunk, int lane,
                                               const float4 (*qs)[32 * CHUNKS],
                                               float4 (&acc)[HEADS][CHUNKS], float (&m)[HEADS],
                                               float (&l)[HEADS], int nh, float scale) {
  constexpr int U = unroll_for(HEADS, CHUNKS);
  for (;;) {
    int slot[U];
    bool on[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      slot[u] = cur.next(lane);
      on[u] = slot[u] >= 0;
    }
    if (!on[0]) break;
    float4 kr[U][CHUNKS], vr[U][CHUNKS];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const size_t off = static_cast<size_t>(on[u] ? slot[u] : 0) * slot_stride;
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        const int ci = lane + 32 * c;
        const bool in = on[u] && ci < nchunk;
        kr[u][c] = in ? load4(kb + off, ci) : zero4();
        vr[u][c] = in ? load4(vb + off, ci) : zero4();
      }
    }
    fold<HEADS, CHUNKS, U>(qs, lane, kr, vr, on, acc, m, l, nh, scale);
    if (!on[U - 1]) break;
  }
}

// Merge the splits' states of one group, in split order, into the output
// rows of heads [head0, head0 + nh) of a group; work: [splits, g, D + 2].
template <typename Elt>
__device__ __forceinline__ void merge_splits(const float* work, Elt* out, int splits, int g,
                                             int head0, int nh, int D) {
  const int pairs = D / 2;
  const size_t row = static_cast<size_t>(D) + 2;
  for (int t = threadIdx.x; t < nh * pairs; t += blockDim.x) {
    const int j = head0 + t / pairs;
    const int c = t % pairs;
    float mx = kNegInf;
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, __ldcg(work + (s * g + j) * row + D));
    float lt = 0.f;
    float2 o = make_float2(0.f, 0.f);
    for (int s = 0; s < splits; ++s) {
      const float* w = work + (s * g + j) * row;
      const float f = expf(__ldcg(w + D) - mx);
      lt += __ldcg(w + D + 1) * f;
      const float2 a = __ldcg(reinterpret_cast<const float2*>(w) + c);
      o.x += f * a.x;
      o.y += f * a.y;
    }
    store2(out + j * D, c, lt > 0.f ? make_float2(o.x / lt, o.y / lt) : make_float2(0.f, 0.f));
  }
}

// HEADS: query heads per block; CHUNKS: chunks of 4 elements per lane
// (D <= 128 * CHUNKS).
template <int HEADS, int CHUNKS, typename Elt>
__device__ __forceinline__ void decode_attention(
    const Elt* __restrict__ q, const Elt* __restrict__ k, const Elt* __restrict__ v,
    const uint8_t* __restrict__ valid, Elt* __restrict__ out, float* __restrict__ work,
    unsigned* __restrict__ tickets, int W, int H, int KV, int D, int valid_row_stride, int splits,
    int split_len, float scale) {
  const int g = H / KV;
  const int chunks = (g + HEADS - 1) / HEADS;
  const int split = blockIdx.x % splits;
  const int group = blockIdx.x / splits;  // (b * KV + kv head) * chunks + chunk
  const int chunk = group % chunks;
  const int pair = group / chunks;  // b * KV + kv head
  const int kvh = pair % KV;
  const int b = pair / KV;
  const int head0 = chunk * HEADS;  // first head of this chunk, within the group
  const int nh = min(HEADS, g - head0);
  const int h0 = kvh * g + head0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nchunk = D / 4;

  // The chunk's queries in shared memory (zeros past D), read by every warp.
  __shared__ float4 s_q[HEADS][32 * CHUNKS];
  const Elt* qb = q + (static_cast<size_t>(b) * H + h0) * D;
  for (int t = threadIdx.x; t < nh * 32 * CHUNKS; t += kThreads) {
    const int j = t / (32 * CHUNKS);
    const int ci = t % (32 * CHUNKS);
    s_q[j][ci] = ci < nchunk ? load4(qb + j * D, ci) : zero4();
  }
  float4 acc[HEADS][CHUNKS];
  float m[HEADS], l[HEADS];
#pragma unroll
  for (int j = 0; j < HEADS; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) acc[j][c] = zero4();
  }

  // This warp's candidates: slots w0 + warp + kWarps * j below w1.
  const int w0 = split * split_len;
  const int w1 = min(W, w0 + split_len);
  const int n = w1 - w0 > warp ? (w1 - w0 - warp + kWarps - 1) / kWarps : 0;
  const size_t slot_stride = static_cast<size_t>(KV) * D;
  const size_t first = (static_cast<size_t>(b) * W + w0 + warp) * slot_stride + kvh * D;
  SlotCursor cur;
  cur.init(valid + static_cast<size_t>(b) * valid_row_stride + w0 + warp, n, lane);
  __syncthreads();  // s_q
  walk_registers<HEADS, CHUNKS>(cur, k + first, v + first, slot_stride, nchunk, lane, s_q, acc, m,
                                l, nh, scale);

  // Merge the warps' states in warp order, one head at a time.
  __shared__ float4 s_acc[kWarps][kMaxD / 4];
  __shared__ float s_m[kWarps], s_l[kWarps];
  Elt* ob = out + (static_cast<size_t>(b) * H + h0) * D;
  float* wb = work + ((static_cast<size_t>(pair) * splits + split) * g + head0) * (D + 2);
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
      float4 o = zero4();
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(s_m[w] - mx);
        lt += s_l[w] * f;
        o = axpby4(o, 1.f, f, s_acc[w][ci]);
      }
      if (splits == 1) {
        // l == 0 iff no slot was valid: attention over an empty cache is zeros.
        store4(ob + j * D, ci,
               lt > 0.f ? make_float4(o.x / lt, o.y / lt, o.z / lt, o.w / lt) : zero4());
      } else {
        float2* wr = reinterpret_cast<float2*>(wb + j * (D + 2));
        wr[2 * ci] = make_float2(o.x, o.y);
        wr[2 * ci + 1] = make_float2(o.z, o.w);
        if (ci == 0) wr[nchunk * 2] = make_float2(mx, lt);
      }
    }
    __syncthreads();
  }
  if (splits == 1) return;

  // The last block of the group to finish merges every split's state.
  __shared__ bool s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(tickets + group, 1u) == static_cast<unsigned>(splits - 1);
    if (s_last) tickets[group] = 0u;  // every block of the group has taken its ticket
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  merge_splits(work + static_cast<size_t>(pair) * splits * g * (D + 2), out +
               (static_cast<size_t>(b) * H + kvh * g) * D, splits, g, head0, nh, D);
}

template <int HEADS, int CHUNKS>
__global__ void __launch_bounds__(kThreads, min_blocks(HEADS, CHUNKS))
    decode_attention_bf16_simt_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                      const bf16* __restrict__ v, const uint8_t* __restrict__ valid,
                                      bf16* __restrict__ out, float* __restrict__ work,
                                      unsigned* __restrict__ tickets, int W, int H, int KV, int D,
                                      int valid_row_stride, int splits, int split_len,
                                      float scale) {
  decode_attention<HEADS, CHUNKS>(q, k, v, valid, out, work, tickets, W, H, KV, D,
                                  valid_row_stride, splits, split_len, scale);
}

// The kernel of an element type.
template <int HEADS, int CHUNKS, typename Elt>
auto entry() {
  static_assert(std::is_same_v<Elt, bf16>, "the bf16 kernel alone");
  return decode_attention_bf16_simt_kernel<HEADS, CHUNKS>;
}

template <int HEADS, int CHUNKS, typename Elt>
cudaError_t launch(const Elt* q, const Elt* k, const Elt* v, const uint8_t* valid, Elt* out,
                   float* work, unsigned* tickets, int B, int W, int H, int KV, int D,
                   int valid_row_stride, int splits, float scale, cudaStream_t stream) {
  const int g = H / KV;
  const long long groups = static_cast<long long>(B) * KV * ((g + HEADS - 1) / HEADS);
  if (groups * splits > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int split_len = (W + splits - 1) / splits;
  const auto kernel = entry<HEADS, CHUNKS, Elt>();
  kernel<<<static_cast<unsigned>(groups * splits), kThreads, 0, stream>>>(
      q, k, v, valid, out, work, tickets, W, H, KV, D, valid_row_stride, splits, split_len, scale);
  return cudaGetLastError();
}

template <int CHUNKS, typename Elt>
cudaError_t launch_heads(const Elt* q, const Elt* k, const Elt* v, const uint8_t* valid,
                         Elt* out, float* work, unsigned* tickets, int B, int W, int H, int KV,
                         int D, int valid_row_stride, int splits, float scale,
                         cudaStream_t stream) {
  const int g = H / KV;
#define DECODE_LAUNCH(HEADS)                                                                    \
  launch<HEADS, CHUNKS>(q, k, v, valid, out, work, tickets, B, W, H, KV, D, valid_row_stride, \
                        splits, scale, stream)
  if (g == 1) return DECODE_LAUNCH(1);
  if (g == 2) return DECODE_LAUNCH(2);
  if (g <= 4) return DECODE_LAUNCH(4);
  return DECODE_LAUNCH(8);
#undef DECODE_LAUNCH
}

// Checks the sizes and launches; Elt is the element type of q, k, v, out.
template <typename Elt>
int launch_checked(const void* q, const void* k, const void* v, const void* valid, void* out,
                   void* work, void* tickets, int B, int W, int H, int KV, int D,
                   int valid_row_stride, int splits, float scale, void* stream) {
  if (B <= 0 || W <= 0 || KV <= 0 || H % KV != 0 || D % 4 != 0 || D < 4 || D > kMaxD ||
      splits < 1 || splits > W || (splits > 1 && (work == nullptr || tickets == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* qp = static_cast<const Elt*>(q);
  const auto* kp = static_cast<const Elt*>(k);
  const auto* vp = static_cast<const Elt*>(v);
  const auto* mp = static_cast<const uint8_t*>(valid);
  auto* op = static_cast<Elt*>(out);
  auto* wp = static_cast<float*>(work);
  auto* tp = static_cast<unsigned*>(tickets);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      D <= 128
          ? launch_heads<1>(qp, kp, vp, mp, op, wp, tp, B, W, H, KV, D, valid_row_stride, splits,
                            scale, st)
          : launch_heads<2>(qp, kp, vp, mp, op, wp, tp, B, W, H, KV, D, valid_row_stride, splits,
                            scale, st);
  return static_cast<int>(err);
}

}  // namespace

// q [B,1,H,D], k/v [B,W,KV,D] bf16, valid [B,W] uint8 (row stride 0 or W),
// out [B,1,H,D] bf16; with splits > 1, work [B,KV,splits,H/KV,D+2] float32
// and tickets (one zeroed unsigned per group, at least B * H of them, left
// zeroed).  Needs H % KV == 0, D % 4 == 0, 4 <= D <= 256, 1 <= splits <= W
// and 16-byte-aligned q, k, v, out.
extern "C" int decode_attention_bf16_simt_launch(const void* q, const void* k, const void* v,
                                                 const void* valid, void* out, void* work,
                                                 void* tickets, int B, int W, int H, int KV, int D,
                                                 int valid_row_stride, int splits, float scale,
                                                 void* stream) {
  return launch_checked<bf16>(q, k, v, valid, out, work, tickets, B, W, H, KV, D,
                              valid_row_stride, splits, scale, stream);
}
