// Threefry-2x32 (20 rounds) over per-lane PRNG keys, as jax.random computes
// it under JAX 0.9's partitionable counters (jax_threefry_partitionable on).
//
// Port-only: no Pallas kernel replaces this.  The JAX package hashes inside
// XLA (jax.random.split / fold_in / bits under vmap), where it fuses with
// its neighbours; the port's plain version (kernels/threefry.py,
// threefry_plain) is some 140 int64 elementwise launches a hash, which made
// keyed acting host-bound on the card.  Here one launch does one hash of
// every (lane, counter) pair.
//
// Representation: the port keeps uint32 key words in int64 tensors.  A key
// row is two int64 words at keys[l * key_stride + {0, 1}]; the kernel reads
// their low 32 bits (the plain version's `& 0xFFFFFFFF`) and writes uint32
// words zero-extended into int64.
//
//   threefry_counts_launch: lane keys [L, 2] and counters 0 .. n-1, each
//     counter c hashed as the pair (c >> 32, c & 0xFFFFFFFF).  mode 0 writes
//     both words as keys [L, n, 2] (jax.random.split), mode 1 their xor
//     [L, n] (jax.random.bits, uint32).  A block of 256 threads covers
//     256 >> shift lanes of 1 << shift counters each (shift = ceil(log2 n)
//     for n <= 256, else 8 and blockIdx.x walks the counters), so no thread
//     divides; grid.y walks the lane groups.
//   threefry_fold_in_launch: keys [L, 2] (or one key, key_stride 0) and data
//     [L] (or one word, data_stride 0) -> keys [L, 2], the hash of the pair
//     (0, data) (jax.random.fold_in).
//
// Bound: the arithmetic.  A hash is 20 rounds of (add, funnel-shift rotate,
// xor), 60 instructions, plus the six injections into x1 (one add each:
// the word, the key and the constant), the last injection into x0 (the other
// five fold with the next round's add into one IADD3) and the parity word
// (one LOP3): 68 int32 instructions, one thread each, in registers.  The 41
// shifts and logic (SHF, LOP3) run on the ALU pipe alone, 64 lanes an SM a
// clock on the H100's 132 SMs; ptxas issues 18 of the 27 adds as IMAD.IADD on
// the FMA pipe beside it, and an SM issues 128 instructions a clock, so the
// least time of a hash is that of its 41 ALU instructions.  The
// bytes are only the words written (16 B a counter for keys, 8 B for bits).
// Every path of the port hashes a few to a few hundred thousand counters,
// so a launch's own floor (about 0.9 us) dominates all but PPO-LM's
// sampling over 151,936 tokens.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define THREEFRY_ROUND(r) \
  x0 += x1;               \
  x1 = rotl(x1, r) ^ x0;

// Hash the counter pair (x0, x1) in place under the key (k0, k1).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  THREEFRY_ROUND(13) THREEFRY_ROUND(15) THREEFRY_ROUND(26) THREEFRY_ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  THREEFRY_ROUND(17) THREEFRY_ROUND(29) THREEFRY_ROUND(16) THREEFRY_ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  THREEFRY_ROUND(13) THREEFRY_ROUND(15) THREEFRY_ROUND(26) THREEFRY_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  THREEFRY_ROUND(17) THREEFRY_ROUND(29) THREEFRY_ROUND(16) THREEFRY_ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  THREEFRY_ROUND(13) THREEFRY_ROUND(15) THREEFRY_ROUND(26) THREEFRY_ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
}

#undef THREEFRY_ROUND

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads)
    threefry_counts_kernel(const int64_t* __restrict__ keys, int64_t key_stride, int64_t lanes,
                           int64_t n, int shift, int64_t lane_groups, int64_t* __restrict__ out,
                           int xor_words) {
  const uint64_t c = static_cast<uint64_t>(blockIdx.x) * (1ull << shift) +
                     (threadIdx.x & ((1u << shift) - 1u));
  if (c >= static_cast<uint64_t>(n)) return;
  const int lanes_per_block = kThreads >> shift;
  const int lane_in_block = static_cast<int>(threadIdx.x >> shift);
  for (int64_t g = blockIdx.y; g < lane_groups; g += gridDim.y) {
    const int64_t lane = g * lanes_per_block + lane_in_block;
    if (lane >= lanes) return;
    const int64_t* k = keys + lane * key_stride;
    uint32_t x0 = static_cast<uint32_t>(c >> 32);
    uint32_t x1 = static_cast<uint32_t>(c);
    threefry2x32(static_cast<uint32_t>(k[0]), static_cast<uint32_t>(k[1]), x0, x1);
    const int64_t i = lane * n + static_cast<int64_t>(c);
    if (xor_words) {
      out[i] = static_cast<int64_t>(x0 ^ x1);
    } else {
      out[2 * i] = static_cast<int64_t>(x0);
      out[2 * i + 1] = static_cast<int64_t>(x1);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    threefry_fold_in_kernel(const int64_t* __restrict__ keys, int64_t key_stride,
                            const int64_t* __restrict__ data, int64_t data_stride, int64_t lanes,
                            int64_t* __restrict__ out) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= lanes) return;
  const int64_t* k = keys + lane * key_stride;
  uint32_t x0 = 0u;
  uint32_t x1 = static_cast<uint32_t>(data[lane * data_stride]);
  threefry2x32(static_cast<uint32_t>(k[0]), static_cast<uint32_t>(k[1]), x0, x1);
  out[2 * lane] = static_cast<int64_t>(x0);
  out[2 * lane + 1] = static_cast<int64_t>(x1);
}

}  // namespace

extern "C" int threefry_counts_launch(const void* keys, long long key_stride, long long lanes,
                                      long long n, void* out, int xor_words, void* stream) {
  if (lanes <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  int shift = 0;
  while (shift < 8 && (1ll << shift) < n) ++shift;
  const long long cols = 1ll << shift;
  const long long lane_groups = (lanes + (kThreads >> shift) - 1) / (kThreads >> shift);
  const long long blocks_x = (n + cols - 1) / cols;
  if (blocks_x > 0x7FFFFFFFll) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks_x),
                  static_cast<unsigned>(lane_groups < kMaxGridY ? lane_groups : kMaxGridY));
  threefry_counts_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), key_stride, lanes, n, shift, lane_groups,
      static_cast<int64_t*>(out), xor_words);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int threefry_fold_in_launch(const void* keys, long long key_stride, const void* data,
                                       long long data_stride, long long lanes, void* out,
                                       void* stream) {
  if (lanes <= 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (lanes + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFll) return static_cast<int>(cudaErrorInvalidValue);
  threefry_fold_in_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), key_stride, static_cast<const int64_t*>(data),
      data_stride, lanes, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
