// Map-phase numeric prefix encoding (paper §IV-B) for Hopper.
//
// Replaces the Pallas kernel repro/kernels/prefix_pack.py::prefix_pack.
// For every position i < n it packs tokens[i : i+k] (0 past n) into n_words
// key words of cpw tokens each: base-(V+1) multiply-accumulate, or bit
// shifts left-aligned to 31 bits.  Arithmetic is uint32_t and the result is
// cast to int32_t at the store, which gives jnp's int32 wraparound without
// signed overflow; a left-align shift outside [0, 32) gives 0, as in XLA.
//
// Bound: memory.  It reads 4n bytes and writes 4 * n * n_words bytes; the
// arithmetic is a few integer operations per byte.  A thread that packed
// each position from its k tokens in shared memory loaded k tokens (104 B
// at k = 26) for every 12 B of device memory, which took about as long as
// the byte bound itself.  Design:
// - A persistent grid walks tiles of `block` positions (the Pallas kernel's
//   grid step), rounded up to kP positions a thread.  A CTA stages
//   the tile's tokens and the k - 1 token halo (0 past n) in shared memory,
//   4 tokens a thread a step, with 16-byte loads when the tokens start on a
//   16-byte boundary (the wrapper reads that from the pointer), 4-byte loads
//   otherwise.  The next tile's loads are issued into registers before the
//   current tile is packed, so they are in flight while it is.
// - A thread packs kP consecutive positions.  Word w of its first position
//   takes cpw tokens; each next position rolls the word by one token:
//     base: w' = w * B + in - out * B^cpw,
//     bits: w' = ((w << bits) | in) & (2^(bits * cpw) - 1),
//   where out leaves the window and in enters it.  The base roll is exact
//   under uint32 wraparound for any tokens, since multiply-accumulate mod
//   2^32 is a ring homomorphism; the bit roll is exact while every token is
//   below 2^bits, so a tile holding a wider token (no real corpus does) is
//   packed directly, cpw tokens a word, by all its threads.  That is about
//   k / kP + 2 * n_words shared loads a position instead of k.  The window
//   is read from the shared tile, not held in registers: k is a run-time
//   value, and registers take only compile-time indexes.
// - Threads kP positions apart would hit kP-strided banks; the tile keeps a
//   padding word every 32 tokens, which spreads them over all 32 banks.
// - With two key words (every SAConfig but a wide one) a thread writes its
//   kP positions' words with 16-byte stores, two positions a store.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

namespace {

constexpr int kP = 8;            // positions a thread packs
// 4-token groups a thread stages: a tile of kP * threads positions and its
// halo, at most 16 * threads tokens for k <= kP * threads
constexpr int kStage = 4;
constexpr int kMaxDevices = 64;  // devices whose launch shape is kept

// shared-memory slot of tile token x: a padding word every 32 tokens
__device__ __forceinline__ int slot(int x) { return x + (x >> 5); }

__device__ __forceinline__ uint32_t push(uint32_t acc, uint32_t tok, bool bits,
                                         int nbits, uint32_t base) {
  return bits ? ((acc << nbits) | tok) : (acc * base + tok);
}

// word w of positions l .. l+kP-1 of the tile
__device__ __forceinline__ void pack_word(const uint32_t* tile, int l, int w,
                                          int cpw, bool bits, int nbits,
                                          uint32_t base, uint32_t base_pow,
                                          uint32_t mask, int align, bool roll,
                                          uint32_t (&acc)[kP]) {
  const int o = l + w * cpw;
  uint32_t x = 0;
  for (int j = 0; j < cpw; ++j) x = push(x, tile[slot(o + j)], bits, nbits, base);
  acc[0] = x;
#pragma unroll
  for (int p = 1; p < kP; ++p) {
    if (roll) {
      const uint32_t out = tile[slot(o + p - 1)];
      const uint32_t in = tile[slot(o + p - 1 + cpw)];
      x = bits ? (((x << nbits) | in) & mask) : (x * base + in - out * base_pow);
    } else {
      x = 0;
      for (int j = 0; j < cpw; ++j)
        x = push(x, tile[slot(o + p + j)], bits, nbits, base);
    }
    acc[p] = x;
  }
  if (bits) {
#pragma unroll
    for (int p = 0; p < kP; ++p)
      acc[p] = (align >= 0 && align < 32) ? acc[p] << align : 0u;
  }
}

// the tile's tokens [b0, b0 + span) that this thread stages, 0 at or past
// n: kStage groups of 4, 16 bytes a load on the vector path
__device__ __forceinline__ void load_groups(const int32_t* __restrict__ tokens,
                                            long long n, long long b0, int span,
                                            bool vec, uint4 (&st)[kStage]) {
#pragma unroll
  for (int s = 0; s < kStage; ++s) {
    const int c = 4 * (threadIdx.x + s * blockDim.x);
    if (c >= span) continue;
    const long long p = b0 + c;
    if (vec && p + 4 <= n) {
      st[s] = __ldg(reinterpret_cast<const uint4*>(tokens + p));
    } else {
      st[s].x = p < n ? (uint32_t)tokens[p] : 0u;
      st[s].y = p + 1 < n ? (uint32_t)tokens[p + 1] : 0u;
      st[s].z = p + 2 < n ? (uint32_t)tokens[p + 2] : 0u;
      st[s].w = p + 3 < n ? (uint32_t)tokens[p + 3] : 0u;
    }
  }
}

__global__ void prefix_pack_kernel(const int32_t* __restrict__ tokens,
                                   int32_t* __restrict__ out, long long n,
                                   long long tiles, int k, int cpw, int n_words,
                                   uint32_t base, uint32_t base_pow, int nbits,
                                   int bit_packing, int vec) {
  extern __shared__ uint32_t tile[];  // slot(round_up(tile + k - 1, 4)) words
  const int t_pos = blockDim.x * kP;  // positions a tile
  const int span = t_pos + k - 1;     // tokens a tile reads
  const int l = threadIdx.x * kP;     // the thread's first position in the tile
  const bool bits = bit_packing != 0;
  const int align = 31 - nbits * cpw;
  const uint32_t mask =
      nbits * cpw >= 32 ? 0xffffffffu : ((1u << (nbits * cpw)) - 1u);
  uint4 st[kStage];  // the next tile's tokens, in flight while one is packed
  if (blockIdx.x < tiles) load_groups(tokens, n, blockIdx.x * t_pos, span, vec, st);
  for (long long tix = blockIdx.x; tix < tiles; tix += gridDim.x) {
    const long long b0 = tix * t_pos;
    uint32_t seen = 0;  // the OR of the tokens this thread staged
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      const int c = 4 * (threadIdx.x + s * blockDim.x);
      if (c >= span) continue;
      tile[slot(c)] = st[s].x;
      tile[slot(c + 1)] = st[s].y;
      tile[slot(c + 2)] = st[s].z;
      tile[slot(c + 3)] = st[s].w;
      seen |= st[s].x | st[s].y | st[s].z | st[s].w;
    }
    // the bit roll needs every token of the tile below 2^bits
    const bool roll = !__syncthreads_or(bits && (seen >> nbits) != 0);
    if (tix + gridDim.x < tiles)
      load_groups(tokens, n, b0 + (long long)gridDim.x * t_pos, span, vec, st);
    const long long i0 = b0 + l;
    if (i0 < n) {
      const int cnt = n - i0 < kP ? (int)(n - i0) : kP;
      uint32_t a[kP], b[kP];
      for (int w = 0; w < n_words; w += 2) {
        const bool pair = w + 1 < n_words;
        pack_word(tile, l, w, cpw, bits, nbits, base, base_pow, mask, align,
                  roll, a);
        if (pair)
          pack_word(tile, l, w + 1, cpw, bits, nbits, base, base_pow, mask,
                    align, roll, b);
        if (n_words == 2 && cnt == kP) {
          int4* dst = reinterpret_cast<int4*>(out + 2 * i0);
#pragma unroll
          for (int p = 0; p < kP; p += 2)
            dst[p / 2] = make_int4((int)a[p], (int)b[p], (int)a[p + 1], (int)b[p + 1]);
        } else {
#pragma unroll
          for (int p = 0; p < kP; ++p) {
            if (p < cnt) {
              out[(i0 + p) * n_words + w] = (int32_t)a[p];
              if (pair) out[(i0 + p) * n_words + w + 1] = (int32_t)b[p];
            }
          }
        }
      }
    }
    __syncthreads();  // the tile is read before the next one is staged
  }
}

}  // namespace

// block: positions a tile (a CTA of block / kP threads, rounded up); vec !=
// 0: the caller has checked that tokens start on a 16-byte boundary; out
// must be 16-byte aligned.
extern "C" int prefix_pack_launch(const void* tokens, void* out, long long n,
                                  int k, int cpw, int n_words, int base,
                                  int bits, int bit_packing, int block, int vec,
                                  void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int threads = (block + kP - 1) / kP;
  const int t_pos = threads * kP;
  if (t_pos + k - 1 > 4 * kStage * threads) return (int)cudaErrorInvalidValue;
  const int span4 = (t_pos + k - 1 + 3) & ~3;
  const size_t smem = (size_t)(span4 + (span4 >> 5) + 1) * sizeof(uint32_t);
  uint32_t base_pow = 1;  // B^cpw mod 2^32
  for (int j = 0; j < cpw; ++j) base_pow *= (uint32_t)base;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  // the persistent grid's CTAs, kept per device as (threads, smem) << 32 |
  // ctas, so that a launch at the last shape asks no occupancy
  static std::atomic<unsigned long long> shape[kMaxDevices];
  const unsigned long long key = ((unsigned long long)threads << 20) | smem;
  unsigned long long kept = dev < kMaxDevices ? shape[dev].load() : 0;
  if ((kept >> 32) != key) {
    int sms = 0, resident = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, prefix_pack_kernel, threads, smem);
    if (err != cudaSuccess) return (int)err;
    if (resident < 1) return (int)cudaErrorInvalidConfiguration;
    kept = (key << 32) | (unsigned)(sms * resident);
    if (dev < kMaxDevices) shape[dev].store(kept);
  }
  const long long tiles = (n + t_pos - 1) / t_pos;
  const long long grid = std::min<long long>(tiles, kept & 0xffffffffu);
  prefix_pack_kernel<<<(unsigned int)grid, threads, smem,
                       (cudaStream_t)stream>>>(
      (const int32_t*)tokens, (int32_t*)out, n, tiles, k, cpw, n_words,
      (uint32_t)base, base_pow, bits, bit_packing, vec);
  return (int)cudaGetLastError();
}
