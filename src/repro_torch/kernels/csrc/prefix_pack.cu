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
// arithmetic is a few integer operations per byte.  Design: one CTA per block
// of B positions stages tokens[b0 : b0+B+k-1] (its block plus the k-1 token
// halo, 0 past n) in shared memory with coalesced loads, so every token is
// read from device memory about once instead of k times; each thread then
// packs one position from shared memory and writes its n_words adjacent
// words.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void prefix_pack_kernel(const int32_t* __restrict__ tokens,
                                   int32_t* __restrict__ out, long long n,
                                   int k, int cpw, int n_words, uint32_t base,
                                   int bits, int bit_packing) {
  extern __shared__ int32_t tile[];  // blockDim.x + k - 1 tokens
  const int b = blockDim.x;
  const long long b0 = (long long)blockIdx.x * b;
  for (int t = threadIdx.x; t < b + k - 1; t += b) {
    const long long p = b0 + t;
    tile[t] = p < n ? tokens[p] : 0;
  }
  __syncthreads();
  const long long i = b0 + threadIdx.x;
  if (i >= n) return;
  const int32_t* win = tile + threadIdx.x;
  const int align = 31 - bits * cpw;
  for (int w = 0; w < n_words; ++w) {
    uint32_t acc = 0;
    for (int j = w * cpw; j < (w + 1) * cpw; ++j) {
      const uint32_t tok = (uint32_t)win[j];
      acc = bit_packing ? ((acc << bits) | tok) : (acc * base + tok);
    }
    if (bit_packing) acc = (align >= 0 && align < 32) ? (acc << align) : 0u;
    out[i * n_words + w] = (int32_t)acc;
  }
}

extern "C" int prefix_pack_launch(const void* tokens, void* out, long long n,
                                  int k, int cpw, int n_words, int base,
                                  int bits, int bit_packing, int block,
                                  void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const long long grid = (n + block - 1) / block;
  const size_t smem = (size_t)(block + k - 1) * sizeof(int32_t);
  prefix_pack_kernel<<<(unsigned int)grid, block, smem,
                       (cudaStream_t)stream>>>(
      (const int32_t*)tokens, (int32_t*)out, n, k, cpw, n_words,
      (uint32_t)base, bits, bit_packing);
  return (int)cudaGetLastError();
}
