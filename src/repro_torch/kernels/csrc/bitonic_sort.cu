// Per-tile sort of (key_hi, key_lo, val) rows by (key_hi, key_lo).
//
// Replaces the Pallas kernel repro/kernels/bitonic_sort.py::bitonic_sort_tiles.
// Every power-of-two tile of `tile` consecutive rows is sorted on its own,
// ascending by signed (key_hi, key_lo); val rides along; rows with equal
// keys may come out in any order (the network is not stable).  The last
// tile may be short.  The TPU kernel pads it with (int32 max, int32 max)
// keys and cuts the first n rows back out; since the network is not stable,
// a padding row can then sort ahead of a real row with that same key, and
// the real row is lost.  Here each row carries a padding flag that compares
// above every key, so the real rows always fill the front of their tile and
// only those are written.
//
// Bound: bytes (12 bytes read and 12 written a row against
// log2(tile) * (log2(tile) + 1) / 2 compare-exchanges a pair).  Design: one
// CTA a tile.  The tile is loaded into shared memory as order-preserving
// int64 keys (hi in the high word, lo with its sign bit flipped in the low
// word), the values and the padding flags; each of the bitonic network's
// stages is one compare-exchange per pair, min(tile / 2, 1024) threads
// walking the tile / 2 pairs, with __syncthreads between stages.
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_TILE 2048  // 13 bytes a row: 26 KB of shared memory

__device__ __forceinline__ long long fold(int32_t hi, int32_t lo) {
  return (long long)(((unsigned long long)(uint32_t)hi << 32) |
                     (uint32_t)(lo ^ (int32_t)0x80000000));
}

__global__ void bitonic_sort_kernel(const int32_t* __restrict__ key_hi,
                                    const int32_t* __restrict__ key_lo,
                                    const int32_t* __restrict__ val,
                                    int32_t* __restrict__ out_hi,
                                    int32_t* __restrict__ out_lo,
                                    int32_t* __restrict__ out_val, long long n,
                                    int tile) {
  extern __shared__ long long keys[];             // tile folded keys
  int32_t* vals = (int32_t*)(keys + tile);        // tile values
  unsigned char* pad = (unsigned char*)(vals + tile);  // tile padding flags
  const long long base = (long long)blockIdx.x * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const long long g = base + i;
    const bool real = g < n;
    keys[i] = real ? fold(key_hi[g], key_lo[g]) : 0;
    vals[i] = real ? val[g] : 0;
    pad[i] = real ? 0 : 1;
  }
  __syncthreads();
  const int pairs = tile >> 1;
  for (int k = 2; k <= tile; k <<= 1) {
    for (int j = k >> 1; j >= 1; j >>= 1) {
      for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
        const int a = ((p / j) * 2 * j) + (p % j);  // lower index of the pair
        const int b = a + j;
        const bool asc = (a & k) == 0;
        const long long ka = keys[a], kb = keys[b];
        const unsigned char pa = pad[a], pb = pad[b];
        const bool a_gt_b = pa != pb ? pa > pb : ka > kb;
        const bool b_gt_a = pa != pb ? pb > pa : kb > ka;
        if (asc ? a_gt_b : b_gt_a) {
          keys[a] = kb;
          keys[b] = ka;
          pad[a] = pb;
          pad[b] = pa;
          const int32_t v = vals[a];
          vals[a] = vals[b];
          vals[b] = v;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const long long g = base + i;
    if (g < n) {  // real rows fill the front of the tile
      const long long key = keys[i];
      out_hi[g] = (int32_t)(key >> 32);
      out_lo[g] = (int32_t)((uint32_t)key ^ 0x80000000u);
      out_val[g] = vals[i];
    }
  }
}

extern "C" int bitonic_sort_launch(const void* key_hi, const void* key_lo,
                                   const void* val, void* out_hi, void* out_lo,
                                   void* out_val, long long n, int tile,
                                   void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (tile < 1 || tile > MAX_TILE || (tile & (tile - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  int threads = tile >> 1;
  if (threads < 1) threads = 1;
  if (threads > 1024) threads = 1024;
  const size_t smem = (size_t)tile * (sizeof(long long) + sizeof(int32_t) + 1);
  const long long grid = (n + tile - 1) / tile;
  bitonic_sort_kernel<<<(unsigned int)grid, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)key_hi, (const int32_t*)key_lo, (const int32_t*)val,
      (int32_t*)out_hi, (int32_t*)out_lo, (int32_t*)out_val, n, tile);
  return (int)cudaGetLastError();
}
