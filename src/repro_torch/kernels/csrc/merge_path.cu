// Merge-path ranks of one out-of-core merge tile.
//
// Replaces the Pallas kernel repro/kernels/merge_path.py::merge_path_ranks.
// For the (c, w) int32 row matrix `keys` it writes, for every row e < c,
//   ranks[e] = #{ r < c : row r < row e }
// under lexicographic compare of signed int32 words, strictly less, so equal
// rows do not count one another.  The merge's rows end in the two words of
// the global suffix index and are unique, and then the ranks are the merged
// order's permutation.  No padding rows: every read is bounds-checked.
//
// Bound: operations.  Every pair is compared on word 0 at least: c^2 compares
// against c*w*4 bytes read and c*4 written.  The TPU kernel keeps the whole
// (c, w) tile in VMEM; at c = 16384 and w = 6 that is 393 KB, more than a
// CTA's shared memory.  Design: one thread per row e, word 0 of its own row
// in a register.  The CTA streams all c rows through shared memory in chunks
// of at most SMEM_WORDS words; every thread walks the chunk in the same order,
// so each shared-memory read is a broadcast.  A pair that differs on word 0
// (most of them) costs one compare; a tie walks on, reading the thread's own
// deeper words from global memory through the read-only cache, and stops at
// the first word that differs.  w is a run-time argument (1 <= w <=
// SMEM_WORDS).
#include <cuda_runtime.h>
#include <stdint.h>

#define SMEM_WORDS 12288  // 48 KB of int32, no opt-in needed

__global__ void merge_path_ranks_kernel(const int32_t* __restrict__ keys,
                                        int32_t* __restrict__ ranks,
                                        long long c, int w, int chunk_rows) {
  extern __shared__ int32_t tile[];
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = e < c;
  const int32_t* mine = keys + (live ? e : 0) * (long long)w;
  const int32_t a0 = live ? mine[0] : 0;
  int count = 0;
  for (long long base = 0; base < c; base += chunk_rows) {
    const long long left = c - base;
    const int rows = left < chunk_rows ? (int)left : chunk_rows;
    const long long words = (long long)rows * w;
    const int32_t* src = keys + base * w;
    for (long long i = threadIdx.x; i < words; i += blockDim.x) tile[i] = src[i];
    __syncthreads();
    if (live) {
      for (int r = 0; r < rows; ++r) {
        const int32_t* other = tile + (long long)r * w;
        const int32_t b0 = other[0];
        if (b0 != a0) {
          count += b0 < a0;
          continue;
        }
        for (int j = 1; j < w; ++j) {
          const int32_t b = other[j];
          const int32_t a = __ldg(mine + j);
          if (b != a) {
            count += b < a;
            break;
          }
        }
      }
    }
    __syncthreads();
  }
  if (live) ranks[e] = count;
}

extern "C" int merge_path_ranks_launch(const void* keys, void* ranks,
                                       long long c, int w, int threads,
                                       void* stream) {
  if (c <= 0) return (int)cudaSuccess;
  if (w < 1 || w > SMEM_WORDS) return (int)cudaErrorInvalidValue;
  const int chunk_rows = SMEM_WORDS / w;
  const size_t smem = (size_t)chunk_rows * w * sizeof(int32_t);
  const long long grid = (c + threads - 1) / threads;
  merge_path_ranks_kernel<<<(unsigned int)grid, threads, smem,
                            (cudaStream_t)stream>>>(
      (const int32_t*)keys, (int32_t*)ranks, c, w, chunk_rows);
  return (int)cudaGetLastError();
}
