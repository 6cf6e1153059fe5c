// TeraSort range partition: bucket of every key and the bucket histogram.
//
// Replaces the Pallas kernel repro/kernels/bucket_hist.py::bucket_hist.
// For n two-word int32 keys (hi, lo) and s = D-1 splitters it writes
//   bucket[i] = #{ j < s : splitter j < key i }
// under lexicographic compare of signed (hi, lo), strictly less, so equal
// keys always share a bucket, and adds every key to hist[bucket[i]] (hist
// has D entries and must be zeroed by the caller).  The splitters need not
// be sorted: the count is linear, as in the TPU kernel.  The tail is
// bounds-checked, not padded: the TPU kernel pads with int32-max keys and
// subtracts them from bucket D-1, which is wrong once a splitter equals
// (int32 max, int32 max); here no padding key is ever counted.
//
// Bound: bytes (8 bytes read and 4 written a key; a binary search would
// need only log2(D) compares a key).  Design: each (hi, lo) pair is folded
// into one order-preserving int64 (hi in the high word, lo with its sign bit
// flipped in the low word), so a splitter costs one shared-memory broadcast
// load and one 64-bit compare.  The splitters and a per-CTA histogram sit
// in shared memory; one thread a key over a grid-stride loop of a bounded
// grid, shared atomics per key and one global atomic per non-empty bucket
// per CTA.
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_SPLITTERS 4095  // s * 8 + (s + 1) * 4 bytes stay within 48 KB
#define CTAS_PER_SM 8
#define NUM_SMS 132

__device__ __forceinline__ long long fold(int32_t hi, int32_t lo) {
  return (long long)(((unsigned long long)(uint32_t)hi << 32) |
                     (uint32_t)(lo ^ (int32_t)0x80000000));
}

__global__ void bucket_hist_kernel(const int32_t* __restrict__ key_hi,
                                   const int32_t* __restrict__ key_lo,
                                   const int32_t* __restrict__ split_hi,
                                   const int32_t* __restrict__ split_lo,
                                   int32_t* __restrict__ bucket,
                                   int32_t* __restrict__ hist, long long n,
                                   int s) {
  extern __shared__ long long smem[];
  long long* split = smem;                       // s folded splitters
  int32_t* local = (int32_t*)(smem + s);         // s + 1 bucket counts
  for (int j = threadIdx.x; j < s; j += blockDim.x)
    split[j] = fold(split_hi[j], split_lo[j]);
  for (int j = threadIdx.x; j <= s; j += blockDim.x) local[j] = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long key = fold(key_hi[i], key_lo[i]);
    int count = 0;
#pragma unroll 8
    for (int j = 0; j < s; ++j) count += key > split[j];
    bucket[i] = count;
    atomicAdd(&local[count], 1);
  }
  __syncthreads();
  for (int j = threadIdx.x; j <= s; j += blockDim.x)
    if (local[j]) atomicAdd(&hist[j], local[j]);
}

extern "C" int bucket_hist_launch(const void* key_hi, const void* key_lo,
                                  const void* split_hi, const void* split_lo,
                                  void* bucket, void* hist, long long n, int s,
                                  int threads, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (s < 0 || s > MAX_SPLITTERS || threads < 1 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)s * sizeof(long long) + (size_t)(s + 1) * sizeof(int32_t);
  long long grid = (n + threads - 1) / threads;
  if (grid > (long long)NUM_SMS * CTAS_PER_SM) grid = (long long)NUM_SMS * CTAS_PER_SM;
  bucket_hist_kernel<<<(unsigned int)grid, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)key_hi, (const int32_t*)key_lo, (const int32_t*)split_hi,
      (const int32_t*)split_lo, (int32_t*)bucket, (int32_t*)hist, n, s);
  return (int)cudaGetLastError();
}
