// TeraSort range partition: bucket of every key and the bucket histogram.
//
// Replaces the Pallas kernel repro/kernels/bucket_hist.py::bucket_hist.
// For n two-word int32 keys (hi, lo) and s = D-1 splitters it writes
//   bucket[i] = #{ j < s : splitter j < key i }
// under lexicographic compare of signed (hi, lo), strictly less, so equal
// keys always share a bucket, and adds every key to hist[bucket[i]] (hist
// has D entries and must be zeroed by the caller).  The splitters need not
// be sorted or distinct: the count below a key does not depend on their
// order, so the kernel sorts them itself.  The tail is bounds-checked, not
// padded: the TPU kernel pads with int32-max keys and subtracts them from
// bucket D-1, which is wrong once a splitter equals (int32 max, int32 max);
// here no padding key is ever counted.
//
// Bound: bytes (8 bytes read and 4 written a key against ceil(log2(s+1))
// compares a key).  Design: each (hi, lo) pair is folded into one
// order-preserving int64 (hi in the high word, lo with its sign bit flipped
// in the low word).  Every CTA folds the splitters into shared memory, pads
// them to p = the power of two above s with int64 max (never below a key),
// and sorts them with a bitonic network.  The first p-1 sorted splitters
// are then laid out as a perfect binary search tree in breadth-first
// (Eytzinger) order, so a tree level's nodes sit side by side: the top
// levels, which every lane of a warp reads, fall in distinct banks, where a
// sorted array's would all fall in one.  A key takes log2(p) branchless
// steps down the tree.  The histogram is per CTA in shared memory (in the
// sorted array's place), a shared atomic a key, and one global atomic per
// non-empty bucket per CTA.  One resident wave of CTAs strides over the
// keys.
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_SPLITTERS 4095  // 2 * p * 8 bytes: 64 KB at most
#define NUM_SMS 132
#define THREADS_PER_SM 2048

__device__ __forceinline__ long long bucket_hist_fold(int32_t hi, int32_t lo) {
  return (long long)(((unsigned long long)(uint32_t)hi << 32) |
                     (uint32_t)(lo ^ (int32_t)0x80000000));
}

// #{ splitters < key }: the descent of the tree (root at 1, children of
// node i at 2i and 2i+1) ends at leaf p + that count
__device__ __forceinline__ int bucket_hist_search(const long long* tree, int p,
                                                  long long key) {
  int i = 1;
  while (i < p) i = 2 * i + (tree[i] < key);
  return i - p;
}

__global__ void bucket_hist_kernel(const int32_t* __restrict__ key_hi,
                                   const int32_t* __restrict__ key_lo,
                                   const int32_t* __restrict__ split_hi,
                                   const int32_t* __restrict__ split_lo,
                                   int32_t* __restrict__ bucket,
                                   int32_t* __restrict__ hist, long long n,
                                   int s, int p) {
  extern __shared__ long long smem[];
  long long* split = smem;                       // p splitters, then padding
  long long* tree = smem + p;                    // nodes 1 .. p-1
  int32_t* local = (int32_t*)smem;               // s + 1 counts, once split is spent
  for (int j = threadIdx.x; j < p; j += blockDim.x)
    split[j] = j < s ? bucket_hist_fold(split_hi[j], split_lo[j])
                     : 0x7fffffffffffffffLL;
  __syncthreads();
  for (int k = 2; k <= p; k <<= 1) {  // bitonic network, ascending
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < (p >> 1); i += blockDim.x) {
        const int a = 2 * i - (i & (j - 1));  // lower index of pair i
        const long long x = split[a], y = split[a + j];
        if ((x > y) == ((a & k) == 0)) {
          split[a] = y;
          split[a + j] = x;
        }
      }
      __syncthreads();
    }
  }
  const int levels = 31 - __clz(p);
  for (int i = 1 + threadIdx.x; i < p; i += blockDim.x) {  // node i: in-order rank r
    const int d = 31 - __clz(i);
    tree[i] = split[((2 * (i - (1 << d)) + 1) << (levels - d - 1)) - 1];
  }
  __syncthreads();
  for (int j = threadIdx.x; j <= s; j += blockDim.x) local[j] = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int b = bucket_hist_search(tree, p, bucket_hist_fold(__ldg(key_hi + i),
                                                                __ldg(key_lo + i)));
    bucket[i] = b;
    atomicAdd(&local[b], 1);
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
  int p = 1;
  while (p < s + 1) p <<= 1;  // room for one padding entry at least
  const size_t smem = 2 * (size_t)p * sizeof(long long);
  if (smem > 48 * 1024) {  // above the default dynamic limit: opt in
    const cudaError_t err = cudaFuncSetAttribute(
        bucket_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  long long grid = (n + threads - 1) / threads;
  const long long wave = (long long)NUM_SMS * (THREADS_PER_SM / threads);
  if (grid > wave) grid = wave;
  bucket_hist_kernel<<<(unsigned int)grid, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)key_hi, (const int32_t*)key_lo, (const int32_t*)split_hi,
      (const int32_t*)split_lo, (int32_t*)bucket, (int32_t*)hist, n, s, p);
  return (int)cudaGetLastError();
}
