// Merge-path ranks of one out-of-core merge tile: a run-aware search.
//
// Replaces the Pallas kernel repro/kernels/merge_path.py::merge_path_ranks.
// For the (c, w) int32 row matrix `keys` it writes, for every row e < c,
//   ranks[e] = #{ r < c : row r < row e }
// under lexicographic compare of signed int32 words, strictly less, so equal
// rows do not count one another.  The merge's rows end in the two words of
// the global suffix index and are unique, and then the ranks are the merged
// order's permutation.  No padding rows: every read is bounds-checked.
//
// Bound: bytes (c*w*4 read, c*4 written).  The TPU kernel compares every
// pair (c^2 compares), since its vector unit has no cheap dynamic addressing.
// A merge tile is the concatenated frontiers of a few sorted runs, so here:
//
// 1. Runs.  Row i starts a run when i = 0 or row i < row i-1; every run is
//    then non-decreasing, whatever the input.  merge_path_run_flags marks the
//    starts (and zeroes `ranks`); merge_path_run_starts scans the marks into
//    run_start[0..R] and R on the device.  No host read: the rank kernel
//    reads R itself.
// 2. Ranks.  rank(e) = sum over runs r of lower_bound(run r, row e), equal to
//    the all-pairs count for every input.  For R <= WARP_RUNS the searches of
//    one row sit in one warp, a lane a run, summed with __shfl_xor_sync; so
//    c*R lanes search, not c threads.  Each CTA stages every run's leading
//    word at evenly spaced rows in shared memory (SAMPLE_WORDS in all): the
//    top levels of a search are shared-memory compares, the last few steps
//    and the tie walks (words from 1 on, four loads in flight) read the tile
//    from L2.
// 3. Many runs.  For R > WARP_RUNS a thread searches WARP_RUNS runs of one
//    row and adds its sum atomically into `ranks`; c*ceil(R/WARP_RUNS)
//    threads' worth of work.  Unsorted tiles (R near c/2) take this branch.
//
// Three launches a call; the branch is taken on the device from R.  w is a
// run-time argument (w >= 1); `threads` is rounded up to whole warps.
#include <cuda_runtime.h>
#include <stdint.h>

#define SCAN_THREADS 256   // CTA size of the two run-finding kernels
#define WARP_RUNS 32       // runs a warp's lanes search together
#define SAMPLE_WORDS 2048  // staged leading words of all runs (8 KB)

// sign of (row a - row b) from word j0 on; four words' loads in flight
__device__ __forceinline__ int merge_path_cmp(const int32_t* __restrict__ a,
                                              const int32_t* __restrict__ b,
                                              int w, int j0) {
  for (int j = j0; j < w; j += 4) {
    int32_t x[4], y[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool in = j + k < w;
      x[k] = in ? __ldg(a + j + k) : 0;
      y[k] = in ? __ldg(b + j + k) : 0;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (x[k] != y[k]) return x[k] < y[k] ? -1 : 1;
  }
  return 0;
}

// row m < row e, given word 0 of both
__device__ __forceinline__ bool merge_path_less(const int32_t* m, int32_t m0,
                                                const int32_t* e, int32_t e0,
                                                int w) {
  return m0 != e0 ? m0 < e0 : merge_path_cmp(m, e, w, 1) < 0;
}

// first row of [lo, hi) that is not below row e (hi if none), the rows of
// [lo, hi) non-decreasing
__device__ __forceinline__ long long merge_path_search(
    const int32_t* __restrict__ keys, const int32_t* e, int32_t e0,
    long long lo, long long hi, int w) {
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    const int32_t* m = keys + mid * w;
    if (merge_path_less(m, __ldg(m), e, e0, w)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// exclusive prefix sum of v over the CTA (blockDim.x a multiple of 32);
// *total gets the CTA's sum
__device__ __forceinline__ int merge_path_block_scan(int v, int* warp_sums,
                                                     int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nw ? warp_sums[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    if (lane < nw) warp_sums[lane] = s;
  }
  __syncthreads();
  const int before = warp ? warp_sums[warp - 1] : 0;
  *total = warp_sums[nw - 1];
  __syncthreads();  // warp_sums free for the next scan
  return before + x - v;
}

__global__ void merge_path_run_flags(const int32_t* __restrict__ keys,
                                     int32_t* __restrict__ ranks,
                                     int32_t* __restrict__ flags,
                                     int32_t* __restrict__ block_runs,
                                     long long c, int w) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int f = 0;
  if (i < c) {
    ranks[i] = 0;  // the atomic branches add into it
    f = i == 0 || merge_path_cmp(keys + i * w, keys + (i - 1) * w, w, 0) < 0;
    flags[i] = f;
  }
  const int runs = __syncthreads_count(f);
  if (threadIdx.x == 0) block_runs[blockIdx.x] = runs;
}

__global__ void merge_path_run_starts(const int32_t* __restrict__ flags,
                                      const int32_t* __restrict__ block_runs,
                                      int32_t* __restrict__ run_start,
                                      int32_t* __restrict__ nruns, long long c) {
  __shared__ int warp_sums[32];
  int mine = 0;  // runs started in earlier CTAs' rows
  for (long long b = threadIdx.x; b < blockIdx.x; b += blockDim.x) mine += block_runs[b];
  int offset;
  merge_path_block_scan(mine, warp_sums, &offset);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int f = i < c ? flags[i] : 0;
  int total;
  const int pos = offset + merge_path_block_scan(f, warp_sums, &total);
  if (f) run_start[pos] = (int)i;
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
    run_start[offset + total] = (int)c;
    *nruns = offset + total;
  }
}

// R <= WARP_RUNS: lane r of a row's lane group searches run r.  Tasks are
// warps' worth of rows, taken CTA by CTA so that idle CTAs leave at once.
__device__ void merge_path_warp_runs(const int32_t* __restrict__ keys,
                                     const int32_t* __restrict__ run_start,
                                     int nrun, int32_t* __restrict__ ranks,
                                     long long c, int w, int32_t* sample) {
  int lanes = 1;  // lanes a row: the runs rounded up to a power of two
  while (lanes < nrun) lanes <<= 1;
  const int rows_per_warp = 32 / lanes;
  const int warps = blockDim.x >> 5;
  const long long tasks = (c + rows_per_warp - 1) / rows_per_warp;
  if ((long long)blockIdx.x * warps >= tasks) return;
  // stage run r's word 0 at rows s0 + k*len/n, k < n = min(len, cap)
  const int cap = SAMPLE_WORDS / lanes;
  for (int idx = threadIdx.x; idx < nrun * cap; idx += blockDim.x) {
    const int r = idx / cap, k = idx - r * cap;
    const int s0 = run_start[r], len = run_start[r + 1] - s0;
    const int n = len < cap ? len : cap;
    if (k < n) sample[idx] = __ldg(keys + (s0 + (long long)k * len / n) * w);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int r = lane & (lanes - 1);
  const bool searching = r < nrun;
  const int s0 = searching ? run_start[r] : 0;
  const int len = searching ? run_start[r + 1] - s0 : 0;
  const int n = len < cap ? len : cap;
  const int32_t* samp = sample + r * cap;
  for (long long t = (long long)blockIdx.x * warps + (threadIdx.x >> 5); t < tasks;
       t += (long long)gridDim.x * warps) {
    const long long e = t * rows_per_warp + lane / lanes;
    int count = 0;
    if (searching && e < c) {
      const int32_t* row = keys + e * w;
      const int32_t e0 = __ldg(row);
      // samples below row e, in shared memory but for ties on word 0
      int lo = 0, hi = n;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        const int32_t m0 = samp[mid];
        const bool less = m0 != e0
            ? m0 < e0
            : merge_path_cmp(keys + (s0 + (long long)mid * len / n) * w, row, w, 1) < 0;
        if (less) lo = mid + 1;
        else hi = mid;
      }
      // the bound lies after sample lo-1 and at or before sample lo
      const long long a = lo == 0 ? s0 : s0 + (long long)(lo - 1) * len / n + 1;
      const long long b = lo == n ? s0 + len : s0 + (long long)lo * len / n;
      count = (int)(merge_path_search(keys, row, e0, a, b, w) - s0);
    }
    for (int d = lanes >> 1; d >= 1; d >>= 1)
      count += __shfl_xor_sync(0xffffffffu, count, d);
    if (searching && r == 0 && e < c) ranks[e] = count;
  }
}

// R > WARP_RUNS: a thread searches WARP_RUNS runs of one row;
// neighbouring lanes take neighbouring rows of the same runs
__device__ void merge_path_run_chunks(const int32_t* __restrict__ keys,
                                      const int32_t* __restrict__ run_start,
                                      int nrun, int32_t* __restrict__ ranks,
                                      long long c, int w) {
  const long long chunks = (nrun + WARP_RUNS - 1) / WARP_RUNS;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < c * chunks;
       t += stride) {
    const long long e = t % c;
    const int r0 = (int)(t / c) * WARP_RUNS;
    const int r1 = r0 + WARP_RUNS < nrun ? r0 + WARP_RUNS : nrun;
    const int32_t* row = keys + e * w;
    const int32_t e0 = __ldg(row);
    int count = 0;
    for (int r = r0; r < r1; ++r) {
      const long long s0 = run_start[r];
      count += (int)(merge_path_search(keys, row, e0, s0, run_start[r + 1], w) - s0);
    }
    if (count) atomicAdd(ranks + e, count);
  }
}

__global__ void merge_path_ranks_kernel(const int32_t* __restrict__ keys,
                                        const int32_t* __restrict__ run_start,
                                        const int32_t* __restrict__ nruns,
                                        int32_t* __restrict__ ranks, long long c,
                                        int w) {
  __shared__ int32_t sample[SAMPLE_WORDS];
  const int nrun = *nruns;
  if (nrun <= WARP_RUNS)
    merge_path_warp_runs(keys, run_start, nrun, ranks, c, w, sample);
  else
    merge_path_run_chunks(keys, run_start, nrun, ranks, c, w);
}

// scratch: 3*c + 2 int32 (flags, per-CTA run counts, run starts, R)
extern "C" int merge_path_ranks_launch(const void* keys, void* ranks, void* scratch,
                                       long long c, int w, int threads,
                                       void* stream) {
  if (c <= 0) return (int)cudaSuccess;
  if (w < 1 || threads < 1 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long scan_grid = (c + SCAN_THREADS - 1) / SCAN_THREADS;
  int32_t* flags = (int32_t*)scratch;
  int32_t* block_runs = flags + c;
  int32_t* run_start = block_runs + scan_grid;
  int32_t* nruns = run_start + c + 1;
  merge_path_run_flags<<<(unsigned int)scan_grid, SCAN_THREADS, 0, s>>>(
      (const int32_t*)keys, (int32_t*)ranks, flags, block_runs, c, w);
  merge_path_run_starts<<<(unsigned int)scan_grid, SCAN_THREADS, 0, s>>>(
      flags, block_runs, run_start, nruns, c);

  threads = (threads + 31) & ~31;
  // one row a warp; the many-runs branch strides over its c*R/32 searches
  const long long grid = (c + threads / 32 - 1) / (threads / 32);
  merge_path_ranks_kernel<<<(unsigned int)grid, threads, 0, s>>>(
      (const int32_t*)keys, run_start, nruns, (int32_t*)ranks, c, w);
  return (int)cudaGetLastError();
}
