// The query engine's compare: suffix window vs pattern window over [start, stop).
//
// Replaces the Pallas kernel repro/kernels/pattern_cmp.py::pattern_cmp.  For
// each row r < b of the (b, k) int32 windows sfx and pat it writes
//   first   = the lowest column c in [0, k) with start[r] <= c < stop[r] and
//             sfx[r, c] != pat[r, c], or stop[r] when there is none;
//   out[r]  = {cmp, matched}: cmp is -1 / +1 as sfx < / > pat (signed int32)
//             at `first`, 0 when first >= stop[r]; matched = first - start[r]
//             (int32, wrapping as the JAX kernel's arithmetic does).
// Padding rows (start == stop == 0) give {0, 0}.
//
// Bound: memory, and at the engine's batch sizes launch latency.  A row reads
// 2k*4 window bytes and 8 range bytes and writes 8; there is one compare per
// token.  Design: one warp per row.  Lanes take 32 columns at a time, test
// their column, and __ballot_sync + __ffs give the first mismatch of the
// chunk; __shfl_sync brings the two values there to every lane.  The loop over
// 32-column chunks starts at the chunk holding max(start, 0) and stops at the
// first chunk with a mismatch, so any k works and a row with an early
// mismatch reads no further.  A row of k = 26 int32 is 104 contiguous bytes,
// so each warp's loads are coalesced.  Lane 0 writes the two words.  The TPU
// kernel's iota masks, row min-reduce and one-hot value gather become the
// ballot and the shuffles.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void pattern_cmp_kernel(const int32_t* __restrict__ sfx,
                                   const int32_t* __restrict__ pat,
                                   const int32_t* __restrict__ start,
                                   const int32_t* __restrict__ stop,
                                   int32_t* __restrict__ out, long long b,
                                   int k) {
  const unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long warps_per_cta = blockDim.x >> 5;
  const long long all_warps = (long long)gridDim.x * warps_per_cta;
  for (long long row = (long long)blockIdx.x * warps_per_cta + (threadIdx.x >> 5);
       row < b; row += all_warps) {
    const int s = start[row];
    const int e = stop[row];
    const int lo = max(s, 0);
    const int hi = min(e, k);
    const int32_t* sr = sfx + row * (long long)k;
    const int32_t* pr = pat + row * (long long)k;
    int first = e;
    int32_t sv = 0, pv = 0;
    for (int c0 = lo & ~31; c0 < hi; c0 += 32) {
      const int c = c0 + lane;
      const bool in = c >= lo && c < hi;
      const int32_t a = in ? sr[c] : 0;
      const int32_t p = in ? pr[c] : 0;
      const unsigned mis = __ballot_sync(FULL, in && a != p);
      if (mis) {
        const int src = __ffs(mis) - 1;
        first = c0 + src;
        sv = __shfl_sync(FULL, a, src);
        pv = __shfl_sync(FULL, p, src);
        break;
      }
    }
    if (lane == 0) {
      const int32_t cmp = first < e ? (sv < pv ? -1 : (sv > pv ? 1 : 0)) : 0;
      out[2 * row] = cmp;
      out[2 * row + 1] = (int32_t)((uint32_t)first - (uint32_t)s);
    }
  }
}

extern "C" int pattern_cmp_launch(const void* sfx, const void* pat,
                                  const void* start, const void* stop,
                                  void* out, long long b, int k, int warps,
                                  void* stream) {
  if (b <= 0) return (int)cudaSuccess;
  long long grid = (b + warps - 1) / warps;
  if (grid > (1LL << 30)) grid = 1LL << 30;  // the row loop covers the rest
  pattern_cmp_kernel<<<(unsigned int)grid, warps * 32, 0,
                       (cudaStream_t)stream>>>(
      (const int32_t*)sfx, (const int32_t*)pat, (const int32_t*)start,
      (const int32_t*)stop, (int32_t*)out, b, k);
  return (int)cudaGetLastError();
}
