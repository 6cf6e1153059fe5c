// The query engine's compare, and its whole search.
//
// pattern_cmp: suffix window vs pattern window over [start, stop).
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

// pattern_search: one Manber-Myers bound (lower, or upper) of every pattern
// row of a batch in one launch, the rounds of the engine's _bound_batch and
// the window levels of its _compare_batch included.  No Pallas kernel does
// this: the JAX engine runs its rounds on the host around pattern_cmp.
//
// Inputs: the corpus zero-padded by k tokens, (n + k) for a text or
// (rows, row_len + k) for reads (row stride row_len + k); a token at position
// p of suffix g is corpus[g + p] while g + p < n (text), or
// corpus[row(g), off(g) + p] while off(g) + p < row_len (reads, row = g >>
// sb, off = g & (2^sb - 1)), and 0 past that: what the in-memory backend's
// window level p / k holds.  sa (int64), llcp/rlcp (int64, or null: no
// LCP), the pattern rows (q, lmax) and lengths (q) int64, the open ranges
// lo/hi (q) int64 from the engine's routing.  Outputs: bound (q) int64 (the
// final hi), levels (q, R) int32 (the window levels row i compared in round
// r, 0 where LLCP/RLCP decided the round, the row needed no compare, or had
// left the loop), active (q) int32 (the rounds row i took).
//
// Bound: latency.  A round is two dependent loads (sa[mid], then the corpus
// at it; with LCP the llcp/rlcp load comes first and may decide the round
// alone), and a bound about log2(shard) rounds, so a row is some 30-90
// dependent global loads whatever the width of the card; bytes are a few
// sectors a round.  Design: one warp a row walks the whole search with lo,
// hi, l, r in registers, and many warps hide each other's latency (4096
// rows fill the card's 132 SMs at 8 warps a CTA in one wave).  Every lane
// loads the same sa/llcp/rlcp entry (one broadcast transaction), so the
// round's decision is warp-uniform with no shuffle.  The compare reads 32
// consecutive tokens of the suffix and of the pattern a step, straight from
// the corpus from the proven-equal prefix t0 on, and a __ballot_sync + __ffs
// gives the first mismatch, as in pattern_cmp; the two tokens there come by
// __shfl_sync.  The levels of a compare are those the engine's window loop
// would fetch: (level of the first mismatch, or of the pattern's last token)
// - t0 / k + 1.  No host read, no window gather and no launch a round.
__device__ __forceinline__ long long corpus_token(
    const int32_t* __restrict__ corpus, bool text, long long n, long long row_len,
    long long row_stride, int sb, long long g, long long p) {
  if (text) {
    const long long i = g + p;
    return i < n ? (long long)corpus[i] : 0;
  }
  const long long off = (g & ((1LL << sb) - 1)) + p;
  return off < row_len ? (long long)corpus[(g >> sb) * row_stride + off] : 0;
}

__global__ void pattern_search_kernel(
    const int32_t* __restrict__ corpus, int text, long long n, long long row_len,
    long long row_stride, int sb, int k, const long long* __restrict__ sa,
    const long long* __restrict__ llcp, const long long* __restrict__ rlcp,
    const long long* __restrict__ pat, long long lmax,
    const long long* __restrict__ plen_in, const long long* __restrict__ lo_in,
    const long long* __restrict__ hi_in, long long q, int upper, int R,
    long long* __restrict__ bound, int32_t* __restrict__ levels,
    int32_t* __restrict__ active) {
  const unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long warps_per_cta = blockDim.x >> 5;
  const long long all_warps = (long long)gridDim.x * warps_per_cta;
  const bool has_lcp = llcp != nullptr;
  for (long long row = (long long)blockIdx.x * warps_per_cta + (threadIdx.x >> 5);
       row < q; row += all_warps) {
    const long long* pr = pat + row * lmax;
    const long long plen = plen_in[row];
    long long lo = lo_in[row], hi = hi_in[row], l = 0, r = 0;
    int rnd = 0;
    while (hi - lo > 1) {
      const long long mid = (lo + hi) >> 1;
      bool right = false, need = true;
      long long newl = l, newr = r, t0;
      if (has_lcp && l != r) {
        // x beyond the deeper endpoint's agreement: mid sides with that
        // endpoint; x short of it: mid sides against it, its lcp exactly x
        const bool c1 = l > r;
        const long long x = c1 ? llcp[mid] : rlcp[mid];
        const long long mx = c1 ? l : r;
        const bool gt = x > mx, ltm = x < mx;
        right = c1 ? gt : ltm;
        if (ltm) {
          if (c1) newr = x; else newl = x;
        }
        need = !(gt || ltm);
        t0 = mx;
      } else {
        t0 = min(l, r);
      }
      int lv = 0;
      if (need) {
        int c = 0;
        long long t = t0;
        if (t0 < plen) {
          const long long g = sa[mid];
          long long first = plen, sv = 0, pv = 0;
          for (long long p0 = t0; p0 < plen; p0 += 32) {
            const long long p = p0 + lane;
            const bool in = p < plen;
            const long long a = in ? corpus_token(corpus, text, n, row_len,
                                                  row_stride, sb, g, p) : 0;
            const long long b = in ? pr[p] : 0;
            const unsigned mis = __ballot_sync(FULL, in && a != b);
            if (mis) {
              const int src = __ffs(mis) - 1;
              first = p0 + src;
              sv = __shfl_sync(FULL, a, src);
              pv = __shfl_sync(FULL, b, src);
              break;
            }
          }
          c = first < plen ? (sv < pv ? -1 : 1) : 0;
          t = first;
          lv = (int)((first < plen ? first : plen - 1) / k - t0 / k + 1);
        }
        right = upper ? c <= 0 : c < 0;
        if (right) newl = t; else newr = t;
      }
      if (lane == 0 && rnd < R) levels[row * R + rnd] = lv;
      if (right) {
        lo = mid;
        l = newl;
      } else {
        hi = mid;
        r = newr;
      }
      ++rnd;
    }
    for (int c = rnd + lane; c < R; c += 32) levels[row * R + c] = 0;
    if (lane == 0) {
      bound[row] = hi;
      active[row] = rnd;
    }
  }
}

extern "C" int pattern_search_launch(
    const void* corpus, int text, long long n, long long row_len,
    long long row_stride, int sb, int k, const void* sa, const void* llcp,
    const void* rlcp, const void* pat, long long lmax, const void* plen,
    const void* lo, const void* hi, long long q, int upper, int R, void* bound,
    void* levels, void* active, int warps, void* stream) {
  if (q <= 0) return (int)cudaSuccess;
  long long grid = (q + warps - 1) / warps;
  if (grid > (1LL << 30)) grid = 1LL << 30;  // the row loop covers the rest
  pattern_search_kernel<<<(unsigned int)grid, warps * 32, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)corpus, text, n, row_len, row_stride, sb, k,
      (const long long*)sa, (const long long*)llcp, (const long long*)rlcp,
      (const long long*)pat, lmax, (const long long*)plen,
      (const long long*)lo, (const long long*)hi, q, upper, R,
      (long long*)bound, (int32_t*)levels, (int32_t*)active);
  return (int)cudaGetLastError();
}
