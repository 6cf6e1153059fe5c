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
// chunk; __shfl_sync brings the two values there to every lane
// (warp_first_mismatch, which the other two kernels here share).  The loop
// over 32-column chunks starts at the chunk holding max(start, 0) and stops
// at the first chunk with a mismatch, so any k works and a row with an early
// mismatch reads no further.  A row of k = 26 int32 is 104 contiguous bytes,
// so each warp's loads are coalesced.  Lane 0 writes the two words.  The TPU
// kernel's iota masks, row min-reduce and one-hot value gather become the
// ballot and the shuffles.
//
// pattern_cmp_level: one window level of the query engine's round loop
// (core/search.py::compare_levels), the compare and its bookkeeping in one
// launch.  The JAX engine runs this level as host code around pattern_cmp
// (repro/serve/sa_engine.py::_compare_batch): the pattern window gathered
// from the pattern rows, the range, the casts, the compare and three
// scattered writes, about 25 eager ops a level on the card.  Inputs: the
// level's fetched windows win (m, k) int32; per engine row i (q rows) pos[i]
// int32, its window's row in win (-1: not in play at this level), t_in[i]
// and t[i] int64 (the matched tokens before and after the level), pi[i]
// int64 (its pattern row); the pattern lengths pat_len (q_pat) and rows pat
// (q_pat, lmax) int64; outputs cmp (q) int32, nxt (q) int64 and levels (q)
// int32 or null.  A row in play takes ti = t_in[i], len = pat_len[pi[i]],
// lv = floor(ti / k), start = ti - lv*k, stop = min(len - lv*k, k), reads
// pattern column c as pat[pi[i], lv*k + c] (0 from len on; a column past
// lmax reads the last, as the plain version's clamped gather) cut to int32 as
// both packages' kernel routes cut it, finds the first mismatch as
// pattern_cmp does, and writes t[i] = ti + matched, cmp[i], nxt[i] = t[i]
// while the row is undecided (cmp == 0 and t[i] < len: the next level's
// start) and -1 once decided, and, with levels, levels[i] += 1.  On the
// first level of a compare t_in is the proven prefix t0 and t another
// tensor: a row out of play there takes t = t_in, cmp = 0, nxt = -1.  Later
// levels pass t as t_in too, and leave a row out of play untouched.  So one
// launch a level is the whole of the level on the card: no set-up launch a
// compare, no gather of the level's rows (the host sends pos, having chosen
// the rows from nxt, which it reads back only when another level may
// follow).  Bound: launch latency, as pattern_cmp: a level reads at most 104
// window bytes, 104 pattern bytes and 48 bookkeeping bytes a row.  Design:
// one warp a row, pattern tokens and the length read in place, lane 0
// writes the row's words.
#include <cuda_runtime.h>
#include <stdint.h>

// The first column c, scanning 32 columns a step from `from` (one a lane),
// with lo <= c < hi and sfx(c) != pat(c); `none` when there is none.  Every
// lane of the warp calls it with the same arguments and gets the same column;
// sv and pv are the two tokens there, 0 with none.
template <typename T, typename Sfx, typename Pat>
__device__ __forceinline__ long long warp_first_mismatch(
    long long from, long long lo, long long hi, long long none, const Sfx& sfx,
    const Pat& pat, T& sv, T& pv) {
  const unsigned FULL = 0xffffffffu;
  const long long lane = threadIdx.x & 31;
  for (long long c0 = from; c0 < hi; c0 += 32) {
    const long long c = c0 + lane;
    const bool in = c >= lo && c < hi;
    const T a = in ? sfx(c) : T(0);
    const T b = in ? pat(c) : T(0);
    const unsigned mis = __ballot_sync(FULL, in && a != b);
    if (mis) {
      const int src = __ffs(mis) - 1;
      sv = __shfl_sync(FULL, a, src);
      pv = __shfl_sync(FULL, b, src);
      return c0 + src;
    }
  }
  sv = pv = T(0);
  return none;
}

// Column c of one row of a (rows, k) int32 window matrix.
struct WindowRow {
  const int32_t* row;
  __device__ int32_t operator()(long long c) const { return row[c]; }
};

// Token p of a pattern of `len` tokens held in a row of last + 1 columns: 0
// from len on, the last column past it (the plain versions clamp their
// gather there; the engine pads every row to at least its length).
__device__ __forceinline__ long long pattern_token(const long long* __restrict__ row,
                                                   long long len, long long last,
                                                   long long p) {
  return p < len ? row[p < last ? p : last] : 0;
}

struct PatternRow {
  const long long* row;
  long long len, last;
  __device__ long long operator()(long long p) const {
    return pattern_token(row, len, last, p);
  }
};

// Column c of the pattern's window at token `base`, cut to int32.
struct PatternWindow {
  const long long* row;
  long long len, last, base;
  __device__ int32_t operator()(long long c) const {
    return (int32_t)pattern_token(row, len, last, base + c);
  }
};

__global__ void pattern_cmp_kernel(const int32_t* __restrict__ sfx,
                                   const int32_t* __restrict__ pat,
                                   const int32_t* __restrict__ start,
                                   const int32_t* __restrict__ stop,
                                   int32_t* __restrict__ out, long long b,
                                   int k) {
  const int lane = threadIdx.x & 31;
  const long long warps_per_cta = blockDim.x >> 5;
  const long long all_warps = (long long)gridDim.x * warps_per_cta;
  for (long long row = (long long)blockIdx.x * warps_per_cta + (threadIdx.x >> 5);
       row < b; row += all_warps) {
    const int s = start[row];
    const int e = stop[row];
    const int lo = max(s, 0);
    int32_t sv, pv;
    const long long first = warp_first_mismatch(
        lo & ~31, lo, min(e, k), e, WindowRow{sfx + row * (long long)k},
        WindowRow{pat + row * (long long)k}, sv, pv);
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

__global__ void pattern_cmp_level_kernel(
    const int32_t* __restrict__ win, int k, const int32_t* __restrict__ pos,
    long long q, const long long* t_in, long long* t,
    const long long* __restrict__ pi, const long long* __restrict__ pat_len,
    const long long* __restrict__ pat, long long lmax, int32_t* __restrict__ cmp,
    long long* __restrict__ nxt, int32_t* __restrict__ levels, int first) {
  const int lane = threadIdx.x & 31;
  const long long warps_per_cta = blockDim.x >> 5;
  const long long all_warps = (long long)gridDim.x * warps_per_cta;
  for (long long i = (long long)blockIdx.x * warps_per_cta + (threadIdx.x >> 5);
       i < q; i += all_warps) {
    const int j = pos[i];
    if (j < 0) {
      if (first && lane == 0) {
        t[i] = t_in[i];
        cmp[i] = 0;
        nxt[i] = -1;
      }
      continue;
    }
    const long long ti = t_in[i], p = pi[i], len = pat_len[p];
    // t_in may be t: every lane has read t_in[i] before lane 0 writes t[i],
    // even for a row whose scan takes no step (no ballot in between)
    __syncwarp();
    const long long lq = ti / k;
    const long long base = (ti % k != 0 && ti < 0 ? lq - 1 : lq) * k;  // floor
    const long long s = ti - base;
    const long long e = min(len - base, (long long)k);
    const long long lo = max(s, 0LL);
    int32_t sv, pv;
    const long long first_mis = warp_first_mismatch(
        lo & ~31LL, lo, e, e, WindowRow{win + (long long)j * k},
        PatternWindow{pat + p * lmax, len, lmax - 1, base}, sv, pv);
    if (lane == 0) {
      const int32_t c = first_mis < e ? (sv < pv ? -1 : (sv > pv ? 1 : 0)) : 0;
      const long long tn = ti + (first_mis - s);
      t[i] = tn;
      cmp[i] = c;
      nxt[i] = c == 0 && tn < len ? tn : -1;
      if (levels != nullptr) levels[i] += 1;
    }
  }
}

extern "C" int pattern_cmp_level_launch(const void* win, int k, const void* pos,
                                        long long q, const void* t_in, void* t,
                                        const void* pi, const void* pat_len,
                                        const void* pat, long long lmax, void* cmp,
                                        void* nxt, void* levels, int warps,
                                        void* stream) {
  if (q <= 0) return (int)cudaSuccess;
  long long grid = (q + warps - 1) / warps;
  if (grid > (1LL << 30)) grid = 1LL << 30;  // the row loop covers the rest
  pattern_cmp_level_kernel<<<(unsigned int)grid, warps * 32, 0,
                             (cudaStream_t)stream>>>(
      (const int32_t*)win, k, (const int32_t*)pos, q, (const long long*)t_in,
      (long long*)t, (const long long*)pi, (const long long*)pat_len,
      (const long long*)pat, lmax, (int32_t*)cmp, (long long*)nxt,
      (int32_t*)levels, t_in != t);
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
// gives the first mismatch, as in pattern_cmp (warp_first_mismatch).  The
// levels of a compare are those the engine's window loop would fetch: (level
// of the first mismatch, or of the pattern's last token) - t0 / k + 1.  No
// host read, no window gather and no launch a round.
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

// Token p of suffix g of the padded corpus.
struct SuffixTokens {
  const int32_t* corpus;
  bool text;
  long long n, row_len, row_stride;
  int sb;
  long long g;
  __device__ long long operator()(long long p) const {
    return corpus_token(corpus, text, n, row_len, row_stride, sb, g, p);
  }
};

__global__ void pattern_search_kernel(
    const int32_t* __restrict__ corpus, int text, long long n, long long row_len,
    long long row_stride, int sb, int k, const long long* __restrict__ sa,
    const long long* __restrict__ llcp, const long long* __restrict__ rlcp,
    const long long* __restrict__ pat, long long lmax,
    const long long* __restrict__ plen_in, const long long* __restrict__ lo_in,
    const long long* __restrict__ hi_in, long long q, int upper, int R,
    long long* __restrict__ bound, int32_t* __restrict__ levels,
    int32_t* __restrict__ active) {
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
          long long sv, pv;
          const long long first = warp_first_mismatch(
              t0, t0, plen, plen,
              SuffixTokens{corpus, text != 0, n, row_len, row_stride, sb, sa[mid]},
              PatternRow{pr, plen, lmax - 1}, sv, pv);
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
