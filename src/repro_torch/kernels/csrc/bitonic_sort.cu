// Per-tile sort of (key_hi, key_lo, val) rows by (key_hi, key_lo).
//
// Replaces the Pallas kernel repro/kernels/bitonic_sort.py::bitonic_sort_tiles.
// Every power-of-two tile of consecutive rows is sorted on its own, ascending
// by signed (key_hi, key_lo); val rides along; rows with equal keys come out
// in no fixed order (the network is not stable).  The last tile may be short.
// The TPU kernel pads it with (int32 max, int32 max) keys and cuts the first n
// rows back out, which can drop a real row with that key; here nothing past n
// is read or written and every real row is kept.
//
// Bound: bytes (12 bytes read and 12 written a row), with the network close
// behind: log2(T)(log2(T)+1)/2 compare-exchanges a pair of rows, each one
// 64-bit compare and six selects, and Hopper issues those at 64 lanes a clock
// an SM.  At tile 1024 that floor is about twice the byte bound (PERF.md).
//
// Keys are sorted as order-preserving int64s: hi in the high word, lo with
// its sign bit flipped in the low word.  The network is the all-ascending form
// of bitonic sort: merge k first pairs row i with i ^ (k - 1) (a "flip"),
// then i with i + j for j = k/4 ... 1 (half cleaners), and the smaller key
// always goes to the lower row.  In that form a row past the real rows acts as
// +inf and never moves, since a real row at a lower index is never strictly
// greater.  So the short last tile is filled, in registers only, with int64
// max keys, and rows swap only on a strictly greater key: even a real
// (int32 max, int32 max) row stays ahead of the fill.  Only the CTA that holds
// row n guards its loads and stores (the SHORT template flag).
//
// Design: a CTA holds 2^LOG_C rows in registers, R = 2^LOG_R a thread, and
// every stage runs inside a thread.  The stages of a merge are taken in
// chunks of LOG_R index bits; before each chunk the CTA moves its rows through
// shared memory into a layout whose registers hold those bits (Net below), so
// a compare-exchange never crosses a thread: no shuffle, one barrier pair a
// chunk.  A merge's flip is its first chunk, in a layout whose upper registers
// hold the mirror images of the lower ones.  The stages are unrolled per
// log2(tile), so every partner, direction and shared-memory offset is a
// compile-time constant and no index needs a division.
//   - Tiles up to 1024: 1024 rows a CTA (several tiles when the tile is
//     smaller), R = 8, 128 threads.  On an H100 R = 8 was faster than 16 or
//     32 (PERF.md).
//   - Larger tiles: T_c = 4096 rows a CTA, R = 16, 256 threads.  Each T_c
//     block is sorted first.  Then, for each merge k = 2 T_c ... tile, global
//     passes run the flip and the half cleaners at j >= T_c (one pass unless
//     log2(k / T_c) > kFlipMaxG), and an in-CTA pass the half cleaners below
//     T_c.  A global pass's CTA holds runs of 2^V contiguous rows (V >= kMinSeg,
//     a thread's rows) at every combination of the pass's bits; a flip's CTA
//     also holds the mirror image of that set (the bits between V and the
//     pass's lowest bit complemented), which the flip pairs it with.  The
//     passes work in place on the outputs.  The wrapper
//     (bitonic_sort.py::plan) lists the launches; it reads T_c and the run
//     length from bitonic_sort_config.
// Loads and stores are 16-byte vectors when every column is 16-byte aligned
// (vec); views, and the CTA that holds row n, take 4-byte accesses.  A full
// CTA of contiguous rows loads and stores them striped across its threads,
// so a warp's accesses are contiguous, and moves them to and from the
// natural layout through shared memory; a CTA that sorts one whole tile may
// take its rows in any order and skips that move on the way in.  On an H100
// both the striped loads and the striped stores timed faster than each
// thread's own run of R rows, at every tile timed (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr long long kFill = 0x7fffffffffffffffLL;  // the key past n
constexpr int kSmallLogC = 10;  // rows a CTA for tiles up to 1024
constexpr int kSmallLogR = 3;
constexpr int kBigLogC = 12;  // T_c
constexpr int kBigLogR = 4;
constexpr int kMinSeg = kBigLogR;  // log2 of a global pass's contiguous run
constexpr int kFlipMaxG = kBigLogC - 1 - kMinSeg;  // bits a flip pass takes
constexpr int kHalfMaxG = kBigLogC - kMinSeg;  // bits a half-cleaner pass takes

__device__ __forceinline__ long long fold(int32_t hi, int32_t lo) {
  return (long long)(((unsigned long long)(uint32_t)hi << 32) |
                     (uint32_t)(lo ^ (int32_t)0x80000000));
}
__device__ __forceinline__ int32_t fold_hi(long long k) { return (int32_t)(k >> 32); }
__device__ __forceinline__ int32_t fold_lo(long long k) {
  return (int32_t)((uint32_t)k ^ 0x80000000u);
}

template <int R>
struct Rows {  // a thread's rows: folded keys and values
  long long k[R];
  int32_t v[R];
};

// rows a < b of the thread: the smaller key to a.  In PTX, one 64-bit
// compare feeds all six selects; written in C++ (the form a pass without
// PTX compiles), the compiler turns the two key selects into a min and a
// max with a compare each: 4 ISETP, not 2.
template <int R>
__device__ __forceinline__ void exchange(Rows<R>& x, int a, int b) {
  const long long ka = x.k[a], kb = x.k[b];
  const int32_t va = x.v[a], vb = x.v[b];
#ifdef __CUDA_ARCH__
  asm("{\n\t.reg .pred p;\n\t"
      "setp.gt.s64 p, %4, %5;\n\t"
      "selp.b64 %0, %5, %4, p;\n\t"
      "selp.b64 %1, %4, %5, p;\n\t"
      "selp.b32 %2, %7, %6, p;\n\t"
      "selp.b32 %3, %6, %7, p;\n\t}"
      : "=l"(x.k[a]), "=l"(x.k[b]), "=r"(x.v[a]), "=r"(x.v[b])
      : "l"(ka), "l"(kb), "r"(va), "r"(vb));
#else
  const bool s = ka > kb;
  x.k[a] = s ? kb : ka;
  x.k[b] = s ? ka : kb;
  x.v[a] = s ? vb : va;
  x.v[b] = s ? va : vb;
#endif
}

// A CTA of 2^LOG_C rows, R = 2^LOG_R a thread.  In layout (LO, MIRROR) the
// registers of a thread hold the rows whose index bits [LO, LO + LOG_R) are
// the register number and whose other bits are the thread's: lane bit c
// (c < 5) takes the lowest index bit of {c, c + 5, c + 10} outside the
// registers, the warp bits the rest in order.  With MIRROR (the first chunk
// of merge 2^(LO + LOG_R)) the registers whose top bit is set hold instead
// the mirror images, row ^ (2^(LO + LOG_R) - 1), of the lower half: the flip
// pairs each row with its own mirror, and the half cleaners that follow pair
// the upper half in reverse.  LO = 0 without MIRROR is the natural layout:
// R consecutive rows a thread.  A layout changes through shared memory, one
// 32-bit word a row and column at phys(row) = row + row / 32: index bits 0-4
// and 5-9 move a word by 1, 2, 4, 8 and 16 banks, the lane bits above take
// one bit of each weight, so no access has a bank conflict; and phys of a
// register's row is the thread's phys plus a compile-time offset.
template <int LOG_R, int LOG_C>
struct Net {
  // each lane bit needs a free index bit among {c, c + 5, c + 10}
  static_assert(LOG_C >= 10 && LOG_C <= 15 && LOG_R >= 1 && LOG_R <= 5, "layout");
  static constexpr int R = 1 << LOG_R;
  static constexpr int NT = 1 << (LOG_C - LOG_R);
  static constexpr int kWords = (1 << LOG_C) + (1 << (LOG_C - 5));  // phys(last) + 1
  static constexpr int kSmem = 3 * kWords * (int)sizeof(int32_t);

  static __host__ __device__ constexpr int phys(int x) {
    return x + (x >> 5);
  }
  static __host__ __device__ constexpr bool in_regs(int lo, int j) {
    return j >= lo && j < lo + LOG_R;
  }
  struct Positions {
    int bit[LOG_C];
  };
  // the index bit that each thread bit takes in layout lo
  static __host__ __device__ constexpr Positions positions(int lo) {
    Positions out{};
    int lanes[5] = {0, 0, 0, 0, 0};
    for (int c = 0; c < 5; ++c) {
      int j = c;
      while (in_regs(lo, j)) j += 5;
      lanes[c] = out.bit[c] = j;
    }
    int b = 5;
    for (int j = 0; j < LOG_C; ++j) {
      bool lane = false;
      for (int c = 0; c < 5; ++c) lane = lane || lanes[c] == j;
      if (!in_regs(lo, j) && !lane) out.bit[b++] = j;
    }
    return out;
  }
  template <int LO>
  static __device__ __forceinline__ int base(int t) {
    constexpr Positions pos = positions(LO);
    int x = 0;
#pragma unroll
    for (int b = 0; b < LOG_C - LOG_R; ++b) x |= ((t >> b) & 1) << pos.bit[b];
    return x;
  }

  // every layout's phys of the thread's base, computed once: p1 is the
  // upper half's base in a MIRROR layout (the bits below LO flipped)
  static constexpr int kLayouts = LOG_C - LOG_R + 1;
  struct Bases {
    int p0[kLayouts], p1[kLayouts];
  };
  template <int LO = 0>
  static __device__ __forceinline__ void init(Bases& bs) {
    if constexpr (LO < kLayouts) {
      const int b = base<LO>(threadIdx.x);
      bs.p0[LO] = phys(b);
      bs.p1[LO] = phys(b ^ ((1 << LO) - 1));
      init<LO + 1>(bs);
    }
  }

  // a row's three words (the key's high and low word, the value) at word w
  static __device__ __forceinline__ void put_row(int32_t* sm, int w, long long k,
                                                 int32_t v) {
    sm[w] = fold_hi(k);
    sm[kWords + w] = (int32_t)k;
    sm[2 * kWords + w] = v;
  }
  static __device__ __forceinline__ void get_row(const int32_t* sm, int w, long long& k,
                                                 int32_t& v) {
    k = (long long)(((unsigned long long)(uint32_t)sm[w] << 32) | (uint32_t)sm[kWords + w]);
    v = sm[2 * kWords + w];
  }

  // the shared-memory word of register r in layout (LO, MIRROR)
  template <int LO, bool MIRROR>
  static __device__ __forceinline__ int word(int p0, int p1, int r) {
    if (MIRROR && (r & (R / 2))) return p1 + phys((r ^ (R / 2 - 1)) << LO);
    return p0 + phys(r << LO);
  }

  template <int LO, bool MIRROR>
  static __device__ __forceinline__ void put(const Rows<R>& x, int32_t* sm,
                                             const Bases& bs) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      put_row(sm, word<LO, MIRROR>(bs.p0[LO], bs.p1[LO], r), x.k[r], x.v[r]);
  }
  template <int LO, bool MIRROR>
  static __device__ __forceinline__ void get(Rows<R>& x, const int32_t* sm,
                                             const Bases& bs) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      get_row(sm, word<LO, MIRROR>(bs.p0[LO], bs.p1[LO], r), x.k[r], x.v[r]);
  }
  template <int FROM, bool FROM_M, int TO, bool TO_M>
  static __device__ __forceinline__ void relayout(Rows<R>& x, int32_t* sm,
                                                  const Bases& bs) {
    if constexpr (FROM != TO || FROM_M != TO_M) {
      __syncthreads();  // every thread has read the last layout
      put<FROM, FROM_M>(x, sm, bs);
      __syncthreads();
      get<TO, TO_M>(x, sm, bs);
    }
  }

  // The CTA's 2^LOG_C contiguous rows striped over the threads, so that a
  // warp's accesses are contiguous: register r of thread t is row
  // (r / 4 * NT + t) * 4 + r % 4 with 16-byte accesses (vec), else
  // r * NT + t.  Rows 4c ... 4c + 3 never straddle a padding word, and the
  // lane bits land on index bits 2-6 (or 0-4): no bank conflict.
  static __device__ __forceinline__ int striped(int r, bool vec) {
    return vec ? ((r >> 2) * NT + (int)threadIdx.x) * 4 + (r & 3) : r * NT + threadIdx.x;
  }
  // rows loaded striped -> the natural layout
  static __device__ __forceinline__ void striped_to_natural(Rows<R>& x, int32_t* sm,
                                                            const Bases& bs, bool vec) {
#pragma unroll
    for (int r = 0; r < R; ++r) put_row(sm, phys(striped(r, vec)), x.k[r], x.v[r]);
    __syncthreads();
    get<0, false>(x, sm, bs);
  }
  // the natural layout -> rows base ... stored striped
  static __device__ __forceinline__ void store_striped(const Rows<R>& x, int32_t* sm,
                                                       const Bases& bs, int32_t* oh,
                                                       int32_t* ol, int32_t* ov,
                                                       long long base, bool vec) {
    __syncthreads();
    put<0, false>(x, sm, bs);
    __syncthreads();
    const int32_t* sh = sm;
    const int32_t* sl = sm + kWords;
    const int32_t* sv = sm + 2 * kWords;
    if (vec) {
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        const int c = q * NT + threadIdx.x;
        const int w = phys(4 * c);
        const uint32_t f = 0x80000000u;
        reinterpret_cast<int4*>(oh + base)[c] = make_int4(sh[w], sh[w + 1], sh[w + 2], sh[w + 3]);
        reinterpret_cast<int4*>(ol + base)[c] =
            make_int4(sl[w] ^ f, sl[w + 1] ^ f, sl[w + 2] ^ f, sl[w + 3] ^ f);
        reinterpret_cast<int4*>(ov + base)[c] = make_int4(sv[w], sv[w + 1], sv[w + 2], sv[w + 3]);
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = striped(r, false), w = phys(i);
        oh[base + i] = sh[w];
        ol[base + i] = sl[w] ^ (int32_t)0x80000000;
        ov[base + i] = sv[w];
      }
    }
  }

  // one stage at register bit B: a half cleaner (partner r ^ 2^B) or, in
  // the natural layout, a flip (partner r ^ (2^(B+1) - 1)); in a MIRROR
  // layout the upper half's pairs put the smaller key on the higher register
  template <int B, bool FLIP, bool MIRROR>
  static __device__ __forceinline__ void stage(Rows<R>& x) {
    constexpr int m = FLIP ? (2 << B) - 1 : 1 << B;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if ((r >> B) & 1) continue;
      if (MIRROR && (r & (R / 2)))
        exchange(x, r ^ m, r);
      else
        exchange(x, r, r ^ m);
    }
  }
  // half cleaners at register bits HI ... LO_B of layout MIRROR
  template <int HI, int LO_B, bool MIRROR>
  static __device__ __forceinline__ void half_cleaners(Rows<R>& x) {
    if constexpr (HI >= LO_B) {
      stage<HI, false, MIRROR>(x);
      half_cleaners<HI - 1, LO_B, MIRROR>(x);
    }
  }

  // the stages at index bits B ... LO_S, half cleaners, from layout CUR
  // (ending in the natural layout): each chunk of LOG_R bits in a layout
  // that holds them in registers
  template <int B, int LO_S, int CUR, bool CUR_M>
  static __device__ __forceinline__ void rest(Rows<R>& x, int32_t* sm,
                                              const Bases& bs) {
    if constexpr (B < LO_S) {
      relayout<CUR, CUR_M, 0, false>(x, sm, bs);
    } else {
      constexpr int L = B - LOG_R + 1 > 0 ? B - LOG_R + 1 : 0;
      relayout<CUR, CUR_M, L, false>(x, sm, bs);
      half_cleaners<B - L, (LO_S > L ? LO_S - L : 0), false>(x);
      rest<L - 1, LO_S, L, false>(x, sm, bs);
    }
  }
  // the stages at index bits HI ... LO_S of one merge, the first a flip
  // (merge 2^(HI + 1)) when FLIP; natural layout in and out
  template <bool FLIP, int HI, int LO_S>
  static __device__ __forceinline__ void run(Rows<R>& x, int32_t* sm,
                                             const Bases& bs) {
    if constexpr (HI < LOG_R) {
      stage<HI, FLIP, false>(x);
      half_cleaners<HI - 1, LO_S, false>(x);
    } else {
      constexpr int L = HI - LOG_R + 1;
      relayout<0, false, L, FLIP>(x, sm, bs);
      half_cleaners<LOG_R - 1, (LO_S > L ? LO_S - L : 0), FLIP>(x);
      rest<L - 1, LO_S, L, FLIP>(x, sm, bs);
    }
  }
  // merges 2^S ... 2^LT
  template <int S, int LT>
  static __device__ __forceinline__ void merges(Rows<R>& x, int32_t* sm,
                                                const Bases& bs) {
    if constexpr (S <= LT) {
      run<true, S - 1, 0>(x, sm, bs);
      merges<S + 1, LT>(x, sm, bs);
    }
  }
};

template <int R>
__device__ __forceinline__ void put4(Rows<R>& x, int r, int4 h, int4 l, int4 w) {
  x.k[r] = fold(h.x, l.x);
  x.k[r + 1] = fold(h.y, l.y);
  x.k[r + 2] = fold(h.z, l.z);
  x.k[r + 3] = fold(h.w, l.w);
  x.v[r] = w.x;
  x.v[r + 1] = w.y;
  x.v[r + 2] = w.z;
  x.v[r + 3] = w.w;
}

// rows row0 ... row0 + R - 1 into the thread's registers; with SHORT, rows
// at n or past it take the fill and are not read
template <bool SHORT, int R>
__device__ __forceinline__ void load_run(Rows<R>& x, const int32_t* kh,
                                         const int32_t* kl, const int32_t* kv,
                                         long long row0, long long n, bool vec) {
  if (!SHORT && vec) {
    const int4* h = reinterpret_cast<const int4*>(kh + row0);
    const int4* l = reinterpret_cast<const int4*>(kl + row0);
    const int4* w = reinterpret_cast<const int4*>(kv + row0);
#pragma unroll
    for (int q = 0; q < R / 4; ++q) put4(x, 4 * q, h[q], l[q], w[q]);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long g = row0 + r;
      x.k[r] = kFill;
      x.v[r] = 0;
      if (!SHORT || g < n) {
        x.k[r] = fold(kh[g], kl[g]);
        x.v[r] = kv[g];
      }
    }
  }
}

template <bool SHORT, int R>
__device__ __forceinline__ void store_run(const Rows<R>& x, int32_t* oh,
                                          int32_t* ol, int32_t* ov,
                                          long long row0, long long n, bool vec) {
  if (!SHORT && vec) {
    int4* h = reinterpret_cast<int4*>(oh + row0);
    int4* l = reinterpret_cast<int4*>(ol + row0);
    int4* w = reinterpret_cast<int4*>(ov + row0);
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const int r = 4 * q;
      h[q] = make_int4(fold_hi(x.k[r]), fold_hi(x.k[r + 1]), fold_hi(x.k[r + 2]),
                       fold_hi(x.k[r + 3]));
      l[q] = make_int4(fold_lo(x.k[r]), fold_lo(x.k[r + 1]), fold_lo(x.k[r + 2]),
                       fold_lo(x.k[r + 3]));
      w[q] = make_int4(x.v[r], x.v[r + 1], x.v[r + 2], x.v[r + 3]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long g = row0 + r;
      if (!SHORT || g < n) {
        oh[g] = fold_hi(x.k[r]);
        ol[g] = fold_lo(x.k[r]);
        ov[g] = x.v[r];
      }
    }
  }
}

// a full CTA's 2^LOG_C rows from base, striped (Net::striped)
template <class N>
__device__ __forceinline__ void load_striped(Rows<N::R>& x, const int32_t* kh,
                                             const int32_t* kl, const int32_t* kv,
                                             long long base, bool vec) {
  if (vec) {
    const int4* h = reinterpret_cast<const int4*>(kh + base);
    const int4* l = reinterpret_cast<const int4*>(kl + base);
    const int4* w = reinterpret_cast<const int4*>(kv + base);
#pragma unroll
    for (int q = 0; q < N::R / 4; ++q) {
      const int c = N::striped(4 * q, true) / 4;
      put4(x, 4 * q, h[c], l[c], w[c]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < N::R; ++r) {
      const long long g = base + N::striped(r, false);
      x.k[r] = fold(kh[g], kl[g]);
      x.v[r] = kv[g];
    }
  }
}

// Sorts every 2^LT tile (LT <= LOG_C) of the CTA's 2^LOG_C rows: the whole
// network up to merge 2^LT.
template <int LOG_R, int LOG_C, int LT>
__global__ void __launch_bounds__(1 << (LOG_C - LOG_R))
bitonic_sort_kernel(const int32_t* __restrict__ kh, const int32_t* __restrict__ kl,
                    const int32_t* __restrict__ kv, int32_t* __restrict__ oh,
                    int32_t* __restrict__ ol, int32_t* __restrict__ ov, long long n,
                    int vec) {
  using N = Net<LOG_R, LOG_C>;
  extern __shared__ int32_t sm[];
  const long long base = (long long)blockIdx.x << LOG_C;
  const long long row0 = base + N::template base<0>(threadIdx.x);
  const bool full = base + (1LL << LOG_C) <= n;
  Rows<N::R> x;
  typename N::Bases bs;
  N::init(bs);
  if (full) {
    load_striped<N>(x, kh, kl, kv, base, vec);
    // a CTA of one whole tile may sort its rows in any order
    if constexpr (LT < LOG_C) N::striped_to_natural(x, sm, bs, vec);
  } else {
    load_run<true>(x, kh, kl, kv, row0, n, false);
  }
  N::template merges<1, LT>(x, sm, bs);
  if (full)
    N::store_striped(x, sm, bs, oh, ol, ov, base, vec);
  else
    store_run<true>(x, oh, ol, ov, row0, n, false);
}

// One global pass of merge k > T_c, in place, at G bits from global bit lo:
// with FLIP, the flip at bit lo + G - 1 (k = 2^(lo + G)) and the half
// cleaners at bits lo + G - 2 ... lo; without, half cleaners at bits
// lo + G - 1 ... lo.  Local row l of a CTA: bits [0, V) the rows of a
// contiguous run, bit V (FLIP) the mirror, the top G bits the pass's bits;
// the local network is the same stages at local bits LOG_C - 1 ... V + FLIP.
// With lo = 0 and G = LOG_C it is the in-CTA merge of the bits below T_c.
template <int G, bool FLIP>
__global__ void __launch_bounds__(1 << (kBigLogC - kBigLogR))
bitonic_pass_kernel(int32_t* kh, int32_t* kl, int32_t* kv, long long n, int lo,
                    int vec) {
  using N = Net<kBigLogR, kBigLogC>;
  constexpr int V = kBigLogC - G - (FLIP ? 1 : 0);
  extern __shared__ int32_t sm[];
  const int mid_bits = lo - V - (FLIP ? 1 : 0);  // CTAs a 2^(lo + G) block
  const long long cta = blockIdx.x;
  const long long mid = cta & ((1LL << mid_bits) - 1);
  const long long blk = (cta >> mid_bits) << (lo + G);
  if ((blk | (mid << V)) >= n) return;  // every row past n
  const bool full = blk + (1LL << (lo + G)) <= n;
  const long long l0 = N::template base<0>(threadIdx.x);
  const long long rest = l0 >> V;
  const bool mirror = FLIP && (rest & 1);
  const long long bits = rest >> (FLIP ? 1 : 0);
  const long long mid_mask = (1LL << (lo - V)) - 1;
  const long long row0 = blk | (bits << lo) |
                         ((mirror ? ~mid & mid_mask : mid) << V) |
                         (l0 & ((1LL << V) - 1));
  constexpr bool kContiguous = G == kBigLogC;  // the in-CTA merge: one block
  Rows<N::R> x;
  typename N::Bases bs;
  N::init(bs);
  if (!full) {
    load_run<true>(x, kh, kl, kv, row0, n, false);
  } else if constexpr (kContiguous) {
    load_striped<N>(x, kh, kl, kv, blk, vec);
    N::striped_to_natural(x, sm, bs, vec);
  } else {
    load_run<false>(x, kh, kl, kv, row0, n, vec);
  }
  N::template run<FLIP, kBigLogC - 1, kBigLogC - G>(x, sm, bs);
  if (!full)
    store_run<true>(x, kh, kl, kv, row0, n, false);
  else if constexpr (kContiguous)
    N::store_striped(x, sm, bs, kh, kl, kv, blk, vec);
  else
    store_run<false>(x, kh, kl, kv, row0, n, vec);
}

// the dynamic shared memory of a kernel: set its limit past 48 KB
template <class K>
cudaError_t smem_limit(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

struct Cols {
  const int32_t *kh, *kl, *kv;
  int32_t *oh, *ol, *ov;
};

template <int LT>
int sort_dispatch(int log_tile, const Cols& c, long long n, int vec,
                  cudaStream_t s) {
  if (log_tile == LT) {
    constexpr bool big = LT > kSmallLogC;
    constexpr int LOG_R = big ? kBigLogR : kSmallLogR;
    constexpr int LOG_C = big ? kBigLogC : kSmallLogC;
    using N = Net<LOG_R, LOG_C>;
    const long long grid = (n + (1LL << LOG_C) - 1) >> LOG_C;
    const cudaError_t err = smem_limit(bitonic_sort_kernel<LOG_R, LOG_C, LT>, N::kSmem);
    if (err != cudaSuccess) return (int)err;
    bitonic_sort_kernel<LOG_R, LOG_C, LT><<<(unsigned)grid, N::NT, N::kSmem, s>>>(c.kh, c.kl, c.kv, c.oh, c.ol, c.ov, n, vec);
    return (int)cudaGetLastError();
  }
  if constexpr (LT < kBigLogC)
    return sort_dispatch<LT + 1>(log_tile, c, n, vec, s);
  else
    return (int)cudaErrorInvalidValue;
}

template <int G, bool FLIP>
int launch_pass(int32_t* kh, int32_t* kl, int32_t* kv, long long n, int lo,
                int vec, cudaStream_t s) {
  constexpr int V = kBigLogC - G - (FLIP ? 1 : 0);
  const int mid_bits = lo - V - (FLIP ? 1 : 0);
  // the CTA's rows must be runs of at least 2^kMinSeg (or all contiguous)
  if (mid_bits < 0 || (V < kMinSeg && lo != 0)) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + (1LL << (lo + G)) - 1) >> (lo + G);
  const long long grid = blocks << mid_bits;
  using N = Net<kBigLogR, kBigLogC>;
  const cudaError_t err = smem_limit(bitonic_pass_kernel<G, FLIP>, N::kSmem);
  if (err != cudaSuccess) return (int)err;
  bitonic_pass_kernel<G, FLIP><<<(unsigned)grid, N::NT, N::kSmem, s>>>(kh, kl, kv, n, lo, vec);
  return (int)cudaGetLastError();
}

template <int G>
int pass_dispatch(int g, int flip, int32_t* kh, int32_t* kl, int32_t* kv,
                  long long n, int lo, int vec, cudaStream_t s) {
  if (g == G) {
    if (flip) {
      if constexpr (G <= kFlipMaxG) return launch_pass<G, true>(kh, kl, kv, n, lo, vec, s);
      return (int)cudaErrorInvalidValue;
    }
    if constexpr (G <= kHalfMaxG || G == kBigLogC)
      return launch_pass<G, false>(kh, kl, kv, n, lo, vec, s);
    return (int)cudaErrorInvalidValue;
  }
  if constexpr (G < kBigLogC)
    return pass_dispatch<G + 1>(g, flip, kh, kl, kv, n, lo, vec, s);
  else
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// Sorts every 2^log_tile rows (log_tile <= 12) of the n rows of (key_hi,
// key_lo, val) into (out_hi, out_lo, out_val).  vec: all six columns are
// 16-byte aligned.
extern "C" int bitonic_sort_launch(const void* key_hi, const void* key_lo,
                                   const void* val, void* out_hi, void* out_lo,
                                   void* out_val, long long n, int log_tile,
                                   int vec, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (log_tile < 0 || log_tile > kBigLogC) return (int)cudaErrorInvalidValue;
  const Cols c{(const int32_t*)key_hi, (const int32_t*)key_lo, (const int32_t*)val,
               (int32_t*)out_hi,       (int32_t*)out_lo,       (int32_t*)out_val};
  return sort_dispatch<0>(log_tile, c, n, vec, (cudaStream_t)stream);
}

// One global pass, in place on the n rows of (key_hi, key_lo, val): g bits
// from bit lo, a flip first when flip is set (bitonic_pass_kernel).
extern "C" int bitonic_pass_launch(void* key_hi, void* key_lo, void* val,
                                   long long n, int lo, int g, int flip, int vec,
                                   void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  return pass_dispatch<1>(g, flip, (int32_t*)key_hi, (int32_t*)key_lo,
                          (int32_t*)val, n, lo, vec, (cudaStream_t)stream);
}

// T_c = 2^log_tc, the most rows one CTA sorts, and 2^min_seg, the contiguous
// rows a thread keeps in a global pass: what bitonic_sort.py::plan assumes.
extern "C" int bitonic_sort_config(int* log_tc, int* min_seg) {
  *log_tc = kBigLogC;
  *min_seg = kMinSeg;
  return 0;
}
