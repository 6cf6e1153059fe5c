// Run-start group ids of sorted rows, in one pass over the rows.
//
// Replaces no Pallas kernel.  The JAX package computes these ids with
// lax.cummax (repro/core/distributed.py::run_starts), and the port's plain
// version with torch.cummax (repro_torch/kernels/ref.py::run_starts_ref).
// For n rows it writes the int32
//   g[i] = max over j <= i of (eq[j] ? -1 : j),
// the index of the first row of row i's run, where either
//   - (columns mode) eq[0] = 0 and, for i >= 1,
//     eq[i] = valid[i] & AND over the w <= 3 int32 key columns of
//     (col[i] == col[i-1]), computed here from the columns and the bool
//     valid mask (a padding row starts a run of its own), or
//   - (flags mode) eq is a given bool array, eq[0] included: rows before the
//     first row with eq false read -1.
//
// Bound: bytes.  A row reads 4 bytes a column and one flag byte and writes a
// 4-byte id, (4w + 5) bytes in all; there is no arithmetic to speak of.  The
// flags, the candidate ids and the scan's index output of the plain version
// are never written to device memory.
//
// Design: tiles of kTile = 4096 rows, one CTA of 256 threads a tile, each
// thread 16 contiguous rows (16-byte loads where every array starts on a
// 16-byte boundary and the thread's rows lie below n; 4-byte loads
// otherwise).  A thread packs its rows' eq flags into a 16-bit mask: row
// r0 + j against r0 + j - 1 in registers, its first row against the previous
// thread's last by a warp shuffle or, across warps, shared memory, and the
// tile's first row against row tile0 - 1 read from device memory.  The
// block max-scans the threads' last run starts (a warp scan, then the eight
// warp totals).  Tiles are numbered in the order their CTAs start (an atomic
// counter), so every earlier tile is running or done, and the scan across
// tiles is a single-pass decoupled look-back over one status word a tile:
//   0        not ready;
//   1        the tile's rows hold no run start (its aggregate is -1);
//   v + 3    the inclusive prefix v >= -1: the last run start at or before
//            the tile's last row (-1: none).
// A tile that holds a run start knows its inclusive prefix at once (its own
// last start beats every earlier row's index) and publishes it before it
// looks back.  Only a tile whose first row continues a run looks back: warp
// 0 reads the status words of the 32 tiles before it together, waits while
// a tile nearer than the nearest inclusive prefix is not ready, and takes
// that prefix, or steps 32 tiles further back when all 32 hold no start.  A
// tile with no start publishes its inclusive prefix once its look-back ends.
// So one run over every tile stays linear: a look-back passes only tiles
// that have not yet published their inclusive prefix, which are tiles still
// running, and never walks over all the tiles before it.  The status words
// are the only scratch (the wrapper's, zeroed here on the stream); the
// launch needs no host read and no synchronisation.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;  // rows a thread
constexpr int kTile = kThreads * kRows;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoStart = 1u;  // status: no run start in the tile
constexpr int kBias = 3;           // status: inclusive prefix v as v + kBias

struct Cols {
  const int32_t* c[3];
};

__device__ __forceinline__ unsigned load_status(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// The 16 flag bytes from row r0 as bits (bit j: byte r0 + j is not 0);
// rows at or past n read 0.
template <bool VEC>
__device__ __forceinline__ unsigned load_flags(const uint8_t* __restrict__ f,
                                               long long r0, long long n,
                                               bool full) {
  unsigned bits = 0;
  if (VEC && full) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(f + r0));
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        bits |= (((w[q] >> (8 * b)) & 0xffu) != 0u ? 1u : 0u) << (4 * q + b);
  } else {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (r0 + j < n && f[r0 + j] != 0) bits |= 1u << j;
    }
  }
  return bits;
}

// The 16 words of a column from row r0 (rows at or past n read 0).
template <bool VEC>
__device__ __forceinline__ void load_rows(const int32_t* __restrict__ c,
                                          long long r0, long long n, bool full,
                                          int32_t (&v)[kRows]) {
  if (VEC && full) {
    const int4* p = reinterpret_cast<const int4*>(c + r0);
#pragma unroll
    for (int q = 0; q < kRows / 4; ++q) {
      const int4 x = __ldg(p + q);
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kRows; ++j) v[j] = r0 + j < n ? c[r0 + j] : 0;
  }
}

// Warp 0 of tile `tile`: the inclusive prefix of tile - 1 (-1 before tile 0).
__device__ int look_back(const unsigned* status, int tile, int lane) {
  for (int base = tile - 1;; base -= 32) {
    const int t = base - lane;  // lane 0 is the nearest tile
    unsigned s = t >= 0 ? load_status(status + t) : unsigned(kBias - 1);
    while (true) {
      const unsigned incl = __ballot_sync(kFull, s > kNoStart);
      const unsigned wait = __ballot_sync(kFull, s == 0u);
      const unsigned nearest = incl & (0u - incl);  // lowest lane with a prefix
      const unsigned nearer = nearest ? nearest - 1u : kFull;
      if (wait & nearer) {  // a nearer tile may still publish a later start
        if (s == 0u) s = load_status(status + t);
        continue;
      }
      if (nearest) {
        const unsigned v = __shfl_sync(kFull, s, __ffs(nearest) - 1);
        return static_cast<int>(v) - kBias;
      }
      break;  // 32 tiles without a run start: look further back
    }
  }
}

template <int W, bool FROM_FLAGS, bool VEC>
__global__ void __launch_bounds__(kThreads)
run_groups_kernel(Cols cols, const uint8_t* __restrict__ flags,
                  int32_t* __restrict__ out, long long n,
                  unsigned* __restrict__ scratch) {
  __shared__ int s_tile;
  __shared__ int32_t s_last[W > 0 ? W : 1][kWarps];
  __shared__ int s_warp_max[kWarps];
  __shared__ int s_prefix;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  unsigned* const status = scratch + 1;
  if (tid == 0) s_tile = static_cast<int>(atomicAdd(scratch, 1u));
  __syncthreads();
  const int tile = s_tile;
  const long long tile0 = static_cast<long long>(tile) * kTile;
  const long long r0 = tile0 + static_cast<long long>(tid) * kRows;
  const bool full = r0 + kRows <= n;

  // eq: bit j set when row r0 + j continues the run of row r0 + j - 1
  unsigned eq = load_flags<VEC>(flags, r0, n, full);  // or valid, refined below
  if (!FROM_FLAGS) {
    int32_t first[W > 0 ? W : 1];
    int32_t prev[W > 0 ? W : 1];
#pragma unroll
    for (int c = 0; c < W; ++c) {
      int32_t v[kRows];
      load_rows<VEC>(cols.c[c], r0, n, full, v);
      unsigned same = 1u;  // bit 0 is settled below
#pragma unroll
      for (int j = 1; j < kRows; ++j) same |= (v[j] == v[j - 1] ? 1u : 0u) << j;
      eq &= same | ~0xffffu;
      first[c] = v[0];
      prev[c] = __shfl_up_sync(kFull, v[kRows - 1], 1);
      if (lane == 31) s_last[c][warp] = v[kRows - 1];
    }
    if (W > 0) __syncthreads();
    bool same0 = r0 > 0;  // row 0 starts a run
    if (same0) {
#pragma unroll
      for (int c = 0; c < W; ++c) {
        const int32_t p = lane > 0 ? prev[c]
                          : warp > 0 ? s_last[c][warp - 1]
                                     : cols.c[c][tile0 - 1];
        same0 &= first[c] == p;
      }
    }
    if (!same0) eq &= ~1u;
  }
  // rows at or past n start nothing (and are not written)
  if (!full) eq |= r0 >= n ? 0xffffu : 0xffffu & ~((1u << (n - r0)) - 1u);

  // the thread's last run start, max-scanned over the block
  const unsigned starts = ~eq & 0xffffu;
  const int mine = starts ? static_cast<int>(r0) + 31 - __clz(starts) : -1;
  int incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl = max(incl, o);
  }
  if (lane == 31) s_warp_max[warp] = incl;
  int excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = -1;
  __syncthreads();
  int tile_max = -1;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) excl = max(excl, s_warp_max[w]);
    tile_max = max(tile_max, s_warp_max[w]);
  }

  if (warp == 0) {
    if (lane == 0)
      store_status(status + tile,
                   tile_max >= 0 ? static_cast<unsigned>(tile_max + kBias) : kNoStart);
    // the rows before the tile's first run start need the earlier tiles'
    const bool continues = __shfl_sync(kFull, eq & 1u, 0) != 0u;
    const int prefix = continues && tile > 0 ? look_back(status, tile, lane) : -1;
    if (lane == 0) {
      s_prefix = prefix;
      if (tile_max < 0) store_status(status + tile, static_cast<unsigned>(prefix + kBias));
    }
  }
  __syncthreads();

  int run = max(s_prefix, excl);
  int32_t g[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if (!((eq >> j) & 1u)) run = static_cast<int>(r0) + j;
    g[j] = run;
  }
  if (VEC && full) {
    int4* p = reinterpret_cast<int4*>(out + r0);
#pragma unroll
    for (int q = 0; q < kRows / 4; ++q)
      p[q] = make_int4(g[4 * q], g[4 * q + 1], g[4 * q + 2], g[4 * q + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      if (r0 + j < n) out[r0 + j] = g[j];
  }
}

template <int W, bool FROM_FLAGS>
void launch_w(bool vec, long long tiles, cudaStream_t stream, const Cols& cols,
              const uint8_t* flags, int32_t* out, long long n, unsigned* scratch) {
  const dim3 grid(static_cast<unsigned>(tiles));
  if (vec)
    run_groups_kernel<W, FROM_FLAGS, true><<<grid, kThreads, 0, stream>>>(
        cols, flags, out, n, scratch);
  else
    run_groups_kernel<W, FROM_FLAGS, false><<<grid, kThreads, 0, stream>>>(
        cols, flags, out, n, scratch);
}

}  // namespace

// g (n,) int32 from w in [0, 3] int32 key columns and the bool mask `flags`
// (columns mode, from_flags = 0: flags is `valid`), or from the bool eq
// flags alone (flags mode, from_flags = 1, w = 0).  `scratch` holds
// `scratch_words` uint32, at least one a tile of 4096 rows plus one.
// `vec`: every array starts on a 16-byte boundary.  Returns the launch's
// cudaError_t (0 on success); n = 0 launches nothing.
extern "C" int run_groups_launch(const int32_t* c0, const int32_t* c1,
                                 const int32_t* c2, int w, const uint8_t* flags,
                                 int from_flags, int32_t* out, long long n,
                                 unsigned* scratch, long long scratch_words,
                                 int vec, cudaStream_t stream) {
  if (n < 0 || n >= (1LL << 31) || w < 0 || w > 3 || (from_flags && w != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const long long tiles = (n + kTile - 1) / kTile;
  if (scratch_words < tiles + 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(scratch, 0, (tiles + 1) * sizeof(unsigned), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Cols cols = {{c0, c1, c2}};
  const bool v = vec != 0;
  if (from_flags) {
    launch_w<0, true>(v, tiles, stream, cols, flags, out, n, scratch);
  } else {
    switch (w) {
      case 0: launch_w<0, false>(v, tiles, stream, cols, flags, out, n, scratch); break;
      case 1: launch_w<1, false>(v, tiles, stream, cols, flags, out, n, scratch); break;
      case 2: launch_w<2, false>(v, tiles, stream, cols, flags, out, n, scratch); break;
      default: launch_w<3, false>(v, tiles, stream, cols, flags, out, n, scratch); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
