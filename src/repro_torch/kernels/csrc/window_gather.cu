// Server side of ``mgetsuffix`` (paper §IV-B): batched suffix-window gather.
//
// Replaces the Pallas kernel repro/kernels/window_gather.py::window_gather.
// For each request q < m it writes the k tokens corpus[rows[q], offs[q] + c]
// for c < k: a row outside [0, R) gives a zero window, the offset is clamped
// to [0, L], and tokens at offs[q] + c >= L are 0.
//
// Bound: bytes.  It reads 8m index bytes and the corpus tokens the windows
// hold, and writes 4mk bytes; there is no arithmetic to speak of.  Random
// windows of 104 bytes (k = 26) touch 4-5 32-byte sectors each, so the DRAM
// bytes read exceed the bound's count of exact tokens.
//
// What a thread per output word lost: a 64-bit division by a run-time k for
// every word, 26 reloads of a request's row and offset, one 4-byte corpus
// load per thread, and 128-byte stores per warp instruction.
//
// Design: a tile of T requests per CTA (T = kTile = 64 unless k needs a
// smaller tile to fit shared memory), over a persistent grid of
// min(tiles, SMs x resident CTAs).  The CTA loads its tile's rows and offsets
// once, coalesced (the next tile's are loaded into registers while this one
// gathers), and keeps per request the corpus word of its first token (64-bit)
// and its count of valid tokens n = clamp(L - off, 0, k) (0 for a row out of
// range) in shared memory.  G threads serve a request (G a power of two that
// covers its chunks, at most 16; wider windows stride), so the request of a
// thread is a shift, and no word needs a division.
//   - Vector path (corpus 16-byte aligned and L % 4 == 0, as the reads corpus
//     is: L = 200): a thread loads aligned 16-byte chunks of the row with
//     ld.global.nc.v4, a chunk of each pass over the tile in flight (at most
//     eight), and only chunks whose first word holds a valid token.  Such a
//     chunk never leaves its row, since rows start and end on 16-byte
//     boundaries.  Otherwise (odd L, or a view whose base is not aligned) the
//     same kernel loads 4 words one at a time.  Each thread scatters its words
//     into the tile in shared memory at their column, keeping the n valid ones
//     and writing 0 to the rest, so every word of the tile is written once.
//   - The tile (T*k*4 bytes, a multiple of 16) leaves contiguous by coalesced
//     16-byte stores from shared memory; the ragged last tile by 4-byte ones.
//     On an H100 at k = 26 these stores were faster than a TMA bulk copy of
//     the tile (cp.async.bulk.global.shared::cta) at 64 requests a tile, the
//     fastest tile of either (PERF.md, PR 16).  Tiles alternate between two
//     shared buffers: the barriers let no gather overlap a store, so one
//     would do, but one buffer timed slower on an H100 at k = 26, for a
//     reason not established.
// The TPU kernel instead ran one grid step per request with a
// scalar-prefetched row DMA, which has no counterpart here.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;   // requests a tile; at most kThreads, a multiple of 4
constexpr int kMaxG = 16;   // threads per request at most
constexpr int kSmemMax = 232448;  // bytes of shared memory a CTA may use
constexpr int kMaxDevices = 64;   // devices whose launch shape is kept

template <int G, bool VEC>
__global__ void __launch_bounds__(kThreads)
window_gather_kernel(const int32_t* __restrict__ corpus,
                     const int32_t* __restrict__ rows,
                     const int32_t* __restrict__ offs,
                     int32_t* __restrict__ out, long long m, int k,
                     long long r, int l, int tile_q, long long tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tk = tile_q * k;  // words of a tile, a multiple of 4
  int32_t* const bufs = reinterpret_cast<int32_t*>(smem);  // two tiles
  long long* const s_src = reinterpret_cast<long long*>(smem + 8 * (size_t)tk);
  int* const s_n = reinterpret_cast<int*>(s_src + tile_q);

  const int tid = threadIdx.x;
  const int sub = tid & (G - 1);     // the thread's chunk of its request
  const int qi = tid / G;            // its request within a pass
  constexpr int kPerPass = kThreads / G;
  // chunk loads in flight per thread: a full tile's passes, at most 8
  constexpr int kFull = kTile / kPerPass;
  constexpr int kUnroll = kFull < 1 ? 1 : (kFull > 8 ? 8 : kFull);
  const int passes = (tile_q + kPerPass - 1) / kPerPass;
  // chunks a window spans: from the aligned word below its first token on
  // the vector path, from the first token itself on the word path
  const int chunks = VEC ? (k + 6) >> 2 : (k + 3) >> 2;

  long long tile = blockIdx.x;
  int row = 0, off = 0;  // this thread's request of the next tile
  if (tid < min((long long)tile_q, m - tile * tile_q)) {
    row = rows[tile * tile_q + tid];
    off = offs[tile * tile_q + tid];
  }
  for (int it = 0; tile < tiles; tile += gridDim.x, ++it) {
    const long long q0 = tile * tile_q;
    const int tq = (int)min((long long)tile_q, m - q0);
    int32_t* const buf = bufs + (it & 1) * tk;
    if (tid < tq) {
      const int o = min(max(off, 0), l);
      const bool ok = row >= 0 && row < r;
      s_src[tid] = ok ? (long long)row * l + o : 0;
      s_n[tid] = ok ? min(l - o, k) : 0;
    }
    __syncthreads();
    const long long next = tile + gridDim.x;
    if (next < tiles && tid < min((long long)tile_q, m - next * tile_q)) {
      row = rows[next * tile_q + tid];
      off = offs[next * tile_q + tid];
    }

    for (int j0 = 0; j0 < chunks; j0 += G) {
      const int j = j0 + sub;
      for (int p0 = 0; p0 < passes; p0 += kUnroll) {
        int4 v[kUnroll];
        int shift[kUnroll], n[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int q = (p0 + u) * kPerPass + qi;
          v[u] = make_int4(0, 0, 0, 0);
          n[u] = -1;  // no request
          shift[u] = 0;
          if (p0 + u < passes && q < tq && j < chunks) {
            const long long src = s_src[q];
            n[u] = s_n[q];
            shift[u] = VEC ? (int)(src & 3) : 0;
            const int c = 4 * j - shift[u];  // column of the chunk's first word
            const int32_t* p = corpus + (src - shift[u]) + 4 * j;
            if (VEC) {
              if (c < n[u]) v[u] = __ldg(reinterpret_cast<const int4*>(p));
            } else {
              if (c < n[u]) v[u].x = __ldg(p);
              if (c + 1 < n[u]) v[u].y = __ldg(p + 1);
              if (c + 2 < n[u]) v[u].z = __ldg(p + 2);
              if (c + 3 < n[u]) v[u].w = __ldg(p + 3);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (n[u] < 0) continue;
          const int q = (p0 + u) * kPerPass + qi;
          const int c = 4 * j - shift[u];
          int32_t* dst = buf + q * k;
          const int32_t w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (c + e >= 0 && c + e < k) dst[c + e] = c + e < n[u] ? w[e] : 0;
          }
        }
      }
    }

    int32_t* const gout = out + q0 * k;
    __syncthreads();
    if (tq == tile_q) {
      const int4* s4 = reinterpret_cast<const int4*>(buf);
      int4* g4 = reinterpret_cast<int4*>(gout);
      for (int i = tid; i < tk / 4; i += kThreads) g4[i] = s4[i];
    } else {
      for (int i = tid; i < tq * k; i += kThreads) gout[i] = buf[i];
    }
  }
}

template <int G, bool VEC>
cudaError_t launch(const int32_t* corpus, const int32_t* rows,
                   const int32_t* offs, int32_t* out, long long m, int k,
                   long long r, int l, cudaStream_t stream) {
  // the largest tile of at most kTile requests, a multiple of 4 (so that a
  // tile's bytes are a multiple of 16), whose two buffers and request table
  // fit in shared memory
  const long long per_request = 8LL * k + 12;
  const int tile_q =
      (int)std::min<long long>(kTile, kSmemMax / per_request) & ~3;
  if (tile_q < 4) return cudaErrorInvalidValue;  // k too wide
  const size_t smem = (size_t)tile_q * per_request;
  auto kernel = window_gather_kernel<G, VEC>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  // the grid's CTAs for this shared-memory size, kept per device as
  // (smem << 32) | ctas, so that a launch at the last size (every launch of
  // a build: k is fixed) sets no attribute and asks no occupancy
  static std::atomic<unsigned long long> shape[kMaxDevices];
  unsigned long long kept = dev < kMaxDevices ? shape[dev].load() : 0;
  if ((kept >> 32) != smem) {
    // the same limit from every caller, so that no launch lowers it below
    // what another, on another thread, is about to use
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    int sms = 0, resident = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    if (resident < 1) return cudaErrorInvalidConfiguration;
    kept = ((unsigned long long)smem << 32) | (unsigned)(sms * resident);
    if (dev < kMaxDevices) shape[dev].store(kept);
  }
  const long long ctas = (long long)(kept & 0xffffffffu);
  const long long tiles = (m + tile_q - 1) / tile_q;
  const long long grid = std::min<long long>(tiles, ctas);
  kernel<<<(unsigned int)grid, kThreads, smem, stream>>>(
      corpus, rows, offs, out, m, k, r, l, tile_q, tiles);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_g(int g, const int32_t* corpus, const int32_t* rows,
                     const int32_t* offs, int32_t* out, long long m, int k,
                     long long r, int l, cudaStream_t s) {
  switch (g) {
    case 1: return launch<1, VEC>(corpus, rows, offs, out, m, k, r, l, s);
    case 2: return launch<2, VEC>(corpus, rows, offs, out, m, k, r, l, s);
    case 4: return launch<4, VEC>(corpus, rows, offs, out, m, k, r, l, s);
    case 8: return launch<8, VEC>(corpus, rows, offs, out, m, k, r, l, s);
    default: return launch<kMaxG, VEC>(corpus, rows, offs, out, m, k, r, l, s);
  }
}

}  // namespace

// vec != 0: the caller has checked that corpus is 16-byte aligned and
// l % 4 == 0 (the vector path); out must be 16-byte aligned.
extern "C" int window_gather_launch(const void* corpus, const void* rows,
                                    const void* offs, void* out, long long m,
                                    int k, long long r, int l, int vec,
                                    void* stream) {
  if (m <= 0 || k <= 0) return (int)cudaSuccess;
  const int chunks = vec ? (k + 6) >> 2 : (k + 3) >> 2;
  int g = 1;
  while (g < chunks && g < kMaxG) g <<= 1;
  const auto* c = static_cast<const int32_t*>(corpus);
  const auto* ro = static_cast<const int32_t*>(rows);
  const auto* of = static_cast<const int32_t*>(offs);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(vec ? launch_g<true>(g, c, ro, of, o, m, k, r, l, s)
                   : launch_g<false>(g, c, ro, of, o, m, k, r, l, s));
}
