// Server side of ``mgetsuffix`` (paper §IV-B): batched suffix-window gather.
//
// Replaces the Pallas kernel repro/kernels/window_gather.py::window_gather.
// For each request q < m it writes the k tokens corpus[rows[q], offs[q] + c]
// for c < k: a row outside [0, R) gives a zero window, the offset is clamped
// to [0, L], and tokens at offs[q] + c >= L are 0.
//
// Bound: memory.  It reads 8m index bytes and at most min(m*k, R*L)*4 corpus
// bytes and writes m*k*4 bytes; there is no arithmetic to speak of.  Design:
// one thread per output token (flat index t -> request t / k, column t % k),
// so consecutive threads write consecutive words and the stores, the larger
// stream, are fully coalesced.  The k threads of one request read one
// contiguous run of the corpus row, and the request's row and offset are
// read once per thread from L1/L2.  The TPU kernel instead ran one grid step
// per request with a scalar-prefetched row DMA, which has no counterpart.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void window_gather_kernel(const int32_t* __restrict__ corpus,
                                     const int32_t* __restrict__ rows,
                                     const int32_t* __restrict__ offs,
                                     int32_t* __restrict__ out, long long m,
                                     int k, long long r, int l) {
  const long long total = m * (long long)k;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const long long q = t / k;
    const int c = (int)(t - q * k);
    const int row = rows[q];
    const int off = min(max(offs[q], 0), l);
    int32_t v = 0;
    if (row >= 0 && row < r && off + c < l) {
      v = corpus[(long long)row * l + off + c];
    }
    out[t] = v;
  }
}

extern "C" int window_gather_launch(const void* corpus, const void* rows,
                                    const void* offs, void* out, long long m,
                                    int k, long long r, int l, void* stream) {
  const long long total = m * (long long)k;
  if (total <= 0) return (int)cudaSuccess;
  const int block = 256;
  long long grid = (total + block - 1) / block;
  if (grid > (1LL << 30)) grid = 1LL << 30;  // grid-stride loop covers the rest
  window_gather_kernel<<<(unsigned int)grid, block, 0,
                         (cudaStream_t)stream>>>(
      (const int32_t*)corpus, (const int32_t*)rows, (const int32_t*)offs,
      (int32_t*)out, m, k, r, l);
  return (int)cudaGetLastError();
}
