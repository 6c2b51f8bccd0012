// Batched carry-free SD addition for sm_90a: kernel B8.
//
// Replaces repro/kernels/sd_add.py::sd_add_pallas.  x, y (B, n) int8 digit
// vectors (LSB first, n <= 16) -> their sum, one thread per vector: the
// two-step rule with the rotated lookahead and the end-around transfer of
// the kind (pow2m1 +1, pow2 0, pow2p1 -1), or for "plain" no wrap and the
// transfer out of the top position kept as digit n (out (B, n + 1)).  The
// reference pads the digit axis to 128 lanes for the TPU's vector unit;
// here the vectors stay n bytes wide.
//
// Bound on the H100: bytes (2n in, n or n + 1 out per vector) at 3.35 TB/s;
// the per-vector work is a few dozen integer operations.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sd_digits.cuh"

namespace {

template <int WS>
__global__ void sd_add_kernel(const int8_t* __restrict__ x,
                              const int8_t* __restrict__ y,
                              int8_t* __restrict__ out, long long B, int n,
                              int plain) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= B) return;
  const int out_n = plain ? n + 1 : n;
  sdk::add_vector<WS>(x + v * n, y + v * n, out + v * out_n, n, plain != 0);
}

}  // namespace

// kind: 1 pow2m1, 0 pow2, -1 pow2p1, 2 plain.  x, y (B, n) contiguous; out
// (B, n) or (B, n + 1) for plain, contiguous.  Returns cudaGetLastError().
extern "C" int sd_add_s8(const void* x, const void* y, void* out,
                         long long B, int n, int kind, void* stream) {
  if (B < 1 || n < 1 || n > sdk::kMaxAddDigits) return (int)cudaErrorInvalidValue;
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* yp = static_cast<const int8_t*>(y);
  auto* op = static_cast<int8_t*>(out);
  const int threads = 256;
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 1: sd_add_kernel<1><<<blocks, threads, 0, s>>>(xp, yp, op, B, n, 0); break;
    case 0: sd_add_kernel<0><<<blocks, threads, 0, s>>>(xp, yp, op, B, n, 0); break;
    case -1: sd_add_kernel<-1><<<blocks, threads, 0, s>>>(xp, yp, op, B, n, 0); break;
    case 2: sd_add_kernel<0><<<blocks, threads, 0, s>>>(xp, yp, op, B, n, 1); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
