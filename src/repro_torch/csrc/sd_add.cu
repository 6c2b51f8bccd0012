// Batched carry-free SD addition for sm_90a: kernel B8.
//
// Replaces repro/kernels/sd_add.py::sd_add_pallas.  x, y (B, n) int8 digit
// vectors (LSB first, n <= 16) -> their sum by the two-step rule with the
// rotated lookahead and the end-around transfer of the kind (pow2m1 +1,
// pow2 0, pow2p1 -1), or for "plain" no wrap and the transfer out of the
// top position kept as digit n (out (B, n + 1)).  The reference pads the
// digit axis to 128 lanes for the TPU's vector unit; here the vectors stay
// n bytes wide.
//
// Schedule (csrc/sd_add_tiles.cuh, where the index maps and the packed
// arithmetic live): a block stages a tile of 1024 vectors of x and y into
// shared memory with 16-byte cp.async copies, two stages deep (the next
// tile's copies fly while this one is added), each thread packs its four
// vectors into (nonzero, sign) masks, adds them with bitwise operations on
// 4n digits at once and spreads the sum back into bytes, and the tile goes
// back with 16-byte stores.  The grid fills the card (resident blocks an
// SM x SMs) and strides over the tiles.  Any base address and any B work:
// the unaligned bytes at a range's ends go one by one, and the vectors
// past a ragged last tile are never stored.
//
// Bound on the H100: bytes (2n in, n or n + 1 out per vector) at 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sd_add_tiles.cuh"

namespace {

template <int N, int WS, bool PLAIN>
__global__ void __launch_bounds__(sda::kThreads)
sd_add_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ y,
              uint8_t* __restrict__ out, long long B) {
  constexpr int NO = PLAIN ? N + 1 : N;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* os = sda::out_buf(smem, N);
  const int tid = threadIdx.x;
  const long long tiles = sda::num_tiles(B);
  auto stage = [&](long long t, int b) {
    const long long bytes = (long long)sda::tile_count(t, B) * N;
    sda::stage_in(x + t * sda::kTile * N, bytes, sda::x_buf(smem, N, b), tid,
                  sda::kThreads);
    sda::stage_in(y + t * sda::kTile * N, bytes, sda::y_buf(smem, N, b), tid,
                  sda::kThreads);
  };
  if (blockIdx.x < tiles) stage(blockIdx.x, 0);
  sda::async_commit();
  int b = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, b ^= 1) {
    // the other stage was last read before the previous tile's second
    // barrier: the next tile's copies may land there now
    if (t + gridDim.x < tiles) stage(t + gridDim.x, b ^ 1);
    sda::async_commit();
    sda::async_wait_prior();
    __syncthreads();
    const int cnt = sda::tile_count(t, B);
    const long long v0 = t * sda::kTile;
    uint8_t* og = out + v0 * NO;
    sda::thread_add<N, WS, PLAIN>(
        sda::x_buf(smem, N, b), sda::y_buf(smem, N, b), os, tid,
        sda::misalign(x + v0 * N), sda::misalign(y + v0 * N),
        sda::misalign(og));
    __syncthreads();
    // os is rewritten only after the next tile's first barrier
    sda::stage_out(os, og, (long long)cnt * NO, tid, sda::kThreads);
  }
}

template <int N, int WS, bool PLAIN>
int launch(const uint8_t* x, const uint8_t* y, uint8_t* out, long long B,
           cudaStream_t s) {
  static int grid_cap = 0;   // resident blocks an SM x SMs, found once
  const int smem = sda::smem_bytes(N, PLAIN);
  if (grid_cap == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        sd_add_kernel<N, WS, PLAIN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sd_add_kernel<N, WS, PLAIN>, sda::kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    grid_cap = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long tiles = sda::num_tiles(B);
  const unsigned grid = (unsigned)(tiles < grid_cap ? tiles : grid_cap);
  sd_add_kernel<N, WS, PLAIN><<<grid, sda::kThreads, smem, s>>>(x, y, out, B);
  return (int)cudaGetLastError();
}

template <int N>
int launch_n(int kind, const uint8_t* x, const uint8_t* y, uint8_t* out,
             long long B, cudaStream_t s) {
  switch (kind) {
    case 1: return launch<N, 1, false>(x, y, out, B, s);
    case 0: return launch<N, 0, false>(x, y, out, B, s);
    case -1: return launch<N, -1, false>(x, y, out, B, s);
    case 2: return launch<N, 0, true>(x, y, out, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

using LaunchN = int (*)(int, const uint8_t*, const uint8_t*, uint8_t*,
                        long long, cudaStream_t);
constexpr LaunchN kByDigits[sda::kMaxDigits + 1] = {
    nullptr,      launch_n<1>,  launch_n<2>,  launch_n<3>,  launch_n<4>,
    launch_n<5>,  launch_n<6>,  launch_n<7>,  launch_n<8>,  launch_n<9>,
    launch_n<10>, launch_n<11>, launch_n<12>, launch_n<13>, launch_n<14>,
    launch_n<15>, launch_n<16>};

}  // namespace

// kind: 1 pow2m1, 0 pow2, -1 pow2p1, 2 plain.  x, y (B, n) contiguous; out
// (B, n) or (B, n + 1) for plain, contiguous; any alignment.  Returns
// cudaGetLastError().
extern "C" int sd_add_s8(const void* x, const void* y, void* out,
                         long long B, int n, int kind, void* stream) {
  if (B < 1 || n < 1 || n > sda::kMaxDigits) return (int)cudaErrorInvalidValue;
  return kByDigits[n](kind, static_cast<const uint8_t*>(x),
                      static_cast<const uint8_t*>(y),
                      static_cast<uint8_t*>(out), B,
                      static_cast<cudaStream_t>(stream));
}
