// Fused SD-RNS modular matmul for sm_90a: kernels B6 and B7.
//
// Replaces repro/kernels/sdrns_matmul.py::sdrns_matmul_pallas (B6, grid
// (C, M/bm, N/bn)) and ::sdrns_matvec_pallas (B7, the decode schedule with
// M <= 8 whole).  Per channel c with end-around sign ws_c, out[c, m, j] is
// the SD digit vector of (A_c @ B_c)[m, j] mod m_c: every term a[m,k] *
// b[k,j] is the Eq. 2 product (n rotations of a's digits selected by b's
// digits, reduced by the pairwise end-around adder tree), and the K terms
// reduce by the same pairwise tree.  The output digit vectors, not only
// their values, equal the reference's: see sd_digits.cuh for the trees.
//
// One body, two launch schedules.  A block is one channel, R = 8 rows and
// blockDim columns, one column per thread; each thread reads its column's
// B digit vector once per k and reuses it for every row of the block.
//   B7 (matvec, M <= 8): grid (cols / bn, 1, C), all M rows in one block,
//      so every B digit vector is read once per launch.
//   B6 (matmul): grid (cols / bn, ceil(M / 8), C), the rows tiled by 8.
//
// Bound on the H100: the digit planes are 7 B per residue (21 B per weight
// at C = 3), so a decode step's planes at 3.35 TB/s are the byte bound; a
// prefill's int8 multiply-accumulates at 1979 TOPS are the operation bound.
// This design is limited by neither but by the rate of integer instructions
// on the CUDA cores: each term costs n - 1 = 6 digit-tree adds plus about
// one K-tree add, a few integer operations per digit each, so a few hundred
// operations per (c, m, k, j) term; no tensor-core instruction computes a
// digit vector.  The levers (packed +/- digit masks, 6 B per weight, and
// K-parallel trees) are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sd_digits.cuh"

namespace {

constexpr int kRows = 8;     // rows per block (both schedules)
constexpr int kMaxC = 8;

struct Signs {
  int v[kMaxC];
};

template <int N, int WS>
__device__ void body(const sdk::MatmulArgs& g, int c) {
  __shared__ int sa[sdk::KC * kRows * N];
  const int r0 = blockIdx.y * kRows;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  sdk::KTree<N, WS> tree[kRows];
  for (int k0 = 0; k0 < g.K; k0 += sdk::KC) {
    sdk::stage_a<N, kRows>(g, c, r0, k0, threadIdx.x, blockDim.x, sa);
    __syncthreads();
    if (j < g.cols) sdk::mul_chunk<N, WS, kRows>(g, c, r0, k0, j, sa, tree);
    __syncthreads();
  }
  if (j < g.cols) sdk::finish_rows<N, WS, kRows>(g, c, r0, j, tree);
}

template <int N>
__global__ void __launch_bounds__(128)
sdrns_kernel(sdk::MatmulArgs g, Signs ws) {
  const int c = blockIdx.z;
  const int w = ws.v[c];
  if (w == 1) {
    body<N, 1>(g, c);
  } else if (w == 0) {
    body<N, 0>(g, c);
  } else {
    body<N, -1>(g, c);
  }
}

}  // namespace

// a (C, M, K, n), b (C, K, cols, n) int8 digits with (K, n) and (cols, n)
// contiguous; out (C, M, cols, n) int8, contiguous.  wrap_signs: host int[C]
// in {1, 0, -1}.  matvec selects B7's schedule (needs M <= 8).  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported width or shape).
extern "C" int sdrns_matmul_s8(const void* a, const void* b, void* out,
                               const int* wrap_signs, int C, int M, int cols,
                               int K, int n, long long a_cs, long long lda,
                               long long b_cs, long long ldb, int matvec,
                               void* stream) {
  if (C < 1 || C > kMaxC || M < 1 || cols < 1 || K < 1 ||
      K > (1 << sdk::kMaxLevels) || (matvec && M > kRows))
    return (int)cudaErrorInvalidValue;
  sdk::MatmulArgs g{static_cast<const int8_t*>(a),
                    static_cast<const int8_t*>(b), static_cast<int8_t*>(out),
                    M, cols, K, a_cs, lda, b_cs, ldb};
  Signs ws{};
  for (int c = 0; c < C; ++c) ws.v[c] = wrap_signs[c];
  // wide column blocks where the grid fills the card (264 blocks: two per
  // SM), narrow ones where it would not (N <= 11264 at C = 3)
  const int bn = (long long)C * ((cols + 127) / 128) >= 264 ? 128 : 32;
  dim3 grid((cols + bn - 1) / bn, matvec ? 1 : (M + kRows - 1) / kRows, C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 5: sdrns_kernel<5><<<grid, bn, 0, s>>>(g, ws); break;
    case 7: sdrns_kernel<7><<<grid, bn, 0, s>>>(g, ws); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
