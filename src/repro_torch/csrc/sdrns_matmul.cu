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
// Bounds on the H100: the digit planes are 7 B per residue digit vector,
// so a decode step's weights at 3.35 TB/s are the byte bound.  No
// tensor-core instruction computes a digit vector, so the work runs on the
// CUDA cores, and their integer issue rate is what binds: ~16.7 T 32-bit
// logic operations/s (LOP3, shifts: 64 lanes a clock an SM, 132 SMs at
// 1.98 GHz).  A term is n leaves, n - 1 digit-tree adds (plus one for a
// zero subtree) and about one add of the K tree.
//
// What the design does about it:
// - Packed masks: a digit vector is two n-bit masks (nonzero digits, their
//   signs), four columns to a 32-bit word, so the carry-free add is ~18
//   operations for 4 x n digits (sdk::add, ~12 of them LOP3) and a leaf is
//   two.  Digits are int8 only in memory.  The (nonzero, sign) pair costs
//   fewer operations than (+1 digits, -1 digits): a leaf's sign is one xor,
//   and the interim digit's sign is the lookahead itself.
// - A's rotations staged once: a block stages rot_p(a[m, k]) for its rows
//   and K chunk in shared memory, lane-replicated; every thread reads them
//   as broadcasts for its four columns.  B7 keeps all M <= 8 rows in one
//   block, so each B digit vector is read once a launch; B6 tiles rows by
//   4 (grid z = C x row tiles): 8 rows a block read B half as often but
//   need ~190 registers a thread, and ran slower.
// - K-parallel trees: K splits into aligned chunks of 2^6 leaves, each a
//   complete subtree of the reference's K tree, reduced in registers (the
//   binary counter unrolled, static indices, no stack frame).  So C x
//   column tiles x chunks blocks fill the card at every shape of the
//   serves (>= 384 at K 4096, N 1024).  A second launch joins the chunk
//   roots, packed in a workspace the wrapper allocates, from level 6 to
//   ceil(log2 K).  No atomics.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sd_digits.cuh"

namespace {

constexpr int kMaxC = 8;

struct Signs {
  int v[kMaxC];
};

template <int N, int WS, int R>
__device__ void chunk_body(const sdk::MatmulArgs& g, int c, int r0,
                           uint32_t* srot) {
  sdk::stage<N, WS, R>(g, c, r0, blockIdx.y, threadIdx.x, blockDim.x, srot);
  __syncthreads();
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w < g.words) sdk::chunk_word<N, WS, R>(g, c, r0, blockIdx.y, w, srot);
}

// grid (column tiles, K chunks, C x row tiles)
// 8 rows need ~190 registers a thread; three blocks an SM run faster
template <int N, int R>
__global__ void __launch_bounds__(sdk::kThreads, R >= 8 ? 3 : 1)
sdrns_chunk_kernel(sdk::MatmulArgs g, Signs ws) {
  __shared__ __align__(16) uint32_t srot[sdk::kChunk * R *
                                         sdk::kRotStride<N>];
  const int tiles = (g.rows + R - 1) / R;
  const int c = blockIdx.z / tiles, r0 = blockIdx.z % tiles * R;
  const int w = ws.v[c];
  if (w == 1) {
    chunk_body<N, 1, R>(g, c, r0, srot);
  } else if (w == 0) {
    chunk_body<N, 0, R>(g, c, r0, srot);
  } else {
    chunk_body<N, -1, R>(g, c, r0, srot);
  }
}

// grid (column tiles, rows of the pass, C)
template <int N>
__global__ void __launch_bounds__(sdk::kThreads)
sdrns_join_kernel(sdk::MatmulArgs g, Signs ws) {
  const int c = blockIdx.z, m = blockIdx.y;
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= g.words) return;
  const int s = ws.v[c];
  if (s == 1) {
    sdk::join_word<N, 1>(g, c, m, w);
  } else if (s == 0) {
    sdk::join_word<N, 0>(g, c, m, w);
  } else {
    sdk::join_word<N, -1>(g, c, m, w);
  }
}

template <int N>
void launch_pass(const sdk::MatmulArgs& g, const Signs& ws, int C, int R,
                 int col_tiles, cudaStream_t s) {
  const dim3 chunk(col_tiles, g.chunks, C * ((g.rows + R - 1) / R));
  switch (R) {
    case 1: sdrns_chunk_kernel<N, 1><<<chunk, sdk::kThreads, 0, s>>>(g, ws); break;
    case 2: sdrns_chunk_kernel<N, 2><<<chunk, sdk::kThreads, 0, s>>>(g, ws); break;
    case 4: sdrns_chunk_kernel<N, 4><<<chunk, sdk::kThreads, 0, s>>>(g, ws); break;
    default: sdrns_chunk_kernel<N, 8><<<chunk, sdk::kThreads, 0, s>>>(g, ws); break;
  }
  sdrns_join_kernel<N><<<dim3(col_tiles, g.rows, C), sdk::kThreads, 0, s>>>(
      g, ws);
}

}  // namespace

// Bytes of the chunk-roots workspace sdrns_matmul_s8 needs for this call.
extern "C" long long sdrns_matmul_workspace(int C, int M, int cols, int K,
                                            int matvec) {
  return sdk::plan(C, M, cols, K, matvec != 0).root_bytes;
}

// a (C, M, K, n), b (C, K, cols, n) int8 digits with (K, n) and (cols, n)
// contiguous; out (C, M, cols, n) int8, contiguous; roots a device
// workspace of sdrns_matmul_workspace(...) bytes.  wrap_signs: host int[C]
// in {1, 0, -1}.  matvec selects B7's schedule (needs M <= 8).  Two
// launches a pass of rows (chunk trees, then the join).  Returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue for an
// unsupported width or shape).
extern "C" int sdrns_matmul_s8(const void* a, const void* b, void* out,
                               void* roots, const int* wrap_signs, int C,
                               int M, int cols, int K, int n, long long a_cs,
                               long long lda, long long b_cs, long long ldb,
                               int matvec, void* stream) {
  if (C < 1 || C > kMaxC || M < 1 || cols < 1 || K < 1 ||
      K > (1 << sdk::kMaxLevels) || (matvec && M > sdk::kMatvecRows) ||
      (n != 5 && n != 7))
    return (int)cudaErrorInvalidValue;
  const sdk::Plan pl = sdk::plan(C, M, cols, K, matvec != 0);
  if ((long long)C * ((pl.rows_pass + pl.R - 1) / pl.R) > 65535 ||
      pl.rows_pass > 65535)
    return (int)cudaErrorInvalidValue;
  Signs ws{};
  for (int c = 0; c < C; ++c) ws.v[c] = wrap_signs[c];
  const bool aligned = reinterpret_cast<uintptr_t>(b) % 4 == 0 &&
                       b_cs % 4 == 0 && ldb % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int m0 = 0; m0 < M; m0 += pl.rows_pass) {
    sdk::MatmulArgs g{static_cast<const int8_t*>(a),
                      static_cast<const int8_t*>(b),
                      static_cast<int8_t*>(out),
                      static_cast<sdk::Vec*>(roots),
                      M, cols, K, a_cs, lda, b_cs, ldb,
                      m0, M - m0 < pl.rows_pass ? M - m0 : pl.rows_pass,
                      pl.words, pl.chunks, aligned ? 1 : 0};
    if (n == 5)
      launch_pass<5>(g, ws, C, pl.R, pl.col_tiles, s);
    else
      launch_pass<7>(g, ws, C, pl.R, pl.col_tiles, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
