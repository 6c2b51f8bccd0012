// C-channel residue matmul with lazy reduction, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rns_matmul.py::rns_matmul_pallas.
// For each channel c: out[c] = center(A[c] @ B[c] mod m_c), with A (M, K)
// and B (K, N) int8 centered residues.  The K loop accumulates exact int32
// sums with no modular reduction (|acc| <= 64 * 64 * K < 2^31); one
// truncating rem, canonicalize and center runs in the epilogue, bit for bit
// the reference's `lax.rem` -> `r < 0 ? r + m` -> `r > m / 2 ? r - m`.
//
// Design: int8 tensor cores through mma.sync.m16n8k32 (s8.s8.s32).  A block
// computes a 64x64 output tile of one channel with four warps (2x2, 32x32
// each).  A tiles are copied to shared memory as they are (K contiguous);
// B planes are stored with N contiguous while the mma wants B along K, so
// each thread loads a 4(k) x 4(n) byte block with 32-bit loads and
// transposes it in registers with __byte_perm before the shared store.  The
// next tile's global loads are issued before the current tile's mma steps
// (register prefetch).  Ragged M, N and K edges load zeros and skip stores.
//
// Bound on the H100: at decode (M = 8) the weight planes are read once and
// nothing else matters, so the kernel is bound by device memory bytes; at
// prefill (M = 2048) by int8 tensor-core operations.  This first version
// keeps one simple tile shape for both; it does not split K, so a decode
// matmul with few N tiles does not fill every SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int SROW = BK + 16;  // 80-byte shared rows: conflict-free fragments
constexpr int THREADS = 128;
constexpr int MAXC = 8;

struct Moduli {
  int m[MAXC];
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes of one A row starting at column k (zeros past M or K).
__device__ __forceinline__ uint4 load_a16(const int8_t* a, long long lda,
                                          int row, int k, int M, int K,
                                          bool vec) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (row >= M) return v;
  const int8_t* p = a + (long long)row * lda + k;
  if (vec && k + 16 <= K) return *reinterpret_cast<const uint4*>(p);
  unsigned w[4] = {0u, 0u, 0u, 0u};
  for (int i = 0; i < 16; ++i) {
    if (k + i < K) w[i >> 2] |= (unsigned)(uint8_t)p[i] << (8 * (i & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 4 bytes of one B row (fixed k) at columns n..n+3 (zeros past K or N).
__device__ __forceinline__ unsigned load_b4(const int8_t* b, long long ldb,
                                            int k, int n, int K, int N,
                                            bool vec) {
  if (k >= K) return 0u;
  const int8_t* p = b + (long long)k * ldb + n;
  if (vec && n + 4 <= N) return *reinterpret_cast<const unsigned*>(p);
  unsigned w = 0u;
  for (int i = 0; i < 4; ++i) {
    if (n + i < N) w |= (unsigned)(uint8_t)p[i] << (8 * i);
  }
  return w;
}

__global__ void __launch_bounds__(THREADS)
rns_matmul_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                  int32_t* __restrict__ out, Moduli mod, int M, int N, int K,
                  long long a_sc, long long lda, long long b_sc,
                  long long ldb, bool vec_a, bool vec_b) {
  __shared__ __align__(16) int8_t As[BM][SROW];
  __shared__ __align__(16) int8_t Bs[BN][SROW];  // transposed: [n][k]

  const int c = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int8_t* a = A + c * a_sc;
  const int8_t* b = B + c * b_sc;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  // A tile: 64 rows x 64 bytes = 256 chunks of 16 bytes, two per thread.
  // B tile: 16 x 16 blocks of 4(k) x 4(n) bytes, two per thread.
  uint4 ra[2];
  unsigned rb[2][4];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int chunk = tid + i * THREADS;
      int row = chunk >> 2, kc = (chunk & 3) * 16;
      ra[i] = load_a16(a, lda, m0 + row, k0 + kc, M, K, vec_a);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int blk = tid + i * THREADS;
      int kq = blk >> 4, nq = blk & 15;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        rb[i][r] = load_b4(b, ldb, k0 + kq * 4 + r, n0 + nq * 4, K, N, vec_b);
    }
  };
  auto store_tile = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int chunk = tid + i * THREADS;
      int row = chunk >> 2, kc = (chunk & 3) * 16;
      *reinterpret_cast<uint4*>(&As[row][kc]) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int blk = tid + i * THREADS;
      int kq = blk >> 4, nq = blk & 15;
      // rows r0..r3 hold bytes [n0..n3] of k = 4kq + r; column j of the
      // 4x4 byte block becomes the word for n = 4nq + j, bytes k0..k3
      unsigned t0 = __byte_perm(rb[i][0], rb[i][1], 0x5140);
      unsigned t1 = __byte_perm(rb[i][2], rb[i][3], 0x5140);
      unsigned t2 = __byte_perm(rb[i][0], rb[i][1], 0x7362);
      unsigned t3 = __byte_perm(rb[i][2], rb[i][3], 0x7362);
      unsigned col[4] = {__byte_perm(t0, t1, 0x5410),
                         __byte_perm(t0, t1, 0x7632),
                         __byte_perm(t2, t3, 0x5410),
                         __byte_perm(t2, t3, 0x7632)};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<unsigned*>(&Bs[nq * 4 + j][kq * 4]) = col[j];
    }
  };

  load_tile(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    store_tile();
    __syncthreads();
    if (k0 + BK < K) load_tile(k0 + BK);  // in flight during the mma steps
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        int r = wm + mi * 16 + g;
        af[mi][0] = *reinterpret_cast<const unsigned*>(&As[r][kk + t * 4]);
        af[mi][1] = *reinterpret_cast<const unsigned*>(&As[r + 8][kk + t * 4]);
        af[mi][2] = *reinterpret_cast<const unsigned*>(&As[r][kk + 16 + t * 4]);
        af[mi][3] =
            *reinterpret_cast<const unsigned*>(&As[r + 8][kk + 16 + t * 4]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        int n = wn + ni * 8 + g;
        unsigned b0 = *reinterpret_cast<const unsigned*>(&Bs[n][kk + t * 4]);
        unsigned b1 =
            *reinterpret_cast<const unsigned*>(&Bs[n][kk + 16 + t * 4]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_s8(acc[mi][ni], af[mi], b0, b1);
      }
    }
    __syncthreads();
  }

  // Epilogue: one truncating rem, canonicalize, center; masked stores.
  const int m = mod.m[c];
  int32_t* o = out + (long long)c * M * N;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        int row = m0 + wm + mi * 16 + g + (r >= 2 ? 8 : 0);
        int col = n0 + wn + ni * 8 + t * 2 + (r & 1);
        if (row < M && col < N) {
          int v = acc[mi][ni][r] % m;
          if (v < 0) v += m;
          if (v > m / 2) v -= m;
          o[(long long)row * N + col] = v;
        }
      }
}

}  // namespace

extern "C" int rns_matmul_s8(const void* a, const void* b, void* out,
                             const int* moduli, int C, int M, int N, int K,
                             long long a_sc, long long lda, long long b_sc,
                             long long ldb, void* stream) {
  if (C < 1 || C > MAXC) return (int)cudaErrorInvalidValue;
  Moduli mod = {};
  for (int c = 0; c < C; ++c) mod.m[c] = moduli[c];
  bool vec_a = lda % 16 == 0 && a_sc % 16 == 0 &&
               (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  bool vec_b = ldb % 4 == 0 && b_sc % 4 == 0 &&
               (reinterpret_cast<uintptr_t>(b) & 3) == 0;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, C);
  rns_matmul_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)a, (const int8_t*)b, (int32_t*)out, mod, M, N, K, a_sc,
      lda, b_sc, ldb, vec_a, vec_b);
  return (int)cudaGetLastError();
}
