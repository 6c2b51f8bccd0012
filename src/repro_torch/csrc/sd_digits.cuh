// Signed-digit (SD) residue arithmetic shared by sdrns_matmul.cu and
// sd_add.cu: the two-step carry-free rule, the Eq. 2 rotations and the
// pairwise adder trees of repro/core/sd.py and repro/core/sdrns.py.
//
// A digit vector is held as N ints in {-1, 0, 1}, LSB first, one register
// each (the kernels take and give int8 digits in memory).  The end-around
// transfer sign WS is +1 for 2^n - 1, 0 for 2^n and -1 for 2^n + 1.
//
// Everything here is __host__ __device__ (plain inline under a host
// compiler), so the arithmetic and the per-thread schedule can be run
// and checked without a card.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define SD_HD __host__ __device__ __forceinline__
#else
#define SD_HD inline
#endif

namespace sdk {

// Deepest K tree a launch may need: K <= 2^kMaxLevels.
constexpr int kMaxLevels = 20;

SD_HD int trailing_ones(unsigned k) {
#ifdef __CUDA_ARCH__
  return __ffs(~k) - 1;
#else
  return __builtin_ctz(~k);
#endif
}

SD_HD int ceil_log2(int k) {
  int d = 0;
  while ((1 << d) < k) ++d;
  return d;
}

// The two-step rule with rotated lookahead and end-around transfer
// (sdrns.modular_add).  Position sums p in [-2, 2]; the lookahead prev is
// p of the position below (WS times the top one at position 0).  The
// reference's case table is, with nn = (prev >= 0):
//   t = (p + nn) >> 1  (arithmetic shift: p=2 -> 1, p=1 -> nn, p=0 -> 0,
//                       p=-1 -> nn - 1, p=-2 -> -1),   w = p - 2t,
// and the sum is w plus the transfer of the position below (WS times the
// top one at position 0).  s may alias x or y.
template <int N, int WS>
SD_HD void add_mod(const int* x, const int* y, int* s) {
  int p[N], t[N], w[N];
#pragma unroll
  for (int i = 0; i < N; ++i) p[i] = x[i] + y[i];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int prev = i == 0 ? WS * p[N - 1] : p[i - 1];
    t[i] = (p[i] + (prev >= 0 ? 1 : 0)) >> 1;
    w[i] = p[i] - 2 * t[i];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = w[i] + (i == 0 ? WS * t[N - 1] : t[i - 1]);
}

// Node (L, J) of the digit tree of one product a * b: the perfect binary
// tree over 2^ceil(log2 N) leaves, leaf p the Eq. 2 partial product
// rot_p(a) * b_p (roll a by p, the p wrapped digits times WS), leaves past
// N zero.  This is sd.pairwise_reduce's pairing: it pads an odd level with
// one zero vector, and x + 0 is not x digit for digit, so the node over a
// leaf and a zero subtree is an add.  A node wholly past N is the zero
// vector (0 + 0 = 0 exactly), and is not computed.
template <int N, int WS, int L, int J>
SD_HD void mul_node(const int* a, const int* b, int* out) {
  if constexpr (J * (1 << L) >= N) {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = 0;
  } else if constexpr (L == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      out[i] = (i >= J ? a[i - J] : WS * a[i - J + N]) * b[J];
  } else {
    int lo[N], hi[N];
    mul_node<N, WS, L - 1, 2 * J>(a, b, lo);
    mul_node<N, WS, L - 1, 2 * J + 1>(a, b, hi);
    add_mod<N, WS>(lo, hi, out);
  }
}

template <int N>
constexpr int depth_of() {
  int d = 0;
  while ((1 << d) < N) ++d;
  return d;
}

// SD modular product (sdrns.modular_mul with x = a, y = b).
template <int N, int WS>
SD_HD void mul_mod(const int* a, const int* b, int* out) {
  mul_node<N, WS, depth_of<N>(), 0>(a, b, out);
}

// A digit vector packed two bits per digit (N <= 16), for the K tree's
// pending nodes.
template <int N>
SD_HD uint32_t pack(const int* d) {
  uint32_t v = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) v |= (uint32_t)(d[i] & 3) << (2 * i);
  return v;
}

template <int N>
SD_HD void unpack(uint32_t v, int* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = (int)(v << (30 - 2 * i)) >> 30;
}

// The K tree of one output, streamed: sd.pairwise_reduce over K equals the
// perfect binary tree over 2^D leaves (D = ceil(log2 K)) whose leaves past
// K are zero.  Leaf k closes the subtrees of its trailing one bits (a
// binary counter); finish() closes the pending ones against zero siblings
// up to level D, and no further (one add too many changes the digits).
template <int N, int WS>
struct KTree {
  uint32_t st[kMaxLevels + 1];

  SD_HD void push(int k, const int* leaf) {
    int cur[N], tmp[N];
#pragma unroll
    for (int i = 0; i < N; ++i) cur[i] = leaf[i];
    const int lvl = trailing_ones((unsigned)k);
    for (int l = 0; l < lvl; ++l) {
      unpack<N>(st[l], tmp);
      add_mod<N, WS>(tmp, cur, cur);
    }
    st[lvl] = pack<N>(cur);
  }

  SD_HD void finish(int K, int* out) {
    const int D = ceil_log2(K);
    int cur[N], tmp[N], zero[N];
#pragma unroll
    for (int i = 0; i < N; ++i) zero[i] = 0;
    bool have = false;
    for (int l = 0; l < D; ++l) {
      if ((K >> l) & 1) {
        unpack<N>(st[l], tmp);
        add_mod<N, WS>(tmp, have ? cur : zero, cur);
        have = true;
      } else if (have) {
        add_mod<N, WS>(cur, zero, cur);
      }
    }
    if (!have) unpack<N>(st[D], cur);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = cur[i];
  }
};

// ---------------------------------------------------------------------------
// The matmul schedule (kernels B6 and B7), split into the steps of one
// thread so that a host loop can run it as the kernel does.  A block owns
// channel c, the rows r0 .. r0 + R - 1 and blockDim columns, one column per
// thread.  K is walked in chunks of KC: the block stages the chunk's A digit
// vectors for its rows in shared memory (stage_a), then every thread reads
// its column's B digit vector once per k and multiplies it by each row's A
// vector, streaming the products into that row's K tree (mul_chunk).
// ---------------------------------------------------------------------------

constexpr int KC = 32;   // K chunk staged per step

struct MatmulArgs {
  const int8_t* a;     // (C, M, K, N) digits, (K, N) contiguous
  const int8_t* b;     // (C, K, cols, N) digits, (cols, N) contiguous
  int8_t* out;         // (C, M, cols, N) digits, contiguous
  int M, cols, K;
  long long a_cs, lda, b_cs, ldb;   // channel and row strides (elements)
};

// Staged A: sa[(kk * R + r) * N + i], KC * R * N ints.
template <int N, int R>
SD_HD void stage_a(const MatmulArgs& g, int c, int r0, int k0, int tid,
                   int nthreads, int* sa) {
  const int kc = g.K - k0 < KC ? g.K - k0 : KC;
  const int rows = g.M - r0 < R ? g.M - r0 : R;
  for (int idx = tid; idx < kc * R * N; idx += nthreads) {
    const int kk = idx / (R * N), r = (idx / N) % R, i = idx % N;
    sa[idx] = r < rows ? (int)g.a[c * g.a_cs + (long long)(r0 + r) * g.lda +
                                  (long long)(k0 + kk) * N + i]
                       : 0;
  }
}

template <int N, int WS, int R>
SD_HD void mul_chunk(const MatmulArgs& g, int c, int r0, int k0, int j,
                     const int* sa, KTree<N, WS>* tree) {
  const int kc = g.K - k0 < KC ? g.K - k0 : KC;
  const int rows = g.M - r0 < R ? g.M - r0 : R;
  const int8_t* bp = g.b + c * g.b_cs + (long long)k0 * g.ldb +
                     (long long)j * N;
  for (int kk = 0; kk < kc; ++kk, bp += g.ldb) {
    int bd[N];
#pragma unroll
    for (int i = 0; i < N; ++i) bd[i] = bp[i];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < rows) {
        int ad[N], leaf[N];
#pragma unroll
        for (int i = 0; i < N; ++i) ad[i] = sa[(kk * R + r) * N + i];
        mul_mod<N, WS>(ad, bd, leaf);
        tree[r].push(k0 + kk, leaf);
      }
    }
  }
}

template <int N, int WS, int R>
SD_HD void finish_rows(const MatmulArgs& g, int c, int r0, int j,
                       KTree<N, WS>* tree) {
  const int rows = g.M - r0 < R ? g.M - r0 : R;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < rows) {
      int res[N];
      tree[r].finish(g.K, res);
      int8_t* o = g.out + (((long long)c * g.M + r0 + r) * g.cols + j) * N;
#pragma unroll
      for (int i = 0; i < N; ++i) o[i] = (int8_t)res[i];
    }
  }
}

// ---------------------------------------------------------------------------
// Batched addition (kernel B8): one digit vector per call, n <= 16 digits
// at run time (the unrolled loops keep the arrays in registers).  ws is
// the end-around sign; plain (ws 0) writes the transfer out of the top
// position as digit n (sd.carry_free_add).
// ---------------------------------------------------------------------------

constexpr int kMaxAddDigits = 16;

template <int WS>
SD_HD void add_vector(const int8_t* x, const int8_t* y, int8_t* out, int n,
                      bool plain) {
  int p[kMaxAddDigits], t[kMaxAddDigits];
  int ptop = 0;
#pragma unroll
  for (int i = 0; i < kMaxAddDigits; ++i) {
    if (i < n) {
      p[i] = (int)x[i] + (int)y[i];
      if (i == n - 1) ptop = p[i];
    }
  }
  int ttop = 0;
#pragma unroll
  for (int i = 0; i < kMaxAddDigits; ++i) {
    if (i < n) {
      const int prev = i == 0 ? WS * ptop : p[i - 1];
      t[i] = (p[i] + (prev >= 0 ? 1 : 0)) >> 1;
      if (i == n - 1) ttop = t[i];
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxAddDigits; ++i) {
    if (i < n) {
      const int w = p[i] - 2 * t[i];
      out[i] = (int8_t)(w + (i == 0 ? WS * ttop : t[i - 1]));
    }
  }
  if (plain) out[n] = (int8_t)ttop;
}

}  // namespace sdk
