// Signed-digit (SD) residue arithmetic of sdrns_matmul.cu: the two-step
// carry-free rule, the Eq. 2 rotations and the pairwise adder trees of
// repro/core/sd.py and repro/core/sdrns.py (sd_add_tiles.cuh runs the same
// rule on lanes of any width for kernel B8).
//
// The kernels take and give int8 digits in {-1, 0, 1}, LSB first.  The
// end-around transfer sign WS is +1 for 2^n - 1, 0 for 2^n and -1 for
// 2^n + 1.  The matmul (B6, B7) computes on packed digit vectors: a Vec
// holds two masks, z (the digits that are not 0) and s (their signs: 1 for
// -1; a bit of s where z is 0 means nothing), and each 32-bit mask carries
// four digit vectors, one a byte ("lane"): digit i of lane c is bit 8c + i,
// and z's bits above digit n - 1 of each lane are zero.  One bitwise
// operation then works on 4 x n digits at once.
//
// Everything here is __host__ __device__ (plain inline under a host
// compiler), so the arithmetic and the per-thread schedule can be run and
// checked without a card (tests/test_torch_sd_digits_host.py).
#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define SD_HD __host__ __device__ __forceinline__
#else
#define SD_HD inline
#endif

namespace sdk {

// Deepest K tree a launch may need: K <= 2^kMaxLevels.
constexpr int kMaxLevels = 20;
// A block reduces one aligned K chunk of 2^kChunkLog leaves, a complete
// subtree of the K tree; a second pass joins the chunks' roots.
constexpr int kChunkLog = 6;
constexpr int kChunk = 1 << kChunkLog;
constexpr int kJoinLevels = kMaxLevels - kChunkLog;
constexpr int kLanes = 4;          // digit vectors (columns) a 32-bit mask
constexpr int kThreads = 128;      // threads a block, one mask word each
constexpr int kMatmulRows = 4;     // rows a block of B6
constexpr int kMatvecRows = 8;     // B7's most rows (all in one block)
// Roots a launch may keep at once; more rows run in passes.
constexpr long long kRootBudget = 256ll << 20;

SD_HD constexpr int ceil_log2(int k) {
  int d = 0;
  while ((1 << d) < k) ++d;
  return d;
}

SD_HD uint32_t byte_perm(uint32_t x, uint32_t y, uint32_t s) {
#ifdef __CUDA_ARCH__
  return __byte_perm(x, y, s);
#else
  const uint64_t v = ((uint64_t)y << 32) | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i)
    r |= (uint32_t)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i);
  return r;
#endif
}

struct Vec {
  uint32_t z, s;   // lanes' nonzero digits, and their signs (1: -1)
};

template <int N>
struct Lane {
  static constexpr uint32_t kOnes = 0x01010101u;             // digit 0
  static constexpr uint32_t kDigits = (1u << N) - 1;         // one lane
  static constexpr uint32_t kAll = kOnes * kDigits;          // every lane
};

// Digit n - 1 of each lane, moved to digit 0.
template <int N>
SD_HD uint32_t top(uint32_t x) {
  return (x >> (N - 1)) & Lane<N>::kOnes;
}

// The two-step rule with rotated lookahead and end-around transfer
// (sdrns.modular_add) on four lanes at once.  Position sums p in [-2, 2];
// with nn = (p of the position below >= 0), WS times the top one at
// position 0, the transfer is t = (p + nn) >> 1 and the interim w = p - 2t;
// the sum is w plus the transfer from below (WS times the top one at
// position 0), always in {-1, 0, 1}.  On (z, s) masks:
//   |p| = 1 where exactly one digit is nonzero (odd), |p| = 2 where both
//   are, of one sign (two); p's sign sp is x's where x is nonzero, else y's;
//   rn marks the positions whose lookahead is negative (nn = 0);
//   t is nonzero where |p| = 2, or |p| = 1 and sp == rn, with p's sign;
//   w is nonzero where |p| = 1, with sign nn (w = -1 iff nn);
//   s = w + t_in: w and t_in are never both nonzero with one sign, so s is
//   nonzero where exactly one of them is, with its sign.
// rn and the incoming transfer's z may carry a bit above digit n - 1 of
// each lane; every use ands it away.
template <int N, int WS>
SD_HD Vec add(Vec x, Vec y) {
  constexpr uint32_t ones = Lane<N>::kOnes;
  const uint32_t odd = x.z ^ y.z;
  const uint32_t two = x.z & y.z & ~(x.s ^ y.s);
  const uint32_t sp = (x.z & x.s) | (~x.z & y.s);
  const uint32_t neg = (odd | two) & sp;
  uint32_t rn = neg << 1;
  if constexpr (WS == 1) rn |= top<N>(neg);
  if constexpr (WS == -1) rn |= top<N>((odd | two) & ~sp);
  const uint32_t tz = two | (odd & ~(sp ^ rn));   // t's sign is sp
  uint32_t iz = tz << 1, is = sp << 1;
  if constexpr (WS != 0) iz |= top<N>(tz);
  // bit 0 of a lane takes the top sign (flipped for WS -1), not the bit
  // that the shift brought in from the lane below
  if constexpr (WS == 1) is = (is & ~ones) | ((sp >> (N - 1)) & ones);
  if constexpr (WS == -1) is = (is & ~ones) | (~(sp >> (N - 1)) & ones);
  return {(odd ^ iz) & Lane<N>::kAll, (odd & ~rn) | (~odd & is)};
}

// Eq. 2's rotations of one digit vector a (masks of one lane): for p < N,
// rot_p(a) = a * 2^p mod the channel's modulus (roll by p, the p wrapped
// digits times WS), replicated into the four lanes, as rot[2p] (z) and
// rot[2p + 1] (s).
template <int N, int WS>
SD_HD void rotations(Vec a, uint32_t* rot) {
  constexpr uint32_t all = Lane<N>::kDigits;
  const uint32_t wz = WS == 0 ? 0 : a.z;          // wrapped digits x WS
  const uint32_t ws = WS == -1 ? ~a.s & all : a.s;
#pragma unroll
  for (int p = 0; p < N; ++p) {
    const uint32_t rz = p == 0 ? a.z : ((a.z << p) & all) | (wz >> (N - p));
    const uint32_t rs = p == 0 ? a.s : ((a.s << p) & all) | (ws >> (N - p));
    rot[2 * p] = rz * Lane<N>::kOnes;
    rot[2 * p + 1] = rs * Lane<N>::kOnes;
  }
}

// Words of A's staged rotations a digit vector (2N, padded for 16-byte
// loads).
template <int N>
constexpr int kRotStride = (2 * N + 3) / 4 * 4;

// B's digit p of each lane as two lane-wide selectors, from the 4N bytes
// of four consecutive digit vectors (wd: N words, byte t = digit t % N of
// lane t / N): nz marks the lanes whose digit is not 0, ng those whose
// digit is -1 (int8 0xFF; +1 is 0x01).
template <int N, int P = 0>
SD_HD void selectors(const uint32_t* wd, uint32_t* nz, uint32_t* ng) {
  if constexpr (P < N) {
    constexpr int t0 = P, t1 = N + P, t2 = 2 * N + P, t3 = 3 * N + P;
    const uint32_t lo = byte_perm(wd[t0 >> 2], wd[t1 >> 2],
                                  (t0 & 3) | ((4 + (t1 & 3)) << 4));
    const uint32_t hi = byte_perm(wd[t2 >> 2], wd[t3 >> 2],
                                  (t2 & 3) | ((4 + (t3 & 3)) << 4));
    const uint32_t g = byte_perm(lo, hi, 0x5410);
    nz[P] = (g & Lane<N>::kOnes) * Lane<N>::kDigits;
    ng[P] = (g >> 1) & Lane<N>::kAll;
    selectors<N, P + 1>(wd, nz, ng);
  }
}

// Leaf p of the digit tree, rot_p(a) * b_p, on four lanes.
template <int N>
SD_HD Vec leaf(uint32_t rz, uint32_t rs, uint32_t nz, uint32_t ng) {
  return {rz & nz, rs ^ ng};
}

// Node (L, J) of the digit tree of one product a * b: the perfect binary
// tree over 2^ceil(log2 N) leaves, leaf p the Eq. 2 partial product
// rot_p(a) * b_p, leaves past N zero.  This is sd.pairwise_reduce's
// pairing: it pads an odd level with one zero vector, and x + 0 is not x
// digit for digit, so the node over a leaf and a zero subtree is an add.
// A node wholly past N is the zero vector (0 + 0 = 0 exactly), and is not
// computed.
template <int N, int WS, int L, int J>
SD_HD Vec mul_node(const uint32_t* rot, const uint32_t* nz,
                   const uint32_t* ng) {
  if constexpr (J * (1 << L) >= N) {
    return {0, 0};
  } else if constexpr (L == 0) {
    return leaf<N>(rot[2 * J], rot[2 * J + 1], nz[J], ng[J]);
  } else {
    return add<N, WS>(mul_node<N, WS, L - 1, 2 * J>(rot, nz, ng),
                      mul_node<N, WS, L - 1, 2 * J + 1>(rot, nz, ng));
  }
}

// SD modular product (sdrns.modular_mul with x = a, y = b).
template <int N, int WS>
SD_HD Vec mul(const uint32_t* rot, const uint32_t* nz, const uint32_t* ng) {
  return mul_node<N, WS, ceil_log2(N), 0>(rot, nz, ng);
}

// A subtree of 2^S leaves of a pairwise tree, streamed leaf by leaf as a
// binary counter: st[l] is the pending node of level l.  sd.pairwise_reduce
// over K equals the perfect binary tree over 2^ceil(log2 K) leaves whose
// leaves past K are zero.  The level loops are unrolled and their branches
// uniform across a warp, so st stays in registers.
template <int N, int WS, int S>
struct Tree {
  Vec st[S + 1];

  // leaf number k (0 <= k < 2^S) closes the subtrees of its trailing ones
  // (no early exit: the loop unrolls to static indices)
  SD_HD void push(int k, Vec cur) {
    bool carry = true;
#pragma unroll
    for (int l = 0; l < S; ++l) {
      if (carry) {
        if ((k >> l) & 1) {
          cur = add<N, WS>(st[l], cur);
        } else {
          st[l] = cur;
          carry = false;
        }
      }
    }
    if (carry) st[S] = cur;
  }

  // The node at level D (D <= S) over the first `count` leaves (1 <= count
  // <= 2^D), the leaves past count zero: the pending nodes close against
  // zero siblings up to level D and no further (one add too many changes
  // the digits).
  SD_HD Vec root(int count, int D) const {
    Vec cur{0, 0};
    bool have = false;
#pragma unroll
    for (int l = 0; l < S; ++l) {
      if (l < D) {
        if ((count >> l) & 1) {
          cur = add<N, WS>(st[l], cur);
          have = true;
        } else if (have) {
          cur = add<N, WS>(cur, Vec{0, 0});
        }
      }
    }
    if (!have) {   // count = 2^D: the node is complete
#pragma unroll
      for (int l = 0; l <= S; ++l)
        if (l == D) cur = st[l];
    }
    return cur;
  }
};

// ---------------------------------------------------------------------------
// The matmul schedule (kernels B6 and B7), split into the steps of one
// block and one thread so that a host loop can run it as the kernels do.
//
// Pass 1 (chunk): a block owns channel c, R rows from r0 (B6: 4; B7: all
// M <= 8, rounded up to 1, 2, 4 or 8), one K chunk and
// kThreads mask words (4 columns each).  It stages the rotations of A's
// digit vectors for its rows and chunk in shared memory (stage); then each
// thread reads its four columns' B digit vectors once per k, turns them
// into selectors, multiplies them by every row's staged rotations and
// streams the products into that row's chunk tree (chunk_word), and writes
// each row's chunk root, still packed, to the roots workspace.
// Pass 2 (join): a thread joins one (c, m, word)'s chunk roots by the same
// tree, from level kChunkLog up to ceil(log2 K), and writes the int8
// digits (join_word).  Rows past the workspace's budget run in passes of
// rows_pass rows; row m of a pass is row m0 + m.
// ---------------------------------------------------------------------------

struct MatmulArgs {
  const int8_t* a;     // (C, M, K, N) digits, (K, N) contiguous
  const int8_t* b;     // (C, K, cols, N) digits, (cols, N) contiguous
  int8_t* out;         // (C, M, cols, N) digits, contiguous
  Vec* roots;          // (C, rows_pass, chunks, words) packed chunk roots
  int M, cols, K;
  long long a_cs, lda, b_cs, ldb;   // channel and row strides (elements)
  int m0, rows;        // this pass: rows m0 .. m0 + rows - 1
  int words, chunks;
  int b_aligned;       // B rows and channels start on 4-byte boundaries
};

// Launch geometry, shared by the launcher and the host harness.
struct Plan {
  int R;               // rows a block
  int rows_pass;       // rows a pass (the roots workspace holds them)
  int words, chunks, col_tiles;
  long long root_bytes;
};

SD_HD Plan plan(int C, int M, int cols, int K, bool matvec,
                long long budget = kRootBudget) {
  Plan pl;
  pl.R = !matvec ? kMatmulRows : M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : 8;
  pl.words = (cols + kLanes - 1) / kLanes;
  pl.chunks = (K + kChunk - 1) / kChunk;
  pl.col_tiles = (pl.words + kThreads - 1) / kThreads;
  const long long row = (long long)C * pl.chunks * pl.words * sizeof(Vec);
  long long fit = budget / row / pl.R * pl.R;
  if (fit < pl.R) fit = pl.R;
  // a pass's rows are grid dimensions: C x row tiles on the chunk launch's
  // z, the rows themselves on the join's y, each at most 65535
  // (M 65536 is one VGG-16 conv at batch 64)
  long long grid = 65535LL / C * pl.R;
  if (grid > 65535) grid = 65535 / pl.R * pl.R;
  if (fit > grid) fit = grid;
  pl.rows_pass = fit < M ? (int)fit : M;
  pl.root_bytes = row * pl.rows_pass;
  return pl;
}

SD_HD uint32_t load_word(const int8_t* p) {
#ifdef __CUDA_ARCH__
  return __ldg(reinterpret_cast<const unsigned int*>(p));
#else
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
#endif
}

// The 4N digit bytes of mask word w in one B row (N words; zero past cols).
template <int N>
SD_HD void load_b(const int8_t* row, int w, int cols, bool aligned,
                  uint32_t* wd) {
  const int8_t* p = row + (long long)w * kLanes * N;
  if (aligned && (w + 1) * kLanes <= cols) {
#pragma unroll
    for (int i = 0; i < N; ++i) wd[i] = load_word(p + 4 * i);
  } else {
    const int bytes = (cols - w * kLanes) * N;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      uint32_t v = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (4 * i + t < bytes) v |= (uint32_t)(uint8_t)p[4 * i + t] << (8 * t);
      wd[i] = v;
    }
  }
}

// Staged rotations: srot[(kk * R + r) * kRotStride<N> + ...], for the
// chunk's kc leaves and the block's R rows (rows past M stay zero).
template <int N, int WS, int R>
SD_HD void stage(const MatmulArgs& g, int c, int r0, int chunk, int tid,
                 int nthreads, uint32_t* srot) {
  const int k0 = chunk * kChunk;
  const int kc = g.K - k0 < kChunk ? g.K - k0 : kChunk;
  const int rows = g.rows - r0 < R ? g.rows - r0 : R;
  for (int idx = tid; idx < kc * R; idx += nthreads) {
    const int kk = idx / R, r = idx % R;
    Vec a{0, 0};
    if (r < rows) {
      const int8_t* d = g.a + c * g.a_cs + (long long)(g.m0 + r0 + r) * g.lda +
                        (long long)(k0 + kk) * N;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        a.z |= (uint32_t)(d[i] != 0) << i;
        a.s |= (uint32_t)(d[i] < 0) << i;
      }
    }
    rotations<N, WS>(a, srot + idx * kRotStride<N>);
  }
}

template <int N>
SD_HD void load_rot(const uint32_t* s, uint32_t* rot) {
#ifdef __CUDA_ARCH__
#pragma unroll
  for (int i = 0; i < kRotStride<N> / 4; ++i) {
    const uint4 v = reinterpret_cast<const uint4*>(s)[i];
    rot[4 * i] = v.x;
    rot[4 * i + 1] = v.y;
    rot[4 * i + 2] = v.z;
    rot[4 * i + 3] = v.w;
  }
#else
  for (int i = 0; i < kRotStride<N>; ++i) rot[i] = s[i];
#endif
}

template <int N, int WS, int R>
SD_HD void chunk_word(const MatmulArgs& g, int c, int r0, int chunk, int w,
                      const uint32_t* srot) {
  const int k0 = chunk * kChunk;
  const int kc = g.K - k0 < kChunk ? g.K - k0 : kChunk;
  const int rows = g.rows - r0 < R ? g.rows - r0 : R;
  const int8_t* bp = g.b + c * g.b_cs + (long long)k0 * g.ldb;
  Tree<N, WS, kChunkLog> tree[R];
  uint32_t wd[N];
  load_b<N>(bp, w, g.cols, g.b_aligned, wd);
  for (int kk = 0; kk < kc; ++kk) {
    uint32_t nz[N], ng[N];
    selectors<N>(wd, nz, ng);
    if (kk + 1 < kc)   // the next leaf's B words load under this one's work
      load_b<N>(bp + (long long)(kk + 1) * g.ldb, w, g.cols, g.b_aligned,
                wd);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < rows) {
        uint32_t rot[kRotStride<N>];
        load_rot<N>(srot + (kk * R + r) * kRotStride<N>, rot);
        tree[r].push(kk, mul<N, WS>(rot, nz, ng));
      }
    }
  }
  // one chunk: the whole K tree's root, at level ceil(log2 K) <= kChunkLog
  const int D = g.chunks == 1 ? ceil_log2(g.K) : kChunkLog;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < rows)
      g.roots[(((long long)c * g.rows + r0 + r) * g.chunks + chunk) *
                  g.words + w] = tree[r].root(kc, D);
  }
}

template <int N, int WS>
SD_HD void join_word(const MatmulArgs& g, int c, int m, int w) {
  const Vec* r = g.roots + ((long long)c * g.rows + m) * g.chunks * g.words +
                 w;
  Tree<N, WS, kJoinLevels> tree;
  for (int i = 0; i < g.chunks; ++i) tree.push(i, r[(long long)i * g.words]);
  const int D = ceil_log2(g.K) - kChunkLog;
  const Vec v = tree.root(g.chunks, D > 0 ? D : 0);
  int8_t* o = g.out + (((long long)c * g.M + g.m0 + m) * g.cols +
                       (long long)w * kLanes) * N;
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    if (w * kLanes + l < g.cols) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int b = 8 * l + i;
        o[l * N + i] = (int8_t)((v.z >> b) & 1 ? 1 - 2 * ((v.s >> b) & 1) : 0);
      }
    }
  }
}

}  // namespace sdk
