// The batched carry-free SD adder (kernel B8) on packed digit masks, with
// the schedule that feeds it: tile staging, packing and unpacking.
//
// A block adds one tile of kTile digit vectors of n digits (n <= 16, LSB
// first, int8 in {-1, 0, 1}) at a time, in a grid-stride loop over tiles:
//   1. stage_in: the tile's n * kTile bytes of x and of y are copied into
//      shared memory with 16-byte cp.async copies (the aligned 16-byte
//      chunks of the range; the at most 15 bytes before the first and after
//      the last go byte by byte, so any base address works), into one of
//      two stages: the next tile's copies fly while the block adds this
//      one.  Byte i of the tile lands at shared offset mis + i, mis = the
//      tile's address mod 16, so the 16-byte copies into shared memory are
//      aligned too.
//   2. thread_add: thread t takes the tile's vectors 4t .. 4t + 3, whose
//      4n bytes are n 32-bit words of the staged tile (read as aligned
//      words, shifted into place when mis is not a multiple of 4).  Bit 0
//      of a digit byte says it is nonzero and bit 1 that it is -1, so one
//      multiply gathers four bytes' bits into a nibble: the four vectors
//      become two 4n-bit masks (z: nonzero digits, s: their signs), vector
//      l's digit i at bit l * n + i.  The two-step rule with the rotated
//      lookahead and the end-around transfer (sd_digits.cuh's add, here on
//      lanes n bits wide) then adds all 4n digits with a few dozen bitwise
//      operations, and the sum is spread back into digit bytes by one
//      multiply a nibble, into the tile's output bytes in shared memory.
//      "plain" keeps each lane's transfer out of digit n - 1 as digit n.
//   3. stage_out: the output tile (n or n + 1 bytes a vector) goes back to
//      global memory with 16-byte stores, as in step 1.
// Vectors past the last one of a ragged tile are computed on stale shared
// bytes and never stored.
//
// Everything here is __host__ __device__ (plain inline under a host
// compiler): tests/test_torch_sd_add_host.py runs the schedule block by
// block and thread by thread, as csrc/sd_add.cu launches it, without a
// card.
#pragma once

#include <stdint.h>
#include <string.h>

#include <type_traits>

#ifdef __CUDACC__
#define SA_HD __host__ __device__ __forceinline__
#else
#define SA_HD inline
#endif

namespace sda {

constexpr int kMaxDigits = 16;
constexpr int kVecs = 4;                    // digit vectors a thread
constexpr int kThreads = 256;               // threads a block
constexpr int kTile = kVecs * kThreads;     // digit vectors a tile

// Shared bytes of one staged buffer of `width` bytes a vector: the tile,
// up to 15 bytes of misalignment before it and the word a thread reads
// past its span, rounded to 16.
SA_HD constexpr int buf_bytes(int width) { return kTile * width + 32; }

// Shared memory of a block: two stages of x and y (the next tile lands in
// one while the block adds the other), then the output tile.
SA_HD constexpr int smem_bytes(int n, bool plain) {
  return 4 * buf_bytes(n) + buf_bytes(plain ? n + 1 : n);
}

// Stage b's x and y buffers, and the output buffer.
SA_HD uint8_t* x_buf(uint8_t* smem, int n, int b) {
  return smem + 2 * b * buf_bytes(n);
}
SA_HD uint8_t* y_buf(uint8_t* smem, int n, int b) {
  return smem + (2 * b + 1) * buf_bytes(n);
}
SA_HD uint8_t* out_buf(uint8_t* smem, int n) {
  return smem + 4 * buf_bytes(n);
}

SA_HD long long num_tiles(long long B) { return (B + kTile - 1) / kTile; }

// Vectors in tile t (kTile but for a ragged last tile).
SA_HD int tile_count(long long t, long long B) {
  const long long left = B - t * kTile;
  return left < kTile ? (int)left : kTile;
}

SA_HD int misalign(const void* p) {
  return (int)(reinterpret_cast<uintptr_t>(p) & 15);
}

#ifndef __CUDA_ARCH__
// Host runs count the 16-byte copies whose addresses the card would fault
// on (the schedule must make none).
inline long long& host_misaligned_copies() {
  static long long n = 0;
  return n;
}
#endif

// An asynchronous 16-byte copy into shared memory (cp.async, bypassing
// L1); a thread's copies land by its next async_wait_prior() but one
// commit, and the block's by the barrier after that.
SA_HD void copy16_in(uint8_t* s, const uint8_t* g) {
#ifdef __CUDA_ARCH__
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
               "l"(g)
               : "memory");
#else
  if (misalign(s) | misalign(g)) ++host_misaligned_copies();
  memcpy(s, g, 16);
#endif
}

SA_HD void copy16_out(uint8_t* g, const uint8_t* s) {
#ifdef __CUDA_ARCH__
  __stcs(reinterpret_cast<uint4*>(g), *reinterpret_cast<const uint4*>(s));
#else
  if (misalign(s) | misalign(g)) ++host_misaligned_copies();
  memcpy(g, s, 16);
#endif
}

SA_HD void async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Wait for every committed group of this thread's copies but the latest.
SA_HD void async_wait_prior() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
#endif
}

// Chunks of a byte range [g, g + nbytes): `head` bytes before the first
// aligned 16-byte chunk, `chunks` whole chunks, then the tail.
struct Span {
  int mis;
  long long head, chunks, tail0;
};

SA_HD Span span_of(const void* g, long long nbytes) {
  Span sp;
  sp.mis = misalign(g);
  const long long lead = (16 - sp.mis) & 15;
  sp.head = nbytes < lead ? nbytes : lead;
  sp.chunks = (nbytes - sp.head) / 16;
  sp.tail0 = sp.head + 16 * sp.chunks;
  return sp;
}

// Thread tid's share of copying g[0, nbytes) to s[mis + i].
SA_HD void stage_in(const uint8_t* g, long long nbytes, uint8_t* s, int tid,
                    int nthreads) {
  const Span sp = span_of(g, nbytes);
  uint8_t* d = s + sp.mis;
  for (long long c = tid; c < sp.chunks; c += nthreads)
    copy16_in(d + sp.head + 16 * c, g + sp.head + 16 * c);
  for (long long i = tid; i < sp.head; i += nthreads) d[i] = g[i];
  for (long long i = sp.tail0 + tid; i < nbytes; i += nthreads) d[i] = g[i];
}

// Thread tid's share of copying s[mis + i] to g[0, nbytes).
SA_HD void stage_out(const uint8_t* s, uint8_t* g, long long nbytes, int tid,
                     int nthreads) {
  const Span sp = span_of(g, nbytes);
  const uint8_t* d = s + sp.mis;
  for (long long c = tid; c < sp.chunks; c += nthreads)
    copy16_out(g + sp.head + 16 * c, d + sp.head + 16 * c);
  for (long long i = tid; i < sp.head; i += nthreads) g[i] = d[i];
  for (long long i = sp.tail0 + tid; i < nbytes; i += nthreads) g[i] = d[i];
}

SA_HD uint32_t funnel(uint32_t lo, uint32_t hi, int sh) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(lo, hi, sh);
#else
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> sh);
#endif
}

// The W words of a thread's span, from shared byte offset b (4-aligned
// words, shifted into place when b is not).
template <int W>
SA_HD void load_span(const uint8_t* s, int b, uint32_t* w) {
  const uint32_t* p = reinterpret_cast<const uint32_t*>(s) + (b >> 2);
  const int sh = 8 * (b & 3);
  if (sh == 0) {
#pragma unroll
    for (int i = 0; i < W; ++i) w[i] = p[i];
  } else {
    uint32_t lo = p[0];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const uint32_t hi = p[i + 1];
      w[i] = funnel(lo, hi, sh);
      lo = hi;
    }
  }
}

template <int W>
SA_HD void store_span(uint8_t* s, int b, const uint32_t* w) {
  if ((b & 3) == 0) {
    uint32_t* p = reinterpret_cast<uint32_t*>(s + b);
#pragma unroll
    for (int i = 0; i < W; ++i) p[i] = w[i];
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) s[b + 4 * i + k] = (uint8_t)(w[i] >> (8 * k));
  }
}

// Bit 0 of each byte of w, as a nibble (byte k -> bit k).
SA_HD uint32_t gather4(uint32_t w) {
  return ((w & 0x01010101u) * 0x10204080u) >> 28;
}

// A nibble's bits back to bit 0 of four bytes (bit k -> byte k).
SA_HD uint32_t spread4(uint32_t nib) {
  return (nib * 0x00204081u) & 0x01010101u;
}

// Four digit vectors of N digits as masks of 4N bits.
template <int N>
using Mask = std::conditional_t<(4 * N <= 32), uint32_t, uint64_t>;

template <int N>
struct Lanes {
  using M = Mask<N>;
  static constexpr M kOne = 1;
  static constexpr M kLane0 = kOne | (kOne << N) | (kOne << (2 * N)) |
                              (kOne << (3 * N));
  static constexpr M kTop = kLane0 << (N - 1);
  static constexpr M kAll =
      4 * N == 8 * (int)sizeof(M) ? ~M(0) : (kOne << (4 * N)) - 1;
  static constexpr uint32_t kDigits = (1u << N) - 1;
};

template <int N>
struct Sum {
  Mask<N> z, s;    // the sum's digits
  Mask<N> tz, ts;  // each lane's transfer out of digit N - 1 (at bit N - 1)
};

// The two-step rule (sd_digits.cuh's add) on four lanes of N bits.
template <int N, int WS>
SA_HD Sum<N> add(Mask<N> xz, Mask<N> xs, Mask<N> yz, Mask<N> ys) {
  using L = Lanes<N>;
  const Mask<N> odd = xz ^ yz;
  const Mask<N> two = xz & yz & ~(xs ^ ys);
  const Mask<N> sp = (xz & xs) | (~xz & ys);
  const Mask<N> nz = odd | two;
  Mask<N> rn = ((nz & sp) << 1) & ~L::kLane0;
  if constexpr (WS == 1) rn |= (nz & sp & L::kTop) >> (N - 1);
  if constexpr (WS == -1) rn |= (nz & ~sp & L::kTop) >> (N - 1);
  const Mask<N> tz = two | (odd & ~(sp ^ rn));
  Mask<N> iz = (tz << 1) & ~L::kLane0, is = (sp << 1) & ~L::kLane0;
  if constexpr (WS != 0) iz |= (tz & L::kTop) >> (N - 1);
  if constexpr (WS == 1) is |= (sp & L::kTop) >> (N - 1);
  if constexpr (WS == -1) is |= (~sp & L::kTop) >> (N - 1);
  Sum<N> r;
  r.z = (odd ^ iz) & L::kAll;
  r.s = (odd & ~rn) | (~odd & is);
  r.tz = tz & L::kTop;
  r.ts = sp & L::kTop;
  return r;
}

// The N words of four vectors -> (z, s) masks.
template <int N>
SA_HD void pack(const uint32_t* w, Mask<N>& z, Mask<N>& s) {
  z = 0;
  s = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    z |= Mask<N>(gather4(w[j])) << (4 * j);
    s |= Mask<N>(gather4(w[j] >> 1)) << (4 * j);
  }
}

// Digit bytes of four (z, s) bits of one nibble each.
SA_HD uint32_t digit_bytes(uint32_t zn, uint32_t sn) {
  return spread4(zn) | spread4(zn & sn) * 0xFEu;
}

// A bit string of NB bits in 32-bit words; put() ors a piece of `width`
// bits in at `off` (compile-time offsets keep it in registers).
template <int NB>
struct Bits {
  uint32_t w[(NB + 31) / 32];

  SA_HD void put(int off, uint32_t piece, int width) {
    w[off >> 5] |= piece << (off & 31);
    if ((off & 31) + width > 32) w[(off >> 5) + 1] |= piece >> (32 - (off & 31));
  }
  SA_HD uint32_t nibble(int j) const { return (w[(4 * j) >> 5] >> ((4 * j) & 31)) & 15u; }
};

// The sum as output words: N words (4N digit bytes), or for "plain" N + 1
// words, each vector then N + 1 bytes, its transfer out as the last.
template <int N, bool PLAIN>
SA_HD void unpack(const Sum<N>& r, uint32_t* out) {
  const Mask<N> neg = r.z & r.s;
  if constexpr (!PLAIN) {
#pragma unroll
    for (int j = 0; j < N; ++j)
      out[j] = digit_bytes((uint32_t)(r.z >> (4 * j)) & 15u,
                           (uint32_t)(neg >> (4 * j)) & 15u);
  } else {
    using L = Lanes<N>;
    const Mask<N> tneg = r.tz & r.ts;
    Bits<4 * (N + 1)> z{}, s{};
#pragma unroll
    for (int l = 0; l < kVecs; ++l) {
      const int lo = l * N;
      z.put(l * (N + 1),
            ((uint32_t)(r.z >> lo) & L::kDigits) |
                ((uint32_t)(r.tz >> (lo + N - 1)) & 1u) << N,
            N + 1);
      s.put(l * (N + 1),
            ((uint32_t)(neg >> lo) & L::kDigits) |
                ((uint32_t)(tneg >> (lo + N - 1)) & 1u) << N,
            N + 1);
    }
#pragma unroll
    for (int j = 0; j < N + 1; ++j) out[j] = digit_bytes(z.nibble(j), s.nibble(j));
  }
}

// Thread tid's four vectors: staged x and y bytes (at shared offsets mis_x
// and mis_y for the tile's first byte) -> output bytes (at mis_o).
template <int N, int WS, bool PLAIN>
SA_HD void thread_add(const uint8_t* xs, const uint8_t* ys, uint8_t* os,
                      int tid, int mis_x, int mis_y, int mis_o) {
  constexpr int NO = PLAIN ? N + 1 : N;
  uint32_t xw[N], yw[N], ow[NO];
  load_span<N>(xs, mis_x + 4 * N * tid, xw);
  load_span<N>(ys, mis_y + 4 * N * tid, yw);
  Mask<N> xz, xsg, yz, ysg;
  pack<N>(xw, xz, xsg);
  pack<N>(yw, yz, ysg);
  unpack<N, PLAIN>(add<N, WS>(xz, xsg, yz, ysg), ow);
  store_span<NO>(os, mis_o + 4 * NO * tid, ow);
}

}  // namespace sda
