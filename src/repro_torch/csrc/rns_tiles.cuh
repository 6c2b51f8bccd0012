// Index maps and integer steps of the residue matmul (kernel B1), shared by
// rns_matmul.cu and the host harness of tests/test_torch_rns_tiles_host.py.
//
// Two schedules compute out[c] = center(A[c] @ B[c] mod m_c) for int8
// centred residues A (C, M, K) (K contiguous) and B (C, K, N) (N
// contiguous), both as strided views.  A stack of S such products (the
// MoE expert einsums: A (S, C, M, K), B (S, C, K, N), out (S, C, M, N))
// runs as one launch of S x C folded channels: channel f is stack slice
// f / C and modulus f % C (a_base, b_base, mod_of), so both schedules
// index folded channels exactly as they index the channels of one
// product, and every slice equals a launch of its own bit for bit.
//
// - decode (M <= kDecodeMaxM): out^T = B^T A^T per channel on
//   mma.m16n8k32, the weight tile as the 16-row A operand and the
//   activations as the 8-column B operand.  A warp streams 32-row K steps
//   of a 128-column strip straight into registers, 16 bytes a load.  Lane
//   (g, t) (g = lane / 4, t = lane % 4) loads the 16 columns 16g..16g+15
//   of rows 4t..4t+3 and 16+4t..16+4t+3; a 4x4 byte transpose turns them
//   into the A fragments of eight mma tiles, tile i's row g standing for
//   column 16g + 2i and row g + 8 for 16g + 2i + 1, so no lane needs
//   another lane's bytes and nothing passes through shared memory.  The
//   work is cut stream-K (decode_plan): equal runs of K steps, one a
//   resident block, across tile boundaries; the partial sums of a cut tile
//   are exact int32 sums, combined in any order.
// - prefill (M > kDecodeMaxM): 128 x 256 output tiles, warps of 64 x
//   kWarpN outputs (2 along M),
//   a 4-stage cp.async ring of A (K-major rows, 80-byte pitch, read with
//   ldmatrix) and B (its N-contiguous rows as they lie, 16-byte chunks
//   XOR-swizzled).  B's fragments are transposed from the staged rows in
//   registers: lane (g, t) reads 4 bytes at columns 4g..4g+3 of four rows
//   and one 4x4 transpose gives the B fragments of four n8 tiles, tile j's
//   column g standing for column 4g + j of a group of 32 of the warp's.
//
// The mma fragment layouts are the PTX ISA's for m16n8k32 .s8 (row.col):
//   A: reg r, byte j of lane (g, t): row g + 8 (r & 1), k 4t + j + 16 (r >> 1)
//   B: reg r, byte j: k 4t + j + 16 r, column g
//   C: reg r: row g + 8 (r >> 1), column 2t + (r & 1)
//
// Everything here is __host__ __device__ (plain inline under a host
// compiler): the harness runs these maps lane by lane, block by block, and
// emulates the mma and ldmatrix from the layouts above.
#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define RT_HD __host__ __device__ __forceinline__
#else
#define RT_HD inline
#endif

namespace rnt {

constexpr int kMaxC = 8;

// ---- both schedules ------------------------------------------------------

struct Args {
  const int8_t* a;     // (S, C, M, K) view, K contiguous
  const int8_t* b;     // (S, C, K, N) view, N contiguous
  int32_t* out;        // (S, C, M, N) contiguous
  int C, M, N, K;      // C: the moduli; S x C folded channels in all
  long long a_ss, a_sc, lda, b_ss, b_sc, ldb;
  int a_vec, b_vec;    // 16, 4 or 1: the widest aligned load of each operand
};

struct Row16 {
  uint32_t w[4];
};

// The widest power-of-two load (16, 4 or 1 bytes) that every row of a view
// allows: base address and every stride divisible by it.
RT_HD int vec_width(uintptr_t base, long long ss, long long sc,
                    long long ld) {
  for (int v = 16; v > 1; v /= 4)
    if (base % v == 0 && ss % v == 0 && sc % v == 0 && ld % v == 0) return v;
  return 1;
}

// Folded channel f: stack slice f / C, modulus f % C; its operand bases.
RT_HD int mod_of(const Args& g, int f) { return f % g.C; }
RT_HD const int8_t* a_base(const Args& g, int f) {
  return g.a + (long long)(f / g.C) * g.a_ss + (long long)(f % g.C) * g.a_sc;
}
RT_HD const int8_t* b_base(const Args& g, int f) {
  return g.b + (long long)(f / g.C) * g.b_ss + (long long)(f % g.C) * g.b_sc;
}

RT_HD int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }
RT_HD int min_i(int a, int b) { return a < b ? a : b; }
RT_HD int max_i(int a, int b) { return a > b ? a : b; }

// One truncating rem (lax.rem), canonicalize, center: even moduli map m/2
// to +m/2.
RT_HD int center_rem(int v, int m) {
  int r = v % m;
  if (r < 0) r += m;
  if (r > m / 2) r -= m;
  return r;
}

RT_HD uint32_t byte_perm(uint32_t x, uint32_t y, uint32_t s) {
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

// Rows x0..x3 of a 4x4 byte block -> its columns: byte i of col[j] is byte
// j of x_i.
RT_HD void transpose4(uint32_t x0, uint32_t x1, uint32_t x2, uint32_t x3,
                      uint32_t (&col)[4]) {
  const uint32_t t0 = byte_perm(x0, x1, 0x5140);
  const uint32_t t1 = byte_perm(x2, x3, 0x5140);
  const uint32_t t2 = byte_perm(x0, x1, 0x7362);
  const uint32_t t3 = byte_perm(x2, x3, 0x7362);
  col[0] = byte_perm(t0, t1, 0x5410);
  col[1] = byte_perm(t0, t1, 0x7632);
  col[2] = byte_perm(t2, t3, 0x5410);
  col[3] = byte_perm(t2, t3, 0x7632);
}

// `n` (0..4) bytes at p as a little-endian word, zeros above.
RT_HD uint32_t load4_bytes(const int8_t* p, int n) {
  uint32_t w = 0;
  for (int i = 0; i < 4; ++i)
    if (i < n) w |= (uint32_t)(uint8_t)p[i] << (8 * i);
  return w;
}

// `n` (0..16) bytes at p, zeros above.
RT_HD Row16 load16_bytes(const int8_t* p, int n) {
  Row16 r;
  for (int q = 0; q < 4; ++q) r.w[q] = load4_bytes(p + 4 * q, n - 4 * q);
  return r;
}

// ---- decode schedule -----------------------------------------------------

constexpr int kDecodeMaxM = 16;    // two n8 columns of activations
constexpr int kDecWarps = 8;       // a block: 8 warps on one strip
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kStripN = 128;       // a tile's columns: 16 B x 8 lane groups
constexpr int kStepK = 32;         // K rows a step: one mma depth
constexpr int kDecUnroll = 2;      // steps a warp loads before it computes
constexpr int kDecBlocksPerSM = 1; // ~170 registers a thread: one an SM

// Stream-K: the work is C x ceil(N / kStripN) tiles (128 columns of one
// channel; C counts the folded channels of a stacked launch) of ksteps K steps each, taken in order (tile-major) as one
// sequence of total steps and cut into `blocks` runs that differ by at
// most one step (block b: [b T / B, (b + 1) T / B)), as many blocks as the
// card holds at once.  A block walks its run tile segment by tile segment,
// its warps taking the segment's steps in turn; a tile cut between blocks
// combines their partial sums (exact int32) in a workspace, and the last
// block to arrive finishes it.
struct DecodePlan {
  int tiles_n;       // tiles (strips of kStripN columns) a channel
  int ksteps;        // K steps of kStepK (at least 1)
  int blocks;        // the grid
  long long total;   // C x tiles_n x ksteps
};

RT_HD DecodePlan decode_plan(int C, int N, int K, int sms) {
  DecodePlan p;
  p.tiles_n = ceil_div(N, kStripN);
  p.ksteps = max_i(ceil_div(K, kStepK), 1);
  p.total = (long long)C * p.tiles_n * p.ksteps;
  long long b = (long long)kDecBlocksPerSM * (sms > 0 ? sms : 1);
  p.blocks = (int)(b < p.total ? b : p.total);
  return p;
}

// Block b's run of the step sequence, and the block whose run holds step x.
RT_HD long long dec_run_begin(const DecodePlan& p, int b) {
  return (long long)b * p.total / p.blocks;
}
RT_HD long long dec_run_end(const DecodePlan& p, int b) {
  return (long long)(b + 1) * p.total / p.blocks;
}
RT_HD int dec_block_of(const DecodePlan& p, long long x) {
  return (int)(((x + 1) * p.blocks - 1) / p.total);
}

// Blocks whose runs hold a part of tile t.
RT_HD int tile_blocks(const DecodePlan& p, int t) {
  const long long f0 = (long long)t * p.ksteps;
  return dec_block_of(p, f0 + p.ksteps - 1) - dec_block_of(p, f0) + 1;
}
// Whether any tile is cut between blocks: some run starts inside a tile.
RT_HD bool decode_cuts_tiles(const DecodePlan& p) {
  for (int b = 1; b < p.blocks; ++b)
    if (dec_run_begin(p, b) % p.ksteps != 0) return true;
  return false;
}

// Workspace of a decode launch: a counter per tile, then the (C, M, N)
// int32 partial sums; none when no tile is cut.  Both start at zero and
// the last block of each cut tile puts its part back to zero.
RT_HD long long decode_counter_ints(int C, const DecodePlan& p) {
  return decode_cuts_tiles(p) ? (long long)C * p.tiles_n : 0;
}
RT_HD long long decode_workspace_bytes(int C, int M, int N,
                                       const DecodePlan& p) {
  if (!decode_cuts_tiles(p)) return 0;
  const long long cnt = (decode_counter_ints(C, p) + 3) / 4 * 4;  // 16 B
  return 4 * (cnt + (long long)C * M * N);
}

// One tile segment of a block's run: tile t, K steps [s0, s1).
struct Segment {
  int t, s0, s1;
};
// The segment of block b's run that starts at step f of the sequence.
RT_HD Segment dec_segment(const DecodePlan& p, int b, long long f) {
  Segment sg;
  sg.t = (int)(f / p.ksteps);
  sg.s0 = (int)(f % p.ksteps);
  const long long left = dec_run_end(p, b) - f;
  sg.s1 = left < p.ksteps - sg.s0 ? sg.s0 + (int)left : p.ksteps;
  return sg;
}
// Tile t's channel and first column.
RT_HD int dec_channel(const DecodePlan& p, int t) { return t / p.tiles_n; }
RT_HD int dec_strip(const DecodePlan& p, int t) {
  return t % p.tiles_n * kStripN;
}

// The warps take a segment's steps in turn: warp w's j-th step, and how
// many it takes.
RT_HD int dec_warp_steps(int s0, int s1, int warp) {
  return s0 + warp < s1 ? ceil_div(s1 - s0 - warp, kDecWarps) : 0;
}
RT_HD int dec_step(int s0, int warp, int j) {
  return s0 + warp + kDecWarps * j;
}

// K offset, inside a step, of row word r (0..7) of a lane; its columns.
RT_HD int dec_row(int lane, int r) {
  return 16 * (r >> 2) + 4 * (lane & 3) + (r & 3);
}
RT_HD int dec_col(int lane) { return 16 * (lane >> 2); }

// 16 aligned bytes of a weight plane, read once: not kept in L1.
RT_HD Row16 load16_stream(const int8_t* p) {
  Row16 r;
#ifdef __CUDA_ARCH__
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.w[0]), "=r"(r.w[1]), "=r"(r.w[2]), "=r"(r.w[3])
      : "l"(p));
#else
  memcpy(&r, p, 16);
#endif
  return r;
}

RT_HD uint32_t load4(const int8_t* p) {
#ifdef __CUDA_ARCH__
  return __ldg(reinterpret_cast<const unsigned*>(p));
#else
  uint32_t w;
  memcpy(&w, p, 4);
  return w;
#endif
}

// The lane's weight rows of the step at k0 in strip n0 of channel base b:
// 8 rows x 16 columns, zeros past K and N.
RT_HD void dec_load_w(const Args& g, const int8_t* b, int k0, int n0,
                      int lane, Row16 (&w)[8]) {
  const int n = n0 + dec_col(lane);
  const bool full = g.b_vec == 16 && n + 16 <= g.N;
  if (full && k0 + kStepK <= g.K) {  // a whole step: no per-row checks
    const int8_t* p = b + (long long)(k0 + dec_row(lane, 0)) * g.ldb + n;
#pragma unroll
    for (int r = 0; r < 8; ++r)
      w[r] = load16_stream(p + (dec_row(0, r)) * g.ldb);
    return;
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int k = k0 + dec_row(lane, r);
    const int8_t* p = b + (long long)k * g.ldb + n;
    if (k >= g.K || n >= g.N)
      w[r] = Row16{{0u, 0u, 0u, 0u}};
    else if (full)
      w[r] = load16_stream(p);
    else
      w[r] = load16_bytes(p, g.N - n);
  }
}

// The B fragment (activations) of the step at k0, columns mt * 8..+7 of the
// mma (rows of A), from channel base a: activation row 8 mt + g, K 4t..
// and 16 + 4t..
RT_HD void dec_load_x(const Args& g, const int8_t* a, int k0, int lane,
                      int mt, uint32_t (&x)[2]) {
  const int m = 8 * mt + (lane >> 2);
  if (g.a_vec >= 4 && k0 + kStepK <= g.K) {  // a whole step
    const int8_t* p = a + (long long)m * g.lda + k0 + 4 * (lane & 3);
    x[0] = m < g.M ? load4(p) : 0u;
    x[1] = m < g.M ? load4(p + 16) : 0u;
    return;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = k0 + 16 * h + 4 * (lane & 3);
    const int8_t* p = a + (long long)m * g.lda + k;
    if (m >= g.M || k >= g.K)
      x[h] = 0u;
    else
      x[h] = g.a_vec >= 4 && k + 4 <= g.K ? load4(p) : load4_bytes(p, g.K - k);
  }
}

// The A fragments of mma tiles 2 word and 2 word + 1 from the lane's rows:
// tile 2 word + h takes {lo[2h], lo[2h + 1], hi[2h], hi[2h + 1]}.
RT_HD void dec_frag_w(const Row16 (&w)[8], int word, uint32_t (&lo)[4],
                      uint32_t (&hi)[4]) {
  transpose4(w[0].w[word], w[1].w[word], w[2].w[word], w[3].w[word], lo);
  transpose4(w[4].w[word], w[5].w[word], w[6].w[word], w[7].w[word], hi);
}

// Accumulator register r of mma tile i, activation column block mt: its
// output row m and its column inside the strip.
RT_HD int dec_out_m(int lane, int mt, int r) {
  return 8 * mt + 2 * (lane & 3) + (r & 1);
}
RT_HD int dec_out_n(int lane, int i, int r) {
  return 16 * (lane >> 2) + 2 * i + (r >> 1);
}

// The block's shared sum of its warps' partials: row m, column n of the
// strip at word dec_acc(m, n).  Rows 148 words apart and each 16-column
// group one word further, so the 32 lanes of one atomicAdd (8 column
// groups x 4 row pairs) hit 32 banks; at a 128-word pitch they hit 2.
constexpr int kAccPitch = 148;
RT_HD int dec_acc(int m, int n) { return m * kAccPitch + n + (n >> 4); }

// One 16-byte copy into a stage: its place in the stage, its source offset
// from the channel's base, and how many bytes of it lie inside the operand
// (the rest is zero).
struct Copy {
  int smem;
  long long src;
  int valid;
};

// ---- prefill schedule ----------------------------------------------------

constexpr int kPreBM = 128, kPreBN = 256, kPreBK = 64;
constexpr int kWarpN = 32;                     // a warp's 64 x kWarpN outputs
constexpr int kGroupsN = kWarpN / 32;          // 4 n8 tiles a group
constexpr int kWarpsN = kPreBN / kWarpN;
constexpr int kPreWarps = kPreBM / 64 * kWarpsN;
constexpr int kPreThreads = 32 * kPreWarps;
constexpr int kPreGroupM = 16;     // M tiles of a rasterization group
constexpr int kPreStages = 4;
constexpr int kRowA = kPreBK + 16;            // 80-byte A rows
constexpr int kStageA = kPreBM * kRowA;       // 10240 B
constexpr int kStageB = kPreBK * kPreBN;      // 16384 B: 64 rows of 256 B
constexpr int kStageBytes = kStageA + kStageB;
constexpr int kPreSmem = kPreStages * kStageBytes;

// The grid is one dimension (C folded channels, as the decode's):
// channel-major, then groups of kPreGroupM M
// tiles, inside a group M tiles fastest.  Blocks that run at once then
// share their B tiles (16 blocks each) and a group's A rows, and each B
// tile is read from device memory about once, not once per M tile (the
// blocks of one M tile would stream a channel's whole B plane, as large as
// the 50 MB L2, between two uses of a B tile).
RT_HD int prefill_blocks(int C, int M, int N) {
  return C * ceil_div(M, kPreBM) * ceil_div(N, kPreBN);
}
struct PreTile {
  int c, m0, n0;
};
RT_HD PreTile pre_tile(int M, int N, int bid) {
  const int tm = ceil_div(M, kPreBM), tn = ceil_div(N, kPreBN);
  const int c = bid / (tm * tn), r = bid % (tm * tn);
  const int group = r / (kPreGroupM * tn), first = group * kPreGroupM;
  const int size = min_i(tm - first, kPreGroupM);
  const int q = r - group * kPreGroupM * tn;
  return PreTile{c, (first + q % size) * kPreBM, q / size * kPreBN};
}

// 16-byte chunk ch of staged B row kr lies at chunk swz(kr, ch): the four
// rows 4t + r that lanes t = 0..3 read together fall in different banks.
RT_HD int swz(int kr, int ch) { return ch ^ (((kr >> 2) & 3) << 1); }

constexpr int kChunksA = kPreBK / 16;  // 16-byte chunks of an A row
constexpr int kChunksB = kPreBN / 16;  // of a B row
constexpr int kCopiesA = kPreBM * kChunksA / kPreThreads;  // a thread's
constexpr int kCopiesB = kPreBK * kChunksB / kPreThreads;

// Copy q (0..kCopiesA - 1) of thread tid: A rows m0.., K columns k0..
RT_HD Copy pre_copy_a(const Args& g, int m0, int k0, int tid, int q) {
  const int id = tid + kPreThreads * q, row = id / kChunksA,
            ch = id % kChunksA;
  const int m = m0 + row, k = k0 + 16 * ch;
  const int valid = m < g.M && k < g.K ? min_i(16, g.K - k) : 0;
  return Copy{row * kRowA + 16 * ch, (long long)m * g.lda + k, valid};
}

// Copy q (0..kCopiesB - 1) of thread tid: B rows k0.., columns n0..
RT_HD Copy pre_copy_b(const Args& g, int n0, int k0, int tid, int q) {
  const int id = tid + kPreThreads * q, kr = id / kChunksB,
            ch = id % kChunksB;
  const int k = k0 + kr, n = n0 + 16 * ch;
  const int valid = k < g.K && n < g.N ? min_i(16, g.N - n) : 0;
  return Copy{kStageA + kr * kPreBN + 16 * swz(kr, ch),
              (long long)k * g.ldb + n, valid};
}

// The shared address ldmatrix.x4 takes from lane `lane` for the A
// fragment of the warp's m16 tile mi at K sub-step kk (0..kPreBK / 32 - 1):
// matrices
// (rows 0-7, K 0-15), (8-15, 0-15), (0-7, 16-31), (8-15, 16-31).
RT_HD int pre_ldsm_a(int warp, int lane, int mi, int kk) {
  const int row = 64 * (warp / kWarpsN) + 16 * mi + (lane & 7) +
                  8 * ((lane >> 3) & 1);
  return row * kRowA + 32 * kk + 16 * (lane >> 4);
}

// Byte offset, in a stage's B part, of the 4 bytes lane `lane` reads for
// row r (0..3) of half h of K sub-step kk, column group grp of the warp:
// columns 4g..4g+3 of the group's 32, row 32 kk + 16 h + 4t + r.
RT_HD int pre_b_addr(int warp, int lane, int kk, int grp, int h, int r) {
  const int n = kWarpN * (warp % kWarpsN) + 32 * grp + 4 * (lane >> 2);
  const int kr = 32 * kk + 16 * h + 4 * (lane & 3) + r;
  return kr * kPreBN + 16 * swz(kr, n >> 4) + (n & 15);
}

// The B fragments of the four n8 tiles of column group grp at K sub-step
// kk, from the staged rows sb (the stage's B part).
RT_HD void pre_frag_b(const int8_t* sb, int warp, int lane, int kk, int grp,
                      uint32_t (&b)[4][2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t x[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      x[r] = *reinterpret_cast<const uint32_t*>(
          sb + pre_b_addr(warp, lane, kk, grp, h, r));
    uint32_t col[4];
    transpose4(x[0], x[1], x[2], x[3], col);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j][h] = col[j];
  }
}

// Accumulator register r of the warp's tile (mi, j) (j = 4 grp + n8 tile):
// its row and column in the block's tile.
RT_HD int pre_out_m(int warp, int lane, int mi, int r) {
  return 64 * (warp / kWarpsN) + 16 * mi + (lane >> 2) + 8 * (r >> 1);
}
RT_HD int pre_out_n(int warp, int lane, int j, int r) {
  return kWarpN * (warp % kWarpsN) + 32 * (j >> 2) + 8 * (lane & 3) +
         4 * (r & 1) + (j & 3);
}

// The lane's row of tile row block mi, half h (row pre_out_m(.., mi, 2h))
// holds, in column group grp, 8 consecutive columns pre_out_n(.., 4 grp,
// 2h) + q: q < 4 in tile 4 grp + q, register 2h; q >= 4 in tile 4 grp + q -
// 4, register 2h + 1.  Their residues:
RT_HD void pre_row_values(const int (&acc)[4][4 * kGroupsN][4], int mi,
                          int h, int grp, int m, int (&v)[8]) {
#pragma unroll
  for (int q = 0; q < 8; ++q)
    v[q] = center_rem(acc[mi][4 * grp + (q & 3)][2 * h + (q >> 2)], m);
}

}  // namespace rnt
