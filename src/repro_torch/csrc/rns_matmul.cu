// C-channel residue matmul with lazy reduction, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rns_matmul.py::rns_matmul_pallas.
// For each channel c: out[c] = center(A[c] @ B[c] mod m_c), with A (M, K)
// and B (K, N) int8 centered residues.  The K loop accumulates exact int32
// sums with no modular reduction (|acc| <= 128 * 128 * K < 2^31 for any
// int8 operands and K < 2^17); one truncating rem, canonicalize and center
// runs in the epilogue, bit for bit the reference's `lax.rem` ->
// `r < 0 ? r + m` -> `r > m / 2 ? r - m`.
//
// Bounds on the H100: at decode (M = 8) the weight planes are read once and
// nothing else matters, so the kernel is bound by device memory bytes (one
// qwen3-8b step: 22.7 GB of P21 planes, 6.8 ms at 3.35 TB/s); at prefill
// (M = 2048) by int8 tensor-core operations.  Two schedules, picked by M
// (rns_tiles.cuh holds their index maps, checked on the host):
//
// - decode, M <= 16 (rns_decode_kernel): the operands swap roles so the
//   weight columns fill the mma's 16-row side and the M activation rows its
//   8-column side.  Each warp streams 32-row steps of a 128-column strip
//   straight into registers with 16-byte loads, two steps (8 KB) in flight
//   before it computes (64 KB an SM), and transposes them in registers
//   into the A fragments of its eight tiles: the tiles' rows are assigned
//   to columns so that each lane's own bytes are its fragments.  The work
//   is cut stream-K: one block an SM (the ~170 registers a thread the
//   loads need), each an equal run of K steps across 128-column tile
//   boundaries, its 8 warps taking the steps of each tile segment in turn;
//   so no launch has a tail wave, and k/v at N 1024 and down at K 12288
//   fill the card too.  Partials of a tile cut between blocks are exact
//   int32 sums, so any order gives the same integers: a block reduces its
//   warps in shared memory (a bank-conflict-free layout, dec_acc), adds its
//   part into an int32 workspace (red.global.add), and the last block of a
//   tile (a counter that the same block resets) runs the epilogue and puts
//   the workspace back to zero.  One launch, no memset per call.  Measured
//   against a cp.async ring into shared memory (3-4 stages a warp), register
//   loads streamed faster at every decode shape (PERF.md §6).
// - prefill, M > 16 (rns_prefill_kernel): 128 x 256 tiles, 16 warps of
//   64 x 32, a 4-stage cp.async ring.  A rows (K contiguous) land with an
//   80-byte pitch and feed ldmatrix.x4; B rows land as they lie in memory
//   (N contiguous: the int8 mma wants B along K, and Hopper's wgmma
//   transposes only 16-bit operands) with their 16-byte chunks swizzled,
//   and each lane transposes its 4x4 byte blocks into the B fragments of
//   four n8 tiles.  The transpose runs on the stage the mma steps read, in
//   registers, while the next stages' copies are in flight.  Blocks are
//   rasterized M-tile-fastest in groups of 16 so running blocks share B
//   tiles in L2.  mma.sync (m16n8k32 s8) rather than wgmma: wgmma would
//   need B K-major in shared memory, i.e. a transposing shared-to-shared
//   pass per stage.  On the card, removing the B transposes or the mma
//   steps alone left the time unchanged and removing the copies saved
//   about a quarter: the loop waits on shared-memory reads and copies
//   more than on arithmetic (not separated further without a profiler).
//   The 128 x 256 tile (a quarter less L2 traffic an operation than 128 x
//   128) was the faster of those tried; 64 x 64 warps were slower.
//
// A stack of S products (S, C, M, K) x (S, C, K, N) runs as one launch over
// S x C folded channels (rns_tiles.cuh: a_base, b_base, mod_of): the
// plans see S x C channels and nothing else changes, so every slice is
// bit-identical to a launch of its own.
//
// Ragged M, N and K edges load zeros and skip stores.  Views whose base or
// strides are not 16-byte aligned (a K segment at an odd offset, N 65) take
// byte loads inside the same kernels.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rns_tiles.cuh"

namespace {

using rnt::Args;
using rnt::Row16;

// the moduli of one product (kMaxC bounds them, not the folded channels)
struct Moduli {
  int m[rnt::kMaxC];
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// One 16-byte copy into a stage: cp.async where the operand allows 16-byte
// copies, byte loads and a shared store elsewhere; bytes past an edge are
// zeros.
__device__ __forceinline__ void stage_copy(int8_t* st, const int8_t* base,
                                           const rnt::Copy& cp, bool vec) {
  int8_t* dst = st + cp.smem;
  if (cp.valid == 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  } else if (vec) {
    cp_async16(dst, base + cp.src, cp.valid);
  } else {
    const Row16 r = rnt::load16_bytes(base + cp.src, cp.valid);
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(r.w[0], r.w[1], r.w[2], r.w[3]);
  }
}

// ---- decode ----------------------------------------------------------------

// The warp's share of a tile segment (K steps [s0, s1) of the strip at n0,
// channel bases a, b) into acc: kDecUnroll steps' loads in flight, then
// their mma steps.
template <int MT>
__device__ __forceinline__ void dec_segment_mma(
    const Args& g, const int8_t* a, const int8_t* b, int n0, int s0, int s1,
    int warp, int lane, int (&acc)[MT][8][4]) {
  const int steps = rnt::dec_warp_steps(s0, s1, warp);
  for (int j = 0; j < steps; j += rnt::kDecUnroll) {
    // A step past the warp's last reads as zero rows (k0 = K: no loads), so
    // every index stays static and the buffers stay in registers.
    Row16 w[rnt::kDecUnroll][8];
    uint32_t x[rnt::kDecUnroll][MT][2];
#pragma unroll
    for (int u = 0; u < rnt::kDecUnroll; ++u) {
      const int k0 = j + u < steps
                         ? rnt::dec_step(s0, warp, j + u) * rnt::kStepK
                         : g.K;
      rnt::dec_load_w(g, b, k0, n0, lane, w[u]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        rnt::dec_load_x(g, a, k0, lane, mt, x[u][mt]);
    }
#pragma unroll
    for (int u = 0; u < rnt::kDecUnroll; ++u) {
#pragma unroll
      for (int word = 0; word < 4; ++word) {
        uint32_t lo[4], hi[4];
        rnt::dec_frag_w(w[u], word, lo, hi);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t af[4] = {lo[2 * h], lo[2 * h + 1], hi[2 * h],
                                  hi[2 * h + 1]};
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_s8(acc[mt][2 * word + h], af, x[u][mt][0], x[u][mt][1]);
        }
      }
    }
  }
}

// grid (plan.blocks); MT activation column blocks of 8 rows.
template <int MT>
__global__ void __launch_bounds__(rnt::kDecThreads, rnt::kDecBlocksPerSM)
rns_decode_kernel(Args g, Moduli mod, rnt::DecodePlan pl, int* counters,
                  int* partial) {
  constexpr int kRows = 8 * MT;
  __shared__ int s_acc[kRows * rnt::kAccPitch];
  __shared__ int s_last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int M = g.M, N = g.N;
  for (int i = tid; i < kRows * rnt::kAccPitch; i += rnt::kDecThreads)
    s_acc[i] = 0;

  const long long f1 = rnt::dec_run_end(pl, blockIdx.x);
  for (long long f = rnt::dec_run_begin(pl, blockIdx.x); f < f1;) {
    const rnt::Segment sg = rnt::dec_segment(pl, blockIdx.x, f);
    f += sg.s1 - sg.s0;
    const int c = rnt::dec_channel(pl, sg.t), m_c = mod.m[rnt::mod_of(g, c)];
    const int n0 = rnt::dec_strip(pl, sg.t);
    int acc[MT][8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mt][i][r] = 0;
    dec_segment_mma<MT>(g, rnt::a_base(g, c), rnt::b_base(g, c), n0, sg.s0,
                        sg.s1, warp, lane, acc);

    __syncthreads();  // s_acc is zero
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          atomicAdd(&s_acc[rnt::dec_acc(rnt::dec_out_m(lane, mt, r),
                                        rnt::dec_out_n(lane, i, r))],
                    acc[mt][i][r]);
    __syncthreads();

    // A whole tile is finished here; a cut one goes to the workspace and
    // its last block finishes it.  Each thread clears what it read.
    const long long base = (long long)c * M * N;
    const bool whole = rnt::tile_blocks(pl, sg.t) == 1;
    for (int i = tid; i < M * rnt::kStripN; i += rnt::kDecThreads) {
      const int m = i / rnt::kStripN, n = i % rnt::kStripN;
      const int v = s_acc[rnt::dec_acc(m, n)];
      s_acc[rnt::dec_acc(m, n)] = 0;
      if (n0 + n < N) {
        const long long o = base + (long long)m * N + n0 + n;
        if (whole)
          g.out[o] = rnt::center_rem(v, m_c);
        else
          atomicAdd(&partial[o], v);
      }
    }
    if (whole) continue;
    __threadfence();
    __syncthreads();
    if (tid == 0)
      s_last = atomicAdd(&counters[sg.t], 1) == rnt::tile_blocks(pl, sg.t) - 1;
    __syncthreads();
    if (!s_last) continue;
    __threadfence();
    for (int i = tid; i < M * rnt::kStripN; i += rnt::kDecThreads) {
      const int m = i / rnt::kStripN, n = n0 + i % rnt::kStripN;
      if (n < N) {
        const long long o = base + (long long)m * N + n;
        g.out[o] = rnt::center_rem(__ldcg(&partial[o]), m_c);
        partial[o] = 0;
      }
    }
    if (tid == 0) counters[sg.t] = 0;
  }
}

// ---- prefill ---------------------------------------------------------------

// grid (prefill_blocks), rasterized by pre_tile
__global__ void __launch_bounds__(rnt::kPreThreads)
rns_prefill_kernel(Args g, Moduli mod) {
  extern __shared__ __align__(128) int8_t smem[];
  const rnt::PreTile tile = rnt::pre_tile(g.M, g.N, blockIdx.x);
  const int c = tile.c, m0 = tile.m0, n0 = tile.n0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int8_t* a = rnt::a_base(g, c);
  const int8_t* b = rnt::b_base(g, c);
  const bool vec_a = g.a_vec == 16, vec_b = g.b_vec == 16;
  const int ktiles = rnt::ceil_div(g.K, rnt::kPreBK);

  auto issue = [&](int kt) {
    if (kt < ktiles) {
      int8_t* st = smem + (kt % rnt::kPreStages) * rnt::kStageBytes;
      const int k0 = kt * rnt::kPreBK;
#pragma unroll
      for (int q = 0; q < rnt::kCopiesA; ++q)
        stage_copy(st, a, rnt::pre_copy_a(g, m0, k0, tid, q), vec_a);
#pragma unroll
      for (int q = 0; q < rnt::kCopiesB; ++q)
        stage_copy(st, b, rnt::pre_copy_b(g, n0, k0, tid, q), vec_b);
    }
    cp_async_commit();
  };

  int acc[4][4 * rnt::kGroupsN][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * rnt::kGroupsN; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int s = 0; s < rnt::kPreStages - 1; ++s) issue(s);
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<rnt::kPreStages - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is free
    issue(kt + rnt::kPreStages - 1);
    const int8_t* st = smem + (kt % rnt::kPreStages) * rnt::kStageBytes;
#pragma unroll
    for (int kk = 0; kk < rnt::kPreBK / 32; ++kk) {
      uint32_t bf[rnt::kGroupsN][4][2];
#pragma unroll
      for (int grp = 0; grp < rnt::kGroupsN; ++grp)
        rnt::pre_frag_b(st + rnt::kStageA, warp, lane, kk, grp, bf[grp]);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        uint32_t af[4];
        ldsm_x4(af, st + rnt::pre_ldsm_a(warp, lane, mi, kk));
#pragma unroll
        for (int j = 0; j < 4 * rnt::kGroupsN; ++j)
          mma_s8(acc[mi][j], af, bf[j >> 2][j & 3][0], bf[j >> 2][j & 3][1]);
      }
    }
  }
  cp_async_wait<0>();

  // Epilogue: a lane holds 8 consecutive columns of each of its rows.
  const int m_c = mod.m[rnt::mod_of(g, c)];
  int32_t* o = g.out + (long long)c * g.M * g.N;
  const bool vec_o = g.N % 4 == 0;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int grp = 0; grp < rnt::kGroupsN; ++grp) {
      const int m = m0 + rnt::pre_out_m(warp, lane, mi, 2 * h);
      const int n = n0 + rnt::pre_out_n(warp, lane, 4 * grp, 2 * h);
      if (m >= g.M) continue;
      int v[8];
      rnt::pre_row_values(acc, mi, h, grp, m_c, v);
      int32_t* row = o + (long long)m * g.N;
      if (vec_o && n + 8 <= g.N) {
        *reinterpret_cast<int4*>(row + n) = make_int4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<int4*>(row + n + 4) =
            make_int4(v[4], v[5], v[6], v[7]);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (n + q < g.N) row[n + q] = v[q];
      }
    }
}

int sm_count() {
  static int cache[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < 64 && cache[dev] > 0) return cache[dev];
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (n <= 0) n = 1;
  if (dev >= 0 && dev < 64) cache[dev] = n;
  return n;
}

// The prefill's dynamic shared memory (above 48 KB), allowed once per device.
cudaError_t set_smem_limit() {
  static bool done[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < 64 && done[dev]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      rns_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      rnt::kPreSmem);
  if (e == cudaSuccess && dev >= 0 && dev < 64) done[dev] = true;
  return e;
}

}  // namespace

// Bytes of workspace rns_matmul_s8 needs for this shape (zeroed once by the
// caller, left zero by every launch); 0 when it needs none.  F: the folded
// channels, S x C.
extern "C" long long rns_matmul_workspace(int F, int M, int N, int K) {
  if (M > rnt::kDecodeMaxM) return 0;
  return rnt::decode_workspace_bytes(F, M, N,
                                     rnt::decode_plan(F, N, K, sm_count()));
}

// S stacked products of C channels: A (S, C, M, K) and B (S, C, K, N) views
// with strides (a_ss, a_sc, lda, 1) and (b_ss, b_sc, ldb, 1), out (S, C, M,
// N) contiguous.  S = 1 is one product.
extern "C" int rns_matmul_s8(const void* a, const void* b, void* out,
                             void* ws, long long ws_bytes,
                             const int* moduli, int S, int C, int M, int N,
                             int K, long long a_ss, long long a_sc,
                             long long lda, long long b_ss, long long b_sc,
                             long long ldb, void* stream) {
  if (S < 1 || C < 1 || C > rnt::kMaxC || M < 1 || N < 1 || K < 0 ||
      (long long)S * C > (1 << 20))
    return (int)cudaErrorInvalidValue;
  Moduli mod = {};
  for (int c = 0; c < C; ++c) mod.m[c] = moduli[c];
  Args g{(const int8_t*)a, (const int8_t*)b, (int32_t*)out, C, M, N, K,
         a_ss, a_sc, lda, b_ss, b_sc, ldb,
         rnt::vec_width(reinterpret_cast<uintptr_t>(a), a_ss, a_sc, lda),
         rnt::vec_width(reinterpret_cast<uintptr_t>(b), b_ss, b_sc, ldb)};
  const int F = S * C;
  cudaStream_t s = (cudaStream_t)stream;
  if (M <= rnt::kDecodeMaxM) {
    const rnt::DecodePlan pl = rnt::decode_plan(F, N, K, sm_count());
    const long long need = rnt::decode_workspace_bytes(F, M, N, pl);
    if (need > ws_bytes || (need > 0 && ws == nullptr))
      return (int)cudaErrorInvalidValue;
    int* counters = (int*)ws;
    int* partial = counters + (rnt::decode_counter_ints(F, pl) + 3) / 4 * 4;
    if (M <= 8)
      rns_decode_kernel<1><<<pl.blocks, rnt::kDecThreads, 0, s>>>(
          g, mod, pl, counters, partial);
    else
      rns_decode_kernel<2><<<pl.blocks, rnt::kDecThreads, 0, s>>>(
          g, mod, pl, counters, partial);
    return (int)cudaGetLastError();
  }
  const cudaError_t e = set_smem_limit();
  if (e != cudaSuccess) return (int)e;
  rns_prefill_kernel<<<rnt::prefill_blocks(F, M, N), rnt::kPreThreads,
                       rnt::kPreSmem, s>>>(g, mod);
  return (int)cudaGetLastError();
}
