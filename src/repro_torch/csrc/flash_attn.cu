// Flash attention for Hopper (sm_90a): causal GQA prefill, and split-KV
// decode partials over bf16 or packed residue pages and over the dense
// contiguous cache.
//
// flash_attention_fwd replaces repro/kernels/flash_attn.py::
// flash_attention_pallas (body _attn_kernel).  One block per (q tile of 64
// rows, head h, batch row b); it walks the KV tiles of head h / g
// (GQA resolved in its own offsets, no repeated KV) up to min(T, kv_len[b])
// and, when causal, the tile's last query row.  Online softmax in f32:
// masked scores take -1e30, masked KV rows load as zeros, l sums the f32 p,
// p is rounded to v's dtype before the PV product, the output is
// acc / max(l, 1e-30).  Bound on the H100 at the serves' S = 256: the
// q/k/v/o bytes (0.0125 ms at qwen3's shape, against 0.0044 ms of bf16
// operations at the full tensor-core rate).
//  - bf16 (the full-width serves): FlashAttention-2 on the tensor cores,
//    mma.sync m16n8k16 bf16 -> f32.  4 warps of 16 query rows; Q is held
//    as A fragments in registers (ldmatrix), K and V stay bf16 in shared
//    memory in rows padded by 16 bytes (ldmatrix / ldmatrix.trans free of
//    bank conflicts), loaded by 16-byte cp.async, double-buffered so that
//    KV tile t + 1 loads while tile t computes.  S's accumulator fragments
//    become PV's A operand in registers (rounded to bf16); the row max and
//    sum reduce over the quad of lanes that shares a row; masked scores
//    take -inf (the reference's -1e30 gives the same max, and p = 0), and
//    tiles that are valid for all of a warp's rows skip the mask.  Q is
//    staged in K's second stage, so 68 KB of shared memory and 168
//    registers at hd 128 let three blocks share an SM; the q tile is the
//    slowest grid index, last first.  head_dim a multiple of 16, <= 128.
//    The kernel is templated on q/k's width DK and v's width DV: latent
//    attention (MLA) runs q and k of 192 (128 + 64 rotary) against v of
//    128, so V is neither padded to 192 nor its PV product widened.  At
//    (192, 128) K and V take 84 KB of shared memory a block, so two blocks
//    share an SM (launch bound 2, registers to 255); instances with DK ==
//    DV compile to the code of the single-width kernel.
//    On the H100 it issues mma.sync at about 200 TFLOP/s at hd 128, half
//    of SDPA's rate: 12 warps an SM leave the softmax unhidden behind the
//    MMAs, and each K/V fragment read from shared memory feeds one 16-row
//    tile.  Larger warp tiles and wgmma with TMA and warp specialisation
//    (softmax of one tile under the MMAs of the next) are the levers.
//  - f32 (the reduced configs, held at the reference's 2e-5): CUDA cores
//    from shared memory, K rows padded by one float so lane-parallel dot
//    products are conflict-free.  No bf16 call reaches this body.
//
// paged_decode_fwd replaces flash_paged_decode_pallas in its bf16 and
// packed modes (body _paged_decode_kernel, unpack _unpack_crt) and, with
// witness lanes, in its syndrome mode (red_moduli).  One block per (page
// slot j, head h, batch row b): the block reads tab[b, j] itself, masks
// rows at or past kv_len[b], and writes the same (o, m, l) partials as the
// reference, so merge_decode_partials is reused unchanged.  Packed pages
// are read as uint8; each byte holds vpb lanes of two two's-complement
// fields, sign-extended and CRT-folded against the power-of-two modulus
// with a truncating rem, then scaled per (row, head) in f32.  Pages are
// addressed through the row stride of the pool itself, so lane 0 of an
// rns8r pool (P, ps, 1 + r, Kv, hd) is read in place, with no copy.  In
// the syndrome mode the GQA lead head (h % g == 0) of each KV head also
// reads the r witness lanes of every valid K and V element it decodes and
// counts the elements whose floored ((w - x mod m) mod m) is nonzero for
// some witness modulus m; the count of (b, h, j) goes to syn, 0 on the
// other heads, so syn summed over heads and pages counts each element
// once.  Bound on the H100: the KV page bytes of the valid rows (witness
// lanes included in the syndrome mode).
//
// flash_decode_fwd replaces flash_decode_pallas (body _decode_kernel): the
// same split-KV partials over the dense (B, T, Kv, hd) cache, one block per
// (chunk of bk rows, head h, batch row b).  Its chunk body is the paged
// decode's (decode_chunk), addressed at row b * T + j * bk instead of a
// page, so a dense decode with bk equal to the page size gives the paged
// decode's partials bit for bit.  Rows at or past kv_len[b] are never read
// (the reference zeroes and masks them with -1e30; neither reaches its
// partial), an all-masked chunk writes o = 0, m = -1e30, l = 0, and p is
// rounded to the cache dtype before the PV product.  Bound on the H100: the
// K and V bytes of the valid rows.
//
// decode_chunk is row-parallel: a group of hd / 8 lanes (rounded up to a
// power of two) takes one KV row, each lane 8 values of it by one vector
// load (16 or 32 bytes of f32 / bf16, 8 / vpb bytes of a packed row), so a
// warp covers 32 * 8 / hd rows at once and keeps PD_UNROLL such passes in
// flight before its shuffle reductions; the first passes' V rows load
// beside their K rows.  All warps then take the chunk's max and sum
// through shared memory (p against the chunk's max, as the reference), and
// PV splits the rows across the warps the same way: each lane accumulates
// its 8 dims over its fixed slice of rows, the lane groups and then the
// warps' partial o sum in a fixed order.  No float atomics: the partials
// are bit-for-bit repeatable.  4 or 8 warps a block (decode_warps).
// head_dim a multiple of 8, <= 128.
//
// Every entry point runs on the given stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_BIG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// x rounded to bf16 (nearest even) and back: the reference casts p to v's
// dtype before PV.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// Prefill, f32: CUDA cores.
// ---------------------------------------------------------------------------

constexpr int FA_BQ = 64;
constexpr int FA_BK = 64;
constexpr int FA_WARPS = 8;
constexpr int FA_ROWS = FA_BQ / FA_WARPS;  // query rows per warp
constexpr int FA_MAXD = 128;               // head_dim <= 128
constexpr int FA_DPL = FA_MAXD / 32;       // output dims per lane

size_t fa_smem_bytes(int hd) {
  return sizeof(float) * ((size_t)FA_BQ * hd + (size_t)FA_BK * (hd + 1) +
                          (size_t)FA_BK * hd + (size_t)FA_BQ * FA_BK);
}

__global__ void __launch_bounds__(FA_WARPS * 32)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const int* __restrict__ kv_len,
                           float* __restrict__ out, int Sq, int T_, int H,
                           int Kv, int hd, int causal, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                      // [BQ][hd]
  float* Ks = Qs + FA_BQ * hd;           // [BK][hd + 1]
  float* Vs = Ks + FA_BK * (hd + 1);     // [BK][hd]
  float* Ps = Vs + FA_BK * hd;           // [BQ][BK]

  const int q0 = blockIdx.x * FA_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / Kv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int nthr = FA_WARPS * 32;

  const int kvv = min(T_, kv_len[b]);
  int kend = kvv;
  if (causal) kend = min(kend, q0 + FA_BQ);

  for (int idx = tid; idx < FA_BQ * hd; idx += nthr) {
    int r = idx / hd, d = idx - r * hd;
    int qi = q0 + r;
    Qs[idx] = qi < Sq ? q[(((long long)b * Sq + qi) * H + h) * hd + d] : 0.f;
  }

  float m_r[FA_ROWS], l_r[FA_ROWS], acc[FA_ROWS][FA_DPL];
#pragma unroll
  for (int r = 0; r < FA_ROWS; ++r) {
    m_r[r] = NEG_BIG;
    l_r[r] = 0.f;
#pragma unroll
    for (int i = 0; i < FA_DPL; ++i) acc[r][i] = 0.f;
  }

  for (int k0 = 0; k0 < kend; k0 += FA_BK) {
    __syncthreads();  // previous tile fully consumed (and Qs written)
    for (int idx = tid; idx < FA_BK * hd; idx += nthr) {
      int j = idx / hd, d = idx - j * hd;
      int t = k0 + j;
      long long off = (((long long)b * T_ + t) * Kv + kh) * hd + d;
      bool ok = t < kvv;
      Ks[j * (hd + 1) + d] = ok ? k[off] : 0.f;
      Vs[j * hd + d] = ok ? v[off] : 0.f;
    }
    __syncthreads();

    // scores for this warp's rows against keys lane and lane + 32
    float s[FA_ROWS][2];
#pragma unroll
    for (int r = 0; r < FA_ROWS; ++r) s[r][0] = s[r][1] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float ka = Ks[lane * (hd + 1) + d];
      float kb = Ks[(lane + 32) * (hd + 1) + d];
#pragma unroll
      for (int r = 0; r < FA_ROWS; ++r) {
        float qv = Qs[(warp * FA_ROWS + r) * hd + d];
        s[r][0] = fmaf(qv, ka, s[r][0]);
        s[r][1] = fmaf(qv, kb, s[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < FA_ROWS; ++r) {
      int row = warp * FA_ROWS + r;
      int qi = q0 + row;
      int ta = k0 + lane, tb = k0 + lane + 32;
      bool va = ta < kvv && (!causal || ta <= qi);
      bool vb = tb < kvv && (!causal || tb <= qi);
      float sa = s[r][0] * scale, sb = s[r][1] * scale;
      float tmax = warp_max(fmaxf(va ? sa : NEG_BIG, vb ? sb : NEG_BIG));
      float m_new = fmaxf(m_r[r], tmax);
      float alpha = expf(m_r[r] - m_new);
      float pa = va ? expf(sa - m_new) : 0.f;
      float pb = vb ? expf(sb - m_new) : 0.f;
      l_r[r] = l_r[r] * alpha + warp_sum(pa + pb);
      m_r[r] = m_new;
      Ps[row * FA_BK + lane] = pa;
      Ps[row * FA_BK + lane + 32] = pb;
#pragma unroll
      for (int i = 0; i < FA_DPL; ++i) acc[r][i] *= alpha;
    }
    __syncwarp();
    for (int j = 0; j < FA_BK; ++j) {
      float vv[FA_DPL];
#pragma unroll
      for (int i = 0; i < FA_DPL; ++i) {
        int d = lane + 32 * i;
        vv[i] = d < hd ? Vs[j * hd + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < FA_ROWS; ++r) {
        float p = Ps[(warp * FA_ROWS + r) * FA_BK + j];
#pragma unroll
        for (int i = 0; i < FA_DPL; ++i) acc[r][i] = fmaf(p, vv[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < FA_ROWS; ++r) {
    int qi = q0 + warp * FA_ROWS + r;
    if (qi >= Sq) continue;
    float inv = 1.f / fmaxf(l_r[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < FA_DPL; ++i) {
      int d = lane + 32 * i;
      if (d < hd) out[(((long long)b * Sq + qi) * H + h) * hd + d] =
          acc[r][i] * inv;
    }
  }
}

int launch_flash_f32(const void* q, const void* k, const void* v,
                     const int* kv_len, void* o, int B, int Sq, int T_, int H,
                     int Kv, int hd, int causal, float scale,
                     cudaStream_t stream) {
  size_t smem = fa_smem_bytes(hd);
  cudaFuncSetAttribute(flash_attention_f32_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((Sq + FA_BQ - 1) / FA_BQ, H, B);
  flash_attention_f32_kernel<<<grid, FA_WARPS * 32, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, kv_len, (float*)o,
      Sq, T_, H, Kv, hd, causal, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Prefill, bf16: tensor cores (mma.sync m16n8k16), cp.async double buffer.
// ---------------------------------------------------------------------------

constexpr int TC_BQ = 64;   // query rows a block
constexpr int TC_BK = 64;   // KV rows a tile
constexpr int TC_WARPS = TC_BQ / 16;
constexpr int TC_THREADS = TC_WARPS * 32;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes from global to shared; with ok false nothing is read and the 16
// bytes are zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// Two f32 as bf16x2 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment layouts (PTX ISA, mma.m16n8k16): a thread with lane = 4 * g + c
// holds accumulator rows g and g + 8 at columns 2c and 2c + 1 of each n8
// block; the A operand holds the same rows at k 2c, 2c + 1 (regs 0, 1) and
// 2c + 8, 2c + 9 (regs 2, 3).  So two n8 blocks of S are one k16 A operand
// of PV, with no trip through shared memory.
// The register budget is set for three blocks an SM at equal widths, two
// where K and V rows differ (shared memory admits no more at 192 / 128).
template <int DK, int DV>
__global__ void __launch_bounds__(TC_THREADS, (DK == DV ? 3 : 2))
flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const int* __restrict__ kv_len,
                            __nv_bfloat16* __restrict__ out, int Sq, int T_,
                            int H, int Kv, int causal, float scale) {
  constexpr int LD = DK + 8;    // padded q / k row: 16 bytes of skew a row
  constexpr int LDV = DV + 8;   // padded v row
  constexpr int CH = DK / 8;    // 16-byte chunks a q / k row
  constexpr int CHV = DV / 8;   // 16-byte chunks a v row
  constexpr int NKD = DK / 16;  // k16 steps of QK^T over the head dim
  constexpr int NO = DV / 8;    // n8 blocks of the output
  constexpr int NS = TC_BK / 8; // n8 blocks of a score tile
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(tc_smem);  // [2][BK][LD]
  __nv_bfloat16* Vs = Ks + 2 * TC_BK * LD;                        // [2][BK][LDV]
  __nv_bfloat16* Qs = Ks + TC_BK * LD;  // [BQ][LD], staged in K's stage 1

  // the q tile is the slowest grid index, last tile first: under causal the
  // tiles that walk the most KV tiles start first
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * TC_BQ;
  const int kh = h / (H / Kv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kvv = min(T_, kv_len[b]);
  const int kend = causal ? min(kvv, q0 + TC_BQ) : kvv;
  const int n_t = kend > 0 ? (kend + TC_BK - 1) / TC_BK : 0;

  for (int i = tid; i < TC_BQ * CH; i += TC_THREADS) {
    const int r = i / CH, c = i - r * CH;
    const int qi = q0 + r;
    const bool ok = qi < Sq;
    const __nv_bfloat16* src =
        q + (((long long)b * Sq + (ok ? qi : 0)) * H + h) * DK + c * 8;
    cp_async16(smem_addr(Qs + r * LD + c * 8), src, ok);
  }
  auto load_kv = [&](int t, int st) {
    const int k0 = t * TC_BK;
    for (int i = tid; i < TC_BK * CH; i += TC_THREADS) {
      const int r = i / CH, c = i - r * CH;
      const int tt = k0 + r;
      const bool ok = tt < kvv;  // rows past kv_len load as zeros
      const long long row = ((long long)b * T_ + (ok ? tt : 0)) * Kv + kh;
      const int so = (st * TC_BK + r) * LD + c * 8;
      cp_async16(smem_addr(Ks + so), k + row * DK + c * 8, ok);
      if constexpr (DK == DV)
        cp_async16(smem_addr(Vs + so), v + row * DV + c * 8, ok);
    }
    if constexpr (DK != DV) {
      for (int i = tid; i < TC_BK * CHV; i += TC_THREADS) {
        const int r = i / CHV, c = i - r * CHV;
        const int tt = k0 + r;
        const bool ok = tt < kvv;
        const long long row = ((long long)b * T_ + (ok ? tt : 0)) * Kv + kh;
        cp_async16(smem_addr(Vs + (st * TC_BK + r) * LDV + c * 8),
                   v + row * DV + c * 8, ok);
      }
    }
  };
  if (n_t > 0) load_kv(0, 0);
  cp_async_commit();  // Q and KV tile 0
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[NKD][4];  // Q as A fragments, held for the whole KV walk
#pragma unroll
  for (int kk = 0; kk < NKD; ++kk)
    ldsm_x4(smem_addr(Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                      (lane >> 4) * 8),
            qf[kk]);
  __syncthreads();  // K's stage 1 is free for tile 1

  // rows lane / 4 and lane / 4 + 8 of this warp's 16
  const int qa = q0 + warp * 16 + (lane >> 2), qb = qa + 8;
  const int c2 = (lane & 3) * 2;  // this lane's first column of an n8 block
  float m_r[2] = {NEG_BIG, NEG_BIG}, l_r[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int t = 0; t < n_t; ++t) {
    if (t + 1 < n_t) load_kv(t + 1, (t + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the tile just issued has landed
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + (t & 1) * TC_BK * LD;
    const __nv_bfloat16* Vt = Vs + (t & 1) * TC_BK * LDV;

    // S = Q K^T: 16 x 64 a warp, f32 accumulators
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NKD; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < NS / 2; ++n2) {
        uint32_t bf[4];  // keys 16 n2 .. + 15, dims 16 kk .. + 15
        ldsm_x4(smem_addr(Kt + (n2 * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                   LD + kk * 16 + ((lane >> 3) & 1) * 8),
                bf);
        mma_bf16(s[2 * n2], qf[kk], bf[0], bf[1]);
        mma_bf16(s[2 * n2 + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // online softmax over the tile: the four lanes of a quad share a row.
    // Masked scores take -inf: the tile max is then the reference's (which
    // masks with -1e30, and m starts at -1e30) and exp gives p = 0 exactly.
    // Tiles whose keys are all valid for all of this warp's rows skip the
    // mask.
    const int k0 = t * TC_BK;
    const bool full = k0 + TC_BK <= kvv &&
                      (!causal || k0 + TC_BK - 1 <= q0 + warp * 16);
    float tmax[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!full) {
          const int key = k0 + n * 8 + c2 + (e & 1);
          if (key >= kvv || (causal && key > (e < 2 ? qa : qb)))
            s[n][e] = __int_as_float(0xff800000);  // -inf
        }
        tmax[e >> 1] = fmaxf(tmax[e >> 1], s[n][e]);
      }
    }
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
      const float m_new = fmaxf(m_r[i], tmax[i] * scale);
      alpha[i] = __expf(m_r[i] - m_new);
      m_r[i] = m_new;
    }
    uint32_t pf[NS / 2][4];  // p in bf16: the A operand of PV
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = __expf(fmaf(s[n][e], scale, -m_r[e >> 1]));
        rsum[e >> 1] += p[e];
      }
      pf[n >> 1][(n & 1) * 2] = pack_bf16(p[0], p[1]);
      pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 1);
      rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 2);
      l_r[i] = l_r[i] * alpha[i] + rsum[i];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += P V, V through ldmatrix.trans
#pragma unroll
    for (int kc = 0; kc < TC_BK / 16; ++kc) {
#pragma unroll
      for (int n2 = 0; n2 < NO / 2; ++n2) {
        uint32_t bf[4];  // keys 16 kc .. + 15, dims 16 n2 .. + 15
        ldsm_x4_trans(smem_addr(Vt + (kc * 16 + (lane & 7) +
                                      ((lane >> 3) & 1) * 8) * LDV +
                                n2 * 16 + (lane >> 4) * 8),
                      bf);
        mma_bf16(acc[2 * n2], pf[kc], bf[0], bf[1]);
        mma_bf16(acc[2 * n2 + 1], pf[kc], bf[2], bf[3]);
      }
    }
    __syncthreads();  // stage t & 1 consumed before tile t + 2 refills it
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = i ? qb : qa;
    if (qi >= Sq) continue;
    const float den = fmaxf(l_r[i], 1e-30f);
    __nv_bfloat16* dst = out + (((long long)b * Sq + qi) * H + h) * DV + c2;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          pack_bf16(acc[n][2 * i] / den, acc[n][2 * i + 1] / den);
  }
}

template <int DK, int DV>
int launch_flash_bf16(const void* q, const void* k, const void* v,
                      const int* kv_len, void* o, int B, int Sq, int T_,
                      int H, int Kv, int causal, float scale,
                      cudaStream_t stream) {
  const size_t smem =
      sizeof(__nv_bfloat16) * (size_t)2 * TC_BK * ((DK + 8) + (DV + 8));
  cudaFuncSetAttribute(flash_attention_bf16_kernel<DK, DV>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid(H, B, (Sq + TC_BQ - 1) / TC_BQ);
  flash_attention_bf16_kernel<DK, DV><<<grid, TC_THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, kv_len, (__nv_bfloat16*)o, Sq, T_, H, Kv,
      causal, scale);
  return (int)cudaGetLastError();
}

// (q / k width, v width) pairs beyond the equal ones: _BF16_SPLIT in
// kernels/flash_attn.py
int dispatch_flash_bf16(const void* q, const void* k, const void* v,
                        const int* kv_len, void* o, int B, int Sq, int T_,
                        int H, int Kv, int hd, int hdv, int causal,
                        float scale, cudaStream_t s) {
  if (hd == 192 && hdv == 128)
    return launch_flash_bf16<192, 128>(q, k, v, kv_len, o, B, Sq, T_, H, Kv,
                                       causal, scale, s);
  if (hd != hdv) return (int)cudaErrorInvalidValue;
#define FA_BF16_CASE(D)                                                   \
  case D:                                                                 \
    return launch_flash_bf16<D, D>(q, k, v, kv_len, o, B, Sq, T_, H, Kv,  \
                                   causal, scale, s);
  switch (hd) {
    FA_BF16_CASE(16)
    FA_BF16_CASE(32)
    FA_BF16_CASE(48)
    FA_BF16_CASE(64)
    FA_BF16_CASE(80)
    FA_BF16_CASE(96)
    FA_BF16_CASE(112)
    FA_BF16_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FA_BF16_CASE
}

// ---------------------------------------------------------------------------
// Split-KV decode partials (paged and dense): one chunk body.
// ---------------------------------------------------------------------------

constexpr int PD_MAXW = 8;    // warps a decode block, at most
constexpr int PD_NV = 8;      // values of a row a lane loads at once
constexpr int PD_UNROLL = 4;  // passes of rows a warp keeps in flight
constexpr int PD_MAXD = 128;  // head_dim <= 128 (16 lanes of 8 values)

enum KvMode { KV_F32 = 0, KV_BF16 = 1, KV_PACKED = 2 };

constexpr int PD_MAXR = 4;  // witness lanes the syndrome mode takes

struct Packed {
  int m0, m1, inv, b0, b1, vpb;
};

struct Witness {
  int r;                  // number of witness lanes (0: no syndrome)
  int m[PD_MAXR];         // their moduli
  long long lane_stride;  // elements between consecutive lanes
};

// The 8 values of one lane as they sit in memory: 32 bytes of f32, 16 of
// bf16 (a), or 8 / vpb bytes of packed lanes (the low bytes of a.x, a.y).
struct RawVec {
  uint4 a, b;
};

// The integer of one packed lane (b0 + b1 bits): both two's-complement
// fields sign-extended, CRT-folded against the power-of-two modulus m1.
__device__ __forceinline__ int unpack_crt(uint32_t lane, const Packed& pk) {
  const int f0 = lane & ((1u << pk.b0) - 1);
  const int f1 = (lane >> pk.b0) & ((1u << pk.b1) - 1);
  const int r0 = f0 - ((f0 >> (pk.b0 - 1)) << pk.b0);
  const int r1 = f1 - ((f1 >> (pk.b1 - 1)) << pk.b1);
  int t = ((r0 - r1) * pk.inv) % pk.m0;  // truncating, like lax.rem
  if (t < 0) t += pk.m0;
  if (t > (pk.m0 - 1) / 2) t -= pk.m0;
  return r1 + pk.m1 * t;
}

// Lane group gi's 8 values of the row starting at element (packed: byte)
// `off`, by one vector load (two for f32).  off and the pages are aligned
// to the load (checked by the wrapper).
template <int MODE>
__device__ __forceinline__ void load_vec(const void* pages, long long off,
                                         int gi, const Packed& pk,
                                         RawVec& r) {
  if (MODE == KV_F32) {
    const uint4* p =
        reinterpret_cast<const uint4*>((const float*)pages + off + gi * 8);
    r.a = p[0];
    r.b = p[1];
  } else if (MODE == KV_BF16) {
    r.a = *reinterpret_cast<const uint4*>((const __nv_bfloat16*)pages + off +
                                          gi * 8);
  } else {
    const uint8_t* p = (const uint8_t*)pages + off + gi * (8 / pk.vpb);
    r.a.y = 0;
    switch (pk.vpb) {
      case 1: {
        const uint2 w = *reinterpret_cast<const uint2*>(p);
        r.a.x = w.x;
        r.a.y = w.y;
        break;
      }
      case 2:
        r.a.x = *reinterpret_cast<const uint32_t*>(p);
        break;
      case 4:
        r.a.x = *reinterpret_cast<const uint16_t*>(p);
        break;
      default:
        r.a.x = *p;
    }
  }
}

// The 8 values as f32 (packed: the integers xi, and xi * scale).
template <int MODE>
__device__ __forceinline__ void decode_vec(const RawVec& r, const Packed& pk,
                                           float scale, float (&x)[PD_NV],
                                           int (&xi)[PD_NV]) {
  if (MODE == KV_F32) {
    const uint32_t w[8] = {r.a.x, r.a.y, r.a.z, r.a.w,
                           r.b.x, r.b.y, r.b.z, r.b.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = __uint_as_float(w[i]);
  } else if (MODE == KV_BF16) {
    const uint32_t w[4] = {r.a.x, r.a.y, r.a.z, r.a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
    // value i sits at bit i * w of the little-endian bytes
    const unsigned long long bits =
        ((unsigned long long)r.a.y << 32) | r.a.x;
    const int w = pk.b0 + pk.b1;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      xi[i] = unpack_crt((uint32_t)(bits >> (i * w)) & ((1u << w) - 1), pk);
      x[i] = (float)xi[i] * scale;
    }
  }
}

// Values of the 8 elements at `off + gi * 8` whose witness residues
// disagree with xi: the reference's floored ((w - x mod m) mod m) != 0.
// x mod m is taken floored, ((x % m) + m) % m, as jnp.remainder does; then
// with xm in [0, m) and the stored byte w >= 0 the outer test equals
// w % m != xm, which saves two of the four runtime divisions.  One value a
// byte (vpb 1), 8 bytes a lane and witness lane.
__device__ __forceinline__ int witness_bad(const int (&xi)[PD_NV],
                                           const uint8_t* wit, long long off,
                                           int gi, const Witness& wt) {
  int bad[PD_NV];
#pragma unroll
  for (int i = 0; i < PD_NV; ++i) bad[i] = 0;
#pragma unroll
  for (int jw = 0; jw < PD_MAXR; ++jw) {  // unrolled: wt.m stays in registers
    if (jw < wt.r) {
      const int m = wt.m[jw];
      const uint2 ww = *reinterpret_cast<const uint2*>(
          wit + off + jw * wt.lane_stride + gi * 8);
      const unsigned long long bits = ((unsigned long long)ww.y << 32) | ww.x;
#pragma unroll
      for (int i = 0; i < PD_NV; ++i) {
        const int w = (int)((bits >> (8 * i)) & 0xff);
        bad[i] |= w % m != ((xi[i] % m) + m) % m;
      }
    }
  }
  int n = 0;
#pragma unroll
  for (int i = 0; i < PD_NV; ++i) n += bad[i];
  return n;
}

// Where one split-KV chunk of one (b, h) reads and writes: `nvalid` KV
// rows starting at row `row0` of the K/V tensors (rows `row_stride`
// elements apart), output column `j` of n_chunks.
struct Chunk {
  long long bh, row0, row_stride;
  int j, n_chunks, nvalid, hd, Kv, kh;
  bool lead;
  float scale;
};

// The block's shared scratch beside the dynamic rows of scores.
struct DecodeShared {
  float red[2 * PD_MAXW];  // per-warp max, then per-warp sum
  int bad[PD_MAXW];        // per-warp syndrome counts
};

// The body shared by the paged and the dense decode: one chunk's partial
// (o, m, l) -- and with SYN its syndrome count -- by one block of nw
// warps.  smem holds (rows in a chunk) + nw * hd floats.
template <typename TQ, int MODE, bool SYN>
__device__ __forceinline__ void decode_chunk(
    const Chunk& c, const TQ* __restrict__ q, const void* __restrict__ kp,
    const void* __restrict__ vp, const float* __restrict__ ks,
    const float* __restrict__ vs, const uint8_t* __restrict__ kw,
    const uint8_t* __restrict__ vw, float* __restrict__ o,
    float* __restrict__ mo, float* __restrict__ lo, int* __restrict__ syn,
    const Packed& pk, const Witness& wt, float* smem, DecodeShared& sh) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nw = blockDim.x >> 5, nthr = blockDim.x;
  const int hd = c.hd, nvalid = c.nvalid, Kv = c.Kv, kh = c.kh, j = c.j;
  const int n_ch = c.n_chunks;
  const long long bh = c.bh, row_stride = c.row_stride;
  const bool check = SYN && c.lead;
  float* sc = smem;                 // [rows] scores, then p
  float* part = sc + ((nvalid + 3) & ~3);  // [nw][hd] partial o

  if (nvalid == 0) {  // all rows masked: o = 0, m = -1e30, l = 0
    for (int d = tid; d < hd; d += nthr) o[(bh * hd + d) * n_ch + j] = 0.f;
    if (tid == 0) {
      mo[bh * n_ch + j] = NEG_BIG;
      lo[bh * n_ch + j] = 0.f;
      if (SYN) syn[bh * n_ch + j] = 0;
    }
    return;
  }

  // lane groups: ng lanes of 8 values cover a row, lpr (ng rounded up to a
  // power of two) lanes take one row, rpw rows a warp at once
  const int ng = hd >> 3;
  const int lpr = ng <= 1 ? 1 : 1 << (32 - __clz(ng - 1));
  const int rpw = 32 / lpr;
  const int sub = lane / lpr, gi = lane & (lpr - 1);
  const bool active = gi < ng;
  const int step = nw * rpw;  // rows a pass of the block
  const int hds = MODE == KV_PACKED ? hd / pk.vpb : hd;  // stored per row
  auto row_off = [&](int r) {
    return (c.row0 + r) * row_stride + (long long)kh * hds;
  };
  auto row_scale = [&](const float* scales, int r) {
    return MODE == KV_PACKED ? scales[(c.row0 + r) * Kv + kh] : 1.f;
  };

  float qv[PD_NV];
#pragma unroll
  for (int i = 0; i < PD_NV; ++i)
    qv[i] = active ? to_f(q[bh * hd + gi * 8 + i]) : 0.f;

  int bad = 0;
  // scores: PD_UNROLL passes of rows loaded before any is reduced; the
  // first passes' V rows load beside their K rows
  RawVec vfirst[PD_UNROLL];
  for (int r0 = 0; r0 < nvalid; r0 += PD_UNROLL * step) {
    RawVec raw[PD_UNROLL];
#pragma unroll
    for (int u = 0; u < PD_UNROLL; ++u) {
      const int r = r0 + u * step + warp * rpw + sub;
      if (active && r < nvalid) {
        load_vec<MODE>(kp, row_off(r), gi, pk, raw[u]);
        if (r0 == 0) load_vec<MODE>(vp, row_off(r), gi, pk, vfirst[u]);
      }
    }
    float part_s[PD_UNROLL];
#pragma unroll
    for (int u = 0; u < PD_UNROLL; ++u) {
      const int r = r0 + u * step + warp * rpw + sub;
      part_s[u] = 0.f;
      if (active && r < nvalid) {
        float x[PD_NV];
        int xi[PD_NV];
        decode_vec<MODE>(raw[u], pk, row_scale(ks, r), x, xi);
        if (check) bad += witness_bad(xi, kw, row_off(r), gi, wt);
#pragma unroll
        for (int i = 0; i < PD_NV; ++i) part_s[u] = fmaf(qv[i], x[i], part_s[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < PD_UNROLL; ++u) {
      for (int s = lpr >> 1; s > 0; s >>= 1)
        part_s[u] += __shfl_xor_sync(0xffffffffu, part_s[u], s);
      const int r = r0 + u * step + warp * rpw + sub;
      if (gi == 0 && r < nvalid) sc[r] = part_s[u] * c.scale;
    }
  }
  __syncthreads();

  // the chunk's max and sum by all warps, combined in warp order
  float mx = NEG_BIG;
  for (int r = tid; r < nvalid; r += nthr) mx = fmaxf(mx, sc[r]);
  mx = warp_max(mx);
  if (lane == 0) sh.red[warp] = mx;
  __syncthreads();
  mx = sh.red[0];
  for (int w = 1; w < nw; ++w) mx = fmaxf(mx, sh.red[w]);
  float sum = 0.f;
  for (int r = tid; r < nvalid; r += nthr) {
    const float p = expf(sc[r] - mx);
    sc[r] = p;
    sum += p;
  }
  sum = warp_sum(sum);
  if (lane == 0) sh.red[PD_MAXW + warp] = sum;
  __syncthreads();  // every p in sc, every warp's sum in red

  // PV: the rows split across the warps as for the scores
  float acc[PD_NV];
#pragma unroll
  for (int i = 0; i < PD_NV; ++i) acc[i] = 0.f;
  for (int r0 = 0; r0 < nvalid; r0 += PD_UNROLL * step) {
    RawVec raw[PD_UNROLL];
#pragma unroll
    for (int u = 0; u < PD_UNROLL; ++u) {
      const int r = r0 + u * step + warp * rpw + sub;
      if (active && r < nvalid && r0 > 0)
        load_vec<MODE>(vp, row_off(r), gi, pk, raw[u]);
    }
#pragma unroll
    for (int u = 0; u < PD_UNROLL; ++u) {
      const int r = r0 + u * step + warp * rpw + sub;
      if (active && r < nvalid) {
        float x[PD_NV];
        int xi[PD_NV];
        decode_vec<MODE>(r0 == 0 ? vfirst[u] : raw[u], pk, row_scale(vs, r),
                         x, xi);
        if (check) bad += witness_bad(xi, vw, row_off(r), gi, wt);
        // p is cast to v's dtype before PV: bf16 pages round it, f32 and
        // dequantized residue pages keep it in f32
        const float p = MODE == KV_BF16 ? round_bf16(sc[r]) : sc[r];
#pragma unroll
        for (int i = 0; i < PD_NV; ++i) acc[i] = fmaf(p, x[i], acc[i]);
      }
    }
  }
  // the warp's rows groups, then the warps, summed in a fixed order
  for (int s = lpr; s < 32; s <<= 1) {
#pragma unroll
    for (int i = 0; i < PD_NV; ++i)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], s);
  }
  if (sub == 0 && active) {
#pragma unroll
    for (int i = 0; i < PD_NV; ++i) part[warp * hd + gi * 8 + i] = acc[i];
  }
  if (SYN) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) bad += __shfl_xor_sync(0xffffffffu, bad, s);
    if (lane == 0) sh.bad[warp] = bad;
  }
  __syncthreads();
  for (int d = tid; d < hd; d += nthr) {
    float od = part[d];
    for (int w = 1; w < nw; ++w) od += part[w * hd + d];
    o[(bh * hd + d) * n_ch + j] = od;
  }
  if (tid == 0) {
    float l = sh.red[PD_MAXW];
    for (int w = 1; w < nw; ++w) l += sh.red[PD_MAXW + w];
    mo[bh * n_ch + j] = mx;
    lo[bh * n_ch + j] = l;
    if (SYN) {
      int n = 0;
      for (int w = 0; w < nw; ++w) n += sh.bad[w];
      syn[bh * n_ch + j] = c.lead ? n : 0;
    }
  }
}

size_t pd_smem_bytes(int rows, int hd, int nw) {
  return sizeof(float) * ((size_t)((rows + 3) & ~3) + (size_t)nw * hd);
}

// Warps a decode block.  8 for chunks of more than 64 rows and for packed
// pages (the syndrome mode's lead heads decode and check every element,
// and the mode must sum as the plain packed mode does), else 4: chosen
// from card timings at the serves' chunk shapes.  The dense decode at
// bk = ps and the paged decode get the same count, so their partials stay
// bit-identical.
int decode_warps(int rows, int mode) {
  return mode == KV_PACKED || rows > 64 ? 8 : 4;
}

// Paged: one block per (page slot j, head h, batch row b); the chunk is
// page tab[b, j], its valid rows those below kv_len[b].
template <typename TQ, int MODE, bool SYN>
__global__ void __launch_bounds__(PD_MAXW * 32)
paged_decode_kernel(const TQ* __restrict__ q, const void* __restrict__ kp,
                    const void* __restrict__ vp,
                    const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const uint8_t* __restrict__ kw,
                    const uint8_t* __restrict__ vw,
                    const int* __restrict__ tab,
                    const int* __restrict__ kv_len, float* __restrict__ o,
                    float* __restrict__ mo, float* __restrict__ lo,
                    int* __restrict__ syn, int H, int Kv, int hd, int ps,
                    int n_pmax, long long row_stride, float scale, Packed pk,
                    Witness wt) {
  extern __shared__ float smem[];
  __shared__ DecodeShared sh;
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = H / Kv;
  Chunk c;
  c.bh = (long long)b * H + h;
  c.j = j;
  c.n_chunks = n_pmax;
  c.nvalid = max(0, min(ps, kv_len[b] - j * ps));
  c.row0 = c.nvalid ? (long long)tab[(long long)b * n_pmax + j] * ps : 0;
  c.row_stride = row_stride;
  c.hd = hd;
  c.Kv = Kv;
  c.kh = h / g;
  c.lead = h % g == 0;
  c.scale = scale;
  decode_chunk<TQ, MODE, SYN>(c, q, kp, vp, ks, vs, kw, vw, o, mo, lo, syn,
                              pk, wt, smem, sh);
}

// Dense (replaces flash_decode_pallas, body _decode_kernel): one block per
// (chunk j of bk rows, head h, batch row b) over the contiguous cache
// k/v (B, T, Kv, hd); chunk j holds rows j*bk .. j*bk + bk - 1 of row b,
// valid below min(kv_len[b], T).  The chunk body is the paged one, so with
// bk equal to the page size both give the same partials bit for bit.
template <typename TQ, int MODE>
__global__ void __launch_bounds__(PD_MAXW * 32)
dense_decode_kernel(const TQ* __restrict__ q, const void* __restrict__ k,
                    const void* __restrict__ v,
                    const int* __restrict__ kv_len, float* __restrict__ o,
                    float* __restrict__ mo, float* __restrict__ lo, int H,
                    int Kv, int hd, int T_, int bk, int n_k, float scale) {
  extern __shared__ float smem[];
  __shared__ DecodeShared sh;
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  Chunk c;
  c.bh = (long long)b * H + h;
  c.j = j;
  c.n_chunks = n_k;
  c.nvalid = max(0, min(bk, min(kv_len[b], T_) - j * bk));
  c.row0 = (long long)b * T_ + (long long)j * bk;
  c.row_stride = (long long)Kv * hd;
  c.hd = hd;
  c.Kv = Kv;
  c.kh = h / (H / Kv);
  c.lead = false;
  c.scale = scale;
  const Packed pk = {0, 0, 0, 0, 0, 1};
  Witness wt;
  wt.r = 0;
  wt.lane_stride = 0;
  decode_chunk<TQ, MODE, false>(c, q, k, v, nullptr, nullptr, nullptr,
                                nullptr, o, mo, lo, nullptr, pk, wt, smem,
                                sh);
}

struct PagedArgs {
  const void *q, *kp, *vp;
  const float *ks, *vs;
  const uint8_t *kw, *vw;
  const int *tab, *kv_len;
  float *o, *m, *l;
  int* syn;
  int B, H, Kv, hd, ps, n_pmax;
  long long row_stride;
  float scale;
  Packed pk;
  Witness wt;
};

template <typename TQ, int MODE, bool SYN>
int launch_paged(const PagedArgs& a, cudaStream_t stream) {
  const int nw = decode_warps(a.ps, MODE);
  size_t smem = pd_smem_bytes(a.ps, a.hd, nw);
  cudaFuncSetAttribute(paged_decode_kernel<TQ, MODE, SYN>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid(a.n_pmax, a.H, a.B);
  paged_decode_kernel<TQ, MODE, SYN><<<grid, nw * 32, smem, stream>>>(
      (const TQ*)a.q, a.kp, a.vp, a.ks, a.vs, a.kw, a.vw, a.tab, a.kv_len,
      a.o, a.m, a.l, a.syn, a.H, a.Kv, a.hd, a.ps, a.n_pmax, a.row_stride,
      a.scale, a.pk, a.wt);
  return (int)cudaGetLastError();
}

template <typename TQ>
int dispatch_paged(int kv_mode, const PagedArgs& a, cudaStream_t stream) {
  switch (kv_mode) {
    case KV_F32:
      return launch_paged<TQ, KV_F32, false>(a, stream);
    case KV_BF16:
      return launch_paged<TQ, KV_BF16, false>(a, stream);
    case KV_PACKED:
      return a.wt.r ? launch_paged<TQ, KV_PACKED, true>(a, stream)
                    : launch_paged<TQ, KV_PACKED, false>(a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename TQ, int MODE>
int launch_dense(const void* q, const void* k, const void* v,
                 const int* kv_len, float* o, float* m, float* l, int B,
                 int H, int Kv, int hd, int T_, int bk, float scale,
                 cudaStream_t stream) {
  const int n_k = (T_ + bk - 1) / bk;
  const int nw = decode_warps(bk, MODE);
  size_t smem = pd_smem_bytes(bk, hd, nw);
  cudaFuncSetAttribute(dense_decode_kernel<TQ, MODE>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid(n_k, H, B);
  dense_decode_kernel<TQ, MODE><<<grid, nw * 32, smem, stream>>>(
      (const TQ*)q, k, v, kv_len, o, m, l, H, Kv, hd, T_, bk, n_k, scale);
  return (int)cudaGetLastError();
}

template <typename TQ>
int dispatch_dense(int kv_dtype, const void* q, const void* k, const void* v,
                   const int* kv_len, float* o, float* m, float* l, int B,
                   int H, int Kv, int hd, int T_, int bk, float scale,
                   cudaStream_t stream) {
  if (kv_dtype == KV_F32)
    return launch_dense<TQ, KV_F32>(q, k, v, kv_len, o, m, l, B, H, Kv, hd,
                                    T_, bk, scale, stream);
  if (kv_dtype == KV_BF16)
    return launch_dense<TQ, KV_BF16>(q, k, v, kv_len, o, m, l, B, H, Kv, hd,
                                     T_, bk, scale, stream);
  return (int)cudaErrorInvalidValue;
}

bool decode_hd_ok(int hd) { return hd >= 8 && hd <= PD_MAXD && hd % 8 == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and the output share it).
// bf16 takes the tensor-core kernel (head_dim a multiple of 16, pointers
// 16-byte aligned; q / k of hd, v and the output of hdv), f32 the
// CUDA-core one (hdv == hd).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* kv_len, void* o,
                                   int B, int Sq, int T, int H, int Kv,
                                   int hd, int hdv, int causal, float scale,
                                   int dtype, void* stream) {
  if (Kv < 1 || H % Kv != 0 || (hd == hdv && hd > FA_MAXD))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* kl = (const int*)kv_len;
  if (dtype == 0 && hd == hdv)
    return launch_flash_f32(q, k, v, kl, o, B, Sq, T, H, Kv, hd, causal,
                            scale, s);
  if (dtype == 1)
    return dispatch_flash_bf16(q, k, v, kl, o, B, Sq, T, H, Kv, hd, hdv,
                               causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

// q_dtype: 0 = float32, 1 = bfloat16.  kv_mode: 0 = float32 pages,
// 1 = bfloat16 pages, 2 = packed uint8 residue pages with f32 scales.
// Pages (P, ps, Kv, hd_stored) have unit strides in their last two axes and
// `row_stride` elements between consecutive (page, slot) rows.  n_red > 0
// (packed pages only) turns on the syndrome mode: k_wit / v_wit point at
// the first witness lane of each pool (same row strides as the pages,
// `wit_lane_stride` elements between lanes), red_moduli (host int[n_red])
// are the witness moduli and syn (B, H, n_pmax) int32 gets the counts.
// head_dim a multiple of 8, <= 128; rows aligned to a lane's vector load.
extern "C" int paged_decode_fwd(const void* q, const void* k_pages,
                                const void* v_pages, const void* k_scale,
                                const void* v_scale, const void* tab,
                                const void* kv_len, void* o, void* m,
                                void* l, int B, int H, int Kv, int hd,
                                int ps, int n_pmax, long long row_stride,
                                float scale, int q_dtype, int kv_mode, int m0,
                                int m1, int crt_inv, const void* k_wit,
                                const void* v_wit, long long wit_lane_stride,
                                int n_red, const int* red_moduli, void* syn,
                                void* stream) {
  if (Kv < 1 || H % Kv != 0 || !decode_hd_ok(hd))
    return (int)cudaErrorInvalidValue;
  if (n_red < 0 || n_red > PD_MAXR || (n_red && kv_mode != KV_PACKED))
    return (int)cudaErrorInvalidValue;
  PagedArgs a;
  a.q = q;
  a.kp = k_pages;
  a.vp = v_pages;
  a.ks = (const float*)k_scale;
  a.vs = (const float*)v_scale;
  a.kw = (const uint8_t*)k_wit;
  a.vw = (const uint8_t*)v_wit;
  a.tab = (const int*)tab;
  a.kv_len = (const int*)kv_len;
  a.o = (float*)o;
  a.m = (float*)m;
  a.l = (float*)l;
  a.syn = (int*)syn;
  a.B = B;
  a.H = H;
  a.Kv = Kv;
  a.hd = hd;
  a.ps = ps;
  a.n_pmax = n_pmax;
  a.row_stride = row_stride;
  a.scale = scale;
  a.pk = {m0, m1, crt_inv, 0, 0, 1};
  if (kv_mode == KV_PACKED) {
    int b0 = 0, b1 = 0;
    while ((1 << b0) < m0) ++b0;  // (m0 - 1).bit_length()
    while ((1 << b1) < m1) ++b1;  // (m1 - 1).bit_length()
    a.pk.b0 = b0;
    a.pk.b1 = b1;
    a.pk.vpb = 8 / (b0 + b1);
    if (n_red && a.pk.vpb != 1) return (int)cudaErrorInvalidValue;
  }
  a.wt.r = n_red;
  a.wt.lane_stride = wit_lane_stride;
  for (int i = 0; i < PD_MAXR; ++i) a.wt.m[i] = i < n_red ? red_moduli[i] : 1;
  cudaStream_t s = (cudaStream_t)stream;
  if (q_dtype == 0) return dispatch_paged<float>(kv_mode, a, s);
  if (q_dtype == 1) return dispatch_paged<__nv_bfloat16>(kv_mode, a, s);
  return (int)cudaErrorInvalidValue;
}

// Split-KV decode partials over the dense cache.  q (B, H, hd) in q_dtype
// (0 = float32, 1 = bfloat16); k, v (B, T, Kv, hd) contiguous in kv_dtype
// (the same codes); kv_len (B,) int32.  Writes o (B, H, hd, n_k), m and l
// (B, H, n_k) f32 with n_k = ceil(T / bk).  head_dim a multiple of 8,
// <= 128.
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v,
                                const void* kv_len, void* o, void* m, void* l,
                                int B, int H, int Kv, int hd, int T, int bk,
                                float scale, int q_dtype, int kv_dtype,
                                void* stream) {
  if (Kv < 1 || H % Kv != 0 || bk < 1 || T < 1 || !decode_hd_ok(hd))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* kl = (const int*)kv_len;
  if (q_dtype == 0)
    return dispatch_dense<float>(kv_dtype, q, k, v, kl, (float*)o, (float*)m,
                                 (float*)l, B, H, Kv, hd, T, bk, scale, s);
  if (q_dtype == 1)
    return dispatch_dense<__nv_bfloat16>(kv_dtype, q, k, v, kl, (float*)o,
                                         (float*)m, (float*)l, B, H, Kv, hd,
                                         T, bk, scale, s);
  return (int)cudaErrorInvalidValue;
}
