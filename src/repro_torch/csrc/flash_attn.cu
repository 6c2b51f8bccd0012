// Flash attention for Hopper (sm_90a): causal GQA prefill and paged
// split-KV decode partials over bf16 or packed residue pages.
//
// flash_attention_fwd replaces repro/kernels/flash_attn.py::
// flash_attention_pallas (body _attn_kernel).  One block per (q tile of 64
// rows, head h, batch row b); it walks the KV tiles of head h / g (GQA
// resolved in its own offsets, no repeated KV) up to min(T, kv_len[b]) and,
// when causal, the tile's last query row.  Online softmax in f32 registers:
// masked scores take -1e30, masked KV rows load as zeros, p is rounded to
// v's dtype before the PV product, the output is acc / max(l, 1e-30).  The
// body runs on CUDA cores from shared memory (K rows padded by one float so
// lane-parallel dot products are conflict-free).  Bound on the H100: the
// q/k/v/o bytes at S = 256 (the work is ~4 GFLOP per layer); a tensor-core
// (mma.sync / wgmma) body is later work.
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
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}
// x rounded to T and back: the reference casts p to v's dtype before PV.
template <typename T>
__device__ __forceinline__ float round_as(float x) {
  return to_f(from_f<T>(x));
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
// Prefill: causal GQA flash attention.
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

template <typename T>
__global__ void __launch_bounds__(FA_WARPS * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int* __restrict__ kv_len, T* __restrict__ out,
                       int Sq, int T_, int H, int Kv, int hd, int causal,
                       float scale) {
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
    Qs[idx] = qi < Sq ? to_f(q[(((long long)b * Sq + qi) * H + h) * hd + d])
                      : 0.f;
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
      Ks[j * (hd + 1) + d] = ok ? to_f(k[off]) : 0.f;
      Vs[j * hd + d] = ok ? to_f(v[off]) : 0.f;
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
      Ps[row * FA_BK + lane] = round_as<T>(pa);
      Ps[row * FA_BK + lane + 32] = round_as<T>(pb);
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
      if (d < hd)
        out[(((long long)b * Sq + qi) * H + h) * hd + d] =
            from_f<T>(acc[r][i] * inv);
    }
  }
}

template <typename T>
int launch_flash(const void* q, const void* k, const void* v,
                 const int* kv_len, void* o, int B, int Sq, int T_, int H,
                 int Kv, int hd, int causal, float scale,
                 cudaStream_t stream) {
  size_t smem = fa_smem_bytes(hd);
  cudaFuncSetAttribute(flash_attention_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((Sq + FA_BQ - 1) / FA_BQ, H, B);
  flash_attention_kernel<T><<<grid, FA_WARPS * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, kv_len, (T*)o, Sq, T_, H, Kv,
      hd, causal, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Paged split-KV decode partials.
// ---------------------------------------------------------------------------

constexpr int PD_THREADS = 128;
constexpr int PD_WARPS = PD_THREADS / 32;

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

// The integer value d of the packed row starting at element `off`.
__device__ __forceinline__ int packed_int(const uint8_t* pages, long long off,
                                          int d, const Packed& pk) {
  const int w = pk.b0 + pk.b1;
  int byte = pages[off + d / pk.vpb];
  int lane = (byte >> ((d % pk.vpb) * w)) & ((1 << w) - 1);
  int f0 = lane & ((1 << pk.b0) - 1);
  int f1 = (lane >> pk.b0) & ((1 << pk.b1) - 1);
  int r0 = f0 - ((f0 >> (pk.b0 - 1)) << pk.b0);  // sign-extend both fields
  int r1 = f1 - ((f1 >> (pk.b1 - 1)) << pk.b1);
  int t = ((r0 - r1) * pk.inv) % pk.m0;          // truncating, like lax.rem
  if (t < 0) t += pk.m0;
  if (t > (pk.m0 - 1) / 2) t -= pk.m0;
  return r1 + pk.m1 * t;
}

// 1 when a witness residue of value x (element d of the row at `off`)
// disagrees with x: the reference's floored ((w - x mod m) mod m) != 0.
// x mod m is taken floored, ((x % m) + m) % m, as jnp.remainder does; then
// with xm in [0, m) and the stored byte w >= 0 the outer test equals
// w % m != xm, which saves two of the four runtime divisions.
__device__ __forceinline__ int witness_bad(int x, const uint8_t* wit,
                                           long long off, int d,
                                           const Witness& wt) {
  int bad = 0;
#pragma unroll
  for (int jw = 0; jw < PD_MAXR; ++jw) {  // unrolled: wt.m stays in registers
    if (jw < wt.r) {
      const int m = wt.m[jw];
      const int w = wit[off + jw * wt.lane_stride + d];
      const int xm = ((x % m) + m) % m;
      bad |= w % m != xm;
    }
  }
  return bad;
}

// Value d of the KV row starting at element `off` (row `srow` of the
// scales: (pid * ps + slot) * Kv + kh).
template <int MODE>
__device__ __forceinline__ float kv_value(const void* pages,
                                          const float* scales, long long off,
                                          long long srow, int d,
                                          const Packed& pk) {
  if (MODE == KV_F32) return ((const float*)pages)[off + d];
  if (MODE == KV_BF16)
    return __bfloat162float(((const __nv_bfloat16*)pages)[off + d]);
  return (float)packed_int((const uint8_t*)pages, off, d, pk) * scales[srow];
}

// kv_value, and with SYN (packed pages only) the witness check of the
// same element on the lead head, added to `bad`.
template <int MODE, bool SYN>
__device__ __forceinline__ float kv_checked(const void* pages,
                                            const float* scales,
                                            const uint8_t* wit, long long off,
                                            long long srow, int d,
                                            const Packed& pk,
                                            const Witness& wt, bool lead,
                                            int& bad) {
  if (!SYN) return kv_value<MODE>(pages, scales, off, srow, d, pk);
  const int x = packed_int((const uint8_t*)pages, off, d, pk);
  if (lead) bad += witness_bad(x, wit, off, d, wt);
  return (float)x * scales[srow];
}

template <typename TQ, int MODE, bool SYN>
__global__ void __launch_bounds__(PD_THREADS)
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
  float* qs = smem;       // [hd]
  float* sc = qs + hd;    // [ps] scores, then p
  __shared__ float red[2];
  __shared__ int bad_s;

  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = H / Kv;
  const int kh = h / g;
  const bool lead = h % g == 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long bh = (long long)b * H + h;
  const int nvalid = max(0, min(ps, kv_len[b] - j * ps));
  const int hds = MODE == KV_PACKED ? hd / pk.vpb : hd;  // stored per row

  if (nvalid == 0) {  // all rows masked: o = 0, m = -1e30, l = 0
    for (int d = tid; d < hd; d += PD_THREADS) o[(bh * hd + d) * n_pmax + j] = 0.f;
    if (tid == 0) {
      mo[bh * n_pmax + j] = NEG_BIG;
      lo[bh * n_pmax + j] = 0.f;
      if (SYN) syn[bh * n_pmax + j] = 0;
    }
    return;
  }
  const long long pid = tab[(long long)b * n_pmax + j];
  for (int d = tid; d < hd; d += PD_THREADS) qs[d] = to_f(q[bh * hd + d]);
  if (SYN && tid == 0) bad_s = 0;
  __syncthreads();

  int bad = 0;
  for (int r = warp; r < nvalid; r += PD_WARPS) {
    const long long row = pid * ps + r;
    const long long off = row * row_stride + (long long)kh * hds;
    const long long srow = row * Kv + kh;
    float part = 0.f;
    for (int d = lane; d < hd; d += 32)
      part = fmaf(qs[d],
                  kv_checked<MODE, SYN>(kp, ks, kw, off, srow, d, pk, wt,
                                        lead, bad),
                  part);
    part = warp_sum(part);
    if (lane == 0) sc[r] = part * scale;
  }
  __syncthreads();

  if (warp == 0) {
    float mx = NEG_BIG;
    for (int r = lane; r < nvalid; r += 32) mx = fmaxf(mx, sc[r]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int r = lane; r < nvalid; r += 32) {
      float p = expf(sc[r] - mx);
      sc[r] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      red[0] = mx;
      red[1] = sum;
    }
  }
  __syncthreads();

  for (int d = tid; d < hd; d += PD_THREADS) {
    float acc = 0.f;
    for (int r = 0; r < nvalid; ++r) {
      const long long row = pid * ps + r;
      const long long off = row * row_stride + (long long)kh * hds;
      // p is cast to v's dtype before PV: bf16 pages round it, f32 and
      // dequantized residue pages keep it in f32
      float p = MODE == KV_BF16 ? round_as<__nv_bfloat16>(sc[r]) : sc[r];
      acc = fmaf(p,
                 kv_checked<MODE, SYN>(vp, vs, vw, off, row * Kv + kh, d, pk,
                                       wt, lead, bad),
                 acc);
    }
    o[(bh * hd + d) * n_pmax + j] = acc;
  }
  if (tid == 0) {
    mo[bh * n_pmax + j] = red[0];
    lo[bh * n_pmax + j] = red[1];
  }
  if (SYN) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) bad += __shfl_xor_sync(0xffffffffu, bad, s);
    if (lane == 0 && bad) atomicAdd(&bad_s, bad);
    __syncthreads();
    if (tid == 0) syn[bh * n_pmax + j] = lead ? bad_s : 0;
  }
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
  size_t smem = sizeof(float) * (size_t)(a.hd + a.ps);
  cudaFuncSetAttribute(paged_decode_kernel<TQ, MODE, SYN>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid(a.n_pmax, a.H, a.B);
  paged_decode_kernel<TQ, MODE, SYN><<<grid, PD_THREADS, smem, stream>>>(
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and the output share it).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* kv_len, void* o,
                                   int B, int Sq, int T, int H, int Kv,
                                   int hd, int causal, float scale, int dtype,
                                   void* stream) {
  if (hd > FA_MAXD || Kv < 1 || H % Kv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* kl = (const int*)kv_len;
  if (dtype == 0)
    return launch_flash<float>(q, k, v, kl, o, B, Sq, T, H, Kv, hd, causal,
                               scale, s);
  if (dtype == 1)
    return launch_flash<__nv_bfloat16>(q, k, v, kl, o, B, Sq, T, H, Kv, hd,
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
  if (Kv < 1 || H % Kv != 0) return (int)cudaErrorInvalidValue;
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
  }
  a.wt.r = n_red;
  a.wt.lane_stride = wit_lane_stride;
  for (int i = 0; i < PD_MAXR; ++i) a.wt.m[i] = i < n_red ? red_moduli[i] : 1;
  cudaStream_t s = (cudaStream_t)stream;
  if (q_dtype == 0) return dispatch_paged<float>(kv_mode, a, s);
  if (q_dtype == 1) return dispatch_paged<__nv_bfloat16>(kv_mode, a, s);
  return (int)cudaErrorInvalidValue;
}
