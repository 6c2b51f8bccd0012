// Reverse conversion of the residue matmul's output for sm_90a: kernel B9.
//
// Replaces no Pallas kernel: the JAX reference decodes B1's residues with
// jnp ops (repro/core/moduli.py::ModuliSet.from_residues), and the port did
// the same in eager int64 PyTorch ops (casts, three remainders a channel
// pair, the sign test's compare chain, the reconstruction): some 30 passes
// over the output, ~500 bytes of HBM traffic an element.  Here each element
// is decoded in registers.  res (S, C, M, N) int32 residues, any
// representative of each, read through channel and stack strides as B1
// leaves them -> out (S, M, N) int32; with ACC the value is added into out
// in place (int32, wrapping), which is the sum over a matmul's K segments.
//
// Per element, bit for bit ModuliSet.from_residues on every set it accepts
// (moduli <= 46340, C <= 8):
// - each residue to its canonical representative in [0, m): one compare
//   for a canonical or centred residue (B1's), else (x + 2^31) mod m less
//   2^31 mod m;
// - stepwise mixed-radix conversion, d_j <- (d_j - d_i) m_i^-1 mod m_j,
//   computed as d_j inv + d_i (m_j - inv) mod m_j: both terms are canonical
//   so the sum stays below 2 x 46340^2 < 2^32, and one reduction does;
// - the sign test: the digits against those of (M - 1) / 2, compared
//   lexicographically from the top;
// - the value, sum of d_j m_0 ... m_{j-1}, less M where the test says so,
//   cast to int32.  The reference sums in exact int64 and casts modulo
//   2^32; a sum of products taken modulo 2^32 throughout has the same low
//   32 bits, so it is done in uint32 with the prefix products and M
//   reduced modulo 2^32 on the host (P33 and CRT40 wrap here, as there).
// Every reduction is x - floor(x magic / 2^32) m with magic = floor(2^32 /
// m), one conditional subtract after (the quotient is at most one short
// for any x < 2^32).  The set's constants are computed once per moduli set
// on the host (kernels/rns_decode.py::decode_tables) and passed by value in
// the kernel's parameters: no copy to the device and no sync a call.
//
// Bound on the H100: bytes, 4 C in and 4 out an element (4 more read with
// ACC): 16 B an element at C = 3, 0.96 ms at the prefill shape M 16384, N
// 12288 at 3.35 TB/s.  The arithmetic, ~15 integer operations a channel
// an element on B1's centred residues, is ~10 T operations a second at
// that byte rate, about a third of the instructions the SMs can dispatch.
// So the design only keeps the bytes moving: 16-byte loads of each channel
// plane and 16-byte stores (four elements a thread an iteration), a grid
// of resident blocks on every SM striding over the planes, a scalar tail
// for a plane whose length is not a multiple of four, or for every element
// where a base or a stride is not 16-byte aligned.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxC = 8;
constexpr int kThreads = 256;

// The set's constants (uint32 words in this order, the host's layout).
struct Tables {
  uint32_t m[kMaxC];              // moduli
  uint32_t magic[kMaxC];          // floor(2^32 / m)
  uint32_t off[kMaxC];            // 2^31 mod m
  uint32_t inv[kMaxC][kMaxC];     // m_i^-1 mod m_j, i < j
  uint32_t ninv[kMaxC][kMaxC];    // m_j - inv[i][j]
  uint32_t half[kMaxC];           // mixed-radix digits of (M - 1) / 2
  uint32_t prod[kMaxC];           // m_0 ... m_{j-1} mod 2^32
  uint32_t big_m;                 // M mod 2^32
};
constexpr int kTableWords = 5 * kMaxC + 2 * kMaxC * kMaxC + 1;
static_assert(sizeof(Tables) == 4 * kTableWords, "Tables is packed");

// x mod m for any x < 2^32.
__device__ __forceinline__ uint32_t reduce(uint32_t x, uint32_t m,
                                           uint32_t magic) {
  const uint32_t r = x - __umulhi(x, magic) * m;
  return r >= m ? r - m : r;
}

// The canonical residue of any int32 representative x.
__device__ __forceinline__ uint32_t canon(int32_t x, uint32_t m,
                                          uint32_t magic, uint32_t off) {
  const uint32_t u = static_cast<uint32_t>(x);
  uint32_t r = u < m ? u : u + m;   // [0, m) as it is, [-m, 0) plus m
  if (r >= m) {                     // any other int32
    r = reduce(u ^ 0x80000000u, m, magic);   // (x + 2^31) mod m
    r = r >= off ? r - off : r + m - off;
  }
  return r;
}

template <int C>
__device__ __forceinline__ uint32_t decode(const int32_t (&x)[C],
                                           const Tables& t) {
  uint32_t d[C];
#pragma unroll
  for (int j = 0; j < C; ++j) d[j] = canon(x[j], t.m[j], t.magic[j], t.off[j]);
#pragma unroll
  for (int i = 0; i < C; ++i) {
#pragma unroll
    for (int j = i + 1; j < C; ++j)
      d[j] = reduce(d[j] * t.inv[i][j] + d[i] * t.ninv[i][j], t.m[j],
                    t.magic[j]);
  }
  bool gt = false, eq = true;
#pragma unroll
  for (int j = C - 1; j >= 0; --j) {
    gt = gt || (eq && d[j] > t.half[j]);
    eq = eq && d[j] == t.half[j];
  }
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < C; ++j) v += d[j] * t.prod[j];
  return gt ? v - t.big_m : v;
}

template <int C, bool ACC>
__global__ void __launch_bounds__(kThreads)
mrc_decode_kernel(const int32_t* __restrict__ res, int32_t* __restrict__ out,
                  const __grid_constant__ Tables t, long long S, long long P,
                  long long cs, long long ss, int vec) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (long long s = blockIdx.y; s < S; s += gridDim.y) {
    const int32_t* r = res + s * ss;
    int32_t* o = out + s * P;
    long long head = 0;
    if (vec) {
      head = P / 4 * 4;
      for (long long v = tid; v < P / 4; v += stride) {
        int4 q[C];
#pragma unroll
        for (int c = 0; c < C; ++c)
          q[c] = __ldg(reinterpret_cast<const int4*>(r + c * cs) + v);
        int32_t x0[C], x1[C], x2[C], x3[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          x0[c] = q[c].x; x1[c] = q[c].y; x2[c] = q[c].z; x3[c] = q[c].w;
        }
        uint32_t y0 = decode<C>(x0, t), y1 = decode<C>(x1, t),
                 y2 = decode<C>(x2, t), y3 = decode<C>(x3, t);
        int4* dst = reinterpret_cast<int4*>(o) + v;
        if (ACC) {
          const int4 p = *dst;
          y0 += static_cast<uint32_t>(p.x);
          y1 += static_cast<uint32_t>(p.y);
          y2 += static_cast<uint32_t>(p.z);
          y3 += static_cast<uint32_t>(p.w);
        }
        *dst = make_int4(static_cast<int32_t>(y0), static_cast<int32_t>(y1),
                         static_cast<int32_t>(y2), static_cast<int32_t>(y3));
      }
    }
    for (long long i = head + tid; i < P; i += stride) {
      int32_t x[C];
#pragma unroll
      for (int c = 0; c < C; ++c) x[c] = r[c * cs + i];
      uint32_t y = decode<C>(x, t);
      if (ACC) y += static_cast<uint32_t>(o[i]);
      o[i] = static_cast<int32_t>(y);
    }
  }
}

template <int C, bool ACC>
int launch(const int32_t* res, int32_t* out, const Tables& t, long long S,
           long long P, long long cs, long long ss, int vec, cudaStream_t s) {
  static int grid_cap = 0;   // resident blocks an SM x SMs, found once
  if (grid_cap == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mrc_decode_kernel<C, ACC>, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    grid_cap = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long gy = S < 65535 ? S : 65535;
  const long long items = vec ? P / 4 + P % 4 : P;
  long long gx = (items + kThreads - 1) / kThreads;
  const long long cap_x = grid_cap / gy > 0 ? grid_cap / gy : 1;
  if (gx > cap_x) gx = cap_x;
  if (gx < 1) gx = 1;
  mrc_decode_kernel<C, ACC><<<dim3((unsigned)gx, (unsigned)gy), kThreads, 0,
                              s>>>(res, out, t, S, P, cs, ss, vec);
  return (int)cudaGetLastError();
}

template <int C>
int launch_c(const int32_t* res, int32_t* out, const Tables& t, long long S,
             long long P, long long cs, long long ss, int vec, int acc,
             cudaStream_t s) {
  return acc ? launch<C, true>(res, out, t, S, P, cs, ss, vec, s)
             : launch<C, false>(res, out, t, S, P, cs, ss, vec, s);
}

using LaunchC = int (*)(const int32_t*, int32_t*, const Tables&, long long,
                        long long, long long, long long, int, int,
                        cudaStream_t);
constexpr LaunchC kByChannels[kMaxC + 1] = {
    nullptr,     launch_c<1>, launch_c<2>, launch_c<3>, launch_c<4>,
    launch_c<5>, launch_c<6>, launch_c<7>, launch_c<8>};

}  // namespace

// res: S stacks of C channel planes of P = M x N int32 each, the planes
// contiguous, channel c of stack s at res + s * ss + c * cs; out (S, P)
// contiguous, written (accumulate 0) or added into (1).  tables: the host's
// kTableWords uint32 words (struct Tables).  Returns cudaGetLastError().
extern "C" int rns_decode_s32(const void* res, void* out, const void* tables,
                              int C, long long S, long long P, long long cs,
                              long long ss, int accumulate, void* stream) {
  if (C < 1 || C > kMaxC || S < 1 || P < 1) return (int)cudaErrorInvalidValue;
  Tables t;
  memcpy(&t, tables, sizeof(Tables));
  const int32_t* r = static_cast<const int32_t*>(res);
  int32_t* o = static_cast<int32_t*>(out);
  // 16-byte accesses where every plane of both sides starts on 16 bytes
  const int vec = reinterpret_cast<uintptr_t>(r) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(o) % 16 == 0 && cs % 4 == 0 &&
                  (S == 1 || (ss % 4 == 0 && P % 4 == 0));
  return kByChannels[C](r, o, t, S, P, cs, ss, vec, accumulate,
                        static_cast<cudaStream_t>(stream));
}
