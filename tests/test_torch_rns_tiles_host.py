"""The residue matmul's two schedules (kernel B1), run on the host.

``src/repro_torch/csrc/rns_tiles.cuh`` holds every index map of
``csrc/rns_matmul.cu``: which K rows and N columns each lane loads, the byte
transposes into mma fragments, the ldmatrix addresses, the swizzled stage
layout, the split-K plan and the output maps.  It compiles under a host
C++ compiler, so the harness below (built with g++ into a temporary
directory, loaded with ctypes) runs both schedules block by block, warp by
warp and lane by lane as the kernel launches them, and emulates the two
warp-wide instructions from the PTX ISA's documented layouts:

* ``mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32``: A register r, byte
  j of lane (g, t) is (row g + 8 (r & 1), k 4t + j + 16 (r >> 1)); B
  register r, byte j is (k 4t + j + 16 r, column g); C register r is (row
  g + 8 (r >> 1), column 2t + (r & 1));
* ``ldmatrix.sync.aligned.m8n8.x4.shared.b16``: lane l gives the address
  of row l % 8 of matrix l / 8; register j of lane i is the 4 bytes at
  2 (i % 4) halves into row i / 4 of matrix j.

The decode schedule's stream-K partials (a tile cut between blocks) are
combined through the same workspace, counters and last-block epilogue as
on the card, with the blocks run in a chosen order (every order of one
tile's blocks, random orders of many); the workspace and counters must be
zero again afterwards.
Results are held bit for bit against the port's plain version
``repro_torch.kernels.rns_matmul.rns_matmul_ref`` and, for two shapes,
against the JAX package's ``repro.kernels.ref.rns_matmul_ref``.

The tests skip when no ``g++`` is found.
"""
from __future__ import annotations

import ctypes
import itertools
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import moduli as jm
from repro.kernels.ref import rns_matmul_ref as jax_rns_matmul_ref
from repro_torch.core.moduli import P21, P21R2
from repro_torch.kernels import rns_matmul as trm

from torch_threads import one_thread  # noqa: F401

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
H100_SMS = 132
# the schedule constants the tests read from the header (host_consts)
CONSTS = ("kDecodeMaxM", "kStripN", "kPreBM", "kPreBN", "kPreBK", "kPreWarps",
          "kGroupsN", "kPreGroupM")

HARNESS = r"""
#include <algorithm>
#include <cassert>
#include <vector>

#include "rns_tiles.cuh"

using namespace rnt;

// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 over the 32 lanes of a
// warp: d[lane][r] += (A B)[row, col] with the PTX ISA's fragment layouts.
static void mma(int* const d[32], const uint32_t (*a)[4],
                const uint32_t (*b)[2]) {
  int A[16][32], B[32][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l >> 2, t = l & 3;
    for (int r = 0; r < 4; ++r)
      for (int j = 0; j < 4; ++j)
        A[g + 8 * (r & 1)][4 * t + j + 16 * (r >> 1)] =
            (int8_t)(a[l][r] >> (8 * j));
    for (int r = 0; r < 2; ++r)
      for (int j = 0; j < 4; ++j)
        B[4 * t + j + 16 * r][g] = (int8_t)(b[l][r] >> (8 * j));
  }
  for (int l = 0; l < 32; ++l) {
    const int g = l >> 2, t = l & 3;
    for (int r = 0; r < 4; ++r) {
      const int row = g + 8 * (r >> 1), col = 2 * t + (r & 1);
      int s = 0;
      for (int k = 0; k < 32; ++k) s += A[row][k] * B[k][col];
      d[l][r] += s;
    }
  }
}

// ldmatrix.sync.aligned.m8n8.x4.shared.b16: lane l gives the row address
// addr[l] of row l % 8 of matrix l / 8; register j of lane i holds the 4
// bytes at 4 (i % 4) of row i / 4 of matrix j.
static void ldsm_x4(uint32_t (*r)[4], const int8_t* smem, const int* addr) {
  for (int i = 0; i < 32; ++i)
    for (int j = 0; j < 4; ++j)
      memcpy(&r[i][j], smem + addr[8 * j + i / 4] + 4 * (i % 4), 4);
}

// ---- decode: one block of rns_decode_kernel<MT> --------------------------

template <int MT>
static void decode_block(const Args& g, const int* mods, const DecodePlan& pl,
                         int blk, int* counters, int* partial) {
  constexpr int kRows = 8 * MT;
  std::vector<int> s_acc(kRows * kAccPitch, 0);
  const int M = g.M, N = g.N;
  for (long long f = dec_run_begin(pl, blk); f < dec_run_end(pl, blk);) {
    const Segment sg = dec_segment(pl, blk, f);
    f += sg.s1 - sg.s0;
    const int c = dec_channel(pl, sg.t), m_c = mods[mod_of(g, c)];
    const int n0 = dec_strip(pl, sg.t);
    const int8_t* a = a_base(g, c);
    const int8_t* b = b_base(g, c);
    for (int warp = 0; warp < kDecWarps; ++warp) {
      static int acc[32][MT][8][4];
      memset(acc, 0, sizeof(acc));
      for (int j = 0; j < dec_warp_steps(sg.s0, sg.s1, warp); ++j) {
        const int k0 = dec_step(sg.s0, warp, j) * kStepK;
        static Row16 w[32][8];
        uint32_t x[MT][32][2];
        for (int l = 0; l < 32; ++l) {
          dec_load_w(g, b, k0, n0, l, w[l]);
          for (int mt = 0; mt < MT; ++mt)
            dec_load_x(g, a, k0, l, mt, x[mt][l]);
        }
        for (int word = 0; word < 4; ++word) {
          uint32_t lo[32][4], hi[32][4];
          for (int l = 0; l < 32; ++l) dec_frag_w(w[l], word, lo[l], hi[l]);
          for (int h = 0; h < 2; ++h) {
            uint32_t af[32][4];
            for (int l = 0; l < 32; ++l) {
              af[l][0] = lo[l][2 * h];
              af[l][1] = lo[l][2 * h + 1];
              af[l][2] = hi[l][2 * h];
              af[l][3] = hi[l][2 * h + 1];
            }
            for (int mt = 0; mt < MT; ++mt) {
              int* d[32];
              for (int l = 0; l < 32; ++l) d[l] = acc[l][mt][2 * word + h];
              mma(d, af, x[mt]);
            }
          }
        }
      }
      for (int l = 0; l < 32; ++l)
        for (int mt = 0; mt < MT; ++mt)
          for (int i = 0; i < 8; ++i)
            for (int r = 0; r < 4; ++r)
              s_acc[dec_acc(dec_out_m(l, mt, r), dec_out_n(l, i, r))] +=
                  acc[l][mt][i][r];
    }
    const long long base = (long long)c * M * N;
    const bool whole = tile_blocks(pl, sg.t) == 1;
    for (int i = 0; i < M * kStripN; ++i) {
      const int m = i / kStripN, n = i % kStripN;
      const int v = s_acc[dec_acc(m, n)];
      s_acc[dec_acc(m, n)] = 0;
      if (n0 + n < N) {
        const long long o = base + (long long)m * N + n0 + n;
        if (whole)
          g.out[o] = center_rem(v, m_c);
        else
          partial[o] += v;
      }
    }
    for (int v : s_acc) assert(v == 0);
    if (whole || counters[sg.t]++ != tile_blocks(pl, sg.t) - 1) continue;
    for (int i = 0; i < M * kStripN; ++i) {
      const int m = i / kStripN, n = n0 + i % kStripN;
      if (n < N) {
        const long long o = base + (long long)m * N + n;
        g.out[o] = center_rem(partial[o], m_c);
        partial[o] = 0;
      }
    }
    counters[sg.t] = 0;
  }
}

// ---- prefill: one block of rns_prefill_kernel ----------------------------

// cp.async with src-size `valid` (or byte loads): the rest is zero
static void stage_copy(int8_t* st, const int8_t* base, const Copy& cp) {
  const Row16 r = cp.valid ? load16_bytes(base + cp.src, cp.valid)
                           : Row16{{0u, 0u, 0u, 0u}};
  memcpy(st + cp.smem, &r, 16);
}

static void prefill_block(const Args& g, const int* mods, int bid) {
  std::vector<int8_t> smem(kPreSmem, 0x5a);
  const PreTile tile = pre_tile(g.M, g.N, bid);
  const int c = tile.c, m0 = tile.m0, n0 = tile.n0;
  const int8_t* a = a_base(g, c);
  const int8_t* b = b_base(g, c);
  const int ktiles = ceil_div(g.K, kPreBK);
  static int acc[kPreWarps][32][4][4 * kGroupsN][4];
  memset(acc, 0, sizeof(acc));
  for (int kt = 0; kt < ktiles; ++kt) {
    int8_t* st = smem.data() + (kt % kPreStages) * kStageBytes;
    const int k0 = kt * kPreBK;
    for (int tid = 0; tid < kPreThreads; ++tid) {
      for (int q = 0; q < kCopiesA; ++q)
        stage_copy(st, a, pre_copy_a(g, m0, k0, tid, q));
      for (int q = 0; q < kCopiesB; ++q)
        stage_copy(st, b, pre_copy_b(g, n0, k0, tid, q));
    }
    for (int warp = 0; warp < kPreWarps; ++warp)
      for (int kk = 0; kk < kPreBK / 32; ++kk) {
        uint32_t bf[32][kGroupsN][4][2];
        for (int l = 0; l < 32; ++l)
          for (int grp = 0; grp < kGroupsN; ++grp)
            pre_frag_b(st + kStageA, warp, l, kk, grp, bf[l][grp]);
        for (int mi = 0; mi < 4; ++mi) {
          int addr[32];
          for (int l = 0; l < 32; ++l) addr[l] = pre_ldsm_a(warp, l, mi, kk);
          uint32_t af[32][4];
          ldsm_x4(af, st, addr);
          for (int j = 0; j < 4 * kGroupsN; ++j) {
            uint32_t bj[32][2];
            int* d[32];
            for (int l = 0; l < 32; ++l) {
              bj[l][0] = bf[l][j >> 2][j & 3][0];
              bj[l][1] = bf[l][j >> 2][j & 3][1];
              d[l] = acc[warp][l][mi][j];
            }
            mma(d, af, bj);
          }
        }
      }
  }
  const int m_c = mods[mod_of(g, c)];
  int32_t* o = g.out + (long long)c * g.M * g.N;
  for (int warp = 0; warp < kPreWarps; ++warp)
    for (int l = 0; l < 32; ++l)
      for (int mi = 0; mi < 4; ++mi)
        for (int h = 0; h < 2; ++h)
        for (int grp = 0; grp < kGroupsN; ++grp) {
          const int m = m0 + pre_out_m(warp, l, mi, 2 * h);
          const int n = n0 + pre_out_n(warp, l, 4 * grp, 2 * h);
          if (m >= g.M) continue;
          int v[8];
          pre_row_values(acc[warp][l], mi, h, grp, m_c, v);
          for (int q = 0; q < 8; ++q)
            if (n + q < g.N) o[(long long)m * g.N + n + q] = v[q];
        }
}

// rns_matmul_s8's arguments (S stacked products of C channels), run on the
// host with `sms` SMs.  Decode blocks run in `order` when given.  Returns
// the decode plan's blocks (0 for the prefill), -1 for a workspace too
// small.
extern "C" int host_matmul(const int8_t* a, const int8_t* b, int32_t* out,
                           int* ws, long long ws_bytes, const int* mods,
                           int S, int C, int M, int N, int K, long long a_ss,
                           long long a_sc, long long lda, long long b_ss,
                           long long b_sc, long long ldb, int sms,
                           const int* order) {
  Args g{a, b, out, C, M, N, K, a_ss, a_sc, lda, b_ss, b_sc, ldb,
         vec_width(reinterpret_cast<uintptr_t>(a), a_ss, a_sc, lda),
         vec_width(reinterpret_cast<uintptr_t>(b), b_ss, b_sc, ldb)};
  const int F = S * C;
  if (M > kDecodeMaxM) {
    for (int bid = 0; bid < prefill_blocks(F, M, N); ++bid)
      prefill_block(g, mods, bid);
    return 0;
  }
  const DecodePlan pl = decode_plan(F, N, K, sms);
  if (decode_workspace_bytes(F, M, N, pl) > ws_bytes) return -1;
  int* counters = ws;
  int* partial = ws + (decode_counter_ints(F, pl) + 3) / 4 * 4;
  for (int i = 0; i < pl.blocks; ++i) {
    const int blk = order ? order[i] : i;
    if (M <= 8)
      decode_block<1>(g, mods, pl, blk, counters, partial);
    else
      decode_block<2>(g, mods, pl, blk, counters, partial);
  }
  return pl.blocks;
}

// decode_plan: {tiles_n, ksteps, blocks, total, shortest run, workspace
// bytes, most blocks on one tile}.
extern "C" void host_plan(int C, int M, int N, int K, int sms,
                          long long* res) {
  const DecodePlan p = decode_plan(C, N, K, sms);
  res[0] = p.tiles_n;
  res[1] = p.ksteps;
  res[2] = p.blocks;
  res[3] = p.total;
  long long shortest = p.total;
  for (int b = 0; b < p.blocks; ++b)
    shortest = std::min(shortest, dec_run_end(p, b) - dec_run_begin(p, b));
  res[4] = shortest;
  res[5] = decode_workspace_bytes(C, M, N, p);
  int most = 0;
  for (int t = 0; t < C * p.tiles_n; ++t)
    most = std::max(most, tile_blocks(p, t));
  res[6] = most;
}

// pre_tile of every block: (c, m0, n0) triples.
extern "C" int host_tiles(int C, int M, int N, int* res) {
  const int n = prefill_blocks(C, M, N);
  for (int bid = 0; bid < n; ++bid) {
    const PreTile t = pre_tile(M, N, bid);
    res[3 * bid] = t.c;
    res[3 * bid + 1] = t.m0;
    res[3 * bid + 2] = t.n0;
  }
  return n;
}

// The schedule constants, in the order of the test's CONSTS.
extern "C" void host_consts(int* res) {
  const int v[] = {kDecodeMaxM, kStripN, kPreBM, kPreBN, kPreBK, kPreWarps,
                   kGroupsN, kPreGroupM};
  for (int i = 0; i < 8; ++i) res[i] = v[i];
}

// Shared-memory banks (4-byte words mod 32) of one warp-wide access: the
// prefill's B fragment reads (kind 0: warp, kk, 2 grp + h, r), each 8-row
// phase of its A ldmatrix (kind 1: warp, mi, kk, matrix r), the decode's
// atomicAdd into the block sum (kind 2: mt, tile, r).  Writes 32 bank
// numbers (kind 1: the 4 banks of each of 8 16-byte rows).
extern "C" void host_banks(int kind, int warp, int x, int kk, int r,
                           int* banks) {
  if (kind == 0) {
    for (int l = 0; l < 32; ++l)
      banks[l] =
          (kStageA + pre_b_addr(warp, l, kk, x >> 1, x & 1, r)) / 4 % 32;
  } else if (kind == 2) {
    // the decode's shared atomicAdd of (mt = warp, tile i = x, register r)
    for (int l = 0; l < 32; ++l)
      banks[l] = dec_acc(dec_out_m(l, warp, r), dec_out_n(l, x, r)) % 32;
  } else {
    for (int i = 0; i < 8; ++i)
      for (int w = 0; w < 4; ++w)
        banks[4 * i + w] = (pre_ldsm_a(warp, 8 * r + i, x, kk) / 4 + w) % 32;
  }
}

"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host harness")
    d = tmp_path_factory.mktemp("rns_tiles_host")
    src, so = d / "harness.cpp", d / "harness.so"
    src.write_text(HARNESS)
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    f"-I{CSRC}", str(src), "-o", str(so)], check=True,
                   capture_output=True, timeout=300)
    h = ctypes.CDLL(str(so))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    h.host_matmul.argtypes = [P, P, P, P, L, P, I, I, I, I, I, L, L, L, L,
                              L, L, I, P]
    h.host_matmul.restype = I
    h.host_plan.argtypes = [I, I, I, I, I, P]
    h.host_tiles.argtypes = [I, I, I, P]
    h.host_banks.argtypes = [I, I, I, I, I, P]
    h.host_consts.argtypes = [P]
    res = (ctypes.c_int * len(CONSTS))()
    h.host_consts(res)
    h.consts = dict(zip(CONSTS, res))
    return h


def _plan(lib, C, M, N, K, sms):
    res = (ctypes.c_longlong * 7)()
    lib.host_plan(C, M, N, K, sms, res)
    return dict(zip(("tiles_n", "ksteps", "blocks", "total", "shortest",
                     "bytes", "most_per_tile"), res))


def _host(lib, a, b, moduli, sms=H100_SMS, order=None):
    """The kernel's schedule on numpy (C, M, K) x (C, K, N) int8 views, or a
    stack (S, C, M, K) x (S, C, K, N) in one launch (innermost axis
    contiguous); returns (out, the decode plan or None) and checks that the
    workspace is zero again."""
    stacked = a.ndim == 4
    a4, b4 = (a, b) if stacked else (a[None], b[None])
    S, C, M, K = a4.shape
    N = b4.shape[3]
    assert a4.strides[3] == 1 and b4.strides[3] == 1
    decode = M <= lib.consts["kDecodeMaxM"]
    nbytes = _plan(lib, S * C, M, N, K, sms)["bytes"] if decode else 0
    ws = np.zeros(max(nbytes // 4, 1), np.int32)
    out = np.full((S, C, M, N), 0x7eadbeef, np.int32)
    mods = (ctypes.c_int * C)(*moduli)
    ordp = None
    if order is not None:
        order = np.ascontiguousarray(order, np.int32)
        ordp = order.ctypes.data
    a_ss, b_ss = (a4.strides[0], b4.strides[0]) if S > 1 else (0, 0)
    blocks = lib.host_matmul(a4.ctypes.data, b4.ctypes.data,
                             out.ctypes.data, ws.ctypes.data, nbytes, mods,
                             S, C, M, N, K, a_ss, a4.strides[1],
                             a4.strides[2], b_ss, b4.strides[1],
                             b4.strides[2], sms, ordp)
    assert blocks >= 0
    assert not ws.any(), "the workspace must be left zero"
    return (out if stacked else out[0]), (
        _plan(lib, S * C, M, N, K, sms) if decode else None)


def _planes(rng, C, M, K, N, moduli):
    half = np.array(moduli).reshape(-1, 1, 1) // 2
    a = rng.integers(-half, half + 1, (C, M, K)).astype(np.int8)
    b = rng.integers(-half, half + 1, (C, K, N)).astype(np.int8)
    return a, b


def _reference(a, b, moduli):
    return trm.rns_matmul_ref(torch.from_numpy(np.ascontiguousarray(a)),
                              torch.from_numpy(np.ascontiguousarray(b)),
                              moduli).numpy()


@pytest.mark.parametrize("M", [1, 2, 8, 9, 16, 17])
@pytest.mark.parametrize("K,N", [(129, 65), (4160, 130)])
def test_schedules_equal_reference(lib, M, K, N):
    """The decode schedule (M <= 16: one or two activation column blocks)
    and, at M 17, the prefill schedule: K 129 and N 65 leave ragged steps
    and strips; at K 4160 the H100's 132 SMs cut every tile between
    blocks."""
    assert lib.consts["kDecodeMaxM"] == 16, "the cases straddle M 16 | 17"
    rng = np.random.default_rng(1000 * M + K)
    a, b = _planes(rng, 3, M, K, N, P21.moduli)
    out, plan = _host(lib, a, b, P21.moduli)
    np.testing.assert_array_equal(out, _reference(a, b, P21.moduli))
    if plan is not None and K == 4160:
        assert plan["most_per_tile"] > 1


@pytest.mark.parametrize("M", [8, 17])
def test_schedules_equal_jax_reference(lib, M):
    """Both schedules against the JAX package's reference."""
    rng = np.random.default_rng(M)
    a, b = _planes(rng, 3, M, 300, 200, P21.moduli)
    ref = np.asarray(jax.jit(jax_rns_matmul_ref, static_argnums=2)(
        jnp.asarray(a), jnp.asarray(b), jm.P21))
    np.testing.assert_array_equal(_host(lib, a, b, P21.moduli)[0], ref)


@pytest.mark.parametrize("M,K,N", [(130, 129, 300), (256, 200, 129),
                                   (40, 64, 256)])
def test_prefill_tiles(lib, M, K, N):
    """Prefill at a ragged 128-row tile pair, a K tile and a ragged one,
    columns that do not fill the last 256-wide tile or its last 16-byte
    chunk, and an exact tile."""
    rng = np.random.default_rng(M + K + N)
    a, b = _planes(rng, 3, M, K, N, P21.moduli)
    np.testing.assert_array_equal(_host(lib, a, b, P21.moduli)[0],
                                  _reference(a, b, P21.moduli))


@pytest.mark.parametrize("M", [8, 17])
def test_wide_n(lib, M):
    """N 14576 (zamba2's in_proj): 114 strips, the last one ragged."""
    rng = np.random.default_rng(M)
    a, b = _planes(rng, 3, M, 96, 14576, P21.moduli)
    np.testing.assert_array_equal(_host(lib, a, b, P21.moduli)[0],
                                  _reference(a, b, P21.moduli))


@pytest.mark.parametrize("M", [2, 16, 20])
def test_p21r2_and_int8_extremes(lib, M):
    """C 5 with P21R2's moduli, operands at the int8 extremes (-128, 127)
    and at the widest modulus's (+-66): the largest exact accumulators."""
    rng = np.random.default_rng(M)
    C, K, N = 5, 700, 150
    a = rng.choice(np.array([-128, 127, -66, 66], np.int8), (C, M, K))
    b = rng.choice(np.array([-128, 127, -66, 66], np.int8), (C, K, N))
    a[:, 0, :] = -128
    b[:, :, 0] = -128
    out, _ = _host(lib, a, b, P21R2.moduli, sms=4)
    np.testing.assert_array_equal(out, _reference(a, b, P21R2.moduli))


@pytest.mark.parametrize("dk", [-1, 0, 1])
def test_run_boundary(lib, dk):
    """K around a block boundary: 3 channels of one tile on two blocks (two
    SMs) give 72-step runs at K 1536 (48 steps a tile), so tile 1 is cut
    between the blocks at its 24th step; K 1535 ends inside the last step,
    K 1537 adds a step (runs of 73 and 74) and moves the cut."""
    K = 1536 + dk
    p = _plan(lib, 3, 8, 128, K, 2)
    assert p["blocks"] == 2 and p["most_per_tile"] == 2 and p["bytes"] > 0
    rng = np.random.default_rng(K)
    a, b = _planes(rng, 3, 8, K, 128, P21.moduli)
    out, _ = _host(lib, a, b, P21.moduli, sms=2)
    np.testing.assert_array_equal(out, _reference(a, b, P21.moduli))


def test_whole_tiles_need_no_workspace(lib):
    """Runs that are whole tiles (3 channels x 2 tiles x 8 steps on 6
    blocks, the last tile ragged) cut nothing: no workspace, every block
    finishes its own tile."""
    p = _plan(lib, 3, 8, 200, 256, 6)
    assert p["shortest"] == p["ksteps"] == 8 and p["bytes"] == 0
    rng = np.random.default_rng(5)
    a, b = _planes(rng, 3, 8, 256, 200, P21.moduli)
    out, _ = _host(lib, a, b, P21.moduli, sms=6)
    np.testing.assert_array_equal(out, _reference(a, b, P21.moduli))


def test_combine_in_every_order(lib):
    """One tile cut across 4 blocks, run in each of the 24 orders, then 3
    channels x 2 tiles on 4 blocks (runs that cross tile boundaries) in
    random orders: the last block to arrive at a tile finishes it, the
    result is the same and the workspace ends at zero."""
    rng = np.random.default_rng(3)
    a, b = _planes(rng, 1, 5, 1024, 100, P21.moduli[:1])
    ref = _reference(a, b, P21.moduli[:1])
    p = _plan(lib, 1, 5, 100, 1024, 4)
    assert p["blocks"] == 4 and p["most_per_tile"] == 4
    for order in itertools.permutations(range(4)):
        out, _ = _host(lib, a, b, P21.moduli[:1], sms=4, order=order)
        np.testing.assert_array_equal(out, ref)
    a, b = _planes(rng, 3, 12, 1000, 200, P21.moduli)
    ref = _reference(a, b, P21.moduli)
    p = _plan(lib, 3, 12, 200, 1000, 4)
    assert p["tiles_n"] == 2 and p["most_per_tile"] > 1
    for seed in range(4):
        order = np.random.default_rng(seed).permutation(p["blocks"])
        out, _ = _host(lib, a, b, P21.moduli, sms=4, order=order)
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("lo,hi", [(0, 200), (128, 390), (37, 250)])
@pytest.mark.parametrize("M", [8, 17])
def test_k_segment_views(lib, lo, hi, M):
    """A K segment as a strided view of both operands, as ``rns_run``
    passes it: the whole, a 128-aligned offset (16-byte copies) and an odd
    one (byte loads for A; B's rows stay aligned)."""
    rng = np.random.default_rng(lo + hi + M)
    a, b = _planes(rng, 3, M, 400, 144, P21.moduli)
    av, bv = a[:, :, lo:hi], b[:, lo:hi]
    out, _ = _host(lib, av, bv, P21.moduli, sms=2)
    np.testing.assert_array_equal(out, _reference(av, bv, P21.moduli))


def test_shared_accesses_are_conflict_free(lib):
    """Every warp-wide shared access of the mma steps touches 32 distinct
    banks: the prefill's B fragment reads of the swizzled stage rows (four
    rows 4t + r at once), each 8-row phase of its A ldmatrix.x4 at the
    80-byte pitch, and the decode's atomicAdd of each accumulator register
    into the block sum."""
    k = lib.consts
    banks = np.zeros(32, np.int32)
    for mt, i, r in itertools.product(range(k["kDecodeMaxM"] // 8),
                                      range(k["kStripN"] // 16), range(4)):
        lib.host_banks(2, mt, i, 0, r, banks.ctypes.data)
        assert len(set(banks)) == 32, ("acc", mt, i, r, banks)
    for warp, kk in itertools.product(range(k["kPreWarps"]),
                                      range(k["kPreBK"] // 32)):
        for gh, r in itertools.product(range(2 * k["kGroupsN"]), range(4)):
            lib.host_banks(0, warp, gh, kk, r, banks.ctypes.data)
            assert len(set(banks)) == 32, ("B", warp, kk, gh, r, banks)
        for mi, mat in itertools.product(range(4), range(4)):
            lib.host_banks(1, warp, mi, kk, mat, banks.ctypes.data)
            assert len(set(banks)) == 32, ("A", warp, kk, mi, mat, banks)


@pytest.mark.parametrize("C", [3, 5])
def test_decode_plan_fills_the_h100(lib, C):
    """At M 8 every projection of qwen3-8b and zamba2-7b runs on exactly
    the blocks the H100 holds at once (one an SM; k/v at N 1024 and down at
    K 12288 included), with runs that differ by at most one K step."""
    shapes = [(4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096),
              (4096, 151936), (3584, 14576), (7168, 3584), (3584, 3584),
              (3584, 14336), (14336, 3584), (3584, 32000)]
    for K, N in shapes:
        p = _plan(lib, C, 8, N, K, H100_SMS)
        assert p["blocks"] == H100_SMS, (K, N, p)
        assert p["shortest"] == p["total"] // p["blocks"] >= 1, (K, N, p)


def test_prefill_rasterization_covers_each_tile_once(lib):
    """pre_tile maps the 1-D grid onto every (channel, M tile, N tile) once,
    M tiles fastest inside groups of kPreGroupM (a ragged last group
    included)."""
    bm, bn, gm = (lib.consts[x] for x in ("kPreBM", "kPreBN", "kPreGroupM"))
    for C, M, N in ((3, 2048, 12288), (2, 2100, 300), (5, 17, 129)):
        tm, tn = -(-M // bm), -(-N // bn)
        res = np.zeros(3 * C * tm * tn, np.int32)
        n = lib.host_tiles(C, M, N, res.ctypes.data)
        assert n == C * tm * tn
        tiles = {tuple(t) for t in res.reshape(-1, 3)}
        assert tiles == {(c, bm * i, bn * j) for c in range(C)
                         for i in range(tm) for j in range(tn)}
        if tm >= gm:
            t = res.reshape(-1, 3)
            assert [x[1] for x in t[:gm]] == [bm * i for i in range(gm)]
            assert all(x[2] == 0 for x in t[:gm])


def _stack(rng, S, C, M, K, N, moduli):
    pairs = [_planes(rng, C, M, K, N, moduli) for _ in range(S)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


@pytest.mark.parametrize("M", [1, 8, 16, 17, 40])
def test_stack_equals_slices(lib, M):
    """Stack mode: S products in one launch over S x C folded channels, on
    both schedules (decode through M 16, the prefill tile above), each
    slice bit-identical to its own launch and to the plain version's stack
    loop.  Four SMs cut the folded tiles across slices, so a stream-K run
    crosses from one slice into the next."""
    rng = np.random.default_rng(M)
    a, b = _stack(rng, 5, 3, M, 200, 144, P21.moduli)
    out, plan = _host(lib, a, b, P21.moduli, sms=4)
    np.testing.assert_array_equal(
        out, trm.rns_matmul_ref(torch.from_numpy(a), torch.from_numpy(b),
                                P21.moduli).numpy())
    for s_ in range(5):
        np.testing.assert_array_equal(
            out[s_], _host(lib, a[s_], b[s_], P21.moduli, sms=4)[0])
    if plan is not None:
        assert plan["tiles_n"] == 2 and plan["total"] == 5 * 3 * 2 * 7


@pytest.mark.parametrize("lo,hi", [(0, 300), (128, 300), (37, 250)])
@pytest.mark.parametrize("M", [8, 24])
def test_stack_of_strided_views(lib, lo, hi, M):
    """The operands as the stacked ``rns_run`` passes them: the activation's
    residues channel-major ``(C, S, M, K)`` seen as ``(S, C, M, K)`` (stack
    stride below the channel stride), K segments of both as strided views
    (the whole, a 128-aligned offset and an odd one, which loads bytes)."""
    rng = np.random.default_rng(lo + hi + M)
    S, C = 4, 3
    a_cs = rng.integers(-64, 65, (C, S, M, 300)).astype(np.int8)
    _, b = _stack(rng, S, C, M, 300, 136, P21.moduli)
    av = a_cs.transpose(1, 0, 2, 3)[..., lo:hi]
    bv = b[:, :, lo:hi]
    out, _ = _host(lib, av, bv, P21.moduli, sms=3)
    for s_ in range(S):
        np.testing.assert_array_equal(out[s_], _reference(av[s_], bv[s_],
                                                          P21.moduli))


def test_stack_plan_at_moonshot_shapes(lib):
    """moonshot-v1-16b-a3b's expert einsums at decode (64 experts x 3
    channels folded, M 8): (K, N) (2048, 1408) for gate and up, (1408,
    2048) for down; every block of the H100 busy, runs within one K step
    of each other; and the prefill grid at M 240 covers every folded tile
    once."""
    for K, N in ((2048, 1408), (1408, 2048)):
        p = _plan(lib, 64 * 3, 8, N, K, H100_SMS)
        assert p["blocks"] == H100_SMS
        assert p["total"] == 64 * 3 * -(-N // 128) * (K // 32)
        assert p["shortest"] == p["total"] // p["blocks"]
    bm, bn = lib.consts["kPreBM"], lib.consts["kPreBN"]
    F, M, N = 64 * 3, 240, 1408
    tm, tn = -(-M // bm), -(-N // bn)
    res = np.zeros(3 * F * tm * tn, np.int32)
    assert lib.host_tiles(F, M, N, res.ctypes.data) == F * tm * tn
    assert {tuple(t) for t in res.reshape(-1, 3)} == {
        (f, bm * i, bn * j) for f in range(F) for i in range(tm)
        for j in range(tn)}
