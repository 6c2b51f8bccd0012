"""The SD matmul's packed arithmetic and schedule (kernels B6 and B7), run on
the host.

``src/repro_torch/csrc/sd_digits.cuh`` holds everything the two kernels
compute: the packed +/- mask add, the Eq. 2 leaves, the digit and K trees,
and the per-block and per-thread steps of the chunk and join passes.  It
compiles under a host C++ compiler, so the small harness below (built
with g++ into a temporary directory and loaded with ctypes) runs the
kernels' schedule block by block and thread by thread, as
``csrc/sdrns_matmul.cu`` launches it, without a card.

* The packed add is checked exhaustively against
  ``repro_torch.core.sdrns.modular_add``: every pair of digit vectors, n 5
  and 7, all three kinds.
* The whole schedule is checked digit for digit on random digits from a
  seed against the JAX package's ``repro.kernels.ref.sdrns_matmul_ref``
  (jitted; four chunks with a ragged last one, n 5 and 7, every M from 1
  to 9 as rows of one call), and, where each new shape would cost the JAX
  reference seconds of compilation, against the port's plain version
  ``repro_torch.kernels.sdrns_matmul.sdrns_matmul_ref`` (held to the JAX
  kernels by tests/test_torch_sdrns_matmul.py): K around the chunk size
  (64 leaves), M around B7's 8 rows, ragged N, K segment views, and rows
  run in several passes.

The tests skip when no ``g++`` is found.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import moduli as jm
from repro.kernels.ref import sdrns_matmul_ref
from repro_torch.core import sdrns
from repro_torch.kernels import sdrns_matmul as tsm

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
CHUNK = 64                     # sdk::kChunk
WS = (1, 0, -1)                # P21 / P16 channel order
MSETS = {5: jm.P16, 7: jm.P21}

HARNESS = r"""
#include <vector>

#include "sd_digits.cuh"

using namespace sdk;

template <int N, int WS>
static void add_all(long long count, const int8_t* x, const int8_t* y,
                    int8_t* out) {
  for (long long v0 = 0; v0 < count; v0 += kLanes) {
    Vec a{0, 0}, b{0, 0};
    for (int l = 0; l < kLanes && v0 + l < count; ++l)
      for (int i = 0; i < N; ++i) {
        const int8_t dx = x[(v0 + l) * N + i], dy = y[(v0 + l) * N + i];
        a.z |= (uint32_t)(dx != 0) << (8 * l + i);
        a.s |= (uint32_t)(dx < 0) << (8 * l + i);
        b.z |= (uint32_t)(dy != 0) << (8 * l + i);
        b.s |= (uint32_t)(dy < 0) << (8 * l + i);
      }
    const Vec s = add<N, WS>(a, b);
    for (int l = 0; l < kLanes && v0 + l < count; ++l)
      for (int i = 0; i < N; ++i)
        out[(v0 + l) * N + i] =
            (int8_t)((s.z >> (8 * l + i)) & 1 ? 1 - 2 * ((s.s >> (8 * l + i)) & 1)
                                               : 0);
  }
}

template <int N>
static int add_n(int ws, long long count, const int8_t* x, const int8_t* y,
                 int8_t* out) {
  if (ws == 1) add_all<N, 1>(count, x, y, out);
  else if (ws == 0) add_all<N, 0>(count, x, y, out);
  else add_all<N, -1>(count, x, y, out);
  return 0;
}

extern "C" int packed_add(int n, int ws, long long count, const int8_t* x,
                          const int8_t* y, int8_t* out) {
  if (n == 5) return add_n<5>(ws, count, x, y, out);
  if (n == 7) return add_n<7>(ws, count, x, y, out);
  return -1;
}

// One block of the chunk pass: every thread stages (before the barrier),
// then every thread runs its mask word.
template <int N, int WS, int R>
static void chunk_block(const MatmulArgs& g, int c, int r0, int chunk,
                        int tile) {
  std::vector<uint32_t> srot(kChunk * R * kRotStride<N>);
  for (int tid = 0; tid < kThreads; ++tid)
    stage<N, WS, R>(g, c, r0, chunk, tid, kThreads, srot.data());
  for (int tid = 0; tid < kThreads; ++tid) {
    const int w = tile * kThreads + tid;
    if (w < g.words) chunk_word<N, WS, R>(g, c, r0, chunk, w, srot.data());
  }
}

template <int N, int WS>
static void run_channel(const MatmulArgs& g, const Plan& pl, int c) {
  for (int chunk = 0; chunk < g.chunks; ++chunk)
    for (int r0 = 0; r0 < g.rows; r0 += pl.R)
      for (int tile = 0; tile < pl.col_tiles; ++tile) switch (pl.R) {
          case 1: chunk_block<N, WS, 1>(g, c, r0, chunk, tile); break;
          case 2: chunk_block<N, WS, 2>(g, c, r0, chunk, tile); break;
          case 4: chunk_block<N, WS, 4>(g, c, r0, chunk, tile); break;
          default: chunk_block<N, WS, 8>(g, c, r0, chunk, tile); break;
        }
  for (int m = 0; m < g.rows; ++m)
    for (int w = 0; w < g.words; ++w) join_word<N, WS>(g, c, m, w);
}

template <int N>
static void run_pass(const MatmulArgs& g, const Plan& pl, const int* ws,
                     int C) {
  for (int c = 0; c < C; ++c) {
    if (ws[c] == 1) run_channel<N, 1>(g, pl, c);
    else if (ws[c] == 0) run_channel<N, 0>(g, pl, c);
    else run_channel<N, -1>(g, pl, c);
  }
}

// sdrns_matmul_s8's arguments, run on the host; root_budget overrides the
// workspace budget (0: the kernels' own); returns the passes run.
extern "C" int host_matmul(const int8_t* a, const int8_t* b, int8_t* out,
                           const int* ws, int C, int M, int cols, int K,
                           int n, long long a_cs, long long lda,
                           long long b_cs, long long ldb, int matvec,
                           long long root_budget) {
  const Plan pl = plan(C, M, cols, K, matvec != 0,
                       root_budget > 0 ? root_budget : kRootBudget);
  std::vector<Vec> roots(pl.root_bytes / sizeof(Vec));
  const bool aligned = reinterpret_cast<uintptr_t>(b) % 4 == 0 &&
                       b_cs % 4 == 0 && ldb % 4 == 0;
  int passes = 0;
  for (int m0 = 0; m0 < M; m0 += pl.rows_pass, ++passes) {
    MatmulArgs g{a, b, out, roots.data(), M, cols, K, a_cs, lda, b_cs, ldb,
                 m0, M - m0 < pl.rows_pass ? M - m0 : pl.rows_pass,
                 pl.words, pl.chunks, aligned ? 1 : 0};
    if (n == 5) run_pass<5>(g, pl, ws, C);
    else if (n == 7) run_pass<7>(g, pl, ws, C);
    else return -1;
  }
  return passes;
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host harness")
    d = tmp_path_factory.mktemp("sd_digits_host")
    src, so = d / "harness.cpp", d / "harness.so"
    src.write_text(HARNESS)
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    f"-I{CSRC}", str(src), "-o", str(so)], check=True,
                   capture_output=True, timeout=300)
    h = ctypes.CDLL(str(so))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    h.packed_add.argtypes = [I, I, L, P, P, P]
    h.host_matmul.argtypes = [P, P, P, P, I, I, I, I, I, L, L, L, L, I, L]
    return h


def _all_vectors(n):
    """Every digit vector of n digits, (3^n, n) int8."""
    idx = np.arange(3 ** n)
    return np.stack([(idx // 3 ** i) % 3 - 1 for i in range(n)],
                    axis=1).astype(np.int8)


@pytest.mark.parametrize("n", [5, 7])
@pytest.mark.parametrize("kind", ["pow2m1", "pow2", "pow2p1"])
def test_packed_add_exhaustive(lib, n, kind):
    """Every (x, y) pair of n-digit vectors: the packed add's digits equal
    the int-per-digit rule's."""
    v = _all_vectors(n)
    x = np.ascontiguousarray(np.repeat(v, len(v), axis=0))
    y = np.ascontiguousarray(np.tile(v, (len(v), 1)))
    out = np.empty_like(x)
    assert lib.packed_add(n, sdrns.WRAP_SIGNS[kind], len(x), x.ctypes.data,
                          y.ctypes.data, out.ctypes.data) == 0
    ref = sdrns.modular_add(torch.from_numpy(x), torch.from_numpy(y), kind)
    np.testing.assert_array_equal(out, ref.numpy())


def _host(lib, a, b, matvec, budget=0):
    """The kernels' schedule on numpy (C, M, K, n) x (C, K, N, n) views
    (last two axes contiguous); returns (digits, passes)."""
    C, M, K, n = a.shape
    N = b.shape[2]
    assert a.strides[3] == 1 and a.strides[2] == n
    assert b.strides[3] == 1 and b.strides[2] == n
    out = np.full((C, M, N, n), 99, np.int8)
    ws = (ctypes.c_int * C)(*WS)
    passes = lib.host_matmul(a.ctypes.data, b.ctypes.data, out.ctypes.data,
                             ws, C, M, N, K, n, a.strides[0], a.strides[1],
                             b.strides[0], b.strides[1], int(matvec), budget)
    assert passes >= 1
    return out, passes


def _reference(a, b):
    return tsm.sdrns_matmul_ref(torch.from_numpy(np.ascontiguousarray(a)),
                                torch.from_numpy(np.ascontiguousarray(b)),
                                WS).numpy()


@pytest.mark.parametrize("n,N", [(7, 13), (5, 9)])
def test_schedule_equals_jax_reference(lib, n, N):
    """Four chunks, the last ragged (K 197), against the JAX package's
    reference: every M from 1 to 9 (B7 for M <= 8: one block of 1, 2, 4
    or 8 rows) on the first M rows of one call."""
    rng = np.random.default_rng(n)
    K = 3 * CHUNK + 5
    a = rng.integers(-1, 2, (3, 9, K, n)).astype(np.int8)
    b = rng.integers(-1, 2, (3, K, N, n)).astype(np.int8)
    ref = np.asarray(jax.jit(sdrns_matmul_ref, static_argnums=2)(
        a, b, MSETS[n]))
    for M in range(1, 10):
        am = np.ascontiguousarray(a[:, :M])
        np.testing.assert_array_equal(_host(lib, am, b, False)[0],
                                      ref[:, :M])
        if M <= 8:
            np.testing.assert_array_equal(_host(lib, am, b, True)[0],
                                          ref[:, :M])


@pytest.mark.parametrize("M", [1, 2, 8, 9])
@pytest.mark.parametrize("K", [1, 2, CHUNK - 1, CHUNK, CHUNK + 1,
                               3 * CHUNK + 5])
def test_schedule_equals_reference(lib, M, K):
    """B6's schedule (rows tiled by 8) and B7's (every row in one block,
    M <= 8) give the reference's digit vectors: one chunk, one complete
    chunk, a chunk and one leaf, four chunks with a ragged last one; N 13
    leaves the last mask word one column (and the B rows unaligned)."""
    rng = np.random.default_rng(100 * M + K)
    N, n = 13, 7
    a = rng.integers(-1, 2, (3, M, K, n)).astype(np.int8)
    b = rng.integers(-1, 2, (3, K, N, n)).astype(np.int8)
    ref = _reference(a, b)
    np.testing.assert_array_equal(_host(lib, a, b, False)[0], ref)
    if M <= 8:
        np.testing.assert_array_equal(_host(lib, a, b, True)[0], ref)


@pytest.mark.parametrize("n,M,K,N", [(5, 3, 200, 9), (5, 9, 64, 4),
                                     (7, 2, 130, 520), (7, 5, 300, 8)])
def test_schedule_widths_and_column_tiles(lib, n, M, K, N):
    """Five digits (P16); N 520 spans two column tiles of 128 words; N a
    multiple of 4 takes the aligned B loads."""
    rng = np.random.default_rng(n * 1000 + K)
    a = rng.integers(-1, 2, (3, M, K, n)).astype(np.int8)
    b = rng.integers(-1, 2, (3, K, N, n)).astype(np.int8)
    ref = _reference(a, b)
    np.testing.assert_array_equal(_host(lib, a, b, False)[0], ref)
    if M <= 8:
        np.testing.assert_array_equal(_host(lib, a, b, True)[0], ref)


@pytest.mark.parametrize("lo,hi", [(0, 150), (37, 250), (64, 193)])
def test_schedule_on_k_segment_views(lib, lo, hi):
    """A K segment as a strided view of both operands (a chunk-aligned and
    an unaligned offset): the chunks start at the segment, not at the
    parent's K."""
    rng = np.random.default_rng(lo + hi)
    a = rng.integers(-1, 2, (3, 6, 260, 7)).astype(np.int8)
    b = rng.integers(-1, 2, (3, 260, 12, 7)).astype(np.int8)
    av, bv = a[:, :, lo:hi], b[:, lo:hi]
    ref = _reference(av, bv)
    np.testing.assert_array_equal(_host(lib, av, bv, False)[0], ref)
    np.testing.assert_array_equal(_host(lib, av, bv, True)[0], ref)


def test_schedule_in_row_passes(lib):
    """A roots workspace too small for every row runs the rows in passes
    of 8 (B6): the same digits."""
    rng = np.random.default_rng(7)
    a = rng.integers(-1, 2, (3, 19, 140, 7)).astype(np.int8)
    b = rng.integers(-1, 2, (3, 140, 10, 7)).astype(np.int8)
    # one row's roots: 3 channels x 3 chunks x 3 words x 8 bytes
    out, passes = _host(lib, a, b, False, budget=3 * 3 * 3 * 8 * 9)
    assert passes == 3
    np.testing.assert_array_equal(out, _reference(a, b))
