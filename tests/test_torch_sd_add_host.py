"""The SD adder's schedule and packed arithmetic (kernel B8), run on the host.

``src/repro_torch/csrc/sd_add_tiles.cuh`` holds everything kernel B8
computes: the tile staging with 16-byte copies (and byte copies at
unaligned ends), each thread's packing of four digit vectors into
(nonzero, sign) masks, the packed two-step add on lanes of n bits and the
unpacking into digit bytes.  It compiles under a host C++ compiler, so the
harness below (built with g++ into a temporary directory, loaded with
ctypes) runs the schedule block by block and thread by thread, with the
barriers where ``csrc/sd_add.cu`` has them and shared memory filled with
stale bytes, and the result is held against the port's plain version
``repro_torch.kernels.sd_add.sd_add_ref`` (itself held to the JAX
reference by tests/test_torch_sdrns_matmul.py):

* every kind and every n from 1 to 16; every pair of digit vectors for n
  up to 6, random pairs above;
* vector counts around the 1024-vector tile, with fewer blocks than tiles
  (the grid-stride loop);
* base addresses of x, y and the output off every alignment.

The tests skip when no ``g++`` is found.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.sd_add import KINDS, sd_add_ref

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
KIND_CODE = {"pow2m1": 1, "pow2": 0, "pow2p1": -1, "plain": 2}
TILE = 1024                    # sda::kTile

HARNESS = r"""
#include <vector>

#include "sd_add_tiles.cuh"

using namespace sda;

// sd_add.cu's kernel on the host: `grid` blocks stride over the tiles, the
// next tile staged into the other stage before this one is added; each
// phase runs for every thread before the next (the barriers).
template <int N, int WS, bool PLAIN>
static void run(const uint8_t* x, const uint8_t* y, uint8_t* out, long long B,
                int grid) {
  constexpr int NO = PLAIN ? N + 1 : N;
  std::vector<uint8_t> mem(smem_bytes(N, PLAIN) + 16, 0xA5);
  uint8_t* smem = mem.data() + (16 - misalign(mem.data())) % 16;
  uint8_t* os = out_buf(smem, N);
  const long long tiles = num_tiles(B);
  auto stage = [&](long long t, int b) {
    const long long bytes = (long long)tile_count(t, B) * N;
    for (int tid = 0; tid < kThreads; ++tid) {
      stage_in(x + t * kTile * N, bytes, x_buf(smem, N, b), tid, kThreads);
      stage_in(y + t * kTile * N, bytes, y_buf(smem, N, b), tid, kThreads);
    }
  };
  for (int blk = 0; blk < grid; ++blk) {
    if (blk < tiles) stage(blk, 0);
    int b = 0;
    for (long long t = blk; t < tiles; t += grid, b ^= 1) {
      if (t + grid < tiles) stage(t + grid, b ^ 1);
      const int cnt = tile_count(t, B);
      const long long v0 = t * kTile;
      uint8_t* og = out + v0 * NO;
      for (int tid = 0; tid < kThreads; ++tid)
        thread_add<N, WS, PLAIN>(x_buf(smem, N, b), y_buf(smem, N, b), os,
                                 tid, misalign(x + v0 * N),
                                 misalign(y + v0 * N), misalign(og));
      for (int tid = 0; tid < kThreads; ++tid)
        stage_out(os, og, (long long)cnt * NO, tid, kThreads);
    }
  }
}

template <int N>
static int run_n(int kind, const uint8_t* x, const uint8_t* y, uint8_t* out,
                 long long B, int grid) {
  switch (kind) {
    case 1: run<N, 1, false>(x, y, out, B, grid); return 0;
    case 0: run<N, 0, false>(x, y, out, B, grid); return 0;
    case -1: run<N, -1, false>(x, y, out, B, grid); return 0;
    case 2: run<N, 0, true>(x, y, out, B, grid); return 0;
    default: return -1;
  }
}

using RunN = int (*)(int, const uint8_t*, const uint8_t*, uint8_t*, long long,
                     int);
static const RunN kByDigits[kMaxDigits + 1] = {
    nullptr,  run_n<1>,  run_n<2>,  run_n<3>,  run_n<4>,  run_n<5>,
    run_n<6>,  run_n<7>,  run_n<8>,  run_n<9>,  run_n<10>, run_n<11>,
    run_n<12>, run_n<13>, run_n<14>, run_n<15>, run_n<16>};

// sd_add_s8's arguments, run on the host with `grid` blocks; -2 if a
// 16-byte copy was misaligned.
extern "C" int host_sd_add(const void* x, const void* y, void* out,
                           long long B, int n, int kind, int grid) {
  if (B < 1 || n < 1 || n > kMaxDigits || grid < 1) return -1;
  host_misaligned_copies() = 0;
  const int err = kByDigits[n](kind, static_cast<const uint8_t*>(x),
                               static_cast<const uint8_t*>(y),
                               static_cast<uint8_t*>(out), B, grid);
  return err ? err : host_misaligned_copies() ? -2 : 0;
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host harness")
    d = tmp_path_factory.mktemp("sd_add_host")
    src, so = d / "harness.cpp", d / "harness.so"
    src.write_text(HARNESS)
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    f"-I{CSRC}", str(src), "-o", str(so)], check=True,
                   capture_output=True, timeout=300)
    h = ctypes.CDLL(str(so))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    h.host_sd_add.argtypes = [P, P, P, L, I, I, I]
    return h


def _host(lib, x, y, kind, grid=4, offs=(0, 0, 0)):
    """B8's schedule on (B, n) int8 digits placed at byte offsets ``offs``
    past 16-byte-aligned buffers (x, y, out)."""
    B, n = x.shape
    out_n = n + 1 if kind == "plain" else n

    def placed(nbytes, off):
        raw = np.full(nbytes + 64, 77, np.uint8)
        start = (-raw.ctypes.data) % 16 + off
        return raw, raw[start:start + nbytes]

    views = []
    for arr, off in ((x, offs[0]), (y, offs[1])):
        _, v = placed(arr.size, off)
        v[:] = arr.reshape(-1).view(np.uint8)
        views.append(v)
    raw_o, out = placed(B * out_n, offs[2])
    assert [v.ctypes.data % 16 for v in views + [out]] == list(offs)
    assert lib.host_sd_add(views[0].ctypes.data, views[1].ctypes.data,
                           out.ctypes.data, B, n, KIND_CODE[kind], grid) == 0
    # nothing written outside the output range
    assert (raw_o[:out.ctypes.data - raw_o.ctypes.data] == 77).all()
    assert (raw_o[out.ctypes.data - raw_o.ctypes.data + out.size:] == 77).all()
    return out.view(np.int8).reshape(B, out_n)


def _ref(x, y, kind):
    return sd_add_ref(torch.from_numpy(x), torch.from_numpy(y), kind).numpy()


def _all_pairs(n):
    """Every (x, y) pair of n-digit vectors, two (9^n, n) int8 arrays."""
    idx = np.arange(3 ** n)
    v = np.stack([(idx // 3 ** i) % 3 - 1 for i in range(n)],
                 axis=1).astype(np.int8)
    return (np.ascontiguousarray(np.repeat(v, len(v), axis=0)),
            np.ascontiguousarray(np.tile(v, (len(v), 1))))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", range(1, 17))
def test_every_kind_and_width(lib, n, kind):
    """Every pair of n-digit vectors for n <= 6 (3^(2n) vectors), 5000
    random pairs (a ragged last tile) above."""
    if n <= 6:
        x, y = _all_pairs(n)
    else:
        rng = np.random.default_rng(n)
        x, y = (rng.integers(-1, 2, (5000, n)).astype(np.int8)
                for _ in range(2))
    np.testing.assert_array_equal(_host(lib, x, y, kind), _ref(x, y, kind))


@pytest.mark.parametrize("B", [1, 3, TILE - 1, TILE, TILE + 1,
                               3 * TILE + 5])
@pytest.mark.parametrize("n", [7, 8, 16])
def test_counts_around_the_tile(lib, B, n):
    """Vector counts around the tile, two blocks striding over up to four
    tiles; all four kinds."""
    rng = np.random.default_rng(B * 17 + n)
    x, y = (rng.integers(-1, 2, (B, n)).astype(np.int8) for _ in range(2))
    for kind in KINDS:
        np.testing.assert_array_equal(_host(lib, x, y, kind, grid=2),
                                      _ref(x, y, kind))


@pytest.mark.parametrize("offs", [(1, 5, 3), (4, 8, 12), (15, 0, 7),
                                  (2, 2, 2), (0, 13, 1)])
@pytest.mark.parametrize("n", [1, 5, 7, 9, 16])
def test_unaligned_bases(lib, offs, n):
    """Bases off 16-byte (and 4-byte) alignment, as a sliced view on a
    storage offset gives: the head and tail bytes go one by one, the
    thread spans are shifted into place."""
    rng = np.random.default_rng(sum(offs) + 31 * n)
    B = 2 * TILE + 77
    x, y = (rng.integers(-1, 2, (B, n)).astype(np.int8) for _ in range(2))
    for kind in KINDS:
        np.testing.assert_array_equal(_host(lib, x, y, kind, offs=offs),
                                      _ref(x, y, kind))
