"""Build and load the port's CUDA kernels (nvcc into one ``.so``, ctypes).

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects are linked into one shared library
with a plain C interface, loaded with :mod:`ctypes`.  Nothing includes
PyTorch's headers, so a build takes seconds.  The library lands in the
repository's git-ignored ``build/`` directory under a name carrying the
sources' hash: a changed source is rebuilt at first use, an unchanged one
is loaded as it is.  Nothing is built when this module is imported.
Processes that start together (the ranks of a mesh) build under one file
lock: the first builds, the others load its library.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "source_hash", "log_path", "build",
           "library", "check"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# C entry points: every one runs on the given stream, allocates nothing,
# and returns cudaGetLastError() after its launch.
_SIGNATURES = {
    # a, b, out, workspace, workspace bytes, moduli (host int[C]), S, C, M,
    # N, K, a_ss, a_sc, lda, b_ss, b_sc, ldb, stream
    "rns_matmul_s8": [_P, _P, _P, _P, _L, _P, _I, _I, _I, _I, _I, _L, _L,
                      _L, _L, _L, _L, _P],
    # a, b, out, roots workspace, wrap_signs (host int[C]), C, M, N, K, n,
    # a_cs, lda, b_cs, ldb, matvec, stream
    "sdrns_matmul_s8": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L,
                        _L, _I, _P],
    # x, y, out, B, n, kind (1 pow2m1, 0 pow2, -1 pow2p1, 2 plain), stream
    "sd_add_s8": [_P, _P, _P, _L, _I, _I, _P],
    # res, out, tables (host uint32[]), C, S, M x N, res channel stride,
    # res stack stride, accumulate, stream
    "rns_decode_s32": [_P, _P, _P, _I, _L, _L, _L, _L, _I, _P],
    # q, k, v, kv_len, o, B, Sq, T, H, Kv, hd, causal, scale, dtype, stream
    "flash_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _F, _I, _P],
    # q, k_pages, v_pages, k_scale, v_scale, tab, kv_len, o, m, l, B, H, Kv,
    # hd, ps, n_pmax, row_stride, scale, q_dtype, kv_mode, m0, m1, crt_inv,
    # k_wit, v_wit, wit_lane_stride, n_red, red_moduli (host int[n_red]),
    # syn, stream
    "paged_decode_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                         _I, _I, _I, _L, _F, _I, _I, _I, _I, _I, _P, _P, _L,
                         _I, _P, _P, _P],
    # q, k, v, kv_len, o, m, l, B, H, Kv, hd, T, bk, scale, q_dtype,
    # kv_dtype, stream
    "flash_decode_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _F, _I, _I, _P],
}

# Queries that launch nothing: name -> (argument types, result type).
_QUERIES = {
    # S x C, M, N, K -> bytes of rns_matmul_s8's workspace (0: none)
    "rns_matmul_workspace": ([_I, _I, _I, _I], _L),
    # C, M, N, K, matvec -> bytes of sdrns_matmul_s8's roots workspace
    "sdrns_matmul_workspace": ([_I, _I, _I, _I, _I], _L),
}

_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    """Hash of every kernel source and header, plus the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def log_path() -> Path:
    """The nvcc (``-Xptxas -v``) log of the build with this source hash."""
    return BUILD_DIR / f"nvcc_{source_hash()}.log"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def build() -> Path:
    """Compile the kernels if this source hash has no library yet."""
    out = BUILD_DIR / f"repro_torch_kernels_{source_hash()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():       # another process may have built it
            _compile(out)
    return out


def _compile(out: Path) -> None:
    nvcc = _nvcc()
    objs, procs = [], []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{os.getpid()}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, p in procs:
        log, _ = p.communicate()
        logs.append(f"== {src.name}\n{log}")
        if p.returncode != 0:
            failed.append(src.name)
    log_path().write_text("\n".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = BUILD_DIR / f".{out.name}.{os.getpid()}"
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         *map(str, objs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, out)


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        for name, (argtypes, restype) in _QUERIES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
