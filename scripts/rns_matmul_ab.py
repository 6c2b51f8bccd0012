#!/usr/bin/env python3
"""Time kernel B1 against an earlier body of it, interleaved, on one GPU.

    python3 scripts/rns_matmul_ab.py OLD_SOURCE [--reps 10]

``OLD_SOURCE`` is an earlier ``src/repro_torch/csrc/rns_matmul.cu`` with the
first C entry ``rns_matmul_s8(a, b, out, moduli, C, M, N, K, a_sc, lda, b_sc,
ldb, stream)`` (e.g. from a ``git archive`` of an earlier commit).  It is
built alone with nvcc into ``build/``; the current body is the package's
(``repro_torch.kernels.rns_matmul.rns_matmul_cuda``).

At every shape ``chip_smoke.py``'s [kernels] phase holds B1 at (qwen3-8b on
P21 and P21R2 planes, zamba2-7b on P21; M 8 and 2048; the logits at M 8),
and around the decode schedule's threshold (M 16, 17 and 32 at qwen3's
gate/up shape), both bodies are held bit for bit against each other and
the plain version, then timed in turns old, new, new, old: each turn the
median of ``--reps`` launches with the L2 flushed before each (CUDA
events).  Prints one line a shape, the decode-step sums, the card's name
and power limit, and a JSON line with every number.  Needs a CUDA card;
exits 2 without one.

    python3 scripts/rns_matmul_ab.py OLD_SOURCE --serve [--serve-new 33]
                                     [--turns 1]

times the serves instead: ``chip_smoke.py``'s [serve] (qwen3-8b, P21,
rns8 pages), [serve-r] (qwen3-8b, P21R2, rns8r pages, strict) and
[serve-hybrid] (zamba2-7b, dense cache) at full width and depth, B 8,
prompt 256.  Each engine is built once; after one short warm-up
``generate`` with each body, it generates ``--serve-new`` tokens in turns
old, new, new, old (``--turns`` times over), with B1's registered
implementation swapped between turns.  Prints each turn's prefill seconds and decode-step ms, and fails
unless every turn gives the same tokens.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402  (shapes, timer, bounds, nvidia-smi)

# the decode schedule takes M <= 16, the prefill tile M > 16
THRESHOLD_M = (16, 17, 32)


def build_old(source: str) -> ctypes.CDLL:
    from repro_torch.kernels import build

    digest = hashlib.sha256(Path(source).read_bytes()).hexdigest()[:16]
    out = build.BUILD_DIR / f"rns_matmul_old_{digest}.so"
    if not out.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", source,
                        "-o", str(out)], check=True, timeout=600)
    lib = ctypes.CDLL(str(out))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rns_matmul_s8.argtypes = [P, P, P, P, I, I, I, I, L, L, L, L, P]
    lib.rns_matmul_s8.restype = I
    return lib


def old_call(torch, lib, a, b, moduli):
    C, M, K = a.shape
    N = b.shape[2]
    out = torch.empty((C, M, N), dtype=torch.int32, device=a.device)
    mods = (ctypes.c_int * C)(*moduli)
    err = lib.rns_matmul_s8(a.data_ptr(), b.data_ptr(), out.data_ptr(), mods,
                            C, M, N, K, a.stride(0), a.stride(1), b.stride(0),
                            b.stride(1),
                            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"old rns_matmul_s8: CUDA error {err}")
    return out


def _engine(torch, name):
    """The model and engine of one serve, as chip_smoke.py builds them."""
    from repro_torch.configs import get_config
    from repro_torch.core.moduli import P21R2
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import ServingEngine

    s_max = cs.SERVE_PROMPT + cs.SERVE_NEW + 1
    if name == "serve-hybrid":
        cfg = get_config("zamba2-7b")
        model = build_model(cfg, system="rns", device="cuda")
        kw = {}
    else:
        cfg = get_config("qwen3-8b")
        extra = dict(rns_mset=P21R2) if name == "serve-r" else {}
        model = build_model(cfg, system="rns", device="cuda", **extra)
        kw = dict(page_size=64, kv_format="rns8r" if name == "serve-r"
                  else "rns8")
        if name == "serve-r":
            kw["policy"] = "strict"
    engine = ServingEngine(model, model.init(cs.SEED), batch=cs.SERVE_B,
                           s_max=s_max, device="cuda", **kw)
    return cfg, engine


def serve_ab(torch, old, n_new: int, n_turns: int, smi: str) -> int:
    import gc

    import numpy as np

    from repro_torch.kernels.rns_matmul import rns_matmul_cuda
    from repro_torch.numerics import registry

    bodies = {"old": lambda a, b, m: old_call(torch, old, a, b,
                                              [int(x) for x in m]),
              "new": rns_matmul_cuda}
    steps = n_new - 1
    rows = {}
    for name in ("serve", "serve-r", "serve-hybrid"):
        cfg, engine = _engine(torch, name)
        prompts = np.random.default_rng(cs.SEED).integers(
            0, cfg.vocab, (cs.SERVE_B, cs.SERVE_PROMPT)).astype(np.int32)
        for body in ("old", "new"):              # warm-up, not timed
            registry.register_impl("rns_matmul", "cuda", bodies[body])
            engine.generate({"tokens": prompts}, max_new=3)
        turns, first = [], None
        for body in ("old", "new", "new", "old") * n_turns:
            registry.register_impl("rns_matmul", "cuda", bodies[body])
            res = engine.generate({"tokens": prompts}, max_new=n_new)
            torch.cuda.synchronize()
            if first is None:
                first = res.tokens
            elif not np.array_equal(res.tokens, first):
                raise AssertionError(f"[{name}] the {body} body's tokens "
                                     f"differ from the first turn's")
            st = res.stats
            turns.append(dict(body=body, prefill_s=st.prefill_s,
                              step_ms=1e3 * st.decode_s / steps))
        registry.register_impl("rns_matmul", "cuda", rns_matmul_cuda)
        rows[name] = turns
        mean = {b: sum(t["step_ms"] for t in turns if t["body"] == b) /
                (2 * n_turns) for b in bodies}
        print(f"[ab-serve] {name} {cfg.name} B={cs.SERVE_B} prompt="
              f"{cs.SERVE_PROMPT} new={n_new}: " + "; ".join(
                  f"{t['body']} prefill_s={t['prefill_s']:.3f} "
                  f"step_ms={t['step_ms']:.1f}" for t in turns) +
              f"; mean step_ms old={mean['old']:.1f} new={mean['new']:.1f}; "
              f"tokens equal in every turn", flush=True)
        del engine, res
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"ab_serve": rows, "device": smi}))
    print(smi)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old_source")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--serve", action="store_true",
                    help="time the serves' decode steps, not the kernel")
    ap.add_argument("--serve-new", type=int, default=33)
    ap.add_argument("--turns", type=int, default=1,
                    help="blocks of old, new, new, old turns a serve")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("rns_matmul_ab: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.moduli import P21, P21R2
    from repro_torch.kernels.rns_matmul import rns_matmul_cuda, rns_matmul_ref
    from repro_torch.roofline import op_cost

    old = build_old(args.old_source)
    smi = cs.nvidia_smi()
    if args.serve:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return serve_ab(torch, old, args.serve_new, args.turns, smi)
    timer = cs.Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    rows, steps = [], {}
    for mset, label, step in ((P21, "P21", cs.QWEN3_STEP),
                              (P21R2, "P21R2", cs.QWEN3_STEP),
                              (P21, "zamba2", cs.HYBRID_MATMULS)):
        C, h = mset.num_channels, max(mset.moduli) // 2
        shapes = [(M, K, N) for M in (8, cs.SERVE_B * cs.SERVE_PROMPT)
                  for (K, N), _ in step[:-1]] + [(8, *step[-1][0])]
        if label == "P21":
            shapes += [(M, 4096, 12288) for M in THRESHOLD_M]
        per = {}
        for M, K, N in shapes:
            a = torch.randint(-h, h + 1, (C, M, K), generator=gen,
                              device="cuda", dtype=torch.int32).to(torch.int8)
            b = torch.randint(-h, h + 1, (C, K, N), generator=gen,
                              device="cuda", dtype=torch.int32).to(torch.int8)
            ref = rns_matmul_ref(a, b, mset.moduli)
            if not (torch.equal(rns_matmul_cuda(a, b, mset.moduli), ref) and
                    torch.equal(old_call(torch, old, a, b, mset.moduli),
                                ref)):
                raise AssertionError(f"{label} M={M} K={K} N={N}: a body "
                                     f"differs from the plain version")
            del ref
            t_old = [timer(lambda: old_call(torch, old, a, b, mset.moduli),
                           args.reps)]
            t_new = [timer(lambda: rns_matmul_cuda(a, b, mset.moduli),
                           args.reps) for _ in range(2)]
            t_old.append(timer(lambda: old_call(torch, old, a, b,
                                                mset.moduli), args.reps))
            o, n = sum(t_old) / 2, sum(t_new) / 2
            bms, by = cs.bound_ms(op_cost.rns_matmul_work(C, M, K, N))
            per[(M, K, N)] = (o, n)
            rows.append(dict(label=label, C=C, M=M, K=K, N=N, old_ms=t_old,
                             new_ms=t_new, bound_ms=bms, bound_by=by))
            print(f"[ab] rns_matmul[{label}] C={C} M={M} K={K} N={N}: "
                  f"old_ms={t_old[0]:.4f},{t_old[1]:.4f} "
                  f"new_ms={t_new[0]:.4f},{t_new[1]:.4f} "
                  f"speedup={o / n:.2f}x bound_ms={bms:.4f} ({by})",
                  flush=True)
            del a, b
            torch.cuda.empty_cache()
        o = sum(per[(8, K, N)][0] * c for (K, N), c in step)
        n = sum(per[(8, K, N)][1] * c for (K, N), c in step)
        steps[label] = dict(old_ms=o, new_ms=n,
                            launches=sum(c for _, c in step))
        print(f"[ab] rns_matmul[{label}] one decode step "
              f"({steps[label]['launches']} launches, M=8): old_ms={o:.3f} "
              f"new_ms={n:.3f} speedup={o / n:.2f}x", flush=True)
    print(json.dumps({"ab": rows, "steps": steps, "device": smi}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
