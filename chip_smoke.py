#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and the exit code is not
0; the script never runs on the CPU):

1. build   -- compile the Hopper kernels from ``src/repro_torch/csrc`` and
   print the card's name and power limit (nvidia-smi).
2. kernels -- hold every kernel of the serving path against its plain
   PyTorch version at the main path's shapes (rns_matmul bit for bit; the
   attention kernels within stated tolerances) and time kernel, plain
   version and a library yardstick the port never calls, beside the bound.
3. small   -- the quantizers give the same bits on the card as on the CPU,
   and the committed reduced qwen3-8b checkpoint served on the card and on
   the CPU (plain versions) gives prefill logits that agree.
4. serve   -- qwen3-8b at full width (36 layers, random weights from seed 0)
   under ``system="rns"`` with rns8 KV pages: batch 8, 256-token prompts,
   64 new tokens, greedy.  Launch counters are reset just before and read
   just after, and must show every kernel on the path.

The last three lines are the kernels JSON, the nvidia-smi line and the
result JSON.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet; dense): bytes/s and operations/s.
HBM_BPS = 3.35e12
PEAK = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
SEED = 0
FLUSH_BYTES = 256 << 20      # > the 50 MB L2: every timed launch starts cold

# qwen3-8b matmul shapes (K, N) and their count per layer; logits once.
LAYER_MATMULS = [((4096, 4096), 2), ((4096, 1024), 2), ((4096, 12288), 2),
                 ((12288, 4096), 1)]
LOGITS = (4096, 151936)


def bound_ms(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BPS, ops / PEAK[kind]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


class Timer:
    """CUDA-event timing of one launch, median over repetitions, with the
    L2 flushed before each (the flush also hides host launch latency)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8,
                                 device="cuda")

    def __call__(self, fn, reps: int) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            ts.append(s.elapsed_time(e))
        return statistics.median(ts)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_rns_matmul(torch, timer, gen):
    from repro_torch.core.moduli import P21
    from repro_torch.kernels.rns_matmul import rns_matmul_cuda, rns_matmul_ref

    C = P21.num_channels
    per = {}
    shapes = [(M, K, N) for M in (8, 2048) for (K, N), _ in LAYER_MATMULS]
    shapes.append((8, *LOGITS))
    for M, K, N in shapes:
        a = torch.randint(-64, 65, (C, M, K), generator=gen, device="cuda",
                          dtype=torch.int32).to(torch.int8)
        b = torch.randint(-64, 65, (C, K, N), generator=gen, device="cuda",
                          dtype=torch.int32).to(torch.int8)
        out = rns_matmul_cuda(a, b, P21.moduli)
        ref = rns_matmul_ref(a, b, P21.moduli)
        err = int((out.to(torch.int64) - ref.to(torch.int64)).abs().max())
        if err != 0:
            raise AssertionError(f"rns_matmul M={M} K={K} N={N}: kernel "
                                 f"differs from the plain version ({err})")
        del out, ref
        ab, bb = a.to(torch.bfloat16), b.to(torch.bfloat16)
        ms = timer(lambda: rns_matmul_cuda(a, b, P21.moduli), 10)
        plain = timer(lambda: rns_matmul_ref(a, b, P21.moduli), 3)
        lib = timer(lambda: torch.bmm(ab, bb), 10)
        nbytes = C * (M * K + K * N + 4 * M * N)
        bms, by = bound_ms(nbytes, 2 * C * M * K * N, "int8")
        per[(M, K, N)] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                              bound_ms=bms, bound_by=by, err=err)
        print(f"[kernels] rns_matmul M={M} K={K} N={N}: bit-exact; "
              f"kernel_ms={ms:.4f} plain_ms={plain:.4f} "
              f"library_ms(bf16 bmm)={lib:.4f} bound_ms={bms:.4f} ({by})",
              flush=True)
        del a, b, ab, bb
        torch.cuda.empty_cache()
    # one decode step of the main path: 36 layers x 7 matmuls + logits, M=8
    mult = [((8, K, N), 36 * n) for (K, N), n in LAYER_MATMULS]
    mult.append(((8, *LOGITS), 1))
    step = {k: sum(per[s][k] * n for s, n in mult)
            for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    print(f"[kernels] rns_matmul one decode step (253 launches, M=8): "
          f"kernel_ms={step['ms']:.3f} plain_ms={step['plain_ms']:.3f} "
          f"library_ms={step['library_ms']:.3f} "
          f"bound_ms={step['bound_ms']:.3f}", flush=True)
    return dict(step, bound_by="bytes",
                max_abs_err=max(v["err"] for v in per.values()),
                at="one decode step: 36 x (q,k,v,o,gate,up,down) + logits, "
                   "M=8; per-shape times in the [kernels] lines")


def check_flash_attention(torch, timer, gen):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attn import (flash_attention_cuda,
                                                flash_attention_ref)

    B, S, H, Kv, hd = 8, 256, 32, 8, 128
    q = torch.randn(B, S, H, hd, generator=gen, device="cuda").bfloat16()
    k = torch.randn(B, S, Kv, hd, generator=gen, device="cuda").bfloat16()
    v = torch.randn(B, S, Kv, hd, generator=gen, device="cuda").bfloat16()
    out = flash_attention_cuda(q, k, v, causal=True)
    ref = flash_attention_ref(q.float(), k.float(), v.float(), causal=True)
    err = float((out.float() - ref).abs().max())
    # bf16 output rounding plus p rounded to bf16 before PV: the reference's
    # own bf16 tolerance (tests/test_flash_attn.py, _tol)
    tol = 2e-2
    if not err <= tol:
        raise AssertionError(f"flash_attention: max error {err} > {tol}")
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    ms = timer(lambda: flash_attention_cuda(q, k, v, causal=True), 20)
    plain = timer(lambda: flash_attention_ref(q, k, v, causal=True), 5)
    lib = timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 20)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * B
    pairs = B * H * S * (S + 1) // 2
    bms, by = bound_ms(nbytes, 4 * hd * pairs, "bf16")
    print(f"[kernels] flash_attention B={B} S={S} H={H} Kv={Kv} hd={hd} "
          f"bf16 causal: max_abs_err={err:.3e} (tol {tol}); "
          f"kernel_ms={ms:.4f} plain_ms={plain:.4f} library_ms(sdpa)="
          f"{lib:.4f} bound_ms={bms:.4f} ({by})", flush=True)
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                bound_by=by, max_abs_err=err,
                at=f"prefill B={B} S={S} H={H} Kv={Kv} hd={hd} bf16")


def check_paged_decode(torch, timer, gen):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attn import (paged_decode_cuda,
                                                paged_decode_ref)
    from repro_torch.numerics import kv_pages as kvp
    from repro_torch.numerics.attention import merge_decode_partials

    B, H, Kv, hd, ps, n_pmax = 8, 32, 8, 128, 64, 5
    P = 1 + B * n_pmax
    kv_len = torch.randint(1, n_pmax * ps + 1, (B,), generator=gen,
                           device="cuda", dtype=torch.int32)
    kv_len[0], kv_len[1] = 1, n_pmax * ps              # ragged over 1..320
    tab = (1 + torch.randperm(B * n_pmax, generator=gen, device="cuda")
           ).reshape(B, n_pmax).to(torch.int32)
    q = torch.randn(B, H, hd, generator=gen, device="cuda").bfloat16()
    dense = torch.randn(2, 1, B, n_pmax * ps, Kv, hd, generator=gen,
                        device="cuda").bfloat16()
    results = {}
    for name in ("bf16", "rns8", "rns4"):
        fmt = kvp.KV_FORMATS[name]
        pool = kvp.make_paged_kv(1, P, ps, Kv, hd, fmt=fmt, device="cuda")
        kvp.scatter_prefill(pool, dense[0], dense[1], tab, ps)
        lay = kvp.layer_slice(pool, 0)
        if fmt.is_residue:
            args = (lay.k.planes.select(-3, 0), lay.v.planes.select(-3, 0),
                    lay.k.scale, lay.v.scale, tab, kv_len, ps, fmt.pack)
            row_bytes = hd // fmt.pack.values_per_byte + 4
            kind = "f32"
        else:
            args = (lay.k, lay.v, None, None, tab, kv_len, ps, None)
            row_bytes, kind = 2 * hd, "bf16"
        out = merge_decode_partials(*paged_decode_cuda(q, *args))
        ref = merge_decode_partials(*paged_decode_ref(q, *args))
        err = float((out - ref).abs().max())
        # residue pages: f32 math in another summation order; bf16 pages:
        # p is rounded to bf16 on both sides, and an exp one f32 ulp apart
        # can round to neighbouring bf16 values (2**-8 of one weight)
        tol = 2e-3 if name == "bf16" else 1e-4
        if not err <= tol:
            raise AssertionError(f"paged_decode[{name}]: max error {err} > "
                                 f"{tol}")
        # library yardstick: SDPA over the gathered, dequantized cache
        lay_vals = []
        for leaf in (lay.k, lay.v):
            rows = leaf.to_int().float() * leaf.scale if fmt.is_residue \
                else leaf.float()
            lay_vals.append(rows[tab.long()].reshape(
                B, n_pmax * ps, Kv, hd).transpose(1, 2).bfloat16()
                .contiguous())
        mask = (torch.arange(n_pmax * ps, device="cuda")[None, :]
                < kv_len[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        ms = timer(lambda: paged_decode_cuda(q, *args), 20)
        plain = timer(lambda: paged_decode_ref(q, *args), 5)
        lib = timer(lambda: F.scaled_dot_product_attention(
            q4, lay_vals[0], lay_vals[1], attn_mask=mask, enable_gqa=True),
            20)
        n_rows = int(kv_len.sum())
        nbytes = (2 * q.numel() + 2 * n_rows * Kv * row_bytes
                  + 4 * B * H * n_pmax * (hd + 2) + 4 * tab.numel() + 4 * B)
        bms, by = bound_ms(nbytes, 4 * hd * H * n_rows, kind)
        print(f"[kernels] paged_decode[{name}] B={B} H={H} Kv={Kv} hd={hd} "
              f"ps={ps} kv_len 1..{n_pmax * ps} (sum {n_rows}): "
              f"max_abs_err={err:.3e} (tol {tol}); kernel_ms={ms:.4f} "
              f"plain_ms={plain:.4f} library_ms(sdpa gathered)={lib:.4f} "
              f"bound_ms={bms:.5f} ({by})", flush=True)
        results[name] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                             bound_ms=bms, bound_by=by, max_abs_err=err,
                             at=f"decode B={B} H={H} Kv={Kv} hd={hd} "
                                f"ps={ps}, {name} pages")
    return results


# ---------------------------------------------------------------------------
# Phase 3: small input, card against CPU
# ---------------------------------------------------------------------------


def check_small(torch):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.convert import from_jax_params, load_npz
    from repro_torch.models.api import build_model
    from repro_torch.numerics import kv_pages as kvp
    from repro_torch.quant.quant import quantize_symmetric
    from repro_torch.serving.engine import ServingEngine

    # the quantizers give the same bits on the card as on the CPU (their
    # scale divisions must not become reciprocal multiplies on the card)
    x = torch.randn(512, 8, 128, generator=torch.Generator().manual_seed(
        SEED)) * 3
    for name, fn in (
            ("quantize_symmetric", lambda t: quantize_symmetric(t, 4,
                                                                axis=-1)),
            ("quantize_to_format[rns8]",
             lambda t: kvp.quantize_to_format(t, kvp.KV_FORMATS["rns8"]))):
        card = [t.cpu() for t in fn(x.cuda())]
        host = fn(x)
        if not all(torch.equal(a, b) for a, b in zip(card, host)):
            raise AssertionError(f"{name}: card and CPU bits differ")
    print("[small] quantize_symmetric and quantize_to_format: card and CPU "
          "bit-identical", flush=True)

    cfg = get_config("qwen3-8b").reduced()
    tree = load_npz(os.path.join(HERE, "checkpoints", "qwen3-8b",
                                 "ckpt_0000000002.npz"))
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (3, 10)).astype(np.int32)
    res = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, system="rns", device=dev)
        eng = ServingEngine(model, from_jax_params(tree, cfg, dev), batch=3,
                            s_max=19, page_size=8, kv_format="rns8",
                            device=dev)
        res[dev] = eng.generate({"tokens": prompts}, max_new=8)
    err = float(np.abs(res["cuda"].prefill_logits
                       - res["cpu"].prefill_logits).max())
    same = int((res["cuda"].tokens == res["cpu"].tokens).sum())
    # f32 compute on both; exact residue matmuls; only float summation
    # order differs (an int4 code can flip only at a rounding tie)
    tol = 1e-3
    print(f"[small] reduced qwen3-8b checkpoint, rns/rns8, card vs CPU: "
          f"prefill logits max_abs_err={err:.3e} (tol {tol}); tokens equal "
          f"{same}/{res['cpu'].tokens.size}", flush=True)
    if not err <= tol:
        raise AssertionError(f"small: card and CPU logits differ by {err}")


# ---------------------------------------------------------------------------
# Phase 4: full-width serve
# ---------------------------------------------------------------------------


def serve_full_width(torch):
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model, resident_bytes
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config("qwen3-8b")
    B, plen, max_new = 8, 256, 64
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, system="rns", device="cuda")
    params = model.init(SEED)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    engine = ServingEngine(model, params, batch=B, s_max=plen + max_new + 1,
                           page_size=64, kv_format="rns8", device="cuda")
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (B, plen)).astype(np.int32)
    kernels.reset_launch_counts()
    res = engine.generate({"tokens": prompts}, max_new=max_new)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    rb = resident_bytes(engine.params)
    steps = max_new - 1
    st = res.stats
    print(f"[serve] qwen3-8b L={cfg.n_layers} d={cfg.d_model} system=rns "
          f"kv=rns8 B={B} prompt={plen} new={max_new}: init_s={t_init:.2f} "
          f"prefill_s={st.prefill_s:.3f} decode_s={st.decode_s:.3f} "
          f"decode_tok_s={B * steps / st.decode_s:.2f} "
          f"step_ms={1e3 * st.decode_s / steps:.1f}", flush=True)
    print(f"[serve] resident weight bytes={rb} kv pool bytes="
          f"{engine.pool.pool_bytes()} max_memory_allocated={peak}",
          flush=True)
    print(f"[serve] launches {json.dumps(counts)}", flush=True)
    per_step = 7 * cfg.n_layers + 1
    want = {"rns_matmul": per_step * (1 + steps),
            "flash_attention": cfg.n_layers,
            "paged_decode": cfg.n_layers * steps}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    if res.tokens.shape != (B, max_new):
        raise AssertionError(f"tokens shape {res.tokens.shape}")
    if not (0 <= res.tokens.min() and res.tokens.max() < cfg.vocab):
        raise AssertionError("tokens out of [0, vocab)")
    if res.prefill_logits.shape != (B, cfg.vocab) or not np.isfinite(
            res.prefill_logits).all():
        raise AssertionError("prefill logits not finite or misshapen")
    print(f"[serve] seq0 tokens {res.tokens[0, :16].tolist()}", flush=True)
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs only on "
              "the card", file=sys.stderr)
        return 2
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.library()
    print(f"[build] kernels from {build.CSRC} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    smi = nvidia_smi()
    print(f"[build] {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rm = check_rns_matmul(torch, timer, gen)
    fa = check_flash_attention(torch, timer, gen)
    pd = check_paged_decode(torch, timer, gen)
    del timer
    torch.cuda.empty_cache()
    check_small(torch)
    counts = serve_full_width(torch)

    src_dir = "src/repro_torch/csrc/"
    entries = [
        ("rns_matmul", src_dir + "rns_matmul.cu",
         "src/repro/kernels/rns_matmul.py:73", rm),
        ("flash_attention", src_dir + "flash_attn.cu",
         "src/repro/kernels/flash_attn.py:131", fa),
        ("paged_decode", src_dir + "flash_attn.cu",
         "src/repro/kernels/flash_attn.py:385", pd["rns8"]),
    ]
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": rep,
         "launches": counts[name], "max_abs_err": r["max_abs_err"],
         "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"],
         "at": r["at"]} for name, source, rep, r in entries]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
