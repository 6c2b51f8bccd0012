#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and the exit code is not
0; the script never runs on the CPU):

1. build   -- compile the Hopper kernels from ``src/repro_torch/csrc`` and
   print the card's name and power limit (nvidia-smi).
2. kernels -- hold every kernel of the serving paths against its plain
   PyTorch version at the main path's shapes (rns_matmul bit for bit on
   the P21 planes of [serve] and the P21R2 planes of [serve-r]; the
   attention kernels within stated tolerances; the paged decode's syndrome
   mode bit for bit on a clean pool and on planted faults; the SD-RNS
   matmul's two schedules digit for digit on a column slice and, decoded,
   equal to rns_matmul's residues at the full shapes; the SD adder bit for
   bit in each kind, and through ``nx.add``) and time kernel, plain version
   and a library yardstick the port never calls, beside the bound.
3. small   -- the quantizers give the same bits on the card as on the CPU,
   and the committed reduced qwen3-8b checkpoint served on the card and on
   the CPU (plain versions) gives prefill logits that agree.
4. serve   -- qwen3-8b at full width (36 layers, random weights from seed 0)
   under ``system="rns"`` with rns8 KV pages: batch 8, 256-token prompts,
   64 new tokens, greedy.  Launch counters are reset just before and read
   just after, and must show every kernel on the path.
5. serve-r -- the same serve on redundant residues: P21R2 weight planes,
   rns8r KV pages and ``policy="strict"``, with the paged decode's syndrome
   mode on every step.  The clean run must show zero syndromes and replays.
6. faults -- the same engine under ``testing.faults.inject_faults``: (a) a
   packed-byte flip in a live K page plus a weight-plane bit in an
   information channel, (b) a sticky KV fault with ``quarantine_after=2``.
   The tokens must equal the clean run's.

7. serve-sd -- qwen3-8b at full width with the depth cut to 8 of 36 layers
   (21 B of digit planes per weight) under ``system="sdrns"``: P21 digit
   planes, rns8 pages, batch 2, 16-token prompts, 8 new tokens, greedy,
   after its twin under ``system="rns"``.  Prefill logits and tokens must
   equal the twin's bit for bit; launch counts are exact.

The last three lines are the kernels JSON, the nvidia-smi line and the
result JSON.
"""
from __future__ import annotations

import dataclasses
import gc
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
KERNELS = ("rns_matmul", "flash_attention", "paged_decode",
           "paged_decode_syndrome", "sdrns_matmul", "sdrns_matvec", "sd_add")
NO_LAUNCHES = dict.fromkeys(KERNELS, 0)
# [serve-sd]: qwen3-8b at full width, depth cut to 8 of 36 layers for time
# and memory (21 B of digit planes per weight: 4.05 GB a layer, 13.07 GB
# for the tied logits weight)
SD_LAYERS, SD_BATCH, SD_PROMPT, SD_NEW = 8, 2, 16, 8
SD_COLS = 256                # columns of the plain version's SD check
SD_ADD_SHAPE = (4096, 4096)  # the weight whose digit planes B8 adds


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


def check_rns_matmul(torch, timer, gen, mset, label):
    """B1 at the main path's shapes on the planes of ``mset``, operands
    drawn over the full centred range of its widest modulus."""
    from repro_torch.kernels.rns_matmul import rns_matmul_cuda, rns_matmul_ref

    C, h = mset.num_channels, max(mset.moduli) // 2
    per = {}
    shapes = [(M, K, N) for M in (8, 2048) for (K, N), _ in LAYER_MATMULS]
    shapes.append((8, *LOGITS))
    for M, K, N in shapes:
        a = torch.randint(-h, h + 1, (C, M, K), generator=gen, device="cuda",
                          dtype=torch.int32).to(torch.int8)
        b = torch.randint(-h, h + 1, (C, K, N), generator=gen, device="cuda",
                          dtype=torch.int32).to(torch.int8)
        out = rns_matmul_cuda(a, b, mset.moduli)
        ref = rns_matmul_ref(a, b, mset.moduli)
        err = int((out.to(torch.int64) - ref.to(torch.int64)).abs().max())
        if err != 0:
            raise AssertionError(f"rns_matmul[{label}] M={M} K={K} N={N}: "
                                 f"kernel differs from the plain version "
                                 f"({err})")
        del out, ref
        ab, bb = a.to(torch.bfloat16), b.to(torch.bfloat16)
        ms = timer(lambda: rns_matmul_cuda(a, b, mset.moduli), 10)
        plain = timer(lambda: rns_matmul_ref(a, b, mset.moduli), 3)
        lib = timer(lambda: torch.bmm(ab, bb), 10)
        nbytes = C * (M * K + K * N + 4 * M * N)
        bms, by = bound_ms(nbytes, 2 * C * M * K * N, "int8")
        per[(M, K, N)] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                              bound_ms=bms, bound_by=by, err=err)
        print(f"[kernels] rns_matmul[{label}] C={C} M={M} K={K} N={N} "
              f"operands in [-{h}, {h}]: bit-exact; kernel_ms={ms:.4f} "
              f"plain_ms={plain:.4f} library_ms(bf16 bmm)={lib:.4f} "
              f"bound_ms={bms:.4f} ({by})", flush=True)
        del a, b, ab, bb
        torch.cuda.empty_cache()
    # one decode step of the main path: 36 layers x 7 matmuls + logits, M=8
    mult = [((8, K, N), 36 * n) for (K, N), n in LAYER_MATMULS]
    mult.append(((8, *LOGITS), 1))
    step = {k: sum(per[s][k] * n for s, n in mult)
            for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    print(f"[kernels] rns_matmul[{label}] one decode step (253 launches, "
          f"M=8): kernel_ms={step['ms']:.3f} plain_ms={step['plain_ms']:.3f} "
          f"library_ms={step['library_ms']:.3f} "
          f"bound_ms={step['bound_ms']:.3f}", flush=True)
    return dict(step, bound_by="bytes",
                max_abs_err=max(v["err"] for v in per.values()),
                at=f"one decode step on {label} planes (C={C}): 36 x "
                   f"(q,k,v,o,gate,up,down) + logits, M=8; per-shape times "
                   f"in the [kernels] lines")


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


def check_paged_decode_syndrome(torch, timer, gen):
    """Kernel B4: the paged decode over rns8r pages with its syndrome
    output, lane 0 and the witness lanes read in place from the pool."""
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
    fmt = kvp.KV_FORMATS["rns8r"]
    pool = kvp.make_paged_kv(1, P, ps, Kv, hd, fmt=fmt, device="cuda")
    kvp.scatter_prefill(pool, dense[0], dense[1], tab, ps)
    lay = kvp.layer_slice(pool, 0)
    r = fmt.redundant
    args = (lay.k.planes.select(-3, 0), lay.v.planes.select(-3, 0),
            lay.k.scale, lay.v.scale, tab, kv_len, ps, fmt.pack,
            lay.k.planes.narrow(-3, 1, r), lay.v.planes.narrow(-3, 1, r),
            fmt.mset.redundant_moduli)
    if args[0].is_contiguous():
        raise AssertionError("lane 0 of the rns8r pool should be strided")

    def compare(label):
        out = paged_decode_cuda(q, *args)
        ref = paged_decode_ref(q, *args)
        torch.cuda.synchronize()
        err = float((merge_decode_partials(*out[:3])
                     - merge_decode_partials(*ref[:3])).abs().max())
        tol = 1e-4      # the rns8 tolerance: f32 sums in another order
        if not err <= tol:
            raise AssertionError(f"paged_decode_syndrome[{label}]: max "
                                 f"error {err} > {tol}")
        if not torch.equal(out[3], ref[3]):
            raise AssertionError(f"paged_decode_syndrome[{label}]: syn "
                                 f"differs from the plain version")
        return err, out[3].sum(dim=(1, 2)).tolist()

    err, clean = compare("clean")
    if any(clean):
        raise AssertionError(f"syndromes on a clean pool: {clean}")
    ms = timer(lambda: paged_decode_cuda(q, *args), 20)
    plain = timer(lambda: paged_decode_ref(q, *args), 5)
    lay_vals = [(leaf.to_int().float() * leaf.scale)[tab.long()].reshape(
        B, n_pmax * ps, Kv, hd).transpose(1, 2).bfloat16().contiguous()
        for leaf in (lay.k, lay.v)]
    mask = (torch.arange(n_pmax * ps, device="cuda")[None, :]
            < kv_len[:, None])[:, None, None, :]
    lib = timer(lambda: F.scaled_dot_product_attention(
        q[:, :, None, :], lay_vals[0], lay_vals[1], attn_mask=mask,
        enable_gqa=True), 20)
    n_rows = int(kv_len.sum())
    # 3 B per K/V element (lane 0 and two witness lanes) + 4 B of scale per
    # row and KV head; q in, partials and syn out
    nbytes = (2 * q.numel() + 2 * n_rows * Kv * (3 * hd + 4)
              + 4 * B * H * n_pmax * (hd + 3) + 4 * tab.numel() + 4 * B)
    bms, by = bound_ms(nbytes, 4 * hd * H * n_rows, "f32")

    # planted faults: slot 1 holds all 320 rows, slot 0 one row
    planes_k, planes_v = pool.k.planes[0], pool.v.planes[0]
    tab_h = tab.cpu()
    named = set(tab_h.flatten().tolist())
    unnamed = next(p for p in range(P) if p not in named)
    planes_k[int(tab_h[1, 0]), 0, 1, 0, 0] ^= 0x01   # witness, valid row
    planes_v[int(tab_h[1, 4]), ps - 1, 0, 3, 7] ^= 0x10  # packed byte, valid
    planes_k[int(tab_h[0, 0]), 5, 0, 0, 0] ^= 0x01   # row past kv_len[0] = 1
    planes_k[unnamed, 0, 0, 2, 9] ^= 0x04            # a page no table names
    _, faulty = compare("planted")
    want = [0] * B
    want[1] = 2
    if faulty != want:
        raise AssertionError(f"planted-fault syndromes {faulty}, expected "
                             f"{want}")
    print(f"[kernels] paged_decode_syndrome[rns8r] B={B} H={H} Kv={Kv} "
          f"hd={hd} ps={ps} kv_len 1..{n_pmax * ps} (sum {n_rows}), lane 0 "
          f"strided: max_abs_err={err:.3e} (tol 1e-4); syn bit-exact, clean "
          f"{clean}, planted {faulty}; kernel_ms={ms:.4f} plain_ms="
          f"{plain:.4f} library_ms(sdpa gathered, counts no syndromes)="
          f"{lib:.4f} bound_ms={bms:.5f} ({by})", flush=True)
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                bound_by=by, max_abs_err=err,
                at=f"decode B={B} H={H} Kv={Kv} hd={hd} ps={ps}, rns8r "
                   f"pages with syndromes; library_ms is SDPA over the "
                   f"gathered dequantized pages and counts no syndromes")


def _digits(torch, gen, *shape):
    return torch.randint(-1, 2, shape, generator=gen, device="cuda",
                         dtype=torch.int8)


def _sd_residues(torch, dig, mset, block=1 << 24):
    """Centred residues (int8) of SD digit planes (C, R, N, n), channel by
    channel and row block by row block (the int32 digit sums of a whole
    logits plane would take 52 GB)."""
    from repro_torch.core import sdrns

    C, R, N, n = dig.shape
    out = torch.empty((C, R, N), dtype=torch.int8, device=dig.device)
    rows = max(1, block // (N * n))
    for c, (kind, width) in enumerate(mset.kinds):
        for r0 in range(0, R, rows):
            out[c, r0:r0 + rows] = sdrns.decode_residue(
                dig[c, r0:r0 + rows], kind, width)
    return out


def check_sdrns_matmul(torch, timer, gen):
    """B6 (M = 32, the prefill projections) and B7 (M = 2, every decode
    projection and the logits) at the main path's shapes, on random digit
    vectors: digit for digit against the plain version on the first
    SD_COLS columns (the plain version materializes the (n, M, K, N, n)
    partial products), and at the full shapes each output digit vector,
    decoded mod m_c and centred, equal to B1's centred residue on the same
    integers.  Timed with B1 and a bf16 bmm over the C channels beside it;
    no PyTorch call computes SD digit vectors, so library_ms is null."""
    from repro_torch.core import sdrns
    from repro_torch.core.moduli import P21
    from repro_torch.kernels.rns_matmul import rns_matmul_cuda
    from repro_torch.kernels.sdrns_matmul import (sdrns_matmul_cuda,
                                                  sdrns_matmul_ref,
                                                  sdrns_matvec_cuda)

    mset, C, n = P21, P21.num_channels, 7
    ws = [sdrns.WRAP_SIGNS[k] for k, _ in mset.kinds]
    B, P = SD_BATCH, SD_PROMPT
    shapes = [(B * P, K, N) for (K, N), _ in LAYER_MATMULS]
    shapes += [(B, K, N) for (K, N), _ in LAYER_MATMULS]
    shapes.append((B, *LOGITS))
    per = {}
    for M, K, N in shapes:
        matvec = M <= 8
        name = "sdrns_matvec" if matvec else "sdrns_matmul"
        kern = sdrns_matvec_cuda if matvec else sdrns_matmul_cuda
        a = _digits(torch, gen, C, M, K, n)
        b = _digits(torch, gen, C, K, N, n)
        out = kern(a, b, ws)
        ref = sdrns_matmul_ref(a, b[:, :, :SD_COLS], ws)
        err = int((out[:, :, :SD_COLS].to(torch.int32)
                   - ref.to(torch.int32)).abs().max())
        if err != 0:
            raise AssertionError(f"{name} M={M} K={K} N={N}: digits differ "
                                 f"from the plain version")
        a_res, b_res = _sd_residues(torch, a, mset), _sd_residues(torch, b,
                                                                  mset)
        rns = rns_matmul_cuda(a_res, b_res, mset.moduli)
        dec = torch.stack([sdrns.decode_residue(out[c], kind, w)
                           for c, (kind, w) in enumerate(mset.kinds)])
        if not torch.equal(dec, rns):
            raise AssertionError(f"{name} M={M} K={K} N={N}: decoded digits "
                                 f"differ from rns_matmul's residues")
        del out, ref, rns, dec
        ms = timer(lambda: kern(a, b, ws), 3)
        bs = b[:, :, :SD_COLS]
        plain = timer(lambda: sdrns_matmul_ref(a, bs, ws), 1)
        rns_ms = timer(lambda: rns_matmul_cuda(a_res, b_res, mset.moduli), 5)
        ab, bb = a_res.to(torch.bfloat16), b_res.to(torch.bfloat16)
        bmm = timer(lambda: torch.bmm(ab, bb), 5)
        nbytes = C * n * (M * K + K * N + M * N)
        bms, by = bound_ms(nbytes, 2 * C * M * K * N, "int8")
        per[(M, K, N)] = dict(ms=ms, plain_ms=plain, rns_ms=rns_ms,
                              bmm_ms=bmm, bound_ms=bms, bound_by=by, err=err)
        print(f"[kernels] {name} C={C} M={M} K={K} N={N} n={n}: digits "
              f"equal the plain version on {SD_COLS} columns, decoded "
              f"residues equal rns_matmul's at full N; kernel_ms={ms:.3f} "
              f"plain_ms({SD_COLS} cols)={plain:.3f} bound_ms={bms:.4f} "
              f"({by}); yardsticks rns_matmul_ms={rns_ms:.4f} "
              f"bf16_bmm_ms={bmm:.4f}", flush=True)
        del a, b, a_res, b_res, ab, bb, bs
        torch.cuda.empty_cache()
    keys = ("ms", "plain_ms", "rns_ms", "bmm_ms", "bound_ms")
    L = SD_LAYERS
    step = [((B, K, N), L * k) for (K, N), k in LAYER_MATMULS]
    step.append(((B, *LOGITS), 1))
    tot = {k: sum(per[s][k] * m for s, m in step) for k in keys}
    layer = {k: sum(per[(B, K, N)][k] * m for (K, N), m in LAYER_MATMULS)
             for k in keys}
    print(f"[kernels] sdrns_matvec one decode step ({7 * L + 1} launches, "
          f"M={B}, {L} layers + logits): kernel_ms={tot['ms']:.3f} "
          f"(per layer {layer['ms']:.3f}, logits "
          f"{per[(B, *LOGITS)]['ms']:.3f}) plain_ms({SD_COLS} cols)="
          f"{tot['plain_ms']:.3f} bound_ms={tot['bound_ms']:.4f}; "
          f"yardsticks rns_matmul_ms={tot['rns_ms']:.3f} bf16_bmm_ms="
          f"{tot['bmm_ms']:.3f}", flush=True)
    pre = per[(B * P, *LAYER_MATMULS[2][0])]        # gate / up (4096, 12288)
    common = dict(library_ms=None, max_abs_err=0)
    matmul = dict(common, ms=pre["ms"], plain_ms=pre["plain_ms"],
                  bound_ms=pre["bound_ms"], bound_by=pre["bound_by"],
                  yardstick_rns_matmul_ms=pre["rns_ms"],
                  yardstick_bf16_bmm_ms=pre["bmm_ms"],
                  at=f"prefill projection M={B * P} K, N="
                     f"{LAYER_MATMULS[2][0]}, P21 "
                     f"digits; plain_ms on the first {SD_COLS} columns; no "
                     f"PyTorch call computes SD digit vectors")
    matvec = dict(common, ms=tot["ms"], plain_ms=tot["plain_ms"],
                  bound_ms=tot["bound_ms"], bound_by="bytes",
                  ms_per_layer=layer["ms"],
                  yardstick_rns_matmul_ms=tot["rns_ms"],
                  yardstick_bf16_bmm_ms=tot["bmm_ms"],
                  at=f"one decode step, {L} layers x (q,k,v,o,gate,up,down) "
                     f"+ logits, M={B}, P21 digits; plain_ms on the first "
                     f"{SD_COLS} columns of each shape; no PyTorch call "
                     f"computes SD digit vectors")
    return matmul, matvec


def check_sd_add(torch, timer):
    """B8 bit for bit for each kind on the digit planes of two (4096, 4096)
    sd weights (3 x 16.8 M vectors), timed; then nx.add on the two weights
    (scales dropped: ring ops are defined on the codes), with the launch
    counters reset just before and read just after, and its decoded sum
    equal to (a + b) mod M, centred."""
    from repro_torch import kernels
    from repro_torch.kernels.sd_add import KINDS, sd_add_cuda, sd_add_ref
    from repro_torch.numerics import api as nx

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    spec = nx.EncodeSpec(layout="sd", qbits=4)
    wa, wb = (dataclasses.replace(nx.encode(torch.randn(
        *SD_ADD_SHAPE, generator=g, device="cuda"), spec), scale=None)
        for _ in range(2))
    n = wa.digit_width
    x, y = wa.planes.reshape(-1, n), wb.planes.reshape(-1, n)
    res = {}
    for kind in KINDS:
        out = sd_add_cuda(x, y, kind)
        if not torch.equal(out, sd_add_ref(x, y, kind)):
            raise AssertionError(f"sd_add[{kind}]: differs from the plain "
                                 f"version")
        del out
        ms = timer(lambda: sd_add_cuda(x, y, kind), 10)
        plain = timer(lambda: sd_add_ref(x, y, kind), 3)
        yard = timer(lambda: torch.add(x, y), 10)
        out_n = n + 1 if kind == "plain" else n
        bms, by = bound_ms(x.shape[0] * (2 * n + out_n), 0, "int8")
        res[kind] = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                         yardstick_int8_add_ms=yard)
        print(f"[kernels] sd_add[{kind}] {x.shape[0]} vectors of {n} "
              f"digits: bit-exact; kernel_ms={ms:.4f} plain_ms={plain:.4f} "
              f"bound_ms={bms:.4f} ({by}); yardstick int8 torch.add_ms="
              f"{yard:.4f}", flush=True)
    kernels.reset_launch_counts()
    s = nx.add(wa, wb)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    M = wa.mset.M
    want = torch.remainder(wa.to_int() + wb.to_int(), M)
    want = torch.where(want > M // 2, want - M, want)
    if not torch.equal(s.to_int(), want):
        raise AssertionError("nx.add: decoded sum differs from (a + b) mod M")
    if counts != dict(NO_LAUNCHES, sd_add=wa.mset.num_channels):
        raise AssertionError(f"nx.add launch counts {counts}")
    print(f"[kernels] nx.add on two sd-resident {SD_ADD_SHAPE} weights: "
          f"decoded sum equals (a + b) mod M centred; launches "
          f"{json.dumps(counts)}", flush=True)
    r = res["pow2p1"]
    return dict(r, library_ms=None, max_abs_err=0,
                launches=counts["sd_add"],
                per_kind={k: v["ms"] for k, v in res.items()},
                at=f"{x.shape[0]} digit vectors (the P21 planes of a "
                   f"{SD_ADD_SHAPE} weight), kind pow2p1 (per_kind: the four "
                   f"kinds); launches from nx.add on two sd-resident "
                   f"weights; no PyTorch call computes SD sums")


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
    want = dict(NO_LAUNCHES, rns_matmul=per_step * (1 + steps),
                flash_attention=cfg.n_layers,
                paged_decode=cfg.n_layers * steps)
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


def serve_redundant(torch):
    """Phases 5 and 6: qwen3-8b at full width on P21R2 / rns8r / strict,
    clean and then under injected faults."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.moduli import P21R2
    from repro_torch.models.api import build_model, resident_bytes
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.testing.faults import FaultSpec, inject_faults

    cfg = get_config("qwen3-8b")
    B, plen, max_new = 8, 256, 64
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, system="rns", rns_mset=P21R2, device="cuda")
    params = model.init(SEED)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    kw = dict(batch=B, s_max=plen + max_new + 1, page_size=64,
              kv_format="rns8r", device="cuda", policy="strict")
    engine = ServingEngine(model, params, **kw)
    del params
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (B, plen)).astype(np.int32)
    kernels.reset_launch_counts()
    res = engine.generate({"tokens": prompts}, max_new=max_new)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    rb = resident_bytes(engine.params)
    steps = max_new - 1
    st, f = res.stats, engine.stats.faults
    print(f"[serve-r] qwen3-8b L={cfg.n_layers} d={cfg.d_model} system=rns "
          f"mset=P21R2 kv=rns8r policy=strict B={B} prompt={plen} "
          f"new={max_new}: init_s={t_init:.2f} prefill_s={st.prefill_s:.3f} "
          f"decode_s={st.decode_s:.3f} decode_tok_s="
          f"{B * steps / st.decode_s:.2f} step_ms="
          f"{1e3 * st.decode_s / steps:.1f}", flush=True)
    print(f"[serve-r] resident weight bytes={rb} kv pool bytes="
          f"{engine.pool.pool_bytes()} max_memory_allocated={peak}",
          flush=True)
    print(f"[serve-r] launches {json.dumps(counts)}; faults "
          f"{json.dumps(dataclasses.asdict(f))}", flush=True)
    per_step = 7 * cfg.n_layers + 1
    want = dict(NO_LAUNCHES, rns_matmul=per_step * (1 + steps),
                flash_attention=cfg.n_layers,
                paged_decode_syndrome=cfg.n_layers * steps)
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    if any(dataclasses.asdict(f).values()):
        raise AssertionError(f"a clean run shows fault counters {f}")
    if res.tokens.shape != (B, max_new) or not (
            0 <= res.tokens.min() and res.tokens.max() < cfg.vocab):
        raise AssertionError("tokens misshapen or out of [0, vocab)")
    if not np.isfinite(res.prefill_logits).all():
        raise AssertionError("prefill logits not finite")
    print(f"[serve-r] seq0 tokens {res.tokens[0, :16].tolist()}", flush=True)

    # Phase 6.  Slot 0 holds pages 1..5 (the pool's free list hands out the
    # lowest page first), so layer 0, page 1, row 0 is a live prompt row.
    n_f = 16
    clean = res.tokens[:, :n_f]
    live = (0, 1, 0, 0, 0)
    before = dataclasses.replace(f)
    faults_a = [FaultSpec(kind="kv", which="k", channel=0, at=live,
                          bit=0x20),
                FaultSpec(kind="weight", channel=1, index=5, bit=0x11)]
    with inject_faults(engine, faults_a, after_steps=3) as log:
        out = engine.generate({"tokens": prompts}, max_new=n_f)
    d = {k: v - getattr(before, k)
         for k, v in dataclasses.asdict(engine.stats.faults).items()}
    print(f"[faults] (a) packed-byte K flip at {log[0][1]} + weight-plane "
          f"bit in information channel 1 of the logits weight at "
          f"{log[1][1]}: tokens equal clean "
          f"{bool(np.array_equal(out.tokens, clean))}; counters "
          f"{json.dumps(d)}", flush=True)
    if not np.array_equal(out.tokens, clean):
        raise AssertionError("faults (a): tokens differ from the clean run")
    if not (d["syndromes"] >= 1 and d["replays"] >= 1
            and d["recomputes"] == 0):
        raise AssertionError(f"faults (a): counters {d}")

    engine_b = ServingEngine(model, engine.params, quarantine_after=2, **kw)
    del engine
    torch.cuda.empty_cache()
    sticky = [FaultSpec(kind="kv_sticky", which="k", channel=2, at=live,
                        bit=0x01)]
    with inject_faults(engine_b, sticky, after_steps=3):
        out = engine_b.generate({"tokens": prompts}, max_new=n_f)
    fb = dataclasses.asdict(engine_b.stats.faults)
    print(f"[faults] (b) sticky K witness fault, quarantine_after=2: tokens "
          f"equal clean {bool(np.array_equal(out.tokens, clean))}; "
          f"quarantined pages {sorted(engine_b.pool.quarantined_pages)}; "
          f"counters {json.dumps(fb)}", flush=True)
    if not np.array_equal(out.tokens, clean):
        raise AssertionError("faults (b): tokens differ from the clean run")
    if fb["pages_quarantined"] < 1:
        raise AssertionError(f"faults (b): counters {fb}")
    return counts


def serve_sd(torch, smi):
    """Phase 7: qwen3-8b at full width, depth cut to SD_LAYERS of 36, under
    system="sdrns" (P21 digit planes, kernels B6 and B7) with rns8 pages,
    after its twin under system="rns" (P21 residue planes, kernel B1) on
    the same weights and prompts.  Both compute the same exact integer
    products, so the prefill logits and every token must be equal bit for
    bit."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model, resident_bytes
    from repro_torch.serving.engine import ServingEngine

    full = get_config("qwen3-8b")
    cfg = dataclasses.replace(full, n_layers=SD_LAYERS)
    B, plen, max_new = SD_BATCH, SD_PROMPT, SD_NEW
    kw = dict(batch=B, s_max=plen + max_new + 1, page_size=64,
              kv_format="rns8", device="cuda")
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (B, plen)).astype(np.int32)
    print(f"[serve-sd] cut: depth {SD_LAYERS} of {full.n_layers}, for time "
          f"and memory (full width: d_model {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv} heads, head_dim {cfg.hd}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}); {smi}", flush=True)

    t0 = time.perf_counter()
    model = build_model(cfg, system="rns", device="cuda")
    twin = ServingEngine(model, model.init(SEED), **kw).generate(
        {"tokens": prompts}, max_new=max_new)
    torch.cuda.synchronize()
    print(f"[serve-sd] twin system=rns (P21 residue planes) in "
          f"{time.perf_counter() - t0:.2f}s: prefill_s="
          f"{twin.stats.prefill_s:.3f} decode_s={twin.stats.decode_s:.3f}",
          flush=True)
    del model
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, system="sdrns", device="cuda")
    params = model.init(SEED)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    engine = ServingEngine(model, params, **kw)
    del params
    kernels.reset_launch_counts()
    res = engine.generate({"tokens": prompts}, max_new=max_new)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    rb = resident_bytes(engine.params)
    steps = max_new - 1
    st = res.stats
    L = cfg.n_layers
    print(f"[serve-sd] qwen3-8b L={L} d={cfg.d_model} system=sdrns (P21 "
          f"digit planes) kv=rns8 B={B} prompt={plen} new={max_new}: "
          f"init_s={t_init:.2f} prefill_s={st.prefill_s:.3f} decode_s="
          f"{st.decode_s:.3f} decode_tok_s={B * steps / st.decode_s:.2f} "
          f"step_ms={1e3 * st.decode_s / steps:.1f}", flush=True)
    print(f"[serve-sd] resident weight bytes={rb} kv pool bytes="
          f"{engine.pool.pool_bytes()} max_memory_allocated={peak}",
          flush=True)
    print(f"[serve-sd] launches {json.dumps(counts)}", flush=True)
    want = dict(NO_LAUNCHES, sdrns_matmul=7 * L,
                sdrns_matvec=1 + steps * (7 * L + 1), flash_attention=L,
                paged_decode=L * steps)
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    same_logits = np.array_equal(res.prefill_logits, twin.prefill_logits)
    same_tokens = np.array_equal(res.tokens, twin.tokens)
    print(f"[serve-sd] against the rns twin: prefill logits bit-identical "
          f"{same_logits}, tokens identical {same_tokens} "
          f"({res.tokens.size} tokens)", flush=True)
    if not (same_logits and same_tokens):
        raise AssertionError("sdrns serve differs from its rns twin")
    if res.tokens.shape != (B, max_new) or not (
            0 <= res.tokens.min() and res.tokens.max() < cfg.vocab):
        raise AssertionError("tokens misshapen or out of [0, vocab)")
    if not np.isfinite(res.prefill_logits).all():
        raise AssertionError("prefill logits not finite")
    print(f"[serve-sd] seq0 tokens {res.tokens[0].tolist()}", flush=True)
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
    from repro_torch.core.moduli import P21, P21R2
    rm = check_rns_matmul(torch, timer, gen, P21, "P21")
    rm_r = check_rns_matmul(torch, timer, gen, P21R2, "P21R2")
    fa = check_flash_attention(torch, timer, gen)
    pd = check_paged_decode(torch, timer, gen)
    ps = check_paged_decode_syndrome(torch, timer, gen)
    sdm, sdv = check_sdrns_matmul(torch, timer, gen)
    sda = check_sd_add(torch, timer)
    del timer
    torch.cuda.empty_cache()
    check_small(torch)
    counts = serve_full_width(torch)
    torch.cuda.empty_cache()
    counts_r = serve_redundant(torch)
    gc.collect()
    torch.cuda.empty_cache()
    counts_sd = serve_sd(torch, smi)

    src_dir = "src/repro_torch/csrc/"
    entries = [
        ("rns_matmul", src_dir + "rns_matmul.cu",
         "src/repro/kernels/rns_matmul.py:73", rm),
        ("flash_attention", src_dir + "flash_attn.cu",
         "src/repro/kernels/flash_attn.py:131", fa),
        ("paged_decode", src_dir + "flash_attn.cu",
         "src/repro/kernels/flash_attn.py:385", pd["rns8"]),
        ("paged_decode_syndrome", src_dir + "flash_attn.cu",
         "src/repro/kernels/flash_attn.py:385 (red_moduli)", ps),
        ("sdrns_matmul", src_dir + "sdrns_matmul.cu",
         "src/repro/kernels/sdrns_matmul.py:109", sdm),
        ("sdrns_matvec", src_dir + "sdrns_matmul.cu",
         "src/repro/kernels/sdrns_matmul.py:154", sdv),
        ("sd_add", src_dir + "sd_add.cu", "src/repro/kernels/sd_add.py:68",
         sda),
    ]
    # launches: B1-B3 from [serve], the syndrome mode from [serve-r], B6
    # and B7 from [serve-sd], B8 from nx.add (the path each is measured
    # on); the other serves' counts are beside them
    launched = dict(counts, paged_decode_syndrome=counts_r[
        "paged_decode_syndrome"], sdrns_matmul=counts_sd["sdrns_matmul"],
        sdrns_matvec=counts_sd["sdrns_matvec"], sd_add=sda["launches"])
    fixed = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "at")
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": rep,
         "launches": launched[name], "launches_serve_r": counts_r[name],
         "launches_serve_sd": counts_sd[name],
         **{k: r[k] for k in fixed},
         **{k: v for k, v in r.items() if k not in fixed + ("launches",)}}
        for name, source, rep, r in entries]}
    # B1 on the P21R2 planes of [serve-r] (C = 5), held and timed as above
    line["kernels"][0]["p21r2"] = dict(
        {k: rm_r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms", "at")},
        launches=counts_r["rns_matmul"])
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
