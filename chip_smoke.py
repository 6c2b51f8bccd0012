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
   bit in each kind, from an odd storage offset too, and through
   ``nx.add``; rns_matmul at the speculative verify's 40 rows and on the
   rns drafter's P16 planes at 3 bits in their K segments; the paged
   decode at the verify's folded 40 rows, each row equal to its own
   launch) and time kernel, plain version and a library yardstick the port
   never calls, beside the bound.
3. small   -- the quantizers give the same bits on the card as on the CPU,
   and the committed reduced qwen3-8b checkpoint served on the card and on
   the CPU (plain versions) gives prefill logits that agree.
4. serve   -- qwen3-8b at full width with the depth cut to 18 of 36 layers
   for time (random weights from seed 0) under ``system="rns"`` with rns8
   KV pages: batch 8, 256-token prompts,
   64 new tokens, greedy.  Launch counters are reset just before and read
   just after, and must show every kernel on the path.
   serve-spec -- speculative decoding on that model, weights and prompts:
   one ``verify_paged`` of k + 1 = 5 tokens a slot equal to 5
   ``decode_paged`` steps bit for bit (logits rows and page bytes), then
   ``spec="ngram:4"`` for 64 new tokens and ``spec="rns:4"`` (the draft
   derived from the target's planes, P16 at 3 bits) for 12: 0 tokens
   differ from phase 4's, and the launch counts are exact per verify and
   per draft step.
   serve-sched -- continuous serving on that model and weights
   (``serving/scheduler.py``): 24 requests of 16-512 prompt tokens and
   8-64 new through B 8 slots, 8 sharing a 256-token prefix, 4 repeating
   a page-aligned prompt, one ending at an EOS taken from its solo run.
   Gates: budgets and EOS kept, a request admitted while another slot is
   mid-decode, the pool's prefix hits and prefill skips equal to what the
   admission order implies, every page free or cached-free at the end,
   four requests re-served alone bit for bit, ``spec="ngram:4"`` giving
   the same tokens, exact launch counts, the first step's B3 launches
   against the plain version; prints requests/s, tokens/s and the p50 /
   p95 latency.
5. serve-r -- the same serve, depth cut to 12 of 36 layers for time, on
   redundant residues: P21R2 weight planes,
   rns8r KV pages and ``policy="strict"``, with the paged decode's syndrome
   mode on every step.  The clean run must show zero syndromes and replays.
6. faults -- the same engine under ``testing.faults.inject_faults``: (a) a
   packed-byte flip in a live K page plus a weight-plane bit in an
   information channel, (b) a sticky KV fault with ``quarantine_after=2``,
   (c) the scheduler serving 8 requests under that sticky fault, the
   holder recomputed by re-admission.  The tokens must equal the clean
   run's.

7. serve-sd -- qwen3-8b at full width with the depth cut to 8 of 36 layers
   (21 B of digit planes per weight) under ``system="sdrns"``: P21 digit
   planes, rns8 pages, batch 2, 16-token prompts, 8 new tokens, greedy,
   after its twin under ``system="rns"``.  Prefill logits and tokens must
   equal the twin's bit for bit; launch counts are exact.
8. serve-dense -- [serve]'s model and resident weights (qwen3-8b at full
   width, 18 layers, under ``system="rns"``), run right after
   [serve-sched],
   with ``paged=False`` (the dense bf16 cache, kernel B5), batch 8,
   256-token prompts, 64 new tokens, greedy, beside its twin on bf16 pages,
   both with the decode chunk set to the page size: prefill logits and
   tokens equal bit for bit, exact launch counts, and the B5 launches of
   the first decode step equal to the plain version on their own inputs.
   roofline -- the work of one prefill and one decode step of that model
   (``model.prefill`` at s_max = prompt + 1, then ``model.decode`` of one
   token on the dense cache) counted by ``roofline/op_cost.py`` on the card
   and on a meta build of the same config and shapes: equal op by op and
   kind by kind, the decode step's B1 bound equal to the kernel table's
   (QWEN3_STEP's shapes at this depth); prints the counts, the compute and
   memory terms, the measured steps, the roofline share and the MFU beside
   the card's name and power limit.
9. serve-hybrid -- zamba2-7b at full width and depth (81 Mamba2 layers, 13
   applications of the shared attention block, 3 tail layers) under
   ``system="rns"`` on the dense bf16 cache, batch 8, 256-token prompts, 64
   new tokens, greedy: every logit finite, exact launch counts, and the B5
   launches of the first decode step equal to the plain version on that
   step's own inputs.

10. serve-configs -- yi-6b, phi3-medium-14b and granite-20b at full width
   with the depth cut to 4 layers each under ``system="rns"`` on rns8
   pages, batch 8, 256-token prompts, 16 new tokens, greedy: finite
   logits, exact launch counts, the B1 and B3 launches of the first decode
   step (granite's B3: 48 query heads on one KV head) equal to the plain
   version on their own inputs, and every B1 and B2 launch of the prefill,
   run again untimed, held against its plain version as it returns.
11. serve-ssm -- mamba2-780m at full width and depth (48 Mamba2 layers, no
   attention) under ``system="rns"`` from its SSM state alone, batch 8,
   256-token prompts, 64 new tokens: finite logits, exact B1 counts, and
   the B1 launches of the first decode step equal to the plain version.
12. serve-moe -- moonshot-v1-16b-a3b at full width (64 experts, top-6)
   with the depth cut to 38 of 48 layers under ``system="rns"`` on rns8
   pages, batch 8, 256-token prompts, 32 new tokens: finite logits, exact
   launch counts with each stacked expert einsum one B1 launch, the B3
   launches of the first decode step equal to the plain version, the
   prefill and that step run again untimed with every B1, B2 and B3
   launch held against its plain version as it returns, and the step
   bit-identical to the same step run with one B1 launch per expert (both
   timed warm).
13. serve-vlm -- pixtral-12b at full width, 20 of its 40 layers (attention
   width 4096 against d_model 5120) under ``system="rns"`` on rns8 pages,
   batch 8, 1024 synthetic patch embeddings then 256 text tokens, 32 new:
   finite logits, exact launch counts, the B1 and B3 launches of the first
   decode step and every B1 and B2 launch of the prefill held against the
   plain versions.
14. serve-audio -- whisper-small at full width and depth (12 encoder and
   12 decoder layers) under ``system="rns"``, batch 8, 1500 synthetic
   frames, an 8-token decoder prompt, 64 new: the same gates, the B5
   launches of the first step (self cache and cross memory) held, and the
   prefill's B2 launches held in their order, the encoder's and the
   cross-attention's with ``causal=False``.

15. train -- qwen3-8b at full width with the depth cut to 4 of 36 layers
   (f32 parameters and moments), trained under ``system="rns"``: the
   per-call residue matmul (int4 codes of float weights, planes made at
   every call) with its straight-through f32 backward, remat, 4 AdamW
   steps of 16 x 256 tokens in 2 micro-batches (B1 at M 2048), then the
   same steps under ``system="bns"`` from the same weights.  Gates: every
   B1 launch of the first step held against the plain version as it
   returns; on layer 0's seven weights and the logits weight the per-call
   ``dense`` equal to the prepared planes' bit for bit; exactly (2 x 7 x L
   + 1) x 2 B1 launches a step and no other kernel; loss, grad norm and
   every parameter finite after each step.  Prints the step times, the B1
   time inside a step, the per-call weight encode timed by itself, the
   peak memory and the losses.
   train-small -- the reduced qwen3-8b on the card: the loss falls by more
   than 1.0 over 30 steps; a run that fails before step 5 and restarts
   from its checkpoint ends bit-identical to an uninterrupted one; the
   sdrns step's loss and gradients equal the rns step's bit for bit, every
   B6 launch held; ``ServingEngine(prepare=False)`` gives the prepared
   engine's prefill logits and tokens; the prepared tree saved from the card
   (``train/checkpoint.py``, the reference's ``.../w/0`` / ``.../w/1``
   layout) and restored onto the card serves the same logits and tokens.
16. cnn -- the paper's DNN evaluation (``data/cifar.py``) at its published
   CIFAR shapes: AlexNet trained as ``examples/torch_rns_cnn_inference.py``
   trains it (60 float SGD steps under ``bns``), VGG-16 on random weights
   from seed 0; 256 synthetic test images in batches of 64 under ``bns``,
   ``rns`` and ``sdrns`` (int6 codes, P21: every conv and fc a B1 launch a
   K segment, or B6, and B7 at a batch of 8).  Gates: AlexNet's rns
   logits equal a plain integer oracle (float64 products of the same
   codes) bit for bit, sdrns logits equal rns's bit for bit on both nets,
   B1's launches of one AlexNet forward and the B6 / B7 launches of an
   AlexNet and a VGG forward held against the plain versions (B6 / B7 on
   a sample of rows and columns), launch counts equal to the segment
   cuts', AlexNet's rns accuracy within 0.08 of float.  Prints ms a batch,
   images/s, each kernel's device ms inside a forward beside
   ``torch._int_mm``'s time over the same B1 launch shapes, the peak
   memory and the Eq. 3 speedups at each net's op mix beside the card's
   ratios.

17. mesh -- qwen3-8b at full width served across ranks that share the
   card (``torch.multiprocessing``, start method ``spawn``; a ``gloo``
   group through a ``file://`` init, CUDA tensors staged through host
   memory for its collectives), on the dense cache, beside the same model
   served in this process with no shard context: (a) the column plan on a
   (1, 2) mesh (wo and w_down, K over the model axis, on the row plan),
   2 layers, batch 8, 256-token prompts, 8 new; (b) the
   channel plan on (1, 3), one of P21's channels a rank, the decode through
   the partial-CRT all-reduce; (c) P21R2's channel plan on (1, 5), 1 layer,
   an information channel's plane corrupted on rank 0; (d) sdrns on (1,
   3), 1 layer, batch 2, 16-token prompts, 4 new, beside its rns twin.
   Gates: prefill logits and tokens bit for bit against the single
   process on every rank; every rank's B1 / B2 / B5 / B6 / B7 launches
   equal to the single process's, B9's one a B1 launch on P21 (the single
   process, the column and row plans) and none under the channel plan,
   and its plane bytes 1 / n of the whole;
   no plane block gathered by a plan (the collective bytes a decode step
   are printed); rank 0's first decode step's B1 and B5 launches, and in
   (d) its every B6 and B7 launch, held against the plain versions; (c)
   the fault repaired in the output and by ``nx.scrub``; (d) equal to the
   rns twin.  No collective time is reported.  Then, in the same ranks,
   the sharded train step (``train/loop.py``'s ``TrainSharding``, FSDP
   over the data axis and TP over the model axis, ``seq_shard`` on) of
   qwen3-8b at full width, 2 layers, ``rns``, f32 activations, 8 x 128
   tokens in 2 micro-batches, 2 AdamW steps: (e) on (1, 2), (f) on (2,
   2), beside the same steps in this process.  Gates: losses and gradient
   norms within 1e-5, the first step's gradients and the parameters after
   the last within rtol 2e-4 / atol 2e-5 on 4096 seeded elements a leaf,
   every rank's B1 launches a step equal to the single process's, rank
   0's first-step B1 launches held against the plain version, (e)'s
   forward logits bit for bit.  Prints the parameter and moment bytes a
   rank, the collective bytes a step and the step seconds.

Phase 3 also serves the reduced zamba2 on the card and on the CPU
([small-hybrid]); phase 2 also holds B5 (the dense-cache decode) at the
shapes the two dense serves launch it with, at the qwen3 and zamba2 decode
shapes in one chunk, a split shape with all-masked chunks and in f32, B2 at
zamba2's head_dim 112 and B1 at every zamba2 shape, decode and prefill;
B1 in stack mode at moonshot's expert einsums (64 slices, M 8 and M 240)
against its plain version and 64 launches of one slice; B2 and B3 at
granite-20b's heads; B2 at whisper's encoder and cross-attention (hd 64,
non-causal) and at pixtral's prefill, B5 at whisper's self cache and cross
memory, and B1 at both models' shapes, whisper's logits shape (N 51865, an
odd row stride) included; B1 at the CNN's conv1 (K 27: an odd A row
stride), VGG-16's conv2 (M 65536) and fc shapes, and B6 at that conv2;
B9 (the reverse conversion after B1, the port's own kernel) bit for bit
against the eager ``from_residues`` on every set it takes, written and
added into a sum (unstacked, odd-length, stacked, [serve-moe]'s expert
stack, more stacks than a grid row, 5 K segments added in place), and at
the prefill (M 16384, N 12288) and decode (M 8) shapes, where it is timed
beside the eager decode and its bound.  Every exact launch-count gate
counts B9 too: one a B1 launch wherever the rns runner decodes without
the witness check.
Every phase prints its command time ([time]).

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

SEED = 0
FLUSH_BYTES = 256 << 20      # > the 50 MB L2: every timed launch starts cold

# qwen3-8b matmul shapes (K, N) and their count per layer; logits once.
LAYER_MATMULS = [((4096, 4096), 2), ((4096, 1024), 2), ((4096, 12288), 2),
                 ((12288, 4096), 1)]
LOGITS = (4096, 151936)
# one qwen3-8b decode step: 36 layers x (q, k, v, o, gate, up, down), logits
QWEN3_STEP = [((K, N), 36 * n) for (K, N), n in LAYER_MATMULS] + [(LOGITS, 1)]
KERNELS = ("rns_matmul", "flash_attention", "paged_decode",
           "paged_decode_syndrome", "flash_decode", "sdrns_matmul",
           "sdrns_matvec", "sd_add", "rns_decode")
NO_LAUNCHES = dict.fromkeys(KERNELS, 0)


def with_b9(want):
    """``want`` with B9's launches: one a B1 launch wherever the rns runner
    decodes without the witness check (every path on P21 or P16)."""
    return dict(want, rns_decode=want["rns_matmul"])

# [serve-sd]: qwen3-8b at full width, depth cut to 8 of 36 layers for time
# and memory (21 B of digit planes per weight: 4.05 GB a layer, 13.07 GB
# for the tied logits weight)
SD_LAYERS, SD_BATCH, SD_PROMPT, SD_NEW = 8, 2, 16, 8
SD_COLS = 256                # columns of the plain version's SD check
SD_ADD_SHAPE = (4096, 4096)  # the weight whose digit planes B8 adds
# zamba2-7b matmul shapes (K, N) and their count per decode step: 81 Mamba2
# in/out projections, 13 shared blocks (in_proj, q, k, v, o, gate, up,
# down), the logits last
HYBRID_MATMULS = [((3584, 14576), 81), ((7168, 3584), 81 + 13),
                  ((3584, 3584), 4 * 13), ((3584, 14336), 2 * 13),
                  ((14336, 3584), 13), ((3584, 32000), 1)]
SERVE_B, SERVE_PROMPT, SERVE_NEW = 8, 256, 64
# [serve] (and [serve-spec], [serve-sched], [serve-dense] on its model) and
# [serve-r] (with [faults]): qwen3-8b at full width, depth cut for time
# (at 36 layers the smoke took 1006 s of its 1200 s on an NVIDIA H100 80GB
# HBM3 at 700 W whose host ran [serve]'s steps 1.4x slower than usual)
SERVE_LAYERS, R_LAYERS = 18, 12
# [serve-spec]: k draft tokens a verify (V = k + 1 rows a slot), and the new
# tokens of each drafter's run.  The rns drafter runs k + 1 host-bound draft
# steps a verify (3.6 s a verify on random weights, where it accepts
# nothing): 12 new tokens, not 64, keep the smoke near half its time limit
# (16 until the reverse conversion's check joined [kernels])
SPEC_K = 4
SPEC_NEW = {"ngram:4": SERVE_NEW, "rns:4": 12}
# moonshot-v1-16b-a3b's expert einsums: 64 experts, top-6; (K, N) and their
# count per layer (gate and up, then down)
MOE_E, MOE_TOPK = 64, 6
MOE_EINSUMS = [((2048, 1408), 2), ((1408, 2048), 1)]
# Moonlight-16B-A3B has the same expert einsums; the benchmark's admission
# holds 8 prompts of 512-2048 tokens, log-uniform (mean (2048 - 512) / ln 4
# = 1108), and the capacity follows the real tokens: the expert stack's M
# is moe_capacity(T, 64, 6) at all 8 prompts at 2048 (T 16384, M 1920) and
# at the mix's mean (T 8864, M 1040)
MLA_ADMIT_T = {"moonlight prefill 8x2048": 8 * 2048,
               "moonlight prefill mean": 8 * 1108}
# its dense products (label, K, N), B1 then B9 through rns_run at M 8 and
# at the admission's padded 8 x 2048 rows: q, kv_a (latent 512 + rope 64),
# kv_b (16 x (128 + 128)), o, layer 0's gate and up, its down, the shared
# experts' gate and up, their down; the untied head at M 8 alone
MLA_MATMULS = [("q", 2048, 3072), ("kv_a", 2048, 576), ("kv_b", 512, 4096),
               ("o", 2048, 2048), ("dense_up", 2048, 11264),
               ("dense_down", 11264, 2048), ("shared_up", 2048, 2816),
               ("shared_down", 2816, 2048)]
MLA_HEAD, MLA_PREFILL_M = ("head", 2048, 163840), 8 * 2048
# [serve-moe]: depth cut to 38 of 48 layers for memory (1.711 GB of P21
# planes a layer; 48 layers and the logits planes would need ~84 GB; at 40
# the serve's peak, 79.28 GB, left 5.74 GB of the card's 85.02 GB free,
# under an 8 GB margin)
MOE_LAYERS, MOE_NEW = 38, 32
# [serve-configs]: yi-6b, phi3-medium-14b and granite-20b at full width,
# depth cut to 4 layers each for time (granite whole would need ~84 GB)
CONFIG_ARCHS = ("yi-6b", "phi3-medium-14b", "granite-20b")
CONFIG_LAYERS, CONFIG_NEW = 4, 16
# [serve-vlm]: pixtral-12b at full width and depth; (K, N) of each matmul and
# its launches a decode step (q; k and v; o; gate and up; down), the tied
# logits last.  1024 patch embeddings, then VLM_TEXT text tokens
PIXTRAL_MATMULS = [((5120, 4096), 40), ((5120, 1024), 80),
                   ((4096, 5120), 40), ((5120, 14336), 80),
                   ((14336, 5120), 40), ((5120, 131072), 1)]
VLM_TEXT, VLM_NEW = 256, 32
# [serve-vlm]'s depth: 20 of pixtral's 40 layers, for time ([mesh]'s train
# cases spend ~200 s in gloo collectives through the host; at 40 layers
# this phase took ~45 s on an NVIDIA H100 80GB HBM3 at 700 W)
VLM_LAYERS = 20
# [serve-audio]: whisper-small at full width and depth (12 encoder and 12
# decoder layers); the decode step's matmuls: (768, 768) six a layer (self
# q, k, v, o; cross q, o), up, down.  Its logits are a float product, as
# the reference's (models/encdec.py), so B1 at the logits' shape (N 51865,
# an odd row stride: the byte-load path) is held and timed with no serve
# launches.  AUDIO_FRAMES: whisper's 30-second window after its conv stack
WHISPER_MATMULS = [((768, 768), 72), ((768, 3072), 12), ((3072, 768), 12),
                   ((768, 51865), 0)]
AUDIO_FRAMES, AUDIO_PROMPT, AUDIO_NEW = 1500, 8, 64
# [serve-sched]: continuous serving of SCHED_N requests on [serve]'s model
SCHED_N, SCHED_SPEC = 24, "ngram:4"
DENSE_BK = 64                # [serve-dense]'s decode chunk = its twin's pages
# [train]: qwen3-8b at full width, depth cut to 4 of 36 layers for memory
# (f32 parameters, gradients and two f32 moments: 16 B a parameter, ~22 GB
# at 4 layers with the tied 622 M-parameter table, ~121 GB at 36); batch
# 16 x 256 tokens in 2 micro-batches, so B1 runs at M 2048
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO, TRAIN_STEPS = 4, 256, 16, \
    2, 4
# [cnn]: the paper's DNN evaluation (data/cifar.py) at its published CIFAR
# shapes.  AlexNet trains as examples/torch_rns_cnn_inference.py trains it
# (float SGD under bns), then CNN_EVAL test images run in batches of
# CNN_BATCH under bns, rns and sdrns at CNN_BITS on P21; VGG-16 runs random
# weights, and one batch of CNN_SMALL (its fc layers at M 8 take B7).  The
# sdrns activation digits of VGG's conv2 are (3, 65536, 576, 7) int8 at
# batch 64 (0.8 GB), 4x that at 256: hence the batches.  B6 and B7
# launches are held on their first CNN_ROWS rows and SD_COLS columns
CNN_TRAIN_STEPS, CNN_TRAIN_N, CNN_EVAL, CNN_BATCH = 60, 4096, 256, 64
CNN_BITS, CNN_SMALL, CNN_ROWS = 6, 8, 32
# B1 at the CNN's new load paths: conv1 (K 27, a 27-byte A row stride: the
# byte path), VGG conv2 (the largest conv, M 65536), AlexNet-scale fc
CNN_B1_SHAPES = [(65536, 27, 64), (65536, 576, 64), (64, 4096, 4096)]
CNN_B6_SHAPE = (65536, 576, 64)
# kernel ms of the bodies B1-B8 replaced, at the same shapes (chip_smoke.py
# on an NVIDIA H100 80GB HBM3, 700 W, before the tensor-core prefill, the
# row-parallel decode chunk, the packed K-parallel SD body, B1's two
# schedules and B8's packed tiles; PERF.md's kernel table).  Printed beside
# the kernel's time in the [kernels] lines only; the JSON line carries
# this run's numbers alone.
BEFORE_MS = {"flash_attention[qwen3]": 0.380, "flash_attention[zamba2]": 0.362,
           "paged_decode[bf16]": 0.029, "paged_decode[rns8]": 0.054,
           "paged_decode[rns4]": 0.053, "paged_decode_syndrome[rns8r]": 0.170,
           "flash_decode[serve_dense]": 0.045,
           "flash_decode[serve_hybrid]": 0.207, "flash_decode[qwen3]": 0.154,
           "flash_decode[zamba2]": 0.208, "flash_decode[split]": 0.248,
           "flash_decode[qwen3_f32]": 0.130,
           # B7 (M 2) and B6 (M 32) at [serve-sd]'s shapes (M, K, N), and
           # B7's decode step: the body with one thread's K tree a column
           "sdrns_matvec[2,4096,4096]": 12.803,
           "sdrns_matvec[2,4096,1024]": 6.957,
           "sdrns_matvec[2,4096,12288]": 11.308,
           "sdrns_matvec[2,12288,4096]": 38.168,
           "sdrns_matvec[2,4096,151936]": 62.697,
           "sdrns_matvec[step]": 865.1,
           "sdrns_matmul[32,4096,4096]": 69.238,
           "sdrns_matmul[32,4096,1024]": 53.059,
           "sdrns_matmul[32,4096,12288]": 104.582,
           "sdrns_matmul[32,12288,4096]": 218.048,
           # B1 (its one-tile body, before the two schedules) at every
           # [kernels] shape (label, M, K, N) and its decode-step sums
           "rns_matmul[P21,8,4096,4096]": 0.1032,
           "rns_matmul[P21,8,4096,1024]": 0.0957,
           "rns_matmul[P21,8,4096,12288]": 0.1502,
           "rns_matmul[P21,8,12288,4096]": 0.2797,
           "rns_matmul[P21,2048,4096,4096]": 1.3437,
           "rns_matmul[P21,2048,4096,1024]": 0.3596,
           "rns_matmul[P21,2048,4096,12288]": 3.9336,
           "rns_matmul[P21,2048,12288,4096]": 3.9218,
           "rns_matmul[P21,8,4096,151936]": 1.453,
           "rns_matmul[P21,step]": 36.659,
           "rns_matmul[P21R2,8,4096,4096]": 0.1187,
           "rns_matmul[P21R2,8,4096,1024]": 0.0966,
           "rns_matmul[P21R2,8,4096,12288]": 0.2383,
           "rns_matmul[P21R2,8,12288,4096]": 0.3083,
           "rns_matmul[P21R2,2048,4096,4096]": 2.2742,
           "rns_matmul[P21R2,2048,4096,1024]": 0.5809,
           "rns_matmul[P21R2,2048,4096,12288]": 6.5631,
           "rns_matmul[P21R2,2048,12288,4096]": 6.486,
           "rns_matmul[P21R2,8,4096,151936]": 2.4494,
           "rns_matmul[P21R2,step]": 46.21,
           "rns_matmul[zamba2,8,3584,14576]": 0.2097,
           "rns_matmul[zamba2,8,7168,3584]": 0.1771,
           "rns_matmul[zamba2,8,3584,3584]": 0.0908,
           "rns_matmul[zamba2,8,3584,14336]": 0.1905,
           "rns_matmul[zamba2,8,14336,3584]": 0.3339,
           "rns_matmul[zamba2,2048,3584,14576]": 4.1295,
           "rns_matmul[zamba2,2048,7168,3584]": 2.0772,
           "rns_matmul[zamba2,2048,3584,3584]": 1.0263,
           "rns_matmul[zamba2,2048,3584,14336]": 4.0197,
           "rns_matmul[zamba2,2048,14336,3584]": 4.0,
           "rns_matmul[zamba2,8,3584,32000]": 0.3112,
           "rns_matmul[zamba2,step]": 47.959,
           # B8, a thread a digit vector, at check_sd_add's shape
           "sd_add[pow2m1]": 0.805, "sd_add[pow2]": 0.648,
           "sd_add[pow2p1]": 0.802, "sd_add[plain]": 0.688}


# the earlier times taken on other kv_len draws than this run's: the same
# shape, but other valid rows (PERF.md compares them by their bounds)
BEFORE_OTHER_DRAW = {"paged_decode[bf16]", "paged_decode[rns8]",
                   "paged_decode[rns4]", "paged_decode_syndrome[rns8r]",
                   "flash_decode[qwen3]", "flash_decode[zamba2]",
                   "flash_decode[split]", "flash_decode[qwen3_f32]"}


def earlier(key: str) -> str:
    if key not in BEFORE_MS:
        return ""
    draw = ", other kv_len draw" if key in BEFORE_OTHER_DRAW else ""
    return f" (before the redesign: {BEFORE_MS[key]:.3f}{draw})"


def bound_ms(work) -> tuple[float, str]:
    """The least ms on the card for ``work`` (a ``roofline.op_cost.Work``
    from the op's cost function): its bytes at the HBM rate or its
    operations at their kind's peak (``roofline/hw.py``), whichever is
    larger, and which one it is."""
    from repro_torch.roofline import op_cost

    return op_cost.bound_ms(work.bytes, work.ops, work.kind)


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


def ptxas_lines(log_path, source: str) -> list[str]:
    """Registers, stack frame and spills of each kernel compiled from
    ``source``, from the build's ``-Xptxas -v`` log."""
    import re

    if not os.path.exists(log_path):
        return [f"{source}: no nvcc log at {log_path}"]
    text = open(log_path).read()
    sec = text.split(f"== {source}\n", 1)[-1].split("\n== ", 1)[0]
    found, name = [], None
    for line in sec.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            name, spills = m.group(1), "spills not reported"
        elif (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                             r"loads", line)) and name:
            spills = f"spills {m.group(1)}/{m.group(2)} B"
            if st := re.search(r"(\d+) bytes stack frame", line):
                spills = f"stack frame {st.group(1)} B, {spills}"
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            found.append((name, int(m.group(1)), spills))
            name = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(
            n for n, _, _ in found), capture_output=True, text=True,
            check=True, timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = [n for n, _, _ in found]
    short = [re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", n)
             for n in names]
    return [f"{source}: {n}: {r} registers, {sp}"
            for n, (_, r, sp) in zip(short, found)]


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _int_mm_same(torch, a_mm, b_mm, moduli, M, N):
    """B1's function through ``torch._int_mm``, one call a channel, then the
    same truncating rem, canonicalize and center (the rows past M of a
    padded A and the columns past N of a padded B are dropped first)."""
    outs = []
    for c, m in enumerate(moduli):
        acc = torch._int_mm(a_mm[c], b_mm[c])[:M, :N]
        r = torch.fmod(acc, m)
        r = torch.where(r < 0, r + m, r)
        outs.append(torch.where(r > m // 2, r - m, r))
    return torch.stack(outs)


def _int_mm_best(torch, timer, a, b, moduli, ref, what):
    """The library time of B1's function: ``torch._int_mm`` per channel
    (A padded to 32 rows where M is smaller, which ``_int_mm`` refuses) on
    B as stored and on a K-contiguous copy made outside the timed region,
    each held equal to the plain version; returns the faster time and its
    layout.  An N or a K that is not a multiple of 8 (``_int_mm`` refuses
    it) is padded with zero columns or zero terms, the copy not timed."""
    C, M, K = a.shape
    N = b.shape[2]
    pad = max(M, 32)
    a_mm = a if pad == M else torch.cat(
        [a, a.new_zeros((C, pad - M, K))], dim=1)
    k_pad = -K % 8
    if k_pad:
        a_mm = torch.cat([a_mm, a_mm.new_zeros((C, pad, k_pad))], dim=2)
        b = torch.cat([b, b.new_zeros((C, k_pad, N))], dim=1)
    n_pad = -N % 8
    if n_pad:
        b = torch.cat([b, b.new_zeros((C, K + k_pad, n_pad))], dim=2)
    wide = (f", K padded to {K + k_pad}" if k_pad else "") + (
        f", N padded to {N + n_pad}" if n_pad else "")
    wide += ", copy not timed" if wide else ""
    lib, layout = None, None
    for name, b_mm in (("B as stored (N contiguous)" + wide, b),
                       ("B copied K-contiguous, copy not timed" + (
                           wide.replace(", copy not timed", "")),
                        b.transpose(1, 2).contiguous().transpose(1, 2))):
        try:
            lib_out = _int_mm_same(torch, a_mm, b_mm, moduli, M, N)
        except RuntimeError:
            continue
        if not torch.equal(lib_out, ref):
            raise AssertionError(f"{what}: torch._int_mm differs from the "
                                 f"plain version")
        del lib_out
        t = timer(lambda: _int_mm_same(torch, a_mm, b_mm, moduli, M, N), 10)
        if lib is None or t < lib:
            lib, layout = t, name
        del b_mm
    if lib is None:
        raise AssertionError(f"{what}: torch._int_mm refused both layouts")
    return lib, layout


def b1_shape(torch, timer, gen, mset, label, M, K, N):
    """B1 at one shape on the planes of ``mset``, operands drawn over the
    full centred range of its widest modulus: held bit for bit against the
    plain version, then kernel, plain version, ``_int_mm`` and a bf16
    ``bmm`` yardstick timed beside the bound (see ``check_rns_matmul``)."""
    from repro_torch.kernels.rns_matmul import rns_matmul_cuda, rns_matmul_ref
    from repro_torch.roofline import op_cost

    C, h = mset.num_channels, max(mset.moduli) // 2
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
    pad = max(M, 32)
    lib, layout = _int_mm_best(torch, timer, a, b, mset.moduli, ref,
                               f"rns_matmul[{label}] M={M} K={K} N={N}")
    del out, ref
    ab, bb = a.to(torch.bfloat16), b.to(torch.bfloat16)
    ms = timer(lambda: rns_matmul_cuda(a, b, mset.moduli), 10)
    plain = timer(lambda: rns_matmul_ref(a, b, mset.moduli), 3)
    bmm = timer(lambda: torch.bmm(ab, bb), 10)
    bms, by = bound_ms(op_cost.COSTS["rns_matmul"](a, b, mset.moduli))
    key = f"rns_matmul[{label},{M},{K},{N}]"
    padded = f", M padded to {pad}" if pad != M else ""
    print(f"[kernels] rns_matmul[{label}] C={C} M={M} K={K} N={N} "
          f"operands in [-{h}, {h}]: bit-exact; kernel_ms={ms:.4f}"
          f"{earlier(key)} plain_ms={plain:.4f} library_ms(_int_mm"
          f"{padded}, {layout})={lib:.4f} yardstick bf16_bmm_ms="
          f"{bmm:.4f} bound_ms={bms:.4f} ({by})", flush=True)
    del a, b, ab, bb
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain, library_ms=lib,
                yardstick_bf16_bmm_ms=bmm, bound_ms=bms, bound_by=by,
                err=err)


def check_rns_matmul(torch, timer, gen, mset, label, step,
                     prefill_m=SERVE_B * SERVE_PROMPT):
    """B1 on the planes of ``mset`` at one model's shapes, operands drawn
    over the full centred range of its widest modulus.  ``step`` lists each
    shape (K, N) with its launches per decode step, the logits last: each is
    held bit for bit at M = 8 (decode) and, but the logits, at the serve's
    prefill M (``prefill_m``).  zamba2's N = 14576 (the Mamba2 in_proj) is not a multiple of
    the kernel's 128-column tiles, so its edge tiles are held too.

    Beside the kernel: its plain version, ``torch._int_mm`` per channel with
    the same rem and centring (the same function; M padded to 32 at M <= 16,
    which ``_int_mm`` refuses; timed on B as stored and on a K-contiguous
    copy made outside the timed region, the faster layout kept and
    printed), and a bf16 ``bmm`` of the same operands as a yardstick (not
    the same function)."""
    C = mset.num_channels
    shapes = [(M, K, N) for M in (8, prefill_m)
              for (K, N), _ in step[:-1]]
    shapes.append((8, *step[-1][0]))
    per = {(M, K, N): b1_shape(torch, timer, gen, mset, label, M, K, N)
           for M, K, N in shapes}
    n = sum(c for _, c in step)
    keys = ("ms", "plain_ms", "library_ms", "yardstick_bf16_bmm_ms",
            "bound_ms")
    total = {k: sum(per[(8, K, N)][k] * c for (K, N), c in step)
             for k in keys}
    print(f"[kernels] rns_matmul[{label}] one decode step ({n} launches, "
          f"M=8): kernel_ms={total['ms']:.3f}"
          f"{earlier(f'rns_matmul[{label},step]')} "
          f"plain_ms={total['plain_ms']:.3f} "
          f"library_ms(_int_mm, M padded to 32)={total['library_ms']:.3f} "
          f"yardstick bf16_bmm_ms={total['yardstick_bf16_bmm_ms']:.3f} "
          f"bound_ms={total['bound_ms']:.3f}", flush=True)
    return dict(total, bound_by="bytes",
                max_abs_err=max(v["err"] for v in per.values()),
                at=f"one decode step on {label} planes (C={C}): {n} "
                   f"launches at M=8; per-shape times in the [kernels] lines "
                   f"and under shapes",
                library_at="torch._int_mm per channel + fmod/canonicalize/"
                           "centre, M padded to 32 at M <= 16, the faster "
                           "of B as stored and B K-contiguous (copy not "
                           "timed)",
                shapes={f"{M},{K},{N}": {k: v[k] for k in keys + (
                    "bound_by",)} for (M, K, N), v in per.items()})


def _segments(K, qmax, mset):
    """The K segments ``numerics.runners.rns_run`` cuts a matmul into at
    operand bound ``qmax``: as few as the dynamic range allows, rounded up
    to 128 terms."""
    from repro_torch.numerics.runners import rns_segments

    return rns_segments(K, qmax, qmax, mset)


def forward_launches(cfg):
    """B1 launches of one forward of a dense or moe config on int4 P21
    planes: one a K segment of each projection (granite's down projection,
    K 24576, takes two), each stacked expert einsum one launch a segment,
    and the logits."""
    from repro_torch.core.moduli import P21

    def n(K):
        return len(_segments(K, 7, P21))

    d = cfg.d_model
    layer = 5 * n(d) + n(cfg.n_heads * cfg.hd) + n(cfg.d_ff)
    return cfg.n_layers * layer + n(d)


def draft_step_launches(n_layers):
    """B1 launches of one rns-drafter step (P16 at 3 bits, K segments)."""
    from repro_torch.core.moduli import P16

    per_layer = sum(len(_segments(K, 3, P16)) * n
                    for (K, N), n in LAYER_MATMULS)
    return n_layers * per_layer + len(_segments(LOGITS[0], 3, P16))


def check_rns_matmul_spec(torch, timer, gen):
    """B1 on the shapes speculative decoding gives it, bit for bit against
    its plain version and timed at every qwen3 shape: the target's verify,
    M = B (k + 1) = 40 rows of P21 planes (above the decode schedule's 16
    rows: the prefill tile); and the rns drafter's P16 = (31, 32, 33)
    planes at 3 bits, each matmul cut into the K segments ``rns_run`` cuts
    it into (3 at K 4096, 7 at K 12288; strided views of one operand), at
    M 8 (its decode steps) and M 40.  ``torch._int_mm`` beside each, per
    channel and per K segment (the same function).  Operands
    over the full centred range of the widest modulus (32's +16 included).
    Returns one entry a (planes, M) with its step total."""
    from repro_torch.core.moduli import P16, P21
    from repro_torch.kernels.rns_matmul import rns_matmul_cuda, rns_matmul_ref
    from repro_torch.roofline import op_cost

    mv = SERVE_B * (SPEC_K + 1)
    res = {}
    for label, mset, qmax, Ms in (("P21", P21, 7, (mv,)),
                                  ("P16", P16, 3, (8, mv))):
        C, h = mset.num_channels, max(mset.moduli) // 2
        for M in Ms:
            per, launches = {}, 0
            for (K, N), cnt in QWEN3_STEP:
                segs = _segments(K, qmax, mset)
                launches += len(segs) * cnt
                a = torch.randint(-h, h + 1, (C, M, K), generator=gen,
                                  device="cuda", dtype=torch.int32).to(
                                      torch.int8)
                b = torch.randint(-h, h + 1, (C, K, N), generator=gen,
                                  device="cuda", dtype=torch.int32).to(
                                      torch.int8)
                views = [(a[:, :, lo:hi], b[:, lo:hi]) for lo, hi in segs]
                for av, bv in views:
                    out = rns_matmul_cuda(av, bv, mset.moduli)
                    if not torch.equal(out, rns_matmul_ref(av, bv,
                                                           mset.moduli)):
                        raise AssertionError(
                            f"rns_matmul[{label}] M={M} K={K} N={N} segment "
                            f"{av.shape[2]} at {av.storage_offset()}: "
                            f"kernel differs from the plain version")
                    del out

                def run(fn=rns_matmul_cuda):
                    return [fn(av, bv, mset.moduli) for av, bv in views]

                ms = timer(run, 10)
                plain = timer(lambda: run(rns_matmul_ref), 3)
                # the library's time: _int_mm per channel and per K segment
                # (each a contiguous copy, made outside the timed region),
                # with the same rem and centring, summed over the segments
                lib, layouts = 0.0, set()
                for (lo, hi), (av, bv) in zip(segs, views):
                    a_s, b_s = av.contiguous(), bv.contiguous()
                    ref = rns_matmul_ref(a_s, b_s, mset.moduli)
                    t, lay_s = _int_mm_best(
                        torch, timer, a_s, b_s, mset.moduli, ref,
                        f"rns_matmul[{label}] M={M} K={K} N={N} segment "
                        f"{lo}:{hi}")
                    lib += t
                    layouts.add(lay_s)
                    del a_s, b_s, ref
                layout = "; ".join(sorted(layouts))
                work = None
                for lo, hi in segs:
                    w = op_cost.rns_matmul_work(C, M, hi - lo, N)
                    work = w if work is None else work + w
                bms, by = bound_ms(work)
                per[(K, N)] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                   bound_ms=bms, bound_by=by,
                                   segments=len(segs))
                libtxt = (f" library_ms(_int_mm, {len(segs)} segment(s), "
                          f"{layout})={lib:.4f}")
                print(f"[kernels] rns_matmul[{label},{mset.moduli}] C={C} "
                      f"M={M} K={K} N={N} in {len(segs)} K segment(s): "
                      f"bit-exact; kernel_ms={ms:.4f} plain_ms={plain:.4f}"
                      f"{libtxt} bound_ms={bms:.4f} ({by})", flush=True)
                del a, b, views
                torch.cuda.empty_cache()
            keys = ("ms", "plain_ms", "library_ms", "bound_ms")
            total = {k: sum(per[s][k] * c for s, c in QWEN3_STEP)
                     for k in keys}
            what = "verify" if label == "P21" else "draft"
            print(f"[kernels] rns_matmul[{label}] one {what} step at M={M} "
                  f"({launches} launches): " + " ".join(
                      f"{k}={v:.3f}" for k, v in total.items()), flush=True)
            res[f"{label},M={M}"] = dict(
                total, launches_per_step=launches, max_abs_err=0,
                shapes={f"{M},{K},{N}": v for (K, N), v in per.items()})
    return res


def check_rns_matmul_moe(torch, timer, gen):
    """B1 in stack mode at moonshot-v1-16b-a3b's expert einsums: E = 64
    slices of P21 planes in one launch, at the decode capacity (M =
    moe_capacity(8, 64, 6) = 8) and the prefill's (M = moe_capacity(2048,
    64, 6) = 240), then at Moonlight-16B-A3B's admissions (``MLA_ADMIT_T``:
    M 1920 and 1040, the capacity over the real tokens), (K, N) (2048,
    1408) for gate and up and (1408, 2048) for down, operands over the
    full centred range of the widest modulus.  Each
    is one launch, bit for bit its plain version (a loop over the slices)
    and 64 launches of one slice each; timed with the L2 flushed beside the
    plain version, the 64 launches, ``torch._int_mm`` per slice and channel
    with the same rem and centring (the same function) and a bf16 bmm
    yardstick.  Returns one entry a phase with its layer total (3 einsums).
    """
    from repro_torch.core.moduli import P21
    from repro_torch.kernels import rns_matmul as rmk
    from repro_torch.models.moe import moe_capacity
    from repro_torch.roofline import hw, op_cost

    E, C, h = MOE_E, P21.num_channels, max(P21.moduli) // 2
    res = {}
    for phase, T in (("decode", SERVE_B), ("prefill", SERVE_B * SERVE_PROMPT),
                     *MLA_ADMIT_T.items()):
        M = moe_capacity(T, E, MOE_TOPK)
        per = {}
        for (K, N), _ in MOE_EINSUMS:
            a = torch.randint(-h, h + 1, (E, C, M, K), generator=gen,
                              device="cuda", dtype=torch.int32).to(torch.int8)
            b = torch.randint(-h, h + 1, (E, C, K, N), generator=gen,
                              device="cuda", dtype=torch.int32).to(torch.int8)
            what = f"rns_matmul[moe {phase}] E={E} M={M} K={K} N={N}"
            before = rmk.launches
            out = rmk.rns_matmul_cuda(a, b, P21.moduli)
            if rmk.launches != before + 1:
                raise AssertionError(f"{what}: {rmk.launches - before} "
                                     f"launches, expected one")
            ref = rmk.rns_matmul_ref(a, b, P21.moduli)
            if not torch.equal(out, ref):
                raise AssertionError(f"{what}: kernel differs from the plain "
                                     f"version")
            alone = torch.stack([rmk.rns_matmul_cuda(a[e], b[e], P21.moduli)
                                 for e in range(E)])
            if not torch.equal(out, alone):
                raise AssertionError(f"{what}: the stacked launch differs "
                                     f"from {E} launches of one slice")
            del out, alone
            lib, layout = _int_mm_best(
                torch, timer, a.reshape(E * C, M, K), b.reshape(E * C, K, N),
                P21.moduli * E, ref.reshape(E * C, M, N), what)
            del ref
            ms = timer(lambda: rmk.rns_matmul_cuda(a, b, P21.moduli), 10)
            sep = timer(lambda: [rmk.rns_matmul_cuda(a[e], b[e], P21.moduli)
                                 for e in range(E)], 5)
            plain = timer(lambda: rmk.rns_matmul_ref(a, b, P21.moduli), 3)
            ab = a.reshape(E * C, M, K).bfloat16()
            bb = b.reshape(E * C, K, N).bfloat16()
            bmm = timer(lambda: torch.bmm(ab, bb), 10)
            work = op_cost.COSTS["rns_matmul"](a, b, P21.moduli)
            nbytes, ops = work.bytes, work.ops
            bms, by = bound_ms(work)
            print(f"[kernels] {what} P21, one stacked launch: bit-exact "
                  f"against the plain version and {E} launches; kernel_ms="
                  f"{ms:.4f} ({E} launches: {sep:.4f}) plain_ms={plain:.4f} "
                  f"library_ms(_int_mm per slice and channel, {layout})="
                  f"{lib:.4f} yardstick bf16_bmm_ms={bmm:.4f} bound_ms="
                  f"{bms:.4f} ({by}; {nbytes / 1e6:.1f} MB, ops "
                  f"{1e3 * ops / hw.PEAK_OPS_INT8:.4f} ms)", flush=True)
            per[f"{M},{K},{N}"] = dict(
                ms=ms, slices_ms=sep, plain_ms=plain, library_ms=lib,
                yardstick_bf16_bmm_ms=bmm, bound_ms=bms, bound_by=by)
            del a, b, ab, bb
            torch.cuda.empty_cache()
        keys = ("ms", "slices_ms", "plain_ms", "library_ms",
                "yardstick_bf16_bmm_ms", "bound_ms")
        layer = {k: sum(per[f"{M},{K},{N}"][k] * c
                        for (K, N), c in MOE_EINSUMS) for k in keys}
        print(f"[kernels] rns_matmul[moe {phase}] one layer's 3 expert "
              f"einsums at M={M}: " + " ".join(
                  f"{k}={v:.4f}" for k, v in layer.items()), flush=True)
        res[phase] = dict(layer, bound_by="bytes", max_abs_err=0,
                          launches_per_layer=sum(c for _, c in MOE_EINSUMS),
                          shapes=per)
    return res


def check_rns_run_mla(torch, timer, gen):
    """B1 then B9 as the serve runs them (``numerics.runners.rns_run`` on
    P21: the activation's residues, one B1 launch a K segment, each decoded
    by B9 in place into the sum) at Moonlight-16B-A3B's dense products
    (``MLA_MATMULS``) at M 8 and at the admission's 8 x 2048 rows, and at
    the untied head's M 8 x N 163840; int4 operands over [-7, 7] (the
    serve's bounds).  Each result bit for bit the float64 product (exact:
    |sum| <= 11264 x 49 < 2^53), with one B1 and one B9 launch a segment;
    timed with the L2 flushed: the whole chain, its B1 launches alone and
    its B9 launches alone, beside the sum of their bounds."""
    from repro_torch.core.moduli import P21
    from repro_torch.kernels import rns_decode as rd
    from repro_torch.kernels import rns_matmul as rmk
    from repro_torch.numerics import runners
    from repro_torch.roofline import op_cost

    shapes = [(label, M, K, N) for M in (8, MLA_PREFILL_M)
              for label, K, N in MLA_MATMULS]
    shapes.append((MLA_HEAD[0], 8, *MLA_HEAD[1:]))
    rows = {}
    for label, M, K, N in shapes:
        a = torch.randint(-7, 8, (M, K), generator=gen, device="cuda",
                          dtype=torch.int32)
        w = torch.randint(-7, 8, (K, N), generator=gen, device="cuda",
                          dtype=torch.int32)
        planes = runners.encode_rns_planes(w, P21)
        want = torch.matmul(a.double(), w.double()).to(torch.int32)
        del w
        segs = runners.rns_segments(K, 7, 7, P21)
        what = f"rns_run[mla {label}] M={M} K={K} N={N}"
        b1, b9 = rmk.launches, rd.launches

        def chain():
            return runners.rns_run(a, planes, mset=P21, max_abs_a=7,
                                   max_abs_b=7)

        got = chain()
        n1, n9 = rmk.launches - b1, rd.launches - b9
        if (n1, n9) != (len(segs), len(segs)):
            raise AssertionError(f"{what}: {n1} B1 and {n9} B9 launches, "
                                 f"expected {len(segs)} of each")
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: B1 then B9 differ from the exact "
                                 f"product")
        del got, want
        a_res = P21.to_residues(a).to(planes.dtype)
        parts = [(a_res[:, :, lo:hi].contiguous(),
                  planes[:, lo:hi, :].contiguous()) for lo, hi in segs]
        outs = [rmk.rns_matmul_cuda(x, y, P21.moduli) for x, y in parts]
        total = torch.zeros((M, N), dtype=torch.int32, device="cuda")
        ms = timer(chain, 10)
        b1_ms = sum(timer(lambda x=x, y=y: rmk.rns_matmul_cuda(
            x, y, P21.moduli), 10) for x, y in parts)
        b9_ms = sum(timer(lambda r=r: rd.rns_decode_cuda(r, P21.info, total),
                          10) for r in outs)
        b1_bound = sum(bound_ms(op_cost.COSTS["rns_matmul"](
            x, y, P21.moduli))[0] for x, y in parts)
        b9_bound = sum(bound_ms(op_cost.COSTS["rns_decode"](
            r, P21.info, total))[0] for r in outs)
        print(f"[kernels] {what} P21, {len(segs)} K segment(s): bit-exact "
              f"against the float64 product; chain_ms={ms:.4f} (B1 "
              f"{b1_ms:.4f}, bound {b1_bound:.4f}; B9 adding into the sum "
              f"{b9_ms:.4f}, bound {b9_bound:.4f}; the rest is the "
              f"activation's residues) bound_ms={b1_bound + b9_bound:.4f}",
              flush=True)
        rows[f"{label},{M},{K},{N}"] = dict(
            ms=ms, b1_ms=b1_ms, b9_ms=b9_ms, b1_bound_ms=b1_bound,
            b9_bound_ms=b9_bound, bound_ms=b1_bound + b9_bound,
            segments=len(segs), max_abs_err=0)
        del a, planes, a_res, parts, outs, total
        torch.cuda.empty_cache()
    return rows


def check_paged_verify(torch, timer, gen):
    """B3 at the folded shape of [serve-spec]'s verify: B (k + 1) = 40 rows,
    each slot's block-table row repeated k + 1 times and its kv_len stepping
    by one a row (slots at 257..316, qwen3 heads), on rns8 pages (the
    target's) and bf16 pages (the draft's).  The folded launch's partials
    equal, bit for bit, those of k + 1 launches of 8 rows (row j of every
    slot), and its merged output its plain version's within the tolerance
    of ``check_paged_decode``; timed beside SDPA over the gathered cache."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attn import (paged_decode_cuda,
                                                paged_decode_ref)
    from repro_torch.numerics import kv_pages as kvp
    from repro_torch.numerics.attention import merge_decode_partials
    from repro_torch.roofline import op_cost

    B, V, H, Kv, hd, ps, n_pmax = SERVE_B, SPEC_K + 1, 32, 8, 128, 64, 6
    P = 1 + B * n_pmax
    base = torch.randint(257, 317, (B,), generator=gen, device="cuda",
                         dtype=torch.int32)
    kv_len = (base[:, None] + torch.arange(V, device="cuda",
                                           dtype=torch.int32)).reshape(-1)
    tab1 = (1 + torch.randperm(B * n_pmax, generator=gen, device="cuda")
            ).reshape(B, n_pmax).to(torch.int32)
    tab = torch.repeat_interleave(tab1, V, dim=0)
    q = torch.randn(B * V, H, hd, generator=gen, device="cuda").bfloat16()
    dense = torch.randn(2, 1, B, n_pmax * ps, Kv, hd, generator=gen,
                        device="cuda").bfloat16()
    results = {}
    for name in ("rns8", "bf16"):
        fmt = kvp.KV_FORMATS[name]
        pool = kvp.make_paged_kv(1, P, ps, Kv, hd, fmt=fmt, device="cuda")
        kvp.scatter_prefill(pool, dense[0], dense[1], tab1, ps)
        lay = kvp.layer_slice(pool, 0)
        if fmt.is_residue:
            pages = (lay.k.planes.select(-3, 0), lay.v.planes.select(-3, 0),
                     lay.k.scale, lay.v.scale)
            pack = fmt.pack
        else:
            pages, pack = (lay.k, lay.v, None, None), None
        args = (*pages, tab, kv_len, ps, pack)
        parts = paged_decode_cuda(q, *args)
        rows = torch.arange(B * V, device="cuda").reshape(B, V)
        for j in range(V):
            r = rows[:, j]
            alone = paged_decode_cuda(q[r].contiguous(), *pages, tab1,
                                      kv_len[r].contiguous(), ps, pack)
            for a, b in zip(alone, parts):
                if not torch.equal(a, b[r]):
                    raise AssertionError(f"paged_decode[{name}, folded]: "
                                         f"row {j} differs from its own "
                                         f"launch")
        out = merge_decode_partials(*parts)
        ref = merge_decode_partials(*paged_decode_ref(q, *args))
        err = float((out - ref).abs().max())
        tol = 2e-3 if name == "bf16" else 1e-4
        if not err <= tol:
            raise AssertionError(f"paged_decode[{name}, folded]: max error "
                                 f"{err} > {tol}")
        vals = []
        for leaf in (lay.k, lay.v):
            rows_kv = leaf.to_int().float() * leaf.scale if fmt.is_residue \
                else leaf.float()
            vals.append(rows_kv[tab.long()].reshape(
                B * V, n_pmax * ps, Kv, hd).transpose(1, 2).bfloat16()
                .contiguous())
        mask = (torch.arange(n_pmax * ps, device="cuda")[None, :]
                < kv_len[:, None])[:, None, None, :]
        ms = timer(lambda: paged_decode_cuda(q, *args), 20)
        plain = timer(lambda: paged_decode_ref(q, *args), 5)
        lib = timer(lambda: F.scaled_dot_product_attention(
            q[:, :, None, :], vals[0], vals[1], attn_mask=mask,
            enable_gqa=True), 20)
        # each slot's pages are read once for its V rows
        bms, by = bound_ms(op_cost.COSTS["paged_decode"](q, *args))
        print(f"[kernels] paged_decode[{name}, folded verify] {B} slots x "
              f"V={V} rows, kv_len {int(kv_len.min())}..{int(kv_len.max())}"
              f" stepping by one a row: rows equal their own launches bit "
              f"for bit; max_abs_err={err:.3e} (tol {tol}); kernel_ms="
              f"{ms:.4f} plain_ms={plain:.4f} library_ms(sdpa gathered)="
              f"{lib:.4f} bound_ms={bms:.5f} ({by})", flush=True)
        results[name] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                             bound_ms=bms, bound_by=by, max_abs_err=err)
        del pool, lay, pages, args, parts, vals
    return results


def check_flash_attention(torch, timer, gen, cases=None):
    """B2's bf16 tensor-core route: ``cases`` of ``(label, B, Sq, T, H, Kv,
    hd, causal, ragged)``, queries at positions 0..Sq-1 against T keys
    (causal only where Sq = T; ``ragged`` draws kv_len < T).  The default
    cases are the prefill shapes of qwen3-8b (hd 128, g 4) and zamba2-7b's
    shared block (hd 112, g 1), a ragged qwen3 shape (S 200, not a multiple
    of the 64-row tiles, kv_len < S), a long qwen3 prompt (S 2048, where the
    operations bound it) and granite-20b's heads (H 48 on one KV head: g
    48).  Held within the reference's bf16 tolerance, 2e-2, or within 1e-2
    of the largest output where that is less: non-causal rows average over
    T keys, so their outputs are small and the absolute limit would not see
    a lost tile.  Timed beside the plain version and SDPA; the byte bound
    reads q and the valid K and V rows once and writes the output once, the
    operations bound counts the attended (query, key) pairs.  Returns the
    rows keyed by label."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attn import (flash_attention_cuda,
                                                flash_attention_ref)
    from repro_torch.roofline import op_cost

    # the default shapes after the serves' two draw from their own
    # generator, so that the later checks draw what they drew before
    # those were added
    extra = torch.Generator(device="cuda").manual_seed(SEED + 1)
    cases = cases or [
        ("qwen3", 8, 256, 256, 32, 8, 128, True, False),
        ("zamba2", 8, 256, 256, 32, 32, 112, True, False),
        ("ragged", 8, 200, 200, 32, 8, 128, True, True),
        ("long", 1, 2048, 2048, 32, 8, 128, True, False),
        ("granite", 8, 256, 256, 48, 1, 128, True, False)]
    out_rows = {}
    for label, B, Sq, T, H, Kv, hd, causal, ragged in cases:
        if label == "ragged":
            gen = extra
        q = torch.randn(B, Sq, H, hd, generator=gen, device="cuda").bfloat16()
        k = torch.randn(B, T, Kv, hd, generator=gen, device="cuda").bfloat16()
        v = torch.randn(B, T, Kv, hd, generator=gen, device="cuda").bfloat16()
        kv_len = None
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        mask = None
        if ragged:
            kv_len = torch.randint(1, T, (B,), generator=gen, device="cuda",
                                   dtype=torch.int32)
            kv_len[0] = 7
            pos = torch.arange(T, device="cuda")
            mask = ((pos[None, None, :] <= pos[None, :Sq, None])
                    & (pos[None, None, :] < kv_len[:, None, None]))[:, None]
        out = flash_attention_cuda(q, k, v, kv_len, causal=causal)
        ref = flash_attention_ref(q, k, v, kv_len, causal=causal)
        err = float((out.float() - ref.float()).abs().max())
        ref_max = float(ref.float().abs().max())
        # bf16 output rounding on both sides and f32 sums in another order:
        # the reference's own bf16 tolerance (tests/test_flash_attn.py, _tol)
        tol = min(2e-2, 1e-2 * ref_max)
        if not err <= tol:
            raise AssertionError(f"flash_attention[{label}]: max error {err}"
                                 f" > {tol} (max |ref| {ref_max})")
        ms = timer(lambda: flash_attention_cuda(q, k, v, kv_len,
                                                causal=causal), 20)
        plain = timer(lambda: flash_attention_ref(q, k, v, kv_len,
                                                  causal=causal), 5)
        if mask is None:
            lib = timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), 20)
        else:
            lib = timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), 20)
        lens = [T] * B if kv_len is None else kv_len.tolist()
        work = op_cost.COSTS["flash_attention"](q, k, v, kv_len,
                                                causal=causal)
        bms, by = bound_ms(work)
        kind = ("causal" if causal else "non-causal") + (
            "" if kv_len is None else f" kv_len 7..{max(lens)}")
        tflops = work.ops / ms / 1e9
        print(f"[kernels] flash_attention[{label}] B={B} Sq={Sq} T={T} H={H} "
              f"Kv={Kv} hd={hd} bf16 {kind}: max_abs_err={err:.3e} (tol "
              f"{tol:.3e}, max |ref| {ref_max:.3e}); kernel_ms={ms:.4f}"
              f"{earlier(f'flash_attention[{label}]')} ({tflops:.0f} TFLOP/s)"
              f" plain_ms={plain:.4f} library_ms(sdpa)={lib:.4f} "
              f"bound_ms={bms:.4f} ({by})", flush=True)
        out_rows[label] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                               bound_ms=bms, bound_by=by, max_abs_err=err,
                               tol=tol, at=f"prefill B={B} Sq={Sq} T={T} "
                                           f"H={H} Kv={Kv} hd={hd} bf16 "
                                           f"{kind}")
        del q, k, v, qt, kt, vt, out, ref, mask
        torch.cuda.empty_cache()
    return out_rows


def check_flash_attention_mla(torch, timer, gen):
    """B2's (192, 128) instance at Moonlight-16B-A3B's prefill: q and k of
    192 (128 + 64 rotary) a head, v of 128, B 8, S 2048, H 16 (every head
    its own k and v after the latent's expansion), causal; then a ragged
    shape (S 200, kv_len < S) and a decode-like one (Sq 1 against kv_len
    rows, non-causal, as the MLA decode step runs it).  Held within the
    reference's bf16 tolerance (``check_flash_attention``'s), timed beside
    the plain version and SDPA; the bound counts 2 x 192 operations a
    (query head, key) pair for the scores and 2 x 128 for the product with
    v, and each input and output byte once."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attn import (flash_attention_cuda,
                                                flash_attention_ref)
    from repro_torch.roofline import op_cost

    rows = {}
    for label, B, Sq, T, H, causal, ragged in (
            ("moonlight", 8, 2048, 2048, 16, True, False),
            ("ragged", 8, 200, 200, 16, True, True),
            ("decode", 8, 1, 300, 16, False, True)):
        q = torch.randn(B, Sq, H, 192, generator=gen,
                        device="cuda").bfloat16()
        k = torch.randn(B, T, H, 192, generator=gen,
                        device="cuda").bfloat16()
        v = torch.randn(B, T, H, 128, generator=gen,
                        device="cuda").bfloat16()
        kv_len = None
        if ragged:
            kv_len = torch.randint(1, T, (B,), generator=gen, device="cuda",
                                   dtype=torch.int32)
            kv_len[0] = 7
        out = flash_attention_cuda(q, k, v, kv_len, causal=causal)
        ref = flash_attention_ref(q, k, v, kv_len, causal=causal)
        if out.shape != (B, Sq, H, 128):
            raise AssertionError(f"flash_attention_mla[{label}]: shape "
                                 f"{tuple(out.shape)}")
        err = float((out.float() - ref.float()).abs().max())
        ref_max = float(ref.float().abs().max())
        tol = min(2e-2, 1e-2 * ref_max)
        if not err <= tol:
            raise AssertionError(f"flash_attention_mla[{label}]: max error "
                                 f"{err} > {tol} (max |ref| {ref_max})")
        ms = timer(lambda: flash_attention_cuda(q, k, v, kv_len,
                                                causal=causal), 20)
        plain = timer(lambda: flash_attention_ref(q, k, v, kv_len,
                                                  causal=causal), 3)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        if kv_len is None:
            lib = timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal), 20)
        else:
            pos = torch.arange(T, device="cuda")
            mask = (pos[None, :] < kv_len[:, None])[:, None, None, :]
            if causal:
                mask = mask & (pos[None, None, :] <= pos[:Sq, None])[None]
            lib = timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask), 20)
        lens = [T] * B if kv_len is None else kv_len.tolist()
        pairs = H * sum(
            (min(n, Sq) * (min(n, Sq) + 1) // 2 + max(Sq - n, 0) * n)
            if causal else Sq * n for n in lens)
        nbytes = 2 * (B * Sq * H * (192 + 128) + sum(lens) * H * (192 + 128))
        bms, by = op_cost.bound_ms(nbytes, 2 * (192 + 128) * pairs, "bf16")
        print(f"[kernels] flash_attention_mla[{label}] B={B} Sq={Sq} T={T} "
              f"H={H} dk=192 dv=128 bf16 {'causal' if causal else 'non-causal'}"
              f"{'' if kv_len is None else ' ragged kv_len'}: max_abs_err="
              f"{err:.3e} (tol {tol:.3e}, max |ref| {ref_max:.3e}); "
              f"kernel_ms={ms:.4f} plain_ms={plain:.4f} library_ms(sdpa)="
              f"{lib:.4f} bound_ms={bms:.4f} ({by})", flush=True)
        rows[label] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                           bound_ms=bms, bound_by=by, max_abs_err=err,
                           tol=tol, at=f"B={B} Sq={Sq} T={T} H={H} dk=192 "
                                       f"dv=128 bf16")
        del q, k, v, qt, kt, vt, out, ref
        torch.cuda.empty_cache()
    return rows


def check_paged_decode(torch, timer, gen, H=32, Kv=8,
                       names=("bf16", "rns8", "rns4"), tag=""):
    """B3 over the page formats ``names`` at qwen3-8b's heads (H 32, Kv 8),
    or others (``tag`` names them: granite-20b's H 48 on one KV head)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attn import (paged_decode_cuda,
                                                paged_decode_ref)
    from repro_torch.numerics import kv_pages as kvp
    from repro_torch.numerics.attention import merge_decode_partials
    from repro_torch.roofline import op_cost

    B, hd, ps, n_pmax = 8, 128, 64, 5
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
    for name in names:
        fmt = kvp.KV_FORMATS[name]
        pool = kvp.make_paged_kv(1, P, ps, Kv, hd, fmt=fmt, device="cuda")
        kvp.scatter_prefill(pool, dense[0], dense[1], tab, ps)
        lay = kvp.layer_slice(pool, 0)
        if fmt.is_residue:
            args = (lay.k.planes.select(-3, 0), lay.v.planes.select(-3, 0),
                    lay.k.scale, lay.v.scale, tab, kv_len, ps, fmt.pack)
        else:
            args = (lay.k, lay.v, None, None, tab, kv_len, ps, None)
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
        bms, by = bound_ms(op_cost.COSTS["paged_decode"](q, *args))
        key = f"paged_decode[{name}{tag}]"
        print(f"[kernels] {key} B={B} H={H} Kv={Kv} hd={hd} "
              f"ps={ps} kv_len 1..{n_pmax * ps} (sum {n_rows}): "
              f"max_abs_err={err:.3e} (tol {tol}); kernel_ms={ms:.4f}"
              f"{earlier(key)} plain_ms={plain:.4f} "
              f"library_ms(sdpa gathered)={lib:.4f} bound_ms={bms:.5f} "
              f"({by})", flush=True)
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
    from repro_torch.roofline import op_cost

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
    # row and KV head; q in, partials and syn out (op_cost.decode_work)
    bms, by = bound_ms(op_cost.COSTS["paged_decode"](q, *args))

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
          f"{clean}, planted {faulty}; kernel_ms={ms:.4f}"
          f"{earlier('paged_decode_syndrome[rns8r]')} plain_ms={plain:.4f} "
          f"library_ms(sdpa gathered, counts no syndromes)={lib:.4f} "
          f"bound_ms={bms:.5f} ({by})", flush=True)
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
    projection and the logits; and M = 8, the engine's padded decode
    batch, on the gate/up shape) at the main path's shapes, on random digit
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
    from repro_torch.roofline import op_cost

    mset, C, n = P21, P21.num_channels, 7
    ws = [sdrns.WRAP_SIGNS[k] for k, _ in mset.kinds]
    B, P = SD_BATCH, SD_PROMPT
    shapes = [(B * P, K, N) for (K, N), _ in LAYER_MATMULS]
    shapes += [(B, K, N) for (K, N), _ in LAYER_MATMULS]
    shapes.append((B, *LOGITS))
    shapes.append((8, *LAYER_MATMULS[2][0]))
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
        bms, by = bound_ms(op_cost.COSTS[name](a, b, ws))
        per[(M, K, N)] = dict(ms=ms, plain_ms=plain, rns_ms=rns_ms,
                              bmm_ms=bmm, bound_ms=bms, bound_by=by, err=err)
        print(f"[kernels] {name} C={C} M={M} K={K} N={N} n={n}: digits "
              f"equal the plain version on {SD_COLS} columns, decoded "
              f"residues equal rns_matmul's at full N; kernel_ms={ms:.3f}"
              f"{earlier(f'{name}[{M},{K},{N}]')} "
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
          f"M={B}, {L} layers + logits): kernel_ms={tot['ms']:.3f}"
          f"{earlier('sdrns_matvec[step]')} (per layer {layer['ms']:.3f}, logits "
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
                  ms_m8_gate_up=per[(8, *LAYER_MATMULS[2][0])]["ms"],
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
    from repro_torch.roofline import op_cost

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    spec = nx.EncodeSpec(layout="sd", qbits=4)
    wa, wb = (dataclasses.replace(nx.encode(torch.randn(
        *SD_ADD_SHAPE, generator=g, device="cuda"), spec), scale=None)
        for _ in range(2))
    n = wa.digit_width
    x, y = wa.planes.reshape(-1, n), wb.planes.reshape(-1, n)
    res = {}
    # the same digits from an odd storage offset (bases off every alignment)
    cut = (x.numel() - 5) // n * n
    xu, yu = (t.reshape(-1)[5:5 + cut].view(-1, n) for t in (x, y))
    for kind in KINDS:
        for a, b in ((x, y), (xu, yu)):
            out = sd_add_cuda(a, b, kind)
            if not torch.equal(out, sd_add_ref(a, b, kind)):
                raise AssertionError(f"sd_add[{kind}] (storage offset "
                                     f"{a.storage_offset()}): differs from "
                                     f"the plain version")
            del out
        ms = timer(lambda: sd_add_cuda(x, y, kind), 10)
        plain = timer(lambda: sd_add_ref(x, y, kind), 3)
        yard = timer(lambda: torch.add(x, y), 10)
        bms, by = bound_ms(op_cost.COSTS["sd_add"](x, y, kind))
        res[kind] = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                         yardstick_int8_add_ms=yard)
        print(f"[kernels] sd_add[{kind}] {x.shape[0]} vectors of {n} "
              f"digits: bit-exact (and from storage offset 5); kernel_ms="
              f"{ms:.4f}"
              f"{earlier(f'sd_add[{kind}]')} plain_ms={plain:.4f} "
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


# B9's sets: every set the reverse conversion takes (P21R2 decodes its
# information channels with the witness channels present in the input)
DECODE_SETS = ("P16", "P21", "P24", "P33", "CRT40", "KV8", "KV4", "P21R2")
DECODE_TIMED = [(16384, 12288), (8, 12288)]    # prefill (8 x 2048), decode
# B9's checked shapes beside DECODE_TIMED: 16-byte planes, an odd length
# (the scalar path), a small stack, [serve-moe]'s stacked expert einsum
# (S 64, M 240: the grid cap splits each plane over the blocks of its
# stack, so the grid-stride loop runs), and more stacks than a grid's y
# dimension takes (the stack loop runs)
DECODE_SHAPES = [(None, 512, 1000), (None, 61, 999), (3, 64, 1000),
                 (64, 240, 2048), (70000, 2, 8)]


def check_rns_decode(torch, timer, gen):
    """B9 bit for bit against the eager decode (``from_residues`` on the
    card) on random int32 representatives, every other row centred (B1's
    own), at every set of DECODE_SETS and shape of DECODE_SHAPES, and 5 K
    segments added in place; at DECODE_TIMED on P21 the same, written and
    added into a sum of random int32 values, and on B1's centred residues.
    Then B9 (written, and added into a sum), the eager decode and the bound
    at DECODE_TIMED on P21."""
    from repro_torch.core import moduli as mm
    from repro_torch.kernels import rns_decode as rd
    from repro_torch.roofline import op_cost

    def draw(shape, mset):
        """Random int32 representatives; every other row centred."""
        x = torch.randint(-2**31, 2**31, shape, generator=gen,
                          device="cuda", dtype=torch.int64).to(torch.int32)
        cen = mset.center(x[..., ::2, :].movedim(-3, 0)).movedim(0, -3)
        x[..., ::2, :] = cen.to(torch.int32)
        return x

    def eager(res, info):
        return info.from_residues(
            res.narrow(-3, 0, info.num_channels).movedim(-3, 0))

    def same(res, info, what):
        """B9 written and added into a random sum, against the eager
        decode and the eager add."""
        want = eager(res, info)
        if not torch.equal(rd.rns_decode_cuda(res, info), want):
            raise AssertionError(f"rns_decode[{what}]: differs from the "
                                 f"eager decode")
        total = torch.randint(-2**31, 2**31, want.shape, generator=gen,
                              device="cuda", dtype=torch.int64
                              ).to(torch.int32)
        want = total + want
        if not torch.equal(rd.rns_decode_cuda(res, info, total), want):
            raise AssertionError(f"rns_decode[{what}]: added into a sum, "
                                 f"differs from the eager add")

    checked = []
    for name in DECODE_SETS:
        mset = getattr(mm, name)
        info = mset.info
        C = mset.num_channels
        for S, M, N in DECODE_SHAPES:
            shape = (C, M, N) if S is None else (S, C, M, N)
            same(draw(shape, mset), info, f"{name} {shape}")
        segs = [draw((C, 257, 1000), mset) for _ in range(5)]
        total, want = None, None
        for res in segs:
            total = rd.rns_decode_cuda(res, info, total)
            part = info.from_residues(res[:info.num_channels])
            want = part if want is None else want + part
        if not torch.equal(total, want):
            raise AssertionError(f"rns_decode[{name}]: 5 segments added in "
                                 f"place differ from the eager sum")
        checked.append(name)
    del segs, total, want
    torch.cuda.synchronize()
    mset = mm.P21
    times = {}
    for M, N in DECODE_TIMED:
        same(draw((3, M, N), mset), mset, f"P21 (3, {M}, {N})")
        res = torch.randint(-64, 65, (3, M, N), generator=gen, device="cuda",
                            dtype=torch.int32)
        same(res, mset, f"P21 (3, {M}, {N}) centred")
        total = torch.zeros((M, N), dtype=torch.int32, device="cuda")
        ms = timer(lambda: rd.rns_decode_cuda(res, mset), 10)
        ms_acc = timer(lambda: rd.rns_decode_cuda(res, mset, total), 10)
        eager_ms = timer(lambda: mset.from_residues(res), 3)
        bms, by = bound_ms(op_cost.COSTS["rns_decode"](res, mset))
        bms_acc, _ = bound_ms(op_cost.COSTS["rns_decode"](res, mset, total))
        times[f"{M},{N}"] = dict(
            ms=ms, ms_accumulate=ms_acc, eager_ms=eager_ms, bound_ms=bms,
            bound_accumulate_ms=bms_acc, bound_by=by,
            hbm_share=bms / ms, hbm_share_accumulate=bms_acc / ms_acc)
        print(f"[kernels] rns_decode[P21] M={M} N={N}: kernel_ms={ms:.4f} "
              f"(bound {bms:.4f}, {by}: {100 * bms / ms:.1f} %), adding "
              f"into a sum {ms_acc:.4f} (bound {bms_acc:.4f}: "
              f"{100 * bms_acc / ms_acc:.1f} %); eager from_residues "
              f"{eager_ms:.3f} ms", flush=True)
        del res, total
    shapes = ", ".join(f"{s} x {m} x {n}" if s else f"{m} x {n}"
                       for s, m, n in DECODE_SHAPES)
    print(f"[kernels] rns_decode: bit-exact against the eager decode, "
          f"written and added into a sum, on {', '.join(checked)} at "
          f"{shapes} (stacks x M x N), and 5 segments added in place; on "
          f"P21 at DECODE_TIMED's shapes, on random representatives and on "
          f"centred residues", flush=True)
    return dict(sets=checked, max_abs_err=0, shapes=times,
                checked_shapes=[list(x) for x in DECODE_SHAPES])


def check_flash_decode(torch, timer, gen, cases=None):
    """B5 against its plain version, partial by partial (o, m, l) and
    merged: at the shapes the two serves launch it with (T 321; [serve-dense]
    at the page size's 64-row chunks, six with a ragged last one,
    [serve-hybrid] at pick_block(321, 512) = 328, one chunk longer than the
    cache), at the qwen3-8b and zamba2-7b decode shapes with one chunk (T
    320), a split shape (T 4096, bk 512, kv_len 1..4096: chunks past kv_len
    are all masked) and the qwen3 shape in f32; kv_len ragged from its low
    end to T.  Timed beside the plain version and SDPA over the same dense
    cache with a length mask; the byte bound reads K and V of the valid
    rows once.  The kernels line takes the [serve-dense] shape, whose
    launches it reports.  ``cases`` replaces the shapes.  Returns the rows
    keyed by label."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attn import (flash_decode_cuda,
                                                flash_decode_ref)
    from repro_torch.numerics.attention import (DEFAULT_DECODE_BLOCK,
                                                merge_decode_partials,
                                                pick_block)
    from repro_torch.roofline import op_cost

    B = SERVE_B
    T_serve, lo_serve = SERVE_PROMPT + SERVE_NEW + 1, SERVE_PROMPT + 1
    bf16 = torch.bfloat16
    cases = cases or [
        ("serve_dense", 32, 8, 128, T_serve, bf16, lo_serve, DENSE_BK),
        ("serve_hybrid", 32, 32, 112, T_serve, bf16, lo_serve, None),
        ("qwen3", 32, 8, 128, 320, torch.bfloat16, 257, None),
        ("zamba2", 32, 32, 112, 320, torch.bfloat16, 257, None),
        ("split", 32, 8, 128, 4096, torch.bfloat16, 1, None),
        ("qwen3_f32", 32, 8, 128, 320, torch.float32, 257, None)]
    res = {}
    for label, H, Kv, hd, T, dt, lo, bk in cases:
        bk = bk or pick_block(T, DEFAULT_DECODE_BLOCK)
        q = torch.randn(B, H, hd, generator=gen, device="cuda").to(dt)
        k = torch.randn(B, T, Kv, hd, generator=gen, device="cuda").to(dt)
        v = torch.randn(B, T, Kv, hd, generator=gen, device="cuda").to(dt)
        kv_len = torch.randint(lo, T + 1, (B,), generator=gen, device="cuda",
                               dtype=torch.int32)
        kv_len[0], kv_len[1] = lo, T
        out = flash_decode_cuda(q, k, v, kv_len, bk)
        ref = flash_decode_ref(q, k, v, kv_len, bk)
        torch.cuda.synchronize()
        # f32: sums in another order (the reference's 2e-5); bf16: p is
        # rounded to bf16 on both sides, and an exp one f32 ulp apart can
        # round to the neighbouring bf16 value (2**-8 of one weight).  o
        # and l are unnormalized sums: held relative to their largest value
        tol = 2e-5 if dt == torch.float32 else 2e-3
        errs = {}
        for name, a, r in (("o", out[0], ref[0]), ("l", out[2], ref[2])):
            errs[name] = float((a - r).abs().max()) / max(
                1.0, float(r.abs().max()))
        errs["m"] = float((out[1] - ref[1]).abs().max())
        merged = float((merge_decode_partials(*out)
                        - merge_decode_partials(*ref)).abs().max())
        errs["merged"] = merged
        bad = {n: e for n, e in errs.items()
               if not e <= (2e-5 if n == "m" else tol)}
        if bad:
            raise AssertionError(f"flash_decode[{label}]: errors {bad} over "
                                 f"tolerance {tol} (m: 2e-5)")
        n_k = -(-T // bk)
        dead = (-(-kv_len // bk)).tolist()
        for b in range(B):
            if not (bool((out[1][b, :, dead[b]:] == -1e30).all())
                    and bool((out[2][b, :, dead[b]:] == 0).all())
                    and bool((out[0][b, :, :, dead[b]:] == 0).all())):
                raise AssertionError(f"flash_decode[{label}]: chunks past "
                                     f"kv_len[{b}] are not (0, -1e30, 0)")
        del out, ref
        kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
        mask = (torch.arange(T, device="cuda")[None, :]
                < kv_len[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        ms = timer(lambda: flash_decode_cuda(q, k, v, kv_len, bk), 20)
        plain = timer(lambda: flash_decode_ref(q, k, v, kv_len, bk), 5)
        lib = timer(lambda: F.scaled_dot_product_attention(
            q4, kt, vt, attn_mask=mask, enable_gqa=True), 20)
        n_rows = int(kv_len.sum())
        bms, by = bound_ms(op_cost.COSTS["flash_decode"](q, k, v, kv_len,
                                                         bk))
        print(f"[kernels] flash_decode[{label}] B={B} H={H} Kv={Kv} hd={hd} "
              f"T={T} bk={bk} ({n_k} chunks) {str(dt)[6:]} kv_len "
              f"{lo}..{T} (sum {n_rows}): errors o {errs['o']:.2e} l "
              f"{errs['l']:.2e} (rel, tol {tol}) m {errs['m']:.2e} merged "
              f"{merged:.2e}; kernel_ms={ms:.4f}"
              f"{earlier(f'flash_decode[{label}]')} plain_ms={plain:.4f} "
              f"library_ms(sdpa, length mask)={lib:.4f} bound_ms={bms:.5f} "
              f"({by})", flush=True)
        res[label] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                          bound_ms=bms, bound_by=by, max_abs_err=merged,
                          at=f"decode B={B} H={H} Kv={Kv} hd={hd} T={T} "
                             f"bk={bk} kv_len {lo}..{T}, {str(dt)[6:]} cache")
        del q, k, v, kt, vt, q4, mask
        torch.cuda.empty_cache()
    return res


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


def _tree_to(node, dev):
    if isinstance(node, dict):
        return {k: _tree_to(v, dev) for k, v in node.items()}
    if isinstance(node, list):
        return [_tree_to(v, dev) for v in node]
    return node.to(dev)


def check_small_hybrid(torch):
    """The reduced zamba2 (4 Mamba2 layers, 2 shared-block applications;
    random weights from seed 0) under rns on the dense cache, served on
    the card and on the CPU: prefill logits within the tolerance, greedy
    tokens equal."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config("zamba2-7b").reduced()
    float_params = build_model(cfg, device="cpu").init(SEED)
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (3, 8)).astype(np.int32)
    res = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, system="rns", device=dev)
        eng = ServingEngine(model, _tree_to(float_params, dev), batch=3,
                            s_max=16, device=dev)
        res[dev] = eng.generate({"tokens": prompts}, max_new=8)
    err = float(np.abs(res["cuda"].prefill_logits
                       - res["cpu"].prefill_logits).max())
    same = int((res["cuda"].tokens == res["cpu"].tokens).sum())
    # f32 compute on both; exact residue matmuls; float summation order
    # differs (an int4 code can flip only at a rounding tie)
    tol = 1e-3
    print(f"[small-hybrid] reduced zamba2-7b (L={cfg.n_layers}, attn_every="
          f"{cfg.attn_every}) rns, dense cache, card vs CPU: prefill logits "
          f"max_abs_err={err:.3e} (tol {tol}); tokens equal "
          f"{same}/{res['cpu'].tokens.size}", flush=True)
    if not err <= tol:
        raise AssertionError(f"small-hybrid: card and CPU logits differ by "
                             f"{err}")
    if not np.array_equal(res["cuda"].tokens, res["cpu"].tokens):
        raise AssertionError("small-hybrid: card and CPU tokens differ")


# ---------------------------------------------------------------------------
# Phase 4: full-width serve
# ---------------------------------------------------------------------------


def serve_full_width(torch):
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model, resident_bytes
    from repro_torch.serving.engine import ServingEngine

    cfg = dataclasses.replace(get_config("qwen3-8b"), n_layers=SERVE_LAYERS)
    B, plen, max_new = SERVE_B, SERVE_PROMPT, SERVE_NEW
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
    want = with_b9(dict(NO_LAUNCHES, rns_matmul=per_step * (1 + steps),
                        flash_attention=cfg.n_layers,
                        paged_decode=cfg.n_layers * steps))
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
    return counts, (model, engine.params, prompts, res.tokens)


def _pool_leaves(kv):
    out = []
    for t in kv:
        out += [t.planes, t.scale] if hasattr(t, "planes") else [t]
    return out


def serve_spec(torch, model, params, prompts, plain):
    """Phase [serve-spec]: speculative decoding on [serve]'s model, weights
    and prompts (qwen3-8b at full width, SERVE_LAYERS deep, P21 planes,
    rns8 pages, B 8, 256-token prompts; ``plain`` its greedy tokens).

    1. One ``verify_paged`` call of V = k + 1 tokens a slot (the first V of
       ``plain``) against V ``decode_paged`` steps on a copy of the same
       pool: logits rows and final page bytes equal bit for bit, the rows'
       argmax equal [serve]'s next tokens, and the verify launches B1 7 L +
       1 times (M 40) and B3 L times (40 folded rows).
    2. ``spec="ngram:4"`` and ``spec="rns:4"`` (the draft derived from the
       target's planes: P16 at 3 bits) for ``SPEC_NEW`` tokens each: tokens
       equal ``plain``'s (0 differ), launch counts exact per verify and per
       propose.
    """
    import numpy as np

    from repro_torch import kernels
    from repro_torch.models.api import resident_bytes
    from repro_torch.numerics import kv_pages as kvp
    from repro_torch.serving.engine import ServingEngine

    cfg = model.cfg
    B, plen = prompts.shape
    V, ps = SPEC_K + 1, 64
    s_max = plen + SERVE_NEW + 1
    n_pmax = -(-s_max // ps)
    L = cfg.n_layers
    per_step = 7 * L + 1
    out = {}

    # 1. the verify against sequential decode steps
    logits, cache = model.prefill(params, prompts, s_max=s_max)
    del logits
    pool = kvp.make_paged_kv(L, 1 + B * n_pmax, ps, cfg.n_kv, cfg.hd,
                             fmt="rns8", device="cuda")
    tab = torch.arange(1, 1 + B * n_pmax, dtype=torch.int32,
                       device="cuda").reshape(B, n_pmax)
    kvp.scatter_prefill(pool, cache[0], cache[1], tab, ps)
    del cache
    seq = kvp.make_paged_kv(L, 1 + B * n_pmax, ps, cfg.n_kv, cfg.hd,
                            fmt="rns8", device="cuda")
    for a, b in zip(_pool_leaves(seq), _pool_leaves(pool)):
        a.copy_(b)
    toks = torch.as_tensor(plain[:, :V], device="cuda").long()
    pos0 = torch.full((B,), plen, dtype=torch.int32, device="cuda")
    rows = []
    for j in range(V):
        lg, seq = model.decode_paged(params, toks[:, j:j + 1], seq, tab,
                                     pos0 + j, page_size=ps)
        rows.append(lg)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    lv, pool = model.verify_paged(params, toks, pool, tab, pos0,
                                  page_size=ps)
    torch.cuda.synchronize()
    t_verify = time.perf_counter() - t0
    counts = kernels.launch_counts()
    want = with_b9(dict(NO_LAUNCHES, rns_matmul=per_step, paged_decode=L))
    if counts != want:
        raise AssertionError(f"verify launch counts {counts}, expected "
                             f"{want}")
    for j in range(V):
        if not torch.equal(lv[:, j], rows[j]):
            raise AssertionError(f"serve-spec: verify row {j} differs from "
                                 f"decode step {j}")
    for a, b in zip(_pool_leaves(seq), _pool_leaves(pool)):
        if not torch.equal(a[:, 1:], b[:, 1:]):
            raise AssertionError("serve-spec: page bytes after the verify "
                                 "differ from the sequential steps'")
    nxt = torch.argmax(lv, dim=-1).cpu().numpy()
    if not np.array_equal(nxt, plain[:, 1:V + 1]):
        raise AssertionError("serve-spec: the verify's argmax rows differ "
                             "from [serve]'s next tokens")
    print(f"[serve-spec] verify_paged V={V} ({B * V} rows): logits rows and "
          f"page bytes equal {V} decode_paged steps bit for bit; argmax "
          f"rows equal [serve]'s tokens 1..{V}; launches "
          f"{json.dumps(counts)}; host_s={t_verify:.3f}", flush=True)
    del pool, seq, lv, rows
    torch.cuda.empty_cache()

    # 2. the two drafters through the engine
    d_step = draft_step_launches(L)
    for spec, new in SPEC_NEW.items():
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine = ServingEngine(model, params, batch=B, s_max=s_max,
                               page_size=ps, kv_format="rns8", device="cuda",
                               spec=spec)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        rns = spec.startswith("rns")
        draft_bytes = resident_bytes(engine._drafter.params) if rns else 0
        kernels.reset_launch_counts()
        res = engine.generate({"tokens": prompts}, max_new=new)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        sp, st = res.stats.spec, res.stats
        steps = sp.verify_steps
        want = dict(NO_LAUNCHES, rns_matmul=per_step * (1 + steps),
                    flash_attention=L, paged_decode=L * steps)
        if rns:     # the draft's prefill, then k + 1 draft steps a propose
            want["rns_matmul"] += d_step * (1 + V * steps)
            want["flash_attention"] += L
            want["paged_decode"] += L * V * steps
        want = with_b9(want)
        print(f"[serve-spec] spec={spec} new={new}: {sp}; acceptance="
              f"{sp.acceptance_rate:.3f} mean_block={sp.mean_accepted_len:.2f}"
              f"; prefill_s={st.prefill_s:.3f} decode_s={st.decode_s:.3f} "
              f"decode_tok_s={sp.emitted / st.decode_s:.2f} ms_per_verify="
              f"{1e3 * st.decode_s / max(steps, 1):.1f}; engine_build_s="
              f"{t_build:.2f} draft resident bytes={draft_bytes} "
              f"max_memory_allocated={peak}", flush=True)
        print(f"[serve-spec] spec={spec} launches {json.dumps(counts)}",
              flush=True)
        if counts != want:
            raise AssertionError(f"serve-spec {spec}: launch counts {counts},"
                                 f" expected {want}")
        differ = int((res.tokens != plain[:, :new]).sum())
        if res.tokens.shape != (B, new) or differ:
            raise AssertionError(f"serve-spec {spec}: {differ} tokens differ "
                                 f"from plain greedy decoding")
        print(f"[serve-spec] spec={spec}: 0 of {B * new} tokens differ from "
              f"[serve]'s greedy tokens", flush=True)
        out[spec] = dict(counts=counts, verify_steps=steps,
                         launches_b1_per_verify=per_step
                         + (V * d_step if rns else 0))
        del engine, res
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _sched_traffic(vocab):
    """[serve-sched]'s requests ``(tokens, max_new, kind)`` in queue order:
    8 share a 256-token prefix (4 full pages) then 16-128 tokens of their
    own, 4 repeat one page-aligned 256-token prompt, 12 are independent,
    16-512 tokens long; budgets of 8-64 new tokens.  The first 8 (one
    admission) hold 2 sharers, 1 repeat and 5 independent ones; the rest
    come shuffled, so later sharers hit the cached prefix and later
    repeats skip their prefill."""
    import numpy as np

    rng = np.random.default_rng(SEED + 20)
    prefix = rng.integers(0, vocab, 256)
    repeat = rng.integers(0, vocab, 256)
    share = [(np.concatenate([prefix, rng.integers(
        0, vocab, int(rng.integers(16, 129)))]), "prefix") for _ in range(8)]
    rep = [(repeat, "repeat")] * 4
    solo = [(rng.integers(0, vocab, int(rng.integers(16, 513))), "solo")
            for _ in range(12)]
    first = share[:2] + rep[:1] + solo[:5]
    rest = share[2:] + rep[1:] + solo[5:]
    order = first + [rest[i] for i in rng.permutation(len(rest))]
    budgets = rng.integers(8, 65, len(order))
    return [(t.astype(np.int32), int(m), kind)
            for (t, kind), m in zip(order, budgets)]


def _log_admissions(engine):
    """Wrap ``engine.admit_prefill`` and ``engine.paged_segment`` (instance
    attributes, so the scheduler's calls go through them) to log each
    admission's prompts and ``AdmitInfo`` and each segment's live slots,
    positions and steps."""
    import numpy as np

    log = []
    admit, segment = engine.admit_prefill, engine.paged_segment

    def logged_admit(slot_tokens, slot_total):
        out = admit(slot_tokens, slot_total)
        log.append(("admit", {s: tuple(np.asarray(t).tolist())
                              for s, t in sorted(slot_tokens.items())},
                    {s: out[s][1] for s in sorted(out)}))
        return out

    def logged_segment(tok0, pos0, remaining, eos_vec, done0, tabs, **kw):
        res = segment(tok0, pos0, remaining, eos_vec, done0, tabs, **kw)
        live = np.nonzero(~np.asarray(done0, bool))[0].tolist()
        log.append(("seg", {s: int(pos0[s]) for s in live},
                    res.counts.copy(), res.steps))
        return res

    engine.admit_prefill, engine.paged_segment = logged_admit, logged_segment
    return log


def _expected_prefix(log, ps):
    """Prefix hits and prefill skips the admission order implies, with no
    eviction: a full page hits when an earlier admitted prompt (this
    admission's earlier slots included) had the same tokens up to its end;
    a page-aligned prompt skips its prefill when an earlier *admission*
    prefilled the same whole prompt."""
    pages, prompts = set(), set()
    hits = skips = 0
    for entry in log:
        if entry[0] != "admit":
            continue
        prefilled = []
        for toks in entry[1].values():
            n_full = len(toks) // ps
            h = sum(toks[: (j + 1) * ps] in pages for j in range(n_full))
            skip = (len(toks) % ps == 0 and h == n_full
                    and toks in prompts)
            hits += h
            skips += skip
            pages.update(toks[: (j + 1) * ps] for j in range(n_full))
            if not skip:
                prefilled.append(toks)
        prompts.update(prefilled)
    return hits, skips


def _mid_decode_admissions(log):
    """Segments that a newly admitted request joined while another request
    went on decoding (its position advanced by the previous segment's
    count, in the same slot)."""
    n, prev = 0, None
    for entry in log:
        if entry[0] != "seg":
            continue
        _, pos, counts, _ = entry
        if prev is not None:
            ppos, pcounts = prev
            going = {s for s in pos if s in ppos
                     and pos[s] == ppos[s] + int(pcounts[s])}
            n += bool(going) and bool(set(pos) - going)
        prev = (pos, counts)
    return n


def _serve_requests(engine, specs):
    from repro_torch.serving.scheduler import Request, RequestScheduler

    return RequestScheduler(engine).serve(
        [Request(rid=i, tokens=t, max_new=m, eos=e)
         for i, (t, m, e) in enumerate(specs)])


def serve_sched(torch, model, params):
    """Phase [serve-sched]: continuous serving on [serve]'s model and
    weights (qwen3-8b at full width, SERVE_LAYERS deep, P21 planes, rns8
    pages, B 8, page 64): the traffic of ``_sched_traffic``, one
    independent request carrying an EOS taken from its solo run.  Gates:
    every request retires with its budget or at its EOS; a request is
    admitted while another slot is mid-decode; the pool's prefix hits and
    prefill skips equal what the admission order implies
    (``_expected_prefix``), with no eviction; every page ends free or
    cached-free; the shortest, the longest, a
    prefix-sharing and a prefill-skipping request re-served alone give
    their tokens bit for bit; the same requests under ``spec="ngram:4"``
    give the same tokens; launch counts equal what the admissions and steps
    imply; the B3 launches of the first decode step equal the plain version
    on their own inputs."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.serving.engine import ServingEngine

    cfg = model.cfg
    L, B, ps = cfg.n_layers, SERVE_B, 64
    per_fwd = 7 * L + 1
    traffic = _sched_traffic(cfg.vocab)
    assert len(traffic) == SCHED_N
    s_max = max(len(t) + m for t, m, _ in traffic) + SPEC_K
    n_pmax = -(-s_max // ps)
    # room for every prompt page to stay cached: no eviction
    num_pages = 1 + B * n_pmax + sum(len(t) // ps for t, _, _ in traffic)

    def engine(**kw):
        return ServingEngine(model, params, batch=B, s_max=s_max,
                             page_size=ps, kv_format="rns8",
                             num_pages=num_pages, device="cuda", **kw)

    eng = engine()
    # the EOS request: an independent one (the shortest budget of 16 or
    # more first) whose solo run emits a token at mid-budget for the first
    # time, away from a page's last row
    specs = [[t, m, None] for t, m, _ in traffic]
    k_eos = None
    for e_idx in sorted((i for i, x in enumerate(traffic)
                         if x[2] == "solo" and x[1] >= 16),
                        key=lambda i: traffic[i][1]):
        t_e, m_e, _ = specs[e_idx]
        solo = _serve_requests(eng, [(t_e, m_e, None)])[0].result
        k_eos = next((k for k in range(m_e // 2, m_e - 1)
                      if solo[k] not in solo[:k]
                      and (len(t_e) + k) % ps != ps - 1), None)
        if k_eos is not None:
            break
    if k_eos is None:
        raise AssertionError("serve-sched: no independent request emits a "
                             "fresh token at mid-budget to stop at")
    specs[e_idx][2] = int(solo[k_eos])
    eng.pool.reset()
    st0 = eng.pool.stats.snapshot()
    log = _log_admissions(eng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    # the first step's pages are copied: a retired request's pages go to
    # later admissions before the launches are checked
    out, first_b3 = record_launches(
        "paged_decode", L, lambda: _serve_requests(eng, specs),
        keep=lambda *a: tuple(x.clone() if torch.is_tensor(x) else x
                              for x in a))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    st = dataclasses.replace(eng.pool.stats, **{
        k: v - getattr(st0, k)
        for k, v in dataclasses.asdict(eng.pool.stats).items()})
    n_tok = sum(len(r.result) for r in out)
    lat = np.array([r.stats.latency_s for r in out])
    print(f"[serve-sched] qwen3-8b L={L} system=rns kv=rns8 B={B} ps={ps} "
          f"num_pages={num_pages}: {SCHED_N} requests (prompts "
          f"{min(len(t) for t, _, _ in traffic)}-"
          f"{max(len(t) for t, _, _ in traffic)}, budgets "
          f"{min(m for _, m, _ in traffic)}-{max(m for _, m, _ in traffic)},"
          f" rid {e_idx} ends at EOS {specs[e_idx][2]} after {k_eos + 1}) in "
          f"{wall:.3f}s: requests_s={SCHED_N / wall:.3f} tokens_s="
          f"{n_tok / wall:.2f} latency_s p50={np.percentile(lat, 50):.3f} "
          f"p95={np.percentile(lat, 95):.3f}; pool {st}; kv pool bytes="
          f"{eng.pool.pool_bytes()} max_memory_allocated={peak}", flush=True)
    for r, (t, m, e) in zip(out, specs):
        ok = (len(r.result) == m and (e is None or e not in r.result[:-1])
              ) or (e is not None and r.result[-1] == e
                    and len(r.result) <= m)
        if not ok:
            raise AssertionError(f"serve-sched: rid {r.rid} returned "
                                 f"{len(r.result)} of {m} tokens (eos {e})")
    if len(out[e_idx].result) != k_eos + 1:
        raise AssertionError(f"serve-sched: the EOS request returned "
                             f"{len(out[e_idx].result)} tokens, expected "
                             f"{k_eos + 1}")
    mid = _mid_decode_admissions(log)
    hits, skips = _expected_prefix(log, ps)
    admits = [e for e in log if e[0] == "admit"]
    prefills = sum(any(i.cached_logits is None for i in e[2].values())
                   for e in admits)
    steps = sum(e[3] for e in log if e[0] == "seg")
    print(f"[serve-sched] {len(admits)} admissions ({prefills} prefills), "
          f"{steps} decode steps in {len(log) - len(admits)} segments; "
          f"{mid} segments admitted a request beside one mid-decode; prefix "
          f"hits {st.prefix_hits} (implied {hits}), prefill skips "
          f"{st.prefill_skips} (implied {skips}), evictions {st.evictions};"
          f" launches {json.dumps(counts)}", flush=True)
    if mid < 1:
        raise AssertionError("serve-sched: no request was admitted while "
                             "another was mid-decode")
    if (st.prefix_hits, st.prefill_skips, st.evictions) != (hits, skips, 0) \
            or not (hits and skips):
        raise AssertionError(f"serve-sched: pool {st}, the admission order "
                             f"implies {hits} hits and {skips} skips")
    if sum(r.stats.prefix_hits for r in out) != hits:
        raise AssertionError("serve-sched: per-request prefix hits do not "
                             "add up to the pool's")
    pool = eng.pool
    if pool._ref.any() or set(pool._free) | set(pool._page_key) != set(
            range(1, pool.num_pages)):
        raise AssertionError("serve-sched: pages still held at the end")
    want = with_b9(dict(NO_LAUNCHES, rns_matmul=per_fwd * (prefills + steps),
                        flash_attention=L * prefills,
                        paged_decode=L * steps))
    if counts != want:
        raise AssertionError(f"serve-sched: launch counts {counts}, "
                             f"expected {want}")
    seg0 = next(e for e in log if e[0] == "seg")
    check_first_b3(first_b3, L, [seg0[1].get(b, 0) + 1 for b in range(B)],
                   "serve-sched", cfg)
    del first_b3

    # four requests re-served alone, the pool reset before each
    lens = [len(t) for t, _, _ in specs]
    picks = {"shortest": int(np.argmin(lens)), "longest": int(np.argmax(lens)),
             "prefix-sharer": next(i for i, x in enumerate(traffic)
                                   if x[2] == "prefix" and i >= B),
             "prefill-skip": next(r.rid for r in out
                                  if r.stats.prefill_skipped)}
    for what, i in picks.items():
        eng.pool.reset()
        alone = _serve_requests(eng, [specs[i]])[0].result
        if not np.array_equal(alone, out[i].result):
            raise AssertionError(f"serve-sched: the {what} request (rid {i})"
                                 f" alone gives other tokens")
    print(f"[serve-sched] re-served alone, bit for bit: "
          f"{json.dumps(picks)}", flush=True)
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # the same traffic under the n-gram drafter
    eng = engine(spec=SCHED_SPEC)
    slog = _log_admissions(eng)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sout = _serve_requests(eng, specs)
    torch.cuda.synchronize()
    s_wall = time.perf_counter() - t0
    s_counts = kernels.launch_counts()
    s_pre = sum(any(i.cached_logits is None for i in e[2].values())
                for e in slog if e[0] == "admit")
    s_steps = sum(e[3] for e in slog if e[0] == "seg")
    differ = [r.rid for r, p in zip(sout, out)
              if not np.array_equal(r.result, p.result)]
    sp = eng.stats.spec
    print(f"[serve-sched] spec={SCHED_SPEC}: {s_wall:.3f}s, tokens_s="
          f"{n_tok / s_wall:.2f}; {s_steps} verify steps, {s_pre} prefills; "
          f"{sp}; launches {json.dumps(s_counts)}; requests whose tokens "
          f"differ from the plain run: {differ}", flush=True)
    if differ:
        raise AssertionError(f"serve-sched: spec tokens differ for {differ}")
    s_want = with_b9(dict(NO_LAUNCHES, rns_matmul=per_fwd * (s_pre + s_steps),
                          flash_attention=L * s_pre,
                          paged_decode=L * s_steps))
    if s_counts != s_want:
        raise AssertionError(f"serve-sched spec: launch counts {s_counts}, "
                             f"expected {s_want}")
    del eng
    return dict(counts=counts, spec_counts=s_counts,
                requests_s=SCHED_N / wall, tokens_s=n_tok / wall,
                latency_p50=float(np.percentile(lat, 50)),
                latency_p95=float(np.percentile(lat, 95)))


def serve_redundant(torch):
    """Phases 5 and 6: qwen3-8b at full width, R_LAYERS deep, on P21R2 /
    rns8r / strict, clean and then under injected faults."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.moduli import P21R2
    from repro_torch.models.api import build_model, resident_bytes
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.testing.faults import FaultSpec, inject_faults

    cfg = dataclasses.replace(get_config("qwen3-8b"), n_layers=R_LAYERS)
    B, plen, max_new = SERVE_B, SERVE_PROMPT, SERVE_NEW
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
    # P21R2's products are checked and corrected at their decode: no B9
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

    # (c) the continuous scheduler on the same engine settings: 8 requests
    # of ragged prompts (64-160 tokens) and budgets (8-16), clean and then
    # under the sticky fault (slot 0's first page is page 1 here too: the
    # first admission takes the lowest pages first, slot 0 first)
    rng = np.random.default_rng(SEED + 21)
    specs = [(rng.integers(0, cfg.vocab, int(rng.integers(64, 161))
                           ).astype(np.int32), int(rng.integers(8, 17)),
              None) for _ in range(8)]
    params = engine_b.params
    del engine_b
    torch.cuda.empty_cache()
    clean_c = _serve_requests(
        ServingEngine(model, params, quarantine_after=2, **kw), specs)
    gc.collect()
    torch.cuda.empty_cache()
    engine_c = ServingEngine(model, params, quarantine_after=2, **kw)
    with inject_faults(engine_c, sticky, after_steps=3):
        out_c = _serve_requests(engine_c, specs)
    fc = dataclasses.asdict(engine_c.stats.faults)
    same = all(np.array_equal(a.result, b.result)
               for a, b in zip(out_c, clean_c))
    print(f"[faults] (c) the scheduler, {len(specs)} requests, sticky K "
          f"witness fault, quarantine_after=2: tokens equal the clean "
          f"scheduler run {same}; quarantined pages "
          f"{sorted(engine_c.pool.quarantined_pages)}; recomputes by "
          f"re-admission {[r.stats.recomputes for r in out_c]}; counters "
          f"{json.dumps(fc)}", flush=True)
    if not same:
        raise AssertionError("faults (c): the scheduler's tokens differ from "
                             "its clean run")
    if fc["pages_quarantined"] < 1 or fc["recomputes"] < 1:
        raise AssertionError(f"faults (c): counters {fc}")
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


def record_launches(name, n, run, skip=0, keep=lambda *args: args):
    """``run()`` with kernel ``name``'s card implementation wrapped to keep
    the arguments (through ``keep``) and a copy of the outputs of its
    launches ``skip`` .. ``skip + n - 1``: one decode step's, after the
    prefill's ``skip``.  Weights, pages and caches are kept as they are,
    not copied: later steps write only rows at or past each launch's
    kv_len, which the kernels and their plain versions mask."""
    from repro_torch.numerics import registry

    kernel = registry.get_impl(name, "cuda")
    seen, kept = [0], []

    def recording(*args, **kw):
        out = kernel(*args, **kw)
        if skip <= seen[0] < skip + n:
            kept.append((keep(*args), out.clone() if hasattr(out, "clone")
                         else tuple(t.clone() for t in out)))
        seen[0] += 1
        return out

    registry.register_impl(name, "cuda", recording)
    try:
        return run(), kept
    finally:
        registry.register_impl(name, "cuda", kernel)


def record_first_decode(n, run):
    """B5's launches of the first decode step (see ``record_launches``)."""
    return record_launches(
        "flash_decode", n, run,
        keep=lambda q, k, v, kv_len, bk: (q.clone(), k, v, kv_len.clone(),
                                          bk))


def hold_launches(checks, run):
    """``run()`` with the card implementation of each kernel named in
    ``checks`` wrapped so that every launch is held against its plain
    version on its own inputs as it returns: ``checks[name](out, *args,
    **kw)`` gives the launch's error.  Returns ``run()``'s result and
    ``{name: (launches, worst error)}``.  For untimed runs: the plain
    versions run in line."""
    from repro_torch.numerics import registry

    cards = {name: registry.get_impl(name, "cuda") for name in checks}
    held = {name: [0, 0.0] for name in checks}

    def holding(name):
        kernel, check, rec = cards[name], checks[name], held[name]

        def launch(*args, **kw):
            out = kernel(*args, **kw)
            rec[0] += 1
            rec[1] = max(rec[1], check(out, *args, **kw))
            return out

        return launch

    for name in checks:
        registry.register_impl(name, "cuda", holding(name))
    try:
        return run(), {name: tuple(rec) for name, rec in held.items()}
    finally:
        for name, kernel in cards.items():
            registry.register_impl(name, "cuda", kernel)


# B1 bit for bit; B2 within the reference's own bf16 tolerance
# (tests/test_flash_attn.py: assert_allclose, rtol = atol = 2e-2), as the
# serves' outputs reach |o| >= 4, where one bf16 ulp of output rounding on
# either side is 2^-5; B3 on rns8 pages as in [kernels]
HELD_TOL = {"rns_matmul": 0.0, "flash_attention": 2e-2, "paged_decode": 1e-4,
            "rns_decode": 0.0}
HELD_ERR = {"rns_matmul": "max_abs_err", "paged_decode": "max_abs_err",
            "flash_attention": "max |out - ref| / (1 + |ref|)",
            "rns_decode": "max_abs_err"}


def hold_decode(run):
    """``run()`` with B9's card implementation wrapped so that every launch
    is held bit for bit against its plain version (the eager decode, added
    into a copy of the sum the launch was given) as it returns.  Returns
    ``run()``'s result and ``(launches, worst error)``, as
    ``hold_launches`` gives them."""
    from repro_torch.kernels.rns_decode import rns_decode_ref
    from repro_torch.numerics import registry

    kernel = registry.get_impl("rns_decode", "cuda")
    rec = [0, 0.0]

    def launch(res, mset, out=None):
        before = None if out is None else out.clone()
        got = kernel(res, mset, out)
        want = rns_decode_ref(res, mset, before)
        rec[0] += 1
        rec[1] = max(rec[1], float((got.long() - want.long()).abs().max()))
        return got

    registry.register_impl("rns_decode", "cuda", launch)
    try:
        return run(), tuple(rec)
    finally:
        registry.register_impl("rns_decode", "cuda", kernel)


def held_checks(*names):
    """``hold_launches`` checks of B1 (the exact integer difference), B2
    (the largest difference over 1 + |ref|: atol = rtol) and B3 (the
    largest difference of the merged outputs)."""
    from repro_torch.kernels.flash_attn import (flash_attention_ref,
                                                paged_decode_ref)
    from repro_torch.kernels.rns_matmul import rns_matmul_ref
    from repro_torch.numerics.attention import merge_decode_partials

    def b1(out, a, b, moduli):
        return float((out.long() - rns_matmul_ref(a, b, moduli).long()
                      ).abs().max())

    def b2(out, q, k, v, kv_len=None, *, causal=True):
        ref = flash_attention_ref(q, k, v, kv_len, causal=causal).float()
        return float(((out.float() - ref).abs() / (1 + ref.abs())).max())

    def b3(out, *args, **kw):
        return float((merge_decode_partials(*out[:3]) - merge_decode_partials(
            *paged_decode_ref(*args, **kw)[:3])).abs().max())

    every = {"rns_matmul": b1, "flash_attention": b2, "paged_decode": b3}
    return {name: every[name] for name in names}


def check_held(held, want, label, what):
    """Each held kernel launched ``want[name]`` times and within
    ``HELD_TOL``."""
    for name, (n, worst) in held.items():
        tol = HELD_TOL[name]
        print(f"[{label}] {what}: {n} {name} launches against the plain "
              f"version on their own inputs, {HELD_ERR[name]}={worst:.3e} "
              f"(tol {tol})", flush=True)
        if n != want[name]:
            raise AssertionError(f"{label}: {what} made {n} {name} launches, "
                                 f"expected {want[name]}")
        if not worst <= tol:
            raise AssertionError(f"{label}: {name} differs from the plain "
                                 f"version on {what}'s inputs")


def check_first_b3(first, n, kv_len0, label, cfg):
    """Hold the recorded B3 launches of the first decode step (rns8 pages)
    against the plain version on their own inputs.  ``kv_len0``: every
    slot's kv_len, or a list of each slot's (ragged batches)."""
    from repro_torch.kernels.flash_attn import paged_decode_ref
    from repro_torch.numerics.attention import merge_decode_partials

    if len(first) != n:
        raise AssertionError(f"{label}: recorded {len(first)} B3 launches of "
                             f"the first step, expected {n}")
    worst = 0.0
    for args, parts in first:
        want = (list(kv_len0) if isinstance(kv_len0, list)
                else [kv_len0] * len(args[6]))
        if args[6].tolist() != want:
            raise AssertionError(f"{label}: first step kv_len "
                                 f"{args[6].tolist()}, expected {want}")
        ref = paged_decode_ref(*args)
        worst = max(worst, float((merge_decode_partials(*parts[:3])
                                  - merge_decode_partials(*ref[:3])
                                  ).abs().max()))
    tol = HELD_TOL["paged_decode"]
    print(f"[{label}] the {n} B3 launches of the first decode step (H "
          f"{cfg.n_heads}, Kv {cfg.n_kv}, rns8 pages, kv_len {kv_len0}) "
          f"against the plain version on their own inputs: "
          f"max_abs_err={worst:.3e} (tol {tol})", flush=True)
    if not worst <= tol:
        raise AssertionError(f"{label}: B3 differs from the plain version on "
                             f"the serve's inputs")


def check_first_b1(first, n, B, label):
    """Hold the recorded B1 launches of the first decode step against the
    plain version on their own inputs, bit for bit."""
    from repro_torch.kernels.rns_matmul import rns_matmul_ref

    if len(first) != n:
        raise AssertionError(f"{label}: recorded {len(first)} B1 launches "
                             f"of the first step, expected {n}")
    for (a, b, moduli), out in first:
        if a.shape[-2] != B or not out.equal(rns_matmul_ref(a, b, moduli)):
            raise AssertionError(f"{label}: a B1 launch of the first "
                                 f"decode step ({tuple(a.shape)} x "
                                 f"{tuple(b.shape)}) differs from the plain "
                                 f"version")
    print(f"[{label}] the {n} B1 launches of the first decode step "
          f"equal the plain version on their own inputs bit for bit",
          flush=True)


def check_first_decode(first, n, kv_len0, label):
    """Hold the recorded B5 launches of the first decode step against the
    plain version on their own inputs, merged.  ``kv_len0``: every launch's
    kv_len (all slots alike), or a list with each launch's."""
    from repro_torch.kernels.flash_attn import flash_decode_ref
    from repro_torch.numerics.attention import merge_decode_partials

    if len(first) != n:
        raise AssertionError(f"{label}: recorded {len(first)} B5 launches of "
                             f"the first step, expected {n}")
    wants = kv_len0 if isinstance(kv_len0, list) else [kv_len0] * n
    worst = 0.0
    for ((q, k, v, kv_len, bk), out), want in zip(first, wants):
        if kv_len.tolist() != [want] * len(kv_len):
            raise AssertionError(f"{label}: first step kv_len "
                                 f"{kv_len.tolist()}, expected {want}")
        ref = flash_decode_ref(q, k, v, kv_len, bk)
        worst = max(worst, float((merge_decode_partials(*out)
                                  - merge_decode_partials(*ref)).abs().max()))
    tol = 2e-3      # the bf16-cache tolerance of [kernels] flash_decode
    shapes = sorted({(a[1].shape[1], a[4]) for a, _ in first})
    print(f"[{label}] the {n} B5 launches of the first decode step ((T, bk) "
          f"{shapes}) against the plain version on their own inputs: "
          f"max_abs_err={worst:.3e} (tol {tol})", flush=True)
    if not worst <= tol:
        raise AssertionError(f"{label}: B5 differs from the plain version on "
                             f"the serve's inputs")


def _finite_wrap(torch, fn):
    """``fn`` with every logits tensor it returns folded into a device flag
    (read once at the end)."""
    flag = torch.ones((), dtype=torch.bool, device="cuda")

    def wrapped(*a, **k):
        out = fn(*a, **k)
        flag.logical_and_(torch.isfinite(out[0]).all())
        return out

    return wrapped, flag


def serve_dense(torch, model, params):
    """Phase 8: [serve]'s qwen3-8b (full width, SERVE_LAYERS deep,
    system="rns", its model and resident weights) with paged=False: the
    dense bf16 cache and
    kernel B5, then its twin on bf16 pages of 64 rows; both with the
    decode chunk set to the page size, so both emit the same per-chunk
    partials (the reference's own pin, tests/test_paged_serving.py)."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.models.api import resident_bytes
    from repro_torch.numerics.attention import set_decode_block
    from repro_torch.serving.engine import ServingEngine

    cfg = model.cfg
    B, plen, max_new, ps = SERVE_B, SERVE_PROMPT, SERVE_NEW, DENSE_BK
    torch.cuda.reset_peak_memory_stats()
    kw = dict(batch=B, s_max=plen + max_new + 1, device="cuda")
    engine = ServingEngine(model, params, paged=False, **kw)
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (B, plen)).astype(np.int32)
    L = cfg.n_layers
    prev = set_decode_block(ps)
    try:
        kernels.reset_launch_counts()
        res, first = record_first_decode(L, lambda: engine.generate(
            {"tokens": prompts}, max_new=max_new))
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        twin_engine = ServingEngine(model, engine.params, page_size=ps,
                                    kv_format="bf16", **kw)
        twin = twin_engine.generate({"tokens": prompts}, max_new=max_new)
        torch.cuda.synchronize()
    finally:
        set_decode_block(prev)
    rb = resident_bytes(engine.params)
    steps = max_new - 1
    st = res.stats
    cache_bytes = 2 * L * B * kw["s_max"] * cfg.n_kv * cfg.hd * 2
    print(f"[serve-dense] qwen3-8b L={L} d={cfg.d_model} system=rns "
          f"paged=False (dense bf16 cache, decode chunk {ps}; [serve]'s "
          f"model and weights) B={B} prompt={plen} new={max_new}: prefill_s="
          f"{st.prefill_s:.3f} decode_s={st.decode_s:.3f} decode_tok_s="
          f"{B * steps / st.decode_s:.2f} step_ms="
          f"{1e3 * st.decode_s / steps:.1f}", flush=True)
    print(f"[serve-dense] resident weight bytes={rb} dense cache bytes="
          f"{cache_bytes} max_memory_allocated={peak}", flush=True)
    print(f"[serve-dense] launches {json.dumps(counts)}", flush=True)
    per_step = 7 * L + 1
    want = with_b9(dict(NO_LAUNCHES, rns_matmul=per_step * (1 + steps),
                        flash_attention=L, flash_decode=L * steps))
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    same_logits = np.array_equal(res.prefill_logits, twin.prefill_logits)
    n_diff = int((res.tokens != twin.tokens).sum())
    print(f"[serve-dense] against the twin on bf16 pages (page size {ps}, "
          f"step_ms {1e3 * twin.stats.decode_s / steps:.1f}): prefill logits "
          f"bit-identical {same_logits}; differing tokens {n_diff} of "
          f"{res.tokens.size}", flush=True)
    # equal partials at bk = page size make equal logits, so equal tokens
    if not same_logits or n_diff:
        raise AssertionError("serve-dense: prefill logits or tokens differ "
                             "from the twin's")
    check_first_decode(first, L, plen + 1, "serve-dense")
    if res.tokens.shape != (B, max_new) or not (
            0 <= res.tokens.min() and res.tokens.max() < cfg.vocab):
        raise AssertionError("tokens misshapen or out of [0, vocab)")
    if not np.isfinite(res.prefill_logits).all():
        raise AssertionError("prefill logits not finite")
    print(f"[serve-dense] seq0 tokens {res.tokens[0, :16].tolist()}",
          flush=True)
    return counts


def roofline(torch, smi, model, params):
    """Phase 8b: the work of one prefill and one decode step of [serve]'s
    model and weights (qwen3-8b, full width, SERVE_LAYERS deep, P21), on the
    engine-free step functions the dry run costs: ``model.prefill`` of the
    B x SERVE_PROMPT prompts at s_max = prompt + 1, then ``model.decode`` of
    one token at position SERVE_PROMPT (the dense cache, kernel B5).  Each
    step is counted by ``roofline/op_cost.py`` on the card, then the same
    steps of a meta build of the same config and shapes: the two counts must
    be equal op by op and kind by kind.  The decode step's summed B1 bound
    must equal the kernel table's, from QWEN3_STEP's shapes at this depth.
    Prints each step's counts, its compute and memory terms (the card's
    data-sheet peaks), the measured step (host clock after a synchronize,
    the median of three, uncounted), roofline_share = max(compute, memory)
    / step and mfu = MODEL_FLOPS / step / the bf16 peak."""
    import numpy as np

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.params import model_flops_total
    from repro_torch.models.api import build_model
    from repro_torch.roofline import hw, op_cost
    from repro_torch.roofline.analysis import roofline_terms

    cfg = model.cfg
    B, S = SERVE_B, SERVE_PROMPT
    prompts = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (B, S)), dtype=torch.int64)
    t0 = time.perf_counter()
    meta = build_model(cfg, system="rns", device="meta")
    meta_params = meta.init(SEED)
    t_meta = time.perf_counter() - t0

    def steps(m, p, dev):
        tokens = prompts.to(dev)
        with op_cost.OpCost() as pre:
            _, cache = m.prefill(p, tokens, s_max=S + 1)
        with op_cost.OpCost() as dec:
            m.decode(p, tokens[:, -1:], cache, S)
        return {"prefill": pre, "decode": dec}, (tokens, cache)

    card, (tokens, cache) = steps(model, params, "cuda")
    torch.cuda.synchronize()
    on_meta, _ = steps(meta, meta_params, "meta")

    def timed(fn):
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t)
        return statistics.median(ts)

    step_s = {"prefill": timed(lambda: model.prefill(params, tokens,
                                                     s_max=S + 1)),
              "decode": timed(lambda: model.decode(params, tokens[:, -1:],
                                                   cache, S))}
    out = {}
    for name, c in card.items():
        d, m = c.as_dict(), on_meta[name].as_dict()
        if d != m:
            diff = sorted(k for k in set(d["by_op"]) | set(m["by_op"])
                          if d["by_op"].get(k) != m["by_op"].get(k))
            raise AssertionError(f"roofline: the {name} step counts "
                                 f"differently on the card and on meta: "
                                 f"{diff[:8]} {d['ops']} {m['ops']}")
        comp, mem, _ = roofline_terms(d["ops"], d["bytes"], 0)
        kind = "decode" if name == "decode" else "prefill"
        mf = model_flops_total(cfg, ShapeConfig(name, S, B, kind))
        st = step_s[name]
        out[name] = dict(
            ops=d["ops"], bytes=d["bytes"], launches=d["launches"],
            compute_ms=1e3 * comp, memory_ms=1e3 * mem,
            bound_by="compute" if comp >= mem else "memory",
            step_ms=1e3 * st, roofline_share=max(comp, mem) / st,
            mfu=mf / st / hw.PEAK_FLOPS_BF16, model_flops=mf,
            kernel_bound_ms=d["bound_ms"])
        r = out[name]
        print(f"[roofline] {name} (qwen3-8b L={cfg.n_layers} B={B} prompt="
              f"{S}, P21; {smi}): card == meta op by op and kind by kind "
              f"({len(d['by_op'])} ops); ops {json.dumps(d['ops'])} bytes "
              f"{d['bytes']} launches {json.dumps(d['launches'])}",
              flush=True)
        print(f"[roofline] {name} ({smi}): compute_ms={r['compute_ms']:.4f} "
              f"memory_ms={r['memory_ms']:.4f} ({r['bound_by']}-bound; "
              f"data-sheet peaks) step_ms={r['step_ms']:.3f} (measured, "
              f"median of 3) roofline_share={r['roofline_share']:.4f} "
              f"mfu={r['mfu']:.5f} (MODEL_FLOPS {mf:.4g} over the bf16 "
              f"peak); kernel bounds ms {json.dumps(d['bound_ms'])}",
              flush=True)
    # B1's decode bound against the kernel table's row, at this depth
    L = cfg.n_layers
    table = [((K, N), L * n) for (K, N), n in LAYER_MATMULS] + [(LOGITS, 1)]
    C = 3
    want = None
    for (K, N), n in table:
        w = op_cost.rns_matmul_work(C, B, K, N)
        w = op_cost.Work(w.ops * n, w.bytes * n, w.kind)
        want = w if want is None else want + w
    want_ms = sum(n * bound_ms(op_cost.rns_matmul_work(C, B, K, N))[0]
                  for (K, N), n in table)
    got = card["decode"].kernel_work("rns_matmul")
    got_ms = card["decode"].bound["rns_matmul"]
    print(f"[roofline] decode B1 ({smi}): {card['decode'].launches['rns_matmul']}"
          f" launches, {got.bytes} bytes, {got.ops} int8 ops, bound_ms="
          f"{got_ms:.4f}; the kernel table's one qwen3 decode step at {L} "
          f"layers: {want.bytes} bytes, {want.ops} ops, bound_ms="
          f"{want_ms:.4f}; meta build {t_meta:.1f}s", flush=True)
    if (got.bytes, got.ops) != (want.bytes, want.ops) or \
            abs(got_ms - want_ms) > 1e-9 * want_ms:
        raise AssertionError("roofline: the decode step's B1 work differs "
                             "from the kernel table's")
    out["b1_decode_bound_ms"] = got_ms
    return out


def serve_hybrid(torch, smi):
    """Phase 9: zamba2-7b at full width and depth under system="rns" on the
    dense bf16 cache (the hybrid family has no paged decode)."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model, resident_bytes
    from repro_torch.models.transformer import hybrid_groups, ssm_dims
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config("zamba2-7b")
    B, plen, max_new = SERVE_B, SERVE_PROMPT, SERVE_NEW
    G, tail = hybrid_groups(cfg)
    dims = ssm_dims(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, system="rns", device="cuda")
    params = model.init(SEED)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0

    # every decode logit finite, folded on the device and read once
    decode, finite = _finite_wrap(torch, model.decode)
    engine = ServingEngine(dataclasses.replace(model, decode=decode), params,
                           batch=B, s_max=plen + max_new + 1, device="cuda")
    del params
    if engine.paged:
        raise AssertionError("the hybrid family has no paged decode")
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (B, plen)).astype(np.int32)
    kernels.reset_launch_counts()
    res, first = record_first_decode(G, lambda: engine.generate(
        {"tokens": prompts}, max_new=max_new))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    rb = resident_bytes(engine.params)
    steps = max_new - 1
    st = res.stats
    s_max = plen + max_new + 1
    kv_bytes = 2 * G * B * s_max * cfg.n_kv * cfg.hd * 2
    ssm_bytes = 4 * cfg.n_layers * B * (
        dims.n_heads * dims.headdim * dims.d_state
        + (dims.d_conv - 1) * dims.conv_dim)
    print(f"[serve-hybrid] zamba2-7b L={cfg.n_layers} ({G} shared-block "
          f"applications, {tail} tail layers) d={cfg.d_model} hd={cfg.hd} "
          f"system=rns dense bf16 cache B={B} prompt={plen} new={max_new}: "
          f"init_s={t_init:.2f} prefill_s={st.prefill_s:.3f} decode_s="
          f"{st.decode_s:.3f} decode_tok_s={B * steps / st.decode_s:.2f} "
          f"step_ms={1e3 * st.decode_s / steps:.1f}; {smi}", flush=True)
    print(f"[serve-hybrid] resident weight bytes={rb} dense KV cache bytes="
          f"{kv_bytes} SSM state + conv bytes={ssm_bytes} "
          f"max_memory_allocated={peak}", flush=True)
    print(f"[serve-hybrid] launches {json.dumps(counts)}", flush=True)
    per_step = 2 * cfg.n_layers + 8 * G + 1
    want = with_b9(dict(NO_LAUNCHES, rns_matmul=per_step * (1 + steps),
                        flash_attention=G, flash_decode=G * steps))
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    check_first_decode(first, G, plen + 1, "serve-hybrid")
    if not (bool(finite) and np.isfinite(res.prefill_logits).all()):
        raise AssertionError("serve-hybrid: a logit is not finite")
    if res.tokens.shape != (B, max_new) or not (
            0 <= res.tokens.min() and res.tokens.max() < cfg.vocab):
        raise AssertionError("tokens misshapen or out of [0, vocab)")
    print(f"[serve-hybrid] every prefill and decode logit finite; seq0 "
          f"tokens {res.tokens[0, :16].tolist()}", flush=True)
    return counts


# ---------------------------------------------------------------------------
# Phases 10-12: the dense configs, the ssm family and the moe family
# ---------------------------------------------------------------------------


def _keep_b3(q, k_pages, v_pages, k_scale, v_scale, tab, kv_len, *rest):
    """A B3 launch's arguments, the per-step tensors copied (the pages are
    the pool's own)."""
    return (q.clone(), k_pages, v_pages, k_scale, v_scale, tab.clone(),
            kv_len.clone(), *rest)


def _serve_line(label, st, B, steps, t_init, rb, peak, extra=""):
    print(f"[{label}] init_s={t_init:.2f} prefill_s={st.prefill_s:.3f} "
          f"decode_s={st.decode_s:.3f} decode_tok_s="
          f"{B * steps / st.decode_s:.2f} step_ms="
          f"{1e3 * st.decode_s / steps:.1f}; resident weight bytes={rb} "
          f"max_memory_allocated={peak}{extra}", flush=True)


def serve_configs(torch, smi):
    """Phase 10: yi-6b, phi3-medium-14b and granite-20b at full width, the
    depth cut to CONFIG_LAYERS layers each, under system="rns" on rns8
    pages: B 8, 256-token prompts, CONFIG_NEW new tokens, greedy.  Gates:
    every logit finite, exact launch counts, the B1 and B3 launches of the
    first decode step (granite's B3: 48 query heads on one KV head) equal
    to the plain version on their own inputs, and the prompt's prefill run
    again, untimed, with each B1 and B2 launch held against its plain
    version as it returns."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model, resident_bytes
    from repro_torch.serving.engine import ServingEngine

    out = {}
    for arch in CONFIG_ARCHS:
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=CONFIG_LAYERS)
        L, B, plen, max_new = cfg.n_layers, SERVE_B, SERVE_PROMPT, CONFIG_NEW
        per_step = forward_launches(cfg)
        label = f"serve-configs {arch}"
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = build_model(cfg, system="rns", device="cuda")
        params = model.init(SEED)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        decode_paged, finite = _finite_wrap(torch, model.decode_paged)
        engine = ServingEngine(
            dataclasses.replace(model, decode_paged=decode_paged), params,
            batch=B, s_max=plen + max_new + 1, page_size=64,
            kv_format="rns8", device="cuda")
        params = engine.params
        prompts = np.random.default_rng(SEED).integers(
            0, cfg.vocab, (B, plen)).astype(np.int32)
        kernels.reset_launch_counts()
        (res, first_b3), first_b1 = record_launches(
            "rns_matmul", per_step, lambda: record_launches(
                "paged_decode", L, lambda: engine.generate(
                    {"tokens": prompts}, max_new=max_new), keep=_keep_b3),
            skip=per_step)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        rb = resident_bytes(engine.params)
        steps = max_new - 1
        print(f"[{label}] cut: depth {L} of {full.n_layers} (full width: "
              f"d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv} heads, "
              f"head_dim {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}); "
              f"system=rns kv=rns8 B={B} prompt={plen} new={max_new}; {smi}",
              flush=True)
        _serve_line(label, res.stats, B, steps, t_init, rb, peak,
                    f" kv pool bytes={engine.pool.pool_bytes()}")
        print(f"[{label}] launches {json.dumps(counts)}", flush=True)
        want = with_b9(dict(NO_LAUNCHES, rns_matmul=per_step * (1 + steps),
                            flash_attention=L, paged_decode=L * steps))
        if counts != want:
            raise AssertionError(f"{label}: launch counts {counts}, expected "
                                 f"{want}")
        check_first_b3(first_b3, L, plen + 1, label, cfg)
        check_first_b1(first_b1, per_step, B, label)
        del engine, first_b3, first_b1
        _, held = hold_launches(
            held_checks("rns_matmul", "flash_attention"),
            lambda: model.prefill(params, prompts, s_max=plen + max_new + 1))
        check_held(held, {"rns_matmul": per_step, "flash_attention": L},
                   label, "the prefill")
        if not (bool(finite) and np.isfinite(res.prefill_logits).all()):
            raise AssertionError(f"{label}: a logit is not finite")
        if res.tokens.shape != (B, max_new) or not (
                0 <= res.tokens.min() and res.tokens.max() < cfg.vocab):
            raise AssertionError(f"{label}: tokens misshapen or out of "
                                 f"[0, vocab)")
        print(f"[{label}] every logit finite; seq0 tokens "
              f"{res.tokens[0].tolist()}", flush=True)
        out[arch] = counts
        del params, res, held
        gc.collect()
        torch.cuda.empty_cache()
    return out


def serve_ssm(torch, smi):
    """Phase 11: mamba2-780m at full width and depth (48 Mamba2 layers, no
    attention) under system="rns", served from its SSM state alone: B 8,
    256-token prompts (one SSM chunk), 64 new tokens, greedy.  Gates:
    every logit finite, exact launch counts (B1 only), and the B1 launches
    of the first decode step equal to the plain version on their own
    inputs."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model, resident_bytes
    from repro_torch.models.transformer import ssm_dims
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config("mamba2-780m")
    B, plen, max_new = SERVE_B, SERVE_PROMPT, SERVE_NEW
    L, dims = cfg.n_layers, ssm_dims(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, system="rns", device="cuda")
    params = model.init(SEED)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    decode, finite = _finite_wrap(torch, model.decode)
    engine = ServingEngine(dataclasses.replace(model, decode=decode), params,
                           batch=B, s_max=plen + max_new + 1, device="cuda")
    del params
    if engine.paged or engine.pool is not None:
        raise AssertionError("the ssm family serves without a KV pool")
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (B, plen)).astype(np.int32)
    per_step = 2 * L + 1
    kernels.reset_launch_counts()
    res, first = record_launches(
        "rns_matmul", per_step, lambda: engine.generate(
            {"tokens": prompts}, max_new=max_new), skip=per_step)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    rb = resident_bytes(engine.params)
    steps = max_new - 1
    ssm_bytes = 4 * L * B * (dims.n_heads * dims.headdim * dims.d_state
                             + (dims.d_conv - 1) * dims.conv_dim)
    print(f"[serve-ssm] mamba2-780m L={L} d={cfg.d_model} (d_inner "
          f"{dims.d_inner}, {dims.n_heads} heads of {dims.headdim}, state "
          f"{dims.d_state}) system=rns, no KV, B={B} prompt={plen} "
          f"new={max_new}; {smi}", flush=True)
    _serve_line("serve-ssm", res.stats, B, steps, t_init, rb, peak,
                f" SSM state + conv bytes={ssm_bytes}")
    print(f"[serve-ssm] launches {json.dumps(counts)}", flush=True)
    want = with_b9(dict(NO_LAUNCHES, rns_matmul=per_step * (1 + steps)))
    if counts != want:
        raise AssertionError(f"serve-ssm: launch counts {counts}, expected "
                             f"{want}")
    check_first_b1(first, per_step, B, "serve-ssm")
    if not (bool(finite) and np.isfinite(res.prefill_logits).all()):
        raise AssertionError("serve-ssm: a logit is not finite")
    if res.tokens.shape != (B, max_new) or not (
            0 <= res.tokens.min() and res.tokens.max() < cfg.vocab):
        raise AssertionError("serve-ssm: tokens misshapen or out of "
                             "[0, vocab)")
    print(f"[serve-ssm] every logit finite; seq0 tokens "
          f"{res.tokens[0, :16].tolist()}", flush=True)
    return counts


MLA_LENS = (256, 320, 384, 448, 512, 640, 768, 1024)   # [serve-mla] prompts
MLA_STEPS = 4


def serve_mla(torch, smi):
    """Phase: Moonlight-16B-A3B uncut (27 layers: latent attention, a dense
    layer 0, 26 layers of 64 experts top-6 with shared experts; vocab
    163840 and an untied head) under system="rns" on rns8 latent pages: one
    admission of 8 ragged prompts (``MLA_LENS``: right-padded, the padding
    kept out of the experts' capacity) through ``ServingEngine.admit_prefill``,
    then MLA_STEPS greedy decode steps through ``decode_paged`` over the
    latent pages.  Gates: every logit finite; B2 once a layer at the
    admission and once a layer a step (the (192, 128) instance), B9 one a
    B1 launch; the peak device memory with every weight resident; then the
    admission's prefill again, untimed, with each B1 launch (the expert
    stacks at the real tokens' capacity among them), each B2 and each B9
    launch held against its plain version on its own inputs."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model, resident_bytes
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config("moonlight-16b-a3b")
    L, B, ps = cfg.n_layers, len(MLA_LENS), 64
    s_max = max(MLA_LENS) + MLA_STEPS + 1
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, system="rns", device="cuda")
    params = model.init(SEED)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    rb = resident_bytes(params)
    engine = ServingEngine(model, params, batch=B, s_max=s_max,
                           page_size=ps, kv_format="rns8", device="cuda")
    del params
    rng = np.random.default_rng(SEED)
    prompts = {s: rng.integers(0, cfg.vocab, n).astype(np.int32)
               for s, n in enumerate(MLA_LENS)}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = engine.admit_prefill(prompts, {s: s_max for s in prompts})
    torch.cuda.synchronize()
    t_admit = time.perf_counter() - t0
    admit_counts = kernels.launch_counts()
    logits0 = np.stack([out[s][0] for s in range(B)])
    tabs = torch.as_tensor(np.stack([engine.pool.tab_row(
        out[s][1].pages, engine.n_pmax) for s in range(B)]), device="cuda")
    tok = torch.as_tensor(logits0.argmax(-1), device="cuda")[:, None]
    pos = torch.as_tensor(MLA_LENS, dtype=torch.int32, device="cuda")
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    kernels.reset_launch_counts()
    step_s = []
    for _ in range(MLA_STEPS):
        t0 = time.perf_counter()
        logits, _ = model.decode_paged(engine.params, tok, engine.pool.kv,
                                       tabs, pos, page_size=ps)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        finite.logical_and_(torch.isfinite(logits).all())
        tok, pos = logits.argmax(-1)[:, None].long(), pos + 1
    step_counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"[serve-mla] moonlight-16b-a3b uncut ({L} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads, q/k {cfg.hd} v "
          f"{cfg.v_head_dim}, latent {cfg.kv_lora_rank} + rope "
          f"{cfg.qk_rope_dim}, {cfg.n_experts} experts of {cfg.d_ff} top-"
          f"{cfg.top_k} + {cfg.n_shared} shared, vocab {cfg.vocab}); "
          f"system=rns kv=rns8 B={B} prompts {list(MLA_LENS)}, "
          f"{MLA_STEPS} decode steps; {smi}", flush=True)
    print(f"[serve-mla] init {t_init:.1f}s, resident bytes {rb}, admission "
          f"{t_admit:.3f}s, decode steps {[round(t, 4) for t in step_s]}s, "
          f"kv pool bytes {engine.pool.pool_bytes()}, peak {peak} of "
          f"{total} (free at the peak {total - peak})", flush=True)
    print(f"[serve-mla] launches: admission {json.dumps(admit_counts)}; "
          f"decode {json.dumps(step_counts)}", flush=True)
    want_b2 = {"admission": L, "decode": L * MLA_STEPS}
    for name, c in (("admission", admit_counts), ("decode", step_counts)):
        if c["flash_attention"] != want_b2[name] or \
                c["rns_decode"] != c["rns_matmul"] or c["paged_decode"]:
            raise AssertionError(f"serve-mla: {name} launches {c}")
    if not (bool(finite) and np.isfinite(logits0).all()):
        raise AssertionError("serve-mla: a logit is not finite")

    # the admission's prefill again, untimed, each B1, B2 and B9 launch
    # held against its plain version on its own inputs as it returns: B1 in
    # stack mode at the expert buffers of the real tokens' capacity, B1 and
    # B9 at every latent-attention, dense and shared product and the head
    lens = np.array(MLA_LENS)
    padded = np.zeros((B, int(lens.max())), np.int64)
    for s, n in enumerate(MLA_LENS):
        padded[s, :n] = prompts[s]
    del out, tabs, tok, logits
    gc.collect()
    (_, held), b9 = hold_decode(lambda: hold_launches(
        held_checks("rns_matmul", "flash_attention"),
        lambda: model.prefill(
            engine.params, torch.as_tensor(padded, device="cuda"),
            s_max=int(lens.max()),
            logits_at=torch.as_tensor(lens - 1, device="cuda"),
            cache_dtype=engine.cache_dtype, lengths=lens.tolist())[0]))
    held = dict(held, rns_decode=b9)
    n_b1 = admit_counts["rns_matmul"]
    check_held(held, {"rns_matmul": n_b1, "flash_attention": L,
                      "rns_decode": n_b1}, "serve-mla",
               "the admission's prefill")
    return dict(admission=admit_counts, decode=step_counts,
                admit_s=t_admit, step_s=step_s, init_s=t_init,
                resident_bytes=rb, peak_bytes=peak,
                held={k: dict(launches=n, max_err=e, tol=HELD_TOL[k])
                      for k, (n, e) in held.items()})


def serve_moe(torch, smi):
    """Phase 12: moonshot-v1-16b-a3b at full width (d 2048, 16 heads of
    128, 64 experts of d_ff 1408, top-6, vocab 163840), the depth cut to
    MOE_LAYERS of 48, under system="rns" on rns8 pages: B 8, 256-token
    prompts, MOE_NEW new tokens, greedy.  Gates: every logit finite; exact
    launch counts, each stacked expert einsum one B1 launch; the B3
    launches of the first decode step equal to the plain version on their
    own inputs; the prefill and the first decode step run again, untimed,
    with each B1, B2 and B3 launch held against its plain version as it
    returns; and that decode step with the stacked launches gives logits
    bit-identical to the same step with one B1 launch per expert (the
    reference's scan), each step's time taken warm."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model, resident_bytes
    from repro_torch.numerics import kv_pages as kvp
    from repro_torch.numerics import registry
    from repro_torch.roofline import hw
    from repro_torch.serving.engine import ServingEngine

    full = get_config("moonshot-v1-16b-a3b")
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    L, B, plen, max_new, ps = cfg.n_layers, SERVE_B, SERVE_PROMPT, MOE_NEW, 64
    s_max = plen + max_new + 1
    per_step = forward_launches(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, system="rns", device="cuda")
    params = model.init(SEED)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    peak_init = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    decode_paged, finite = _finite_wrap(torch, model.decode_paged)
    engine = ServingEngine(
        dataclasses.replace(model, decode_paged=decode_paged), params,
        batch=B, s_max=s_max, page_size=ps, kv_format="rns8", device="cuda")
    params = engine.params
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (B, plen)).astype(np.int32)
    kernels.reset_launch_counts()
    res, first_b3 = record_launches(
        "paged_decode", L, lambda: engine.generate(
            {"tokens": prompts}, max_new=max_new), keep=_keep_b3)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = max(peak_init, torch.cuda.max_memory_allocated())
    total = torch.cuda.get_device_properties(0).total_memory
    rb = resident_bytes(params)
    steps = max_new - 1
    print(f"[serve-moe] cut: depth {L} of {full.n_layers}, for memory (full "
          f"width: d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv} heads of "
          f"{cfg.hd}, {cfg.n_experts} experts of d_ff {cfg.d_ff}, top-"
          f"{cfg.top_k}, vocab {cfg.vocab}); system=rns kv=rns8 B={B} "
          f"prompt={plen} new={max_new}; {smi}", flush=True)
    _serve_line("serve-moe", res.stats, B, steps, t_init, rb, peak,
                f" (at init {peak_init}) kv pool bytes="
                f"{engine.pool.pool_bytes()} device total={total} free at "
                f"the peak={total - peak}")
    print(f"[serve-moe] the step's byte bound: {rb} resident bytes (every "
          f"expert's planes are read) at {hw.HBM_BW / 1e12:.2f} TB/s = "
          f"{1e3 * rb / hw.HBM_BW:.2f} ms", flush=True)
    print(f"[serve-moe] launches {json.dumps(counts)}", flush=True)
    want = with_b9(dict(NO_LAUNCHES, rns_matmul=per_step * (1 + steps),
                        flash_attention=L, paged_decode=L * steps))
    if counts != want:
        raise AssertionError(f"serve-moe: launch counts {counts}, expected "
                             f"{want}")
    check_first_b3(first_b3, L, plen + 1, "serve-moe", cfg)
    if not (bool(finite) and np.isfinite(res.prefill_logits).all()):
        raise AssertionError("serve-moe: a logit is not finite")
    if res.tokens.shape != (B, max_new) or not (
            0 <= res.tokens.min() and res.tokens.max() < cfg.vocab):
        raise AssertionError("serve-moe: tokens misshapen or out of "
                             "[0, vocab)")
    print(f"[serve-moe] every logit finite; seq0 tokens "
          f"{res.tokens[0, :16].tolist()}", flush=True)
    del engine, res, first_b3
    gc.collect()
    torch.cuda.empty_cache()

    # the prefill again, each B1 and B2 launch held against its plain
    # version; then the first decode step from copies of one pool, held the
    # same way, and timed warm stacked and with one launch per expert
    (logits, cache), held = hold_launches(
        held_checks("rns_matmul", "flash_attention"),
        lambda: model.prefill(params, prompts, s_max=s_max))
    check_held(held, {"rns_matmul": per_step, "flash_attention": L},
               "serve-moe", "the prefill")
    tok = torch.argmax(logits, dim=-1, keepdim=True)
    del logits
    n_pmax = -(-s_max // ps)
    tab = torch.arange(1, 1 + B * n_pmax, dtype=torch.int32,
                       device="cuda").reshape(B, n_pmax)
    pools = []
    for _ in range(2):
        pool = kvp.make_paged_kv(L, 1 + B * n_pmax, ps, cfg.n_kv, cfg.hd,
                                 fmt="rns8", device="cuda")
        kvp.scatter_prefill(pool, cache[0], cache[1], tab, ps)
        pools.append(pool)
    del cache
    pos = torch.full((B,), plen, dtype=torch.int32, device="cuda")

    def step(pool):
        # rewrites the same KV row at pos with the same values: repeatable
        return model.decode_paged(params, tok, pool, tab, pos,
                                  page_size=ps)[0]

    def timed(pool, n=3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            out = step(pool)
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t) / n

    _, held = hold_launches(held_checks("rns_matmul", "paged_decode"),
                            lambda: step(pools[0]))
    check_held(held, {"rns_matmul": per_step, "paged_decode": L},
               "serve-moe", "the first decode step")
    n_stacked = held["rns_matmul"][0]
    kernels.reset_launch_counts()
    stacked, ms_stacked = timed(pools[0])
    if kernels.launch_counts()["rns_matmul"] != 3 * n_stacked:
        raise AssertionError("serve-moe: the timed stacked steps launched B1 "
                             f"{kernels.launch_counts()['rns_matmul']} times")
    kernel = registry.get_impl("rns_matmul", "cuda")

    def per_expert(a, b, moduli):
        if a.dim() == 4:
            return torch.stack([kernel(a[e], b[e], moduli)
                                for e in range(a.shape[0])])
        return kernel(a, b, moduli)

    registry.register_impl("rns_matmul", "cuda", per_expert)
    try:
        kernels.reset_launch_counts()
        step(pools[1])                          # warm
        n_scanned = kernels.launch_counts()["rns_matmul"]
        scanned, ms_scanned = timed(pools[1])
    finally:
        registry.register_impl("rns_matmul", "cuda", kernel)
    want_scan = per_step + 3 * L * (cfg.n_experts - 1)
    print(f"[serve-moe] one decode step, warm, host clock, mean of 3: "
          f"{ms_stacked:.1f} ms with {n_stacked} B1 launches (the stacked "
          f"einsums) against {ms_scanned:.1f} ms with {n_scanned} (one "
          f"launch per expert): logits bit-identical "
          f"{torch.equal(stacked, scanned)}", flush=True)
    if (n_stacked, n_scanned) != (per_step, want_scan):
        raise AssertionError(f"serve-moe: {n_stacked} / {n_scanned} B1 "
                             f"launches, expected {per_step} / {want_scan}")
    if not torch.equal(stacked, scanned):
        raise AssertionError("serve-moe: the stacked step's logits differ "
                             "from the per-expert step's")
    return counts


def serve_vlm(torch, smi):
    """Phase [serve-vlm]: pixtral-12b at full width, VLM_LAYERS of its 40
    layers (attention width 32 x 128 = 4096 against d_model 5120, tied logits at
    N 131072) under system="rns" on rns8 pages: B 8, 1024 synthetic patch
    embeddings from the seed, then VLM_TEXT text tokens, VLM_NEW new
    tokens, greedy.  Gates: every logit finite, exact launch counts, the B1
    and B3 launches of the first decode step equal to the plain version on
    their own inputs, and every B1 and B2 launch of the prefill, run again
    untimed, held against its plain version as it returns."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model, resident_bytes
    from repro_torch.models.frontends import synthetic_patches
    from repro_torch.serving.engine import ServingEngine

    cfg = dataclasses.replace(get_config("pixtral-12b"), n_layers=VLM_LAYERS)
    L, B, max_new = cfg.n_layers, SERVE_B, VLM_NEW
    plen = cfg.n_img_tokens + VLM_TEXT
    s_max = plen + max_new + 1
    per_step = forward_launches(cfg)
    label = "serve-vlm"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, system="rns", device="cuda")
    params = model.init(SEED)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    decode_paged, finite = _finite_wrap(torch, model.decode_paged)
    engine = ServingEngine(
        dataclasses.replace(model, decode_paged=decode_paged), params,
        batch=B, s_max=s_max, page_size=64, kv_format="rns8", device="cuda")
    params = engine.params
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    patches = synthetic_patches(gen, B, cfg)
    tokens = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (B, VLM_TEXT)).astype(np.int32)
    inputs = {"tokens": tokens, "patches": patches}
    kernels.reset_launch_counts()
    (res, first_b3), first_b1 = record_launches(
        "rns_matmul", per_step, lambda: record_launches(
            "paged_decode", L, lambda: engine.generate(
                inputs, max_new=max_new), keep=_keep_b3),
        skip=per_step)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    rb = resident_bytes(engine.params)
    steps = max_new - 1
    print(f"[{label}] pixtral-12b L={L} (full depth) d={cfg.d_model} heads "
          f"{cfg.n_heads}/{cfg.n_kv} x {cfg.hd} (attention width "
          f"{cfg.n_heads * cfg.hd}) d_ff={cfg.d_ff} vocab={cfg.vocab}; "
          f"system=rns kv=rns8 B={B} prompt={plen} ({cfg.n_img_tokens} "
          f"patches + {VLM_TEXT} tokens) new={max_new}; init peak "
          f"{init_peak}; {smi}", flush=True)
    _serve_line(label, res.stats, B, steps, t_init, rb, peak,
                f" kv pool bytes={engine.pool.pool_bytes()}")
    print(f"[{label}] launches {json.dumps(counts)}", flush=True)
    want = with_b9(dict(NO_LAUNCHES, rns_matmul=per_step * (1 + steps),
                        flash_attention=L, paged_decode=L * steps))
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts}, expected "
                             f"{want}")
    check_first_b3(first_b3, L, plen + 1, label, cfg)
    check_first_b1(first_b1, per_step, B, label)
    del engine, first_b3, first_b1
    gc.collect()
    torch.cuda.empty_cache()
    _, held = hold_launches(
        held_checks("rns_matmul", "flash_attention"),
        lambda: model.prefill(params, tokens, s_max=s_max, patches=patches))
    check_held(held, {"rns_matmul": per_step, "flash_attention": L}, label,
               "the prefill")
    if not (bool(finite) and np.isfinite(res.prefill_logits).all()):
        raise AssertionError(f"{label}: a logit is not finite")
    if res.tokens.shape != (B, max_new) or not (
            0 <= res.tokens.min() and res.tokens.max() < cfg.vocab):
        raise AssertionError(f"{label}: tokens misshapen or out of "
                             f"[0, vocab)")
    print(f"[{label}] every logit finite; seq0 tokens "
          f"{res.tokens[0, :16].tolist()}", flush=True)
    return counts


def serve_audio(torch, smi):
    """Phase [serve-audio]: whisper-small at full width and depth (12
    encoder and 12 decoder layers) under system="rns" on the dense bf16
    caches: B 8, AUDIO_FRAMES synthetic frames from the seed, an
    AUDIO_PROMPT-token decoder prompt, AUDIO_NEW new tokens, greedy.  The
    encoder runs B2 with ``causal=False``, the cross-attention B2
    (non-causal) at prefill and B5 (kv_len 1500) at decode, the decoder's
    self-attention B2 and B5 over its 448 positions; the logits are a float
    product (the reference's).  Gates: every logit finite, exact launch
    counts, the B1 and B5 launches of the first decode step equal to the
    plain version on their own inputs, and every B1 and B2 launch of the
    prefill, run again untimed, held as it returns, the B2 launches in the
    order and causality the model implies."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.moduli import P21
    from repro_torch.models.api import build_model, resident_bytes
    from repro_torch.models.frontends import synthetic_frames
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config("whisper-small")
    Le, Ld, B = cfg.n_enc_layers, cfg.n_layers, SERVE_B
    plen, max_new, T = AUDIO_PROMPT, AUDIO_NEW, AUDIO_FRAMES
    label = "serve-audio"

    def n(K):
        return len(_segments(K, 7, P21))

    d, f = cfg.d_model, cfg.d_ff
    # encoder layer: q, k, v, o, up at K d; down at K d_ff.  Decoder layer
    # at prefill: self q, k, v, o, cross k, v (over the memory), cross q, o,
    # up; down.  At decode the cross k and v are not recomputed
    pre_b1 = Le * (5 * n(d) + n(f)) + Ld * (9 * n(d) + n(f))
    step_b1 = Ld * (7 * n(d) + n(f))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, system="rns", device="cuda")
    params = model.init(SEED)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    decode, finite = _finite_wrap(torch, model.decode)
    engine = ServingEngine(dataclasses.replace(model, decode=decode), params,
                           batch=B, s_max=T, device="cuda")
    if engine.paged:
        raise AssertionError(f"{label}: the audio family serves from the "
                             f"dense cache")
    params = engine.params
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    frames = synthetic_frames(gen, B, T, cfg)
    tokens = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (B, plen)).astype(np.int32)
    kernels.reset_launch_counts()
    (res, first_b5), first_b1 = record_launches(
        "rns_matmul", step_b1, lambda: record_first_decode(
            2 * Ld, lambda: engine.generate(
                {"tokens": tokens, "frames": frames}, max_new=max_new)),
        skip=pre_b1)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    rb = resident_bytes(engine.params)
    steps = max_new - 1
    print(f"[{label}] whisper-small encoder {Le} + decoder {Ld} layers (full "
          f"depth) d={d} heads {cfg.n_heads}/{cfg.n_kv} x {cfg.hd} d_ff={f} "
          f"vocab={cfg.vocab} dec_len={cfg.dec_len}; system=rns, dense bf16 "
          f"caches, B={B} frames={T} prompt={plen} new={max_new}; {smi}",
          flush=True)
    # the self cache (dec_len rows) and the cross memory (T rows), K and V
    # in bf16 for every decoder layer
    kv_bytes = {n_: 2 * 2 * Ld * B * rows * cfg.n_kv * cfg.hd
                for n_, rows in (("self", cfg.dec_len), ("cross", T))}
    _serve_line(label, res.stats, B, steps, t_init, rb, peak,
                f" cache bytes {json.dumps(kv_bytes)}")
    print(f"[{label}] launches {json.dumps(counts)}", flush=True)
    want = with_b9(dict(NO_LAUNCHES, rns_matmul=pre_b1 + step_b1 * steps,
                        flash_attention=Le + 2 * Ld,
                        flash_decode=2 * Ld * steps))
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts}, expected "
                             f"{want}")
    check_first_b1(first_b1, step_b1, B, label)
    check_first_decode(first_b5, 2 * Ld, [plen + 1, T] * Ld, label)
    del engine, first_b5, first_b1
    gc.collect()
    torch.cuda.empty_cache()
    checks = held_checks("rns_matmul", "flash_attention")
    b2, seen = checks["flash_attention"], []

    def b2_order(out, q, k, v, kv_len=None, *, causal=True):
        seen.append((causal, q.shape[1], k.shape[1]))
        return b2(out, q, k, v, kv_len, causal=causal)

    checks["flash_attention"] = b2_order
    _, held = hold_launches(checks, lambda: model.prefill(
        params, tokens, frames=frames))
    check_held(held, {"rns_matmul": pre_b1, "flash_attention": Le + 2 * Ld},
               label, "the prefill")
    order = [(False, T, T)] * Le + [(True, plen, plen), (False, plen, T)] * Ld
    print(f"[{label}] the prefill's B2 launches (causal, Sq, T): "
          f"{sum(not c for c, _, _ in seen)} non-causal (the encoder's {Le} "
          f"at {T} x {T}, the cross-attention's {Ld} at {plen} x {T}), "
          f"{sum(c for c, _, _ in seen)} causal", flush=True)
    if seen != order:
        raise AssertionError(f"{label}: the prefill's B2 launches {seen}, "
                             f"expected {order}")
    if not (bool(finite) and np.isfinite(res.prefill_logits).all()):
        raise AssertionError(f"{label}: a logit is not finite")
    if res.tokens.shape != (B, max_new) or not (
            0 <= res.tokens.min() and res.tokens.max() < cfg.vocab):
        raise AssertionError(f"{label}: tokens misshapen or out of "
                             f"[0, vocab)")
    print(f"[{label}] every logit finite; seq0 tokens "
          f"{res.tokens[0, :16].tolist()}", flush=True)
    return counts


# ---------------------------------------------------------------------------
# Phase 15: training
# ---------------------------------------------------------------------------


def _timed_kernels(torch, names, run):
    """``run()`` with every launch of the kernels ``names`` bracketed by
    CUDA events: returns ``run()``'s result and each kernel's summed
    device ms."""
    from repro_torch.numerics import registry

    cards = {name: registry.get_impl(name, "cuda") for name in names}
    events = {name: [] for name in names}

    def timed(name):
        kernel = cards[name]

        def launch(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = kernel(*args, **kw)
            end.record()
            events[name].append((start, end))
            return out

        return launch

    for name in names:
        registry.register_impl(name, "cuda", timed(name))
    try:
        out = run()
    finally:
        for name, kernel in cards.items():
            registry.register_impl(name, "cuda", kernel)
    torch.cuda.synchronize()
    return out, {name: sum(s.elapsed_time(e) for s, e in ev)
                 for name, ev in events.items()}


def _all_finite(torch, tree):
    from repro_torch.train.tree import tree_leaves

    flag = torch.ones((), dtype=torch.bool, device="cuda")
    for x in tree_leaves(tree):
        flag.logical_and_(torch.isfinite(x).all())
    return bool(flag)


def train_full_width(torch):
    """Phase 15: qwen3-8b at full width, depth cut to TRAIN_LAYERS, trained
    under system="rns" (int4 codes on P21 planes made per call, the
    straight-through f32 backward) for TRAIN_STEPS AdamW steps of
    TRAIN_MICRO micro-batches, then the same steps under system="bns" from
    the same weights as a yardstick."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.tree import tree_leaves

    cfg = dataclasses.replace(get_config("qwen3-8b"), n_layers=TRAIN_LAYERS)
    L, n = cfg.n_layers, TRAIN_MICRO
    M = TRAIN_BATCH // n * TRAIN_SEQ
    pipe = TokenPipeline(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=SEED)
    opt = OptConfig(peak_lr=1e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
    per_step = (2 * 7 * L + 1) * n      # forward, remat's recompute, logits
    label = "train"
    out = {}
    for system in ("rns", "bns"):
        torch.cuda.reset_peak_memory_stats()
        model = build_model(cfg, system=system, device="cuda")
        params = model.init(SEED, prepare=False)
        n_params = sum(p.numel() for p in tree_leaves(params))
        state = init_opt_state(params, opt)
        torch.cuda.synchronize()
        if system == "rns":
            enc_ms = _train_encode_and_gate(torch, params, M)
        step = make_train_step(model, opt, n)
        want = with_b9(dict(NO_LAUNCHES, rns_matmul=per_step
                            if system == "rns" else 0))
        losses, times, b1_ms, total = [], [], [], dict(NO_LAUNCHES)
        for i in range(TRAIN_STEPS):
            batch = pipe.batch_at(i)
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if system == "rns" and i == 0:
                (params, state, met), held = hold_launches(
                    held_checks("rns_matmul"),
                    lambda: step(params, state, batch))
            elif system == "rns":
                (params, state, met), ms = _timed_kernels(
                    torch, ("rns_matmul",), lambda: step(params, state, batch))
                b1_ms.append(ms["rns_matmul"])
            else:
                params, state, met = step(params, state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            counts = kernels.launch_counts()
            if counts != want:
                raise AssertionError(f"{label} {system} step {i}: launch "
                                     f"counts {counts}, expected {want}")
            total = {k: total[k] + counts[k] for k in total}
            loss, gnorm = float(met["loss"]), float(met["grad_norm"])
            if not (np.isfinite(loss) and np.isfinite(gnorm)
                    and _all_finite(torch, params)):
                raise AssertionError(f"{label} {system} step {i}: loss "
                                     f"{loss}, grad_norm {gnorm} or a "
                                     f"parameter not finite")
            losses.append(loss)
            print(f"[{label}] {system} step {i}: loss={loss:.6f} grad_norm="
                  f"{gnorm:.4f} lr={float(met['lr']):.3e} step_s="
                  f"{times[-1]:.3f}"
                  + (f" B1_ms={b1_ms[-1]:.3f}" if b1_ms and i else ""),
                  flush=True)
            if system == "rns" and i == 0:
                check_held(held, {"rns_matmul": per_step}, label,
                           "the first rns step")
        peak = torch.cuda.max_memory_allocated()
        step_s = statistics.mean(times[1:])
        print(f"[{label}] qwen3-8b L={L} d={cfg.d_model} vocab={cfg.vocab} "
              f"system={system} batch {TRAIN_BATCH} x seq {TRAIN_SEQ} in "
              f"{n} micro-batches (M={M}), remat, f32 params and moments "
              f"({n_params} parameters): step_s={step_s:.3f} (mean of steps "
              f"1-{TRAIN_STEPS - 1}; step 0 {times[0]:.3f}) "
              f"max_memory_allocated={peak} launches {json.dumps(total)}",
              flush=True)
        out[system] = dict(step_s=step_s, losses=losses, peak=peak,
                           counts=total, times=times)
        if system == "rns":
            b1 = statistics.mean(b1_ms)
            enc = n * (2 * enc_ms["layers"] + enc_ms["logits"])
            print(f"[{label}] rns step: B1 {b1:.3f} ms in {per_step} launches "
                  f"({100 * b1 / 1e3 / step_s:.2f} % of the step); the "
                  f"per-call weight encode, timed by itself ({n} x (2 x "
                  f"{7 * L} layer weights + the logits weight)) {enc:.3f} ms "
                  f"({100 * enc / 1e3 / step_s:.2f} %)", flush=True)
            out[system].update(b1_ms=b1, encode_ms=enc)
        del model, params, state, step, met
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[{label}] rns step_s / bns step_s = "
          f"{out['rns']['step_s'] / out['bns']['step_s']:.3f}; loss rns "
          f"{out['rns']['losses']} bns {out['bns']['losses']}", flush=True)
    return out


def _train_encode_and_gate(torch, params, M):
    """Gate (b): on layer 0's seven weights and the tied logits weight,
    ``dense`` of the float weight (the per-call path) equals ``dense`` of
    its prepared planes bit for bit at M rows; and each weight's per-call
    encode (quantize, then residue planes) timed by itself."""
    from repro_torch.models import linear
    from repro_torch.quant import residency

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    lp = params["layers"][0]
    named = [(k, lp["attn"][k]["w"]) for k in ("wq", "wk", "wv", "wo")]
    named += [(k, lp["mlp"][k]["w"]) for k in ("w_gate", "w_up", "w_down")]
    named.append(("logits", params["embed"]["table"].T))
    kw = dict(system="rns", compute_dtype=torch.bfloat16)
    enc = {}
    with torch.no_grad():
        for name, w in named:
            x = torch.randn(M, w.shape[0], generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            per_call = linear.dense({"w": w}, x, **kw)
            prepared = linear.dense(residency.prepare_dense({"w": w},
                                                            system="rns"),
                                    x, **kw)
            if not torch.equal(per_call, prepared):
                raise AssertionError(f"train: the per-call dense of {name} "
                                     f"{tuple(w.shape)} differs from the "
                                     f"prepared one")
            del x, per_call, prepared
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            residency.prepare_weight(w, system="rns")
            start.record()
            for _ in range(3):
                residency.prepare_weight(w, system="rns")
            end.record()
            end.synchronize()
            enc[name] = start.elapsed_time(end) / 3
    print(f"[train] per-call dense equals the prepared planes' bit for bit "
          f"at M={M} on layer 0's seven weights and the logits weight; "
          f"per-call encode ms "
          f"{json.dumps({k: round(v, 4) for k, v in enc.items()})}",
          flush=True)
    return {"layers": TRAIN_LAYERS * sum(v for k, v in enc.items()
                                         if k != "logits"),
            "logits": enc["logits"]}


def train_small(torch):
    """Phase 15b: the reduced qwen3-8b on the card under rns: the loss falls
    over 30 steps on the learnable stream; a run that fails before step 5
    and restarts from its checkpoint ends bit-identical to an
    uninterrupted one; the sdrns step equals the rns step bit for bit with
    B6 launched and held; prepare=False serving gives the prepared
    engine's logits and tokens."""
    import tempfile

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels.sdrns_matmul import sdrns_matmul_ref
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.train import checkpoint
    from repro_torch.train.ft import (FtConfig, SimulatedFailure,
                                      run_training)
    from repro_torch.train.loop import loss_and_grads, make_train_step
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.tree import tree_leaves

    label = "train-small"
    cfg = get_config("qwen3-8b").reduced()
    model = build_model(cfg, system="rns", device="cuda")
    opt = OptConfig(peak_lr=1e-2, warmup_steps=3, total_steps=30)
    pipe = TokenPipeline(cfg.vocab, 64, 8, seed=SEED)

    def fresh():
        params = model.init(SEED, prepare=False)
        return {"params": params, "opt_state": init_opt_state(params, opt)}

    step = make_train_step(model, opt, 1)
    state = fresh()
    p, o = state["params"], state["opt_state"]
    losses = []
    for i in range(30):
        p, o, met = step(p, o, pipe.batch_at(i))
        losses.append(float(met["loss"]))
    first, last = losses[0], statistics.mean(losses[-5:])
    print(f"[{label}] reduced qwen3-8b rns, 30 steps, batch 8 x seq 64, lr "
          f"1e-2: loss {first:.4f} -> mean of the last 5 {last:.4f}; every "
          f"3rd {[round(x, 4) for x in losses[::3]]}", flush=True)
    if not (np.isfinite(losses).all() and last < first - 1.0):
        raise AssertionError(f"{label}: the loss did not fall by 1.0 "
                             f"({first} -> {last})")

    def run(d, failure_at=None):
        fcfg = FtConfig(ckpt_dir=d, total_steps=8, ckpt_every=2,
                        failure_at=failure_at, log_fn=lambda s: None)
        try:
            return run_training(init_state=fresh, train_step=step,
                                batch_at=pipe.batch_at, cfg=fcfg)
        except SimulatedFailure:
            fcfg.failure_at = None
            return run_training(init_state=fresh, train_step=step,
                                batch_at=pipe.batch_at, cfg=fcfg)

    with tempfile.TemporaryDirectory() as d:
        whole = run(os.path.join(d, "a"))
        again = run(os.path.join(d, "b"), failure_at=5)
    leaves = [tree_leaves({k: r[k] for k in ("params", "opt_state")})
              for r in (whole, again)]
    same = all(torch.equal(a, b) for a, b in zip(*leaves))
    print(f"[{label}] failure before step 5, restart from the step-4 "
          f"checkpoint: parameters, moments and step equal to an "
          f"uninterrupted run's bit for bit {same} ({len(leaves[0])} "
          f"leaves); losses after the restart {again['history']}",
          flush=True)
    if not same or again["history"] != whole["history"][4:]:
        raise AssertionError(f"{label}: the restarted run differs")

    batch = TokenPipeline(cfg.vocab, 16, 4, seed=SEED + 1).batch_at(0)
    params = model.init(SEED, prepare=False)
    res = {}
    for system in ("rns", "sdrns"):
        m = build_model(cfg, system=system, device="cuda")
        if system == "rns":
            res[system] = loss_and_grads(m, params, batch)
            continue

        def b6(out, a, b, ws):
            return float((out.long() - sdrns_matmul_ref(a, b, ws).long()
                          ).abs().max())

        res[system], held = hold_launches(
            {"sdrns_matmul": b6}, lambda: loss_and_grads(m, params, batch))
        n_b6, worst = held["sdrns_matmul"]
        print(f"[{label}] sdrns step: {n_b6} B6 launches (M 64) against the "
              f"plain version on their own inputs, max_abs_err={worst}",
              flush=True)
        if n_b6 != 7 * cfg.n_layers + 1 or worst != 0:
            raise AssertionError(f"{label}: B6 launched {n_b6} times or "
                                 f"differs from its plain version")
    (l0, c0), g0 = res["rns"]
    (l1, c1), g1 = res["sdrns"]
    same = (torch.equal(l0, l1) and torch.equal(c0, c1) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(g0),
                                          tree_leaves(g1))))
    print(f"[{label}] sdrns loss and every gradient equal rns's bit for bit "
          f"{same} (loss {float(l0):.6f})", flush=True)
    if not same:
        raise AssertionError(f"{label}: sdrns differs from rns")

    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (3, 8)).astype(np.int32)
    gens = [ServingEngine(model, params, batch=3, s_max=17, page_size=8,
                          kv_format="rns8", device="cuda", prepare=prep
                          ).generate({"tokens": prompts}, max_new=8)
            for prep in (True, False)]
    same_logits = np.array_equal(gens[0].prefill_logits,
                                 gens[1].prefill_logits)
    same_tokens = np.array_equal(gens[0].tokens, gens[1].tokens)
    print(f"[{label}] ServingEngine(prepare=False), the per-call path: "
          f"prefill logits bit-identical to the prepared engine's "
          f"{same_logits}, tokens equal {same_tokens}", flush=True)
    if not (same_logits and same_tokens):
        raise AssertionError(f"{label}: prepare=False serving differs")

    # the prepared tree through a checkpoint: saved from the card, restored
    # onto the card into another prepared tree, served
    prepared = model.prepare_params(params)
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 1, prepared)
        back = checkpoint.restore(d, model.init(SEED + 9))
    pairs = list(zip(_resident(back), _resident(prepared)))
    same_planes = all(a.planes.is_cuda and torch.equal(a.planes, b.planes)
                      and torch.equal(a.scale, b.scale) for a, b in pairs)
    served = ServingEngine(model, back, batch=3, s_max=17, page_size=8,
                           kv_format="rns8", device="cuda").generate(
        {"tokens": prompts}, max_new=8)
    same_logits = np.array_equal(served.prefill_logits,
                                 gens[0].prefill_logits)
    same_tokens = np.array_equal(served.tokens, gens[0].tokens)
    print(f"[{label}] prepared tree saved from the card and restored onto "
          f"it ({len(pairs)} ResidueTensors as .../w/0 planes and .../w/1 "
          f"scales): planes and scales equal {same_planes}; prefill logits "
          f"bit-identical {same_logits}, tokens equal {same_tokens}",
          flush=True)
    if not (pairs and same_planes and same_logits and same_tokens):
        raise AssertionError(f"{label}: the restored prepared tree differs")


def _resident(tree):
    from repro_torch.quant import residency

    out = []
    residency.map_resident(tree, out.append)
    return out


# ---------------------------------------------------------------------------
# Phase 16: the paper's DNN evaluation
# ---------------------------------------------------------------------------


def check_cnn_kernels(torch, timer, gen):
    """B1 at CNN_B1_SHAPES on P21 planes (``b1_shape``: bit for bit, kernel,
    plain version, ``_int_mm`` and the bound), and B6 at VGG-16's conv2
    shape on random digit vectors: digit for digit against the plain
    version on the first CNN_ROWS rows and SD_COLS columns, decoded
    residues equal to B1's at the full shape, timed beside its bound."""
    from repro_torch.core import sdrns
    from repro_torch.core.moduli import P21
    from repro_torch.kernels.rns_matmul import rns_matmul_cuda
    from repro_torch.kernels.sdrns_matmul import (sdrns_matmul_cuda,
                                                  sdrns_matmul_ref)
    from repro_torch.roofline import op_cost

    b1 = {f"{M},{K},{N}": b1_shape(torch, timer, gen, P21, "cnn", M, K, N)
          for M, K, N in CNN_B1_SHAPES}
    mset, C, n = P21, P21.num_channels, 7
    ws = [sdrns.WRAP_SIGNS[k] for k, _ in mset.kinds]
    M, K, N = CNN_B6_SHAPE
    a = _digits(torch, gen, C, M, K, n)
    b = _digits(torch, gen, C, K, N, n)
    out = sdrns_matmul_cuda(a, b, ws)
    a_s, b_s = a[:, :CNN_ROWS], b[:, :, :SD_COLS]
    err = int((out[:, :CNN_ROWS, :SD_COLS].to(torch.int32)
               - sdrns_matmul_ref(a_s, b_s, ws).to(torch.int32)).abs().max())
    a_res, b_res = _sd_residues(torch, a, mset), _sd_residues(torch, b, mset)
    rns = rns_matmul_cuda(a_res, b_res, mset.moduli)
    dec = torch.stack([sdrns.decode_residue(out[c], kind, w)
                       for c, (kind, w) in enumerate(mset.kinds)])
    if err != 0 or not torch.equal(dec, rns):
        raise AssertionError(f"sdrns_matmul[cnn] M={M} K={K} N={N}: digits "
                             f"differ from the plain version or decode "
                             f"unlike rns_matmul")
    del out, rns, dec
    ms = timer(lambda: sdrns_matmul_cuda(a, b, ws), 3)
    plain = timer(lambda: sdrns_matmul_ref(a_s, b_s, ws), 1)
    rns_ms = timer(lambda: rns_matmul_cuda(a_res, b_res, mset.moduli), 5)
    bms, by = bound_ms(op_cost.sdrns_work(C, M, K, N, n))
    print(f"[kernels] sdrns_matmul[cnn] C={C} M={M} K={K} N={N} n={n} (VGG-16 "
          f"conv2 at batch 64): digits equal the plain version on "
          f"{CNN_ROWS} rows x {min(N, SD_COLS)} columns, decoded residues "
          f"equal rns_matmul's at the full shape; kernel_ms={ms:.3f} "
          f"plain_ms({CNN_ROWS} rows, {min(N, SD_COLS)} cols)={plain:.3f} "
          f"bound_ms={bms:.4f} ({by}); yardstick rns_matmul_ms={rns_ms:.4f}",
          flush=True)
    del a, b, a_res, b_res, a_s, b_s
    torch.cuda.empty_cache()
    b6 = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
              library_ms=None, max_abs_err=err, yardstick_rns_matmul_ms=rns_ms,
              at=f"VGG-16 conv2 at batch 64: M={M} K={K} N={N}, P21 digits; "
                 f"plain_ms on the first {CNN_ROWS} rows and "
                 f"{min(N, SD_COLS)} columns; no PyTorch call computes SD "
                 f"digit vectors")
    return b1, b6


def cnn_launches(spec, batch, system):
    """Kernel launches of one ``cnn_forward`` over ``batch`` images at
    CNN_BITS on P21, from the runners' own segment cuts: B1 one a K segment
    under rns; under sdrns B6 one a segment at M > DECODE_M, B7 one a
    segment and a block of DECODE_M rows at M <= DECODE_M."""
    from repro_torch.core.moduli import P21
    from repro_torch.data.cifar import dense_shapes
    from repro_torch.numerics import runners
    from repro_torch.quant.quant import qmax_for_bits

    q = qmax_for_bits(CNN_BITS)
    want = dict(NO_LAUNCHES)
    for M, K, _ in dense_shapes(spec, batch):
        if system == "rns":
            want["rns_matmul"] += len(runners.rns_segments(K, q, q, P21))
        elif system == "sdrns":
            segs = len(runners.sdrns_segments(K, q, q, P21))
            if M <= runners.DECODE_M:
                want["sdrns_matvec"] += segs * -(-M // runners.DECODE_M)
            else:
                want["sdrns_matmul"] += segs
    return with_b9(want)


def cnn_bounds(spec, batch, system):
    """The least device ms of each kernel's launches in one forward: per
    launch the larger of its bytes (int8 residues and int32 outputs for B1;
    7-byte digit vectors for B6 / B7) at HBM_BPS and its int8 operations at
    the int8 peak, summed over the launches ``cnn_launches`` counts."""
    from repro_torch.core.moduli import P21
    from repro_torch.data.cifar import dense_shapes
    from repro_torch.numerics import runners
    from repro_torch.quant.quant import qmax_for_bits
    from repro_torch.roofline import op_cost

    q, C, out = qmax_for_bits(CNN_BITS), P21.num_channels, {}
    for M, K, N in dense_shapes(spec, batch) if system != "bns" else ():
        if system == "rns":
            name, cuts = "rns_matmul", runners.rns_segments(K, q, q, P21)
        else:
            name = ("sdrns_matvec" if M <= runners.DECODE_M
                    else "sdrns_matmul")
            cuts = runners.sdrns_segments(K, q, q, P21)
        for lo, hi in cuts:
            k = hi - lo
            work = (op_cost.rns_matmul_work(C, M, k, N) if system == "rns"
                    else op_cost.sdrns_work(C, M, k, N, 7))
            out[name] = out.get(name, 0.0) + bound_ms(work)[0]
    return out


def cnn_library_ms(torch, timer, spec, batch):
    """The library's time for one rns forward's B1 launches: per launch
    (each K segment of each ``dense`` call, ``cnn_launches``'s cuts) the
    faster ``torch._int_mm`` layout of ``_int_mm_best`` on operands over
    the centred P21 range, held equal to the plain version; summed over the
    launches (a shape seen before is timed once)."""
    from repro_torch.core.moduli import P21
    from repro_torch.data.cifar import dense_shapes
    from repro_torch.kernels.rns_matmul import rns_matmul_ref
    from repro_torch.numerics import runners
    from repro_torch.quant.quant import qmax_for_bits

    q, C, h = qmax_for_bits(CNN_BITS), P21.num_channels, max(P21.moduli) // 2
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    seen, total = {}, 0.0
    for M, K, N in dense_shapes(spec, batch):
        for lo, hi in runners.rns_segments(K, q, q, P21):
            key = (M, hi - lo, N)
            if key not in seen:
                a, b = (torch.randint(-h, h + 1, shape, generator=gen,
                                      device="cuda", dtype=torch.int32
                                      ).to(torch.int8)
                        for shape in ((C, M, hi - lo), (C, hi - lo, N)))
                seen[key] = _int_mm_best(
                    torch, timer, a, b, P21.moduli,
                    rns_matmul_ref(a, b, P21.moduli),
                    f"rns_matmul[cnn library] M={M} K={hi - lo} N={N}")[0]
                del a, b
            total += seen[key]
    torch.cuda.empty_cache()
    return total


def _oracle_dense(torch):
    """``linear.dense`` under rns as a plain integer oracle: the same int
    codes (per token and per output channel), their product in float64 on
    the card (exact: |acc| <= 31 * 31 * 4608 < 2**53), dequantized by the
    same ops as ``_qmatmul_resident``."""
    from repro_torch.quant.quant import quantize_symmetric

    def dense(params, x, *, system, bits, compute_dtype, **_):
        if system != "rns":
            raise ValueError(f"the oracle stands for rns, not {system!r}")
        lead = x.shape[:-1]
        qx, sx = quantize_symmetric(
            x.reshape(-1, x.shape[-1]).to(torch.float32), bits, axis=-1)
        qw, sw = quantize_symmetric(params["w"].to(torch.float32), bits,
                                    axis=-2)
        acc = torch.matmul(qx.double(), qw.double()).to(torch.int32)
        y = acc.to(torch.float32) * sx * sw
        return y.reshape(*lead, y.shape[-1]).to(compute_dtype)

    return dense


def cnn_eval(torch, smi):
    """Phase 16: AlexNet and VGG-16 (data/cifar.py) at their published CIFAR
    shapes under bns, rns and sdrns on the card.  Untimed first: the rns
    logits of AlexNet against the plain integer oracle (all CNN_EVAL
    images), every B1 launch of one AlexNet forward and every B6 launch of
    one AlexNet sdrns forward held against the plain versions, and VGG-16's
    batch of CNN_SMALL under sdrns with its B6 and B7 launches held.  Then,
    with the launch counters reset just before and read just after, each
    net under each system over CNN_EVAL images in batches of CNN_BATCH
    (one warm batch, then the timed ones; kernel device ms by CUDA events)
    and each net's batch of CNN_SMALL under rns and sdrns (its fc layers
    on B7).  Gates: sdrns
    logits equal to rns's bit for bit (both nets, both batch sizes), the
    launch counts equal to ``cnn_launches``, AlexNet's rns accuracy within
    0.08 of its float accuracy, every logit finite."""
    sys.path.insert(0, os.path.join(HERE, "examples"))
    import torch_rns_cnn_inference as example

    from repro_torch import kernels
    from repro_torch.core.cost_model import speedup
    from repro_torch.data import cifar
    from repro_torch.kernels.sdrns_matmul import sdrns_matmul_ref
    from repro_torch.models import linear

    label = "cnn"
    dev = torch.device("cuda")
    rns_kw = {"system": "rns", "bits": CNN_BITS,
              "compute_dtype": torch.float32}
    sd_kw = dict(rns_kw, system="sdrns")
    kws = {"bns": example.BNS, "rns": rns_kw, "sdrns": sd_kw}
    nets = {"alexnet": cifar.ALEXNET, "vgg16": cifar.VGG16}
    torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    params = {"alexnet": cifar.init_cnn(
        torch.Generator(device=dev).manual_seed(SEED), cifar.ALEXNET,
        device=dev)}
    xs, ys = (torch.from_numpy(v).to(dev)
              for v in cifar.synthetic_cifar(CNN_TRAIN_N, split="train"))
    losses = example.train_float(params["alexnet"], cifar.ALEXNET, xs, ys,
                                 steps=CNN_TRAIN_STEPS, batch=CNN_BATCH,
                                 log=lambda line: None)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    print(f"[{label}] AlexNet, float SGD under bns, {CNN_TRAIN_STEPS} steps "
          f"of {CNN_BATCH} on synthetic_cifar({CNN_TRAIN_N}): loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} in {t_train:.2f}s "
          f"({1e3 * t_train / CNN_TRAIN_STEPS:.1f} ms a step)", flush=True)
    del xs, ys
    params["vgg16"] = cifar.init_cnn(
        torch.Generator(device=dev).manual_seed(SEED), cifar.VGG16,
        device=dev)
    xt, yt = (torch.from_numpy(v).to(dev)
              for v in cifar.synthetic_cifar(CNN_EVAL, split="test"))
    batches = [xt[i:i + CNN_BATCH] for i in range(0, CNN_EVAL, CNN_BATCH)]
    small = xt[:CNN_SMALL]

    def forward(net, x, system):
        with torch.no_grad():
            return cifar.cnn_forward(params[net], nets[net], x,
                                     dense_kw=kws[system])

    def sd_check(out, a, b, ws):
        return float((out[:, :CNN_ROWS, :SD_COLS].long() - sdrns_matmul_ref(
            a[:, :CNN_ROWS], b[:, :, :SD_COLS], ws).long()).abs().max())

    # untimed: the oracle and the held launches
    oracle = _oracle_dense(torch)
    card_dense, linear.dense = linear.dense, oracle
    try:
        want_rns = torch.cat([forward("alexnet", x, "rns") for x in batches])
    finally:
        linear.dense = card_dense
    held = {}
    _, held["alexnet rns"] = hold_launches(
        held_checks("rns_matmul"), lambda: forward("alexnet", batches[0],
                                                   "rns"))
    _, held["alexnet sdrns"] = hold_launches(
        {"sdrns_matmul": sd_check, "sdrns_matvec": sd_check},
        lambda: forward("alexnet", batches[0], "sdrns"))
    _, held["vgg16 sdrns small"] = hold_launches(
        {"sdrns_matmul": sd_check, "sdrns_matvec": sd_check},
        lambda: forward("vgg16", small, "sdrns"))
    for what, rec in held.items():
        net, system = what.split()[:2]
        x_b = CNN_SMALL if what.endswith("small") else CNN_BATCH
        want = cnn_launches(nets[net], x_b, system)
        for name, (n, worst) in rec.items():
            sample = ("" if name == "rns_matmul" else
                      f" (up to {CNN_ROWS} rows x {SD_COLS} columns)")
            print(f"[{label}] {what} (batch {x_b}): {n} {name} launches "
                  f"against the plain version on their own inputs{sample}, "
                  f"max_abs_err={worst}", flush=True)
            if n != want[name] or worst != 0:
                raise AssertionError(f"{label}: {what}: {n} {name} launches "
                                     f"(expected {want[name]}) or differs "
                                     f"from its plain version ({worst})")

    # counted and timed
    res, dev_ms, bounds = {}, {}, {}
    want = dict(NO_LAUNCHES)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for net, spec in nets.items():
        for system in ("bns", "rns", "sdrns"):
            forward(net, batches[0], system)             # warm
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, ms = _timed_kernels(
                torch, ("rns_matmul", "sdrns_matmul", "sdrns_matvec"),
                lambda: torch.cat([forward(net, x, system)
                                   for x in batches]))
            sec = time.perf_counter() - t
            res[(net, system)] = logits
            per = cnn_launches(spec, CNN_BATCH, system)
            for name in want:
                want[name] += per[name] * (1 + len(batches))
            dev_ms[(net, system)] = {k: v / len(batches) for k, v in
                                     ms.items() if per[k]}
            acc = float((logits.argmax(-1) == yt.long()).float().mean())
            b_ms = 1e3 * sec / len(batches)
            res[(net, system, "stats")] = dict(ms_batch=b_ms, acc=acc,
                                               images_s=CNN_BATCH * 1e3 / b_ms)
            bnd = bounds[(net, system)] = cnn_bounds(spec, CNN_BATCH,
                                                     system)
            kern = " ".join(f"{k}={v:.3f} (bound {bnd[k]:.4f})" for k, v in
                            dev_ms[(net, system)].items())
            print(f"[{label}] {net} {system}: {CNN_EVAL} images in "
                  f"{len(batches)} batches of {CNN_BATCH}: {b_ms:.2f} ms a "
                  f"batch ({CNN_BATCH * 1e3 / b_ms:.1f} images/s), accuracy "
                  f"{acc:.4f}; kernel device ms a forward: "
                  f"{kern or 'no kernel'}", flush=True)
        for system in ("rns", "sdrns"):
            res[(net, system, "small")], ms = _timed_kernels(
                torch, ("rns_matmul", "sdrns_matmul", "sdrns_matvec"),
                lambda: forward(net, small, system))
            per = cnn_launches(spec, CNN_SMALL, system)
            for name in want:
                want[name] += per[name]
            key = (net, f"{system}[batch {CNN_SMALL}]")
            dev_ms[key] = {k: v for k, v in ms.items() if per[k]}
            bnd = bounds[key] = cnn_bounds(spec, CNN_SMALL, system)
            print(f"[{label}] {net} {system} at batch {CNN_SMALL}: kernel "
                  f"device ms a forward: " + " ".join(
                      f"{k}={ms[k]:.3f} (bound {bnd[k]:.4f})"
                      for k in ms if per[k]), flush=True)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[{label}] launches over the counted runs: {counts} (expected "
          f"{want}); max_memory_allocated {peak:.2f} GB", flush=True)
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts} != {want}")

    same_oracle = torch.equal(res[("alexnet", "rns")], want_rns)
    print(f"[{label}] AlexNet rns logits equal the plain integer oracle "
          f"(float64 products of the same int{CNN_BITS} codes) bit for bit "
          f"{same_oracle}", flush=True)
    if not same_oracle:
        raise AssertionError(f"{label}: rns logits differ from the oracle")
    for net in nets:
        for key in ((net, "sdrns"), (net, "sdrns", "small")):
            ref = res[(net, "rns") + key[2:]]
            same = torch.equal(res[key], ref)
            what = f"batch {CNN_SMALL}" if key[2:] else f"{CNN_EVAL} images"
            print(f"[{label}] {net} sdrns logits equal rns's bit for bit "
                  f"{same} ({what})", flush=True)
            if not same:
                raise AssertionError(f"{label}: {key} differs from rns")
    finite = all(bool(torch.isfinite(v).all()) for k, v in res.items()
                 if k[-1] != "stats")
    acc_f = res[("alexnet", "bns", "stats")]["acc"]
    acc_r = res[("alexnet", "rns", "stats")]["acc"]
    print(f"[{label}] every logit finite {finite}; AlexNet accuracy float "
          f"{acc_f:.4f}, rns int{CNN_BITS} {acc_r:.4f} (gate: rns >= float "
          f"- 0.08)", flush=True)
    if not finite or acc_r < acc_f - 0.08:
        raise AssertionError(f"{label}: non-finite logits or rns accuracy "
                             f"{acc_r} below float {acc_f} - 0.08")

    timer = Timer(torch)
    library = {net: cnn_library_ms(torch, timer, spec, CNN_BATCH)
               for net, spec in nets.items()}
    del timer
    for net in nets:
        print(f"[{label}] {net} rns: torch._int_mm in place of the "
              f"{cnn_launches(nets[net], CNN_BATCH, 'rns')['rns_matmul']} "
              f"B1 launches of one forward of {CNN_BATCH} images (per "
              f"launch, the faster B layout, summed) {library[net]:.4f} ms "
              f"against B1's {dev_ms[(net, 'rns')]['rns_matmul']:.3f} ms "
              f"in the forward; {smi}", flush=True)
    model = {}
    for net, spec in nets.items():
        ops = cifar.op_counts(spec)
        x, y = ops["adds"], ops["muls"]
        st = {s: res[(net, s, "stats")]["ms_batch"]
              for s in ("bns", "rns", "sdrns")}
        model[net] = dict(
            eq3_sdrns_over_rns=speedup("RNS", "SD-RNS", 24, x, y),
            eq3_sdrns_over_bns=speedup("BNS", "SD-RNS", 24, x, y),
            card_rns_over_sdrns=st["rns"] / st["sdrns"],
            card_bns_over_sdrns=st["bns"] / st["sdrns"])
        m = model[net]
        print(f"[{label}] {net} op mix adds={x:,} muls={y:,}: Eq. 3 at P 24 "
              f"(the paper's circuits) SD-RNS x{m['eq3_sdrns_over_rns']:.3f} "
              f"over RNS, x{m['eq3_sdrns_over_bns']:.3f} over BNS; this "
              f"card's batch times (this port's kernels, not those circuits; "
              f"no claim) rns/sdrns {m['card_rns_over_sdrns']:.3f}, "
              f"bns/sdrns {m['card_bns_over_sdrns']:.3f}; {smi}",
              flush=True)
    return {"counts": counts, "peak_gb": peak, "train_s": t_train,
            "library_ms": library,
            "bound_ms": {f"{n} {s}": v for (n, s), v in bounds.items()},
            "losses": [losses[0], losses[-1]],
            "stats": {f"{n} {s}": res[(n, s, "stats")] for n in nets
                      for s in ("bns", "rns", "sdrns")},
            "kernel_ms": {f"{n} {s}": v for (n, s), v in dev_ms.items()},
            "model": model}



# ---------------------------------------------------------------------------
# Phase 17: the mesh
# ---------------------------------------------------------------------------

# [mesh]: ranks that share the one card, in a gloo group (NCCL refuses two
# ranks on one device).  Each case: (label, tensor-parallel ranks, layout,
# system, moduli set, layers, batch, prompt, new tokens); the data axis is
# 1.  qwen3-8b at full width, depth cut for time (the tied logits weight,
# K 4096 x N 151936, runs as every serve's does)
MESH_CASES = [
    ("a", 2, "col", "rns", "P21", 2, 8, 256, 8),
    ("b", 3, "chan", "rns", "P21", 2, 8, 256, 8),
    ("c", 5, "chan", "rns", "P21R2", 1, 8, 256, 8),
    ("d", 3, "chan", "sdrns", "P21", 1, 2, 16, 4),
]
MESH_WORLD = 5
# (c): the information-channel element of layer 0's wq that rank 0 corrupts
MESH_FAULT = (0, 3, 5)
MESH_KERNELS = ("rns_matmul", "flash_attention", "flash_decode",
                "sdrns_matmul", "sdrns_matvec", "rns_decode")
# [mesh]'s train cases, in the same spawned ranks: (label, mesh shape) of
# the sharded train step (train/loop.py's TrainSharding, seq_shard on) of
# qwen3-8b at full width cut to MESH_TRAIN_LAYERS, under rns, batch
# MESH_TRAIN_B x MESH_TRAIN_S tokens in MESH_TRAIN_MICRO micro-batches,
# MESH_TRAIN_STEPS AdamW steps (16 B a parameter: ~16 GB whole, a quarter
# of the blocks a rank on (2, 2)); rank 0 runs the one-process steps they
# are held against on the same card.  Activations in f32, as the CPU tests
# whose limits hold here: in bf16 a sum taken in another order (the column
# plan's over the tensor axis) moves single elements by a bf16 ulp, past
# those limits (as these cases show on the CPU at reduced width)
MESH_TRAIN = [("e", (1, 2)), ("f", (2, 2))]
MESH_TRAIN_LAYERS, MESH_TRAIN_B, MESH_TRAIN_S = 2, 8, 128
MESH_TRAIN_MICRO, MESH_TRAIN_STEPS = 2, 2
MESH_TRAIN_OPT = dict(peak_lr=1e-4, warmup_steps=0, total_steps=10)
# the CPU tests' limits (tests/test_torch_mesh_train.py)
MESH_RTOL, MESH_ATOL, MESH_LOSS_RTOL = 2e-4, 2e-5, 1e-5


def _plane_bytes(node) -> int:
    """Bytes of this process's residue planes (scales not counted)."""
    if hasattr(node, "planes") and hasattr(node, "mset"):
        return node.planes.numel() * node.planes.element_size()
    if isinstance(node, dict):
        return sum(_plane_bytes(v) for v in node.values())
    if isinstance(node, list):
        return sum(_plane_bytes(v) for v in node)
    return 0


def check_sd_launches(kept, counts, label):
    """Hold every recorded B6 / B7 launch against the plain version on its
    own inputs, digit for digit on the first SD_COLS columns (the plain
    version materializes the partial products)."""
    from repro_torch.kernels.sdrns_matmul import sdrns_matmul_ref

    for name, rec in kept.items():
        if len(rec) != counts[name]:
            raise AssertionError(f"{label}: recorded {len(rec)} {name} "
                                 f"launches of {counts[name]}")
        for (a, b, ws), out in rec:
            if not out[:, :, :SD_COLS].equal(
                    sdrns_matmul_ref(a, b[:, :, :SD_COLS], ws)):
                raise AssertionError(f"{label}: a {name} launch "
                                     f"({tuple(a.shape)} x "
                                     f"{tuple(b.shape)}) differs from the "
                                     f"plain version")
    shapes = {name: sorted({tuple(a.shape[:2]) for (a, _, _), _ in rec})
              for name, rec in kept.items()}
    print(f"[{label}] rank 0's {len(kept['sdrns_matmul'])} B6 and "
          f"{len(kept['sdrns_matvec'])} B7 launches (channels x rows "
          f"{shapes}) equal the plain version on their own inputs digit "
          f"for digit (first {SD_COLS} columns)", flush=True)


def _mesh_serve(torch, system, mset_name, layers, B, plen, max_new,
                stagger=None, fault=None, rank=0, hold=False):
    """Serve qwen3-8b (full width, ``layers`` deep, weights from SEED) on
    the dense cache under whatever shard context is installed; returns the
    outputs, this process's launch counts, plane bytes and collective
    bytes a decode step, and with ``hold`` the first decode step's B1 and
    B5 launches (rns) or every B6 / B7 launch (sdrns) held against the
    plain versions."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import moduli
    from repro_torch.models.api import build_model
    from repro_torch.numerics import api as nx
    from repro_torch.numerics import runners
    from repro_torch.parallel import collectives
    from repro_torch.serving.engine import ServingEngine

    cfg = dataclasses.replace(get_config("qwen3-8b"), n_layers=layers)
    mset = getattr(moduli, mset_name)
    kw = {"rns_mset": mset} if system == "rns" else {}
    model = build_model(cfg, system=system, device="cuda", **kw)
    t0 = time.perf_counter()
    if stagger is None:
        params = model.init(SEED)
    else:
        # the ranks make their weights one after another: each encodes the
        # whole weight before it keeps its block (13 GB of digit planes for
        # the tied logits weight under sdrns)
        params = stagger(lambda: model.init(SEED))
    engine = ServingEngine(model, params, batch=B, s_max=plen + max_new + 1,
                           paged=False, device="cuda")
    del params
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    fixed = None
    if fault is not None:
        t = engine.params["layers"][0]["attn"]["wq"]["w"]
        clean = t.planes.clone()
        if rank == 0:
            t.planes[fault] += 7
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (B, plen)).astype(np.int32)
    plan = runners.weight_plan
    tags = {}

    def tagged(*a, **k):
        p = plan(*a, **k)
        tags[p and p[0]] = tags.get(p and p[0], 0) + 1
        return p

    # the collectives' bytes when the first decode step starts: the rest
    # of the run is the decode steps
    at_decode = {}
    decode = model.decode

    def marking(*a, **k):
        if not at_decode:
            at_decode.update(collectives.moved_bytes(), marked=True)
        return decode(*a, **k)

    engine.model = dataclasses.replace(model, decode=marking)

    # bytes the plans gathered to build a kernel's planes block
    cut, plane_gathers = runners.plan_planes, [0]

    def cutting(t, shard):
        before = sum(collectives.moved_bytes().values())
        out = cut(t, shard)
        plane_gathers[0] += sum(collectives.moved_bytes().values()) - before
        return out

    runners.weight_plan, runners.plan_planes = tagged, cutting
    per_step = 7 * layers + 1
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def run():
        return engine.generate({"tokens": prompts}, max_new=max_new)

    try:
        kernels.reset_launch_counts()
        collectives.reset_moved_bytes()
        if hold and system == "rns":
            (res, first_b5), first_b1 = record_launches(
                "rns_matmul", per_step, lambda: record_first_decode(
                    layers, run), skip=per_step)
        elif hold:
            keep = lambda a, b, ws: (a.clone(), b, list(ws))  # noqa: E731
            (res, kept_b7), kept_b6 = record_launches(
                "sdrns_matmul", 1 << 20, lambda: record_launches(
                    "sdrns_matvec", 1 << 20, run, keep=keep), keep=keep)
        else:
            res = run()
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        moved = collectives.moved_bytes()
    finally:
        runners.weight_plan, runners.plan_planes = plan, cut
        engine.model = model
    peak = torch.cuda.max_memory_allocated()
    steps = max_new - 1
    if not at_decode.pop("marked", False):
        raise AssertionError("mesh: the engine ran no decode step")
    step_bytes = {k: (v - at_decode.get(k, 0)) / steps
                  for k, v in moved.items()}
    if hold and system == "rns":
        check_first_b1(first_b1, per_step, B, "mesh")
        check_first_decode(first_b5, layers, plen + 1, "mesh")
    elif hold:
        check_sd_launches({"sdrns_matmul": kept_b6,
                           "sdrns_matvec": kept_b7}, counts, "mesh")
    if fault is not None:
        fixed_t, det, cor = nx.scrub(t)
        fixed = dict(detected=det, corrected=cor,
                     repaired=bool(fixed_t.planes.equal(clean)))
    return dict(logits=res.prefill_logits, tokens=res.tokens,
                counts={k: counts[k] for k in MESH_KERNELS},
                plane_bytes=_plane_bytes(engine.params), init_s=t_init,
                moved=moved, step_bytes=step_bytes,
                plane_gathers=plane_gathers[0],
                prefill_s=res.stats.prefill_s,
                step_ms=1e3 * res.stats.decode_s / steps, peak=peak,
                tags=tags, scrub=fixed,
                fallback_gathers=engine.stats.fallback_gathers)


def _tree_err(torch, got, want):
    """The worst ``|got - want| / (MESH_ATOL + MESH_RTOL |want|)`` over
    two trees of one structure (<= 1: within the CPU tests' limits) and the
    count of elements past 1."""
    from repro_torch.train.tree import tree_leaves

    worst, bad = 0.0, 0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        r = ((a.float() - b.float()).abs()
             / (MESH_ATOL + MESH_RTOL * b.float().abs()))
        worst = max(worst, float(r.max()))
        bad += int((r > 1).sum())
    return worst, bad


def _logits_digest(torch, logits):
    """An exact position-weighted checksum of a logits tensor's bits."""
    bits = logits.contiguous().view(-1).view(torch.int32).to(torch.int64)
    w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
    return int((bits * w).sum())


def _mesh_train(torch, ctx, rank):
    """One rank of [mesh]'s train case on ``ctx``'s mesh: weights made
    from SEED, placed on this rank's blocks; MESH_TRAIN_STEPS sharded
    steps (the launches counted, rank 0's first step's B1 launches held
    against the plain version).  Rank 0 also runs the one-process steps
    on the same card: step 0 from the same weights (the loss, the gradient
    norm, its block of the gradients and of the state after it compared),
    the one-process run continued (its loss printed beside the sharded
    one), and, from the sharded parameters after step 0 gathered whole,
    step 1's loss and gradients (the loss, the gradient norm and its block
    of the gradients compared: the same inputs).  The forward's logits on this rank's rows
    of batch 0 are compared with one process's bit for bit on a mesh with
    no data axis."""
    import dataclasses as dc

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models import transformer
    from repro_torch.models.api import build_model
    from repro_torch.parallel import collectives
    from repro_torch.parallel.sharding import relayout, shard_ctx
    from repro_torch.train import loop
    from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                             global_norm, init_opt_state)
    from repro_torch.train.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config("qwen3-8b"),
                              n_layers=MESH_TRAIN_LAYERS,
                              compute_dtype="float32")
    n = MESH_TRAIN_MICRO
    model = build_model(cfg, system="rns", device="cuda")
    ocfg = OptConfig(**MESH_TRAIN_OPT, moment_dtype=cfg.opt_state_dtype)
    pipe = TokenPipeline(cfg.vocab, MESH_TRAIN_S, MESH_TRAIN_B, seed=SEED)
    batches = [pipe.batch_at(i) for i in range(MESH_TRAIN_STEPS)]
    kw = {"system": "rns", "compute_dtype": torch.float32}
    rows = loop.local_rows({"tokens": torch.as_tensor(
        batches[0]["tokens"], device="cuda")}, n, ctx)["tokens"].long()
    params = model.init(SEED, prepare=False)
    state = {"params": params, "opt_state": init_opt_state(params, ocfg)}
    sh = loop.TrainSharding.of(params, ctx)
    blocks = sh.place_state(state)
    rec = dict(losses=[], grad_norms=[], counts=[], moved=[], step_s=[],
               held_bytes=sum(x.numel() * x.element_size()
                              for x in tree_leaves(blocks["params"])),
               moment_bytes=sum(x.numel() * x.element_size() for x in (
                   tree_leaves(blocks["opt_state"]["m"])
                   + tree_leaves(blocks["opt_state"]["v"]))),
               whole_bytes=sum(x.numel() * x.element_size()
                               for x in tree_leaves(params)))
    step_one = loop.make_train_step(model, ocfg, n)
    if rank == 0:
        # the one-process steps on the same card, kept as rank 0's blocks
        with torch.no_grad():
            one_logits = transformer.lm_forward(params, cfg, rows,
                                                dense_kw=kw)[0]
        rec["one_digest"] = _logits_digest(torch, one_logits)
        del one_logits
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        (loss, _), g = loop.make_grad_fn(model, n)(params, batches[0])
        p1, st1, met = adamw_update(params, g, state["opt_state"], ocfg)
        torch.cuda.synchronize()
        rec["one_s"] = time.perf_counter() - t0
        rec["one_counts"] = kernels.launch_counts()["rns_matmul"]
        rec["one_loss"], rec["one_gn"] = float(loss), float(met["grad_norm"])
        one_g, one_1 = sh.place(g), sh.place_state(
            {"params": p1, "opt_state": st1})
        del g, state, params
        _, _, met = step_one(p1, st1, batches[1])
        rec["one_cont_loss"] = float(met["loss"])
        rec["one_cont_gn"] = float(met["grad_norm"])
        del p1, st1, met
    else:
        del state, params
    torch.cuda.empty_cache()
    p, st = blocks["params"], blocks["opt_state"]
    del blocks
    with torch.no_grad(), shard_ctx(dc.replace(ctx, rows_local=True)):
        logits = transformer.lm_forward(loop.forward_tree(p, sh.specs, ctx),
                                        cfg, rows, dense_kw=kw)[0]
    rec["digest"] = _logits_digest(torch, logits)
    del logits
    torch.cuda.reset_peak_memory_stats()
    grads_fn = loop.make_grad_fn(model, n, sh)
    for i, batch in enumerate(batches):
        kernels.reset_launch_counts()
        collectives.reset_moved_bytes()
        torch.cuda.synchronize()
        t0 = time.perf_counter()

        def run():
            (loss, _), g = grads_fn(p, batch)
            return loss, g, adamw_update(p, g, st, ocfg, sharding=sh)

        if i == 0 and rank == 0:
            (loss, g, (p_next, st_next, met)), rec["held"] = hold_launches(
                held_checks("rns_matmul"), run)
        else:
            loss, g, (p_next, st_next, met) = run()
        torch.cuda.synchronize()
        rec["step_s"].append(time.perf_counter() - t0)
        rec["counts"].append(kernels.launch_counts()["rns_matmul"])
        rec["moved"].append(collectives.moved_bytes())
        rec["losses"].append(float(loss))
        rec["grad_norms"].append(float(met["grad_norm"]))
        if i == 0 and rank == 0:
            rec["err_grads"] = _tree_err(torch, g, one_g)
            rec["err_state"] = _tree_err(torch, {"p": p_next, **st_next},
                                         {"p": one_1["params"],
                                          **one_1["opt_state"]})
            del one_g, one_1
        if i == 1:
            p1, g1 = p, g           # step 1's parameters and gradients
        del g
        p, st = p_next, st_next
    rec["peak"] = torch.cuda.max_memory_allocated()
    # step 1 in one process from the sharded parameters it started from,
    # gathered whole on rank 0 (a leaf at a time on the others)
    t0 = time.perf_counter()

    def gathered(x, spec):
        w = relayout(x, ctx.mesh, spec, (None,) * x.dim())
        return w if rank == 0 else None

    whole = tree_map(gathered, p1, sh.specs)
    del p1
    torch.cuda.synchronize()
    rec["gather_s"] = time.perf_counter() - t0
    if rank == 0:
        (loss, _), g = loop.make_grad_fn(model, n)(whole, batches[1])
        del whole
        rec["one_step1_loss"] = float(loss)
        rec["one_step1_gn"] = float(global_norm(g))
        rec["err_step1"] = _tree_err(torch, g1, sh.place(g))
        del g
    del g1, p, st, model
    return rec


def _check_mesh_train(label, shape, ranks, smi):
    """The gates of a [mesh] train case (``_mesh_train``): every rank's
    losses and gradient norms equal rank 0's (the global batch's); step 0
    against one process from the same weights and step 1 against one
    process from the same sharded state: the loss and the gradient norm
    within MESH_LOSS_RTOL, rank 0's blocks of the gradients (and of the
    state after step 0) within rtol MESH_RTOL / atol MESH_ATOL; every
    rank's B1 launches a step equal to one process's; rank 0's first-step
    B1 launches held; with no data axis, the forward's logits bit for
    bit on every rank.  Prints the bytes a rank, the collective bytes and
    seconds a step, and the continued one-process run's losses beside the
    sharded run's (not gated: the int4 codes of a forward are a
    discontinuous function of the weights, which the two runs hold
    rounded apart after a step)."""
    n = shape[0] * shape[1]
    rs = [ranks[r][label] for r in range(n)]
    r0 = rs[0]
    fails = []

    def rel(a, b):
        return abs(a - b) / abs(b)

    for r, got in enumerate(rs):
        if got["losses"] != r0["losses"] or \
                got["grad_norms"] != r0["grad_norms"]:
            fails.append(f"rank {r}'s losses or gradient norms differ from "
                         f"rank 0's")
        if any(c != r0["one_counts"] for c in got["counts"]):
            fails.append(f"rank {r}: B1 launches {got['counts']}, one "
                         f"process {r0['one_counts']} a step")
        if shape[0] == 1 and got["digest"] != r0["one_digest"]:
            fails.append(f"rank {r}: the forward's logits differ from one "
                         f"process's")
    checks = {
        "step 0 loss": rel(r0["losses"][0], r0["one_loss"]),
        "step 0 grad_norm": rel(r0["grad_norms"][0], r0["one_gn"]),
        "step 1 loss": rel(r0["losses"][1], r0["one_step1_loss"]),
        "step 1 grad_norm": rel(r0["grad_norms"][1], r0["one_step1_gn"])}
    for what, err in checks.items():
        if not err <= MESH_LOSS_RTOL:
            fails.append(f"{what} off by {err:.3e} relative")
    for what in ("err_grads", "err_state", "err_step1"):
        if r0[what][0] > 1:
            fails.append(f"{what}: {r0[what][1]} elements past the limits "
                         f"(worst {r0[what][0]:.3f})")
    print(f"[mesh] ({label}) train: qwen3-8b L={MESH_TRAIN_LAYERS} full "
          f"width, rns, f32 activations, mesh=({shape[0]},{shape[1]}) "
          f"seq_shard, batch {MESH_TRAIN_B} x {MESH_TRAIN_S} in "
          f"{MESH_TRAIN_MICRO} micro-batches, {MESH_TRAIN_STEPS} AdamW "
          f"steps: losses {r0['losses']}, grad_norm {r0['grad_norms']}; one "
          f"process on the same inputs: step 0 {r0['one_loss']} / "
          f"{r0['one_gn']}, step 1 from the gathered sharded parameters "
          f"{r0['one_step1_loss']} / {r0['one_step1_gn']} (relative "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in checks.items()})});"
          f" rank 0's blocks, worst |d| / (atol + rtol |ref|) and elements "
          f"past 1: gradients {r0['err_grads']}, state after step 0 "
          f"{r0['err_state']}, gradients of step 1 {r0['err_step1']}; the "
          f"one-process run continued: step 1 loss {r0['one_cont_loss']} "
          f"grad_norm {r0['one_cont_gn']} (not gated); parameter bytes a "
          f"rank {[g['held_bytes'] for g in rs]}, moment bytes "
          f"{[g['moment_bytes'] for g in rs]}, of {r0['whole_bytes']} "
          f"parameter bytes whole; collective payload bytes a step (rank "
          f"0) {json.dumps(r0['moved'])}; step_s a rank "
          f"{[[round(t, 3) for t in g['step_s']] for g in rs]} (one process "
          f"{r0['one_s']:.3f} for step 0, on the card beside the ranks); "
          f"parameters gathered whole in {r0['gather_s']:.1f}s; peak a rank "
          f"{[g['peak'] for g in rs]}; B1 launches a step {r0['counts']}"
          + ("; forward logits bit for bit on every rank" if shape[0] == 1
             else "") + f"; {smi}", flush=True)
    check_held(r0["held"], {"rns_matmul": r0["one_counts"]},
               f"mesh ({label})", "rank 0's first train step")
    if fails:
        raise AssertionError(f"mesh ({label}) train: " + "; ".join(fails))
    return dict(ranks=n, layout=f"train ({shape[0]},{shape[1]}) seq_shard",
                system="rns", losses=r0["losses"],
                grad_norms=r0["grad_norms"],
                one_losses=[r0["one_loss"], r0["one_step1_loss"]],
                one_continued_loss=r0["one_cont_loss"],
                held_bytes=[g["held_bytes"] for g in rs],
                moment_bytes=[g["moment_bytes"] for g in rs],
                whole_bytes=r0["whole_bytes"], step_s=r0["step_s"],
                one_step_s=r0["one_s"], step_bytes=r0["moved"],
                peak=r0["peak"], counts=dict(NO_LAUNCHES,
                                             rns_matmul=r0["counts"][0]),
                errors={k: r0[k] for k in ("err_grads", "err_state",
                                           "err_step1")})


def _mesh_rank(rank, world, init, out_dir):
    """One rank of [mesh]: every case on its own sub-mesh of the first n
    ranks (the others wait), results saved for the parent."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import build
    from repro_torch.launch.mesh import (init_process_group, make_ctx,
                                         make_test_mesh)
    from repro_torch.parallel.sharding import shard_ctx

    build.library()            # built by the parent: loaded, not rebuilt
    # five ranks share the host's cores, and a rank's host work is launches
    # and host copies: one intra-op thread a rank
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = init_process_group(backend="gloo",
                                 init_method=f"file://{init}", rank=rank,
                                 world_size=world)
    out = {"backend": backend}
    try:
        for label, n, layout, system, mset, layers, B, plen, new in \
                MESH_CASES:
            mesh = make_test_mesh((1, n), ranks=range(n))
            if rank < n:
                ctx = make_ctx(mesh, channel_shard=layout == "chan")
                group = mesh.get_group("model")

                def stagger(make):
                    made = None
                    for r in range(n):
                        if r == rank:
                            made = make()
                            torch.cuda.synchronize()
                        dist.barrier(group=group)
                    return made

                with shard_ctx(ctx):
                    out[label] = _mesh_serve(
                        torch, system, mset, layers, B, plen, new,
                        stagger=stagger if system == "sdrns" else None,
                        fault=MESH_FAULT if mset == "P21R2" else None,
                        rank=rank, hold=rank == 0)
            gc.collect()
            torch.cuda.empty_cache()
            dist.barrier()
        for label, shape in MESH_TRAIN:
            mesh = make_test_mesh(shape, ranks=range(shape[0] * shape[1]))
            if rank < shape[0] * shape[1]:
                out[label] = _mesh_train(
                    torch, make_ctx(mesh, seq_shard=True), rank)
            gc.collect()
            torch.cuda.empty_cache()
            dist.barrier()
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def serve_mesh(torch, smi):
    """Phase 17: full-width qwen3-8b served across ranks that share the
    card (``torch.multiprocessing``, start method ``spawn``, a ``gloo``
    group through a ``file://`` init), beside the same model served in this
    process with no shard context.  (a) the column plan on (1, 2) (its
    row-parallel weights on the row plan), (b) the channel plan on (1, 3),
    (c) P21R2's channel plan on (1, 5) with an information channel's plane
    corrupted on rank 0, (d) sdrns on (1, 3) beside its rns twin.  Gates:
    prefill logits and tokens bit for bit against the single-process run
    on every rank; each rank's launches equal to the single-process counts,
    its plane bytes 1 / n of the whole and no plane block gathered; rank
    0's first decode step's B1 and B5 launches (rns) or every B6 and B7
    launch (sdrns) held against the plain versions; (c) the fault repaired
    in the output and found and repaired by ``nx.scrub``; (d) equal to its
    rns twin.  Then the train cases (MESH_TRAIN) in the same ranks, rank 0
    running the one-process steps they are held against
    (``_mesh_train``, ``_check_mesh_train``)."""
    import shutil
    import tempfile

    import numpy as np
    import torch.multiprocessing as mp

    base = {}
    for label, n, layout, system, mset, layers, B, plen, new in MESH_CASES:
        keys = [(system, mset, layers, B, plen, new)]
        if system == "sdrns":
            keys.append(("rns", mset, layers, B, plen, new))
        for key in keys:
            if key not in base:
                base[key] = _mesh_serve(torch, *key)
                gc.collect()
                torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="mesh_")
    t0 = time.perf_counter()
    try:
        pc = mp.start_processes(
            _mesh_rank, args=(MESH_WORLD, os.path.join(tmp, "init"), tmp),
            nprocs=MESH_WORLD, join=False, start_method="spawn")
        try:
            while not pc.join(timeout=5):
                pass
        finally:
            for p in pc.processes:
                if p.is_alive():
                    p.kill()
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(MESH_WORLD)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t_ranks = time.perf_counter() - t0
    staged = ("every collective's CUDA tensors staged through host memory "
              "(parallel/collectives.py)" if ranks[0]["backend"] == "gloo"
              else "no staging")
    print(f"[mesh] {MESH_WORLD} ranks on one card, backend "
          f"{ranks[0]['backend']} ({staged}); ranks ran {t_ranks:.1f}s; "
          f"no collective time is reported (gloo through the host says "
          f"nothing about NCCL); {smi}", flush=True)
    out = {}
    for label, n, layout, system, mset, layers, B, plen, new in MESH_CASES:
        one = base[(system, mset, layers, B, plen, new)]
        r0 = ranks[0][label]
        tags = {str(k): v for k, v in r0["tags"].items()}
        print(f"[mesh] ({label}) ranks={n} mesh=(1,{n}) layout={layout} "
              f"system={system} {mset} L={layers} B={B} prompt={plen} "
              f"new={new}: plan tags {tags}; launches a rank "
              f"{json.dumps(r0['counts'])} (one process: "
              f"{json.dumps(one['counts'])}); plane bytes a rank "
              f"{r0['plane_bytes']} of {one['plane_bytes']}; init_s="
              f"{r0['init_s']:.2f} prefill_s={r0['prefill_s']:.3f} "
              f"step_ms={r0['step_ms']:.1f} (one process: prefill_s="
              f"{one['prefill_s']:.3f} step_ms={one['step_ms']:.1f}); "
              f"peak a rank {r0['peak']}; collective bytes a rank a decode "
              f"step {json.dumps(r0['step_bytes'])}, in the whole run "
              f"{json.dumps(r0['moved'])}, of which plane blocks gathered "
              f"{r0['plane_gathers']}; {smi}", flush=True)
        for r in range(n):
            got = ranks[r][label]
            if not (np.array_equal(got["logits"], one["logits"])
                    and np.array_equal(got["tokens"], one["tokens"])):
                raise AssertionError(f"mesh ({label}) rank {r}: prefill "
                                     f"logits or tokens differ from the "
                                     f"single-process run")
            # B9 decodes each B1 product on P21: the single process's, and
            # the column and row plans'; the channel plan folds CRT
            # partials instead, and P21R2's decode checks its witnesses
            on_p21 = system == "rns" and mset == "P21"
            b9 = got["counts"]["rns_matmul"] if on_p21 and layout == "col" \
                else 0
            b9_one = one["counts"]["rns_matmul"] if on_p21 else 0
            if dict(got["counts"], rns_decode=b9_one) != one["counts"] \
                    or got["counts"]["rns_decode"] != b9:
                raise AssertionError(f"mesh ({label}) rank {r}: launches "
                                     f"{got['counts']}, the single process "
                                     f"{one['counts']}; B9 expected {b9}, "
                                     f"{b9_one} in the single process")
            if got["plane_bytes"] * n != one["plane_bytes"]:
                raise AssertionError(f"mesh ({label}) rank {r}: "
                                     f"{got['plane_bytes']} plane bytes, "
                                     f"not 1/{n} of {one['plane_bytes']}")
            plans = {"col", "row"} if layout == "col" else {layout}
            if set(got["tags"]) != plans or got["fallback_gathers"]:
                raise AssertionError(f"mesh ({label}) rank {r}: plans "
                                     f"{got['tags']}, fallbacks "
                                     f"{got['fallback_gathers']}")
            if got["plane_gathers"]:
                raise AssertionError(f"mesh ({label}) rank {r}: the plans "
                                     f"gathered {got['plane_gathers']} bytes "
                                     f"of planes")
        need = ("sdrns_matmul", "sdrns_matvec") if system == "sdrns" \
            else ("rns_matmul",)
        if any(r0["counts"][k] == 0 for k in need + ("flash_attention",
                                                     "flash_decode")):
            raise AssertionError(f"mesh ({label}): a kernel of the path was "
                                 f"not launched: {r0['counts']}")
        print(f"[mesh] ({label}) all {n} ranks: prefill logits and "
              f"{r0['tokens'].size} tokens bit-identical to the single "
              f"process, launches equal, plane bytes 1/{n}, no plane "
              f"gathered", flush=True)
        if mset == "P21R2":
            for r in range(n):
                sc = ranks[r][label]["scrub"]
                if not (sc["detected"] >= 1 and sc["corrected"] >= 1
                        and sc["repaired"]):
                    raise AssertionError(f"mesh ({label}) rank {r}: scrub "
                                         f"{sc}")
            print(f"[mesh] ({label}) info channel 0 of layer 0's wq "
                  f"corrupted at {MESH_FAULT} on rank 0: the outputs equal "
                  f"the fault-free run through the witnesses held by ranks "
                  f"3 and 4; nx.scrub detected {r0['scrub']['detected']}, "
                  f"corrected {r0['scrub']['corrected']}, planes repaired "
                  f"on every rank", flush=True)
        if system == "sdrns":
            twin = base[("rns", mset, layers, B, plen, new)]
            if not (np.array_equal(r0["logits"], twin["logits"])
                    and np.array_equal(r0["tokens"], twin["tokens"])):
                raise AssertionError(f"mesh ({label}): sdrns differs from "
                                     f"its rns twin")
            print(f"[mesh] ({label}) equal to the rns twin bit for bit",
                  flush=True)
        out[label] = dict(ranks=n, layout=layout, system=system, mset=mset,
                          counts=r0["counts"], plane_bytes=r0["plane_bytes"],
                          prefill_s=r0["prefill_s"], step_ms=r0["step_ms"],
                          peak=r0["peak"], step_bytes=r0["step_bytes"])
    for label, shape in MESH_TRAIN:
        out[label] = _check_mesh_train(label, shape, ranks, smi)
    return out


def main() -> int:
    # [serve-moe] makes and encodes 38 layers of 2.2 GB f32 expert stacks one
    # after another beside their planes: fixed-size segments fragment (out
    # of memory on an H100 80GB with 26.7 GB reserved but free)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
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
    for source in ("rns_matmul.cu", "flash_attn.cu", "sdrns_matmul.cu",
                   "rns_decode.cu"):
        for line in ptxas_lines(build.log_path(), source):
            print(f"[build] ptxas {line}", flush=True)
    smi = nvidia_smi()
    print(f"[build] {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def phase(label, fn, *args):
        """Run one phase, print its command time, free what it left."""
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        print(f"[time] {label}: {time.perf_counter() - t:.1f}s", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        return out

    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    from repro_torch.core.moduli import P21, P21R2
    t_kernels = time.perf_counter()
    rm = check_rns_matmul(torch, timer, gen, P21, "P21", QWEN3_STEP)
    rm_r = check_rns_matmul(torch, timer, gen, P21R2, "P21R2", QWEN3_STEP)
    rm_h = check_rns_matmul(torch, timer, gen, P21, "zamba2", HYBRID_MATMULS)
    fa_rows = check_flash_attention(torch, timer, gen)
    fa = dict(fa_rows.pop("qwen3"), **fa_rows)
    pd = check_paged_decode(torch, timer, gen)
    ps = check_paged_decode_syndrome(torch, timer, gen)
    fd_rows = check_flash_decode(torch, timer, gen)
    fd = dict(fd_rows.pop("serve_dense"), **fd_rows)
    sdm, sdv = check_sdrns_matmul(torch, timer, gen)
    sda = check_sd_add(torch, timer)
    rm_s = check_rns_matmul_spec(torch, timer, gen)
    pv = check_paged_verify(torch, timer, gen)
    # the new slices' shapes draw from their own generators, so that the
    # checks above draw what they drew before these were added
    rm_moe = check_rns_matmul_moe(
        torch, timer, torch.Generator(device="cuda").manual_seed(SEED + 2))
    pd_g = check_paged_decode(
        torch, timer, torch.Generator(device="cuda").manual_seed(SEED + 3),
        H=48, Kv=1, names=("rns8",), tag=",granite")
    # the vlm and audio serves' shapes: B2 non-causal (whisper's encoder and
    # cross-attention) and at hd 64, at pixtral's prefill; B5 at whisper's
    # self cache and cross memory; B1 at both models' shapes
    fa_new = check_flash_attention(
        torch, timer, torch.Generator(device="cuda").manual_seed(SEED + 4),
        cases=[("whisper_enc", SERVE_B, AUDIO_FRAMES, AUDIO_FRAMES, 12, 12,
                64, False, False),
               ("whisper_cross", SERVE_B, AUDIO_PROMPT, AUDIO_FRAMES, 12, 12,
                64, False, False),
               ("whisper_self", SERVE_B, AUDIO_PROMPT, AUDIO_PROMPT, 12, 12,
                64, True, False),
               ("pixtral", SERVE_B, 1024 + VLM_TEXT, 1024 + VLM_TEXT, 32, 8,
                128, True, False)])
    fd_new = check_flash_decode(
        torch, timer, torch.Generator(device="cuda").manual_seed(SEED + 5),
        cases=[("whisper_self", 12, 12, 64, 448, torch.bfloat16,
                AUDIO_PROMPT + 1, None),
               ("whisper_cross", 12, 12, 64, AUDIO_FRAMES, torch.bfloat16,
                AUDIO_FRAMES, None)])
    g6 = torch.Generator(device="cuda").manual_seed(SEED + 6)
    rm_w = check_rns_matmul(torch, timer, g6, P21, "whisper",
                            WHISPER_MATMULS, prefill_m=SERVE_B * AUDIO_FRAMES)
    rm_p = check_rns_matmul(torch, timer, g6, P21, "pixtral",
                            PIXTRAL_MATMULS,
                            prefill_m=SERVE_B * (1024 + VLM_TEXT))
    # B1 at the logits shape of a training micro-batch (M 2048); the layers'
    # M 2048 shapes are [serve]'s prefill shapes above
    m_train = TRAIN_BATCH // TRAIN_MICRO * TRAIN_SEQ
    rm_tl = b1_shape(torch, timer,
                     torch.Generator(device="cuda").manual_seed(SEED + 7),
                     P21, "train", m_train, *LOGITS)
    # [cnn]'s new shapes: B1 at conv1 / VGG conv2 / fc, B6 at VGG conv2
    cnn_b1, cnn_b6 = check_cnn_kernels(
        torch, timer, torch.Generator(device="cuda").manual_seed(SEED + 8))
    # B9, the reverse conversion after B1, on every set it takes
    b9 = check_rns_decode(
        torch, timer, torch.Generator(device="cuda").manual_seed(SEED + 9))
    # B2's (192, 128) instance, latent attention's widths
    fa_mla = check_flash_attention_mla(
        torch, timer, torch.Generator(device="cuda").manual_seed(SEED + 10))
    # B1 then B9 at latent attention's, layer 0's and the shared experts'
    # products and at the untied head (Moonlight-16B-A3B)
    rr_mla = check_rns_run_mla(
        torch, timer, torch.Generator(device="cuda").manual_seed(SEED + 11))
    del timer
    torch.cuda.empty_cache()
    print(f"[time] kernels: {time.perf_counter() - t_kernels:.1f}s",
          flush=True)
    phase("small", check_small, torch)
    phase("small-hybrid", check_small_hybrid, torch)
    counts, ctx = phase("serve", serve_full_width, torch)
    spec = phase("serve-spec", serve_spec, torch, *ctx)
    sched = phase("serve-sched", serve_sched, torch, *ctx[:2])
    counts_dense = phase("serve-dense", serve_dense, torch, *ctx[:2])
    roof = phase("roofline", roofline, torch, smi, *ctx[:2])
    del ctx
    gc.collect()
    torch.cuda.empty_cache()
    counts_r = phase("serve-r + faults", serve_redundant, torch)
    counts_sd = phase("serve-sd", serve_sd, torch, smi)
    counts_hy = phase("serve-hybrid", serve_hybrid, torch, smi)
    counts_cfg = phase("serve-configs", serve_configs, torch, smi)
    counts_ssm = phase("serve-ssm", serve_ssm, torch, smi)
    counts_moe = phase("serve-moe", serve_moe, torch, smi)
    mla = phase("serve-mla", serve_mla, torch, smi)
    counts_vlm = phase("serve-vlm", serve_vlm, torch, smi)
    counts_audio = phase("serve-audio", serve_audio, torch, smi)
    train = phase("train", train_full_width, torch)
    phase("train-small", train_small, torch)
    cnn = phase("cnn", cnn_eval, torch, smi)
    mesh = phase("mesh", serve_mesh, torch, smi)

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
        ("flash_decode", src_dir + "flash_attn.cu",
         "src/repro/kernels/flash_attn.py:228", fd),
        ("sdrns_matmul", src_dir + "sdrns_matmul.cu",
         "src/repro/kernels/sdrns_matmul.py:109", sdm),
        ("sdrns_matvec", src_dir + "sdrns_matmul.cu",
         "src/repro/kernels/sdrns_matmul.py:154", sdv),
        ("sd_add", src_dir + "sd_add.cu", "src/repro/kernels/sd_add.py:68",
         sda),
    ]
    # launches: B1-B3 from [serve], the syndrome mode from [serve-r], B5
    # from [serve-dense], B6 and B7 from [serve-sd], B8 from nx.add (the
    # path each is measured on); the other serves' counts are beside them
    launched = dict(counts, paged_decode_syndrome=counts_r[
        "paged_decode_syndrome"], flash_decode=counts_dense["flash_decode"],
        sdrns_matmul=counts_sd["sdrns_matmul"],
        sdrns_matvec=counts_sd["sdrns_matvec"], sd_add=sda["launches"])
    fixed = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "at")
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": rep,
         "launches": launched[name], "launches_serve_r": counts_r[name],
         "launches_serve_sd": counts_sd[name],
         "launches_serve_dense": counts_dense[name],
         "launches_serve_hybrid": counts_hy[name],
         "launches_serve_configs": {a: c[name] for a, c in counts_cfg.items()},
         "launches_serve_ssm": counts_ssm[name],
         "launches_serve_moe": counts_moe[name],
         "launches_serve_sched": sched["counts"][name],
         "launches_serve_vlm": counts_vlm[name],
         "launches_serve_audio": counts_audio[name],
         "launches_train": train["rns"]["counts"][name],
         "launches_cnn": cnn["counts"][name],
         **{k: r[k] for k in fixed},
         **{k: v for k, v in r.items() if k not in fixed + ("launches",)}}
        for name, source, rep, r in entries]}
    # B1 on the P21R2 planes of [serve-r] (C = 5), held and timed as above
    line["kernels"][0]["p21r2"] = dict(
        {k: rm_r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms", "library_at",
                              "yardstick_bf16_bmm_ms", "at", "shapes")},
        launches=counts_r["rns_matmul"])
    # B1 at zamba2-7b's shapes, one decode step of [serve-hybrid]
    line["kernels"][0]["zamba2"] = dict(rm_h,
                                        launches=counts_hy["rns_matmul"])
    # [serve-spec]: B1 at the verify's M 40 and on the draft's P16 planes,
    # B3 at the folded verify shape, with the launches of each drafter's run
    line["kernels"][0]["spec"] = dict(
        rm_s, launches={k: v["counts"]["rns_matmul"] for k, v in spec.items()})
    line["kernels"][2]["spec"] = dict(
        pv, launches={k: v["counts"]["paged_decode"] for k, v in spec.items()})
    # B1 in stack mode at moonshot's expert einsums (decode and prefill
    # capacity; Moonlight's admissions beside them), with [serve-moe]'s
    # launches; B3 at granite-20b's heads
    line["kernels"][0]["moe"] = dict(rm_moe,
                                     launches=counts_moe["rns_matmul"])
    line["kernels"][2]["granite"] = dict(
        pd_g["rns8"], launches=counts_cfg["granite-20b"]["paged_decode"])
    # the vlm and audio serves' shapes, with their serves' launches (B1 at
    # whisper's logits shape has none: the logits are a float product)
    line["kernels"][0]["whisper"] = dict(
        rm_w, launches=counts_audio["rns_matmul"])
    line["kernels"][0]["pixtral"] = dict(
        rm_p, launches=counts_vlm["rns_matmul"])
    for key, serve in (("whisper_enc", "audio"), ("whisper_cross", "audio"),
                       ("whisper_self", "audio"), ("pixtral", "vlm")):
        line["kernels"][1][key] = dict(fa_new[key], launches=(
            counts_audio if serve == "audio" else counts_vlm
        )["flash_attention"])
    for key in ("whisper_self", "whisper_cross"):
        line["kernels"][4][key] = dict(
            fd_new[key], launches=counts_audio["flash_decode"])
    # [train]: one rns step's B1 launches at M 2048 (each layer shape 2 x L
    # x n_micro times, the logits n_micro times): the L2-flushed per-shape
    # times of [kernels] summed over them, and the launches' device time
    # measured inside the steps
    L, n = TRAIN_LAYERS, TRAIN_MICRO
    step_shapes = [(rm["shapes"][f"{m_train},{K},{N}"], c * 2 * L * n)
                   for (K, N), c in LAYER_MATMULS] + [(rm_tl, n)]
    line["kernels"][0]["train"] = dict(
        {k: sum(r[k] * c for r, c in step_shapes)
         for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
        bound_by="operations",
        ms_in_step=train["rns"]["b1_ms"],
        max_abs_err=rm_tl["err"],
        launches=train["rns"]["counts"]["rns_matmul"],
        at=f"one [train] step: {sum(c for _, c in step_shapes)} launches "
           f"at M={m_train}; ms, plain_ms, library_ms and bound_ms sum the "
           f"per-shape medians (L2 flushed), ms_in_step is their device "
           f"time inside the timed steps",
        step_s={k: v["step_s"] for k, v in train.items()},
        encode_ms=train["rns"]["encode_ms"])
    # [cnn]: B1 at the CNN's new shapes, B6 at VGG-16's conv2, and each
    # kernel's device ms inside one forward of a batch of 64, by net
    def in_forward(name):
        return {k: dict(ms=v[name], bound_ms=cnn["bound_ms"][k][name],
                        **({"library_ms": cnn["library_ms"][k.split()[0]]}
                           if name == "rns_matmul" and k.endswith(" rns")
                           else {}))
                for k, v in cnn["kernel_ms"].items() if name in v}

    line["kernels"][0]["cnn"] = dict(
        shapes=cnn_b1, launches=cnn["counts"]["rns_matmul"],
        ms_in_forward=in_forward("rns_matmul"))
    line["kernels"][5]["cnn"] = dict(
        cnn_b6, launches=cnn["counts"]["sdrns_matmul"],
        ms_in_forward=in_forward("sdrns_matmul"))
    line["kernels"][6]["cnn"] = dict(
        launches=cnn["counts"]["sdrns_matvec"],
        ms_in_forward=in_forward("sdrns_matvec"))
    line["cnn"] = {k: v for k, v in cnn.items() if k not in (
        "counts", "kernel_ms", "bound_ms", "library_ms")}
    # [mesh]: each case's launches a rank (every rank's equal the single
    # process's) for B1, B5, B6 and B7
    for i in (0, 4, 5, 6):
        name = line["kernels"][i]["name"]
        line["kernels"][i]["mesh"] = {
            label: dict(ranks=v["ranks"], layout=v["layout"],
                        system=v["system"], launches=v["counts"][name])
            for label, v in mesh.items()}
    line["mesh"] = {label: {k: v[k] for k in v if k != "counts"}
                    for label, v in mesh.items()}
    # B2 at latent attention's widths, with [serve-mla]'s launches
    line["kernels"][1]["mla"] = dict(
        fa_mla, launches=mla["admission"]["flash_attention"]
        + mla["decode"]["flash_attention"])
    line["serve_mla"] = mla
    # B1 then B9 at Moonlight-16B-A3B's dense products, with [serve-mla]'s
    # launches (its expert stacks are under "moe")
    line["kernels"][0]["mla"] = dict(
        shapes=rr_mla, launches=mla["admission"]["rns_matmul"]
        + mla["decode"]["rns_matmul"])
    # [serve-sched]: the spec run's launches and the serve's end-to-end rates
    line["serve_sched"] = {k: v for k, v in sched.items() if k != "counts"}
    # [roofline]: the counted work of one prefill and one decode step of
    # [serve]'s model (card == meta), its terms and the measured steps
    line["roofline"] = roof
    # B9: the port's own kernel (no pallas_call), held and timed in
    # [kernels]; it follows B1's launches wherever rns_run decodes
    line["rns_decode"] = dict(
        b9, source=src_dir + "rns_decode.cu", replaces=None,
        launches=counts["rns_decode"], launches_serve_r=counts_r["rns_decode"],
        launches_serve_dense=counts_dense["rns_decode"],
        launches_serve_hybrid=counts_hy["rns_decode"],
        launches_serve_ssm=counts_ssm["rns_decode"],
        launches_serve_moe=counts_moe["rns_decode"],
        launches_serve_sched=sched["counts"]["rns_decode"],
        launches_train=train["rns"]["counts"]["rns_decode"],
        launches_cnn=cnn["counts"]["rns_decode"],
        mesh={label: v["counts"]["rns_decode"] for label, v in mesh.items()})
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
