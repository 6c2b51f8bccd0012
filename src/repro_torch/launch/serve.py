"""Serving entry point: batched prefill + decode on the card.

Example (one H100):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
      --system rns --kv-format rns8 --batch 8 --prompt-len 256 --max-new 64

The dense family (``qwen3-8b``, ``yi-6b``, ``phi3-medium-14b``,
``granite-20b``) and the moe family (``moonshot-v1-16b-a3b``,
``grok-1-314b``) decode over the paged KV pool in ``--kv-format``; the
hybrid family (``zamba2-7b``: Mamba2 layers and a shared attention block)
has no paged decode and serves from the dense bf16 cache, and the ssm
family (``mamba2-780m``) from its SSM state alone; ``--kv-format`` does not
apply to either.  Their prompts must be a multiple of the SSM chunk (256)
long, or shorter than one chunk.  At full width one card holds yi-6b,
phi3-medium-14b and mamba2-780m whole; granite-20b and moonshot need a
depth cut (``chip_smoke.py`` makes it through the Python API), grok-1-314b
runs reduced only.

``--system sdrns`` serves on P21 signed-digit weight planes, 21 B per
weight: at full width only a cut depth fits one card (``chip_smoke.py``
cuts qwen3-8b to 8 of 36 layers through the Python API).

The vlm family (``pixtral-12b``) takes ``n_img_tokens`` synthetic patch
embeddings before the ``--prompt-len`` text tokens, on the paged pool.  The
audio family (``whisper-small``, an encoder-decoder) takes ``--prompt-len``
synthetic frames for its encoder (1500: whisper's 30-second window after
its conv stack) and an 8-token decoder prompt, on the dense cache; its
decoder's 448 positions bound the prompt and ``--max-new``.  Frames and
patches are drawn from ``--seed`` (``models/frontends.py``).

``--spec ngram:4`` (or ``rns:4``) decodes speculatively: a drafter
proposes 4 tokens a slot and the target verifies them in one batched step
(paged serving and greedy sampling only; the tokens equal plain decoding),
and a summary line gives the verify steps and the acceptance.

``--no-prepare`` keeps the weights float and quantizes and converts each
at every matmul (the per-call path; the same tokens as the resident
default, a baseline for the conversion's cost).

Weights are random, made from ``--seed``.  ``--device cpu`` runs the plain
PyTorch versions of the kernels (use ``--reduced`` there).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, PORT_ARCH_IDS, get_config
from repro_torch.models import frontends
from repro_torch.models.api import build_model
from repro_torch.serving.engine import ServingEngine

DEC_PROMPT = 8     # the audio family's decoder prompt (the reference's)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True,
                    choices=ARCH_IDS + PORT_ARCH_IDS)
    ap.add_argument("--system", default="bns", choices=("bns", "rns", "sdrns"))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kv-format", default="bf16",
                    choices=("bf16", "rns8", "rns4"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-prepare", action="store_true",
                    help="keep weights float and convert them per call "
                         "(baseline for the residue-resident default)")
    ap.add_argument("--spec", default=None, metavar="DRAFTER[:K]",
                    help='speculative decoding drafter: "ngram[:k]" or '
                         '"rns[:k]" (greedy only; paged engines). Output '
                         "tokens equal plain decoding")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, system=args.system, device=args.device)
    params = model.init(args.seed, prepare=not args.no_prepare)
    B, P = args.batch, args.prompt_len
    s_max = P + args.max_new + 1
    if cfg.family == "vlm":
        s_max += cfg.n_img_tokens
    if cfg.is_encdec:
        s_max = P              # the encoder memory; the decoder has dec_len
    engine = ServingEngine(model, params, batch=B, s_max=s_max,
                           kv_format=args.kv_format, device=args.device,
                           spec=args.spec, prepare=not args.no_prepare)
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    if cfg.is_encdec:
        inputs = {"frames": frontends.synthetic_frames(gen, B, P, cfg),
                  "tokens": rng.integers(0, cfg.vocab, (B, DEC_PROMPT)
                                         ).astype(np.int32)}
        plen = DEC_PROMPT
    else:
        inputs = {"tokens": rng.integers(0, cfg.vocab, (B, P)
                                         ).astype(np.int32)}
        plen = P
        if cfg.family == "vlm":
            inputs["patches"] = frontends.synthetic_patches(gen, B, cfg)
            plen += cfg.n_img_tokens

    t0 = time.perf_counter()
    res = engine.generate(inputs, max_new=args.max_new,
                          temperature=args.temperature, generator=gen)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.perf_counter() - t0
    kv = args.kv_format if engine.paged else "dense"
    print(f"[serve] {args.arch} system={args.system} kv={kv} "
          f"device={model.device} B={B} prompt={plen} new={args.max_new}: "
          f"{dt:.2f}s ({B * args.max_new / dt:.1f} tok/s)")
    if engine.stats.spec is not None:
        sp = engine.stats.spec
        print(f"[serve] spec={args.spec}: {sp.verify_steps} verify steps "
              f"for {sp.emitted} tokens (accept={sp.acceptance_rate:.2f}, "
              f"mean block={sp.mean_accepted_len:.2f})")
    for b in range(min(B, 2)):
        print(f"  seq{b}: {res.tokens[b].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
