"""Batched LM serving demo on the PyTorch / CUDA port: prefill a request
batch, then decode.  The counterpart of ``examples/serve_lm.py``.

It runs the prefill and decode steps the serving cells run, on a reduced
config: on the card by default, or on the CPU (the kernels' plain
versions) with ``--device cpu``.  ``--system`` is the number system the
model computes in (bns / rns / sdrns); under rns / sdrns the weights are
residue-resident and every projection runs the residue matmul kernel.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py [--arch yi-6b]
          [--system rns] [--batch 4] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.api import build_model
from repro_torch.serving.engine import ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--system", default="bns",
                    choices=("bns", "rns", "sdrns"))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    model = build_model(cfg, system=args.system, device=args.device)
    params = model.init(0)
    engine = ServingEngine(model, params, batch=args.batch,
                           s_max=args.prompt_len + args.max_new + 1,
                           device=args.device)

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab,
                           (args.batch, args.prompt_len)).astype(np.int32)
    gen = torch.Generator(device=model.device).manual_seed(0)
    t0 = time.time()
    res = engine.generate({"tokens": prompts}, max_new=args.max_new,
                          temperature=args.temperature, generator=gen)
    dt = time.time() - t0
    n = res.tokens.size
    print(f"[serve_lm] {args.arch} (reduced) system={args.system} "
          f"B={args.batch}: {n} tokens in {dt:.2f}s ({n / dt:.1f} tok/s on "
          f"{model.device.type})")
    for b in range(args.batch):
        print(f"  request {b}: prompt[-4:]={prompts[b, -4:].tolist()} -> "
              f"generated {res.tokens[b, :12].tolist()}...")
    # consistency: greedy decoding is deterministic across calls
    res2 = engine.generate({"tokens": prompts}, max_new=4)
    res3 = engine.generate({"tokens": prompts}, max_new=4)
    same = bool(np.array_equal(res2.tokens, res3.tokens))
    print(f"[serve_lm] greedy decode deterministic across calls: {same}")
    if not same:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
