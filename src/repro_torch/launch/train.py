"""Training entry point: the fault-tolerant runner over the train step.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
      --reduced --system rns --device cpu --steps 20 --batch 8 --seq 64 \
      --ckpt-dir /tmp/train_qwen3
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
      --reduced --system rns --steps 200          # on the card

The data is the deterministic synthetic stream of ``data/tokens.py``
(learnable: the loss falls), the weights random from ``--seed``.  Every
``--ckpt-every`` steps and after the last the parameters and the AdamW
state are checkpointed into ``--ckpt-dir`` (default
``checkpoints/<arch>``, which holds a committed reduced qwen3-8b
checkpoint at step 2: a run there resumes from it); a run resumes from the
latest checkpoint it finds.  ``--failure-at N`` raises a simulated failure
before step N once; the run restarts from its checkpoint.  The vlm family
trains with zero patch embeddings before the text (their labels ignored).
The audio family is refused, as the reference's ``launch/train.py``
refuses it (``Model.loss`` takes it).  ``--device cpu`` runs the plain PyTorch
versions of the kernels (use ``--reduced`` there).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models.api import build_model
from repro_torch.train import checkpoint
from repro_torch.train.ft import FtConfig, run_training, run_with_restarts
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import OptConfig, init_opt_state

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--system", default="bns", choices=("bns", "rns", "sdrns"))
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--failure-at", type=int, default=None,
                    help="inject a simulated crash before this step")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family == "audio":
        raise SystemExit("launch/train.py trains the decoder-only "
                         "families; whisper's loss is Model.loss with "
                         "frames")
    model = build_model(cfg, system=args.system, device=args.device)
    opt_cfg = OptConfig(peak_lr=args.lr, warmup_steps=10,
                        total_steps=args.steps,
                        moment_dtype=cfg.opt_state_dtype)
    step_fn = make_train_step(model, opt_cfg, args.micro)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=args.seq,
                         global_batch=args.batch, seed=args.seed)

    def init_state():
        params = model.init(args.seed, prepare=False)
        return {"params": params,
                "opt_state": init_opt_state(params, opt_cfg)}

    def batch_at(step):
        b = pipe.batch_at(step)
        if cfg.family == "vlm":
            B, n_img = b["tokens"].shape[0], cfg.n_img_tokens
            return {"tokens": b["tokens"],
                    "patches": np.zeros((B, n_img, cfg.d_model), np.float32),
                    "labels": np.concatenate(
                        [np.full((B, n_img), -1, np.int32), b["labels"]],
                        axis=1)}
        return b

    ckpt_dir = args.ckpt_dir or f"checkpoints/{cfg.name}"
    ft_cfg = FtConfig(ckpt_dir=ckpt_dir, total_steps=args.steps,
                      ckpt_every=args.ckpt_every, failure_at=args.failure_at)

    def run_once():
        # the injected failure fires once; the restart runs past it
        try:
            return run_training(init_state=init_state, train_step=step_fn,
                                batch_at=batch_at, cfg=ft_cfg)
        finally:
            ft_cfg.failure_at = None

    t0 = time.perf_counter()
    result = run_with_restarts(run_once)
    dt = time.perf_counter() - t0
    hist = result["history"]
    if not hist:
        print(f"[done] {args.arch} system={args.system}: nothing to do "
              f"(checkpoint in {ckpt_dir} already at step "
              f"{checkpoint.latest_step(ckpt_dir)} >= --steps {args.steps};"
              " use a fresh --ckpt-dir)")
        return 0
    print(f"[done] {args.arch} system={args.system} device={model.device} "
          f"steps={args.steps} loss {hist[0]:.3f} -> {hist[-1]:.3f} "
          f"({dt:.1f}s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
