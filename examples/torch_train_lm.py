"""End-to-end LM training on the PyTorch / CUDA port, on synthetic
data with fault tolerance.  The counterpart of ``examples/train_lm.py``.

The default preset trains a ~1M-parameter qwen3-family model and prints
the falling loss; ``--preset m100`` builds the ~100M-parameter variant of
the same family (the same code path, more compute).  It runs on the card
by default (under ``rns`` every projection's forward is the residue
matmul kernel, its backward straight-through in f32), or on the CPU with
``--device cpu``.  Checkpoints go to ``--ckpt-dir``; ``--resume``
continues from one.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]
          [--preset tiny] [--system rns] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import shutil

from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models.api import build_model
from repro_torch.train.ft import FtConfig, run_training
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.tree import tree_leaves

PRESETS = {
    # name: (d_model, n_layers, n_heads, n_kv, d_ff, vocab, seq, batch)
    "tiny": (128, 4, 4, 2, 384, 2048, 128, 8),
    "m100": (768, 12, 12, 4, 2304, 32768, 512, 32),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--system", default="bns", choices=("bns", "rns"))
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="checkpoints/torch_train_lm")
    ap.add_argument("--resume", action="store_true",
                    help="continue from an existing checkpoint (default: "
                         "start fresh)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if not args.resume:
        shutil.rmtree(args.ckpt_dir, ignore_errors=True)

    d, L, H, kv, ff, vocab, seq, batch = PRESETS[args.preset]
    cfg = dataclasses.replace(
        get_config("qwen3-8b").reduced(), d_model=d, n_layers=L, n_heads=H,
        n_kv=kv, d_ff=ff, vocab=vocab, head_dim=d // H)
    model = build_model(cfg, system=args.system, device=args.device)
    opt_cfg = OptConfig(peak_lr=args.lr, warmup_steps=20,
                        total_steps=args.steps)
    step = make_train_step(model, opt_cfg, 1)
    pipe = TokenPipeline(vocab=vocab, seq_len=seq, global_batch=batch)

    def init_state():
        params = model.init(0, prepare=False)
        return {"params": params,
                "opt_state": init_opt_state(params, opt_cfg)}

    n_params = sum(x.numel() for x in tree_leaves(init_state()["params"]))
    print(f"[train_lm] {args.preset}: {n_params / 1e6:.1f}M params, "
          f"seq={seq} batch={batch} system={args.system} "
          f"device={model.device.type}")
    res = run_training(
        init_state=init_state, train_step=step, batch_at=pipe.batch_at,
        cfg=FtConfig(ckpt_dir=args.ckpt_dir, total_steps=args.steps,
                     ckpt_every=max(args.steps // 4, 10), log_every=10))
    h = res["history"]
    if not h:
        print("[train_lm] nothing to do (checkpoint already at "
              f"{res['step']} steps; use a fresh --ckpt-dir)")
        return
    print(f"[train_lm] loss: start {h[0]:.3f} -> "
          f"min {min(h):.3f} -> final {h[-1]:.3f}")
    if not min(h) < h[0]:
        raise SystemExit("loss did not fall")


if __name__ == "__main__":
    main()
