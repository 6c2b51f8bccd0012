"""The paper's DNN evaluation on the PyTorch / CUDA port: a CIFAR-scale
AlexNet whose every convolution and fc layer runs through the residue
matmul kernel.  The counterpart of ``examples/rns_cnn_inference.py``.

Pipeline:
  1. train AlexNet (float, ``system="bns"``) for ``--train-steps`` SGD
     steps on the synthetic CIFAR-10 set;
  2. run inference under ``system="rns"`` at ``--bits`` (int6 codes per
     token and per output channel, P21 residue planes, the exact int32
     product, mixed-radix decode): on the card every layer is a launch of
     the residue matmul kernel;
  3. check that quantized accuracy stays within 0.08 of float;
  4. report the Eq. 3 delay model's SD-RNS speedups at this network's op
     mix (the paper's circuits, not this card).

Run:  PYTHONPATH=src python examples/torch_rns_cnn_inference.py
      [--train-steps 60] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.cost_model import select_number_system, speedup
from repro_torch.data.cifar import (ALEXNET, cnn_forward, init_cnn,
                                    op_counts, synthetic_cifar)
from repro_torch.models.api import resolve_device

BNS = {"system": "bns", "compute_dtype": torch.float32}


def train_float(params, spec, xs, ys, *, steps: int, batch: int,
                lr: float = 0.05, log=print):
    """``steps`` plain SGD steps on the float network (``bns``), batches
    taken in order from ``xs`` / ``ys`` (device tensors) as the reference's
    example takes them.  Updates ``params`` in place; returns the losses."""
    leaves = [leaf for p in params.values() for leaf in p.values()]
    for leaf in leaves:
        leaf.requires_grad_(True)
    n, losses = xs.shape[0], []
    for i in range(steps):
        j = (i * batch) % (n - batch)
        logits = cnn_forward(params, spec, xs[j:j + batch], dense_kw=BNS)
        loss = -torch.log_softmax(logits, -1).gather(
            1, ys[j:j + batch, None].long()).mean()
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for leaf, g in zip(leaves, grads):
                leaf.sub_(lr * g)
        losses.append(float(loss.detach()))
        if i % 20 == 0:
            log(f"  step {i}: loss {losses[-1]:.3f}")
    for leaf in leaves:
        leaf.requires_grad_(False)
    return losses


@torch.no_grad()
def evaluate(params, spec, xt, yt, dense_kw, *, batch: int = 64):
    """(accuracy, logits) over ``xt`` in batches of ``batch`` images."""
    logits = torch.cat([cnn_forward(params, spec, xt[i:i + batch],
                                    dense_kw=dense_kw)
                        for i in range(0, xt.shape[0], batch)])
    acc = float((logits.argmax(-1) == yt.long()).float().mean())
    return acc, logits


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--train-steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--eval-n", type=int, default=256)
    ap.add_argument("--bits", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False

    spec = ALEXNET
    params = init_cnn(torch.Generator(device=dev).manual_seed(0), spec,
                      device=dev)
    xs, ys = (torch.from_numpy(a).to(dev)
              for a in synthetic_cifar(4096, split="train"))
    xt, yt = (torch.from_numpy(a).to(dev)
              for a in synthetic_cifar(args.eval_n, split="test"))

    print(f"[cnn] training float AlexNet on synthetic CIFAR "
          f"({args.train_steps} steps, {dev})")
    train_float(params, spec, xs, ys, steps=args.train_steps,
                batch=args.batch)

    def timed(dense_kw):
        t0 = time.perf_counter()
        acc, logits = evaluate(params, spec, xt, yt, dense_kw,
                               batch=args.batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return acc, logits, time.perf_counter() - t0

    acc_f, _, t_f = timed(BNS)
    acc_r, _, t_r = timed({"system": "rns", "bits": args.bits,
                           "compute_dtype": torch.float32})
    print(f"[cnn] accuracy: float {acc_f:.3f} | RNS int{args.bits} "
          f"{acc_r:.3f} (wall on {dev}: {t_f:.2f}s vs {t_r:.2f}s, first "
          "calls included)")

    ops_ = op_counts(spec)
    x, y = ops_["adds"], ops_["muls"]
    pick = select_number_system(x, y, 24)
    print(f"[cost model] AlexNet mix adds={x:,} muls={y:,} -> "
          f"best system {'/'.join(pick)}")
    print(f"[cost model] SD-RNS speedup on this workload: "
          f"x{speedup('RNS', 'SD-RNS', 24, x, y):.2f} vs RNS, "
          f"x{speedup('BNS', 'SD-RNS', 24, x, y):.2f} vs BNS "
          "(paper: x1.27 / x2.25; the delay model of the paper's circuits)")
    if acc_r < acc_f - 0.08:
        raise SystemExit("RNS quantized accuracy collapsed")


if __name__ == "__main__":
    main()
