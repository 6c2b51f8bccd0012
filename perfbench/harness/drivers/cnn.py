"""CNN cells: the paper's image classifier through the port's
``data/cifar.py::cnn_forward``, in batches.

Set-up makes the weights from the seed on the device (one draw), a pool of
batches of images from the mix's generator (``generators/images.py``),
and runs one warm batch; the counts keep each part's seconds.  The window runs the pool's
batches round and round, each batch synchronized, and ends at the first
batch boundary after ``--seconds``.  Every batch's logits are kept; once
the window has closed and the program's state is freed, the plain
reference computes each distinct batch once and every kept batch is
compared with it: ``logit_err``, the widest gap between the program's and
the reference's logits in units of the reference batch's standard
deviation.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import time
from pathlib import Path

import torch

from harness import main, weights
from harness.main import Cell, Run
from harness.trace import OpTimer, ProfilerSlice, port_kernel_names, span
from yardstick import flops


def spec_of(cfg: dict):
    from repro_torch.data.cifar import CnnSpec
    return CnnSpec(cfg["name"], tuple(tuple(layer) for layer in
                                      cfg["layers"]),
                   input_hw=cfg["input_size"], input_c=cfg["input_channels"],
                   n_classes=cfg["num_classes"])


def images(cell: Cell, seed: int, dev) -> torch.Tensor:
    return main.generator(cell).pool(cell.mix, seed, dev)


def run(cell: Cell, *, seed: int, seconds: float, trace: bool, device,
        t_start: float, fault=None) -> Run:
    """One run of a CNN cell.  ``fault`` (tests) wraps the forward."""
    from repro_torch.data import cifar
    from repro_torch.numerics import registry

    cfg, wl = cell.config, cell.workload
    port = cfg["port"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    parts = {"setup_imports_s": time.perf_counter() - t_start}
    t = time.perf_counter()
    spec = spec_of(cfg)
    params = weights.cnn_params(cfg, seed, dev)
    pool = images(cell, seed, dev)
    sync()
    parts["setup_inputs_s"] = time.perf_counter() - t
    dense_kw = {"system": port["system"], "bits": port["bits"],
                "compute_dtype": getattr(torch, cfg["torch_dtype"])}

    def forward(x):
        with torch.no_grad():
            return cifar.cnn_forward(params, spec, x, dense_kw=dense_kw)

    if fault is not None:
        forward = fault(forward)
    t = time.perf_counter()
    forward(pool[0])
    sync()
    parts["setup_warm_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start

    timer = OpTimer() if trace and cuda else None
    prof = ProfilerSlice(port_kernel_names(_csrc())) if trace else None
    if trace:
        dense = cifar.linear.dense

        def labelled(p, x, **kw):
            with span(f"dense K={x.shape[-1]} N={p['w'].shape[-1]}", True):
                return dense(p, x, **kw)
        cifar.linear.dense = labelled
    outs: list[tuple[int, torch.Tensor]] = []
    ctx = (timer.installed(registry) if timer is not None
           else contextlib.nullcontext())
    try:
        with ctx:
            if timer is not None:
                timer.on = True
            if prof is not None:
                prof.start()
            t0 = time.perf_counter()
            i = 0
            while True:
                b = i % len(pool)
                with span("cnn_forward", trace):
                    outs.append((b, forward(pool[b])))
                sync()
                i += 1
                now = time.perf_counter()
                if prof is not None and prof.running and (
                        now - t0 >= min(wl["trace_slice_s"], seconds)):
                    prof.stop()
                    # the profiler's own stop and reduction are not the
                    # window's
                    after = time.perf_counter()
                    t0 += after - now
                    now = after
                if now - t0 >= seconds:
                    break
            if timer is not None:
                timer.on = False
    finally:
        if trace:
            cifar.linear.dense = dense
    window_s = now - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    ops = timer.summary() if timer is not None else None
    n_img = len(outs) * cell.mix["batch"]
    counts = {"batches": len(outs), "images": n_img,
              "model_flops": 2.0 * n_img * flops.cnn_macs(
                  cfg["layers"], cfg["input_size"], cfg["input_channels"]),
              **parts}
    outs = [(b, o.detach().to("cpu", torch.float64)) for b, o in outs]
    del params, timer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = check(cell, seed, dev, pool, outs, port["bits"])
    return Run(setup_s=setup_s, window_s=window_s, attempted=len(outs),
               failed=0, counts=counts,
               numbers={k: v for k, v in numbers.items()
                        if k in wl["limits"]},
               limits=wl["limits"], memory_peak_bytes=peak, ops=ops,
               profile=prof.result if prof is not None else None)


def reference_logits(cell: Cell, seed: int, dev, pool: torch.Tensor,
                     batches: set[int], bits: int) -> dict[int, torch.Tensor]:
    cfg = cell.config
    ref = importlib.import_module(f"reference.{cfg['reference']}")
    params = weights.cnn_params(cfg, seed, dev)
    with torch.no_grad():
        return {b: ref.logits(cfg["layers"], params, pool[b], bits=bits)
                .to("cpu", torch.float64) for b in sorted(batches)}


def logit_err(outs: list[tuple[int, torch.Tensor]],
              ref: dict[int, torch.Tensor]) -> float:
    worst = 0.0
    for b, o in outs:
        r = ref[b]
        if o.shape != r.shape:
            return float("inf")
        worst = max(worst, float((o - r).abs().max() / r.std()))
    return worst


def check(cell: Cell, seed: int, dev, pool, outs, bits: int
          ) -> dict[str, float]:
    ref = reference_logits(cell, seed, dev, pool, {b for b, _ in outs},
                           bits)
    return {"logit_err": logit_err(outs, ref),
            "checked_batches": float(len(outs))}


def control(cell: Cell, seed: int, dev, bits: int) -> dict[str, float]:
    """The reference at ``bits`` put in the program's place, over every
    batch of the pool, against the reference at the configuration's."""
    pool = images(cell, seed, dev)
    every = set(range(len(pool)))
    ref = reference_logits(cell, seed, dev, pool, every,
                           cell.config["port"]["bits"])
    low = reference_logits(cell, seed, dev, pool, every, bits)
    return {"logit_err": logit_err(sorted(low.items()), ref)}


def _csrc():
    import repro_torch
    return Path(repro_torch.__file__).resolve().parent / "csrc"
