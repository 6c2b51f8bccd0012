"""Shared helpers of ``tests/test_torch_cifar.py`` and
``tests/test_torch_cifar_alexnet.py``: each package's CNN forward with
every dense call recorded, and the kernel calls a forward should make.

``port_forward`` runs ``repro_torch``'s ``cnn_forward`` on the CPU's plain
versions, counting each plain kernel call and recording each layer's int
activation and exact int32 accumulator (``runners.rns_run`` /
``sdrns_run``); ``ref_forward`` runs the reference's, keeping the float
input of each ``linear.dense`` call; ``expected_calls`` counts from the
runners' own segment cuts.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.data import cifar as jc
from repro.models import linear as jlinear
from repro_torch.core.moduli import P21
from repro_torch.data import cifar as tc
from repro_torch.numerics import registry, runners

NARROW = (("conv", 8, 3, 1), ("pool", 2), ("conv", 32, 3, 1), ("pool", 2),
          ("fc", 32), ("fc", 10))
BITS, QMAX = 6, 31
KERNELS = ("rns_matmul", "sdrns_matmul", "sdrns_matvec")


def _jax_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def expected_calls(spec, batch, system):
    """Plain-kernel calls of one forward at 6 bits on P21, from the runners'
    own segment cuts (B7 takes its rows in blocks of ``DECODE_M``)."""
    want = dict.fromkeys(KERNELS, 0)
    for M, K, _ in tc.dense_shapes(spec, batch):
        if system == "rns":
            want["rns_matmul"] += len(runners.rns_segments(K, QMAX, QMAX,
                                                           P21))
            continue
        segs = len(runners.sdrns_segments(K, QMAX, QMAX, P21))
        if M <= runners.DECODE_M:
            want["sdrns_matvec"] += segs * -(-M // runners.DECODE_M)
        else:
            want["sdrns_matmul"] += segs
    return want


def port_forward(params, spec, images, system, monkeypatch):
    """The port's forward (CPU plain versions) with each layer's int
    activation and int32 accumulator recorded and the plain kernel calls
    counted."""
    calls = dict.fromkeys(KERNELS, 0)
    layers = []
    for name in KERNELS:
        ref = registry.get_impl(name, "cpu")

        def counted(*args, _ref=ref, _name=name, **kw):
            calls[_name] += 1
            return _ref(*args, **kw)

        monkeypatch.setattr(registry, "_REGISTRY", {
            **registry._REGISTRY,
            name: {**registry._REGISTRY[name], "ref": counted}})
    for run in ("rns_run", "sdrns_run"):
        orig = getattr(runners, run)

        def recording(a, planes, *, _orig=orig, **kw):
            out = _orig(a, planes, **kw)
            layers.append((a.clone(), out.clone()))
            return out

        monkeypatch.setattr(runners, run, recording)
    kw = {"system": system, "compute_dtype": torch.float32}
    if system != "bns":
        kw["bits"] = BITS
    with torch.no_grad():
        logits = tc.cnn_forward(params, spec, torch.from_numpy(images),
                                dense_kw=kw)
    monkeypatch.undo()
    return logits.numpy(), layers, calls


def ref_forward(params, spec, images, system, impl, monkeypatch):
    """The reference's forward with each dense call's float input kept."""
    inputs = []
    orig = jlinear.dense

    def recording(p, x, **kw):
        inputs.append(np.asarray(x))
        return orig(p, x, **kw)

    monkeypatch.setattr(jlinear, "dense", recording)
    kw = {"system": system, "compute_dtype": jnp.float32}
    if system != "bns":
        kw.update(bits=BITS, impl=impl)
    logits = np.asarray(jc.cnn_forward(params, spec, jnp.asarray(images),
                                       dense_kw=kw))
    monkeypatch.undo()
    return logits, inputs
