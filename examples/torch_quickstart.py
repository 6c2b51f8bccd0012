"""Quickstart on the PyTorch / CUDA port: the paper's SD-RNS arithmetic in
five steps.  The counterpart of ``examples/quickstart.py``.

``system`` (bns / rns / sdrns, ``build_model(system=...)``) is the number
system a model computes in; the kernel behind each numerics op follows the
tensor's device: the hand-written Hopper kernels on the card, their plain
PyTorch versions on the CPU.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import sd
from repro_torch.core.cost_model import eq3_total, select_number_system
from repro_torch.core.moduli import P21, special_set
from repro_torch.core.rns import RnsTensor
from repro_torch.core.sdrns import SdRnsNumber
from repro_torch.models.api import resolve_device
from repro_torch.numerics import api as nx


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args().device)

    def t(v, dtype=torch.int32):
        return torch.as_tensor(np.asarray(v), dtype=dtype, device=dev)

    print("== 1. residue decomposition (the paper's Eq. 2 moduli) ==")
    ms = special_set(5)                  # {31, 32, 33}, P=16 row of Table I
    x = t([1234, -987, 12345])           # |x| must stay < M/2 = 16367
    r = ms.to_residues(x)
    print(f"moduli {ms.moduli}, dynamic range M={ms.M} (signed: "
          f"+-{ms.M // 2})")
    print(f"x={x.tolist()} -> residues\n{r.cpu().numpy()}")
    print(f"reverse conversion: {ms.from_residues(r).tolist()}")

    print("\n== 2. carry-free signed-digit addition (Eq. 1 layer) ==")
    a, b = t(27), t(-14)
    da, db = sd.from_int(a, 8), sd.from_int(b, 8)
    s = sd.carry_free_add(da, db)
    print(f"{int(a)} + {int(b)} in SD digits -> {int(sd.to_int(s))} "
          "(constant depth, no carry chain)")

    print("\n== 3. SD-RNS numbers: add & multiply mod M ==")
    xs = SdRnsNumber.from_int(t([57, -33]), ms)
    ys = SdRnsNumber.from_int(t([12, 41]), ms)
    print(f"(57,-33) + (12,41) = {(xs + ys).to_int().tolist()}")
    print(f"(57,-33) * (12,41) = {(xs * ys).to_int().tolist()}")

    print("\n== 4. exact integer matmul through RNS channels ==")
    rng = np.random.default_rng(0)
    A = t(rng.integers(-7, 8, (64, 128)))
    B = t(rng.integers(-7, 8, (128, 64)))
    exact = (A.double() @ B.double()).to(torch.int32)
    # encode once (the forward conversion the paper amortizes), matmul many
    tB = nx.encode(B, nx.EncodeSpec(layout="rns", mset=P21, qbits=4))
    C = nx.matmul(A, tB, max_abs_a=7)
    print(f"A@B exact: {bool(torch.equal(C, exact))}  "
          f"(3 int8 channels, zero in-loop reductions, on {dev})")
    print(f"decode round-trip exact: {bool(torch.equal(nx.decode(tB), B))}")
    lazy = RnsTensor.from_int(A, P21).matmul(RnsTensor.from_int(B, P21))
    print(f"RnsTensor.matmul (lazy reduction, one centering): "
          f"{bool(torch.equal(lazy.to_int(), exact))}")

    print("\n== 5. which number system should your workload use? ==")
    for (x_, y_) in ((1000, 0), (0, 1000), (500, 500)):
        pick = select_number_system(x_, y_, 24)
        tot = {s: eq3_total(s, 24, x_, y_)
               for s in ("BNS", "RNS", "SD", "SD-RNS")}
        print(f"adds={x_:5d} muls={y_:5d} -> {'/'.join(pick):12s} (ns: "
              + ", ".join(f"{k}={v:.0f}" for k, v in tot.items()) + ")")


if __name__ == "__main__":
    main()
