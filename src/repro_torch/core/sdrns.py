"""SD-RNS: signed digits inside residue channels (the paper's core).

Port of ``repro/core/sdrns.py``.  Residues for the moduli
``{2^n - 1, 2^n, 2^n + 1}`` are n-digit SD vectors.  Addition is carry-free
with an end-around transfer: the transfer out of the top position re-enters
position 0 as it is for ``2^n - 1`` (``2^n == 1``), negated for ``2^n + 1``
(``2^n == -1``) and dropped for ``2^n``; the lookahead rotates the same
way.  Multiplication follows Eq. 2: the partial product ``x * y_i * 2^i``
is a rotation of x's digit vector, and the n partial products reduce with
the modular carry-free adder in a pairwise tree.
"""
from __future__ import annotations

import torch

from repro_torch.core import sd
from repro_torch.core.moduli import ModuliSet

__all__ = ["WRAP_SIGNS", "encode_residue", "decode_residue", "modular_add",
           "rotate_pp", "modular_mul", "SdRnsNumber", "sdrns_add",
           "sdrns_mul", "sdrns_encode", "sdrns_decode"]

# End-around transfer sign per channel kind: 2^n == +1 (mod 2^n - 1),
# == 0 (mod 2^n), == -1 (mod 2^n + 1).
WRAP_SIGNS = {"pow2m1": 1, "pow2": 0, "pow2p1": -1}


def _modulus(kind: str, n: int) -> int:
    return (1 << n) - 1 + {"pow2m1": 0, "pow2": 1, "pow2p1": 2}[kind]


def encode_residue(r: torch.Tensor, n: int) -> torch.Tensor:
    """A centered residue (|r| <= 2^(n-1)) as n SD digits."""
    return sd.from_int(r, n)


def decode_residue(digits: torch.Tensor, kind: str, n: int) -> torch.Tensor:
    """Digits -> centered residue (the SD value reduced mod m)."""
    m = _modulus(kind, n)
    r = torch.remainder(sd.to_int(digits), m)
    return torch.where(r > m // 2, r - m, r)


def modular_add(x: torch.Tensor, y: torch.Tensor, kind: str) -> torch.Tensor:
    """Carry-free SD addition mod 2^n - 1 / 2^n / 2^n + 1; (..., n) digits.

    One pass: position sums, (w, t) with the rotated lookahead, then
    s = w + rotated t.
    """
    ws = WRAP_SIGNS[kind]
    p = x.to(torch.int8) + y.to(torch.int8)
    prev = torch.roll(p, 1, dims=-1)
    prev[..., 0] *= ws
    w, t = sd.add_interim(p, prev)
    t_in = torch.roll(t, 1, dims=-1)
    t_in[..., 0] *= ws
    return sd.combine(w, t_in)


def rotate_pp(digits: torch.Tensor, a: int, kind: str) -> torch.Tensor:
    """Digits of ``2^a * value`` mod the channel modulus (Eq. 2).

    pow2m1: cyclic rotation; pow2: shift with zero fill; pow2p1: the
    wrapped digits negated (a in [n, 2n) is a full negation plus a
    rotation by a - n).  LSB-first storage: a left rotation is a roll by +a.
    """
    n = digits.shape[-1]
    if kind == "pow2m1":
        return torch.roll(digits, a % n, dims=-1)
    idx = torch.arange(n, device=digits.device)
    if kind == "pow2":
        if a >= n:
            return torch.zeros_like(digits)
        return torch.roll(digits, a, dims=-1) * (idx >= a).to(digits.dtype)
    a %= 2 * n
    neg_all = a >= n
    a = a - n if neg_all else a
    rolled = torch.roll(digits, a, dims=-1)
    out = torch.where(idx < a, -rolled, rolled)
    return -out if neg_all else out


def modular_mul(x: torch.Tensor, y: torch.Tensor, kind: str) -> torch.Tensor:
    """SD modular multiply: Eq. 2 rotations of x selected by y's digits,
    reduced by a pairwise carry-free modular adder tree.  (..., n) digits;
    x and y broadcast."""
    n = x.shape[-1]
    pps = [rotate_pp(x, i, kind) * y[..., i:i + 1].to(torch.int8)
           for i in range(n)]
    return sd.pairwise_reduce(torch.stack(pps, dim=-2), -2,
                              lambda a, b: modular_add(a, b, kind))


def _digit_width(mset: ModuliSet) -> int:
    return max(n for _, n in mset.kinds)


def sdrns_encode(x: torch.Tensor, mset: ModuliSet) -> torch.Tensor:
    """int values (...) -> SD digit residues (C, ..., n)."""
    n = _digit_width(mset)
    return sd.from_int(mset.to_residues(x, centered=True), n)


def sdrns_decode(digits: torch.Tensor, mset: ModuliSet) -> torch.Tensor:
    """SD digit residues (C, ..., n) -> int32 values."""
    planes = [decode_residue(digits[c], kind, n)
              for c, (kind, n) in enumerate(mset.kinds)]
    return mset.from_residues(torch.stack(planes))


def sdrns_add(xd: torch.Tensor, yd: torch.Tensor,
              mset: ModuliSet) -> torch.Tensor:
    return torch.stack([modular_add(xd[c], yd[c], kind)
                        for c, (kind, _) in enumerate(mset.kinds)])


def sdrns_mul(xd: torch.Tensor, yd: torch.Tensor,
              mset: ModuliSet) -> torch.Tensor:
    return torch.stack([modular_mul(xd[c], yd[c], kind)
                        for c, (kind, _) in enumerate(mset.kinds)])


class SdRnsNumber:
    """A tensor of integers as SD-digit residue channels: (C, ..., n)."""

    def __init__(self, digits: torch.Tensor, mset: ModuliSet):
        if any(kind == "generic" for kind, _ in mset.kinds):
            raise ValueError("SD-RNS digit form needs 2^n±1 / 2^n moduli")
        self.digits = digits
        self.mset = mset

    @classmethod
    def from_int(cls, x: torch.Tensor, mset: ModuliSet) -> "SdRnsNumber":
        return cls(sdrns_encode(x, mset), mset)

    def to_int(self) -> torch.Tensor:
        return sdrns_decode(self.digits, self.mset)

    def __add__(self, other: "SdRnsNumber") -> "SdRnsNumber":
        return SdRnsNumber(sdrns_add(self.digits, other.digits, self.mset),
                           self.mset)

    def __mul__(self, other: "SdRnsNumber") -> "SdRnsNumber":
        return SdRnsNumber(sdrns_mul(self.digits, other.digits, self.mset),
                           self.mset)

    def __neg__(self) -> "SdRnsNumber":
        return SdRnsNumber(sd.negate(self.digits), self.mset)
