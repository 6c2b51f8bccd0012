"""Moduli sets and residue conversions on torch tensors.

The port's copy of the parts of ``repro/core/moduli.py`` the serving path
needs: :class:`ModuliSet` (forward conversion, centering, mixed-radix
reverse conversion), :func:`special_set`, :class:`PackedFormat` (the
byte-packed 2-channel KV page codec) and the sets ``P21``, ``KV8`` and
``KV4``.  Redundant (witness) channels wait for the fault-tolerance slice.

Residues are stored **centered**: ``r in [-floor(m/2), floor(m/2)]``; an
even modulus centers ``m/2`` to ``+m/2`` (``r > m//2 -> r - m``).  Every
conversion here is exact integer arithmetic and matches the reference bit
for bit: the reference's special-modulus folds compute the same canonical
residue that ``torch.remainder`` (floored, sign of the divisor) gives for
every int32 input.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence

import torch

__all__ = ["ModuliSet", "PackedFormat", "modinv", "special_set", "P21",
           "KV8", "KV4"]


def _egcd(a: int, b: int) -> tuple[int, int, int]:
    if a == 0:
        return b, 0, 1
    g, x, y = _egcd(b % a, a)
    return g, y - (b // a) * x, x


def modinv(a: int, m: int) -> int:
    """Modular inverse of ``a`` mod ``m`` (host-side, exact)."""
    g, x, _ = _egcd(a % m, m)
    if g != 1:
        raise ValueError(f"{a} is not invertible mod {m}")
    return x % m


@dataclasses.dataclass(frozen=True)
class ModuliSet:
    """A pairwise-coprime moduli set with its conversions."""

    moduli: tuple[int, ...]

    @staticmethod
    def make(moduli: Sequence[int]) -> "ModuliSet":
        mods = tuple(int(m) for m in moduli)
        for m in mods:
            if m < 2:
                raise ValueError(f"modulus {m} is degenerate: every modulus "
                                 "must be >= 2")
        for i in range(len(mods)):
            for j in range(i + 1, len(mods)):
                if math.gcd(mods[i], mods[j]) != 1:
                    raise ValueError(
                        f"moduli must be pairwise coprime, got {mods[i]}, "
                        f"{mods[j]}")
        return ModuliSet(mods)

    @property
    def num_channels(self) -> int:
        return len(self.moduli)

    @functools.cached_property
    def M(self) -> int:
        """Dynamic range: the product of the moduli (exact Python int)."""
        return math.prod(self.moduli)

    @functools.cached_property
    def half_range(self) -> int:
        """Max |X| representable in the signed (centered) interpretation."""
        return (self.M - 1) // 2

    # ---- forward conversion ------------------------------------------------
    def to_residues(self, x: torch.Tensor, *,
                    centered: bool = True) -> torch.Tensor:
        """int32 values (...) -> residues (C, ...) int32."""
        x = x.to(torch.int32)
        planes = []
        for m in self.moduli:
            r = torch.remainder(x, m)
            if centered:
                r = torch.where(r > m // 2, r - m, r)
            planes.append(r)
        return torch.stack(planes, dim=0)

    def center(self, residues: torch.Tensor) -> torch.Tensor:
        """Any representatives (C, ...) -> centered residues."""
        out = []
        for c, m in enumerate(self.moduli):
            r = torch.remainder(residues[c], m)
            out.append(torch.where(r > m // 2, r - m, r))
        return torch.stack(out, dim=0)

    def canon(self, residues: torch.Tensor) -> torch.Tensor:
        """Any representatives (C, ...) -> canonical residues in [0, m)."""
        return torch.stack([torch.remainder(residues[c], m)
                            for c, m in enumerate(self.moduli)], dim=0)

    # ---- reverse conversion ------------------------------------------------
    @functools.cached_property
    def _half_mrc_digits(self) -> tuple[int, ...]:
        """Mixed-radix digits of (M-1)//2, the sign-test threshold."""
        h, digs = self.half_range, []
        for m in self.moduli:
            digs.append(h % m)
            h //= m
        return tuple(digs)

    def from_residues(self, residues: torch.Tensor) -> torch.Tensor:
        """Residues (C, ...) -> signed int32 values (stepwise MRC).

        Exact whenever the centered value fits int32.  The reference
        reconstructs in wrapping int32; here every intermediate is an exact
        int64 (digits times prefix products stay below M), and the final
        cast to int32 wraps modulo 2**32 exactly as the reference does.
        """
        C = self.num_channels
        vs = [r.to(torch.int64) for r in self.canon(residues.to(torch.int64))]
        digits = []
        for i in range(C):
            d_i = vs[i]
            digits.append(d_i)
            for j in range(i + 1, C):
                mj = self.moduli[j]
                inv = modinv(self.moduli[i] % mj, mj)
                vs[j] = torch.remainder(torch.remainder(vs[j] - d_i, mj) * inv,
                                        mj)
        # exact sign: X_canonical > (M-1)/2  <=>  digits >lex threshold digits
        half = self._half_mrc_digits
        gt = torch.zeros_like(digits[0], dtype=torch.bool)
        eq = torch.ones_like(digits[0], dtype=torch.bool)
        for j in range(C - 1, -1, -1):
            gt = gt | (eq & (digits[j] > half[j]))
            eq = eq & (digits[j] == half[j])
        val = torch.zeros_like(digits[0])
        prod = 1
        for j in range(C):
            val = val + digits[j] * prod
            prod *= self.moduli[j]
        val = val - gt.to(torch.int64) * self.M
        return val.to(torch.int32)

    def packed(self) -> "PackedFormat":
        """The byte-packed storage format of this (two-channel) set."""
        return PackedFormat.for_moduli(self.moduli)


def special_set(n: int) -> ModuliSet:
    """The paper's ``{2^n - 1, 2^n, 2^n + 1}`` set (``n >= 2``)."""
    if n < 2:
        raise ValueError(f"special_set needs n >= 2, got n={n}")
    return ModuliSet.make(((1 << n) - 1, 1 << n, (1 << n) + 1))


@dataclasses.dataclass(frozen=True)
class PackedFormat:
    """Byte-packed codec for a 2-channel ``(odd, power-of-two)`` pair.

    Each value's two centered residues sit in adjacent two's-complement bit
    fields of ``widths``; ``values_per_byte`` values share one uint8 along
    the last axis.
    """

    moduli: tuple[int, int]
    widths: tuple[int, int]
    values_per_byte: int

    @staticmethod
    def for_moduli(moduli: Sequence[int]) -> "PackedFormat":
        if len(moduli) != 2:
            raise ValueError(
                f"packed layout needs 2 moduli, got {tuple(moduli)}")
        m0, m1 = (int(m) for m in moduli)
        if m0 % 2 == 0 or m1 & (m1 - 1) != 0:
            raise ValueError(f"packed layout needs (odd, power-of-two) "
                             f"moduli, got {tuple(moduli)}")
        b0, b1 = (m0 - 1).bit_length(), (m1 - 1).bit_length()
        w = b0 + b1
        if w not in (1, 2, 4, 8):
            raise ValueError(
                f"packed field widths {b0}+{b1} must sum to a divisor of 8")
        return PackedFormat((m0, m1), (b0, b1), 8 // w)

    @property
    def bits(self) -> int:
        return self.widths[0] + self.widths[1]

    @functools.cached_property
    def crt_inverse(self) -> int:
        """``inv(m1 mod m0, m0)``, the CRT fold's one multiplier."""
        m0, m1 = self.moduli
        return modinv(m1 % m0, m0)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """int32 values (..., N) -> packed residue bytes (..., N/vpb) uint8."""
        b0, b1 = self.widths
        vpb = self.values_per_byte
        r = ModuliSet(self.moduli).to_residues(x.to(torch.int32))
        lane = (r[0] & ((1 << b0) - 1)) | ((r[1] & ((1 << b1) - 1)) << b0)
        if vpb == 1:
            return lane.to(torch.uint8)
        n = lane.shape[-1]
        if n % vpb:
            raise ValueError(
                f"last axis {n} must divide values-per-byte {vpb}")
        lanes = lane.reshape(*lane.shape[:-1], n // vpb, vpb)
        w = b0 + b1
        byte = torch.zeros(lanes.shape[:-1], dtype=torch.int32,
                           device=x.device)
        for i in range(vpb):
            byte = byte | (lanes[..., i] << (i * w))
        return byte.to(torch.uint8)

    def decode(self, packed: torch.Tensor) -> torch.Tensor:
        """Packed bytes (..., N/vpb) uint8 -> int32 values (..., N)."""
        b0, b1 = self.widths
        vpb = self.values_per_byte
        m0, m1 = self.moduli
        w = b0 + b1
        byte = packed.to(torch.int32)
        if vpb > 1:
            lanes = torch.stack([(byte >> (i * w)) & ((1 << w) - 1)
                                 for i in range(vpb)], dim=-1)
            lane = lanes.reshape(*packed.shape[:-1], packed.shape[-1] * vpb)
        else:
            lane = byte
        f0 = lane & ((1 << b0) - 1)
        f1 = (lane >> b0) & ((1 << b1) - 1)
        r0 = f0 - ((f0 >> (b0 - 1)) << b0)          # sign-extend both fields
        r1 = f1 - ((f1 >> (b1 - 1)) << b1)
        t = torch.remainder((r0 - r1) * self.crt_inverse, m0)
        t = torch.where(t > (m0 - 1) // 2, t - m0, t)
        return r1 + m1 * t


P21 = special_set(7)
# Packable 2-channel sets for residue-domain KV pages (numerics/kv_pages.py):
# KV8 = {15, 16}: one byte per value; KV4 = {3, 4}: one nibble per value.
KV8 = ModuliSet.make((15, 16))
KV4 = ModuliSet.make((3, 4))
