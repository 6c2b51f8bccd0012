"""Moduli sets and residue conversions on torch tensors.

The port's copy of ``repro/core/moduli.py``: :class:`ModuliSet` (forward
conversion, centering, mixed-radix reverse conversion, the exact host
codecs of any width, the channel-wise ring ops and lazy-reduction budget
of :class:`~repro_torch.core.rns.RnsTensor`, with trailing redundant
"witness" channels the syndrome check and single-fault correction, the
partial CRT of the channel-split decode (:meth:`ModuliSet.partial_decode`,
:meth:`~ModuliSet.fold_partials`, :meth:`~ModuliSet.partial_witnesses`,
:meth:`~ModuliSet.corrected_fold`); ``kinds``, the per-modulus tags the
signed-digit layouts dispatch on), the special-modulus folds
:func:`mod_pow2`, :func:`mod_pow2_minus1` and :func:`mod_pow2_plus1`,
:func:`special_set`, :class:`PackedFormat` (the byte-packed 2-channel KV
page codec) and the sets ``P16``, ``P21``, ``P24``, ``P33``, ``P64``
(Table I's rows), ``CRT40``, ``KV8``, ``KV4``, ``P21R2`` and ``KV8R2``.

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

import numpy as np
import torch

__all__ = ["ModuliSet", "PackedFormat", "modinv", "special_set",
           "mod_pow2", "mod_pow2_minus1", "mod_pow2_plus1", "P16", "P21",
           "P24", "P33", "P64", "CRT40", "KV8", "KV4", "P21R2", "KV8R2"]


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


# ---------------------------------------------------------------------------
# Special-modulus reductions of int32 tensors to canonical residues in
# [0, m): masks, shifts and a few adds (the paper's "wiring-only"
# conversions).  Bit for bit the reference's, -2**31 included (whose ``abs``
# wraps in both).
# ---------------------------------------------------------------------------


def mod_pow2(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x mod 2**n`` for int32 ``x`` (two's complement handles negatives)."""
    return x & ((1 << n) - 1)


def mod_pow2_minus1(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x mod (2**n - 1)`` by end-around chunk folding of ``|x|``."""
    m = (1 << n) - 1
    neg = x < 0
    y = x.abs()
    for _ in range(_folds_needed(31, n)):
        y = (y & m) + (y >> n)
    y = torch.where(y >= m, y - m, y)
    return torch.where(neg & (y != 0), m - y, torch.where(neg, 0, y))


def mod_pow2_plus1(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x mod (2**n + 1)`` by alternating chunk folding of ``|x|``."""
    m = (1 << n) + 1
    neg = x < 0
    mask = (1 << n) - 1
    y = x.abs()
    for _ in range(_folds_needed(31, n)):
        y = (y & mask) - (y >> n)
    y = torch.remainder(y, m)
    return torch.where(neg & (y != 0), m - y, torch.where(neg, 0, y))


def _folds_needed(bits: int, n: int) -> int:
    """Fold iterations that bring a ``bits``-bit value under ~2**(n+1)."""
    k, width = 0, bits
    while width > n + 1:
        width = max(n + 1, width - n + 1)
        k += 1
        if k > 8:
            break
    return max(k, 1)


def _exact(f, *arrays) -> np.ndarray:
    """``f`` elementwise over object arrays (Python ints, any width)."""
    return np.vectorize(f, otypes=[object])(*arrays)


@dataclasses.dataclass(frozen=True)
class ModuliSet:
    """A pairwise-coprime moduli set with its conversions.

    The trailing ``redundant`` moduli are witness channels: they do not
    extend the range (``M`` and ``half_range`` are taken over the
    information moduli only) and make a corrupted channel detectable and,
    with ``redundant >= 2``, correctable at decode time.
    """

    moduli: tuple[int, ...]
    redundant: int = 0

    @staticmethod
    def make(moduli: Sequence[int], *, redundant: int = 0) -> "ModuliSet":
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
        if not 0 <= redundant < len(mods):
            raise ValueError(f"redundant={redundant} needs 0 <= r < "
                             f"{len(mods)} (one information channel must "
                             "remain)")
        if redundant >= 2:
            # single-fault correction: a wrong-channel projection differs
            # from the true value by a multiple of M_total / (m_i * m_j),
            # which must clear the legitimate range
            m_info = math.prod(mods[: len(mods) - redundant])
            m_total = math.prod(mods)
            for i in range(len(mods)):
                for j in range(i + 1, len(mods)):
                    if m_total // (mods[i] * mods[j]) < m_info:
                        raise ValueError(
                            f"redundant moduli {mods[len(mods) - redundant:]}"
                            f" are too small for single-fault correction: "
                            f"M_total/({mods[i]}*{mods[j]}) < M_info")
        return ModuliSet(mods, redundant)

    def with_redundancy(self, extra: Sequence[int]) -> "ModuliSet":
        """This set's information moduli with ``extra`` as witnesses."""
        extra = tuple(int(m) for m in extra)
        return ModuliSet.make(self.info_moduli + extra, redundant=len(extra))

    @property
    def num_channels(self) -> int:
        return len(self.moduli)

    @property
    def num_info(self) -> int:
        """Number of information (non-redundant) channels."""
        return len(self.moduli) - self.redundant

    @property
    def info_moduli(self) -> tuple[int, ...]:
        return self.moduli[: self.num_info]

    @property
    def redundant_moduli(self) -> tuple[int, ...]:
        return self.moduli[self.num_info:]

    @functools.cached_property
    def kinds(self) -> tuple[tuple[str, int], ...]:
        """Per-modulus tag ``(kind, n)``: ``"pow2m1"`` for 2^n - 1,
        ``"pow2"`` for 2^n, ``"pow2p1"`` for 2^n + 1, else
        ``("generic", 0)``."""
        out = []
        for m in self.moduli:
            nb = m.bit_length()
            if m == (1 << nb) - 1:
                out.append(("pow2m1", nb))
            elif m == 1 << (nb - 1):
                out.append(("pow2", nb - 1))
            elif m == (1 << (nb - 1)) + 1:
                out.append(("pow2p1", nb - 1))
            else:
                out.append(("generic", 0))
        return tuple(out)

    @functools.cached_property
    def info(self) -> "ModuliSet":
        """The information channels alone (``self`` without redundancy)."""
        return self if self.redundant == 0 else ModuliSet(self.info_moduli)

    @functools.cached_property
    def M(self) -> int:
        """Dynamic range: the product of the information moduli."""
        return math.prod(self.info_moduli)

    @functools.cached_property
    def M_total(self) -> int:
        """Product of all moduli, witness channels included."""
        return math.prod(self.moduli)

    @property
    def precision_bits(self) -> int:
        return self.M.bit_length()

    @functools.cached_property
    def half_range(self) -> int:
        """Max |X| representable in the signed (centered) interpretation:
        the legitimate range of a redundant set."""
        return (self.M - 1) // 2

    # ---- exact host conversions (Python ints, any width) --------------------
    def to_residues_host(self, x) -> np.ndarray:
        """Centered residues ``(C,) + x.shape`` int64 of integers of any
        width (P64's only exact path)."""
        xs = np.asarray(x, dtype=object)
        out = np.empty((self.num_channels,) + xs.shape, dtype=np.int64)
        for c, m in enumerate(self.moduli):
            r = _exact(lambda v, m=m: int(v) % m, xs)
            out[c] = _exact(lambda v, m=m: v - m if v > m // 2 else v,
                            r).astype(np.int64)
        return out

    def from_residues_host(self, residues) -> np.ndarray:
        """Mixed-radix reverse conversion of ``(C, ...)`` residues to signed
        Python ints in ``[-M//2, M//2]`` (an object array); a redundant set
        decodes its information channels."""
        if self.redundant:
            return self.info.from_residues_host(
                np.asarray(residues)[: self.num_info])
        res = np.asarray(residues)
        zero = _exact(lambda *_: 0, res[0])
        digits = [_exact(lambda v: int(v) % self.moduli[0], res[0])]
        for j in range(1, self.num_channels):
            mj = self.moduli[j]
            part, prod = zero, 1
            for i in range(j):
                part = part + digits[i] * prod
                prod *= self.moduli[i]
            inv = modinv(prod % mj, mj)
            digits.append(_exact(
                lambda r, p, mj=mj, inv=inv: ((int(r) - int(p)) * inv) % mj,
                res[j], part))
        val, prod = zero, 1
        for j in range(self.num_channels):
            val = val + digits[j] * prod
            prod *= self.moduli[j]
        return _exact(lambda v: v - self.M if v > self.M // 2 else v, val)

    # ---- forward conversion ------------------------------------------------
    def to_residues(self, x: torch.Tensor, *, centered: bool = True,
                    channel_ids=None) -> torch.Tensor:
        """int32 values (...) -> residues (C, ...) int32; with
        ``channel_ids``, those channels' only (C_loc, ...)."""
        x = x.to(torch.int32)
        moduli = (self.moduli if channel_ids is None
                  else [self.moduli[c] for c in channel_ids])
        planes = []
        for m in moduli:
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
        A redundant set decodes its information channels only.  Moduli
        above 46340 are refused, as the reference refuses them (P64 decodes
        through :meth:`from_residues_host`).
        """
        if self.redundant:
            return self.info.from_residues(residues[: self.num_info])
        if max(self.moduli) > 46340:
            raise ValueError("reverse conversion needs moduli <= 46340 (use "
                             "from_residues_host for the P=64 set)")
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

    # ---- channel-wise ring ops (any representatives in, centered out) ------
    def channel_mod(self, residues: torch.Tensor) -> torch.Tensor:
        """Reduce each channel mod m_c and re-center (the lazy flush)."""
        return self.center(residues)

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.center(a + b)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.center(a - b)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.center(a * b)

    def lazy_add_capacity(self) -> int:
        """Centered-residue products an int32 accumulates before a
        reduction is needed (the lazy-reduction budget)."""
        worst = max((m // 2) ** 2 for m in self.moduli)
        return (1 << 31) // (2 * worst)

    # ---- redundancy: syndromes and single-fault correction ----------------
    def _info_bad(self, res: torch.Tensor, x: torch.Tensor
                  ) -> list[torch.Tensor]:
        """Per witness channel: does the stored residue disagree with the
        information decode ``x``?  (``res`` canonical.)"""
        ni = self.num_info
        return [torch.remainder(res[ni + j] - torch.remainder(x, m), m) != 0
                for j, m in enumerate(self.redundant_moduli)]

    def syndromes(self, residues: torch.Tensor) -> torch.Tensor:
        """Per-witness consistency syndromes ``(r, ...)`` int32: zero
        everywhere exactly when the witnesses agree with the decode."""
        if self.redundant == 0:
            raise ValueError("syndromes() needs a redundant ModuliSet")
        res = self.canon(residues.to(torch.int32))
        x = self.info.from_residues(res[: self.num_info])
        return torch.stack(
            [torch.remainder(res[self.num_info + j] - torch.remainder(x, m),
                             m) for j, m in enumerate(self.redundant_moduli)],
            dim=0).to(torch.int32)

    @functools.cached_property
    def _projection_tables(self) -> tuple[list[list[int]], list[int]]:
        """CRT tables of the leave-one-information-channel-out sets: per
        dropped channel ``c``, the weights ``B_j = (M_c/m_j) *
        inv(M_c/m_j, m_j)`` (0 at ``j == c``) and the product ``M_c``."""
        weights, prods = [], []
        for c in range(self.num_info):
            mc = math.prod(m for j, m in enumerate(self.moduli) if j != c)
            row = [0 if j == c else (mc // m) * modinv(mc // m, m)
                   for j, m in enumerate(self.moduli)]
            if (self.num_channels - 1) * max(self.moduli) * mc >= 1 << 62:
                raise ValueError(f"projection of {self.moduli} overflows "
                                 "int64")
            weights.append(row)
            prods.append(mc)
        return weights, prods

    @functools.cached_property
    def _device_tables(self) -> dict:
        """:attr:`_projection_tables` as tensors, by device."""
        return {}

    def _project_info(self, res: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """Leave-one-information-channel-out projections of canonical
        residues.  Returns ``(best, n_legit)``: the sum of the projections
        inside the legitimate range and how many landed there.

        The reference decodes each projection by MRC in wrapping int32;
        here all of them come from one vectorized CRT in exact int64 (the
        sums stay far below 2**63), centered and then wrapped to int32 the
        same way, so the values are identical with a handful of tensor ops
        instead of one MRC per dropped channel.
        """
        ni, lead = self.num_info, (1,) * (res.dim() - 1)
        dev = res.device
        tables = self._device_tables.get(dev)
        if tables is None:      # one host-to-device copy per device, ever
            weights, prods = self._projection_tables
            tables = (torch.tensor(weights, dtype=torch.int64, device=dev),
                      torch.tensor(prods, dtype=torch.int64, device=dev))
            self._device_tables[dev] = tables
        w, mc = tables[0], tables[1].view(ni, *lead)
        acc = torch.zeros((ni, *res.shape[1:]), dtype=torch.int64, device=dev)
        for j in range(self.num_channels):
            acc += res[j].to(torch.int64) * w[:, j].view(ni, *lead)
        p = torch.remainder(acc, mc)
        p = torch.where(p > (mc - 1) // 2, p - mc, p).to(torch.int32)
        legit = p.abs() <= self.half_range
        n_legit = legit.to(torch.int32).sum(dim=0)
        best = torch.where(legit, p, 0).sum(dim=0, dtype=torch.int32)
        return best, n_legit

    def corrected_decode(self, residues: torch.Tensor) -> torch.Tensor:
        """Reverse conversion with in-line single-fault correction.

        Equals :meth:`from_residues` on consistent residues.  When every
        syndrome fires (an information channel is corrupted) and
        ``redundant >= 2``, the value is rebuilt from the unique projection
        inside the legitimate range.  The reference runs the projections
        under ``lax.cond``; here they always run and ``torch.where``
        selects, so the decode never reads the device from the host.
        """
        if self.redundant == 0:
            return self.from_residues(residues)
        res = self.canon(residues.to(torch.int32))
        x = self.info.from_residues(res[: self.num_info])
        if self.redundant < 2:
            return x
        info_fault = functools.reduce(torch.logical_and,
                                      self._info_bad(res, x))
        best, n_legit = self._project_info(res)
        return torch.where(info_fault & (n_legit == 1), best, x)

    def correct(self, residues: torch.Tensor):
        """Detect and repair single-channel faults.

        Returns ``(fixed, detected, corrected)``: centered ``(C, ...)``
        residues and elementwise bool masks.  No nonzero syndrome: nothing
        to do; exactly one: that witness is rewritten from the information
        decode; two or more: an information channel is faulty and the whole
        vector is re-encoded from the unique legitimate projection (left
        untouched when there is none).  ``redundant == 1`` detects only.
        """
        if self.redundant == 0:
            raise ValueError("correct() needs a redundant ModuliSet")
        res = self.canon(residues.to(torch.int32))
        ni = self.num_info
        x = self.info.from_residues(res[:ni])
        syn = self._info_bad(res, x)
        n_nz = functools.reduce(torch.add, [s.to(torch.int32) for s in syn])
        detected = n_nz > 0
        rows = list(res)
        corrected = torch.zeros_like(detected)
        if self.redundant >= 2:
            red_fault = n_nz == 1
            for j, m in enumerate(self.redundant_moduli):
                rows[ni + j] = torch.where(red_fault & syn[j],
                                           torch.remainder(x, m), res[ni + j])
            best, n_legit = self._project_info(res)
            fix = (n_nz >= 2) & (n_legit == 1)
            rows = [torch.where(fix, torch.remainder(best, m), r)
                    for m, r in zip(self.moduli, rows)]
            corrected = red_fault | fix
        return self.center(torch.stack(rows, dim=0)), detected, corrected

    # ---- partial CRT: the channel-split decode ------------------------------
    #
    # MRC is sequential across channels, so a rank holding only some
    # channels cannot contribute an MRC digit.  CRT can: each information
    # channel's projection t_c * (M / m_c), t_c = r_c * inv(M / m_c) mod
    # m_c, is a local value-domain partial; the sum over all channels is
    # X mod M, so one all-reduce and one final mod M replace the gather of
    # the channels.  Every product r * inv stays under max(m)^2 and the sum
    # under num_info * (M - 1): exact in int32 where
    # :attr:`supports_partial_decode` holds.

    @functools.cached_property
    def supports_partial_decode(self) -> bool:
        """Whether the int32 partial-CRT decode is exact: every ``r * inv``
        (< max(m)^2) and the summed projections (< num_info * (M - 1)) fit
        int32.  False for the wide sets (P33, P64, CRT40), which keep the
        sequential MRC decode."""
        return (max(self.moduli) <= 46340
                and self.num_info * (self.M - 1) < (1 << 31))

    @functools.cached_property
    def _crt_tables(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-channel ``(B, inv)``, both ``(C,)`` int32: ``B[c] = M / m_c``
        and ``inv[c] = (M / m_c)^-1 mod m_c`` on the information channels,
        zero on the witness channels (their projections vanish)."""
        B = np.zeros((self.num_channels,), np.int64)
        inv = np.zeros((self.num_channels,), np.int64)
        for c, m in enumerate(self.info_moduli):
            B[c] = self.M // m
            inv[c] = modinv((self.M // m) % m, m)
        return B.astype(np.int32), inv.astype(np.int32)

    @staticmethod
    def _take(values: Sequence[int], channel_ids, ndim: int,
              device) -> torch.Tensor:
        """``values[channel_ids]`` as int32, shaped to broadcast over
        ``(C_loc, ...)`` planes of rank ``ndim``."""
        idx = np.asarray(torch.as_tensor(channel_ids).cpu(), np.int64)
        out = torch.as_tensor(np.asarray(values, np.int64)[idx],
                              dtype=torch.int32, device=device)
        return out.reshape((-1,) + (1,) * (ndim - 1))

    def partial_decode(self, planes: torch.Tensor, channel_ids
                       ) -> torch.Tensor:
        """Local CRT partial of a channel slice.

        ``planes``: ``(C_loc, ...)`` residues of the channels this rank
        holds (any int32 representative: centered, canonical or a lazy
        accumulation); ``channel_ids``: their ``(C_loc,)`` global indices.
        Returns the sum over them of ``(r_c * inv_c mod m_c) * (M / m_c)``;
        witness channels add zero.  Summed over every rank and folded by
        :meth:`fold_partials`, it equals :meth:`from_residues` bit for bit.
        """
        if not self.supports_partial_decode:
            raise ValueError(
                f"moduli set {self.moduli} exceeds the int32 partial-CRT "
                "bound (num_info * (M-1) must fit int32); use the gathered "
                "MRC path (from_residues)")
        B_tab, inv_tab = self._crt_tables
        nd, dev = planes.dim(), planes.device
        m = self._take(self.moduli, channel_ids, nd, dev)
        B = self._take(B_tab, channel_ids, nd, dev)
        inv = self._take(inv_tab, channel_ids, nd, dev)
        r = torch.remainder(planes.to(torch.int32), m)    # canonical [0, m)
        t = torch.remainder(r * inv, m)                   # r*inv < max(m)^2
        return (t * B).sum(dim=0, dtype=torch.int32)      # each term < M

    def fold_partials(self, partial_sum: torch.Tensor) -> torch.Tensor:
        """The all-reduced partials to the signed decode: one final mod M,
        centred at :meth:`from_residues`' threshold (bit-identical)."""
        x = torch.remainder(partial_sum.to(torch.int32), self.M)
        return torch.where(x > self.half_range, x - self.M, x)

    def partial_witnesses(self, planes: torch.Tensor, channel_ids
                          ) -> torch.Tensor:
        """Local contribution to the ``(r, ...)`` canonical witness planes:
        each witness channel's canonical residues where this rank holds it,
        zero elsewhere, so the all-reduce assembles every witness plane
        wherever the channels live.  ``(0, ...)`` for a plain set."""
        cid = torch.as_tensor(channel_ids).cpu().tolist()
        p32 = planes.to(torch.int32)
        outs = []
        for j, m in enumerate(self.redundant_moduli):
            acc = torch.zeros(planes.shape[1:], dtype=torch.int32,
                              device=planes.device)
            for i, c in enumerate(cid):
                if c == self.num_info + j:
                    acc = acc + torch.remainder(p32[i], m)
            outs.append(acc)
        if not outs:
            return torch.zeros((0, *planes.shape[1:]), dtype=torch.int32,
                               device=planes.device)
        return torch.stack(outs, dim=0)

    def corrected_fold(self, partial_sum: torch.Tensor,
                       witnesses: torch.Tensor) -> torch.Tensor:
        """:meth:`fold_partials` with the witness check, the all-reduce
        sibling of :meth:`corrected_decode`: when every syndrome fires (an
        information channel is corrupted, ``redundant >= 2``) the canonical
        residue vector is rebuilt from ``(x, witnesses)`` (the CRT value
        satisfies ``x = r_i mod m_i`` for every stored information residue,
        corrupted or not) and the value taken from its unique legitimate
        leave-one-out projection.  Bit-identical to
        :meth:`corrected_decode` on the gathered planes; the projections
        always run and ``torch.where`` selects (no host read)."""
        x = self.fold_partials(partial_sum)
        if self.redundant < 2:
            return x
        w = witnesses.to(torch.int32)
        info_fault = functools.reduce(torch.logical_and, [
            torch.remainder(w[j] - torch.remainder(x, m), m) != 0
            for j, m in enumerate(self.redundant_moduli)])
        res = torch.stack([torch.remainder(x, m) for m in self.info_moduli]
                          + [w[j] for j in range(self.redundant)], dim=0)
        best, n_legit = self._project_info(res)
        return torch.where(info_fault & (n_legit == 1), best, x)

    def packed(self) -> "PackedFormat":
        """The byte-packed storage format of this set's two information
        channels."""
        return PackedFormat.for_moduli(self.info_moduli)


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


# Table I's precision rows (P = 16 / 24 / 32 / 64 bits: n = 5 / 8 / 11 / 21)
# and P21 (n = 7: every centered residue fits int8, the tensor-core sweet
# spot).  P33 and P64 decode on the device in wrapping int32, as the
# reference's do; P64 exactly only on the host.
P16 = special_set(5)
P21 = special_set(7)
P24 = special_set(8)
P33 = special_set(11)
P64 = special_set(21)
# A six-channel set whose residues all fit int8 (~2^42 of range): C = 6
# splits over 2 or 3 ranks, and past the int32 partial-CRT bound it keeps
# the gathered MRC decode.
CRT40 = ModuliSet.make((121, 125, 127, 128, 129, 131))
# Packable 2-channel sets for residue-domain KV pages (numerics/kv_pages.py):
# KV8 = {15, 16}: one byte per value; KV4 = {3, 4}: one nibble per value.
KV8 = ModuliSet.make((15, 16))
KV4 = ModuliSet.make((3, 4))
# Two witness channels each: P21R2 keeps P21's range with every centered
# residue in int8, KV8R2 is the rns8r page format (lane 0 the packed KV8
# byte, lanes 1..2 the witnesses, 17 * 19 = 323 > 240).
P21R2 = ModuliSet.make((127, 128, 129, 131, 133), redundant=2)
KV8R2 = ModuliSet.make((15, 16, 17, 19), redundant=2)
