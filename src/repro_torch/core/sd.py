"""Binary signed-digit (SD) arithmetic: the paper's Eq. 1 layer.

Port of ``repro/core/sd.py``.  An n-digit SD integer has digits
``x_i in {-1, 0, 1}`` and value ``sum x_i 2^i``; digit vectors are int8
tensors whose **last axis is the digit position, LSB first**.  The
two-step rule adds two of them without a carry chain: per position an
interim sum ``w_i`` and a transfer ``t_{i+1}`` with ``s_i = w_i + t_i``
never leaving {-1, 0, 1}.  The modular (end-around) adders live in
:mod:`repro_torch.core.sdrns`.  Every function here gives the reference's
digit vectors bit for bit.
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["from_int", "to_int", "negate", "carry_free_add", "add_interim",
           "combine", "shift_left", "add_tree", "pairwise_reduce"]


def from_int(x: torch.Tensor, n_digits: int) -> torch.Tensor:
    """int tensor ``x`` -> SD digits ``x.shape + (n_digits,)`` int8.

    The binary expansion of |x| with a global sign; needs
    ``|x| < 2**n_digits``.
    """
    x = x.to(torch.int32)
    sign = torch.sign(x).to(torch.int8).unsqueeze(-1)
    shifts = torch.arange(n_digits, dtype=torch.int32, device=x.device)
    bits = (x.abs().unsqueeze(-1) >> shifts) & 1
    return bits.to(torch.int8) * sign


def to_int(digits: torch.Tensor) -> torch.Tensor:
    """SD digits (last axis LSB first) -> int32 values."""
    n = digits.shape[-1]
    weights = torch.ones((), dtype=torch.int32, device=digits.device) << \
        torch.arange(n, dtype=torch.int32, device=digits.device)
    return (digits.to(torch.int32) * weights).sum(dim=-1, dtype=torch.int32)


def negate(digits: torch.Tensor) -> torch.Tensor:
    """Digit-wise negation: no carry chain."""
    return -digits


def shift_left(digits: torch.Tensor, k: int) -> torch.Tensor:
    """Multiply by 2**k, growing the digit vector by k (non-modular)."""
    zeros = digits.new_zeros((*digits.shape[:-1], k))
    return torch.cat([zeros, digits], dim=-1)


# The two-step rule.  Position sums p_i = x_i + y_i in [-2, 2]; choose the
# transfer t_{i+1} and interim w_i with p_i = 2 t_{i+1} + w_i:
#
#   p >=  2 : t = +1, w = p - 2
#   p ==  1 : (t, w) = (+1, -1) if p_{i-1} >= 0 else (0, +1)
#   p ==  0 : (t, w) = (0, 0)
#   p == -1 : (t, w) = (0, -1) if p_{i-1} >= 0 else (-1, +1)
#   p <= -2 : t = -1, w = p + 2
#
# The lookahead makes an incoming t_i = +1 meet w_i <= 0 (and -1 meet
# w_i >= 0), so s_i = w_i + t_i stays in {-1, 0, 1}.


def add_interim(p: torch.Tensor, prev: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-position ``(w, t_out)`` from position sums ``p`` and the
    lookahead ``prev`` (p shifted toward the LSB; rotated by the modular
    adders)."""
    p = p.to(torch.int8)
    nonneg = prev >= 0
    one = torch.ones_like(p)
    zero = torch.zeros_like(p)
    flip = torch.where(nonneg, -one, one)            # w for p == +-1
    w = torch.where(p >= 2, p - 2, torch.where(
        (p == 1) | (p == -1), flip, torch.where(p == 0, zero, p + 2)))
    t = torch.where(p >= 2, one, torch.where(
        p == 1, torch.where(nonneg, one, zero), torch.where(
            p == 0, zero, torch.where(
                p == -1, torch.where(nonneg, zero, -one), -one))))
    return w, t


def combine(w: torch.Tensor, t_in: torch.Tensor) -> torch.Tensor:
    """s = w + incoming transfer; stays in {-1, 0, 1} by construction."""
    return w + t_in


def _shift_up(x: torch.Tensor) -> torch.Tensor:
    """Position i takes position i - 1's value; position 0 takes 0."""
    return torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], dim=-1)


def carry_free_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Non-modular carry-free addition: (..., n) x 2 -> (..., n + 1)."""
    p = x.to(torch.int8) + y.to(torch.int8)
    w, t = add_interim(p, _shift_up(p))
    s = combine(w, _shift_up(t))
    return torch.cat([s, t[..., -1:]], dim=-1)   # transfer out is digit n


def pairwise_reduce(pps: torch.Tensor, axis: int,
                    add: Callable[[torch.Tensor, torch.Tensor],
                                  torch.Tensor]) -> torch.Tensor:
    """Balanced pairwise reduction over ``axis``: zero-pad an odd count,
    then ``add`` the 0::2 and 1::2 slices, level by level.

    The pairing is load-bearing: ``x + 0`` is not ``x`` digit for digit,
    and the kernels' output digit vectors equal this tree's only because
    they reduce in exactly this order.
    """
    axis = axis % pps.dim()
    while pps.shape[axis] > 1:
        if pps.shape[axis] % 2 == 1:
            pad = list(pps.shape)
            pad[axis] = 1
            pps = torch.cat([pps, pps.new_zeros(pad)], dim=axis)
        lo = pps[(slice(None),) * axis + (slice(0, None, 2),)]
        hi = pps[(slice(None),) * axis + (slice(1, None, 2),)]
        pps = add(lo, hi)
    return pps.squeeze(axis)


def add_tree(pps: torch.Tensor) -> torch.Tensor:
    """Reduce ``(..., num_pp, n)`` partial products with a balanced
    non-modular carry-free tree (one digit more per level)."""
    return pairwise_reduce(pps, -2, carry_free_add)
