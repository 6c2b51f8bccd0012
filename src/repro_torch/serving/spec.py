"""Speculative decoding: the ``spec=`` knob and the greedy acceptance rule.

Port of ``repro/serving/spec.py``.  A drafter proposes ``k`` tokens, the
target verifies all of them in one batched paged step (``V = k + 1`` rows
per slot, folded into one paged-decode launch), and the greedy rule emits
the longest draft prefix the target agrees with plus the target's own next
token: 1 to ``k + 1`` tokens per verify.  Every emitted token is the argmax
of a target logits row over the prefix a plain decode would have seen, so
the tokens equal plain greedy decoding; the drafter only decides how many
rows one verify retires.  Drafters live in :mod:`repro_torch.serving.drafters`.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["SpecConfig", "accept_blocks"]


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Parsed ``ServingEngine(spec=...)`` knob.

    ``drafter``: ``"ngram"`` (lookahead over the emitted stream) or
    ``"rns"`` (a reduced-moduli residue draft model derived from the
    target's resident planes).  ``k``: draft tokens per verify.
    ``ngram_n``: context length of the n-gram match.  ``draft_qbits`` /
    ``draft_mset``: the rns drafter's weight width and moduli set
    (``None``: P16).
    """

    drafter: str = "ngram"
    k: int = 4
    ngram_n: int = 2
    draft_qbits: int = 3
    draft_mset: object | None = None

    def __post_init__(self):
        if self.drafter not in ("ngram", "rns"):
            raise ValueError(
                f"spec drafter must be 'ngram' or 'rns', got {self.drafter!r}")
        if self.k < 1:
            raise ValueError(f"spec k must be >= 1, got {self.k}")

    @classmethod
    def parse(cls, spec) -> "SpecConfig":
        """Accept a SpecConfig, or a ``"drafter"`` / ``"drafter:k"`` string."""
        if isinstance(spec, cls):
            return spec
        if not isinstance(spec, str):
            raise TypeError(
                f"spec must be a SpecConfig or string, got {type(spec)}")
        name, _, karg = spec.partition(":")
        return cls(drafter=name, k=int(karg)) if karg else cls(drafter=name)


def accept_blocks(drafts: torch.Tensor, greedy: torch.Tensor, *,
                  eos: torch.Tensor, budget: torch.Tensor,
                  live: torch.Tensor):
    """The greedy acceptance rule on device tensors.

    ``drafts (B, k)``: the proposals; ``greedy (B, k+1)``: row ``j`` is the
    target's argmax after ``t_0, d_1..d_j``; ``eos (B,)``: per-slot stop
    token (< 0: none); ``budget (B,)``: tokens the slot may still emit;
    ``live (B,)`` bool.

    Returns ``(m, n_acc)`` int64: ``m`` tokens of ``greedy`` to emit per
    slot (0 for dead slots, else >= 1: the longest matching draft prefix
    plus the correction or bonus token, clamped by the budget and cut just
    past the first EOS), and ``n_acc``, the accepted-draft count before
    clamping.
    """
    k = drafts.shape[1]
    match = (drafts == greedy[:, :k]).long()
    # longest all-accepted prefix: cumprod turns the first mismatch into 0s
    n_acc = torch.cumprod(match, dim=1).sum(dim=1)
    m = torch.minimum(n_acc + 1, budget.long())
    j = torch.arange(k + 1, device=greedy.device)[None, :]
    eos = eos.long()
    is_eos = (eos[:, None] >= 0) & (greedy == eos[:, None])
    eos_pos = torch.where(is_eos, j, k + 1).amin(dim=1)
    m = torch.minimum(m, eos_pos + 1)          # emit through the EOS, stop
    m = torch.where(live, m, torch.zeros_like(m))
    return m, n_acc
