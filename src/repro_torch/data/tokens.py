"""Deterministic synthetic LM token pipeline (a copy of
``repro/data/tokens.py``; numpy only).

Every batch is a pure function of ``(seed, step)``: no filesystem, no
state.  After a checkpoint restore the pipeline regenerates exactly the
batches the lost run would have produced, so a restart continues on the
same data.

The stream is learnable: the next token follows a fixed affine map
``(a * token + c) % vocab`` with occasional random tokens, so a few hundred
training steps show a clearly falling loss.  Per-host slicing carves the
global batch by ``host_id``.  Batches equal the reference's byte for byte.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

__all__ = ["TokenPipeline"]


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.05       # fraction of random next tokens
    host_id: int = 0
    n_hosts: int = 1

    def __post_init__(self):
        assert self.global_batch % self.n_hosts == 0

    @property
    def host_batch(self) -> int:
        return self.global_batch // self.n_hosts

    @property
    def _affine(self) -> tuple[int, int]:
        """The stream's fixed next-token map, from the seed alone."""
        rng = np.random.default_rng(self.seed * 7_919 + 13)
        a = 3 + 2 * int(rng.integers(0, max(self.vocab // 8, 2)))
        c = int(rng.integers(1, self.vocab))
        return a, c

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """The host-local batch for ``step``: ``{"tokens", "labels"}``
        int32 (B, seq_len), ``labels[t] = tokens[t + 1]``; a row's last
        label is the walk's next value."""
        a, c = self._affine
        rows = []
        base = self.host_id * self.host_batch
        for b in range(self.host_batch):
            rng = np.random.default_rng(
                (self.seed * 1_000_003 + step) * 131_071 + base + b)
            x = int(rng.integers(0, self.vocab))
            seq = np.empty(self.seq_len + 1, np.int64)
            noise_mask = rng.random(self.seq_len + 1) < self.noise
            for t in range(self.seq_len + 1):
                seq[t] = x
                if noise_mask[t]:
                    x = int(rng.integers(0, self.vocab))
                else:
                    x = (a * x + c) % self.vocab
            rows.append(seq)
        arr = np.stack(rows).astype(np.int32)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
