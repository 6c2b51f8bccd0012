"""Requests for a served model (mixes of ``"kind": "requests"``): it reads
a mix's data file (``perfbench/traffic/<mix>.json``) and makes the run's
prompts and budgets from the seed.

Every seed gets the same work, in another order.  The sizes of job ``k``
do not depend on the seed:

* prompt lengths are the ``job_size`` quantiles of the mix's distribution
  (``loguniform`` or ``uniform`` between ``lo`` and ``hi``), cut into
  ``strata`` bands; each consecutive group of ``strata`` requests holds
  one length from each band;
* budgets (new tokens a request may emit) come in classes of given shares,
  each class's budgets the quantiles of its own range, dealt to the
  requests.

Both deals are fixed for each job.  The seed orders the arrivals within
each group (which slot a request lands in, when a group is admitted
together) and draws the token ids, uniform over the vocabulary.  A window
sees only the first groups of a job, so a seed that changed the sizes
would change the work a window does.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from harness.weights import block_seed


@dataclasses.dataclass
class Req:
    rid: int
    tokens: np.ndarray     # (prompt_len,) int32
    max_new: int


def _quantiles(spec: dict, n: int) -> np.ndarray:
    lo, hi = spec["lo"], spec["hi"]
    u = (np.arange(n) + 0.5) / n
    if spec.get("dist", "uniform") == "loguniform":
        v = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    else:
        v = lo + u * (hi - lo)
    return np.clip(np.rint(v), lo, hi).astype(np.int64)


def sizes(mix: dict, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Job ``k``'s (prompt lengths, budgets) in groups of ``strata``, the
    same for every seed."""
    n, m = mix["job_size"], mix["strata"]
    if n % m:
        raise ValueError(f"job_size {n} is not a multiple of strata {m}")
    deal = np.random.default_rng(k)
    bands = np.sort(_quantiles(mix["prompt"], n)).reshape(m, n // m)
    bands = np.stack([deal.permutation(b) for b in bands])   # (m, n / m)
    lens = bands.T.reshape(-1)          # group g: one length from each band
    classes = mix["budget"]
    total = sum(c["share"] for c in classes)
    counts = [n * c["share"] // total for c in classes]
    counts[0] += n - sum(counts)
    news = deal.permutation(np.concatenate(
        [_quantiles(c, j) for c, j in zip(classes, counts)]))
    return lens, news


def job(mix: dict, seed: int, k: int, vocab: int, *,
        tag: str = "job") -> list[Req]:
    """Job ``k`` of the run: ``job_size`` requests in arrival order."""
    lens, news = sizes(mix, k)
    m = mix["strata"]
    rng = np.random.default_rng(block_seed(seed, "traffic", tag, k))
    order = np.concatenate([g * m + rng.permutation(m)
                            for g in range(len(lens) // m)])
    lens, news = lens[order], news[order]
    ids = np.random.default_rng(block_seed(seed, "ids", tag, k)).integers(
        0, vocab, size=int(lens.sum()), dtype=np.int64).astype(np.int32)
    out, at = [], 0
    for i, (n, b) in enumerate(zip(lens, news)):
        out.append(Req(k * len(lens) + i, ids[at: at + n].copy(), int(b)))
        at += n
    return out


def most_new(mix: dict) -> int:
    """The largest budget of the mix."""
    return max(c["hi"] for c in mix["budget"])


def longest(mix: dict) -> int:
    """Most KV positions a request of the mix holds."""
    return mix["prompt"]["hi"] + most_new(mix)
