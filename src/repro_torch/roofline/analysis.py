"""Roofline analysis: ring-model collective bytes and the three-term model
(port of ``repro/roofline/analysis.py``, with the card's peaks of
``roofline/hw.py`` and the counts of ``roofline/op_cost.py`` in place of
the TPU's and of parsed HLO).

Terms (seconds, one step, one card: the dry run counts rank 0's program,
so its counts are per card):

  compute    = Σ_kind ops_kind / peak_kind
  memory     = bytes / HBM bandwidth
  collective = ring bytes / NVLink bandwidth (one direction)

:func:`ring_bytes` is the ring algorithm's bytes a member moves for one
collective whose result is ``out_bytes`` over a group of ``g``:

  all-gather          out_bytes * (g-1)/g
  reduce-scatter      out_bytes * (g-1)       (out is the scattered shard)
  all-reduce          2 * out_bytes * (g-1)/g
  all-to-all          out_bytes * (g-1)/g
  collective-permute  out_bytes

MODEL_FLOPS (``launch/params.py``) over the counted operations gives the
"useful compute" ratio that flags remat and redundant work.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.roofline import hw

__all__ = ["COLLECTIVES", "ring_bytes", "roofline_terms", "CellRoofline",
           "summarize_cell"]

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def ring_bytes(collective: str, out_bytes: int, g: int) -> int:
    """Bytes one member of a group of ``g`` moves for ``collective`` with
    an ``out_bytes`` result (module docstring); 0 for a group of one."""
    if collective not in COLLECTIVES:
        raise ValueError(f"unknown collective {collective!r}; expected one "
                         f"of {COLLECTIVES}")
    if g <= 1:
        return 0
    if collective in ("all-gather", "all-to-all"):
        return out_bytes * (g - 1) // g
    if collective == "reduce-scatter":
        return out_bytes * (g - 1)
    if collective == "all-reduce":
        return 2 * out_bytes * (g - 1) // g
    return out_bytes


def roofline_terms(ops_by_kind: dict[str, float], bytes_dev: float,
                   coll_bytes_dev: float) -> tuple[float, float, float]:
    """(compute, memory, collective) seconds of one card's step."""
    compute = sum(n / hw.PEAK[k] for k, n in ops_by_kind.items())
    return compute, bytes_dev / hw.HBM_BW, coll_bytes_dev / hw.NVLINK_BW


@dataclasses.dataclass
class CellRoofline:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    ops_dev: float
    bytes_dev: float
    coll_bytes_dev: float
    model_flops_total: float
    useful_ratio: float
    peak_fraction: float

    def row(self) -> str:
        return (f"| {self.arch} | {self.shape} | {self.mesh} "
                f"| {self.compute_s*1e3:.2f} | {self.memory_s*1e3:.2f} "
                f"| {self.collective_s*1e3:.2f} | {self.bottleneck} "
                f"| {self.useful_ratio:.4f} | {self.peak_fraction:.2e} |")


def summarize_cell(record: dict[str, Any]) -> CellRoofline:
    """The roofline summary of one dry-run record (its ``op_cost``
    block).  ``useful_ratio`` is MODEL_FLOPS over the operations every card
    counts; ``peak_fraction`` is MODEL_FLOPS per card-second of the modelled
    step over the **bf16** peak, as the reference's share is over its bf16
    peak."""
    oc = record["op_cost"]
    c, m, n = roofline_terms(oc["ops"], oc["bytes"], oc["coll_bytes"])
    dominant = max((("compute", c), ("memory", m), ("collective", n)),
                   key=lambda kv: kv[1])[0]
    n_chips = record["n_devices"]
    ops_dev = float(sum(oc["ops"].values()))
    mf = record.get("model_flops_total", 0.0)
    useful = mf / max(ops_dev * n_chips, 1.0)
    step_time = max(c, m, n)
    peak_frac = (mf / n_chips / max(step_time, 1e-12)) / hw.PEAK_FLOPS_BF16
    return CellRoofline(
        arch=record["arch"], shape=record["shape"], mesh=record["mesh"],
        compute_s=c, memory_s=m, collective_s=n, bottleneck=dominant,
        ops_dev=ops_dev, bytes_dev=oc["bytes"],
        coll_bytes_dev=oc["coll_bytes"], model_flops_total=mf,
        useful_ratio=useful, peak_fraction=peak_frac)
