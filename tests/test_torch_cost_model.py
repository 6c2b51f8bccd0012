"""Port parity: the paper's delay / energy model (``core/cost_model.py``).

The port keeps its own copy of the framework-free reference module; every
function must return the reference's values (the same floats, compared
with ``==``) on a grid of systems x precisions x (adds, muls) mixes.
"""
from __future__ import annotations

import dataclasses
import itertools

import pytest

from repro.core import cost_model as jcm
from repro_torch.core import cost_model as tcm

from torch_threads import one_thread  # noqa: F401

SYSTEMS = ("BNS", "RNS", "SD", "SD-RNS")
MIXES = [(0, 0), (0, 1), (1, 0), (10, 10), (100, 5), (5, 100), (1e4, 1e4),
         (4.0, 64.0), (64.0, 1024.0), (4096.0, 65536.0), (3.5, 0.25),
         (1e6, 1e6)]


def test_tables_and_constants_equal():
    for name in ("PRECISIONS", "TABLE_I", "SYSTEMS", "ADD_LEVELS",
                 "MUL_LEVELS", "MIX_LEVELS", "PAPER_TABLE_II",
                 "ENERGY_POWER_FACTOR"):
        assert getattr(tcm, name) == getattr(jcm, name), name
    assert tcm.__all__ == jcm.__all__


def _outcome(fn, *args):
    """The value, or the type of what it raised (BNS's 0-delay mix)."""
    try:
        return fn(*args)
    except ZeroDivisionError as e:
        return type(e)


@pytest.mark.parametrize("precision", sorted(jcm.PRECISIONS))
def test_eq3_speedup_energy_on_grid(precision):
    for system in SYSTEMS:
        assert dataclasses.asdict(tcm.delays_for(system, precision)) == \
            dataclasses.asdict(jcm.delays_for(system, precision))
        assert tcm.conversion_costs(system, precision) == \
            jcm.conversion_costs(system, precision)
        for x, y in MIXES:
            assert tcm.eq3_total(system, precision, x, y) == \
                jcm.eq3_total(system, precision, x, y)
            assert tcm.delays_for(system, precision).total(x, y) == \
                jcm.delays_for(system, precision).total(x, y)
            assert tcm.energy_total(system, precision, x, y) == \
                jcm.energy_total(system, precision, x, y)
    for (base, cand), (x, y) in itertools.product(
            itertools.permutations(SYSTEMS, 2), MIXES):
        for name in ("speedup", "energy_reduction_vs"):
            assert _outcome(getattr(tcm, name), base, cand, precision, x,
                            y) == _outcome(getattr(jcm, name), base, cand,
                                           precision, x, y)


@pytest.mark.parametrize("precision", sorted(jcm.PRECISIONS))
def test_selection_equal(precision):
    for (x, y), tie in itertools.product(MIXES, (1.0, 1.10, 1.16, 1.5)):
        assert tcm.select_number_system(x, y, precision, tie_factor=tie) == \
            jcm.select_number_system(x, y, precision, tie_factor=tie)
        for cands in (("RNS", "SD-RNS"), ("BNS", "SD"), SYSTEMS):
            assert tcm.select_number_system(
                x, y, precision, tie_factor=tie, candidates=cands) == \
                jcm.select_number_system(x, y, precision, tie_factor=tie,
                                         candidates=cands)
    for tie in (1.10, 1.16):
        assert tcm.selection_matrix(precision, tie_factor=tie) == \
            jcm.selection_matrix(precision, tie_factor=tie)
    levels = {"a": 1.0, "b": 300.0}
    assert tcm.selection_matrix(precision, add_levels=levels,
                                mul_levels=levels) == \
        jcm.selection_matrix(precision, add_levels=levels, mul_levels=levels)


def test_errors_equal():
    for fn, args in ((tcm.delays_for, ("SD", 20)),
                     (tcm.conversion_costs, ("TNS", 16)),
                     (tcm.speedup, ("BNS", "BNS", 16, 0, 0))):
        jfn = getattr(jcm, fn.__name__)
        with pytest.raises(Exception) as te:
            fn(*args)
        with pytest.raises(Exception) as je:
            jfn(*args)
        assert type(te.value) is type(je.value)
        assert str(te.value) == str(je.value)
