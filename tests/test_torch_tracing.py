"""The port's spans and counters (``repro_torch.tracing``) on the CPU.

* With no profiler recording, a span or count records nothing and touches
  no profiler API or CUDA event.
* Under ``torch.profiler`` a tiny paged admission and tiny rns and sdrns
  CNN forwards leave their spans in the trace as user annotations (the
  numerics spans inside ``engine.prefill``), one ``numerics.decode`` a K
  segment run and one a product's rescale, one ``numerics.weight_encode``
  a per-call product, the engine's counters equal to the prefill's rows
  and prompt tokens, and ``numerics.decode_eager`` to the elements the rns
  runner decoded (each K segment's; the CPU has no B9).
* Outputs are bit-identical with tracing on and off, and a session read
  after it ends is not mixed into the next one.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.data import cifar
from repro_torch.models import linear
from repro_torch.models.api import build_model
from repro_torch.numerics import runners
from repro_torch.serving.engine import ServingEngine

from torch_threads import one_thread  # noqa: F401

# K 2048 in the first fc layer: two K segments at 6 bits on P21
CNN = cifar.CnnSpec("tiny", (("conv", 8, 3, 1), ("pool", 2), ("fc", 16),
                             ("fc", 10)))
NUMERICS = ("numerics.encode", "numerics.decode")
ENGINE = ("engine.admit_prefill", "engine.pages", "engine.prefill",
          "engine.scatter")


def _profiled(fn):
    """``fn()`` under a CPU profiler; (its result, the trace's user
    annotations as (start, end, name), the tracing snapshot)."""
    tracing.snapshot()          # closes whatever an earlier test left open
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
             for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()]
    return out, spans, tracing.snapshot()


@pytest.fixture
def counted(monkeypatch):
    """Counts the K segments the runners cut, the quantized products
    (``linear._qmatmul_resident``) and per-call ``dense`` calls made, and
    the output elements ``runners._rns_local`` decodes (each segment's)."""
    n = {"segments": 0, "products": 0, "dense": 0, "decoded": 0}

    def wrap(mod, name, key, size=None):
        fn = getattr(mod, name)

        def counting(*a, **k):
            out = fn(*a, **k)
            n[key] += 1 if size is None else size(out)
            return out
        monkeypatch.setattr(mod, name, counting)

    wrap(runners, "rns_segments", "segments", len)
    wrap(runners, "sdrns_segments", "segments", len)
    wrap(linear, "_qmatmul_resident", "products")
    wrap(linear, "dense", "dense")
    local = runners._rns_local

    def decoding(a, b_res, segs, *rest):
        out = local(a, b_res, segs, *rest)
        n["decoded"] += len(segs) * out.numel()
        return out
    monkeypatch.setattr(runners, "_rns_local", decoding)
    return n


def _cnn(system: str):
    params = cifar.init_cnn(torch.Generator().manual_seed(3), CNN, "cpu")
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(4))
    kw = {"system": system, "bits": 6, "compute_dtype": torch.float32}

    def run():
        with torch.no_grad():
            return cifar.cnn_forward(params, CNN, x, dense_kw=kw)
    return run


def _engine():
    cfg = dataclasses.replace(get_config("qwen3-8b").reduced(),
                              compute_dtype="float32")
    model = build_model(cfg, system="rns", device="cpu")
    params = model.init(seed=5)
    return lambda: ServingEngine(model, params, batch=3, s_max=32,
                                 page_size=8, kv_format="rns8",
                                 device="cpu")


LENS = (13, 5, 21)


def _admit(engine):
    rng = np.random.default_rng(6)
    toks = {s: rng.integers(1, 500, n) for s, n in enumerate(LENS)}
    out = engine.admit_prefill(toks, {s: 32 for s in toks})
    kv = engine.pool.kv
    return ({s: out[s][0] for s in out},
            [t.clone() for t in (kv.k.planes, kv.k.scale, kv.v.planes,
                                 kv.v.scale)])


def _inside(inner, outer) -> bool:
    return all(any(a0 <= a and b <= b0 for a0, b0, _ in outer)
               for a, b, _ in inner)


def test_off_records_nothing_and_calls_no_profiler(monkeypatch):
    before = tracing.snapshot()

    def refuse(*a, **k):
        raise AssertionError("a profiler API was called with tracing off")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert tracing.span("numerics.encode") is tracing.span("engine.pages")
    with tracing.span("numerics.decode"):
        tracing.count("engine.prefill_rows", 7)
    _cnn("rns")()
    assert tracing.snapshot() == before


@pytest.mark.parametrize("system", ["rns", "sdrns"])
def test_cnn_spans(system, counted):
    run = _cnn(system)
    off = run()
    on, spans, snap = _profiled(run)
    assert torch.equal(on, off)
    s = snap["spans"]
    names = {n for _, _, n in spans}
    assert {"numerics.encode", "numerics.decode",
            "numerics.weight_encode"} <= names
    dense = counted["dense"] // 2           # the same forward twice
    segs = counted["segments"] // 2
    assert dense == 3 and counted["products"] // 2 == dense
    assert segs == 4                        # K 27, 2048 (two), 16
    assert s["numerics.weight_encode"]["calls"] == dense
    # the activation's residue (or digit) encode, one a product
    assert s["numerics.encode"]["calls"] == dense
    # each segment's decode and sum, and each product's rescale
    assert s["numerics.decode"]["calls"] == segs + dense
    for rec in s.values():
        assert 0 <= rec["self_s"] <= rec["host_s"] + 1e-9
        assert rec["stream_s"] == pytest.approx(rec["host_s"])
    # the rns products' decodes, all eager on the CPU (the plain B9)
    decoded = counted["decoded"] // 2
    assert decoded == (2 * 32 * 32 * 8 + 2 * 2 * 16 + 2 * 10
                       if system == "rns" else 0)
    assert snap["counters"] == ({"numerics.decode_eager": decoded}
                                if decoded else {})


def test_admission_spans_and_counters(counted):
    make = _engine()
    logits_off, pages_off = _admit(make())
    engine = make()
    (logits_on, pages_on), spans, snap = _profiled(lambda: _admit(engine))
    for s in logits_off:
        np.testing.assert_array_equal(logits_on[s], logits_off[s])
    for a, b in zip(pages_on, pages_off):
        assert torch.equal(a, b)
    by = {n: [sp for sp in spans if sp[2] == n]
          for n in NUMERICS + ENGINE}
    assert all(len(by[n]) > 0 for n in by), {n: len(v) for n, v in by.items()}
    prefill = by["engine.prefill"]
    assert _inside(by["numerics.encode"] + by["numerics.decode"], prefill)
    assert _inside(prefill + by["engine.pages"] + by["engine.scatter"],
                   by["engine.admit_prefill"])
    s = snap["spans"]
    assert s["engine.admit_prefill"]["calls"] == 1
    assert s["engine.scatter"]["calls"] == 1
    products = counted["products"] // 2
    assert s["numerics.encode"]["calls"] == products
    assert s["numerics.decode"]["calls"] == \
        counted["segments"] // 2 + products
    assert "numerics.weight_encode" not in s       # resident weights
    adm = s["engine.admit_prefill"]
    children = sum(s[n]["host_s"] for n in ENGINE[1:])
    assert adm["self_s"] == pytest.approx(adm["host_s"] - children)
    assert snap["counters"] == {"engine.prefill_rows": 3 * max(LENS),
                                "engine.prompt_tokens": sum(LENS),
                                "numerics.decode_eager":
                                    counted["decoded"] // 2}


def test_a_new_session_starts_over():
    _, _, first = _profiled(_cnn("rns"))
    assert first["spans"]["numerics.weight_encode"]["calls"] == 3

    def pages_only():
        with tracing.span("engine.pages"):
            tracing.count("engine.prompt_tokens", 4)
    _, _, second = _profiled(pages_only)
    assert set(second["spans"]) == {"engine.pages"}
    assert second["counters"] == {"engine.prompt_tokens": 4}
    assert tracing.snapshot() == second
    assert first["spans"]["numerics.weight_encode"]["calls"] == 3


def test_decode_counters():
    """The reverse conversion's two counters: in ``COUNTERS``, nothing
    while tracing is off, in the snapshot while it is on."""
    names = ("numerics.decode_kernel", "numerics.decode_eager")
    assert set(names) <= tracing.COUNTERS
    _, _, before = _profiled(lambda: None)
    for n in names:
        tracing.count(n, 5)
    assert tracing.snapshot() == before

    def both():
        tracing.count(names[0], 6)
        tracing.count(names[1], 7)
        tracing.count(names[0], 1)
    _, _, snap = _profiled(both)
    assert snap["counters"] == {names[0]: 7, names[1]: 7}


def test_names_are_a_fixed_set():
    def bad_span():
        with tracing.span("dense K=4608"):
            pass
    with pytest.raises(ValueError):
        _profiled(bad_span)
    with pytest.raises(ValueError):
        _profiled(lambda: tracing.count("engine.slots", 1))
