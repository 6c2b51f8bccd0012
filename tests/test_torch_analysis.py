"""The port's analysis layer against the JAX package: the shape cells,
parameter / FLOP accounting, ``Model.input_specs``, the ring-model
collective bytes, the H100 bounds of the kernel table, the meta backend of
every registered op, and the work counter (``roofline/op_cost.py``) giving
one count for one step on the CPU and on the meta device."""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.launch import params as jparams
from repro.models.api import build_model as jbuild_model
from repro.roofline.analysis import collective_bytes
from repro_torch.configs import (ARCH_IDS, SHAPES, all_cells, cells_for,
                                 get_config)
from repro_torch.core.moduli import P21
from repro_torch.kernels import flash_attn as fa
from repro_torch.kernels import rns_matmul as rm
from repro_torch.kernels import sd_add as sa
from repro_torch.kernels import sdrns_matmul as sm
from repro_torch.launch import params
from repro_torch.models.api import build_model, resolve_device
from repro_torch.numerics import kv_pages as kvp
from repro_torch.numerics import registry
from repro_torch.roofline import hw, op_cost
from repro_torch.roofline.analysis import COLLECTIVES, ring_bytes
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import OptConfig, init_opt_state

from torch_threads import one_thread  # noqa: F401

# qwen3-8b's matmul shapes (K, N) and their launches a layer, the logits once
QWEN3_LAYER = [((4096, 4096), 2), ((4096, 1024), 2), ((4096, 12288), 2),
               ((12288, 4096), 1)]
QWEN3_LOGITS = (4096, 151936)


# ---- shape cells and accounting ---------------------------------------------

def test_shapes_and_cells_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    assert list(all_cells()) == list(jbase.all_cells())
    for arch in ARCH_IDS:
        assert cells_for(arch) == jbase.cells_for(arch)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("reduced", [False, True])
def test_param_and_flop_accounting_match_reference(arch, reduced):
    cfg, jcfg = get_config(arch), jbase.get_config(arch)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert params.param_counts(cfg) == jparams.param_counts(jcfg)
    assert params.active_param_count(cfg) == \
        jparams.active_param_count(jcfg)
    for name in SHAPES:
        assert params.model_flops_total(cfg, SHAPES[name]) == \
            jparams.model_flops_total(jcfg, jbase.SHAPES[name])


_DT = {jnp.dtype(jnp.int32): torch.int32,
       jnp.dtype(jnp.bfloat16): torch.bfloat16}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch):
    """Keys, shapes and dtypes of every kind, as meta tensors."""
    cfg = get_config(arch)
    ours = build_model(cfg, device="meta")
    ref = jbuild_model(jbase.get_config(arch))
    for name, shape in SHAPES.items():
        got = ours.input_specs(shape)
        want = ref.input_specs(jbase.SHAPES[name])
        assert list(got) == list(want), (arch, name)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape), (arch, name, k)
            assert t.dtype == _DT[jnp.dtype(want[k].dtype)], (arch, name, k)


def test_meta_device_is_asked_for_by_name():
    assert resolve_device("meta").type == "meta"
    assert registry.backend_for("meta") == "meta"
    with pytest.raises(ValueError):
        registry.backend_for("xpu")


# ---- ring-model collective bytes ----------------------------------------------

@pytest.mark.parametrize("g", [2, 3, 16])
@pytest.mark.parametrize("op", COLLECTIVES)
def test_ring_bytes_match_reference(op, g):
    """``ring_bytes`` against the reference's parser of the same op."""
    for shape in ((128, 64), (3, 5, 7), (1,)):
        out = int(np.prod(shape)) * 4
        dims = ",".join(map(str, shape))
        line = (f"  %c = f32[{dims}]{{0}} {op}(f32[{dims}]{{0}} %x), "
                f"replica_groups=[{16 // g if 16 % g == 0 else 1},{g}]"
                f"<=[{g}]")
        assert collective_bytes(line)[op]["bytes"] == \
            ring_bytes(op, out, g), (op, g, shape)
    assert ring_bytes(op, 1024, 1) == 0


# ---- bounds of the kernel table (PERF.md section 6) ---------------------------

def test_kernel_table_bounds():
    """The cost functions give the kernel table's bounds on the card's
    data-sheet peaks (hw.py)."""
    C = P21.num_channels
    ms, by = op_cost.bound_ms(*_bytes_ops(
        op_cost.rns_matmul_work(C, 2048, 4096, 12288)))
    assert (round(ms, 4), by) == (0.3125, "operations")
    step = [((K, N), 36 * n) for (K, N), n in QWEN3_LAYER] + \
        [(QWEN3_LOGITS, 1)]
    total, bys = 0.0, set()
    for (K, N), n in step:
        ms, by = op_cost.bound_ms(*_bytes_ops(
            op_cost.rns_matmul_work(C, 8, K, N)))
        total += n * ms
        bys.add(by)
    assert (round(total, 3), bys) == (6.831, {"bytes"})
    ms, by = op_cost.bound_ms(*_bytes_ops(
        op_cost.sd_add_work(C * 4096 * 4096, 7, 7)))
    assert (round(ms, 4), by) == (0.3155, "bytes")
    # B2: B 8, S 256, H 32, Kv 8, hd 128, bf16, causal
    q = torch.empty((8, 256, 32, 128), dtype=torch.bfloat16, device="meta")
    k = torch.empty((8, 256, 8, 128), dtype=torch.bfloat16, device="meta")
    ms, by = op_cost.bound_ms(*_bytes_ops(op_cost.COSTS["flash_attention"](
        q, k, k, None, causal=True)))
    assert (round(ms, 4), by) == (0.0125, "bytes")
    # B3: B 8, H 32, Kv 8, hd 128, ps 64, 5 pages a slot, 1389 rows, rns8
    fmt = kvp.KV_FORMATS["rns8"]
    gen = torch.Generator().manual_seed(0)
    tab = (1 + torch.randperm(40, generator=gen)).reshape(8, 5).to(
        torch.int32)
    kv_len = torch.tensor([1, 320, 200, 150, 118, 300, 100, 200],
                          dtype=torch.int32)
    assert int(kv_len.sum()) == 1389
    pages = torch.empty((41, 64, 8, 128), dtype=torch.uint8)
    scale = torch.empty((41, 64, 8, 1))
    q = torch.empty((8, 32, 128), dtype=torch.bfloat16)
    work = op_cost.COSTS["paged_decode"](q, pages, pages, scale, scale, tab,
                                         kv_len, 64, fmt.pack)
    ms, by = op_cost.bound_ms(*_bytes_ops(work))
    assert (round(ms, 5), by, work.kind) == (0.00109, "bytes", "f32")
    # a folded verify reads each slot's pages once for its rows
    folded = op_cost.COSTS["paged_decode"](
        q.repeat_interleave(2, 0), pages, pages, scale, scale,
        tab.repeat_interleave(2, 0), kv_len.repeat_interleave(2), 64,
        fmt.pack)
    assert folded.ops == 2 * work.ops
    assert folded.bytes - work.bytes == (8 * 32 * 128 * 2
                                         + 4 * 8 * 32 * 5 * 130 + 4 * 8)


def _bytes_ops(w):
    return w.bytes, w.ops, w.kind


def test_hw_constants():
    assert hw.PEAK == {"int8": 1979e12, "bf16": 989e12, "tf32": 495e12,
                       "f32": 67e12}
    assert (hw.HBM_BW, hw.HBM_BYTES, hw.NVLINK_BW) == (3.35e12, 80 * 10**9,
                                                       450e9)


# ---- the meta backend -----------------------------------------------------------

def _meta(*xs):
    return [x.to("meta") if isinstance(x, torch.Tensor) else x for x in xs]


def _same_layout(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "meta"
        assert (g.shape, g.dtype, g.stride()) == (w.shape, w.dtype,
                                                  w.stride())


def test_meta_outputs_match_plain_versions():
    """Every registered op's meta implementation returns the plain
    version's shapes, dtypes and strides."""
    gen = torch.Generator().manual_seed(1)
    a = torch.randint(-60, 61, (3, 5, 24), generator=gen).to(torch.int8)
    b = torch.randint(-60, 61, (3, 24, 7), generator=gen).to(torch.int8)
    _same_layout(rm.rns_matmul_meta(*_meta(a, b), P21.moduli),
                 rm.rns_matmul_ref(a, b, P21.moduli))
    _same_layout(rm.rns_matmul_meta(*_meta(a[None], b[None]), P21.moduli),
                 rm.rns_matmul_ref(a[None], b[None], P21.moduli))
    ad = torch.randint(-1, 2, (3, 2, 6, 7), generator=gen).to(torch.int8)
    bd = torch.randint(-1, 2, (3, 6, 4, 7), generator=gen).to(torch.int8)
    ws = (1, 0, -1)
    _same_layout(sm.sdrns_matmul_meta(*_meta(ad, bd), ws),
                 sm.sdrns_matmul_ref(ad, bd, ws))
    for kind in sa.KINDS:
        _same_layout(sa.sd_add_meta(*_meta(ad, ad), kind),
                     sa.sd_add_ref(ad, ad, kind))
    q = torch.randn(2, 5, 4, 8, generator=gen)
    k = torch.randn(2, 7, 2, 8, generator=gen)
    _same_layout(fa.flash_attention_meta(*_meta(q, k, k)),
                 fa.flash_attention_ref(q, k, k))
    kv_len = torch.tensor([3, 7], dtype=torch.int32)
    _same_layout(fa.flash_decode_meta(*_meta(q[:, 0], k, k, kv_len), 4),
                 fa.flash_decode_ref(q[:, 0], k, k, kv_len, 4))
    fmt = kvp.KV_FORMATS["rns8r"]
    pool = kvp.make_paged_kv(1, 5, 4, 2, 8, fmt=fmt, device="cpu")
    lay = kvp.layer_slice(pool, 0)
    r = fmt.redundant
    tab = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    args = (lay.k.planes.select(-3, 0), lay.v.planes.select(-3, 0),
            lay.k.scale, lay.v.scale, tab, kv_len, 4, fmt.pack,
            lay.k.planes.narrow(-3, 1, r), lay.v.planes.narrow(-3, 1, r),
            fmt.mset.redundant_moduli)
    _same_layout(fa.paged_decode_meta(*_meta(q[:, 0], *args)),
                 fa.paged_decode_ref(q[:, 0], *args))
    _same_layout(fa.paged_decode_meta(*_meta(q[:, 0], *args[:8])),
                 fa.paged_decode_ref(q[:, 0], *args[:8]))


# ---- the work counter ------------------------------------------------------------

def _count_steps(arch, system, device):
    cfg = get_config(arch).reduced()
    model = build_model(cfg, system=system, device=device)
    p = model.init(0)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 8)), device=device)
    with op_cost.OpCost() as pre:
        _, cache = model.prefill(p, tokens, s_max=16)
    with op_cost.OpCost() as dec:
        model.decode(p, tokens[:, :1], cache, 8)
    return pre.as_dict(), dec.as_dict()


@pytest.mark.parametrize("arch,system", [
    ("qwen3-8b", "bns"), ("qwen3-8b", "rns"), ("qwen3-8b", "sdrns"),
    ("moonshot-v1-16b-a3b", "rns")])
def test_counts_equal_on_cpu_and_meta(arch, system):
    """One reduced prefill and decode step counts the same, op by op and
    kind by kind, on the CPU (plain versions) and on the meta device."""
    cpu, meta = _count_steps(arch, system, "cpu"), \
        _count_steps(arch, system, "meta")
    assert cpu == meta
    pre, dec = cpu
    kernel = "rns_matmul" if system == "rns" else (
        "sdrns_matvec" if system == "sdrns" else None)
    if kernel:
        assert dec["launches"][kernel] == 15
        assert dec["ops"]["int8"] > 0
    assert pre["launches"]["flash_attention"] == 2
    assert dec["launches"]["flash_decode"] == 2
    # the plain versions' own aten ops are not counted on top
    assert "aten.fmod" not in pre["by_op"]


def _train_count(remat):
    cfg = dataclasses.replace(get_config("qwen3-8b").reduced(), remat=remat)
    model = build_model(cfg, system="rns", device="meta")
    p = model.init(0, prepare=False)
    opt = OptConfig()
    batch = model.input_specs(dataclasses.replace(SHAPES["train_4k"],
                                                  seq_len=16,
                                                  global_batch=2))
    with op_cost.OpCost() as c:
        make_train_step(model, opt)(p, init_opt_state(p, opt), batch)
    return c


def test_remat_increases_flops():
    """The twin of tests/test_hlo_cost.py::test_remat_increases_flops: the
    recomputed forward counts again."""
    plain, remat = _train_count(False), _train_count(True)
    assert remat.ops["int8"] > plain.ops["int8"]
    assert sum(remat.ops.values()) > sum(plain.ops.values())
    assert remat.launches["rns_matmul"] > plain.launches["rns_matmul"]


def test_meta_paged_decode_needs_lengths():
    """Work that depends on lengths a meta tensor does not hold raises;
    lengths held on the host beside meta operands are read."""
    q = torch.empty((2, 4, 8), device="meta")
    pages = torch.empty((5, 4, 2, 8), device="meta")
    tab = torch.empty((2, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        op_cost.COSTS["paged_decode"](q, pages, pages, None, None, tab,
                                      tab[:, 0], 4)
    with pytest.raises(ValueError, match="meta"):
        op_cost.COSTS["flash_decode"](q, pages, pages, tab[:, 0], 4)
    w = op_cost.COSTS["flash_decode"](
        q, pages, pages, torch.tensor([3, 5], dtype=torch.int32), 4)
    assert w.ops == 4 * 8 * 4 * (3 + 4)
