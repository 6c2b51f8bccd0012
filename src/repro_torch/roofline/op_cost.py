"""The work a step does, counted the same whatever runs it (the port's
counterpart of ``repro/roofline/hlo_cost.py``, which reads XLA's HLO text;
the port has none).

:class:`OpCost` is a context manager that sums, over what runs inside it,
the operations by kind (``"int8"``, ``"bf16"``, ``"tf32"``, ``"f32"``), the
HBM bytes, and the collectives' ring-model bytes by collective.  It counts
two things:

* **The registered kernel ops** (``numerics/registry.py``).  Each op has a
  cost function of its arguments (:data:`COSTS`) giving the work the
  algorithm needs for these inputs: each input byte read once, each output
  byte written once, masked and causal work left out as the inputs imply.
  While it counts, the counter is the registry's ``OBSERVER``: it adds an
  op's cost when the op is called, whichever implementation runs (the
  Hopper kernel, its plain version, or the meta one), and pauses the count
  inside, so the plain version's aten ops are never counted on top.  It is
  the collectives' ``OBSERVER`` too, for their ring-model bytes.
* **Everything else**, as aten ops (a ``TorchDispatchMode``): FLOPs of the
  matmul-class ops from ``torch.utils.flop_counter``'s formulas, of the
  kind of their operands' dtype (``tf32`` for f32 only where
  ``torch.backends.cuda.matmul.allow_tf32`` is set); bytes as what each op
  that is neither a view nor an allocation reads and writes
  (:func:`moved_bytes`).  Eager PyTorch fuses nothing, so each aten op is a
  top-level op: this is the eager form of ``hlo_cost.py``'s memory model.
  Elementwise FLOPs are left out, as there.

The count depends on shapes, dtypes and the lengths the step's inputs
imply, never on the device: the same step counts the same on the card, on
the CPU and on the meta device (the dry run).  A kernel op whose work
depends on values held in a tensor (a decode's ``kv_len``, a paged
decode's block table) reads them from a CPU or CUDA tensor; a meta tensor
holds none, so there the dense decode keeps its lengths on the host
(``numerics/attention.py::flash_decode``), and a paged decode raises.

The work functions (:func:`rns_matmul_work` and siblings) take shapes
alone, for bounds of launches that are not run (``chip_smoke.py``'s
kernel table, a decode step's B1 sum); :func:`bound_ms` turns a count into
the least time on the card (``roofline/hw.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.numerics import registry
from repro_torch.parallel import collectives
from repro_torch.roofline import hw
from repro_torch.roofline.analysis import ring_bytes

__all__ = ["KINDS", "Work", "bound_ms", "rns_matmul_work", "sdrns_work",
           "sd_add_work", "attention_work", "decode_work", "COSTS",
           "OpCost", "kind_of", "moved_bytes"]

KINDS = ("int8", "bf16", "tf32", "f32")


@dataclasses.dataclass(frozen=True)
class Work:
    """Operations of one kind and HBM bytes; ``op`` renames the counted op
    (the paged decode's syndrome mode counts as ``paged_decode_syndrome``,
    the name its kernel's launch counter has)."""

    ops: int
    bytes: int
    kind: str
    op: str | None = None

    def __add__(self, other: "Work") -> "Work":
        if other.kind != self.kind:
            raise ValueError(f"cannot add {self.kind} work to {other.kind}")
        return Work(self.ops + other.ops, self.bytes + other.bytes,
                    self.kind, self.op)


def bound_ms(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    """The least ms on the card: the larger of the bytes at the HBM rate
    and the operations at the kind's peak; and which one bounds."""
    t_bytes, t_ops = nbytes / hw.HBM_BW, ops / hw.PEAK[kind]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kind_of(dtype: torch.dtype) -> str:
    """The kind of a product of ``dtype`` operands."""
    if dtype in (torch.int8, torch.uint8):
        return "int8"
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        return "tf32"
    return "f32"


# ---------------------------------------------------------------------------
# Work of each kernel op, from shapes
# ---------------------------------------------------------------------------


def rns_matmul_work(C: int, M: int, K: int, N: int, *, stack: int = 1,
                    a_bytes: int = 1, b_bytes: int = 1) -> Work:
    """B1: ``stack`` x C channel products (M, K) x (K, N) of residues
    (``a_bytes`` / ``b_bytes`` a residue), int32 residues out."""
    return Work(2 * stack * C * M * K * N,
                stack * C * (M * K * a_bytes + K * N * b_bytes + 4 * M * N),
                "int8")


def sdrns_work(C: int, M: int, K: int, N: int, n: int) -> Work:
    """B6 / B7: C channel products of n-digit vectors (a byte a digit), the
    digit vectors of the (M, N) residues out."""
    return Work(2 * C * M * K * N, C * n * (M * K + K * N + M * N), "int8")


def sd_add_work(vectors: int, n: int, out_n: int) -> Work:
    """B8: two n-digit vectors in, one ``out_n``-digit vector out, each."""
    return Work(0, vectors * (2 * n + out_n), "int8")


def _causal_pairs(Sq: int, n: int) -> int:
    """Σ_{i < Sq} min(i + 1, n): the (query, key) pairs of queries at
    0..Sq-1 against n keys under the causal mask."""
    if n >= Sq:
        return Sq * (Sq + 1) // 2
    return n * (n + 1) // 2 + (Sq - n) * n


def attention_work(B: int, Sq: int, H: int, Kv: int, hd: int,
                   lengths: Sequence[int], *, causal: bool, esz: int,
                   kind: str, with_len: bool) -> Work:
    """B2: q in and out, each batch row's valid K and V rows read once; 4 hd
    operations a (query head, key) pair (QK and PV)."""
    pairs = H * sum(_causal_pairs(Sq, n) if causal else Sq * n
                    for n in lengths)
    nbytes = esz * (2 * B * Sq * H * hd + 2 * sum(lengths) * Kv * hd)
    return Work(4 * hd * pairs, nbytes + (4 * B if with_len else 0), kind)


def decode_work(*, q_bytes: int, B: int, H: int, Kv: int, hd: int,
                rows: int, read_rows: int, row_bytes: int, chunks: int,
                outs: int, index_bytes: int, kind: str) -> Work:
    """B3 / B4 / B5: q in; ``read_rows`` distinct valid K and V rows of
    ``row_bytes`` a KV head read once; ``outs`` f32 values a (slot, head,
    chunk) out (o, m, l and the syndrome); 4 hd operations a (query head,
    valid row) pair over ``rows`` (slot, row) pairs."""
    nbytes = (q_bytes + 2 * read_rows * Kv * row_bytes
              + 4 * B * H * chunks * outs + index_bytes)
    return Work(4 * hd * H * rows, nbytes, kind)


# ---------------------------------------------------------------------------
# Cost functions of the registered ops (their arguments as the registry
# passes them to an implementation)
# ---------------------------------------------------------------------------


def _values(t: torch.Tensor, what: str) -> list[int]:
    if t.device.type == "meta":
        raise ValueError(f"the work of this op depends on {what}, which a "
                         f"meta tensor does not hold")
    return [int(v) for v in t.reshape(-1).tolist()]


def _lengths(kv_len, B: int, T: int) -> list[int]:
    if kv_len is None:
        vals = [T] * B
    else:
        vals = _values(kv_len, "kv_len")
        vals = vals * B if len(vals) == 1 else vals
    return [max(0, min(int(n), T)) for n in vals]


def _nbytes(t: torch.Tensor | None) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def rns_matmul_cost(a_res, b_res, moduli, **_) -> Work:
    C, M, K = a_res.shape[-3:]
    stack = 1
    for d in a_res.shape[:-3]:
        stack *= d
    return rns_matmul_work(C, M, K, b_res.shape[-1], stack=stack,
                           a_bytes=a_res.element_size(),
                           b_bytes=b_res.element_size())


def sdrns_cost(a_dig, b_dig, ws, **_) -> Work:
    C, M, K, n = a_dig.shape
    return sdrns_work(C, M, K, b_dig.shape[2], n)


def sd_add_cost(x, y, kind, **_) -> Work:
    n = x.shape[-1]
    return sd_add_work(x.numel() // max(n, 1), n,
                       n + 1 if kind == "plain" else n)


def flash_attention_cost(q, k, v, kv_len=None, *, causal=True, **_) -> Work:
    B, Sq, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    return attention_work(B, Sq, H, Kv, hd, _lengths(kv_len, B, T),
                          causal=causal, esz=q.element_size(),
                          kind="bf16" if q.dtype == torch.bfloat16 else "f32",
                          with_len=kv_len is not None)


def flash_decode_cost(q, k, v, kv_len, bk, **_) -> Work:
    B, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    rows = sum(_lengths(kv_len, B, T))
    return decode_work(q_bytes=_nbytes(q), B=B, H=H, Kv=Kv, hd=hd,
                       rows=rows, read_rows=rows,
                       row_bytes=hd * k.element_size(), chunks=-(-T // bk),
                       outs=hd + 2, index_bytes=4 * B,
                       kind="f32" if k.dtype == torch.float32 else "bf16")


def _distinct_rows(tab: torch.Tensor, lens: list[int], ps: int
                   ) -> tuple[int, int]:
    """(valid (page, row) pairs read, block-table rows read): rows that
    share a page and an offset, and repeated block-table rows (a folded
    verify repeats a slot's row), are read once."""
    tab_h = tab.cpu().to(torch.int64)
    seen_rows: set[tuple] = set()
    pairs: set[tuple[int, int]] = set()
    for b, n in enumerate(lens):
        row = tuple(tab_h[b].tolist())
        seen_rows.add(row)
        for t in range(0, n, ps):
            pairs.update((row[t // ps], o) for o in range(min(ps, n - t)))
    return len(pairs), len(seen_rows)


def paged_decode_cost(q, k_pages, v_pages, k_scale, v_scale, tab, kv_len,
                      page_size, pack=None, k_wit=None, v_wit=None,
                      red_moduli=None, **_) -> Work:
    B, H, hd = q.shape
    Kv = k_pages.shape[2]
    n_pmax = tab.shape[1]
    lens = _lengths(kv_len, B, n_pmax * page_size)
    _values(tab[:0], "the block table")        # raises on meta
    read_rows, tab_rows = _distinct_rows(tab, lens, page_size)
    syn = red_moduli is not None
    if pack is None:
        row_bytes = hd * k_pages.element_size()
        kind = "bf16" if k_pages.dtype == torch.bfloat16 else "f32"
    else:
        row_bytes = hd // pack.values_per_byte + 4
        if syn:
            row_bytes += len(red_moduli) * k_wit.shape[-1]
        kind = "f32"
    return dataclasses.replace(decode_work(
        q_bytes=_nbytes(q), B=B, H=H, Kv=Kv, hd=hd, rows=sum(lens),
        read_rows=read_rows, row_bytes=row_bytes, chunks=n_pmax,
        outs=hd + 2 + int(syn), index_bytes=4 * n_pmax * tab_rows + 4 * B,
        kind=kind), op="paged_decode_syndrome" if syn else None)


COSTS: dict[str, Callable[..., Work]] = {
    "rns_matmul": rns_matmul_cost,
    "flash_attention": flash_attention_cost,
    "paged_decode": paged_decode_cost,
    "flash_decode": flash_decode_cost,
    "sdrns_matmul": sdrns_cost,
    "sdrns_matvec": sdrns_cost,
    "sd_add": sd_add_cost,
}


# ---------------------------------------------------------------------------
# The counter
# ---------------------------------------------------------------------------

# ops that move no bytes: allocations
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided"}

# gathers: they read the rows they return (and their indices), not the
# whole table of their first operand
_GATHER = {"embedding", "index", "index_select", "gather", "take"}

# ops that read nothing of an operand but its shape
_SHAPE_OF = {"zeros_like", "ones_like", "full_like", "rand_like",
             "randn_like", "randint_like"}

# in-place ops that overwrite their operand without reading it
_OVERWRITE = {"copy_", "fill_", "zero_"}


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def stored_bytes(t: torch.Tensor) -> int:
    """The bytes a tensor's elements occupy: an expanded dim (stride 0)
    holds one element, a strided view only the elements it spans."""
    if t.numel() == 0:
        return 0
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return min(n * t.element_size(), t.untyped_storage().nbytes())


def _tensor_bytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(stored_bytes(t) for t in leaves
               if isinstance(t, torch.Tensor))


def moved_bytes(func, args: tuple, kwargs: dict, out) -> int:
    """The HBM bytes one aten op moves: each operand it reads, once, and
    its result, once.  A gather reads its result's rows and its indices;
    a ``*_like`` op reads no operand; an operand an op writes (in place or
    ``out=``) is read only where the op reads it (``add_`` does, ``copy_``
    does not), and its aliased result is the one write."""
    name = func.overloadpacket.__name__
    if name in _GATHER:
        return 2 * _tensor_bytes(out) + _tensor_bytes((args[1:], kwargs))
    if name in _SHAPE_OF:
        return _tensor_bytes(out)
    schema = func._schema
    by_name = {a.name: a for a in schema.arguments}
    reads = 0
    for arg, val in [*zip(schema.arguments, args),
                     *((by_name[k], v) for k, v in kwargs.items())]:
        alias = arg.alias_info
        if alias is not None and alias.is_write and (
                arg.kwarg_only or name in _OVERWRITE):
            continue                            # written, not read
        reads += _tensor_bytes(val)
    return reads + _tensor_bytes(out)


def _first_dtype(args) -> torch.dtype | None:
    leaves, _ = tree_flatten(args)
    for t in leaves:
        if isinstance(t, torch.Tensor):
            return t.dtype
    return None


class OpCost(TorchDispatchMode):
    """Counts what runs inside ``with OpCost() as c:`` (module docstring).

    ``c.ops`` -- operations by kind; ``c.bytes`` -- HBM bytes;
    ``c.coll`` -- ``{collective: {"bytes", "count"}}`` (ring model);
    ``c.by_op`` -- ``{op: {"count", "bytes", <kind>: ops}}`` for every
    aten op (``"aten.mm"``) and kernel op (``"rns_matmul"``) counted;
    ``c.launches`` -- calls of each kernel op; ``c.bound`` -- each
    kernel op's :func:`bound_ms` summed launch by launch.
    """

    def __init__(self):
        super().__init__()
        self._outer: tuple = ()
        self.ops = dict.fromkeys(KINDS, 0)
        self.bytes = 0
        self.coll: dict[str, dict[str, int]] = {}
        self.by_op: dict[str, dict[str, int]] = {}
        self.launches: dict[str, int] = {}
        self.bound: dict[str, float] = {}
        self._paused = 0

    # -- context ------------------------------------------------------------
    # module slots, not ContextVars: the autograd engine runs a backward on
    # threads of its own, and the registry must find the count there too
    def __enter__(self):
        self._outer = registry.OBSERVER, collectives.OBSERVER
        registry.OBSERVER, collectives.OBSERVER = self.kernel, \
            self.collective
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            registry.OBSERVER, collectives.OBSERVER = self._outer

    @contextlib.contextmanager
    def paused(self):
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    # -- counting -----------------------------------------------------------
    def _add(self, name: str, ops: int, kind: str, nbytes: int) -> None:
        rec = self.by_op.setdefault(name, {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += nbytes
        self.bytes += nbytes
        if ops:
            rec[kind] = rec.get(kind, 0) + ops
            self.ops[kind] += ops

    def kernel(self, op: str, fn: Callable, /, *args, **kwargs) -> Any:
        """Run a registered op's implementation ``fn``, adding its cost and
        counting nothing inside it (nor the cost function's reads)."""
        if self._paused:
            return fn(*args, **kwargs)
        with self.paused():
            work = COSTS[op](*args, **kwargs)
            name = work.op or op
            self._add(name, work.ops, work.kind, work.bytes)
            self.launches[name] = self.launches.get(name, 0) + 1
            self.bound[name] = self.bound.get(name, 0.0) + bound_ms(
                work.bytes, work.ops, work.kind)[0]
            return fn(*args, **kwargs)

    def collective(self, name: str, out_bytes: int, g: int):
        """Add one collective's ring-model bytes (``roofline/analysis.py``)
        over a group of ``g``; returns the context it runs in, which
        counts nothing."""
        if not self._paused:
            rec = self.coll.setdefault(name, {"bytes": 0, "count": 0})
            rec["bytes"] += int(ring_bytes(name, out_bytes, g))
            rec["count"] += 1
        return self.paused()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused or _is_view(func):
            return out
        packet = func.overloadpacket
        if packet.__name__ in _FREE:
            return out
        ops, kind = 0, "f32"
        if packet in flop_registry:
            ops = int(flop_registry[packet](*args, **kwargs, out_val=out))
            dt = _first_dtype(args)
            kind = kind_of(dt) if dt is not None else "f32"
        self._add(f"aten.{packet.__name__}", ops, kind,
                  moved_bytes(func, args, kwargs, out))
        return out

    # -- results ------------------------------------------------------------
    @property
    def coll_bytes(self) -> int:
        return sum(r["bytes"] for r in self.coll.values())

    def as_dict(self) -> dict[str, Any]:
        return {"ops": dict(self.ops), "bytes": self.bytes,
                "coll": {k: dict(v) for k, v in self.coll.items()},
                "coll_bytes": self.coll_bytes,
                "launches": dict(self.launches),
                "bound_ms": dict(self.bound),
                "by_op": {k: dict(v) for k, v in sorted(self.by_op.items())}}

    def kernel_work(self, op: str) -> Work:
        """The summed work of kernel op ``op`` (its one kind)."""
        rec = self.by_op.get(op, {"bytes": 0})
        kinds = [k for k in KINDS if k in rec]
        kind = kinds[0] if kinds else "int8"
        return Work(rec.get(kind, 0), rec["bytes"], kind, op)
