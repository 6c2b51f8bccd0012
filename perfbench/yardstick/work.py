"""The work each registered kernel op needs, from its logical arguments.

Copied from ``repro_torch/roofline/op_cost.py`` (the work functions and
the cost functions of the registered ops).  Each input byte is read once
and each output byte written once; masked and causal work is left out as
the inputs imply.  An op's arguments are those the numerics registry hands
an implementation, so the count is the same whatever kernel, or set of
kernels, implements the op.

Ops whose work depends on values held in device tensors (a paged decode's
lengths and block table) are counted from copies of those tensors taken
at the call (:func:`snapshot`), after the window, so counting syncs
nothing inside it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Work:
    ops: int
    bytes: int
    kind: str


def rns_matmul_work(C: int, M: int, K: int, N: int, *, stack: int = 1,
                    a_bytes: int = 1, b_bytes: int = 1) -> Work:
    """B1: ``stack`` x C channel products (M, K) x (K, N) of residues,
    int32 residues out."""
    return Work(2 * stack * C * M * K * N,
                stack * C * (M * K * a_bytes + K * N * b_bytes + 4 * M * N),
                "int8")


def sdrns_work(C: int, M: int, K: int, N: int, n: int) -> Work:
    """B6: C channel products of n-digit vectors (a byte a digit), the
    digit vectors of the (M, N) residues out."""
    return Work(2 * C * M * K * N, C * n * (M * K + K * N + M * N), "int8")


def _causal_pairs(Sq: int, n: int) -> int:
    if n >= Sq:
        return Sq * (Sq + 1) // 2
    return n * (n + 1) // 2 + (Sq - n) * n


def attention_work(B: int, Sq: int, H: int, Kv: int, hd: int,
                   lengths: Sequence[int], *, causal: bool, esz: int,
                   kind: str, with_len: bool) -> Work:
    """B2: q in and out, each row's valid K and V rows read once; 4 hd
    operations a (query head, key) pair."""
    pairs = H * sum(_causal_pairs(Sq, n) if causal else Sq * n
                    for n in lengths)
    nbytes = esz * (2 * B * Sq * H * hd + 2 * sum(lengths) * Kv * hd)
    return Work(4 * hd * pairs, nbytes + (4 * B if with_len else 0), kind)


def decode_work(*, q_bytes: int, B: int, H: int, Kv: int, hd: int,
                rows: int, read_rows: int, row_bytes: int, chunks: int,
                outs: int, index_bytes: int, kind: str) -> Work:
    """B3 / B5: q in; ``read_rows`` distinct K and V rows read once; ``outs``
    f32 values a (slot, head, chunk) out; 4 hd operations a (query head,
    valid row) pair."""
    nbytes = (q_bytes + 2 * read_rows * Kv * row_bytes
              + 4 * B * H * chunks * outs + index_bytes)
    return Work(4 * hd * H * rows, nbytes, kind)


def _lengths(vals: list[int] | None, B: int, T: int) -> list[int]:
    if vals is None:
        vals = [T] * B
    elif len(vals) == 1:
        vals = vals * B
    return [max(0, min(int(n), T)) for n in vals]


def _nbytes(t) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def _host(t) -> list[int] | None:
    return None if t is None else [int(v) for v in t.reshape(-1).tolist()]


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


def flash_attention_cost(q, k, v, kv_len=None, *, causal=True, **_) -> Work:
    B, Sq, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    return attention_work(B, Sq, H, Kv, hd, _lengths(_host(kv_len), B, T),
                          causal=causal, esz=q.element_size(),
                          kind="bf16" if q.dtype == torch.bfloat16 else "f32",
                          with_len=kv_len is not None)


def paged_decode_cost(q, k_pages, v_pages, k_scale, v_scale, tab, kv_len,
                      page_size, pack=None, k_wit=None, v_wit=None,
                      red_moduli=None, **_) -> Work:
    B, H, hd = q.shape
    Kv = k_pages.shape[2]
    n_pmax = tab.shape[1]
    lens = _lengths(_host(kv_len), B, n_pmax * page_size)
    tab_h = tab.cpu().to(torch.int64)
    rows_seen: set[tuple] = set()
    pairs: set[tuple[int, int]] = set()
    for b, n in enumerate(lens):
        row = tuple(tab_h[b].tolist())
        rows_seen.add(row)
        for t in range(0, n, page_size):
            pairs.update((row[t // page_size], o)
                         for o in range(min(page_size, n - t)))
    syn = red_moduli is not None
    if pack is None:
        row_bytes = hd * k_pages.element_size()
        kind = "bf16" if k_pages.dtype == torch.bfloat16 else "f32"
    else:
        row_bytes = hd // pack.values_per_byte + 4
        if syn:
            row_bytes += len(red_moduli) * k_wit.shape[-1]
        kind = "f32"
    return decode_work(
        q_bytes=_nbytes(q), B=B, H=H, Kv=Kv, hd=hd, rows=sum(lens),
        read_rows=len(pairs), row_bytes=row_bytes, chunks=n_pmax,
        outs=hd + 2 + int(syn),
        index_bytes=4 * n_pmax * len(rows_seen) + 4 * B, kind=kind)


COSTS: dict[str, Callable[..., Work]] = {
    "rns_matmul": rns_matmul_cost,
    "flash_attention": flash_attention_cost,
    "paged_decode": paged_decode_cost,
    "sdrns_matmul": sdrns_cost,
}

# arguments whose values (not only shapes) the count reads, by position
_VALUE_ARGS = {"flash_attention": (3, "kv_len"),
               "paged_decode": (5, "tab", 6, "kv_len")}


def deferred_work(op: str, args: tuple, kwargs: dict[str, Any]
                  ) -> Callable[[], Work]:
    """The op's work, to be read after the window.  Shapes are read now;
    the tensors whose values the count reads are copied on their device
    (no sync) and read when the work is asked for."""
    keep = _VALUE_ARGS.get(op)
    if keep is None:
        w = COSTS[op](*args, **kwargs)
        return lambda: w
    pos = {keep[i]: keep[i + 1] for i in range(0, len(keep), 2)}

    def light(v, kept: bool):
        if not isinstance(v, torch.Tensor):
            return v
        if kept:
            return v.clone()
        return torch.empty(v.shape, dtype=v.dtype, device="meta")

    args2 = tuple(light(a, i in pos) for i, a in enumerate(args))
    kw2 = {k: light(v, k in pos.values()) for k, v in kwargs.items()}
    return lambda: COSTS[op](*args2, **kw2)
