"""Flash attention: Hopper kernels and their plain PyTorch versions.

* :func:`flash_attention_cuda` / :func:`flash_attention_ref` replace
  ``repro/kernels/flash_attn.py::flash_attention_pallas`` (exact causal GQA
  attention, forward only, online softmax in f32).
* :func:`paged_decode_cuda` / :func:`paged_decode_ref` replace
  ``flash_paged_decode_pallas`` in its bf16 and packed modes: split-KV
  decode partials ``(o, m, l)`` over a paged pool, one partial per
  block-table entry, merged by ``numerics.attention.merge_decode_partials``.
  Given witness lanes and their moduli (rns8r pages) they also return the
  kernel's syndrome output ``syn (B, H, n_pmax)`` int32: per (slot, head,
  page) the valid K and V elements whose witness residues disagree with the
  decoded value, counted on GQA lead heads only (``h % g == 0``), as
  ``flash_paged_decode_pallas(..., red_moduli=...)`` does.  The kernel
  launches under its own counter name, ``paged_decode_syndrome``.
* :func:`flash_decode_cuda` / :func:`flash_decode_ref` replace
  ``flash_decode_pallas``: the same split-KV partials over the dense
  contiguous cache ``k, v (B, T, Kv, hd)``, one partial per chunk of ``bk``
  rows (the last one ragged when ``bk`` does not divide T).  With ``bk``
  equal to the page size they equal the paged decode's partials over the
  same rows bit for bit (one chunk body in ``csrc/flash_attn.cu``).

The kernels live in ``csrc/flash_attn.cu``; its header note says what bounds
each on the H100 and what the design does about it.  The prefill takes the
tensor-core kernel for bf16 (head_dim a multiple of 16 up to 128, or q and
k of 192 with v of 128: latent attention's widths) and the CUDA-core
kernel for f32 (one width up to 128); the decodes share one row-parallel
chunk body that loads each row as vectors (head_dim a multiple of 8 up to
128).  Each raises for what its kernel does not take.  The prefill's v
may be narrower than q and k (``(B, T, Kv, dv)``); its output has v's
width and its softmax scale is ``1 / sqrt(q's width)``.  The plain versions
compute the same functions in the same order of operations, tensor-wide:
masked scores take ``-1e30``, masked KV rows are zeroed, ``p`` is rounded
to v's dtype before the PV product and the prefill output is
``acc / max(l, 1e-30)``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.moduli import PackedFormat
from repro_torch.kernels import build

__all__ = ["flash_attention_cuda", "flash_attention_ref",
           "flash_attention_meta", "paged_decode_cuda", "paged_decode_ref",
           "paged_decode_meta", "flash_decode_cuda", "flash_decode_ref",
           "flash_decode_meta", "launches", "reset_launches"]

NEG_BIG = -1e30
launches = {"flash_attention": 0, "paged_decode": 0,
            "paged_decode_syndrome": 0, "flash_decode": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# (q/k width, v width) pairs of the bf16 prefill kernel beyond its equal
# widths (FA_BF16_SPLIT in csrc/flash_attn.cu)
_BF16_SPLIT = {(192, 128)}
_DECODE_WARPS = 8      # PD_MAXW in csrc/flash_attn.cu
_SMEM_BYTES = 227 * 1024


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check_aligned(what: str, align: int, *addrs: int) -> None:
    """Raise unless every address, stride or offset (in bytes) is a
    multiple of ``align``: the kernels load rows by vectors."""
    if any(a % align for a in addrs):
        raise ValueError(f"{what}: the kernel loads {align}-byte vectors; "
                         f"addresses and row strides must be multiples")


def _check_decode_hd(hd: int) -> None:
    if hd % 8 or not 8 <= hd <= 128:
        raise ValueError(f"the decode kernels take head_dim a multiple of 8 "
                         f"up to 128, got {hd}")


def _full_len(kv_len: torch.Tensor | None, B: int, T: int,
              device) -> torch.Tensor:
    if kv_len is None:
        return torch.full((B,), T, dtype=torch.int32, device=device)
    return kv_len.to(device=device, dtype=torch.int32).expand(B).contiguous()


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_len: torch.Tensor | None = None, *,
                        causal: bool = True) -> torch.Tensor:
    """q (B, Sq, H, hd), k (B, T, Kv, hd), v (B, T, Kv, dv) -> (B, Sq, H,
    dv) in q's dtype."""
    B, Sq, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    G = H // Kv
    kv_len = _full_len(kv_len, B, T, q.device)
    kpos = torch.arange(T, device=q.device)
    rows = kpos[None, :] < kv_len[:, None]                     # (B, T)
    kz = torch.where(rows[:, :, None, None], k, 0).to(torch.float32)
    vz = torch.where(rows[:, :, None, None], v, 0)
    qg = q.to(torch.float32).reshape(B, Sq, Kv, G, hd)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, kz) * (1.0 / hd ** 0.5)
    mask = rows[:, None, None, None, :]
    if causal:
        qpos = torch.arange(Sq, device=q.device)
        mask = mask & (kpos[None, :] <= qpos[:, None])
    m = torch.where(mask, s, NEG_BIG).amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    lsum = p.sum(dim=-1, keepdim=True)                         # (B,Kv,G,Sq,1)
    o = torch.einsum("bkgqt,btkd->bkgqd", p.to(v.dtype).to(torch.float32),
                     vz.to(torch.float32))
    o = o / torch.clamp(lsum, min=1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, dv).to(
        q.dtype).contiguous()


def flash_attention_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: torch.Tensor | None = None, *,
                         causal: bool = True) -> torch.Tensor:
    """The contract's output, empty (the meta device)."""
    return torch.empty((*q.shape[:-1], v.shape[-1]), dtype=q.dtype,
                       device=q.device)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: torch.Tensor | None = None, *,
                         causal: bool = True) -> torch.Tensor:
    """The Hopper kernel; same contract as :func:`flash_attention_ref`."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_cuda takes CUDA tensors")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_cuda takes f32 or bf16 q/k/v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    B, Sq, H, hd = q.shape
    _, T, Kv, hd2 = k.shape
    dv = v.shape[-1]
    if (hd2 != hd or v.shape[:-1] != k.shape[:-1] or k.shape[0] != B
            or H % Kv):
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if dv != hd and (q.dtype != torch.bfloat16 or (hd, dv) not in
                     _BF16_SPLIT):
        raise ValueError(f"q/k width {hd} with v width {dv}: the kernel "
                         f"takes unequal widths {sorted(_BF16_SPLIT)} in "
                         f"bf16 only")
    if dv == hd and hd > 128:
        raise ValueError(f"head_dim {hd} > 128 is not supported")
    if q.dtype == torch.bfloat16 and hd % 16:
        raise ValueError(f"the bf16 tensor-core kernel takes head_dim a "
                         f"multiple of 16, got {hd}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_cuda takes contiguous q/k/v")
    if q.dtype == torch.bfloat16:
        _check_aligned("flash_attention_cuda", 16, q.data_ptr(),
                       k.data_ptr(), v.data_ptr())
    kl = _full_len(kv_len, B, T, q.device)
    out = torch.empty((B, Sq, H, dv), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = build.library().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kl.data_ptr(),
        out.data_ptr(), B, Sq, T, H, Kv, hd, dv, int(causal),
        1.0 / hd ** 0.5, _DTYPE_CODE[q.dtype], stream)
    build.check(err, "flash_attention_fwd")
    launches["flash_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# Split-KV decode partials (paged and dense)
# ---------------------------------------------------------------------------


def _chunk_rows(n_chunks: int, rows: int,
                kv_len: torch.Tensor) -> torch.Tensor:
    """(B, n_chunks, rows) bool: row t of chunk j is below ``kv_len[b]``."""
    t = torch.arange(n_chunks * rows, device=kv_len.device)
    return t.reshape(n_chunks, rows)[None] < kv_len[:, None, None]


def _chunk_partials(q: torch.Tensor, kb: torch.Tensor, vb: torch.Tensor,
                    valid: torch.Tensor):
    """The per-chunk partials of one decode token.

    q (B, H, hd); kb, vb (B, n, rows, Kv, hd) chunked K/V in the cache
    dtype (or dequantized f32); valid (B, n, rows).  Returns ``o (B, H, hd,
    n)``, ``m`` and ``l`` ``(B, H, n)`` f32: masked rows zeroed and scored
    -1e30, ``p`` rounded to the values' dtype before the PV product.
    """
    B, H, hd = q.shape
    n, Kv = kb.shape[1], kb.shape[3]
    g = H // Kv
    kb = torch.where(valid[..., None, None], kb, 0)
    vb = torch.where(valid[..., None, None], vb, 0)
    qg = q.to(torch.float32).reshape(B, Kv, g, hd)
    s = torch.einsum("bkgd,bjtkd->bkgjt", qg, kb.to(torch.float32))
    s = s * (1.0 / hd ** 0.5)
    vmask = valid[:, None, None]                             # (B,1,1,n,rows)
    s = torch.where(vmask, s, NEG_BIG)
    m = s.amax(dim=-1)                                       # (B,Kv,g,n)
    p = torch.where(vmask, torch.exp(s - m[..., None]), 0.0)
    lsum = p.sum(dim=-1)
    o = torch.einsum("bkgjt,bjtkd->bkgdj", p.to(vb.dtype).to(torch.float32),
                     vb.to(torch.float32))
    return (o.reshape(B, H, hd, n).contiguous(),
            m.reshape(B, H, n).contiguous(),
            lsum.reshape(B, H, n).contiguous())


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, bk: int):
    """Split-KV partials over the dense cache.

    q (B, H, hd); k, v (B, T, Kv, hd) in the cache dtype; kv_len (B,)
    int32 (rows at or past ``min(kv_len[b], T)`` are masked).  Returns
    ``o (B, H, hd, n_k)``, ``m`` and ``l`` ``(B, H, n_k)`` f32 with
    ``n_k = ceil(T / bk)``; the last chunk is ragged when ``bk`` does not
    divide T.
    """
    B, T = k.shape[:2]
    n_k = -(-T // bk)
    pad = (0, 0, 0, 0, 0, n_k * bk - T)

    def chunks(x):
        return torch.nn.functional.pad(x, pad).reshape(
            B, n_k, bk, *x.shape[2:])

    kl = torch.clamp(_full_len(kv_len, B, T, q.device), max=T)
    return _chunk_partials(q, chunks(k), chunks(v), _chunk_rows(n_k, bk, kl))


def _partials_meta(q: torch.Tensor, n: int):
    B, H, hd = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.empty((B, H, hd, n), **f32), torch.empty((B, H, n), **f32),
            torch.empty((B, H, n), **f32))


def flash_decode_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      kv_len: torch.Tensor, bk: int):
    """The contract's partials, empty (the meta device)."""
    return _partials_meta(q, -(-k.shape[1] // bk))


def flash_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      kv_len: torch.Tensor, bk: int):
    """The Hopper kernel; same contract as :func:`flash_decode_ref`.

    q, k, v and kv_len must be contiguous; q is f32 or bf16, the cache f32
    or bf16 (one dtype for k and v), kv_len int32.
    """
    if not all(t.is_cuda for t in (q, k, v, kv_len)):
        raise ValueError("flash_decode_cuda takes CUDA tensors")
    if not all(t.is_contiguous() for t in (q, k, v, kv_len)):
        raise ValueError("flash_decode_cuda takes contiguous q, k, v and "
                         "kv_len")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q must be f32 or bf16, got {q.dtype}")
    if k.dtype not in _DTYPE_CODE or v.dtype != k.dtype:
        raise TypeError(f"the cache must be f32 or bf16 of one dtype, got "
                        f"{k.dtype}, {v.dtype}")
    if kv_len.dtype != torch.int32:
        raise TypeError(f"kv_len must be int32, got {kv_len.dtype}")
    B, H, hd = q.shape
    _, T, Kv, hd2 = k.shape
    if (hd2 != hd or v.shape != k.shape or k.shape[0] != B or H % Kv
            or kv_len.shape != (B,)):
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, kv_len "
                         f"{tuple(kv_len.shape)}")
    _check_decode_hd(hd)
    if bk < 1 or 4 * (bk + _DECODE_WARPS * hd) > _SMEM_BYTES:
        raise ValueError(f"chunk of {bk} rows does not fit shared memory")
    _check_aligned("flash_decode_cuda", 16, k.data_ptr(), v.data_ptr())
    n_k = -(-T // bk)
    dev = q.device
    o = torch.empty((B, H, hd, n_k), dtype=torch.float32, device=dev)
    m = torch.empty((B, H, n_k), dtype=torch.float32, device=dev)
    lsum = torch.empty((B, H, n_k), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = build.library().flash_decode_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        o.data_ptr(), m.data_ptr(), lsum.data_ptr(), B, H, Kv, hd, T, bk,
        1.0 / hd ** 0.5, _DTYPE_CODE[q.dtype], _DTYPE_CODE[k.dtype], stream)
    build.check(err, "flash_decode_fwd")
    launches["flash_decode"] += 1
    return o, m, lsum


def _witness_mismatch(raw: torch.Tensor, wit: torch.Tensor,
                      pack: PackedFormat, red_moduli) -> torch.Tensor:
    """Elementwise: does any witness lane ``wit (..., r, Kv, hd)`` disagree
    with the packed value of ``raw (..., Kv, hd)``?  Floored remainders,
    as the reference's ``jnp.remainder``."""
    vals = pack.decode(raw)
    w = wit.to(torch.int32)
    bad = torch.zeros(vals.shape, dtype=torch.bool, device=vals.device)
    for jw, m in enumerate(red_moduli):
        bad |= torch.remainder(w[..., jw, :, :] - torch.remainder(vals, m),
                               m) != 0
    return bad


def paged_decode_ref(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, k_scale: torch.Tensor | None,
                     v_scale: torch.Tensor | None, tab: torch.Tensor,
                     kv_len: torch.Tensor, page_size: int,
                     pack: PackedFormat | None = None,
                     k_wit: torch.Tensor | None = None,
                     v_wit: torch.Tensor | None = None,
                     red_moduli: tuple[int, ...] | None = None):
    """Split-KV partials over a paged pool.

    q (B, H, hd); pages (P, ps, Kv, hd) in the cache dtype, or with ``pack``
    packed uint8 (P, ps, Kv, hd/vpb) plus f32 scales (P, ps, Kv, 1); tab
    (B, n_pmax) int32; kv_len (B,) int32.  Returns ``o (B, H, hd, n_pmax)``,
    ``m`` and ``l`` ``(B, H, n_pmax)``, all f32.  With ``red_moduli`` and
    the witness lanes ``k_wit``/``v_wit`` (P, ps, r, Kv, hd) uint8 a fourth
    output ``syn (B, H, n_pmax)`` int32 (the module docstring).
    """
    B, H, hd = q.shape
    _, ps, Kv, _ = k_pages.shape
    if ps != page_size:
        raise ValueError(f"pages hold {ps} rows, page_size is {page_size}")
    g = H // Kv
    n_pmax = tab.shape[1]
    tab = tab.long()

    def rows_of(pages, scale):
        sel = pages[tab]                          # (B, n_pmax, ps, Kv, hd?)
        if pack is None:
            return sel
        return pack.decode(sel).to(torch.float32) * scale[tab]

    kb, vb = rows_of(k_pages, k_scale), rows_of(v_pages, v_scale)
    valid = _chunk_rows(n_pmax, ps, kv_len.to(q.device))
    out = _chunk_partials(q, kb, vb, valid)
    if red_moduli is None:
        return out
    keep = valid[..., None, None]                    # (B, n_pmax, ps, 1, 1)
    cnt = sum((_witness_mismatch(pages[tab], wit[tab], pack, red_moduli)
               & keep).sum(dim=(2, 4))
              for pages, wit in ((k_pages, k_wit), (v_pages, v_wit)))
    lead = (torch.arange(H, device=q.device) % g == 0)       # (H,)
    per_head = cnt.to(torch.int32).repeat_interleave(g, dim=2)  # (B,np,H)
    syn = torch.where(lead[None, None], per_head, 0).permute(0, 2, 1)
    return (*out, syn.contiguous())


def paged_decode_meta(q: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, k_scale: torch.Tensor | None,
                      v_scale: torch.Tensor | None, tab: torch.Tensor,
                      kv_len: torch.Tensor, page_size: int,
                      pack: PackedFormat | None = None,
                      k_wit: torch.Tensor | None = None,
                      v_wit: torch.Tensor | None = None,
                      red_moduli: tuple[int, ...] | None = None):
    """The contract's partials (and ``syn``), empty (the meta device)."""
    parts = _partials_meta(q, tab.shape[1])
    if red_moduli is None:
        return parts
    return (*parts, torch.empty(parts[1].shape, dtype=torch.int32,
                                device=q.device))


def _pool_strides(pages: torch.Tensor, what: str) -> tuple[int, int]:
    """``(row_stride, page_stride)`` of a (P, ps, Kv, hd) page view whose
    last two axes are dense: the kernel addresses rows through them."""
    P, ps, Kv, hds = pages.shape
    if pages.stride(3) != 1 or (Kv > 1 and pages.stride(2) != hds):
        raise ValueError(f"{what}: the (Kv, hd) axes must be dense, got "
                         f"strides {pages.stride()}")
    if P > 1 and pages.stride(0) != ps * pages.stride(1):
        raise ValueError(f"{what}: pages must be ps rows apart, got strides "
                         f"{pages.stride()}")
    return pages.stride(1), pages.stride(0)


def paged_decode_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, k_scale: torch.Tensor | None,
                      v_scale: torch.Tensor | None, tab: torch.Tensor,
                      kv_len: torch.Tensor, page_size: int,
                      pack: PackedFormat | None = None,
                      k_wit: torch.Tensor | None = None,
                      v_wit: torch.Tensor | None = None,
                      red_moduli: tuple[int, ...] | None = None):
    """The Hopper kernel; same contract as :func:`paged_decode_ref`.

    Pages are read in place through their strides (lane 0 of an rns8r pool
    is a strided view); q, tab, kv_len and the scales must be contiguous.
    """
    tensors = [q, k_pages, v_pages, tab, kv_len]
    if pack is not None:
        if k_scale is None or v_scale is None:
            raise ValueError("packed pages need k_scale and v_scale")
        tensors += [k_scale, v_scale]
    syn_mode = red_moduli is not None
    if syn_mode:
        if pack is None or k_wit is None or v_wit is None:
            raise ValueError("the syndrome mode needs packed pages and "
                             "their witness lanes")
        tensors += [k_wit, v_wit]
    if not all(t.is_cuda for t in tensors):
        raise ValueError("paged_decode_cuda takes CUDA tensors")
    if not all(t.is_contiguous() for t in (q, tab, kv_len) + (
            (k_scale, v_scale) if pack is not None else ())):
        raise ValueError("paged_decode_cuda takes contiguous q, tab, kv_len "
                         "and scales")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q must be f32 or bf16, got {q.dtype}")
    B, H, hd = q.shape
    P, ps, Kv, hds = k_pages.shape
    if ps != page_size or v_pages.shape != k_pages.shape or H % Kv:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}, page_size {page_size}")
    _check_decode_hd(hd)
    if 4 * (ps + _DECODE_WARPS * hd) > _SMEM_BYTES:
        raise ValueError(f"pages of {ps} rows do not fit shared memory")
    row_stride, page_stride = _pool_strides(k_pages, "k_pages")
    if _pool_strides(v_pages, "v_pages") != (row_stride, page_stride):
        raise ValueError("k_pages and v_pages must share their strides")
    esz = k_pages.element_size()
    # a lane loads 8 values: 16 or 32 bytes of f32 / bf16, 8 / vpb bytes
    # of packed residues
    align = 16 if pack is None else 8 // pack.values_per_byte
    _check_aligned("paged_decode_cuda", align, k_pages.data_ptr(),
                   v_pages.data_ptr(), row_stride * esz)
    if tab.dtype != torch.int32 or kv_len.dtype != torch.int32:
        raise TypeError("tab and kv_len must be int32")
    n_pmax = tab.shape[1]
    m0 = m1 = inv = 0
    if pack is None:
        if k_pages.dtype not in _DTYPE_CODE or v_pages.dtype != k_pages.dtype:
            raise TypeError(f"dense pages must be f32 or bf16, got "
                            f"{k_pages.dtype}")
        if hds != hd:
            raise ValueError(f"pages hold {hds} values per row, q has {hd}")
        mode = _DTYPE_CODE[k_pages.dtype]
        ks = vs = 0
    else:
        if k_pages.dtype != torch.uint8 or v_pages.dtype != torch.uint8:
            raise TypeError("packed pages must be uint8")
        if hds * pack.values_per_byte != hd:
            raise ValueError(f"packed rows of {hds} bytes do not hold hd={hd}")
        if k_scale.shape != (P, ps, Kv, 1) or v_scale.shape != (P, ps, Kv, 1):
            raise ValueError("scales must be (P, ps, Kv, 1)")
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
            raise TypeError("scales must be f32")
        mode = 2
        (m0, m1), inv = pack.moduli, pack.crt_inverse
        ks, vs = k_scale.data_ptr(), v_scale.data_ptr()
    dev = q.device
    o = torch.empty((B, H, hd, n_pmax), dtype=torch.float32, device=dev)
    m = torch.empty((B, H, n_pmax), dtype=torch.float32, device=dev)
    lsum = torch.empty((B, H, n_pmax), dtype=torch.float32, device=dev)
    kw = vw = lane_stride = 0
    syn = None
    red = (ctypes.c_int * 1)(0)
    if syn_mode:
        r = len(red_moduli)
        if pack.values_per_byte != 1:
            raise ValueError("witness lanes need one value per byte")
        for w in (k_wit, v_wit):
            if (w.dtype != torch.uint8 or w.shape != (P, ps, r, Kv, hds)
                    or w.stride(0) != page_stride or w.stride(1) != row_stride
                    or w.stride(3) != hds or w.stride(4) != 1):
                raise ValueError(f"witness lanes must be uint8 (P, ps, r, Kv,"
                                 f" hd) laid out like the pages, got "
                                 f"{tuple(w.shape)} {w.stride()}")
        if v_wit.stride(2) != k_wit.stride(2):
            raise ValueError("k and v witness lanes must share their strides")
        kw, vw, lane_stride = k_wit.data_ptr(), v_wit.data_ptr(), \
            k_wit.stride(2)
        _check_aligned("paged_decode_cuda witness lanes", 8, kw, vw,
                       lane_stride)
        red = (ctypes.c_int * r)(*(int(x) for x in red_moduli))
        syn = torch.empty((B, H, n_pmax), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = build.library().paged_decode_fwd(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), ks, vs,
        tab.data_ptr(), kv_len.data_ptr(), o.data_ptr(), m.data_ptr(),
        lsum.data_ptr(), B, H, Kv, hd, ps, n_pmax, row_stride,
        1.0 / hd ** 0.5, _DTYPE_CODE[q.dtype], mode, m0, m1, inv, kw, vw,
        lane_stride, len(red_moduli) if syn_mode else 0, red,
        0 if syn is None else syn.data_ptr(), stream)
    build.check(err, "paged_decode_fwd")
    if syn_mode:
        launches["paged_decode_syndrome"] += 1
        return o, m, lsum, syn
    launches["paged_decode"] += 1
    return o, m, lsum
