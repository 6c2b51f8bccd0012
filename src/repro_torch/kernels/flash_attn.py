"""Flash attention: Hopper kernels and their plain PyTorch versions.

* :func:`flash_attention_cuda` / :func:`flash_attention_ref` replace
  ``repro/kernels/flash_attn.py::flash_attention_pallas`` (exact causal GQA
  attention, forward only, online softmax in f32).
* :func:`paged_decode_cuda` / :func:`paged_decode_ref` replace
  ``flash_paged_decode_pallas`` in its bf16 and packed modes: split-KV
  decode partials ``(o, m, l)`` over a paged pool, one partial per
  block-table entry, merged by ``numerics.attention.merge_decode_partials``.

The kernels live in ``csrc/flash_attn.cu``; its header note says what bounds
each on the H100 and what the design does about it.  The plain versions
compute the same functions in the same order of operations, tensor-wide:
masked scores take ``-1e30``, masked KV rows are zeroed, ``p`` is rounded
to v's dtype before the PV product and the prefill output is
``acc / max(l, 1e-30)``.
"""
from __future__ import annotations

import torch

from repro_torch.core.moduli import PackedFormat
from repro_torch.kernels import build

__all__ = ["flash_attention_cuda", "flash_attention_ref",
           "paged_decode_cuda", "paged_decode_ref", "launches",
           "reset_launches"]

NEG_BIG = -1e30
launches = {"flash_attention": 0, "paged_decode": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


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
    """q (B, Sq, H, hd), k/v (B, T, Kv, hd) -> (B, Sq, H, hd) in q's dtype."""
    B, Sq, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
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
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


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
    if hd2 != hd or v.shape != k.shape or k.shape[0] != B or H % Kv:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if hd > 128:
        raise ValueError(f"head_dim {hd} > 128 is not supported")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_cuda takes contiguous q/k/v")
    kl = _full_len(kv_len, B, T, q.device)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = build.library().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kl.data_ptr(),
        out.data_ptr(), B, Sq, T, H, Kv, hd, int(causal), 1.0 / hd ** 0.5,
        _DTYPE_CODE[q.dtype], stream)
    build.check(err, "flash_attention_fwd")
    launches["flash_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# Paged decode partials
# ---------------------------------------------------------------------------


def paged_decode_ref(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, k_scale: torch.Tensor | None,
                     v_scale: torch.Tensor | None, tab: torch.Tensor,
                     kv_len: torch.Tensor, page_size: int,
                     pack: PackedFormat | None = None):
    """Split-KV partials over a paged pool.

    q (B, H, hd); pages (P, ps, Kv, hd) in the cache dtype, or with ``pack``
    packed uint8 (P, ps, Kv, hd/vpb) plus f32 scales (P, ps, Kv, 1); tab
    (B, n_pmax) int32; kv_len (B,) int32.  Returns ``o (B, H, hd, n_pmax)``,
    ``m`` and ``l`` ``(B, H, n_pmax)``, all f32.
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
    rows = torch.arange(n_pmax * ps, device=q.device).reshape(n_pmax, ps)
    valid = rows[None] < kv_len.to(q.device)[:, None, None]  # (B, n_pmax, ps)
    kb = torch.where(valid[..., None, None], kb, 0)
    vb = torch.where(valid[..., None, None], vb, 0)
    qg = q.to(torch.float32).reshape(B, Kv, g, hd)
    s = torch.einsum("bkgd,bjtkd->bkgjt", qg, kb.to(torch.float32))
    s = s * (1.0 / hd ** 0.5)
    vmask = valid[:, None, None]                             # (B,1,1,n_pmax,ps)
    s = torch.where(vmask, s, NEG_BIG)
    m = s.amax(dim=-1)                                       # (B,Kv,g,n_pmax)
    p = torch.where(vmask, torch.exp(s - m[..., None]), 0.0)
    lsum = p.sum(dim=-1)
    o = torch.einsum("bkgjt,bjtkd->bkgdj", p.to(vb.dtype).to(torch.float32),
                     vb.to(torch.float32))
    return (o.reshape(B, H, hd, n_pmax), m.reshape(B, H, n_pmax),
            lsum.reshape(B, H, n_pmax))


def paged_decode_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, k_scale: torch.Tensor | None,
                      v_scale: torch.Tensor | None, tab: torch.Tensor,
                      kv_len: torch.Tensor, page_size: int,
                      pack: PackedFormat | None = None):
    """The Hopper kernel; same contract as :func:`paged_decode_ref`."""
    tensors = [q, k_pages, v_pages, tab, kv_len]
    if pack is not None:
        if k_scale is None or v_scale is None:
            raise ValueError("packed pages need k_scale and v_scale")
        tensors += [k_scale, v_scale]
    if not all(t.is_cuda for t in tensors):
        raise ValueError("paged_decode_cuda takes CUDA tensors")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_decode_cuda takes contiguous tensors")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q must be f32 or bf16, got {q.dtype}")
    B, H, hd = q.shape
    P, ps, Kv, hds = k_pages.shape
    if ps != page_size or v_pages.shape != k_pages.shape or H % Kv:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}, page_size {page_size}")
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
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = build.library().paged_decode_fwd(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), ks, vs,
        tab.data_ptr(), kv_len.data_ptr(), o.data_ptr(), m.data_ptr(),
        lsum.data_ptr(), B, H, Kv, hd, ps, n_pmax, 1.0 / hd ** 0.5,
        _DTYPE_CODE[q.dtype], mode, m0, m1, inv, stream)
    build.check(err, "paged_decode_fwd")
    launches["paged_decode"] += 1
    return o, m, lsum
