"""Model API: ``build_model(cfg, system=..., device=...)``.

The returned :class:`Model` bundles the functions of every family: the
decoder-only dense, moe, vlm, ssm and hybrid (``models/transformer.py``)
and the audio encoder-decoder (``models/encdec.py``):

* ``init(seed, prepare=True)`` -- random parameters on the model's
  device, in ``cfg.param_dtype``.  Under ``system="rns"`` and ``"sdrns"``
  each layer is made residue-resident right after it is made, so only one
  layer's float weights exist at a time (at qwen3-8b's full width under
  ``rns`` that keeps the peak near the resident size, ~26 GB, instead of
  ~58 GB for all float weights followed by their planes);
  ``prepare=False`` keeps them float (training, and serving on the
  per-call path);
* ``loss(params, batch)`` -- ``(ce + 0.01 * aux, ce)`` of the training
  forward on a float tree: mean cross entropy over labels >= 0 (-1 is
  ignored) and the moe layers' load-balance loss (in the sharded train
  step, ``train/loop.py``, the tree holds this rank's blocks as
  ``ShardedParam`` weights and the global batch's loss comes out on every
  rank).  ``batch`` holds
  ``tokens`` and ``labels`` (B, S), and ``patches`` (vlm: the labels cover
  the patch positions too) or ``frames`` (audio);
* ``prepare_params(params)`` -- the quantize-once / convert-once pass over a
  float tree (identity for ``bns``; idempotent on prepared trees): every
  ``{"w": ...}`` weight but the moe router's (routing stays float), the
  bare ``(E, K, N)`` expert stacks ``w_gate`` / ``w_up`` / ``w_down`` (the
  stack kept), the encoder's and decoder's layers of the audio family, and
  the tied logits weight (not for the audio family, whose logits stay a
  float product, as in the reference), or an untied ``lm_head``;
* ``prepare_weight(w)`` -- one float ``(K, N)`` weight made resident as
  ``prepare_params`` makes each (the speculative drafter re-encodes the
  target's weights one at a time through it);
* ``prefill(params, tokens, s_max=None, logits_at=None, patches=None,
  frames=None, lengths=None)`` -- logits and the family's cache; the vlm
  family takes ``patches (B, n_img, d)`` put before the tokens, the audio
  family ``frames (B, S_enc, d)`` for its encoder and ``tokens`` as the
  decoder prompt; ``lengths`` (host ints) are right-padded prompts'
  lengths, which an MLA model's expert layers read;
* ``init_cache(batch, s_max)`` -- a zeroed cache of that layout (the ssm
  family's is an ``SsmCache`` alone, no KV; the audio family's ``s_max`` is
  the encoder memory's length);
* ``decode(params, token, cache, pos)`` -- one step over the dense cache
  (updated in place), every slot at position ``pos``;
* ``decode_paged(params, token, kv, block_tab, pos, page_size=...,
  with_syndrome=False)`` -- the dense, moe and vlm families (``None`` for
  ssm, hybrid and audio); with the syndrome it also returns the ``(B, L)``
  count of KV elements whose witnesses disagree (rns8r pages);
* ``verify_paged(params, tokens, kv, block_tab, pos, page_size=...)`` --
  the speculative verify of ``tokens (B, V)`` at ``pos .. pos + V - 1``,
  ``(logits (B, V, vocab), kv)``; the dense, moe and vlm families;
* ``cache_roles(cache)`` -- the sharding roles of a cache's leaves (a
  :class:`~repro_torch.parallel.sharding.Roles` each, the reference's);
* ``input_specs(shape)`` -- the inputs of one step of a
  :class:`~repro_torch.configs.base.ShapeConfig` cell as empty tensors on
  the meta device, under the reference's keys: ``tokens`` / ``labels``
  (and ``frames`` or ``patches``) for train and prefill, ``token`` (B, 1)
  and a 0-d ``pos`` for decode.

Under an installed :class:`~repro_torch.parallel.sharding.ShardCtx`,
``init`` and ``prepare_params`` keep this rank's block of every resident
weight, placed by its name rule (``sharding.rule_roles``; the channel
axis C over tp under ``ctx.channel_shard``), right after the weight is
made; the float leaves stay whole.

Entry points run on the card: ``device`` defaults to ``"cuda"`` and a
missing card raises; callers ask for the CPU with ``device="cpu"``, and
for shapes alone with ``device="meta"`` (the dry run: ``init`` draws from a
CPU generator, which ``torch.randn`` takes for a meta tensor, and every
registered kernel op returns empty outputs of its shapes).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.moduli import ModuliSet
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import frontends
from repro_torch.models import transformer as tf_mod
from repro_torch.models.attention import KVCache
from repro_torch.models.ssm import SsmCache
from repro_torch.numerics.tensor import ResidueTensor
from repro_torch.parallel import collectives, sharding
from repro_torch.quant import residency

__all__ = ["Model", "build_model", "cross_entropy", "resolve_device",
           "resident_bytes", "cache_roles", "MOE_AUX_WEIGHT"]

MOE_AUX_WEIGHT = 0.01


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean cross entropy in f32 over the positions whose label is >= 0
    (-1 marks a position to ignore).  In the sharded train step, whose dp
    ranks hold their own rows, the sum and the count are the global
    batch's (all-reduced over dp; the same value on every rank)."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    valid = (labels >= 0).to(torch.float32)
    num, den = -(ll * valid).sum(), valid.sum()
    rows = sharding.dp_rows()
    if rows is not None:
        mesh, dp, _ = rows
        num = collectives.diff_all_reduce(num, mesh, dp)
        den = collectives.all_reduce(den, mesh, dp)
    return num / den.clamp(min=1.0)


def resolve_device(device: torch.device | str) -> torch.device:
    """The device to run on; raises when a CUDA device is asked for and no
    card is present (nothing falls back to the CPU).  ``"meta"`` is taken
    when asked for by name: shapes and dtypes, no values."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device
    init: Callable[..., Any]
    loss: Callable[..., Any]
    prepare_params: Callable[[Any], Any]
    prepare_weight: Callable[[torch.Tensor], Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]
    init_cache: Callable[..., Any]
    # paged serving and its speculative verify; None for families without
    # a paged decode (ssm, hybrid, audio)
    decode_paged: Callable[..., Any] | None = None
    verify_paged: Callable[..., Any] | None = None
    cache_roles: Callable[[Any], Any] | None = None
    input_specs: Callable[[ShapeConfig], dict[str, torch.Tensor]] | None = \
        None


def build_model(cfg: ArchConfig, *, system: str = "bns",
                device: torch.device | str = "cuda",
                rns_bits: int = 4,
                rns_mset: ModuliSet | None = None) -> Model:
    """``system``: ``"bns"`` (bf16 matmuls), ``"rns"`` (int4 codes on
    residue planes) or ``"sdrns"`` (int4 codes on P21 signed-digit planes,
    the fused SD-RNS kernels; the same integer products as ``rns``).

    ``rns_mset`` (``system="rns"`` only) picks the resident planes' moduli
    set, P21 by default; a redundant set such as ``P21R2`` carries witness
    planes that every residue matmul checks and corrects at its decode.
    Signed-digit planes cannot carry redundant channels, so ``sdrns``
    refuses it, as the reference does."""
    if system not in ("bns", "rns", "sdrns"):
        raise ValueError(f"system must be 'bns', 'rns' or 'sdrns', got "
                         f"{system!r}")
    if rns_mset is not None and system != "rns":
        raise ValueError(f"rns_mset= is only meaningful for system='rns', "
                         f"got system={system!r}")
    dev = resolve_device(device)
    cd = getattr(torch, cfg.compute_dtype)
    dense_kw: dict[str, Any] = {"system": system, "compute_dtype": cd}
    prep_kw: dict[str, Any] = {"system": system, "bits": rns_bits}
    if system != "bns":
        dense_kw["bits"] = rns_bits
        if rns_mset is not None:
            dense_kw["mset"] = prep_kw["mset"] = rns_mset

    def resident(w, path, in_list):
        """``w`` made resident, and under a shard context this rank's
        block on the specs of its name rule."""
        t = residency.prepare_weight(w, roles=False, **prep_kw)
        ctx = sharding.get_shard_ctx()
        if ctx is None:
            return t
        roles = sharding.rule_roles(path, t.shape, ctx.axis_size("tp"),
                                    in_list=in_list)
        return sharding.shard_residue_tensor(t, roles, ctx)

    def prepare_tree(node, name=None, path=(), in_list=False):
        if isinstance(node, list):
            return [prepare_tree(v, None, path + (str(i),), True)
                    for i, v in enumerate(node)]
        if residency.makes_resident(name, node):
            if isinstance(node, dict):
                return {"w": resident(node["w"], path + ("w",), in_list)}
            return resident(node, path, in_list)
        if not isinstance(node, dict):
            return node
        out = {k: prepare_tree(v, k, path + (k,), in_list)
               for k, v in node.items()}
        if (name == "embed" and "logits_w" not in out and not encdec
                and cfg.tie_embeddings):
            # tied-embedding logits matmul; the f32 table stays for the
            # embedding gather
            out["logits_w"] = resident(out["table"].to(torch.float32).T,
                                       path + ("logits_w",), in_list)
        return out

    encdec = cfg.is_encdec

    def prepare_weight(w):
        if system == "bns":
            return w
        return residency.prepare_weight(w, **prep_kw)

    def prepare_params(params):
        """Every dense weight, the moe expert stacks and the tied logits
        weight (``table.T``, stored as ``embed.logits_w``) become
        residue-resident; the moe router stays float."""
        if system == "bns":
            return params
        return {k: prepare_tree(v, k, (k,)) for k, v in params.items()}

    pd = getattr(torch, cfg.param_dtype)

    def cast_layer(node):
        """The float32 leaves of a fresh layer in ``cfg.param_dtype``."""
        if isinstance(node, dict):
            return {k: cast_layer(v) for k, v in node.items()}
        if isinstance(node, list):
            return [cast_layer(v) for v in node]
        if isinstance(node, torch.Tensor) and node.dtype == torch.float32:
            return node.to(pd)
        return node

    def init(seed: int = 0, prepare: bool = True):
        # a meta tensor takes a CPU generator (a meta one does not exist)
        gen = torch.Generator(
            device="cpu" if dev.type == "meta" else dev).manual_seed(seed)
        prep = (cast_layer if system == "bns" or not prepare
                else lambda p: prepare_tree(cast_layer(p)))
        with torch.no_grad():
            if encdec:
                params = encdec_mod.init_encdec(gen, cfg, device=dev,
                                                prepare_layer=prep)
            else:
                params = tf_mod.init_lm(gen, cfg, device=dev,
                                        prepare_layer=prep)
            params = {k: v if isinstance(v, list) else cast_layer(v)
                      for k, v in params.items()}
            return prepare_params(params) if prepare else params

    def loss(params, batch):
        def get(key):
            return torch.as_tensor(batch[key], device=dev)

        tokens = get("tokens").long()
        if encdec:
            logits, aux = encdec_mod.encdec_forward(
                params, cfg, get("frames"), tokens, dense_kw=dense_kw)
        else:
            logits, aux = tf_mod.lm_forward(
                params, cfg, tokens, dense_kw=dense_kw,
                patches=get("patches") if "patches" in batch else None)
        ce = cross_entropy(logits, get("labels").long())
        return ce + MOE_AUX_WEIGHT * aux, ce

    @torch.no_grad()
    def prefill(params, tokens, s_max=None, logits_at=None,
                cache_dtype=torch.bfloat16, patches=None, frames=None,
                lengths=None):
        tokens = torch.as_tensor(tokens, device=dev).long()
        if encdec:
            if frames is None:
                raise ValueError(f"{cfg.name}: the audio family's prefill "
                                 f"needs frames (B, S_enc, d_model)")
            return encdec_mod.encdec_prefill(
                params, cfg, torch.as_tensor(frames, device=dev), tokens,
                dense_kw=dense_kw, cache_dtype=cache_dtype)
        if patches is not None:
            patches = torch.as_tensor(patches, device=dev)
        return tf_mod.lm_prefill(params, cfg, tokens, s_max=s_max,
                                 dense_kw=dense_kw, cache_dtype=cache_dtype,
                                 logits_at=logits_at, patches=patches,
                                 lengths=lengths)

    def init_cache(batch: int, s_max: int, dtype=torch.bfloat16):
        if encdec:
            return encdec_mod.init_encdec_cache(cfg, batch, s_max, dtype, dev)
        return tf_mod.init_lm_cache(cfg, batch, s_max, dtype, dev)

    @torch.no_grad()
    def decode(params, token, cache, pos: int):
        token = torch.as_tensor(token, device=dev).long()
        if encdec:
            return encdec_mod.encdec_decode(params, cfg, token, cache, pos,
                                            dense_kw=dense_kw)
        return tf_mod.lm_decode(params, cfg, token, cache, pos,
                                dense_kw=dense_kw)

    @torch.no_grad()
    def decode_paged(params, token, kv, block_tab, pos, *, page_size,
                     cache_dtype=torch.bfloat16, with_syndrome=False):
        token = torch.as_tensor(token, device=dev).long()
        return tf_mod.lm_decode_paged(
            params, cfg, token, kv, block_tab, pos, page_size=page_size,
            dense_kw=dense_kw, cache_dtype=cache_dtype,
            with_syndrome=with_syndrome)

    @torch.no_grad()
    def verify_paged(params, tokens, kv, block_tab, pos, *, page_size,
                     cache_dtype=torch.bfloat16):
        tokens = torch.as_tensor(tokens, device=dev).long()
        return tf_mod.lm_verify_paged(
            params, cfg, tokens, kv, block_tab, pos, page_size=page_size,
            dense_kw=dense_kw, cache_dtype=cache_dtype)

    def input_specs(shape: ShapeConfig) -> dict[str, torch.Tensor]:
        B, S = shape.global_batch, shape.seq_len

        def tok(*dims):
            return torch.empty(dims, dtype=torch.int32, device="meta")

        if shape.kind == "decode":
            # one new token against an S-long cache
            return {"token": tok(B, 1), "pos": tok()}
        train = shape.kind == "train"
        if encdec:
            out = {"frames": frontends.frames_struct(B, S, cfg),
                   "tokens": tok(B, cfg.dec_len)}
            if train:
                out["labels"] = tok(B, cfg.dec_len)
            return out
        if cfg.family == "vlm":
            out = {"tokens": tok(B, S - cfg.n_img_tokens),
                   "patches": frontends.patches_struct(B, cfg)}
        else:
            out = {"tokens": tok(B, S)}
        if train:
            out["labels"] = tok(B, S)
        return out

    paged = cfg.family in ("dense", "moe", "vlm")
    return Model(cfg=cfg, device=dev, init=init, loss=loss,
                 prepare_params=prepare_params,
                 prepare_weight=prepare_weight, prefill=prefill,
                 decode=decode, init_cache=init_cache,
                 decode_paged=decode_paged if paged else None,
                 verify_paged=verify_paged if paged else None,
                 cache_roles=cache_roles, input_specs=input_specs)


def cache_roles(cache) -> Any:
    """Roles of every cache leaf (:class:`~repro_torch.parallel.sharding.
    Roles`, the reference's rule): KV ``(L, B, T, kv, hd)`` batch over dp
    and sequence over tp (over ``("tp", "dp")`` at B 1, so a batch of one
    still splits the sequence), the conv history ``(L, B, K-1, conv_dim)``
    its channels over tp, the SSM state ``(L, B, H, P, N)`` its heads."""
    Roles = sharding.Roles

    def roles_for(leaf, kind: str) -> Roles:
        if kind == "kv":
            seq = ("tp",) if leaf.shape[1] > 1 else ("tp", "dp")
            return Roles.of(None, "dp", seq, None, None)
        if kind == "conv":
            return Roles.of(None, "dp", None, "tp")
        return Roles.of(None, "dp", "tp", None, None)

    def map_kv(c: KVCache):
        return KVCache(roles_for(c.k, "kv"), roles_for(c.v, "kv"))

    def map_ssm(c: SsmCache):
        return SsmCache(roles_for(c.conv, "conv"),
                        roles_for(c.state, "state"))

    if isinstance(cache, KVCache):
        return map_kv(cache)
    if isinstance(cache, SsmCache):
        return map_ssm(cache)
    return {k: map_kv(v) if isinstance(v, KVCache) else map_ssm(v)
            for k, v in cache.items()}


def resident_bytes(params: Any) -> int:
    """Bytes of the residue-resident weights (planes and scales)."""
    if isinstance(params, ResidueTensor):
        return params.nbytes()
    if isinstance(params, dict):
        return sum(resident_bytes(v) for v in params.values())
    if isinstance(params, list):
        return sum(resident_bytes(v) for v in params)
    return 0
