"""A DeepSeek-V3-style decoder (Moonlight-16B-A3B): multi-head latent
attention, a leading dense layer, sigmoid-routed experts with shared
experts and an untied ``lm_head``, as the port's ``build_model`` serves it
(``repro_torch.configs.base.MlaMoeConfig``).

Weights follow the published initializer: normal with std
``initializer_range``, norm scales one; the router's correction bias is
drawn the same way (the configuration lists it under ``assumed``).  Each
layer is one draw on the device from its own generator
(``harness.weights``), its matrices views of it, so the reference can make
any layer again, alone, after the window.
"""
from __future__ import annotations

import dataclasses

import torch

from harness.weights import normal

# the program's functions the check copies (``harness/drivers/
# serve_mla.py``): the MLA block over a prompt, the feed-forward block (each
# called with its parameters and its input rows (B, S, d)), and the expert
# placement of every expert layer
CAPTURE = {"attention": ("repro_torch.models.attention",
                         "mla_prefill_attention"),
           "mlp": ("repro_torch.models.transformer", "_mlp_block"),
           "place": ("repro_torch.models.moe", "place")}

# what the port implements of the published keys
_PUBLISHED = {"q_lora_rank": None, "scoring_func": "sigmoid",
              "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1,
              "norm_topk_prob": True, "hidden_act": "silu",
              "tie_word_embeddings": False, "rms_norm_eps": 1e-5,
              "moe_layer_freq": 1, "attention_bias": False}


def arch_config(cfg: dict):
    """The port's architecture config, with every size from the file."""
    from repro_torch.configs.base import get_config
    for k, v in _PUBLISHED.items():
        if cfg.get(k, v) != v:
            raise ValueError(f"the port's MLA decoder takes {k}={v!r}, the "
                             f"configuration has {cfg[k]!r}")
    if cfg.get("rope_scaling") is not None:
        raise ValueError("the port's MLA decoder has no rope scaling")
    return dataclasses.replace(
        get_config(cfg["port"]["arch"]), n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv=cfg["num_key_value_heads"], d_ff=cfg["moe_intermediate_size"],
        vocab=cfg["vocab_size"],
        head_dim=cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"],
        rope_theta=float(cfg["rope_theta"]),
        n_experts=cfg["n_routed_experts"], top_k=cfg["num_experts_per_tok"],
        moe_cf=float(cfg["port"]["capacity_factor"]),
        kv_lora_rank=cfg["kv_lora_rank"],
        qk_nope_dim=cfg["qk_nope_head_dim"],
        qk_rope_dim=cfg["qk_rope_head_dim"], v_head_dim=cfg["v_head_dim"],
        first_dense=cfg["first_k_dense_replace"],
        dense_d_ff=cfg["intermediate_size"],
        n_shared=cfg["n_shared_experts"],
        routed_scale=float(cfg["routed_scaling_factor"]),
        compute_dtype=cfg["torch_dtype"], tie_embeddings=False)


def build(cfg: dict, dev):
    from repro_torch.models.api import build_model
    port = cfg["port"]
    return build_model(arch_config(cfg), system=port["system"], device=dev,
                       rns_bits=port["bits"])


def params(model, cfg: dict, seed: int, dev) -> dict:
    """The program's prepared parameters, each layer made resident as it
    is made."""
    with torch.no_grad():
        emb = model.prepare_params(
            {"embed": {"table": embed_table(cfg, seed, dev)}})
        layers = [model.prepare_params({"layers": [_tree(
            layer_leaves(cfg, seed, i, dev))]})["layers"][0]
            for i in range(cfg["num_hidden_layers"])]
        head = model.prepare_params(
            {"lm_head": {"w": lm_head(cfg, seed, dev)}})
    return {"embed": emb["embed"], "layers": layers,
            "final_norm": {"scale": final_norm(cfg, seed, dev)},
            "lm_head": head["lm_head"]}


def _shapes(cfg: dict, i: int) -> dict[str, tuple[int, ...]]:
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    r, dv = cfg["kv_lora_rank"], cfg["v_head_dim"]
    out = {"wq": (d, H * (nope + rope)), "kv_a": (d, r + rope),
           "kv_b": (r, H * (nope + dv)), "wo": (H * dv, d)}
    if i < cfg["first_k_dense_replace"]:
        ff = cfg["intermediate_size"]
        out.update(w_gate=(d, ff), w_up=(d, ff), w_down=(ff, d))
        return out
    E, f = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    fs = cfg["n_shared_experts"] * f
    out.update(router=(d, E), bias=(E,), e_gate=(E, d, f), e_up=(E, d, f),
               e_down=(E, f, d), s_gate=(d, fs), s_up=(d, fs),
               s_down=(fs, d))
    return out


def layer_leaves(cfg: dict, seed: int, i: int, device
                 ) -> dict[str, torch.Tensor]:
    """Layer ``i``'s f32 leaves by name (the reference's names)."""
    shapes = _shapes(cfg, i)
    sizes = {k: int(torch.Size(s).numel()) for k, s in shapes.items()}
    flat = normal(sum(sizes.values()), seed, "layer", i,
                  device=device).mul_(cfg["initializer_range"])
    out, at = {}, 0
    for name, shape in shapes.items():
        out[name] = flat[at: at + sizes[name]].view(shape)
        at += sizes[name]
    d, r = cfg["hidden_size"], cfg["kv_lora_rank"]
    for k, n in (("attn_norm", d), ("kv_norm", r), ("mlp_norm", d)):
        out[k] = torch.ones(n, device=device)
    return out


def final_norm(cfg: dict, seed: int, device) -> torch.Tensor:
    return torch.ones(cfg["hidden_size"], device=device)


def embed_table(cfg: dict, seed: int, device) -> torch.Tensor:
    V, d = cfg["vocab_size"], cfg["hidden_size"]
    return normal(V * d, seed, "embed", device=device).mul_(
        cfg["initializer_range"]).view(V, d)


def lm_head(cfg: dict, seed: int, device) -> torch.Tensor:
    """The untied head ``(d, vocab)``."""
    V, d = cfg["vocab_size"], cfg["hidden_size"]
    return normal(V * d, seed, "lm_head", device=device).mul_(
        cfg["initializer_range"]).view(d, V)


def _tree(leaves: dict[str, torch.Tensor]) -> dict:
    """A layer's leaves in the program's parameter layout."""
    out = {
        "attn_norm": {"scale": leaves["attn_norm"]},
        "attn": {**{k: {"w": leaves[k]} for k in ("wq", "kv_a", "kv_b",
                                                  "wo")},
                 "kv_norm": {"scale": leaves["kv_norm"]}},
        "mlp_norm": {"scale": leaves["mlp_norm"]},
    }
    if "router" not in leaves:
        out["mlp"] = {k: {"w": leaves[k]} for k in ("w_gate", "w_up",
                                                    "w_down")}
        return out
    # the router stays float: copies, so that no view keeps the layer's
    # whole draw alive beside its planes
    out["moe"] = {
        "router": {"w": leaves["router"].clone(),
                   "bias": leaves["bias"].clone()},
        "w_gate": leaves["e_gate"], "w_up": leaves["e_up"],
        "w_down": leaves["e_down"],
        "shared": {k: {"w": leaves["s_" + k[2:]]}
                   for k in ("w_gate", "w_up", "w_down")},
    }
    return out
