"""A dense GQA decoder with qk-norm and tied embeddings (Qwen3), as the
port's ``build_model`` serves it.

Weights follow the published initializer: normal with std
``initializer_range``, norm scales one.  Each block of random numbers is
drawn on the device from its own generator (``harness.weights``): a
layer's seven matrices are views of one draw, so the reference can make
any layer again, alone, after the window.
"""
from __future__ import annotations

import dataclasses

import torch

from harness.weights import normal

# the program's functions the check copies (``harness/capture.py``): the
# attention block over a prompt and the MLP block, each called with its
# parameters and its input rows (B, S, d)
CAPTURE = {"attention": ("repro_torch.models.attention",
                         "prefill_attention"),
           "mlp": ("repro_torch.models.transformer", "_mlp_block")}

_MATS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def arch_config(cfg: dict):
    """The port's architecture config, with every size from the file."""
    from repro_torch.configs.base import get_config
    if not cfg["tie_word_embeddings"] or cfg["rms_norm_eps"] != 1e-5:
        raise ValueError("the port's decoder ties its embeddings and uses "
                         "RMSNorm eps 1e-5")
    return dataclasses.replace(
        get_config(cfg["port"]["arch"]), n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv=cfg["num_key_value_heads"], d_ff=cfg["intermediate_size"],
        vocab=cfg["vocab_size"], head_dim=cfg["head_dim"],
        rope_theta=float(cfg["rope_theta"]),
        compute_dtype=cfg["torch_dtype"], tie_embeddings=True)


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
    return {"embed": emb["embed"], "layers": layers,
            "final_norm": {"scale": final_norm(cfg, seed, dev)}}


def _shapes(cfg: dict) -> dict[str, tuple[int, int]]:
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    qd = cfg["num_attention_heads"] * cfg["head_dim"]
    kd = cfg["num_key_value_heads"] * cfg["head_dim"]
    return {"wq": (d, qd), "wk": (d, kd), "wv": (d, kd), "wo": (qd, d),
            "w_gate": (d, ff), "w_up": (d, ff), "w_down": (ff, d)}


def layer_leaves(cfg: dict, seed: int, i: int, device
                 ) -> dict[str, torch.Tensor]:
    """Layer ``i``'s f32 leaves by name."""
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    shapes = _shapes(cfg)
    flat = normal(sum(a * b for a, b in shapes.values()), seed, "layer", i,
                  device=device).mul_(cfg["initializer_range"])
    out, at = {}, 0
    for name in _MATS:
        a, b = shapes[name]
        out[name] = flat[at: at + a * b].view(a, b)
        at += a * b
    ones = {"attn_norm": d, "q_norm": hd, "k_norm": hd, "mlp_norm": d}
    out.update({k: torch.ones(n, device=device) for k, n in ones.items()})
    return out


def final_norm(cfg: dict, seed: int, device) -> torch.Tensor:
    return torch.ones(cfg["hidden_size"], device=device)


def embed_table(cfg: dict, seed: int, device) -> torch.Tensor:
    V, d = cfg["vocab_size"], cfg["hidden_size"]
    return normal(V * d, seed, "embed", device=device).mul_(
        cfg["initializer_range"]).view(V, d)


def _tree(leaves: dict[str, torch.Tensor]) -> dict:
    """A layer's leaves in the program's parameter layout."""
    return {
        "attn_norm": {"scale": leaves["attn_norm"]},
        "attn": {**{k: {"w": leaves[k]} for k in ("wq", "wk", "wv", "wo")},
                 "q_norm": {"scale": leaves["q_norm"]},
                 "k_norm": {"scale": leaves["k_norm"]}},
        "mlp_norm": {"scale": leaves["mlp_norm"]},
        "mlp": {k: {"w": leaves[k]} for k in ("w_gate", "w_up", "w_down")},
    }
