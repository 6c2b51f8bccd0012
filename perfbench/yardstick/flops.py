"""Model FLOPs of the work a run did (matmul work only, the classic
convention; copied from ``repro_torch/launch/params.py`` and
``repro_torch/data/cifar.py::op_counts``).

* A dense GQA decoder layer: q, k, v and o projections and a gated MLP;
  2 FLOPs a parameter a token.  The tied logits product counts once for
  each row whose logits the run computed (an admission's last prompt
  token, a decode step's token), not for every prompt token.
* A CNN: 2 FLOPs a multiply-accumulate of its conv and fc layers.
"""
from __future__ import annotations


def dense_layer_params(d: int, n_heads: int, n_kv: int, hd: int,
                       d_ff: int) -> int:
    attn = d * n_heads * hd + 2 * d * n_kv * hd + n_heads * hd * d
    return attn + 3 * d * d_ff


def decoder_flops(cfg: dict, tokens: int, logit_rows: int) -> float:
    """``cfg`` holds the published keys (hidden_size, ...)."""
    d = cfg["hidden_size"]
    layer = dense_layer_params(d, cfg["num_attention_heads"],
                               cfg["num_key_value_heads"], cfg["head_dim"],
                               cfg["intermediate_size"])
    return (2.0 * cfg["num_hidden_layers"] * layer * tokens
            + 2.0 * d * cfg["vocab_size"] * logit_rows)


def cnn_macs(layers: list, input_hw: int, input_c: int) -> int:
    """Multiply-accumulates of one image through ``layers`` (``["conv",
    c_out, k, stride]``, ``["pool", k]``, ``["fc", d_out]``)."""
    macs = 0
    hw, c = input_hw, input_c
    for layer in layers:
        if layer[0] == "conv":
            _, c_out, k, stride = layer
            hw //= stride
            macs += hw * hw * c_out * k * k * c
            c = c_out
        elif layer[0] == "pool":
            hw //= layer[1]
        else:
            d_in = hw * hw * c if hw else c
            macs += d_in * layer[1]
            hw, c = 0, layer[1]
    return macs
