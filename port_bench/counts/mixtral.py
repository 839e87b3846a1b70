"""Model FLOPs of the Mixtral family: GQA attention, the router and the
``num_experts_per_tok`` experts a token passes through."""

from __future__ import annotations

from typing import Dict

from . import model


def layer_matmul_params(cfg: Dict) -> int:
    """Parameters one token multiplies through in one layer."""
    z = model.dims(cfg)
    d, dh = z["d"], z["dh"]
    attn = d * z["h"] * dh * 2 + d * z["hkv"] * dh * 2
    experts = cfg["num_experts_per_tok"] * 3 * d * z["f"]
    return attn + experts + d * cfg["num_local_experts"]


def train_flops_per_token(cfg: Dict, seq: int) -> float:
    return model.transformer_train_flops_per_token(cfg, seq, layer_matmul_params(cfg))


attention_shape = model.transformer_attention_shape
