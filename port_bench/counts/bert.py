"""Model FLOPs of the BERT family: a dense encoder block of q, k, v and o
projections and a two-matrix feed-forward."""

from __future__ import annotations

from typing import Dict

from . import model


def layer_matmul_params(cfg: Dict) -> int:
    """Parameters one token multiplies through in one layer."""
    z = model.dims(cfg)
    return 4 * z["d"] * z["d"] + 2 * z["d"] * z["f"]


def train_flops_per_token(cfg: Dict, seq: int) -> float:
    return model.transformer_train_flops_per_token(cfg, seq, layer_matmul_params(cfg))


attention_shape = model.transformer_attention_shape
