"""Model operations of a configuration, from its published sizes.

Model FLOPs count the matrix products a token needs: 2 a multiply-add, 6 a
parameter in training (forward and backward), attention's two products over
the keys the mask keeps. Remat's recomputation, capacity slots left empty and
the softmax, norms and elementwise work are not counted, so a share of the
peak built on them is the useful share.

A family's own counts live in ``counts/<family>.py``, found by the
configuration's ``family``; a decoder or encoder family builds on the
transformer helpers here. Whether attention is causal is the
configuration's ``causal``."""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Dict


def family(cfg: Dict) -> ModuleType:
    """``counts/<family>.py`` of the configuration's family."""
    return importlib.import_module(f"port_bench.counts.{cfg['family']}")


def train_flops_per_token(cfg: Dict, seq: int) -> float:
    """Forward and backward model FLOPs a trained token needs at ``seq``."""
    return family(cfg).train_flops_per_token(cfg, seq)


def attention_shape(cfg: Dict, batch: int, seq: int):
    """(b, s, h, hkv, d, causal) of one flash launch of the model at
    [batch, seq]."""
    return family(cfg).attention_shape(cfg, batch, seq)


def dims(cfg: Dict) -> Dict[str, int]:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return {"d": d, "h": h, "hkv": cfg.get("num_key_value_heads", h), "dh": d // h,
            "f": cfg["intermediate_size"], "L": cfg["num_hidden_layers"],
            "V": cfg["vocab_size"]}


def attention_pairs(s: int, causal: bool) -> int:
    return s * (s + 1) // 2 if causal else s * s


def transformer_train_flops_per_token(cfg: Dict, seq: int, layer_params: int) -> float:
    """A transformer's training FLOPs a token: ``layer_params`` multiplied
    through in each layer, the [d, V] head, and attention over the pairs the
    configuration's ``causal`` mask keeps."""
    z = dims(cfg)
    params = z["L"] * layer_params + z["d"] * z["V"]
    attn = z["L"] * 2 * 2 * z["h"] * z["dh"] * attention_pairs(seq, bool(cfg["causal"])) / seq
    return 6 * params + 3 * attn


def transformer_attention_shape(cfg: Dict, batch: int, seq: int):
    z = dims(cfg)
    return batch, seq, z["h"], z["hkv"], z["dh"], bool(cfg["causal"])
