"""BERT-Large's encoder in plain f32, as the configuration's ``assumed``
states it (pre-LayerNorm blocks without biases, tanh GELU, a final
LayerNorm and an untied MLM head): the masked-LM loss."""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..inputs import LeafSpec
from .common import Precision, attention, cross_entropy, layer_norm

LN_EPS = 1e-5


def leaf_specs(cfg: Dict) -> List[LeafSpec]:
    """The parameters in the port's layout (stacked layers, [in, out]
    matrices, the fused [d, 3d] q/k/v weight)."""
    d, f, L = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    V, P = cfg["vocab_size"], cfg["max_position_embeddings"]
    return [
        (("embed",), (V, d), "normal", 1, 1.0),
        (("pos_embed",), (P, d), "normal", 1, 0.02),
        (("layers", "ln1_scale"), (L, d), "ones", 1, 1.0),
        (("layers", "ln1_bias"), (L, d), "zeros", 1, 1.0),
        (("layers", "wqkv"), (L, d, 3 * d), "normal", d, 1.0),
        (("layers", "wo"), (L, d, d), "normal", d, 1.0),
        (("layers", "ln2_scale"), (L, d), "ones", 1, 1.0),
        (("layers", "ln2_bias"), (L, d), "zeros", 1, 1.0),
        (("layers", "w_up"), (L, d, f), "normal", d, 1.0),
        (("layers", "w_down"), (L, f, d), "normal", f, 1.0),
        (("ln_f_scale",), (d,), "ones", 1, 1.0),
        (("ln_f_bias",), (d,), "zeros", 1, 1.0),
        (("mlm_head",), (d, V), "normal", d, 1.0),
    ]


def _block(x: torch.Tensor, lp: Dict, cfg: Dict, prec: Precision) -> torch.Tensor:
    b, s, d = x.shape
    h = cfg["num_attention_heads"]
    hn = layer_norm(x, lp["ln1_scale"], lp["ln1_bias"], LN_EPS)
    q, k, v = (t.reshape(b, s, h, d // h) for t in prec.mm(hn, lp["wqkv"]).chunk(3, dim=-1))
    x = x + prec.mm(attention(q, k, v, False, prec).reshape(b, s, d), lp["wo"])
    hn = layer_norm(x, lp["ln2_scale"], lp["ln2_bias"], LN_EPS)
    return x + prec.mm(F.gelu(prec.mm(hn, lp["w_up"]), approximate="tanh"), lp["w_down"])


def loss(params: Dict, batch: Dict, cfg: Dict, prec: Precision) -> torch.Tensor:
    """The mean negative log-likelihood over the masked positions."""
    tokens = batch["tokens"]
    x = params["embed"][tokens] + params["pos_embed"][: tokens.shape[1]]
    for i in range(cfg["num_hidden_layers"]):
        lp = {k: v[i] for k, v in params["layers"].items()}
        x = checkpoint(_block, x, lp, cfg, prec, use_reentrant=False)
    x = layer_norm(x, params["ln_f_scale"], params["ln_f_bias"], LN_EPS)
    return cross_entropy(prec.mm(x, params["mlm_head"]), batch["targets"])
