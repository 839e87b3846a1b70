"""Mixtral in plain f32: the decoder with GQA attention and RoPE, and the
sparse MoE under GShard's static capacity as the configuration's
``assumed.routing`` states it: training's loss."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..inputs import LeafSpec
from .common import Precision, attention, cross_entropy, rms_norm, rope


def _sizes(cfg: Dict):
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return (d, h, cfg["num_key_value_heads"], d // h, cfg["intermediate_size"],
            cfg["num_hidden_layers"], cfg["num_local_experts"], cfg["vocab_size"])


def leaf_specs(cfg: Dict) -> List[LeafSpec]:
    """The parameters in the port's layout (stacked layers, [in, out]
    matrices, experts [L, E, in, out])."""
    d, h, hk, dh, f, L, E, V = _sizes(cfg)
    return [
        (("embed",), (V, d), "normal", 1, 1.0),
        (("layers", "ln1"), (L, d), "ones", 1, 1.0),
        (("layers", "wq"), (L, d, h * dh), "normal", d, 1.0),
        (("layers", "wk"), (L, d, hk * dh), "normal", d, 1.0),
        (("layers", "wv"), (L, d, hk * dh), "normal", d, 1.0),
        (("layers", "wo"), (L, h * dh, d), "normal", h * dh, 1.0),
        (("layers", "ln2"), (L, d), "ones", 1, 1.0),
        (("layers", "router"), (L, d, E), "normal", d, 1.0),
        (("layers", "w_gate"), (L, E, d, f), "normal", d, 1.0),
        (("layers", "w_up"), (L, E, d, f), "normal", d, 1.0),
        (("layers", "w_down"), (L, E, f, d), "normal", f, 1.0),
        (("ln_f",), (d,), "ones", 1, 1.0),
        (("lm_head",), (d, V), "normal", d, 1.0),
    ]


def capacity(cfg: Dict, tokens: int) -> int:
    k = cfg["num_experts_per_tok"]
    return max(k, math.ceil(k * tokens / cfg["num_local_experts"] * cfg["router_capacity_factor"]))


def moe(h: torch.Tensor, lp: Dict, cfg: Dict, prec: Precision) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed FFN of h [T, D] (the T tokens routed together, row-major):
    (out [T, D], the load-balancing loss)."""
    T = h.shape[0]
    E, K = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    gates = torch.softmax(prec.mm(h, lp["router"]), dim=-1)  # [T, E]
    C = capacity(cfg, T)
    left = gates.detach().clone()
    occupancy = torch.zeros(E, dtype=torch.long, device=h.device)
    rows = torch.arange(T, device=h.device)
    picks, kept, weights = [], [], []
    for _ in range(K):
        idx = left.argmax(dim=-1)  # the first maximum
        onehot = F.one_hot(idx, E)  # [T, E]
        slot = (torch.cumsum(onehot, 0) - 1)[rows, idx] + occupancy[idx]
        occupancy = occupancy + onehot.sum(0)
        left[rows, idx] = -1.0
        picks.append(idx)
        kept.append(slot < C)
        weights.append(gates[rows, idx] * kept[-1])
    denom = torch.stack(weights).sum(0).clamp_min(1e-9)
    out = torch.zeros_like(h)
    for e in range(E):
        sel = [(rows[(p == e) & k], w[(p == e) & k]) for p, k, w in zip(picks, kept, weights)]
        tok = torch.cat([s[0] for s in sel])
        if tok.numel() == 0:
            continue
        w = torch.cat([s[1] for s in sel])
        x = h[tok]
        y = prec.mm(F.silu(prec.mm(x, lp["w_gate"][e])) * prec.mm(x, lp["w_up"][e]),
                    lp["w_down"][e])
        out = out.index_add(0, tok, y * w[:, None])
    out = out / denom[:, None]
    me = torch.zeros(E, dtype=h.dtype, device=h.device)
    load = torch.zeros(E, dtype=h.dtype, device=h.device)
    for p in picks:
        me = me.index_add(0, p, gates[rows, p])
        load = load + F.one_hot(p, E).sum(0).to(h.dtype)
    aux = E * torch.sum((me / T) * (load / T)) / (K * K)
    return out, aux


def _qkv(x: torch.Tensor, lp: Dict, cfg: Dict, prec: Precision, positions: torch.Tensor):
    b, s, _ = x.shape
    d, h, hk, dh = _sizes(cfg)[:4]
    hn = rms_norm(x, lp["ln1"], cfg["rms_norm_eps"])
    q = prec.mm(hn, lp["wq"]).view(b, s, h, dh)
    k = prec.mm(hn, lp["wk"]).view(b, s, hk, dh)
    v = prec.mm(hn, lp["wv"]).view(b, s, hk, dh)
    theta = cfg["rope_theta"]
    return rope(q, positions, theta), rope(k, positions, theta), v


def _ffn(x: torch.Tensor, lp: Dict, cfg: Dict, prec: Precision):
    b, s, d = x.shape
    out, aux = moe(rms_norm(x, lp["ln2"], cfg["rms_norm_eps"]).reshape(b * s, d), lp, cfg, prec)
    return x + out.view(b, s, d), aux


def _block(x: torch.Tensor, lp: Dict, cfg: Dict, prec: Precision):
    b, s, _ = x.shape
    q, k, v = _qkv(x, lp, cfg, prec, torch.arange(s, device=x.device))
    x = x + prec.mm(attention(q, k, v, True, prec).reshape(b, s, -1), lp["wo"])
    return _ffn(x, lp, cfg, prec)


def _layer(params: Dict, i: int) -> Dict:
    return {k: v[i] for k, v in params["layers"].items()}


def loss(params: Dict, batch: Dict, cfg: Dict, prec: Precision) -> torch.Tensor:
    """Next-token cross entropy over tokens[:, 1:] plus the aux loss's
    coefficient times the layers' summed load-balancing losses; each block
    under a checkpoint."""
    tokens = batch["tokens"]
    x = params["embed"][tokens]
    aux = x.new_zeros(())
    for i in range(cfg["num_hidden_layers"]):
        x, a = checkpoint(_block, x, _layer(params, i), cfg, prec, use_reentrant=False)
        aux = aux + a
    x = rms_norm(x, params["ln_f"], cfg["rms_norm_eps"])
    logits = prec.mm(x[:, :-1], params["lm_head"])
    return cross_entropy(logits, tokens[:, 1:]) + cfg["assumed"]["router_aux_loss_coef"] * aux
