"""Int8 weight quantization for the serving path.

Counterpart of ``hivedscheduler_tpu/models/quantize.py``: per-output-channel
symmetric int8 of the decode-path linears, as ``{"w": int8, "scale": f32}``
leaves that ``quantized_matmul`` (and so the whole KV-cache machinery in
``models/generate.py``) takes in place of a plain matrix. Plain torch ops,
as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .transformer import Params

# The decode-path linear weights ([in, out] matmuls re-read every step).
LAYER_LINEAR_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-output-channel symmetric int8 of an [in, out] matrix."""
    if w.dim() != 2:
        raise ValueError(f"expected [in, out] weight, got shape {tuple(w.shape)}")
    wf = w.float()
    scale = (wf.abs().amax(dim=0) / 127.0).clamp_min(1e-8)  # all-zero channels
    q = torch.clamp(torch.round(wf / scale), -127, 127)
    return {"w": q.to(torch.int8), "scale": scale}


def quantized_matmul(x: torch.Tensor, w: Any) -> torch.Tensor:
    """``x @ w`` where ``w`` is a plain matrix OR a quantized leaf: the int8
    weights are cast to the activation dtype and the per-channel scale is
    applied to the product."""
    if isinstance(w, dict):
        return (x @ w["w"].to(x.dtype)) * w["scale"].to(x.dtype)
    return x @ w


def _quantize_stacked(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    # Layer by layer, so the f32 working copy is one layer's, not the stack's.
    parts = [quantize_weight(w[i]) for i in range(w.shape[0])]
    return {
        "w": torch.stack([p["w"] for p in parts]),
        "scale": torch.stack([p["scale"] for p in parts]),
    }


def quantize_params(params: Params) -> Params:
    """Quantize the stacked per-layer linears and the untied ``lm_head``;
    everything else passes through unchanged."""
    out = dict(params)
    out["layers"] = {
        k: (_quantize_stacked(v) if k in LAYER_LINEAR_KEYS else v)
        for k, v in params["layers"].items()
    }
    if "lm_head" in params:
        out["lm_head"] = quantize_weight(params["lm_head"])
    return out
