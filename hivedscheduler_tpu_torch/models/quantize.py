"""Int8 weight quantization for the serving path.

Counterpart of ``hivedscheduler_tpu/models/quantize.py``: per-output-channel
symmetric int8 of the decode-path linears, as ``{"w": int8, "scale": f32}``
leaves that ``quantized_matmul`` (and so the whole KV-cache machinery in
``models/generate.py``) takes in place of a plain matrix. Plain torch ops,
as the JAX package leaves them to XLA.

On a mesh the tree's leaves are DTensors placed by the rule table, and
:func:`quantize_params` quantizes each rank's shards where they lie: the
per-channel max over the in dim is taken on the local rows, then over the
mesh axis that shards the in dim (fsdp for the products whose in dim is
``embed``, tp for ``wo`` and ``w_down``, whose in dim is ``heads`` or
``mlp``). The max is exact and the rest is elementwise, so every shard is,
bit for bit, that block of the one-process tree. :func:`quantized_axes`
names the int8 tree's dims, so that placement, gathers and ``convert``
agree.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor

from ..parallel import sharding

Params = Dict[str, Any]

# The decode-path linear weights ([in, out] matmuls re-read every step).
LAYER_LINEAR_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-output-channel symmetric int8 of an [in, out] matrix."""
    if w.dim() != 2:
        raise ValueError(f"expected [in, out] weight, got shape {tuple(w.shape)}")
    return _quantize(w)


def _quantize(w: torch.Tensor, names: Optional[Sequence[Optional[str]]] = None) -> Dict[str, Any]:
    """An [in, out] matrix or an [L, in, out] stack, layer by layer (the
    f32 working copy is one layer's). A DTensor is quantized on this rank's
    shard: the max over the in dim is completed over the mesh axes that the
    rule table gives its logical ``names``' in dim, and the int8 leaves are
    DTensors on its mesh, placed by :func:`int8_axes`."""
    dtensor = isinstance(w, DTensor)
    local = w.to_local() if dtensor else w
    parts = []
    for m in ([local] if local.dim() == 2 else local.unbind(0)):
        wf = m.float()
        amax = wf.abs().amax(dim=0)
        if dtensor:
            amax = sharding.all_reduce_max(amax, w.device_mesh, sharding.spec_for(names)[-2])
        scale = (amax / 127.0).clamp_min(1e-8)  # all-zero channels
        q = torch.clamp(torch.round(wf / scale), -127, 127)
        parts.append({"w": q.to(torch.int8), "scale": scale})
    out = {k: parts[0][k] if local.dim() == 2 else torch.stack([p[k] for p in parts])
           for k in ("w", "scale")}
    if dtensor:
        axes = int8_axes(names)
        for key, shape in (("w", w.shape), ("scale", w.shape[:-2] + w.shape[-1:])):
            out[key] = DTensor.from_local(
                out[key], w.device_mesh, sharding.placements_for(axes[key], w.device_mesh),
                run_check=False, shape=shape, stride=torch.empty(shape, device="meta").stride())
    return out


def quantized_matmul(x: torch.Tensor, w: Any) -> torch.Tensor:
    """``x @ w`` where ``w`` is a plain matrix OR a quantized leaf: the int8
    weights are cast to the activation dtype and the per-channel scale is
    applied to the product."""
    if isinstance(w, dict):
        return (x @ w["w"].to(x.dtype)) * w["scale"].to(x.dtype)
    return x @ w


def int8_axes(names: Sequence[Optional[str]]) -> Dict[str, Tuple[Optional[str], ...]]:
    """The logical axes of a quantized leaf from its matrix's ([..., in,
    out]): ``w`` keeps them; ``scale`` drops the in dim."""
    names = tuple(names)
    return {"w": names, "scale": names[:-2] + names[-1:]}


def quantized_axes(axes: Params) -> Params:
    """A model's ``logical_axes`` tree for its :func:`quantize_params`
    tree: the stacked linears and ``lm_head`` as :func:`int8_axes`."""
    out = dict(axes)
    out["layers"] = {k: (int8_axes(v) if k in LAYER_LINEAR_KEYS else v)
                     for k, v in axes["layers"].items()}
    if "lm_head" in axes:
        out["lm_head"] = int8_axes(axes["lm_head"])
    return out


def quantize_params(params: Params, axes: Optional[Params] = None) -> Params:
    """Quantize the stacked per-layer linears and the untied ``lm_head``;
    everything else passes through unchanged. DTensor leaves (a tree on a
    mesh) need the model's ``logical_axes`` as ``axes``: the int8 leaves
    are DTensors on the same mesh, ``w`` placed as its matrix and ``scale``
    by its out dim's name (:func:`quantized_axes`)."""

    def one(w, names):
        if isinstance(w, DTensor) and names is None:
            raise ValueError("quantizing DTensor leaves needs the model's logical_axes")
        return _quantize(w, names)

    axes = axes or {}
    out = dict(params)
    out["layers"] = {
        k: (one(v, axes.get("layers", {}).get(k)) if k in LAYER_LINEAR_KEYS else v)
        for k, v in params["layers"].items()
    }
    if "lm_head" in params:
        out["lm_head"] = one(params["lm_head"], axes.get("lm_head"))
    return out


def shard_digest(params: Params) -> str:
    """SHA-256 over this rank's int8 ``w`` and ``scale`` blocks (the whole
    leaves without a mesh), in tree order: equal on two ranks, or a rank
    and a slice of the one-process tree, only where they hold the same
    bytes."""
    h = hashlib.sha256()
    for leaf in [params["layers"][k] for k in LAYER_LINEAR_KEYS] + (
            [params["lm_head"]] if "lm_head" in params else []):
        for key in ("w", "scale"):
            t = leaf[key]
            t = t.to_local() if isinstance(t, DTensor) else t
            h.update(t.detach().contiguous().cpu().numpy())
    return h.hexdigest()
