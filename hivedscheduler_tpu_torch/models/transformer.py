"""Llama-style decoder-only transformer, single device.

Counterpart of ``hivedscheduler_tpu/models/transformer.py``. Parameters are
a plain dict in the JAX package's layout: stacked per-layer leaves
``[n_layers, ...]`` and ``[in, out]`` matrices applied as ``x @ W``, so a
JAX parameter tree converts without transposes (``models/convert.py``).
Attention goes through ``ops.attention.mha`` (the flash kernels for long
self-attention, forward and backward). Training keeps f32 master
parameters and casts them to the compute dtype on entry, as the JAX
package does; ``remat`` checkpoints each block (``torch.utils.checkpoint``)
under one of the JAX package's four policies. Meshes, sequence and pipeline
parallelism belong to later slices of the port.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from .. import Device, resolve_device
from ..ops.attention import mha  # also registers torch.ops.hived.flash_fwd

Params = Dict[str, Any]
REMAT_POLICIES = ("full", "dots", "flash", "dots+flash")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    # "full": recompute the whole block in backward (least memory).
    # "dots": keep the 2-D matrix products' outputs, recompute the rest.
    # "flash": keep only the flash forward kernel's (out, lse): backward
    # then skips the kernel's relaunch, the block's costliest recompute.
    # "dots+flash": both.
    remat_policy: str = "full"
    tied_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def llama3_8b() -> TransformerConfig:
    """Llama-3-8B shapes."""
    return TransformerConfig(
        vocab_size=128256,
        d_model=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        max_seq_len=8192,
        rope_theta=500000.0,
    )


def tiny(vocab: int = 512) -> TransformerConfig:
    """Small config for tests."""
    return TransformerConfig(
        vocab_size=vocab,
        d_model=128,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        max_seq_len=512,
        rope_theta=10000.0,
        dtype=torch.float32,
        remat=False,
    )


def init(
    config: TransformerConfig,
    generator: torch.Generator,
    device: Device = None,
    dtype: Optional[torch.dtype] = None,
) -> Params:
    """Random parameters, normal / sqrt(fan_in) as in the JAX package, drawn
    directly on the device in ``dtype``: the compute dtype by default
    (serving needs no f32 master copy), ``torch.float32`` for training's
    master parameters. ``generator`` lives on ``device``."""
    c = config
    device = resolve_device(device)
    dtype = c.dtype if dtype is None else dtype
    d, h, hk, dh, f, L = (
        c.d_model, c.n_heads, c.n_kv_heads, c.head_dim, c.d_ff, c.n_layers,
    )

    def norm(fan_in, shape):
        w = torch.empty(shape, dtype=dtype, device=device)
        w.normal_(generator=generator)
        return w.mul_(1.0 / math.sqrt(fan_in))

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    params: Params = {
        "embed": norm(1, (c.vocab_size, d)),
        "layers": {
            "ln1": ones((L, d)),
            "wq": norm(d, (L, d, h * dh)),
            "wk": norm(d, (L, d, hk * dh)),
            "wv": norm(d, (L, d, hk * dh)),
            "wo": norm(h * dh, (L, h * dh, d)),
            "ln2": ones((L, d)),
            "w_gate": norm(d, (L, d, f)),
            "w_up": norm(d, (L, d, f)),
            "w_down": norm(f, (L, f, d)),
        },
        "ln_f": ones((d,)),
    }
    if not c.tied_embeddings:
        params["lm_head"] = norm(d, (d, c.vocab_size))
    return params


def cast(tree: Any, dtype: torch.dtype) -> Any:
    """Cast every leaf to ``dtype``, except int8 (quantized) weights, which
    must stay int8. A leaf already in ``dtype`` is returned as it is."""
    if isinstance(tree, dict):
        return {k: cast(v, dtype) for k, v in tree.items()}
    return tree if tree.dtype == torch.int8 else tree.to(dtype)


def leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a parameter tree, in its (insertion) order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    return [tree]


def layer(layers: Params, i: int) -> Params:
    """Layer ``i``'s parameters: views into the stacked leaves."""
    return {
        k: ({kk: vv[i] for kk, vv in v.items()} if isinstance(v, dict) else v[i])
        for k, v in layers.items()
    }


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embeddings, half-split (rotate-half); x: [B, S, H, D],
    positions: [S]."""
    d = x.shape[-1]
    freqs = 1.0 / (
        theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    )
    angles = positions[:, None].float() * freqs[None, :]  # [S, D/2]
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _block(x: torch.Tensor, layer: Params, config: TransformerConfig) -> torch.Tensor:
    """One pre-norm block: attention (flash kernel via ``mha``) + SwiGLU."""
    c = config
    b, s, _ = x.shape
    h = rms_norm(x, layer["ln1"])
    q = (h @ layer["wq"]).reshape(b, s, c.n_heads, c.head_dim)
    k = (h @ layer["wk"]).reshape(b, s, c.n_kv_heads, c.head_dim)
    v = (h @ layer["wv"]).reshape(b, s, c.n_kv_heads, c.head_dim)
    positions = torch.arange(s, device=x.device)
    q = rope(q, positions, c.rope_theta)
    k = rope(k, positions, c.rope_theta)
    attn = mha(q, k, v, causal=True).reshape(b, s, c.n_heads * c.head_dim)
    x = x + attn @ layer["wo"]
    h = rms_norm(x, layer["ln2"])
    return x + (F.silu(h @ layer["w_gate"]) * (h @ layer["w_up"])) @ layer["w_down"]


def _remat_policy(name: str) -> Callable:
    """A config's remat_policy as a ``checkpoint`` ``context_fn`` ("full":
    recompute everything). The selective policies keep the outputs of the
    ops they name: ``aten.mm`` for "dots" (every product of the block with
    a weight is a 2-D ``mm`` after ``matmul`` folds the batch), the flash
    forward op for "flash". Where the flash op never runs (short sequences)
    "flash" keeps nothing and is "full", as in the JAX package."""
    if name not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {name!r}; one of {sorted(REMAT_POLICIES)}")
    if name == "full":
        return noop_context_fn
    saved = {"dots": [torch.ops.aten.mm.default], "flash": [torch.ops.hived.flash_fwd.default]}
    ops = [op for part in name.split("+") for op in saved[part]]
    return functools.partial(create_selective_checkpoint_contexts, ops)


def _unstack(layers: Params) -> List[Params]:
    """Per-layer views of the stacked leaves, one ``unbind`` a leaf: the
    backward stacks the layer gradients once, instead of scattering each
    into its own zero ``[L, ...]`` tensor as indexing would."""
    cols = {k: v.unbind(0) for k, v in layers.items()}
    n = len(next(iter(cols.values())))
    return [{k: col[i] for k, col in cols.items()} for i in range(n)]


def forward_hidden(
    params: Params, tokens: torch.Tensor, config: TransformerConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final normed hidden states [B, S, D] (compute dtype) and the LM-head
    weight [D, V]. Differentiable: with ``config.remat`` each block is
    checkpointed under ``config.remat_policy`` when autograd records."""
    c = config
    context_fn = _remat_policy(c.remat_policy) if c.remat else None
    params = cast(params, c.dtype)  # f32 master -> compute dtype
    x = params["embed"][tokens]
    for lp in _unstack(params["layers"]):
        if c.remat and torch.is_grad_enabled():
            x = checkpoint(_block, x, lp, c, use_reentrant=False, context_fn=context_fn)
        else:
            x = _block(x, lp, c)
    x = rms_norm(x, params["ln_f"])
    head = params["embed"].T if c.tied_embeddings else params["lm_head"]
    return x, head


def forward(
    params: Params, tokens: torch.Tensor, config: TransformerConfig
) -> torch.Tensor:
    """Logits [B, S, V] in f32; ``tokens`` [B, S] int."""
    x, head = forward_hidden(params, tokens, config)
    return (x @ head).float()
