"""Autoregressive decoding with a preallocated KV cache.

Counterpart of ``hivedscheduler_tpu/models/generate.py``, in eager PyTorch:

- the cache is ``[layers, batch, max_len, kv_heads, head_dim]`` as in the
  JAX package, but it is written in place (JAX returns a new cache), and its
  fill ``length`` is a host int, so the "auto" attention mode is a plain
  branch on the host;
- prefill of a fresh cache runs the prompt's causal self-attention through
  ``ops.attention.mha``, i.e. the flash kernel; decode steps and chunked
  prefill attend over the cache with a grouped GQA einsum (no kernel in
  the JAX package either);
- ``generate_scan``/``generate_greedy_scan`` keep the JAX names and
  semantics as Python loops (CUDA graphs are later work);
- sampling draws from a ``torch.Generator``, so its stream differs from
  ``jax.random``'s: the two agree in distribution, not token by token;
- on an active mesh (``parallel/sharding.is_active``) the weights are
  DTensors (tp shards, gathered over fsdp a layer at a time; int8 leaves
  gathered as int8, and ``wo``'s and ``w_down``'s whole-width scale applied
  before their tp sum, equal to JAX's value in exact arithmetic), the prompt
  and the cache hold this rank's batch rows and its KV heads, the flash
  prefill runs on that block, and the logits are gathered over tp before
  sampling, so the ranks of a tp group sample from the same logits;
- ``ffn``: the hook ``ffn(h_normed, layer, mesh)`` that replaces the dense
  SwiGLU, as in the JAX package: how the MoE family
  (``mixtral.decode_ffn``) rides the same cache machinery. On a mesh it
  gets the layer whole over fsdp and returns the whole output.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import Device, resolve_device
from ..parallel import sharding
from . import model_of
from ..ops.attention import NEG_INF, mha
from .quantize import quantized_matmul as _mm
from .transformer import (
    Params, TransformerConfig, cast, gather_head, gather_layer, layer, rms_norm, rope,
)


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # [L, B, S_max, Hkv, D]
    v: torch.Tensor  # [L, B, S_max, Hkv, D]
    length: int  # filled positions


def _heads_local(config: TransformerConfig, batch: int, mesh: Any) -> bool:
    """True where the ranks of the tp group each attend their own heads
    (``sharding.mha_shardable``); False where they attend all of them."""
    if not sharding.is_active(mesh):
        return True
    dpf = sharding.axes_size(sharding.BATCH_AXES, mesh)
    return sharding.mha_shardable(batch * dpf, config.n_heads, config.n_kv_heads, mesh)


def init_cache(
    config: TransformerConfig, batch: int, max_len: int, device: Device = None,
    mesh: Any = None,
) -> KVCache:
    """An empty cache for ``batch`` rows (on an active mesh: this rank's
    rows and the KV heads it attends)."""
    c = config
    kv = c.n_kv_heads
    if sharding.is_active(mesh) and _heads_local(c, batch, mesh):
        kv //= sharding.axes_size("tp", mesh)
    shape = (c.n_layers, batch, max_len, kv, c.head_dim)
    device = resolve_device(device)
    return KVCache(
        k=torch.zeros(shape, dtype=c.dtype, device=device),
        v=torch.zeros(shape, dtype=c.dtype, device=device),
        length=0,
    )


def _attend_cached(
    q: torch.Tensor,  # [B, T, H, D]
    k_cache: torch.Tensor,  # [B, S_max, Hkv, D]
    v_cache: torch.Tensor,
    q_offset: int,  # absolute position of q[:, 0]
) -> torch.Tensor:
    """Causal attention of T queries over the cache, GQA as a grouped einsum
    (no repeat of the cache). Only the filled prefix ``q_offset + T`` is
    read: the empty slots beyond it are masked in the JAX package and add
    exactly zero there."""
    b, t, h, d = q.shape
    hkv = k_cache.shape[2]
    n = q_offset + t
    kc, vc = k_cache[:, :n], v_cache[:, :n]
    qg = q.reshape(b, t, hkv, h // hkv, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), kc.float()) / math.sqrt(d)
    q_pos = q_offset + torch.arange(t, device=q.device)[:, None]
    k_pos = torch.arange(n, device=q.device)[None, :]
    scores = torch.where(q_pos >= k_pos, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, vc)
    return out.reshape(b, t, h, d)


def _block_cached(
    x: torch.Tensor,  # [B, T, D]
    layer: Params,
    k_cache: torch.Tensor,  # [B, S_max, Hkv, D], written in place
    v_cache: torch.Tensor,
    pos: int,
    config: TransformerConfig,
    attn_mode: str = "auto",
    mesh: Any = None,
    ffn: Optional[Callable] = None,
) -> torch.Tensor:
    """One decoder block over cached KV. ``attn_mode``: "flash" = fresh-cache
    prefill, prompt-only causal attention through ``mha``; "cached" =
    attention over the cache (decode, chunked prefill); "auto" = "flash"
    when ``pos == 0``, else "cached". On an active mesh ``layer`` holds this
    rank's tp shards, as in ``transformer._block``. ``ffn``: the hook in
    place of the dense SwiGLU."""
    if attn_mode not in ("auto", "flash", "cached"):
        raise ValueError(f"unknown attn_mode {attn_mode!r}")
    c = config
    b, t, _ = x.shape
    h = rms_norm(x, layer["ln1"])
    q, k, v = _mm(h, layer["wq"]), _mm(h, layer["wk"]), _mm(h, layer["wv"])
    width = q.shape[-1]
    gathered = not _heads_local(c, b, mesh)
    if gathered:  # the JAX package's fallback: every head on every tp rank
        q, k, v = (sharding.gather_tp(y, 2, mesh) for y in (q, k, v))
    q = q.reshape(b, t, -1, c.head_dim)
    k = k.reshape(b, t, -1, c.head_dim)
    v = v.reshape(b, t, -1, c.head_dim)
    positions = pos + torch.arange(t, device=x.device)
    q = rope(q, positions, c.rope_theta)
    k = rope(k, positions, c.rope_theta)
    k_cache[:, pos:pos + t] = k
    v_cache[:, pos:pos + t] = v
    if attn_mode == "auto":
        attn_mode = "flash" if pos == 0 else "cached"
    if t > 1 and attn_mode == "flash":
        attn = mha(q, k, v, causal=True).to(q.dtype)
    else:  # a decode step (t == 1) or a chunked prefill
        attn = _attend_cached(q, k_cache, v_cache, pos)
    attn = attn.reshape(b, t, -1)
    if gathered:
        attn = attn.narrow(2, mesh.get_local_rank("tp") * width, width)
    x = x + sharding.reduce_from(_mm(attn, layer["wo"]), mesh)
    hh = rms_norm(x, layer["ln2"])
    if ffn is not None:
        return x + ffn(hh, layer, mesh)
    out = _mm(F.silu(_mm(hh, layer["w_gate"])) * _mm(hh, layer["w_up"]), layer["w_down"])
    return x + sharding.reduce_from(out, mesh)


@torch.inference_mode()
def _forward_cached(
    params: Params,
    tokens: torch.Tensor,  # [B, T]
    cache: KVCache,
    config: TransformerConfig,
    attn_mode: str = "auto",
    last_only: bool = False,
    mesh: Any = None,
    ffn: Optional[Callable] = None,
) -> Tuple[torch.Tensor, KVCache]:
    """Logits [B, T, V] f32 (``last_only``: [B, 1, V], the LM head applied to
    the last position alone) and the cache, advanced by T. On an active
    mesh, ``tokens`` and the logits are this rank's rows, every vocab id."""
    c = config
    pos = cache.length
    if pos + tokens.shape[1] > cache.k.shape[2]:
        raise ValueError(
            f"cache of {cache.k.shape[2]} positions cannot take "
            f"{tokens.shape[1]} more after {pos}"
        )
    if sharding.is_active(mesh):
        local = sharding.to_local(params)
        axes = model_of(c).logical_axes(c)["layers"]

        def layer_at(i):
            return gather_layer(layer(local["layers"], i), c, mesh, axes)

        x = sharding.embed_lookup(local["embed"], tokens, mesh, c.dtype)
        ln_f = local["ln_f"].to(c.dtype)
        head = gather_head(local, c, mesh)
    else:
        params = cast(params, c.dtype)  # int8 leaves stay int8
        x = params["embed"][tokens]
        ln_f = params["ln_f"]
        head = params["embed"].T if c.tied_embeddings else params["lm_head"]

        def layer_at(i):
            return layer(params["layers"], i)

    for i in range(c.n_layers):
        x = _block_cached(x, layer_at(i), cache.k[i], cache.v[i], pos, c, attn_mode, mesh, ffn)
    if last_only:
        x = x[:, -1:]
    x = rms_norm(x, ln_f)
    logits = _mm(x, head)
    if sharding.is_active(mesh):
        logits = sharding.gather_tp(logits, 2, mesh)
    cache.length = pos + tokens.shape[1]
    return logits.float(), cache


def prefill(
    params: Params,
    prompt: torch.Tensor,  # [B, T_prompt]
    cache: KVCache,
    config: TransformerConfig,
    chunked: Optional[bool] = None,
    mesh: Any = None,
    ffn: Optional[Callable] = None,
) -> Tuple[torch.Tensor, KVCache]:
    """Fill the cache with the prompt; returns (last-position logits [B, V],
    cache). A fresh cache takes the flash program, a cache with history the
    cached one. ``chunked`` forces the choice; ``chunked=False`` (the flash
    program, prompt-only attention) on a cache with history raises: it
    would ignore the history."""
    if chunked is None:
        mode = "flash" if cache.length == 0 else "cached"
    else:
        mode = "cached" if chunked else "flash"
    if mode == "flash" and cache.length > 0:
        raise ValueError(
            f"prefill(chunked=False) needs a fresh cache; this one holds "
            f"{cache.length} positions (use chunked=None or True)"
        )
    logits, cache = _forward_cached(
        params, prompt, cache, config, mode, last_only=True, mesh=mesh, ffn=ffn
    )
    return logits[:, -1], cache


def decode_step(
    params: Params,
    token: torch.Tensor,  # [B]: previous token
    cache: KVCache,
    config: TransformerConfig,
    mesh: Any = None,
    ffn: Optional[Callable] = None,
) -> Tuple[torch.Tensor, KVCache]:
    """One decoding step; returns (logits [B, V], cache)."""
    logits, cache = _forward_cached(params, token[:, None], cache, config, mesh=mesh, ffn=ffn)
    return logits[:, 0], cache


@torch.inference_mode()
def sample_logits(
    logits: torch.Tensor,  # [..., V]
    generator: Optional[torch.Generator],
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """Temperature / top-k / top-p (nucleus) sampling; greedy when
    ``temperature <= 0`` or ``generator is None``. Top-k masks below the
    k-th logit; top-p masks tokens whose exclusive prefix mass in the sorted
    distribution reaches ``top_p`` (the top-1 token is always kept)."""
    if temperature <= 0.0 or generator is None:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / temperature
    v = logits.shape[-1]
    if top_k and top_k < v:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p < 1.0:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        exclusive_mass = torch.cumsum(probs, dim=-1) - probs
        keep = exclusive_mass < top_p
        # Keep the best token: top_p <= 0 would otherwise mask the whole row.
        keep[..., 0] = True
        threshold = torch.where(keep, sorted_desc, math.inf).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < threshold, NEG_INF, logits)
    probs = torch.softmax(logits, dim=-1).reshape(-1, v)
    return torch.multinomial(probs, 1, generator=generator).reshape(logits.shape[:-1])


def generate_stream(
    params: Params,
    prompt: torch.Tensor,  # [B, T_prompt]
    config: TransformerConfig,
    max_new_tokens: int,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    top_k: int = 0,
    top_p: float = 1.0,
    mesh: Any = None,
    ffn: Optional[Callable] = None,
) -> Iterator[torch.Tensor]:
    """Yield the ``max_new_tokens`` new tokens, each [B], as they are made:
    a flash prefill of a fresh cache, then one decode step per token. On
    an active ``mesh``, ``prompt`` is this rank's rows; the ranks of a tp
    group must pass generators in the same state."""
    b, t = prompt.shape
    cache = init_cache(config, b, t + max_new_tokens, device=prompt.device, mesh=mesh)
    logits, cache = prefill(params, prompt, cache, config, mesh=mesh, ffn=ffn)
    token = sample_logits(logits, generator, temperature, top_k, top_p)
    for i in range(max_new_tokens):
        yield token
        if i == max_new_tokens - 1:
            break
        logits, cache = decode_step(params, token, cache, config, mesh, ffn)
        token = sample_logits(logits, generator, temperature, top_k, top_p)


def generate(
    params: Params,
    prompt: torch.Tensor,  # [B, T_prompt]
    config: TransformerConfig,
    max_new_tokens: int,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    top_k: int = 0,
    top_p: float = 1.0,
    ffn: Optional[Callable] = None,
) -> torch.Tensor:
    """Greedy (temperature=0) or sampled generation; returns
    [B, T_prompt + max_new_tokens]. ``ffn``: the MoE hook
    (``mixtral.decode_ffn``)."""
    new = generate_stream(
        params, prompt, config, max_new_tokens, temperature, generator, top_k, top_p, ffn=ffn
    )
    return torch.cat([prompt] + [tok[:, None].to(prompt.dtype) for tok in new], dim=1)


def generate_scan(
    params: Params,
    prompt: torch.Tensor,
    config: TransformerConfig,
    max_new_tokens: int,
    generator: Optional[torch.Generator],
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    ffn: Optional[Callable] = None,
) -> torch.Tensor:
    """Sampled generation under the JAX package's name and defaults. JAX
    compiles it as one program; eager PyTorch runs the same loop as
    ``generate``."""
    return generate(
        params, prompt, config, max_new_tokens, temperature, generator, top_k, top_p, ffn
    )


def generate_greedy_scan(
    params: Params,
    prompt: torch.Tensor,
    config: TransformerConfig,
    max_new_tokens: int,
) -> torch.Tensor:
    """Greedy generation; ``generate_scan`` at temperature 0."""
    return generate_scan(params, prompt, config, max_new_tokens, None, temperature=0.0)
