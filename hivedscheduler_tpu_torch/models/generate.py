"""Autoregressive decoding with a preallocated KV cache and a captured
decode step.

Counterpart of ``hivedscheduler_tpu/models/generate.py``, where one
compiled ``decode_step`` serves every position:

- the cache is ``[layers, batch, max_len, kv_heads, head_dim]`` as in the
  JAX package, written in place (JAX returns a new cache) at its fill
  ``length``, a 0-d int32 tensor on the cache's device, as JAX's device
  scalar: K/V go in with ``index_copy_`` at ``length + arange(t)``, RoPE
  takes the same positions, and a decode step attends over all ``max_len``
  slots under JAX's mask ``q_pos >= k_pos``, so slots past the fill (a
  previous request's K/V) add exactly zero. A decode step has no shape
  that depends on the fill and reads nothing back from the device. Next to
  the device fill, ``issued`` counts on the host the positions handed out;
  only the overflow check and the fresh-cache gates read it;
- prefill of a fresh cache runs the prompt's causal self-attention through
  ``ops.attention.mha``, i.e. the flash kernel; decode steps and chunked
  prefill attend over the cache with a grouped GQA einsum (no kernel in
  the JAX package either);
- on CUDA tensors, with an active mesh or without, the decode step runs
  from a ``torch.cuda.CUDAGraph``, the port's counterpart of ``jax.jit``:
  one graph for each (batch, max_len, sampling arguments, ``ffn``) of a
  parameter tree on a mesh (or on none), captured on that shape's first
  step and replayed by every later one. It holds the one-token forward,
  the sampling, the advance of the fill and the copy of the new token
  into the next step's input: ``generate_scan``'s ``lax.scan`` body. A
  graph reads fixed addresses, so it is bound to one cache and to the
  weights it was captured on. Its owner (:func:`decoder`) holds the cache
  and buffers of each shape, holds the weights only weakly, and is
  dropped with the first of them; ``decode_step`` replays the graph of
  the owner whose ``init_cache`` made its cache. The eager loop stays as the plain
  version of the step (``plain=True``, and the CPU path);
- sampling draws one uniform a vocab entry from a ``torch.Generator``
  outside the graph and picks by the exponential race (the argmax of
  ``p / E`` with ``E = -log(1 - u)``), so the graph and the eager loop give
  the same tokens from one generator state. The stream differs from
  ``jax.random``'s: the two packages agree in distribution, not token by
  token;
- on an active mesh (``parallel/sharding.is_active``) the weights are
  DTensors (tp shards, gathered over fsdp a layer at a time; int8 leaves
  gathered as int8, and ``wo``'s and ``w_down``'s whole-width scale applied
  before their tp sum, equal to JAX's value in exact arithmetic), the prompt
  and the cache hold this rank's batch rows and its KV heads, the flash
  prefill runs on that block, and the logits are gathered over tp before
  sampling, so the ranks of a tp group sample from the same logits. A
  rank's captured step holds its collectives (the tp all-reduces, the
  embedding's, the logits' tp gather, the per-layer fsdp gathers, the MoE
  routing's token gathers and ep sums), as XLA places them inside JAX's
  jitted step: the ranks of a gang capture and replay the same steps in
  the same order, since shapes, sampling arguments and ``ffn`` agree
  across a tp or ep group;
- ``ffn``: the hook ``ffn(h_normed, layer, mesh)`` that replaces the dense
  SwiGLU, as in the JAX package: how the MoE family
  (``mixtral.decode_ffn``) rides the same cache machinery, captured steps
  included. On a mesh it gets the layer whole over fsdp and returns the
  whole output.
"""

from __future__ import annotations

import dataclasses
import math
import time
import weakref
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import Device, resolve_device
from ..parallel import sharding
from . import model_of
from ..ops.attention import NEG_INF, mha
from .quantize import quantized_matmul as _mm
from .transformer import (
    Params, TransformerConfig, cast, gather_head, gather_layer, layer, leaves, rms_norm, rope,
)

# (temperature, top_k, top_p) of a sampled decode; None: greedy.
Sampling = Optional[Tuple[float, int, float]]


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # [L, B, S_max, Hkv, D]
    v: torch.Tensor  # [L, B, S_max, Hkv, D]
    length: torch.Tensor  # [] int32 on the cache's device: filled positions
    issued: int = 0  # positions handed out, counted on the host


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
    rows and the KV heads it attends). A captured decode step needs its
    owner's cache instead: ``decoder(params, config, mesh).init_cache``."""
    c = config
    kv = c.n_kv_heads
    if sharding.is_active(mesh) and _heads_local(c, batch, mesh):
        kv //= sharding.axes_size("tp", mesh)
    shape = (c.n_layers, batch, max_len, kv, c.head_dim)
    device = resolve_device(device)
    return KVCache(
        k=torch.zeros(shape, dtype=c.dtype, device=device),
        v=torch.zeros(shape, dtype=c.dtype, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device),
    )


def _check_room(cache: KVCache, t: int) -> None:
    if cache.issued + t > cache.k.shape[2]:
        raise ValueError(
            f"cache of {cache.k.shape[2]} positions cannot take {t} more after {cache.issued}"
        )


def _attend_cached(
    q: torch.Tensor,  # [B, T, H, D]
    k_cache: torch.Tensor,  # [B, S_max, Hkv, D]
    v_cache: torch.Tensor,
    q_offset: torch.Tensor,  # [] int: absolute position of q[:, 0]
) -> torch.Tensor:
    """Causal attention of T queries over the whole cache, GQA as a grouped
    einsum (no repeat of the cache). Every slot is read; those past
    ``q_offset + T`` are masked, as in the JAX package, and add exactly
    zero whatever they hold."""
    b, t, h, d = q.shape
    s_max, hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, t, hkv, h // hkv, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k_cache.float()) / math.sqrt(d)
    q_pos = q_offset + torch.arange(t, device=q.device)[:, None]
    k_pos = torch.arange(s_max, device=q.device)[None, :]
    scores = torch.where(q_pos >= k_pos, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v_cache)
    return out.reshape(b, t, h, d)


def _block_cached(
    x: torch.Tensor,  # [B, T, D]
    layer: Params,
    k_cache: torch.Tensor,  # [B, S_max, Hkv, D], written in place
    v_cache: torch.Tensor,
    pos: torch.Tensor,  # [] int: the cache's fill, on its device
    config: TransformerConfig,
    attn_mode: str = "cached",
    mesh: Any = None,
    ffn: Optional[Callable] = None,
) -> torch.Tensor:
    """One decoder block over cached KV. ``attn_mode``: "flash" = fresh-cache
    prefill, prompt-only causal attention through ``mha``; "cached" =
    attention over the cache (decode, chunked prefill). On an active mesh
    ``layer`` holds this rank's tp shards, as in ``transformer._block``.
    ``ffn``: the hook in place of the dense SwiGLU."""
    if attn_mode not in ("flash", "cached"):
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
    k_cache.index_copy_(1, positions, k)
    v_cache.index_copy_(1, positions, v)
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
def _forward_tokens(
    params: Params,
    tokens: torch.Tensor,  # [B, T]
    cache: KVCache,
    config: TransformerConfig,
    attn_mode: str,
    last_only: bool = False,
    mesh: Any = None,
    ffn: Optional[Callable] = None,
) -> torch.Tensor:
    """The device work of :func:`_forward_cached`: logits [B, T, V] f32
    (``last_only``: [B, 1, V]); the cache written at its device fill, which
    advances by T in place. Reads nothing back and touches no host count,
    so a decode step of it can be captured."""
    c = config
    pos = cache.length
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
    cache.length.add_(tokens.shape[1])
    return logits.float()


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
    the last position alone) and the cache, advanced by T. "auto" takes
    "flash" on a fresh cache (by the host count), else "cached". On an
    active mesh, ``tokens`` and the logits are this rank's rows, every
    vocab id."""
    t = tokens.shape[1]
    _check_room(cache, t)
    if attn_mode == "auto":
        attn_mode = "flash" if cache.issued == 0 else "cached"
    logits = _forward_tokens(params, tokens, cache, config, attn_mode, last_only, mesh, ffn)
    cache.issued += t
    return logits, cache


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
    would ignore the history. Eager on every device."""
    if chunked is None:
        mode = "flash" if cache.issued == 0 else "cached"
    else:
        mode = "cached" if chunked else "flash"
    if mode == "flash" and cache.issued > 0:
        raise ValueError(
            f"prefill(chunked=False) needs a fresh cache; this one holds "
            f"{cache.issued} positions (use chunked=None or True)"
        )
    logits, cache = _forward_cached(
        params, prompt, cache, config, mode, last_only=True, mesh=mesh, ffn=ffn
    )
    return logits[:, -1], cache


def _graphed(x: torch.Tensor) -> bool:
    """Whether a decode step on ``x``'s device runs from a captured graph:
    on CUDA tensors, on a mesh or not."""
    return x.is_cuda


def decode_step(
    params: Params,
    token: torch.Tensor,  # [B]: previous token
    cache: KVCache,
    config: TransformerConfig,
    mesh: Any = None,
    ffn: Optional[Callable] = None,
) -> Tuple[torch.Tensor, KVCache]:
    """One decoding step; returns (logits [B, V], cache). On CUDA it
    replays the captured step of the owner that made ``cache``
    (``decoder(params, config, mesh).init_cache``; any other CUDA cache
    raises); elsewhere it runs eagerly."""
    if _graphed(cache.k):
        return decoder(params, config, mesh).step(params, token, cache, ffn), cache
    logits, cache = _forward_cached(params, token[:, None], cache, config, mesh=mesh, ffn=ffn)
    return logits[:, 0], cache


def _draw(noise: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Fill ``noise`` with uniforms in [0, 1) from ``generator``: the one
    random draw of a sampled step, made outside any graph."""
    return noise.uniform_(0.0, 1.0, generator=generator)


def _pick(
    logits: torch.Tensor,  # [..., V]
    noise: Optional[torch.Tensor],  # [..., V] uniforms; None: greedy
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """The token :func:`sample_logits` picks, given its uniforms: no host
    read and no randomness of its own, so a captured step can hold it."""
    if noise is None:
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
    probs = torch.softmax(logits, dim=-1)
    # The exponential race: token i arrives at E_i / p_i with E_i ~ Exp(1),
    # and the first to arrive is i with probability p_i. E_i = 0 (u = 0) is
    # raised to the least normal float, so a masked token (p_i = 0) never
    # arrives and no 0/0 appears.
    arrival = (-torch.log1p(-noise)).clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(probs / arrival, dim=-1)


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
    distribution reaches ``top_p`` (the top-1 token is always kept). One
    uniform a vocab entry is drawn from ``generator``."""
    if temperature <= 0.0 or generator is None:
        return _pick(logits, None)
    noise = _draw(torch.empty(logits.shape, dtype=torch.float32, device=logits.device),
                  generator)
    return _pick(logits, noise, temperature, top_k, top_p)


def _sampling(temperature: float, generator: Optional[torch.Generator], top_k: int,
              top_p: float) -> Sampling:
    if temperature <= 0.0 or generator is None:
        return None
    return (float(temperature), int(top_k), float(top_p))


def _capture(fn: Callable[[], torch.Tensor], restore: Callable[[], None]
             ) -> Tuple[Callable[[], None], torch.Tensor]:
    """Capture ``fn`` (device work only) into a CUDA graph; returns (replay,
    the graph's output tensor). ``fn`` runs once on a side stream first,
    as ``torch.cuda.graph`` asks, and ``restore`` then puts back the state
    that run moved. A capture that fails raises."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        restore()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph.replay, out


@dataclasses.dataclass
class _Slot:
    """One (batch, max_len) of a :class:`Decoder`: the cache its graphs
    write, the step's input token, the step's uniforms, and the graphs."""

    cache: KVCache
    token: torch.Tensor  # [B] int64: the next step's input
    noise: Optional[torch.Tensor] = None  # [B, V] f32, made at the first sampled step
    graphs: Dict[Any, Tuple[Callable[[], None], torch.Tensor]] = dataclasses.field(
        default_factory=dict)
    busy: bool = False


class Decoder:
    """The captured decode steps of one parameter tree on one card, or of
    this rank's shards of it on a mesh (the port's counterpart of JAX's
    compile cache for ``decode_step``). Made and found by :func:`decoder`.
    It holds, for each (batch, max_len), a cache and the step's buffers
    (on a mesh: this rank's rows and KV heads), and for each (sampling
    arguments, ``ffn``) of that shape one graph. It refers to the weights
    weakly: the graphs read their addresses, and :func:`decoder` drops
    the owner (its graphs, caches and buffers) as soon as one of them is
    freed.

    ``captures``, ``capture_s`` and ``replays`` count over every owner, as
    the kernels' ``launches`` do."""

    captures = 0
    capture_s = 0.0
    replays = 0

    def __init__(self, params: Params, config: TransformerConfig, mesh: Any = None):
        self.config = config
        self.mesh = mesh
        self.device = params["embed"].device
        self._slots: Dict[Tuple[int, int], _Slot] = {}

    def _slot(self, batch: int, max_len: int) -> _Slot:
        slot = self._slots.get((batch, max_len))
        if slot is None:
            with torch.inference_mode():
                slot = _Slot(
                    cache=init_cache(self.config, batch, max_len, self.device, self.mesh),
                    token=torch.zeros(batch, dtype=torch.long, device=self.device),
                )
            self._slots[(batch, max_len)] = slot
        if slot.busy:
            raise RuntimeError(
                f"a stream of batch {batch} and {max_len} positions is still running on this "
                "tree's decoder: its cache serves one request at a time"
            )
        return slot

    @staticmethod
    def _empty(cache: KVCache) -> KVCache:
        with torch.inference_mode():
            cache.length.zero_()
        cache.issued = 0
        return cache

    def init_cache(self, batch: int, max_len: int) -> KVCache:
        """This owner's empty cache for ``batch`` rows and ``max_len``
        positions, the one its graphs of that shape write. There is one a
        shape: the next request or ``init_cache`` of that shape empties it."""
        return self._empty(self._slot(batch, max_len).cache)

    def _graph(self, params: Params, slot: _Slot, sampling: Any, ffn: Optional[Callable]
               ) -> Tuple[Callable[[], None], torch.Tensor]:
        """The slot's graph for ``sampling`` ("logits" for ``decode_step``,
        else a stream's sampling arguments) and ``ffn``, captured now if
        this is its first step. The capture's warm-up runs a real step;
        the fill and the input token are put back after it."""
        key = (sampling, ffn)  # called in inference mode
        if key in slot.graphs:
            return slot.graphs[key]
        cache, config = slot.cache, self.config

        def step():
            logits = _forward_tokens(params, slot.token[:, None], cache, config, "cached",
                                     mesh=self.mesh, ffn=ffn)[:, 0]
            if sampling == "logits":
                return logits
            nxt = _pick(logits, slot.noise if sampling else None, *(sampling or ()))
            slot.token.copy_(nxt)
            return nxt

        saved = (cache.length.clone(), slot.token.clone())

        def restore():
            cache.length.copy_(saved[0])
            slot.token.copy_(saved[1])

        t0 = time.perf_counter()
        slot.graphs[key] = _capture(step, restore)
        Decoder.captures += 1
        Decoder.capture_s += time.perf_counter() - t0
        return slot.graphs[key]

    def _replay(self, replay: Callable[[], None], cache: KVCache) -> None:
        replay()
        cache.issued += 1
        Decoder.replays += 1

    def step(self, params: Params, token: torch.Tensor, cache: KVCache,
             ffn: Optional[Callable] = None) -> torch.Tensor:
        """``decode_step`` on this owner's ``cache``: logits [B, V] (a copy
        of the graph's output)."""
        slot = next((s for s in self._slots.values() if s.cache is cache), None)
        if slot is None:
            raise ValueError("a captured decode step writes its owner's cache: make it with "
                             "generate.decoder(params, config, mesh).init_cache(batch, max_len)")
        _check_room(cache, 1)
        with torch.inference_mode():
            slot.token.copy_(token)
            replay, out = self._graph(params, slot, "logits", ffn)
            self._replay(replay, cache)
            return out.clone()

    def stream(self, params: Params, prompt: torch.Tensor, max_new_tokens: int,
               sampling: Sampling, generator: Optional[torch.Generator],
               ffn: Optional[Callable] = None) -> Iterator[torch.Tensor]:
        """``generate_stream`` through this owner: an eager flash prefill of
        the shape's cache, the first token sampled from its logits, then
        one replay a token. Each token is yielded as a copy. On a mesh,
        ``prompt`` is this rank's rows."""
        b, t = prompt.shape
        slot = self._slot(b, t + max_new_tokens)
        slot.busy = True
        try:
            cache = self._empty(slot.cache)
            logits, cache = prefill(params, prompt, cache, self.config, mesh=self.mesh,
                                    ffn=ffn)
            token = sample_logits(logits, generator, *(sampling or (0.0,)))
            if max_new_tokens > 0:
                yield token
            if max_new_tokens <= 1:
                return
            with torch.inference_mode():
                slot.token.copy_(token)
                if sampling and slot.noise is None:
                    slot.noise = torch.empty(logits.shape, dtype=torch.float32,
                                             device=self.device)
                replay, _ = self._graph(params, slot, sampling, ffn)
            for _ in range(max_new_tokens - 1):
                with torch.inference_mode():
                    if sampling:
                        _draw(slot.noise, generator)
                    self._replay(replay, cache)
                    token = slot.token.clone()
                yield token
        finally:
            slot.busy = False


# The live owners, by (config, mesh, the identities of the tree's leaves). An
# entry leaves as soon as one of its leaves is freed (``weakref.finalize``),
# so a key never outlives a leaf it names and no graph outlives its weights.
_DECODERS: Dict[Tuple[Any, ...], Decoder] = {}


def _forget(key: Tuple[Any, ...], ref: "weakref.ref[Decoder]") -> None:
    if ref() is not None and _DECODERS.get(key) is ref():
        del _DECODERS[key]


def decoder(params: Params, config: TransformerConfig, mesh: Any = None) -> Decoder:
    """The owner of ``params``' captured decode steps under ``config`` on
    ``mesh`` (None: one process): found by the mesh and the tree's leaves,
    made on first use. It lives while every leaf of the tree does and no
    longer, so dropping the weights drops their graphs and caches."""
    tensors = leaves(params)
    key = (config, mesh, *map(id, tensors))
    dec = _DECODERS.get(key)
    if dec is None:
        dec = _DECODERS[key] = Decoder(params, config, mesh)
        ref = weakref.ref(dec)
        for leaf in tensors:
            weakref.finalize(leaf, _forget, key, ref).atexit = False
    return dec


def _plain_stream(
    params: Params, prompt: torch.Tensor, config: TransformerConfig, max_new_tokens: int,
    sampling: Sampling, generator: Optional[torch.Generator], mesh: Any,
    ffn: Optional[Callable],
) -> Iterator[torch.Tensor]:
    """The eager loop: the captured step's plain version."""
    b, t = prompt.shape
    sample = (sampling or (0.0,))
    cache = init_cache(config, b, t + max_new_tokens, device=prompt.device, mesh=mesh)
    logits, cache = prefill(params, prompt, cache, config, mesh=mesh, ffn=ffn)
    token = sample_logits(logits, generator, *sample)
    for i in range(max_new_tokens):
        yield token
        if i == max_new_tokens - 1:
            break
        logits, cache = _forward_cached(params, token[:, None], cache, config, mesh=mesh,
                                        ffn=ffn)
        token = sample_logits(logits[:, 0], generator, *sample)


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
    plain: bool = False,
) -> Iterator[torch.Tensor]:
    """Yield the ``max_new_tokens`` new tokens, each [B], as they are made:
    a flash prefill of a fresh cache, then one decode step per token, from
    the captured graph on CUDA (``plain=True``: the eager loop, the step's
    plain version). On an active ``mesh``, ``prompt`` is this rank's rows;
    the ranks of a tp or ep group must pass generators in the same state,
    and every rank of the gang must make the same calls, since each
    step's collectives (captured or eager) span the gang."""
    sampling = _sampling(temperature, generator, top_k, top_p)
    if not plain and _graphed(prompt):
        return decoder(params, config, mesh).stream(params, prompt, max_new_tokens, sampling,
                                                    generator, ffn)
    return _plain_stream(params, prompt, config, max_new_tokens, sampling, generator, mesh, ffn)


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
    plain: bool = False,
    mesh: Any = None,
) -> torch.Tensor:
    """Greedy (temperature=0) or sampled generation; returns
    [B, T_prompt + max_new_tokens]. ``ffn``: the MoE hook
    (``mixtral.decode_ffn``); ``plain`` and ``mesh``: as in
    :func:`generate_stream`."""
    new = generate_stream(
        params, prompt, config, max_new_tokens, temperature, generator, top_k, top_p, mesh,
        ffn, plain,
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
    mesh: Any = None,
) -> torch.Tensor:
    """Sampled generation under the JAX package's name and defaults. JAX
    compiles it as one program (on a mesh, one SPMD program); here the
    prefill, then one replay of the captured step a token, with no host
    read before the result."""
    return generate(
        params, prompt, config, max_new_tokens, temperature, generator, top_k, top_p, ffn,
        mesh=mesh,
    )


def generate_greedy_scan(
    params: Params,
    prompt: torch.Tensor,
    config: TransformerConfig,
    max_new_tokens: int,
) -> torch.Tensor:
    """Greedy generation; ``generate_scan`` at temperature 0."""
    return generate_scan(params, prompt, config, max_new_tokens, None, temperature=0.0)
