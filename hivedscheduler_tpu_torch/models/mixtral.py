"""Mixtral-style sparse-MoE decoder, on one device or a mesh with expert
parallelism (BASELINE config 5: Mixtral 8x7B expert-parallel).

Counterpart of ``hivedscheduler_tpu/models/mixtral.py``. The parameter
tree is the JAX package's, leaf for leaf (``w_gate`` [L, E, d, f], the
router [L, d, E]), so ``models/convert.py`` carries JAX weights across
unchanged. Attention, RoPE (theta 1e6) and the norms are the decoder's
(``transformer.attention``): the flash kernels, forward and backward.
Remat is full block remat, as ``jax.checkpoint`` with no policy: a
training step launches the forward kernel twice a layer.

The routed FFN (:func:`moe_ffn`) keeps GShard's static-capacity semantics
value for value: top-2 picks by first argmax over the f32 softmax of the
router, each round's tokens taking the slots after the earlier rounds'
occupancy in row-major [B, S] order, drops past the capacity, the K gates
renormalised by their kept sum, the Switch load-balancing loss. It
dispatches by index, not by the dense [T, E, C] one-hot einsums of the
reference (at 4 x 4096 tokens each of those is 2.7 GB): each kept token is
added into its (expert, slot) row of an [E, C, D] buffer, the experts'
SwiGLU runs as batched products on the buffer, and each token gathers its
K rows back. Only the order of a token's <= K terms can differ.

On an active mesh the parameters are DTensors placed by
:func:`logical_axes` and the rule table (experts over ep, their embed dim
over fsdp, their mlp dim over tp), each layer gathered over fsdp inside
its checkpoint. The rows shard over (dp, fsdp) and not over ep, so the ep
peers hold the same tokens: routing is computed over the whole gang's
tokens (each round's picks all-gathered, as GSPMD sees global arrays),
each ep rank runs only its E/ep experts (``copy_to`` ep before, the sum
``reduce_from`` ep after), and the aux loss is built from global sums.
Splitting the rows among the ep peers with two all-to-alls (GShard's
form) moves less data at scale and is later work.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Iterator, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import Device, resolve_device
from ..parallel import pipeline, sharding
from . import transformer
from .transformer import rms_norm

Params = transformer.Params


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    n_experts: int = 8
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    max_seq_len: int = 8192
    rope_theta: float = 1000000.0
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    # Sequence-parallel backend when the mesh has sp > 1
    # (``parallel/sharding.sp_attention``): auto | ring | ulysses.
    sp_mode: str = "auto"
    # Part of the decode-config contract (``generate``); Mixtral's head is untied.
    tied_embeddings: bool = False

    def __post_init__(self):
        sharding.validate_sp_mode(self.sp_mode)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def mixtral_8x7b() -> MixtralConfig:
    return MixtralConfig()


def tiny(vocab: int = 512) -> MixtralConfig:
    return MixtralConfig(vocab_size=vocab, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                         d_ff=128, n_experts=4, experts_per_token=2, max_seq_len=256,
                         rope_theta=10000.0, dtype=torch.float32, remat=False)


def init_leaves(
    config: MixtralConfig, generator: torch.Generator, device: Device = None,
    dtype: Optional[torch.dtype] = None,
) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor]]:
    """Each parameter as (path, tensor), drawn one at a time in the JAX
    tree's order: normal / sqrt(fan_in), norm scales 1."""
    c = config
    device = resolve_device(device)
    dtype = c.dtype if dtype is None else dtype
    d, h, hk, dh, f, L, E = (c.d_model, c.n_heads, c.n_kv_heads, c.head_dim, c.d_ff,
                             c.n_layers, c.n_experts)

    def norm(fan_in, shape):
        w = torch.empty(shape, dtype=dtype, device=device)
        w.normal_(generator=generator)
        return w.mul_(1.0 / math.sqrt(fan_in))

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    yield ("embed",), norm(1, (c.vocab_size, d))
    yield ("layers", "ln1"), ones((L, d))
    yield ("layers", "wq"), norm(d, (L, d, h * dh))
    yield ("layers", "wk"), norm(d, (L, d, hk * dh))
    yield ("layers", "wv"), norm(d, (L, d, hk * dh))
    yield ("layers", "wo"), norm(h * dh, (L, h * dh, d))
    yield ("layers", "ln2"), ones((L, d))
    yield ("layers", "router"), norm(d, (L, d, E))
    yield ("layers", "w_gate"), norm(d, (L, E, d, f))
    yield ("layers", "w_up"), norm(d, (L, E, d, f))
    yield ("layers", "w_down"), norm(f, (L, E, f, d))
    yield ("ln_f",), ones((d,))
    yield ("lm_head",), norm(d, (d, c.vocab_size))


def init(config: MixtralConfig, generator: torch.Generator, device: Device = None,
         dtype: Optional[torch.dtype] = None) -> Params:
    """Random parameters drawn on ``device`` in ``dtype`` (default the
    compute dtype; ``torch.float32`` for training's masters)."""
    return transformer._tree(init_leaves(config, generator, device, dtype))


def logical_axes(config: MixtralConfig) -> Params:
    return {
        "embed": ("vocab", "embed"),
        "layers": {
            "ln1": ("layers", None),
            "wq": ("layers", "embed", "heads"),
            "wk": ("layers", "embed", "kv_heads"),
            "wv": ("layers", "embed", "kv_heads"),
            "wo": ("layers", "heads", "embed"),
            "ln2": ("layers", None),
            "router": ("layers", "embed", None),
            # Experts shard over ep; within an expert, tp shards the ffn.
            "w_gate": ("layers", "expert", "embed", "mlp"),
            "w_up": ("layers", "expert", "embed", "mlp"),
            "w_down": ("layers", "expert", "mlp", "embed"),
        },
        "ln_f": (None,),
        "lm_head": ("embed", "vocab"),
    }


def init_distributed(config: MixtralConfig, mesh: Any, generator: torch.Generator,
                     device: Device = None, dtype: Optional[torch.dtype] = None) -> Params:
    """``init``'s parameters as DTensors on ``mesh`` (each leaf drawn whole,
    only this rank's shard kept): value for value ``init``'s."""
    return transformer.place(init_leaves(config, generator, device, dtype), logical_axes(config),
                             mesh)


def distribute(params: Params, config: MixtralConfig, mesh: Any) -> Params:
    """A whole parameter tree (the same on every rank) as DTensors on
    ``mesh``, placed by the rule table."""
    return transformer.place(transformer._flatten(params), logical_axes(config), mesh)


def capacity(config: MixtralConfig, n_tokens: int) -> int:
    """Slots an expert has for ``n_tokens`` routed tokens (the JAX formula)."""
    K = config.experts_per_token
    return max(K, int(math.ceil(K * n_tokens / config.n_experts * config.capacity_factor)))


class Routing(NamedTuple):
    picks: torch.Tensor  # [K, b, s] expert of each round, this rank's tokens
    positions: torch.Tensor  # [K, b, s] slot in that expert; >= capacity: dropped
    capacity: int
    load: torch.Tensor  # [E] picks of each expert over all rounds and the gang's tokens


def route(gates: torch.Tensor, config: MixtralConfig, mesh: Any = None) -> Routing:
    """Top-K routing of this rank's tokens from their gates [b, s, E] (f32
    softmax). Each round takes the first argmax of what is left; positions
    count over the whole gang's tokens in row-major [B, S] order, after the
    occupancy of the earlier rounds, so each (expert, slot) holds at most
    one token. On an active mesh each round's picks are all-gathered over
    the token axes (integers only) and every rank computes every position;
    it keeps its own block."""
    c = config
    E = c.n_experts
    n_tokens = gates.shape[0] * gates.shape[1] * sharding.axes_size(sharding.TOKEN_AXES, mesh)
    occupancy = torch.zeros(E, dtype=torch.long, device=gates.device)
    remaining = gates.detach()
    picks, positions = [], []
    experts = torch.arange(E, device=gates.device)[:, None]
    for _ in range(c.experts_per_token):
        idx = remaining.argmax(dim=-1)  # [b, s]: the first maximum
        every = sharding.gather_tokens(idx, mesh)  # [B, S]
        # [E, T], the tokens along the inner dim: a scan along the outer dim
        # of [T, E] took ~3 ms at T = 16384 on an H100.
        onehot = (experts == every.reshape(1, -1)).long()
        pos = ((onehot.cumsum(1) - onehot + occupancy[:, None]) * onehot).sum(0)
        pos = pos.view(every.shape)
        occupancy = occupancy + onehot.sum(1)
        picks.append(idx)
        positions.append(sharding.shard_batch(pos, mesh) if mesh is not None else pos)
        remaining = remaining * (1.0 - F.one_hot(idx, E).to(remaining.dtype))
    return Routing(torch.stack(picks), torch.stack(positions), capacity(c, n_tokens), occupancy)


def moe_ffn(h: torch.Tensor, layer: Params, config: MixtralConfig,
            mesh: Any = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-K routed expert FFN of the normed ``h`` [b, s, D]; returns (out
    [b, s, D], aux loss). On an active mesh ``layer`` holds this rank's
    experts (whole over fsdp, its tp columns), ``h`` this rank's tokens,
    and the aux loss is the gang's (the same on every rank)."""
    c = config
    mesh = mesh if sharding.is_active(mesh) else None
    b, s, d = h.shape
    E, K = c.n_experts, c.experts_per_token
    gates = torch.softmax((h @ layer["router"]).float(), dim=-1)  # [b, s, E]
    r = route(gates, c, mesh)
    picks, pos = r.picks.reshape(K, -1), r.positions.reshape(K, -1)  # [K, t]
    gate_k = gates.reshape(-1, E).gather(1, picks.T).T  # [K, t]
    weight = gate_k * (pos < r.capacity)  # the reference's combine weights

    # Switch / GShard load balancing over the gang's tokens, K-normalised.
    # The gates' sums are all-reduced (their gradient too) outside the
    # experts' ep region, so the router's gradient is counted once.
    n_tokens = b * s * sharding.axes_size(sharding.TOKEN_AXES, mesh)
    me = torch.zeros(E, dtype=torch.float32, device=h.device).index_add(
        0, picks.reshape(-1), gate_k.reshape(-1))
    me = sharding.all_reduce_sum(me, mesh)
    aux = E * torch.sum((me / n_tokens) * (r.load.float() / n_tokens)) / (K * K)

    # This rank's experts; a slot of another rank's expert or past the
    # capacity goes to the spare last row of the buffer, which is dropped.
    ep = sharding.axes_size("ep", mesh)
    n_local, C = E // ep, r.capacity
    local = picks - (mesh.get_local_rank("ep") * n_local if ep > 1 else 0)
    keep = (pos < C) & (local >= 0) & (local < n_local)
    slot = torch.where(keep, local * C + pos, n_local * C)
    x = sharding.copy_to(sharding.copy_to(h.reshape(-1, d), mesh, "tp"), mesh, "ep")
    buf = x.new_zeros(n_local * C + 1, d)
    for k in range(K):
        buf.index_add_(0, slot[k], x)  # each kept slot receives one token
    buf = buf[: n_local * C].view(n_local, C, d)
    up = torch.bmm(F.silu(torch.bmm(buf, layer["w_gate"])) * torch.bmm(buf, layer["w_up"]),
                   layer["w_down"])
    rows = sharding.reduce_from(up, mesh, "tp").reshape(n_local * C, d)
    # Combine: the weights cast to the compute dtype (the reference's
    # combine.astype), summed in f32 over this rank's experts, then over ep.
    # ``keep`` masks after the copy, so that only kept terms' gradients are
    # summed over ep.
    w = sharding.copy_to(weight.to(h.dtype), mesh, "ep") * keep
    idx = slot.clamp(max=n_local * C - 1)
    out = sum(w[k, :, None].float() * rows.index_select(0, idx[k]).float() for k in range(K))
    out = sharding.reduce_from(out, mesh, "ep").to(h.dtype)
    denom = weight.sum(0).to(h.dtype)
    out = out / torch.clamp_min(denom, 1e-9)[:, None]
    return out.view(b, s, d), aux


def _block(x: torch.Tensor, layer: Params, config: MixtralConfig,
           mesh: Any = None) -> Tuple[torch.Tensor, torch.Tensor]:
    x = transformer.attention(x, layer, config, mesh)
    out, aux = moe_ffn(rms_norm(x, layer["ln2"]), layer, config, mesh)
    return x + out, aux


def _sharded_block(x: torch.Tensor, layer: Params, config: MixtralConfig,
                   mesh: Any) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_block`` on one layer's f32 shards, gathered over fsdp here (inside
    the checkpoint: backward gathers the layer again)."""
    whole = transformer.gather_layer(layer, config, mesh, logical_axes(config)["layers"])
    return _block(x, whole, config, mesh)


def forward(params: Params, tokens: torch.Tensor, config: MixtralConfig,
            mesh: Any = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits [B, S, V] f32, the layers' summed aux loss). On an active
    mesh, this rank's rows (and sequence shard) and its tp shard of the
    vocab; the aux loss is the gang's."""
    c = config
    pp = sharding.axes_size("pp", mesh)
    if pp > 1:
        # Mixtral never pipelines; it scales over ep (the JAX refusal).
        raise NotImplementedError(
            "mixtral.forward does not pipeline; use ep (expert) parallelism "
            f"instead of pp (mesh has pp={pp})")
    if sharding.is_active(mesh):
        sharding.check_supported(mesh)
        local = sharding.to_local(params)
        x = sharding.embed_lookup(local["embed"], tokens, mesh, c.dtype)
        block = functools.partial(_sharded_block, config=c, mesh=mesh)
    else:
        local = transformer.cast(params, c.dtype)  # f32 masters -> compute dtype
        x = local["embed"][tokens]
        block = functools.partial(_block, config=c)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in pipeline.unstack(local["layers"]):
        if c.remat and torch.is_grad_enabled():
            x, a = checkpoint(block, x, lp, use_reentrant=False)
        else:
            x, a = block(x, lp)
        aux = aux + a
    if sharding.is_active(mesh):
        x = rms_norm(x, local["ln_f"].to(c.dtype))
        head = transformer.gather_head(local, c, mesh)
    else:
        x, head = rms_norm(x, local["ln_f"]), local["lm_head"]
    return transformer.logits_of(x, head, mesh), aux


@functools.lru_cache(maxsize=None)
def decode_ffn(config: MixtralConfig):
    """The ``ffn`` hook of ``generate`` (``prefill``, ``decode_step``,
    ``generate_stream``): the routed MoE on the step's tokens, its aux loss
    dropped. One object per config, as in the JAX package. Capacity counts
    the step's tokens (B a decode step), so at small batches tokens are
    dropped; raise ``capacity_factor`` to compare decode with
    :func:`forward`."""

    def ffn(h: torch.Tensor, layer: Params, mesh: Any = None) -> torch.Tensor:
        return moe_ffn(h, layer, config, mesh)[0]

    return ffn


def lm_loss(params: Params, tokens: torch.Tensor, config: MixtralConfig, mesh: Any = None,
            aux_weight: float = 0.01) -> torch.Tensor:
    """Next-token cross entropy (the plain log-softmax over the untied
    head) plus ``aux_weight`` times the aux loss. On an active mesh the
    value is this rank's share, as in ``models/train.next_token_loss``:
    ``sharding.mean_over_batch`` gives the gang's loss and
    ``sharding.reduce_gradients`` its gradient (each sp rank carries 1/sp
    of the aux term)."""
    from .train import _sp_targets

    active = sharding.is_active(mesh)
    tp = sharding.axes_size("tp", mesh) if active else 1
    sp = sharding.axes_size("sp", mesh) if active else 1
    targets = _sp_targets(tokens, mesh) if sp > 1 else tokens[:, 1:]
    n = targets.shape[1]
    logits, aux = forward(params, tokens, config, mesh)
    if tp > 1:
        v = logits.shape[-1]
        nll = sharding.vocab_parallel_nll(logits[:, :n].reshape(-1, v), targets.reshape(-1), mesh)
    else:
        logp = F.log_softmax(logits[:, :n], dim=-1)
        nll = -logp.gather(-1, targets[..., None])[..., 0].mean()
    if sp > 1:
        nll, aux = nll * (n / (sp * tokens.shape[1] - 1)), aux / sp
    return nll + aux_weight * aux
