"""BERT-style bidirectional encoder for MLM pretraining (BERT-large).

Counterpart of ``hivedscheduler_tpu/models/bert.py``. The parameter tree
is the JAX package's (stacked ``[n_layers, ...]`` leaves, ``[in, out]``
matrices, the fused ``wqkv``), so ``models/convert.py`` converts it leaf
for leaf and checkpoints share its names. Attention is the decoder's op,
non-causal, with as many K/V heads as query heads: through
``sharding.sharded_mha`` into ``ops.attention.mha``, the flash kernels at
S >= 256 (BERT-large: 16 heads of 64 at S512). Remat is full (the JAX
``jax.checkpoint`` with no policy), so a training step launches the
forward kernel twice a layer.

Parity with the JAX package, point by point: GELU is the tanh
approximation (``jax.nn.gelu``'s default); LayerNorm takes the population
variance and applies its scale and bias in f32 before the cast back; the
position embedding ``pos_embed[:S]`` is added after the lookup; the MLM
loss is a masked mean, exactly 0 when nothing is masked.

On an active mesh (dp x fsdp x tp) the parameters are DTensors placed by
``logical_axes`` and the rule table, each layer gathered over fsdp inside
its checkpoint, Megatron tp as in the Llama block. ``wqkv`` keeps the JAX
layout ``[d, 3d]`` with "heads" on its columns, so a tp rank's contiguous
shard is not its own q, k and v heads (at tp 2, rank 0 holds all of q and
half of k): the block gathers its columns over tp and takes the rank's
heads from each third; the gather's backward reduce-scatters. The loss is
the global masked mean: the masked count is summed over the batch shards,
whose counts differ.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Iterator, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import Device, resolve_device
from ..parallel import pipeline, sharding
from . import transformer

Params = transformer.Params


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    d_model: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    d_ff: int = 4096
    max_seq_len: int = 512
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def bert_large() -> BertConfig:
    return BertConfig()


def tiny(vocab: int = 512) -> BertConfig:
    return BertConfig(vocab_size=vocab, d_model=64, n_layers=2, n_heads=4, d_ff=128,
                      max_seq_len=128, dtype=torch.float32, remat=False)


def init_leaves(
    config: BertConfig, generator: torch.Generator, device: Device = None,
    dtype: torch.dtype = torch.float32,
) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor]]:
    """Each parameter as (path, tensor), drawn one at a time in the JAX
    tree's order: normal / sqrt(fan_in), the position table scaled by 0.02,
    LayerNorm scales 1 and biases 0."""
    c = config
    device = resolve_device(device)
    d, f, L = c.d_model, c.d_ff, c.n_layers

    def norm(fan_in, shape, scale=1.0):
        w = torch.empty(shape, dtype=dtype, device=device)
        w.normal_(generator=generator)
        return w.mul_(scale / math.sqrt(fan_in))

    def const(value, shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    yield ("embed",), norm(1, (c.vocab_size, d))
    yield ("pos_embed",), norm(1, (c.max_seq_len, d), 0.02)
    yield ("layers", "ln1_scale"), const(1.0, (L, d))
    yield ("layers", "ln1_bias"), const(0.0, (L, d))
    yield ("layers", "wqkv"), norm(d, (L, d, 3 * d))
    yield ("layers", "wo"), norm(d, (L, d, d))
    yield ("layers", "ln2_scale"), const(1.0, (L, d))
    yield ("layers", "ln2_bias"), const(0.0, (L, d))
    yield ("layers", "w_up"), norm(d, (L, d, f))
    yield ("layers", "w_down"), norm(f, (L, f, d))
    yield ("ln_f_scale",), const(1.0, (d,))
    yield ("ln_f_bias",), const(0.0, (d,))
    yield ("mlm_head",), norm(d, (d, c.vocab_size))


def init(config: BertConfig, generator: torch.Generator, device: Device = None,
         dtype: torch.dtype = torch.float32) -> Params:
    """Random f32 master parameters (``generator`` lives on ``device``)."""
    return transformer._tree(init_leaves(config, generator, device, dtype))


def logical_axes(config: BertConfig) -> Params:
    return {
        "embed": ("vocab", "embed"),
        "pos_embed": (None, "embed"),
        "layers": {
            "ln1_scale": ("layers", None),
            "ln1_bias": ("layers", None),
            "wqkv": ("layers", "embed", "heads"),
            "wo": ("layers", "heads", "embed"),
            "ln2_scale": ("layers", None),
            "ln2_bias": ("layers", None),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
        },
        "ln_f_scale": (None,),
        "ln_f_bias": (None,),
        "mlm_head": ("embed", "vocab"),
    }


def init_sharded(config: BertConfig, mesh: Any, generator: torch.Generator,
                 device: Device = None) -> Params:
    """``init``'s f32 parameters, as DTensors placed by the rule table on an
    active mesh (each leaf drawn whole, only this rank's shard kept), as
    plain tensors otherwise."""
    if not sharding.is_active(mesh):
        return init(config, generator, device)
    return transformer.place(init_leaves(config, generator, device), logical_axes(config), mesh)


def distribute(params: Params, config: BertConfig, mesh: Any) -> Params:
    """A whole parameter tree (the same on every rank) as DTensors on
    ``mesh``, placed by the rule table."""
    return transformer.place(transformer._flatten(params), logical_axes(config), mesh)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim in f32: the population variance, then
    scale and bias applied in f32 (a bf16 scale is promoted), then the cast
    back to ``x``'s dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def ffn(h: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """The feed-forward product with ``jax.nn.gelu``'s tanh GELU."""
    return F.gelu(h @ w_up, approximate="tanh") @ w_down


def _qkv_weight(wqkv: torch.Tensor, d: int, mesh: Any) -> torch.Tensor:
    """This tp rank's q, k and v columns [d, 3d/tp] of the fused weight:
    its heads of each third, from the columns gathered over tp."""
    tp = sharding.axes_size("tp", mesh) if sharding.is_active(mesh) else 1
    if tp == 1:
        return wqkv
    full = sharding.gather_tp(wqkv, 1, mesh)
    width, r = d // tp, mesh.get_local_rank("tp")
    return torch.cat([full[:, j * d + r * width: j * d + (r + 1) * width] for j in range(3)], 1)


def _block(x: torch.Tensor, layer: Params, config: BertConfig, mesh: Any = None) -> torch.Tensor:
    """One post-embedding encoder block (pre-LN, as the JAX one): attention
    over every position, then the GELU MLP. On an active mesh ``layer``
    holds this rank's tp shards (whole over fsdp)."""
    c = config
    h = sharding.copy_to(layer_norm(x, layer["ln1_scale"], layer["ln1_bias"]), mesh)
    q, k, v = (h @ _qkv_weight(layer["wqkv"], c.d_model, mesh)).chunk(3, dim=-1)
    attn = sharding.sharded_mha(q, k, v, mesh, c.n_heads, c.n_heads, causal=False)
    x = x + sharding.reduce_from(attn @ layer["wo"], mesh)
    h = sharding.copy_to(layer_norm(x, layer["ln2_scale"], layer["ln2_bias"]), mesh)
    return x + sharding.reduce_from(ffn(h, layer["w_up"], layer["w_down"]), mesh)


def _sharded_block(x: torch.Tensor, layer: Params, config: BertConfig, mesh: Any) -> torch.Tensor:
    """``_block`` on one layer's f32 shards, gathered over fsdp here (inside
    the checkpoint: backward gathers the layer again)."""
    axes = logical_axes(config)["layers"]
    whole = {k: sharding.gather_param(v, sharding.fsdp_dim(axes[k][1:]), config.dtype, mesh)
             for k, v in layer.items()}
    return _block(x, whole, config, mesh)


def forward(params: Params, tokens: torch.Tensor, config: BertConfig,
            mesh: Any = None) -> torch.Tensor:
    """MLM logits [B, S, V] in f32 (on an active mesh this rank's rows and
    its tp shard of the vocab, [B, S, V/tp])."""
    c = config
    s = tokens.shape[1]
    if sharding.is_active(mesh):
        sharding.check_supported(mesh)
        if pipeline.stages(mesh) > 1 or sharding.axes_size("sp", mesh) > 1:
            raise NotImplementedError("BERT runs on dp x fsdp x tp meshes (pp 1, sp 1), as "
                                      "the JAX package's does")
        local = sharding.to_local(params)
        pos = sharding.gather_param(local["pos_embed"], 1, c.dtype, mesh)
        x = sharding.embed_lookup(local["embed"], tokens, mesh, c.dtype) + pos[:s]
        block = functools.partial(_sharded_block, config=c, mesh=mesh)
        norm = {k: local[k].to(c.dtype) for k in ("ln_f_scale", "ln_f_bias")}
        head = sharding.gather_param(local["mlm_head"], 0, c.dtype, mesh)
    else:
        local = transformer.cast(params, c.dtype)  # f32 masters -> compute dtype
        x = local["embed"][tokens] + local["pos_embed"][:s]
        block = functools.partial(_block, config=c)
        norm = local
        head = local["mlm_head"]
    for lp in pipeline.unstack(local["layers"]):
        if c.remat and torch.is_grad_enabled():
            x = checkpoint(block, x, lp, use_reentrant=False)
        else:
            x = block(x, lp)
    x = layer_norm(x, norm["ln_f_scale"], norm["ln_f_bias"])
    return transformer.logits_of(x, head, mesh)


def mlm_loss(params: Params, tokens: torch.Tensor, targets: torch.Tensor, config: BertConfig,
             mesh: Any = None) -> torch.Tensor:
    """Masked-LM loss: the mean negative log-likelihood over the positions
    whose target is >= 0 (-100 elsewhere), sum(nll * mask) / max(count, 1),
    so exactly 0 when nothing is masked. On an active mesh ``tokens`` and
    ``targets`` are this rank's rows, the log-softmax is vocab-parallel
    over tp, and the count is the whole batch's: the returned value is this
    rank's share, scaled so that ``sharding.mean_over_batch`` gives the
    global masked mean and ``sharding.reduce_gradients`` its gradient."""
    logits = forward(params, tokens, config, mesh)
    mask = targets >= 0
    safe = torch.where(mask, targets, torch.zeros((), dtype=targets.dtype, device=targets.device))
    active = sharding.is_active(mesh)
    if active and sharding.axes_size("tp", mesh) > 1:
        v = logits.shape[-1]
        nll = sharding.vocab_parallel_token_nll(logits.reshape(-1, v), safe.reshape(-1), mesh)
        nll = nll.reshape(mask.shape)
    else:
        nll = -F.log_softmax(logits, dim=-1).gather(-1, safe[..., None])[..., 0]
    total = (nll * mask).sum()
    count = mask.sum()
    if not active:
        return total / count.clamp_min(1)
    for axis in sharding.BATCH_AXES:
        if sharding.axes_size(axis, mesh) > 1:
            count = sharding._all_reduce(count, mesh, axis)
    return total * sharding.axes_size(sharding.BATCH_AXES, mesh) / count.clamp_min(1)
