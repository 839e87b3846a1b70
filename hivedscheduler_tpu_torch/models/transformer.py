"""Llama-style decoder-only transformer, on one device or a mesh.

Counterpart of ``hivedscheduler_tpu/models/transformer.py``. Parameters are
a plain dict in the JAX package's layout: stacked per-layer leaves
``[n_layers, ...]`` and ``[in, out]`` matrices applied as ``x @ W``, so a
JAX parameter tree converts without transposes (``models/convert.py``).
Attention goes through ``parallel.sharding.sharded_mha`` into
``ops.attention.mha`` (the flash kernels for long self-attention, forward
and backward). Training keeps f32 master parameters and casts them to the
compute dtype, as the JAX package does; ``remat`` checkpoints each block
(``torch.utils.checkpoint``) under one of the JAX package's four policies.

With an active ``mesh`` the parameters are DTensors placed by
``logical_axes`` and the rule table (``init_distributed``), each block
gathers its layer over fsdp inside its checkpoint and runs Megatron tensor
parallelism over tp; the stacked tree stays the public layout, so
checkpoints and ``convert.py`` see the same names on one process and a
gang. With sp > 1 each rank holds a contiguous shard of the sequence and
attends through ``sharding.sp_attention`` (Ulysses or ring, ``sp_mode``).
With pp > 1 each rank holds its stage's L/P layers and the layer loop is
``parallel.pipeline``'s GPipe schedule: the embedding runs on the first
stage, the final norm and the head on the last.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from .. import Device, resolve_device
from ..ops.attention import mha  # noqa: F401 (registers torch.ops.hived.flash_fwd)
from ..parallel import pipeline, sharding
from . import quantize

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
    # Sequence-parallel backend when the mesh has sp > 1
    # (``parallel/sharding.sp_attention``): "auto" takes Ulysses where it is
    # legal and the tensors are on the card (the flash kernels run on the
    # full sequence), ring attention otherwise; "ring"/"ulysses" force one.
    sp_mode: str = "auto"
    # GPipe microbatch count when the mesh has pp > 1 (parallel/pipeline.py);
    # None = the largest divisor of the rank's batch <= 2*pp, which can be
    # smaller than 2*pp (batch 10 at pp 4 gives 5). The bubble is
    # (pp-1)/(M+pp-1) of the step.
    pp_microbatches: Optional[int] = None

    def __post_init__(self):
        sharding.validate_sp_mode(self.sp_mode)

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


def init_leaves(
    config: TransformerConfig,
    generator: torch.Generator,
    device: Device = None,
    dtype: Optional[torch.dtype] = None,
) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor]]:
    """Each parameter as (path, tensor), drawn one at a time in ``init``'s
    order: ``init`` and ``init_distributed`` consume the same stream."""
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

    yield ("embed",), norm(1, (c.vocab_size, d))
    yield ("layers", "ln1"), ones((L, d))
    yield ("layers", "wq"), norm(d, (L, d, h * dh))
    yield ("layers", "wk"), norm(d, (L, d, hk * dh))
    yield ("layers", "wv"), norm(d, (L, d, hk * dh))
    yield ("layers", "wo"), norm(h * dh, (L, h * dh, d))
    yield ("layers", "ln2"), ones((L, d))
    yield ("layers", "w_gate"), norm(d, (L, d, f))
    yield ("layers", "w_up"), norm(d, (L, d, f))
    yield ("layers", "w_down"), norm(f, (L, f, d))
    yield ("ln_f",), ones((d,))
    if not c.tied_embeddings:
        yield ("lm_head",), norm(d, (d, c.vocab_size))


def _tree(items: Iterable[Tuple[Tuple[str, ...], Any]]) -> Params:
    tree: Params = {}
    for path, leaf in items:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


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
    return _tree(init_leaves(config, generator, device, dtype))


def logical_axes(config: TransformerConfig) -> Params:
    """Logical dim names per parameter; ``parallel/sharding.py`` maps them
    to mesh axes (embed -> fsdp for ZeRO-3, heads/mlp/vocab -> tp)."""
    axes: Params = {
        "embed": ("vocab", "embed"),
        "layers": {
            "ln1": ("layers", None),
            "wq": ("layers", "embed", "heads"),
            "wk": ("layers", "embed", "kv_heads"),
            "wv": ("layers", "embed", "kv_heads"),
            "wo": ("layers", "heads", "embed"),
            "ln2": ("layers", None),
            "w_gate": ("layers", "embed", "mlp"),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
        },
        "ln_f": (None,),
    }
    if not config.tied_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


def place(
    items: Iterable[Tuple[Tuple[str, ...], torch.Tensor]], axes: Params, mesh: Any
) -> Params:
    """DTensors on ``mesh``'s parameter sub-mesh from whole (path, leaf)
    pairs, placed by the rule table from the logical ``axes`` tree: each
    rank keeps its shard of a leaf, and the rest is freed before the next
    leaf is made."""
    pmesh = sharding.param_mesh(mesh)
    placements = {path: sharding.placements_for(names, pmesh) for path, names in _flatten(axes)}
    return _tree((path, sharding.distribute(leaf, placements[path], pmesh)) for path, leaf in items)


def init_distributed(
    config: TransformerConfig,
    mesh: Any,
    generator: torch.Generator,
    device: Device = None,
    dtype: Optional[torch.dtype] = None,
) -> Params:
    """``init``'s parameters as DTensors on ``mesh``, placed by the rule
    table: each leaf is drawn whole on the device from ``generator`` (the
    same stream as ``init``) and only this rank's shard is kept, so no rank
    holds more than one whole leaf. Value for value ``init``'s."""
    return place(init_leaves(config, generator, device, dtype), logical_axes(config), mesh)


def distribute(params: Params, config: TransformerConfig, mesh: Any) -> Params:
    """A whole parameter tree (the same on every rank) as DTensors on
    ``mesh``, placed by the rule table."""
    return place(_flatten(params), logical_axes(config), mesh)


def _flatten(tree: Params, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, path + (k,))
        else:
            yield path + (k,), v


def cast(tree: Any, dtype: torch.dtype) -> Any:
    """Cast every leaf to ``dtype``, except int8 (quantized) weights, which
    must stay int8. A leaf already in ``dtype`` is returned as it is."""
    if isinstance(tree, dict):
        return {k: cast(v, dtype) for k, v in tree.items()}
    return tree if tree.dtype == torch.int8 else tree.to(dtype)


def leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a parameter tree of dicts and lists, in its
    (insertion) order."""
    if isinstance(tree, (dict, list)):
        return [t for v in (tree.values() if isinstance(tree, dict) else tree)
                for t in leaves(v)]
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


def attention(x: torch.Tensor, layer: Params, config: Any, mesh: Any = None) -> torch.Tensor:
    """``x`` plus the pre-norm block's attention (flash kernels via
    ``sharding.sharded_mha``), for any config with the decoder's head
    fields (``models/mixtral.py`` shares it). On an active mesh ``layer``
    holds this rank's tp shards (whole over fsdp): q/k/v are
    column-parallel, ``wo`` row-parallel and followed by the tp all-reduce
    that GSPMD inserts in JAX.

    With sp > 1, ``x`` is this rank's sequence shard: RoPE takes the
    shard's global positions (the JAX block sees the global sequence under
    GSPMD) and attention goes through ``sharding.sp_attention`` on the tp
    rank's whole heads."""
    c = config
    b, s, _ = x.shape
    h = sharding.copy_to(rms_norm(x, layer["ln1"]), mesh)
    sp = sharding.axes_size("sp", mesh) if sharding.is_active(mesh) else 1
    if sp > 1:
        tp = sharding.axes_size("tp", mesh)
        if c.n_heads % tp or c.n_kv_heads % tp:
            raise ValueError(f"sequence parallelism needs tp={tp} to divide the {c.n_heads} "
                             f"heads and {c.n_kv_heads} KV heads")
        positions = mesh.get_local_rank("sp") * s + torch.arange(s, device=x.device)
        q, k, v = ((h @ layer[w]).reshape(b, s, -1, c.head_dim) for w in ("wq", "wk", "wv"))
        attn = sharding.sp_attention(
            rope(q, positions, c.rope_theta), rope(k, positions, c.rope_theta), v, mesh,
            causal=True, sp_mode=c.sp_mode,
        ).reshape(b, s, -1)
    else:
        positions = torch.arange(s, device=x.device)
        attn = sharding.sharded_mha(
            h @ layer["wq"], h @ layer["wk"], h @ layer["wv"], mesh, c.n_heads, c.n_kv_heads,
            rotary=lambda t: rope(t, positions, c.rope_theta),
        )
    return x + sharding.reduce_from(attn @ layer["wo"], mesh)


def _block(
    x: torch.Tensor, layer: Params, config: TransformerConfig, mesh: Any = None
) -> torch.Tensor:
    """One pre-norm block: :func:`attention` + SwiGLU, whose gate and up
    products are column-parallel over tp and ``w_down`` row-parallel."""
    x = attention(x, layer, config, mesh)
    h = sharding.copy_to(rms_norm(x, layer["ln2"]), mesh)
    out = (F.silu(h @ layer["w_gate"]) * (h @ layer["w_up"])) @ layer["w_down"]
    return x + sharding.reduce_from(out, mesh)


def _gather_leaf(leaf: Any, names: Tuple[Optional[str], ...], dtype: torch.dtype,
                 mesh: Any) -> Any:
    """A leaf's shard cast to ``dtype`` and gathered over fsdp where
    ``names`` shard it there. An int8 leaf (``models/quantize.py``): ``w``
    gathered as int8; its scale gathered where its out dim shards over fsdp
    (``wo``, ``w_down``) and local otherwise."""
    if isinstance(leaf, dict):
        axes = quantize.int8_axes(names)
        return {k: _gather_leaf(v, axes[k], dtype, mesh) for k, v in leaf.items()}
    return sharding.gather_param(leaf, sharding.fsdp_dim(names), dtype, mesh)


def gather_layer(layer: Params, config: Any, mesh: Any, axes: Optional[Params] = None) -> Params:
    """One layer's shards, each cast to the compute dtype and gathered over
    fsdp (its tp and ep shards stay local; int8 leaves stay int8): what
    ``_block`` takes on a mesh. ``axes``: the model's per-layer logical
    axes (default this module's)."""
    axes = logical_axes(config)["layers"] if axes is None else axes
    return {k: _gather_leaf(v, axes[k][1:], config.dtype, mesh) for k, v in layer.items()}


def gather_head(local: Params, config: TransformerConfig, mesh: Any) -> Any:
    """The LM head [D, V/tp] in the compute dtype from this rank's shards
    (an int8 leaf when ``lm_head`` is quantized)."""
    if config.tied_embeddings:
        return sharding.gather_param(local["embed"], 1, config.dtype, mesh).T
    return _gather_leaf(local["lm_head"], ("embed", "vocab"), config.dtype, mesh)


def _sharded_block(
    x: torch.Tensor, layer: Params, config: TransformerConfig, mesh: Any
) -> torch.Tensor:
    """``_block`` on one layer's f32 shards, gathered here so that under
    remat backward gathers the layer again instead of keeping it (ZeRO-3,
    one layer at a time)."""
    return _block(x, gather_layer(layer, config, mesh), config, mesh)


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


def forward_hidden(
    params: Params, tokens: torch.Tensor, config: TransformerConfig, mesh: Any = None
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Final normed hidden states [B, S, D] (compute dtype) and the LM-head
    weight [D, V]. Differentiable: with ``config.remat`` each block is
    checkpointed under ``config.remat_policy`` when autograd records.

    On an active mesh (``sharding.is_active``) ``params`` are DTensors
    placed by ``logical_axes`` and ``tokens`` this rank's rows
    (``sharding.shard_batch``); the hidden states are this rank's rows and
    the head its tp shard [D, V/tp]. With pp > 1 the layers run as the
    pipeline's stages; a stage before the last returns (the pipeline's
    anchor, None): the loss is the last stage's, and ``backward()`` on the
    anchor runs this stage's part of the backward schedule."""
    c = config
    context_fn = _remat_policy(c.remat_policy) if c.remat else None
    pp = 1
    if sharding.is_active(mesh):
        sharding.check_supported(mesh)
        pp = pipeline.stages(mesh)
        local = sharding.to_local(params)
        if pp > 1:
            pipeline.check_layers(c.n_layers, pp)
        if pp > 1 and mesh.get_local_rank("pp") > 0:
            # Received from the previous stage: only the shape is read here.
            x = torch.empty(tokens.shape + (c.d_model,), dtype=c.dtype, device=tokens.device)
        else:
            x = sharding.embed_lookup(local["embed"], tokens, mesh, c.dtype)
        block = functools.partial(_sharded_block, config=c, mesh=mesh)
        layers = local["layers"]
    else:
        params = cast(params, c.dtype)  # f32 master -> compute dtype
        x = params["embed"][tokens]
        block = functools.partial(_block, config=c)
        layers = params["layers"]

    def run(h: torch.Tensor, lp: Params) -> torch.Tensor:
        if c.remat and torch.is_grad_enabled():
            return checkpoint(block, h, lp, use_reentrant=False, context_fn=context_fn)
        return block(h, lp)

    if pp > 1:
        x = pipeline.stage_blocks(layers, x, mesh, run, c.pp_microbatches)
        if not pipeline.is_last_stage(mesh):
            return x, None
    else:
        for lp in pipeline.unstack(layers):
            x = run(x, lp)
    if sharding.is_active(mesh):
        return rms_norm(x, local["ln_f"].to(c.dtype)), gather_head(local, c, mesh)
    head = params["embed"].T if c.tied_embeddings else params["lm_head"]
    return rms_norm(x, params["ln_f"]), head


def logits_of(x: torch.Tensor, head: torch.Tensor, mesh: Any = None) -> torch.Tensor:
    """The f32 logits of final hidden states under the head (on an active
    mesh the rank's tp shard of the vocab)."""
    if sharding.is_active(mesh):
        x = sharding.copy_to(x, mesh)
    return (x @ head).float()


def forward(
    params: Params, tokens: torch.Tensor, config: TransformerConfig, mesh: Any = None
) -> torch.Tensor:
    """Logits [B, S, V] in f32; ``tokens`` [B, S] int. On an active mesh,
    this rank's rows and its tp shard of the vocab, [B, S, V/tp]. With
    pp > 1 the last stage's logits are broadcast to every stage, as the
    JAX package's pipeline broadcasts its output (not differentiable: a
    step takes ``models/train.next_token_loss``, which finishes the loss on
    the last stage)."""
    x, head = forward_hidden(params, tokens, config, mesh)
    if head is not None:
        logits = logits_of(x, head, mesh)
    if pipeline.stages(mesh) > 1 and sharding.is_active(mesh):
        if head is None:
            vshard = config.vocab_size // sharding.axes_size("tp", mesh)
            logits = torch.empty(tokens.shape + (vshard,), device=tokens.device)
        logits = sharding.broadcast_from(logits, mesh, "pp", pipeline.stages(mesh) - 1)
    return logits
