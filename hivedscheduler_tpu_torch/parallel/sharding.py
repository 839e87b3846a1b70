"""Logical-axis sharding rules and the collectives of the sharded step.

Counterpart of ``hivedscheduler_tpu/parallel/sharding.py``. The rule table
is the JAX package's: every tensor dimension has a logical name
(``transformer.logical_axes``), and ``DEFAULT_RULES`` maps each name to the
mesh axis it shards over. A parameter is a ``DTensor`` on the (dp, fsdp,
tp) sub-mesh of the port's 6-axis mesh, or (dp, pp, fsdp, tp) with
pipeline stages (``parallel/mesh.py``, :func:`param_mesh`), with the
placements the table gives (:func:`placements_for`): its storage is this
rank's shard, and ``torch.distributed.checkpoint`` reshards it between
layouts.

JAX leaves the collectives to GSPMD; here they are written out, each an
autograd function over one mesh axis, and the model runs on each rank's
local tensors (``DTensor.to_local``):

- ZeRO-3 over ``fsdp``: :func:`gather_param` casts a shard to the compute
  dtype and all-gathers it over fsdp where the block uses it, one layer at
  a time (inside the layer's checkpoint, so backward gathers it again); its
  backward reduce-scatters the f32 gradient. Int8 (quantized serving)
  shards are gathered as int8. ``dp`` replicates and
  :func:`reduce_gradients` all-reduces over it after backward.
- Megatron tensor parallelism over ``tp``: :func:`copy_to` before a
  column-parallel product (identity forward, all-reduce of the gradient),
  :func:`reduce_from` after a row-parallel one (all-reduce forward,
  identity backward).
- :func:`sharded_mha` runs the flash kernels on the rank's (batch, heads)
  block, the counterpart of the JAX ``shard_map``.
- Sequence parallelism over ``sp``: :func:`sp_attention` picks Ulysses
  (``parallel/ulysses.py``, :func:`all_to_all`) or ring attention
  (``parallel/ring.py``, :func:`shift`). Parameters are replicated over
  sp, so :func:`reduce_gradients` sums their gradients over it too.
- Pipeline parallelism over ``pp`` (``parallel/pipeline.py``, :func:`send`
  and :func:`recv` between neighbouring stages): the stacked layers shard
  over pp; a leaf replicated there (the embedding, the final norm, the
  head) gets its gradient only on the stages that use it, and
  :func:`reduce_gradients` sums it over pp.

The collectives go through ``torch.distributed._functional_collectives``,
whose NCCL calls a CUDA graph captures and replays (``chip_smoke.py``
phase 8 replays them captured on fresh inputs): the decode and training
steps on a mesh run from captured graphs with their collectives inside
(``models/generate.py``, ``models/train.py``). Every differentiable
collective of a step (the gathers and reduce-scatters, the all-reduces,
Ulysses' all-to-all) takes one route: funcol's async call on the group's
NCCL stream, ordered after the current stream, then ``wait_tensor``;
ring's shifts and a pipeline's hops are P2P requests waited on. Only
``reduce_gradients``' in-place all-reduces and ``broadcast_from`` call
c10d synchronously (``async_op`` False), outside autograd. A rank must
make the same collectives in the same order as its peers at capture and
at every replay.

A mesh is *active* when a process group exists (:func:`is_active`): then
the model runs this sharded code. A collective over an axis of one rank is
the identity and is skipped, as GSPMD emits none, so a one-rank mesh runs
the sharded code with no communication. Without a group (``mesh=None`` or
the one-process mesh of ``make_mesh``) the model keeps its unsharded path.
- Expert parallelism over ``ep`` (``models/mixtral.py``): the experts
  shard over ep and the rows do not, so the ep peers hold the same tokens;
  each runs its own experts on them, between :func:`copy_to` and
  :func:`reduce_from` over ep, as tp's products run between those over
  tp. A leaf replicated over ep gets its whole gradient on every ep rank
  and is never summed there. The router's load statistics are sums over
  every token of the gang (:func:`all_reduce_sum`, :func:`gather_tokens`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

from ..ops import attention
from .mesh import MESH_AXES

# logical dim name -> mesh axis (or None = replicate); the JAX package's
# table. Batch over (dp, fsdp), sequence over sp, Megatron tp over
# heads/mlp/vocab, the parameters' embed dim over fsdp (ZeRO-3), experts
# over ep, the stacked-layer dim over pp (size 1 without pipelining).
DEFAULT_RULES: Dict[str, Any] = {
    "batch": ("dp", "fsdp"),
    "seq": "sp",
    "embed": "fsdp",
    "act_embed": None,
    "heads": "tp",
    "kv_heads": "tp",
    "head_dim": None,
    "mlp": "tp",
    "vocab": "tp",
    "expert": "ep",
    "layers": "pp",
}

# The batch's axes: a gradient sums over them, the loss averages.
BATCH_AXES = ("dp", "fsdp")

# Sequence-parallel backends accepted by sp_attention and the model
# config's sp_mode field (validated eagerly via validate_sp_mode).
SP_MODES = ("auto", "ring", "ulysses")


def validate_sp_mode(sp_mode: str) -> None:
    if sp_mode not in SP_MODES:
        raise ValueError(f"unknown sp_mode {sp_mode!r}; one of {'/'.join(SP_MODES)}")


def _sizes(mesh: Any) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axes_size(axis: Any, mesh: Any) -> int:
    """Total rank count over a mesh-axis spec (None, a name, or a tuple of
    names, the shapes the rules produce). ``mesh`` is a ``DeviceMesh`` or
    anything with its ``mesh_dim_names`` and ``shape``."""
    if axis is None or mesh is None:
        return 1
    sizes = _sizes(mesh)
    n = 1
    for a in axis if isinstance(axis, tuple) else (axis,):
        n *= sizes.get(a, 1)
    return n


def spec_for(
    logical_axes: Sequence[Optional[str]], rules: Optional[Dict[str, Any]] = None
) -> Tuple[Any, ...]:
    """The mesh axes of each tensor dim (the JAX ``PartitionSpec``'s
    entries) for one tensor's logical axis names."""
    table = DEFAULT_RULES if rules is None else rules
    return tuple(table.get(name) if name else None for name in logical_axes)


def placements_for(
    logical_axes: Sequence[Optional[str]], mesh: Any, rules: Optional[Dict[str, Any]] = None
) -> Tuple[Placement, ...]:
    """DTensor placements, one per mesh dim: ``Shard(d)`` on each mesh axis
    that tensor dim ``d`` maps to, ``Replicate()`` elsewhere."""
    by_axis: Dict[str, Placement] = {}
    for d, axes in enumerate(spec_for(logical_axes, rules)):
        for a in () if axes is None else axes if isinstance(axes, tuple) else (axes,):
            if a in by_axis:
                raise ValueError(f"mesh axis {a!r} shards two dims of {tuple(logical_axes)}")
            by_axis[a] = Shard(d)
    return tuple(by_axis.get(a, Replicate()) for a in mesh.mesh_dim_names)


def tree_shardings(
    mesh: Any, logical_tree: Any, rules: Optional[Dict[str, Any]] = None
) -> Any:
    """A placements tree from a tree of logical-axis tuples (the tree
    mirrors the parameter tree; its leaves are tuples of names)."""
    if isinstance(logical_tree, dict):
        return {k: tree_shardings(mesh, v, rules) for k, v in logical_tree.items()}
    return placements_for(logical_tree, mesh, rules)


def is_active(mesh: Any) -> bool:
    """True when ``mesh`` runs collectives: a mesh built under a process
    group. ``None`` and the one-process mesh (no group) are inactive."""
    return mesh is not None and dist.is_initialized()


def check_supported(mesh: Any) -> None:
    """Raise for a mesh whose axes are not the port's six (the rule table
    names them); every parallelism of the six is ported."""
    if tuple(mesh.mesh_dim_names) != MESH_AXES:
        raise ValueError(f"mesh axes {tuple(mesh.mesh_dim_names)} are not {MESH_AXES}")


def param_axes(mesh: Any) -> Tuple[str, ...]:
    """The mesh axes a parameter's placements name: (dp, fsdp, tp), with pp
    (pipeline stages) and ep (experts) in their mesh order where they have
    more than one rank. The rule table places no parameter on sp
    (replicated there). DTensor's sharding propagation grows steeply with
    the mesh's rank (AdamW's first step on the 6-D mesh took minutes on the
    CPU), so an axis of one rank is left out."""
    return tuple(a for a in MESH_AXES
                 if a in ("dp", "fsdp", "tp") or (a in ("pp", "ep") and axes_size(a, mesh) > 1))


def param_mesh(mesh: Any) -> Any:
    """The sub-mesh over :func:`param_axes` that parameters are placed on."""
    check_supported(mesh)
    return mesh[param_axes(mesh)]


def batch_rank(mesh: Any) -> int:
    """This rank's index among the batch's shards, row-major over (dp, fsdp)."""
    i = 0
    for a in BATCH_AXES:
        i = i * axes_size(a, mesh) + mesh.get_local_rank(a)
    return i


def local_shard(full: torch.Tensor, placements: Sequence[Placement], mesh: Any) -> torch.Tensor:
    """This rank's block of ``full`` under ``placements`` (a copy). Every
    sharded dim must divide evenly: the gathers assume equal shards."""
    out = full
    for axis, p in zip(mesh.mesh_dim_names, placements):
        if isinstance(p, Shard):
            n = axes_size(axis, mesh)
            if out.shape[p.dim] % n:
                raise ValueError(
                    f"dim {p.dim} of a {tuple(full.shape)} tensor does not split over {axis}={n}")
            out = out.chunk(n, dim=p.dim)[mesh.get_local_rank(axis)]
    return out.clone(memory_format=torch.contiguous_format)


def distribute(full: torch.Tensor, placements: Sequence[Placement], mesh: Any) -> DTensor:
    """``full`` (the same on every rank) as a DTensor: each rank keeps its
    own block, with no communication."""
    return DTensor.from_local(local_shard(full, placements, mesh), mesh, tuple(placements),
                              run_check=False, shape=full.shape, stride=full.stride())


def to_local(tree: Any) -> Any:
    """The local tensors of a DTensor tree (differentiable); plain tensors
    pass through."""
    if isinstance(tree, dict):
        return {k: to_local(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_local(v) for v in tree]
    return tree.to_local() if isinstance(tree, DTensor) else tree


# ------------------------------------------------------------- collectives


def _group(mesh: Any, axis: str):
    return mesh.get_group(axis)


def _wait(t: torch.Tensor) -> torch.Tensor:
    return funcol.wait_tensor(t) if isinstance(t, funcol.AsyncCollectiveTensor) else t


def _all_gather(x: torch.Tensor, dim: int, mesh: Any, axis: str) -> torch.Tensor:
    return _wait(funcol.all_gather_tensor(x.contiguous(), dim, _group(mesh, axis)))


def _reduce_scatter(x: torch.Tensor, dim: int, mesh: Any, axis: str) -> torch.Tensor:
    return _wait(funcol.reduce_scatter_tensor(x.contiguous(), "sum", dim, _group(mesh, axis)))


def _all_reduce(x: torch.Tensor, mesh: Any, axis: str, op: str = "sum") -> torch.Tensor:
    return _wait(funcol.all_reduce(x.contiguous(), op, _group(mesh, axis)))


def _shift(x: torch.Tensor, mesh: Any, axis: str, offset: int) -> torch.Tensor:
    group = _group(mesh, axis)
    n, r = axes_size(axis, mesh), mesh.get_local_rank(axis)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, (r + offset) % n), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (r - offset) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def send(x: torch.Tensor, mesh: Any, axis: str, to: int) -> None:
    """Send ``x`` to the rank at index ``to`` along ``axis`` (a pipeline
    stage's hop); the peer calls :func:`recv`."""
    group = _group(mesh, axis)
    dist.isend(x.contiguous(), dist.get_global_rank(group, to), group).wait()


def recv(shape: Tuple[int, ...], dtype: torch.dtype, device: torch.device, mesh: Any, axis: str,
         frm: int) -> torch.Tensor:
    """A new tensor received from the rank at index ``frm`` along ``axis``."""
    group = _group(mesh, axis)
    out = torch.empty(shape, dtype=dtype, device=device)
    dist.irecv(out, dist.get_global_rank(group, frm), group).wait()
    return out


def broadcast_from(x: torch.Tensor, mesh: Any, axis: str, src: int) -> torch.Tensor:
    """The tensor that the rank at index ``src`` along ``axis`` holds, on
    every rank of the axis; the others pass a tensor of its shape and
    dtype. Not differentiable."""
    if axes_size(axis, mesh) == 1:
        return x
    group = _group(mesh, axis)
    x = x.detach().contiguous()
    dist.broadcast(x, dist.get_global_rank(group, src), group=group)
    return x


def _exchange(x: torch.Tensor, mesh: Any, axis: str) -> torch.Tensor:
    return _wait(funcol.all_to_all_single(x.contiguous(), None, None, _group(mesh, axis)))


class _Shift(torch.autograd.Function):
    """Send to rank + ``offset`` over ``axis`` and receive from rank -
    ``offset`` (ring order); backward passes the gradient the other way."""

    @staticmethod
    def forward(ctx, x, mesh, axis, offset):
        ctx.mesh, ctx.axis, ctx.offset = mesh, axis, offset
        return _shift(x, mesh, axis, offset)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.mesh, ctx.axis, -ctx.offset), None, None, None


class _AllToAll(torch.autograd.Function):
    """All-to-all over ``axis`` of equal chunks along dim 0: chunk ``j``
    goes to rank ``j``, and chunk ``i`` of the output came from rank ``i``.
    It is its own transpose, so backward is the same exchange."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _exchange(x, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.mesh, ctx.axis), None, None


class _Gather(torch.autograd.Function):
    """Cast a shard to ``dtype`` and all-gather it over ``axis`` along
    ``dim``; backward reduce-scatters the gradient in the shard's dtype (a
    parameter's f32 master: an f32 reduction, FSDP2's reduce_dtype)."""

    @staticmethod
    def forward(ctx, shard, dim, dtype, mesh, axis):
        ctx.dim, ctx.mesh, ctx.axis, ctx.dtype = dim, mesh, axis, shard.dtype
        return _all_gather(shard.to(dtype), dim, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad.to(ctx.dtype), ctx.dim, ctx.mesh, ctx.axis), None, None, None, None


class _ReduceForward(torch.autograd.Function):
    """Megatron's g: all-reduce (sum) over ``axis``, identity backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _ReduceBackward(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce of the gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.mesh, ctx.axis), None, None


def gather_param(shard: torch.Tensor, dim: Optional[int], dtype: torch.dtype, mesh: Any) -> torch.Tensor:
    """The whole-over-fsdp parameter in ``dtype`` from this rank's shard;
    ``dim`` is the dim sharded over fsdp (None: not sharded there, only
    cast). tp shards stay local. An int8 (quantized) shard is gathered as
    int8 and stays int8: its product casts it after the gather, which moves
    half a bf16 gather's bytes."""
    if shard.dtype == torch.int8:
        dtype = torch.int8
    if dim is None or axes_size("fsdp", mesh) == 1:
        return shard.to(dtype)
    return _Gather.apply(shard, dim, dtype, mesh, "fsdp")


def gather_tp(x: torch.Tensor, dim: int, mesh: Any) -> torch.Tensor:
    """All-gather over tp along ``dim``; backward reduce-scatters."""
    return x if axes_size("tp", mesh) == 1 else _Gather.apply(x, dim, x.dtype, mesh, "tp")


def copy_to(x: torch.Tensor, mesh: Any, axis: str = "tp") -> torch.Tensor:
    """Megatron's f over ``axis``: ``x`` enters a region whose ranks each
    compute a part (tp: its columns; ep: its experts); backward sums the
    parts' gradients over ``axis``."""
    return x if axes_size(axis, mesh) == 1 else _ReduceBackward.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh: Any, axis: str = "tp") -> torch.Tensor:
    """Megatron's g over ``axis``: the sum of the ranks' parts, with the
    identity backward."""
    return x if axes_size(axis, mesh) == 1 else _ReduceForward.apply(x, mesh, axis)


class _AllReduceSum(torch.autograd.Function):
    """All-reduce (sum) over ``axis`` whose every rank uses the sum: its
    backward sums the ranks' gradients the same way."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.mesh, ctx.axis), None, None


def all_reduce_max(x: torch.Tensor, mesh: Any, axes: Any) -> torch.Tensor:
    """The elementwise max of ``x`` over ``axes`` (None, a name or a tuple
    of names, as the rules give them), on every rank; an axis of one rank
    is skipped. Not differentiable."""
    for axis in () if axes is None else axes if isinstance(axes, tuple) else (axes,):
        if axes_size(axis, mesh) > 1:
            x = _all_reduce(x, mesh, axis, "max")
    return x


# The axes over which a gang's ranks hold different tokens: rows over the
# batch's, columns over sp (ep and tp peers hold the same ones).
TOKEN_AXES = BATCH_AXES + ("sp",)


def all_reduce_sum(x: torch.Tensor, mesh: Any, axes: Sequence[str] = TOKEN_AXES) -> torch.Tensor:
    """The sum of ``x`` over ``axes``, on every rank; differentiable, each
    rank's gradient being the sum of every rank's gradient of the sum."""
    for axis in axes:
        if axes_size(axis, mesh) > 1:
            x = _AllReduceSum.apply(x, mesh, axis)
    return x


def gather_tokens(x: torch.Tensor, mesh: Any) -> torch.Tensor:
    """The global [B, S, ...] tensor from every rank's [b, s, ...] block:
    rows over (dp, fsdp) row-major, columns over sp (``shard_batch``'s
    inverse). Not differentiable."""
    for axis, dim in (("sp", 1), ("fsdp", 0), ("dp", 0)):
        if axes_size(axis, mesh) > 1:
            x = _all_gather(x, dim, mesh, axis)
    return x


def shift(x: torch.Tensor, mesh: Any, axis: str = "sp", offset: int = 1) -> torch.Tensor:
    """What rank - ``offset`` (mod the axis size) holds of ``x``, each rank
    sending its own to rank + ``offset``; differentiable (ring attention's
    K/V rotation)."""
    return x if axes_size(axis, mesh) == 1 else _Shift.apply(x, mesh, axis, offset)


def all_to_all(x: torch.Tensor, mesh: Any, axis: str = "sp") -> torch.Tensor:
    """All-to-all over ``axis`` of ``x``'s equal chunks along dim 0 (dim 0
    is the axis size); differentiable (Ulysses' head/sequence exchange)."""
    return x if axes_size(axis, mesh) == 1 else _AllToAll.apply(x, mesh, axis)


def fsdp_dim(logical: Sequence[Optional[str]], rules: Optional[Dict[str, Any]] = None) -> Optional[int]:
    """The tensor dim the rules shard over fsdp, or None."""
    for d, axes in enumerate(spec_for(logical, rules)):
        if axes == "fsdp" or (isinstance(axes, tuple) and "fsdp" in axes):
            return d
    return None


def reduce_gradients(leaves: Sequence[DTensor], mesh: Any) -> None:
    """Finish the gradients after backward: sum each leaf's local gradient
    over the batch axes it is replicated on (a leaf sharded over fsdp was
    reduce-scattered there by its gather), over sp (each sp rank's loss
    scores its own positions, and no parameter is placed on sp) and over
    pp where it is replicated there (only the stages that use such a leaf
    have its gradient; the others hold zeros, so each use counts once),
    then divide by the batch's shard count, so that each is the gradient of
    the global mean loss. With pp > 1 a leaf that got no gradient on this
    stage gets zeros first: every rank makes the same collectives. Nothing
    is summed over ep or tp: a leaf sharded there (an expert, a tp column)
    has only its own block's gradient, and a leaf replicated there already
    has its whole gradient on every rank (``copy_to`` summed the parts of
    the regions where the ranks differ)."""
    n = axes_size(BATCH_AXES, mesh)
    sp, pp = axes_size("sp", mesh), axes_size("pp", mesh)
    for p in leaves:
        if p.grad is None:
            if pp == 1:
                continue
            p.grad = torch.zeros_like(p)
        g = p.grad.to_local()
        for axis, placement in zip(p.device_mesh.mesh_dim_names, p.placements):
            if ((axis in BATCH_AXES or axis == "pp") and not isinstance(placement, Shard)
                    and axes_size(axis, mesh) > 1):
                dist.all_reduce(g, group=_group(mesh, axis))
        if sp > 1:
            dist.all_reduce(g, group=_group(mesh, "sp"))
        if n > 1:
            g.div_(n)


def mean_over_batch(loss: torch.Tensor, mesh: Any) -> torch.Tensor:
    """The global mean loss, on every rank, from each rank's share: a mean
    over its rows (equal rows on every batch shard), which its sp ranks'
    shares sum to (``models/train.next_token_loss``); with pp > 1 only the
    last stage holds it and the others pass 0."""
    total = loss.detach()
    for axis in BATCH_AXES + ("sp", "pp"):
        if axes_size(axis, mesh) > 1:
            total = _all_reduce(total, mesh, axis)
    n = axes_size(BATCH_AXES, mesh)
    return total / n if n > 1 else total


# --------------------------------------------------------------- the model


def embed_lookup(
    table: torch.Tensor, tokens: torch.Tensor, mesh: Any, dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """Embedding lookup of this rank's ``tokens`` [B, S]. Without an active
    mesh, ``table[tokens]`` (``table`` whole, cast to ``dtype``); on one,
    :func:`vocab_parallel_embed` on the rank's shard of the table. The JAX
    package falls back to the plain gather where the shapes do not divide;
    here no such shape arises, since ``distribute`` refuses a table and
    ``shard_batch`` a batch that does not divide."""
    if not is_active(mesh):
        return (table if dtype is None else table.to(dtype))[tokens]
    return vocab_parallel_embed(table, tokens, mesh, dtype)


def vocab_parallel_embed(
    table: torch.Tensor,  # [V/tp, D/fsdp]: this rank's shard (vocab->tp, embed->fsdp)
    tokens: torch.Tensor,  # [B, S] this rank's rows
    mesh: Any,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Megatron's vocab-parallel lookup. The embed dim is gathered over
    fsdp first (the batch shards over fsdp too, so after the lookup the
    fsdp peers hold different tokens' rows), then each tp rank looks up
    only the rows it owns, the others masked to zero, and an all-reduce
    over tp combines them."""
    table = gather_param(table, 1, table.dtype if dtype is None else dtype, mesh)
    vshard = table.shape[0]
    local = tokens - mesh.get_local_rank("tp") * vshard
    ok = (local >= 0) & (local < vshard)
    out = table[local.clamp(0, vshard - 1)]
    out = torch.where(ok[..., None], out, torch.zeros((), dtype=out.dtype, device=out.device))
    return reduce_from(out, mesh)


def vocab_parallel_token_nll(logits: torch.Tensor, targets: torch.Tensor, mesh: Any) -> torch.Tensor:
    """Negative log-likelihood of each of ``targets`` [N] under tp-sharded
    logits [N, V/tp] (f32): the log-softmax's max and sum and the target's
    logit each combine over tp, so no rank holds [N, V]. Returns [N], the
    same on every tp rank."""
    vshard = logits.shape[-1]
    m = _all_reduce(logits.detach().amax(dim=-1), mesh, "tp", "max")
    s = reduce_from(torch.exp(logits - m[:, None]).sum(dim=-1), mesh)
    local = targets - mesh.get_local_rank("tp") * vshard
    ok = (local >= 0) & (local < vshard)
    picked = logits.gather(1, local.clamp(0, vshard - 1)[:, None])[:, 0]
    tl = reduce_from(torch.where(ok, picked, torch.zeros((), device=picked.device)), mesh)
    return m + torch.log(s) - tl


def vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor, mesh: Any) -> torch.Tensor:
    """The mean of :func:`vocab_parallel_token_nll`."""
    return torch.mean(vocab_parallel_token_nll(logits, targets, mesh))


def mha_shardable(
    batch: int, n_heads: int, n_kv_heads: int, mesh: Any, rules: Optional[Dict[str, Any]] = None
) -> bool:
    """The JAX package's gate for attention on local blocks (global sizes):
    batch divides dp x fsdp, heads and kv_heads divide tp, both shard over
    the same count (each rank keeps whole GQA groups), and no sp."""
    table = DEFAULT_RULES if rules is None else rules

    def size(name):
        return axes_size(table.get(name), mesh)

    return (batch % size("batch") == 0 and n_heads % size("heads") == 0
            and n_kv_heads % size("kv_heads") == 0 and size("heads") == size("kv_heads")
            and size("seq") == 1)


def sharded_mha(
    q: torch.Tensor,  # [B, S, H*D / tp]: this rank's columns of the q projection
    k: torch.Tensor,  # [B, S, Hkv*D / tp]
    v: torch.Tensor,
    mesh: Any,
    n_heads: int,
    n_kv_heads: int,
    rotary: Callable[[torch.Tensor], torch.Tensor] = lambda t: t,
    causal: bool = True,
) -> torch.Tensor:
    """Attention of this rank's rows and heads; returns its columns of the
    [B, S, H*D] output, the row-parallel output projection's input.

    Where :func:`mha_shardable` holds, each rank's columns are whole heads:
    ``rotary`` (RoPE) and ``attention.mha`` (the flash kernels) run on the
    local (batch, heads) block. Otherwise (the JAX package falls back to
    its reference there) the columns are gathered over tp, every head goes
    through ``attention.mha``, so the kernels still run, and the rank keeps
    its own columns, as ``generate._block_cached`` does. Without an active
    mesh, all heads are local."""
    b, s, width = q.shape
    tp = axes_size("tp", mesh) if is_active(mesh) else 1
    d = width * tp // n_heads
    local = tp == 1 or mha_shardable(b * axes_size(BATCH_AXES, mesh), n_heads, n_kv_heads, mesh)
    if not local:
        q, k, v = (gather_tp(y, 2, mesh) for y in (q, k, v))
    qh = rotary(q.reshape(b, s, -1, d))
    kh = rotary(k.reshape(b, s, -1, d))
    out = attention.mha(qh, kh, v.reshape(b, s, -1, d), causal).reshape(b, s, -1)
    return out if local else out.narrow(2, mesh.get_local_rank("tp") * width, width)


def _ulysses_legal_or_raise(mesh: Any, h: int, hkv: int, s_global: int, sp_mode: str) -> bool:
    """Whether Ulysses applies (``can_ulysses``, global sizes); an explicit
    ``sp_mode="ulysses"`` on a mesh where it does not is a user error."""
    from .ulysses import can_ulysses

    legal = can_ulysses(mesh, h, hkv, s_global)
    if sp_mode == "ulysses" and not legal:
        raise ValueError(
            f"sp_mode='ulysses' but heads/seq do not divide the mesh: heads={h} "
            f"kv_heads={hkv} seq={s_global} mesh={_sizes(mesh)}")
    return legal


def sp_backend(mesh: Any, h: int, hkv: int, s_global: int, sp_mode: str, on_cuda: bool) -> str:
    """The sequence-parallel backend ``sp_attention`` takes, "ulysses" or
    "ring" (global head counts and length). "auto" takes Ulysses where it
    is legal and the tensors are on the card, where its local attention
    runs the flash kernels; else ring, whose local memory is bounded by
    its query chunks (the JAX package's choice, whose kernels stand behind
    ``pallas_wanted``). An explicit mode overrides that either way."""
    validate_sp_mode(sp_mode)
    legal = _ulysses_legal_or_raise(mesh, h, hkv, s_global, sp_mode)
    if sp_mode == "ulysses" or (sp_mode == "auto" and legal and on_cuda):
        return "ulysses"
    return "ring"


def sp_attention(
    q: torch.Tensor,  # [B, S/sp, H/tp, D]: this rank's shard
    k: torch.Tensor,  # [B, S/sp, Hkv/tp, D]
    v: torch.Tensor,
    mesh: Any,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    sp_mode: str = "auto",
) -> torch.Tensor:
    """Attention over the whole sequence, sharded over ``sp``; the one place
    that picks the backend (:func:`sp_backend`). Returns this rank's shard
    of the output."""
    from . import ring, ulysses

    sp, tp = axes_size("sp", mesh), axes_size("tp", mesh)
    backend = sp_backend(mesh, q.shape[2] * tp, k.shape[2] * tp, q.shape[1] * sp, sp_mode,
                         q.is_cuda)
    if backend == "ulysses":
        return ulysses.ulysses_attention(q, k, v, mesh, causal=causal, sm_scale=sm_scale)
    return ring.ring_attention(q, k, v, mesh, causal=causal, sm_scale=sm_scale)


def shard_batch(batch: torch.Tensor, mesh: Any) -> torch.Tensor:
    """This rank's block of a host batch with (batch, seq, ...) layout: its
    rows over (dp, fsdp) and its columns over sp. Every rank passes the same
    global batch. Raises where a dim does not divide."""
    blocks = ((BATCH_AXES, batch_rank(mesh)), (("sp",), mesh.get_local_rank("sp")))
    for dim, (axes, i) in enumerate(blocks[: batch.dim()]):
        n = axes_size(axes, mesh)
        if batch.shape[dim] % n:
            raise ValueError(f"batch dim {dim} of {batch.shape[dim]} does not split over {axes}={n}")
        width = batch.shape[dim] // n
        batch = batch.narrow(dim, i * width, width)
    return batch.contiguous()
