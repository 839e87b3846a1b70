"""Training step: next-token loss, AdamW, f32 master weights, on one
device or sharded over a mesh.

Counterpart of ``hivedscheduler_tpu/models/train.py``. The model computes
in ``config.dtype`` from f32 master parameters, each block checkpointed
under ``config.remat_policy``; attention's backward runs the hand-written
flash backward kernels. On a mesh (``init_sharded``, ``make_train_step``)
the parameters and AdamW's moments are DTensors placed by the rule table
(ZeRO-3 over fsdp, tp over heads/mlp/vocab, the layers over pp's
stages, dp and sp replicating), the batch is each rank's rows and, with
sp > 1, its shard of the columns; the step's collectives are
``parallel/sharding.py``'s and, with pp > 1, ``parallel/pipeline.py``'s.

On CUDA a step runs from a CUDA graph (:class:`StepGraphs`, found by
:func:`step_graphs`; :func:`captured_step` for this model, each twin's
``captured_step`` for its own), on one card or on each rank of a mesh: the
counterpart of the JAX package's ``jax.jit(train_step, donate_argnums=(0,
1))`` and, on a mesh, of its sharded ``make_train_step``. One graph a
batch shape and dtype (and mesh) holds the whole step, the step's NCCL
collectives included; the parameters and the optimizer's state are updated
in place. The eager ``train_step`` is its plain version: the CPU's path and
the reference the graph is held to.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import time
import weakref
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from .. import Device, resolve_device
from ..ops.attention import add_launches, kernel_launches
from ..parallel import sharding
from . import transformer

Params = transformer.Params

# Vocab sizes at or above this use the fused chunked loss: a [B, S, V] f32
# logits tensor at V = 128k, S = 8k is 4 GB that the chunked online
# logsumexp never materialises.
FUSED_LOSS_MIN_VOCAB = 32768
_LOSS_CHUNK = 8192  # vocab elements per chunk

def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D) accumulated and returned in f32 (in ``a``'s dtype
    when that is f32 or wider): on the card one cuBLAS call with an f32
    output at the bf16 rate."""
    if a.dtype in (torch.float32, torch.float64):
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _ChunkedCE(torch.autograd.Function):
    """Mean cross-entropy of ``x @ head`` without [N, V] logits: an online
    logsumexp over vocab chunks, each chunk's logits recomputed in
    backward, so the memory is O(N * chunk). Backward sums ``x``'s gradient
    over the chunks in f32 and rounds it once, so that the chunk count
    does not move it: summed in bf16 chunk by chunk, a one-card step's
    losses parted from a tp gang's, whose vocab-parallel loss has no
    chunks, by 2e-2 in five steps (ROADMAP F8)."""

    @staticmethod
    def forward(ctx, x, head, targets, chunk):
        n = x.shape[0]
        m = torch.full((n,), -torch.inf, dtype=torch.float32, device=x.device)
        s = torch.zeros(n, dtype=torch.float32, device=x.device)
        tl = torch.zeros(n, dtype=torch.float32, device=x.device)
        for i, w in enumerate(head.split(chunk, dim=1)):
            logits = (x @ w).float()  # [N, width]
            m_new = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=-1)
            m = m_new
            local = targets - i * chunk
            in_chunk = (local >= 0) & (local < w.shape[1])
            picked = logits.gather(1, local.clamp(0, w.shape[1] - 1)[:, None])[:, 0]
            tl = torch.where(in_chunk, picked, tl)
        lse = m + torch.log(s)
        ctx.chunk = chunk
        ctx.save_for_backward(x, head, targets, lse)
        return torch.mean(lse - tl)

    @staticmethod
    def backward(ctx, grad):
        x, head, targets, lse = ctx.saved_tensors
        scale = grad / x.shape[0]
        grad_x = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        grad_head = []
        for i, w in enumerate(head.split(ctx.chunk, dim=1)):
            # d loss / d logits: (softmax - onehot) / N, rounded to the
            # compute dtype as the f32 logits' cast back rounds it.
            p = torch.exp((x @ w).float() - lse[:, None])
            local = targets - i * ctx.chunk
            hit = (local >= 0) & (local < w.shape[1])
            p.scatter_add_(1, local.clamp(0, w.shape[1] - 1)[:, None], -hit.to(p.dtype)[:, None])
            p = (p * scale).to(x.dtype)
            grad_x += _mm_f32(p, w.T)
            grad_head.append(x.T @ p)
        return grad_x.to(x.dtype), torch.cat(grad_head, dim=1), None, None


def _chunked_ce(
    x: torch.Tensor,  # [N, D] compute dtype (final hidden, scored rows)
    head: torch.Tensor,  # [D, V]
    targets: torch.Tensor,  # [N] int
    chunk: int,
) -> torch.Tensor:
    """Exact mean cross-entropy over vocab chunks of ``chunk`` columns
    (:class:`_ChunkedCE`); a vocab that the chunk does not divide ends in
    one narrower chunk."""
    return _ChunkedCE.apply(x, head, targets, chunk)


def next_token_loss(
    params: Params,
    tokens: torch.Tensor,  # [B, S]
    config: transformer.TransformerConfig,
    fused: Optional[bool] = None,
    chunk: int = _LOSS_CHUNK,
    mesh: Any = None,
) -> torch.Tensor:
    """Causal LM loss: predict tokens[:, 1:] from tokens[:, :-1]. The whole
    sequence goes through the model; the last position is not scored.
    ``fused`` (default: vocab >= FUSED_LOSS_MIN_VOCAB and the vocab not
    sharded over tp) takes the chunked logsumexp. On an active mesh the
    loss is the mean over this rank's rows, and with tp > 1 the
    log-softmax is vocab-parallel over the tp-sharded logits.

    With sp > 1 ``tokens`` are this rank's shard of the columns: its last
    position's target is the next sp rank's first token (:func:`_sp_targets`),
    only the last sp rank's last position goes unscored, and the loss is
    this rank's share of the mean over its rows' S - 1 global targets, so
    that the sp ranks' losses sum to it (``sharding.mean_over_batch``).

    With pp > 1 the loss is finished on the last stage; every other stage
    returns the pipeline's anchor, a zero whose ``backward()`` runs that
    stage's part of the schedule."""
    active = sharding.is_active(mesh)
    tp = sharding.axes_size("tp", mesh) if active else 1
    sp = sharding.axes_size("sp", mesh) if active else 1
    if fused is None:
        fused = config.vocab_size >= FUSED_LOSS_MIN_VOCAB and tp == 1
    if fused and tp > 1:
        raise ValueError("the fused loss needs the vocab whole (tp == 1)")
    targets = _sp_targets(tokens, mesh) if sp > 1 else tokens[:, 1:]
    n = targets.shape[1]  # positions scored on this rank
    x, head = transformer.forward_hidden(params, tokens, config, mesh)
    if head is None:
        return x  # a pipeline stage before the last: the anchor (0)
    if fused:
        b, _, d = x.shape
        loss = _chunked_ce(x[:, :n].reshape(b * n, d), head, targets.reshape(-1), chunk)
    else:
        logits = transformer.logits_of(x, head, mesh)  # [B, S, V/tp] f32
        if tp > 1:
            v = logits.shape[-1]
            loss = sharding.vocab_parallel_nll(logits[:, :n].reshape(-1, v), targets.reshape(-1),
                                               mesh)
        else:
            logp = F.log_softmax(logits[:, :n], dim=-1)
            loss = -logp.gather(-1, targets[..., None])[..., 0].mean()
    return loss if sp == 1 else loss * (n / (sp * tokens.shape[1] - 1))


def _sp_targets(tokens: torch.Tensor, mesh: Any) -> torch.Tensor:
    """This sp shard's targets: its own ``tokens[:, 1:]``, then the next sp
    rank's first token (passed back over the ring), except on the last sp
    rank, whose last position has no target."""
    first_of_next = sharding.shift(tokens[:, :1], mesh, "sp", -1)
    if mesh.get_local_rank("sp") == sharding.axes_size("sp", mesh) - 1:
        return tokens[:, 1:]
    return torch.cat([tokens[:, 1:], first_of_next], dim=1)


def capturable(leaves: Sequence[torch.Tensor], asked: Optional[bool] = None) -> bool:
    """Whether an Adam over ``leaves`` keeps its step count and bias
    corrections on the card (``capturable=True``), so that a CUDA graph
    can hold its update: ``asked`` when given, else for CUDA tensors, a
    gang's DTensors too (on the CPU the step count stays a CPU scalar)."""
    if asked is not None:
        return asked
    return all(t.is_cuda for t in leaves)


def quiet_if_capturable(optimizer: torch.optim.Optimizer) -> torch.optim.Optimizer:
    """A capturable optimizer warns the first time it steps outside a
    capture; here that is by design (the graph's warm-up and the eager
    plain step), so the warning is marked as given."""
    if all(g.get("capturable", False) for g in optimizer.param_groups):
        optimizer._warned_capturable_if_run_uncaptured = True
    return optimizer


def make_optimizer(
    params: Params, learning_rate: float = 3e-4, weight_decay: float = 0.1,
    capturable_step: Optional[bool] = None,
) -> torch.optim.AdamW:
    """AdamW over every leaf (no mask), with ``optax.adamw``'s settings:
    b1 0.9, b2 0.95, eps 1e-8. Torch's decoupled decay p -= lr * wd * p is
    optax's ``add_decayed_weights`` then ``scale(-lr)``. Marks every leaf as
    requiring grad. On CUDA leaves (or with ``capturable_step=True``)
    it is capturable: the step count and the bias corrections live on the
    card in f32, as ``optax.adamw`` computes them, and the eager step and
    the captured one run the same arithmetic."""
    leaves = transformer.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    return quiet_if_capturable(torch.optim.AdamW(
        leaves, lr=learning_rate, betas=(0.9, 0.95), eps=1e-8, weight_decay=weight_decay,
        capturable=capturable(leaves, capturable_step),
    ))


def train_step(
    params: Params,
    optimizer: torch.optim.Optimizer,
    tokens: torch.Tensor,
    config: transformer.TransformerConfig,
    device: Device = None,
    mesh: Any = None,
) -> torch.Tensor:
    """One step: loss, backward, AdamW update of ``params`` in place.
    ``tokens`` may be any integer dtype (a token file's int32 rows). Returns
    the loss (a detached scalar, not synchronised). Runs on CUDA
    unless ``device`` names another; the parameters must live there. The
    step's gradients stay in each leaf's ``.grad`` until the next step.
    On an active ``mesh``, ``tokens`` are this rank's rows; the gradients
    and the returned loss are those of the global batch's mean loss."""
    device = resolve_device(device)
    first = transformer.leaves(params)[0]
    if first.device.type != device.type:
        raise ValueError(f"parameters on {first.device}, step asked for {device}")
    optimizer.zero_grad(set_to_none=True)
    loss = next_token_loss(params, tokens.to(device=device, dtype=torch.long), config, mesh=mesh)
    loss.backward()
    if sharding.is_active(mesh):
        sharding.reduce_gradients(transformer.leaves(params), mesh)
        loss = sharding.mean_over_batch(loss, mesh)
    optimizer.step()
    return loss.detach()


def shardings_for(
    config: Any, mesh: Any, model: Any = transformer
) -> Tuple[Params, Dict[str, Any]]:
    """The placements of a train state: (the parameters', AdamW's state),
    from the model's ``logical_axes`` (``model``: this package's
    ``transformer`` by default, ``models.mixtral`` for the MoE family, as
    in the JAX package). AdamW's two moments take their parameter's
    placements leaf for leaf (``zeros_like`` of a DTensor parameter); its
    ``step`` is a replicated CPU scalar (None here). Reads only the mesh's
    axis names and sizes: nothing is allocated."""
    param_pl = sharding.tree_shardings(sharding.param_mesh(mesh), model.logical_axes(config))
    return param_pl, {"exp_avg": param_pl, "exp_avg_sq": param_pl, "step": None}


def init_sharded(
    config: transformer.TransformerConfig,
    mesh: Any,
    generator: torch.Generator,
    device: Device = None,
    learning_rate: float = 3e-4,
    weight_decay: float = 0.1,
    model: Any = transformer,
) -> Tuple[Params, torch.optim.AdamW]:
    """f32 master parameters straight into their placements
    (``model.init_distributed``, ``transformer`` by default: no rank ever
    holds more than one whole leaf, and the values are ``model.init``'s
    from the same generator) and their AdamW, whose moments take the
    placements of :func:`shardings_for`. Returns (params, optimizer). On an inactive
    mesh (one process, no group) they are ``model.init``'s plain tensors,
    for the unsharded step."""
    if sharding.is_active(mesh):
        params = model.init_distributed(config, mesh, generator, device, torch.float32)
    else:
        params = model.init(config, generator, device, torch.float32)
    return params, make_optimizer(params, learning_rate, weight_decay)


def make_train_step(
    config: transformer.TransformerConfig, mesh: Any, optimizer: torch.optim.Optimizer
) -> Callable[[Params, torch.Tensor], torch.Tensor]:
    """The step on ``mesh``, ``step(params, tokens) -> loss``: ``tokens``
    are this rank's rows (``sharding.shard_batch``), the loss the global
    mean. It is :func:`captured_step`: on CUDA each rank replays its graph
    of the whole sharded step (JAX's jitted, donating step with its
    shardings), on an active mesh or an inactive one (one process), for
    every sp backend."""
    device = mesh.device_type

    def step(params: Params, tokens: torch.Tensor) -> torch.Tensor:
        return captured_step(params, optimizer, tokens, config, device, mesh)

    return step


# ------------------------------------------------------------ captured steps

_DIGEST_CHUNK = 1024
_DIGEST_PART = 1 << 24  # elements summed at a time: the int64 sum's input copy is 128 MB
_WORDS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def tree_digest(tree: Any) -> str:
    """A digest of a tree's bits, taken where its leaves live, for trees
    too large to copy to the host: sha256 over each leaf's shape, dtype and
    the int64 sums of its elements' bit patterns over consecutive chunks of
    1024 elements (a DTensor leaf's local shard). Equal trees give equal
    digests; trees that differ give different ones unless their
    differences cancel inside a chunk."""
    digest = hashlib.sha256()
    for t in transformer.leaves(tree):
        t = t.to_local() if isinstance(t, DTensor) else t
        words = t.detach().reshape(-1).view(_WORDS[t.element_size()])
        digest.update(f"{tuple(t.shape)} {t.dtype}".encode())
        for part in words.split(_DIGEST_PART):
            n = part.numel() // _DIGEST_CHUNK * _DIGEST_CHUNK
            sums = torch.cat([part[:n].view(-1, _DIGEST_CHUNK).sum(1, dtype=torch.int64),
                              part[n:].sum(dtype=torch.int64).reshape(1)])
            digest.update(sums.cpu().numpy().tobytes())
    return digest.hexdigest()



def _graphed(t: torch.Tensor) -> bool:
    """Whether a step of leaves on ``t``'s device runs from a captured
    graph: on CUDA. The CPU runs the eager step."""
    return t.is_cuda


def _capture(fn: Callable[[], torch.Tensor]) -> Tuple[Callable[[], None], torch.Tensor]:
    """Capture ``fn`` (device work only) into a CUDA graph with its own
    memory pool; returns (replay, the graph's output). The capture runs
    ``fn``'s Python and executes nothing on the card. A capture that fails
    raises."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph.replay, out


@contextlib.contextmanager
def _expandable_segments(device: torch.device) -> Iterator[None]:
    """Make the caching allocator's new segments expandable for the block
    (CUDA), unless ``PYTORCH_ALLOC_CONF`` (or ``PYTORCH_CUDA_ALLOC_CONF``)
    asked for them already.
    A capture's private pool then grows in place: without it, each large
    block that the pool's freed ones could not hold took a segment of its
    own, and a Mixtral step at 2 layers reserved 78 GiB where its tensors
    never held more than 59 (63 with it, one H100)."""
    if device.type != "cuda":
        yield
        return
    conf = ",".join(os.environ.get(k, "") for k in ("PYTORCH_ALLOC_CONF",
                                                    "PYTORCH_CUDA_ALLOC_CONF"))
    # torch.cuda.memory._set_allocator_settings: its older, now deprecated name.
    setting = getattr(torch._C, "_accelerator_setAllocatorSettings",
                      None) or torch.cuda.memory._set_allocator_settings
    setting("expandable_segments:True")
    try:
        yield
    finally:
        if "expandable_segments:true" not in conf.replace(" ", "").lower():
            setting("expandable_segments:False")


@contextlib.contextmanager
def _side_stream(device: torch.device) -> Iterator[None]:
    """Run the block on a side stream that waits for the current one and
    is waited for after it (CUDA), as a capture's warm-up must; elsewhere
    in place."""
    if device.type != "cuda":
        yield
        return
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        yield
    torch.cuda.current_stream(device).wait_stream(side)


@dataclasses.dataclass
class _Graph:
    """One captured step: its replay, its output, its static inputs, the
    state tree it updates in place, the leaves' gradients it writes and
    each kernel's launches a replay."""

    replay: Callable[[], None]
    loss: torch.Tensor
    batch: Tuple[torch.Tensor, ...]
    state: Any
    grads: List[Optional[torch.Tensor]]
    launches: Dict[str, int]


class StepGraphs:
    """The captured training steps of one parameter tree and its optimizer
    on one card, or on one rank of a mesh: the port's counterpart of JAX's
    compile cache for a jitted, donating train step. Made and found by
    :func:`step_graphs`. It holds, for each (step kind and mesh, batch
    shapes and dtypes), the static input buffers and one graph that runs
    the whole step: forward (the flash kernels and the remat policy's
    recompute inside), backward, on a mesh the step's collectives (the
    fsdp gathers and reduce-scatters, tp's and ep's all-reduces, batch
    norm's sums, the gradients' reductions, the loss's mean, a pipeline's
    sends and receives), the optimizer's in-place update of the f32
    masters and, for a step with state (ResNet's batch statistics), the
    copy of the new state into the state tree. On a mesh every rank makes
    the same collectives in the same order at the warm-up, at the capture
    and at each replay, as the eager step does; the warm-up also makes the
    communicators, which a capture cannot.

    The first call of a shape runs the real step eagerly on a side stream
    (the warm-up a capture needs; it also makes the optimizer's lazy
    state), then captures it, which executes nothing, and returns the
    eager step's loss; its gradients stay in the leaves' ``.grad`` until
    the next step, as ``train_step`` leaves them (copied into the graph's
    gradient buffers; they wait on the host during the capture, a DTensor
    gradient's local shard, so that the capture's peak memory is the eager
    step's). Every later call copies its batch into the static buffers and
    replays: no step runs twice and the trajectory is the eager one. The
    loss returned is a copy of the graph's output, which the next replay
    overwrites.

    A replay runs no Python: the kernels' launch counts
    (``ops.attention.kernel_launches``) are those the capture recorded,
    added at each replay. It refers to the weights weakly: ``step_graphs``
    drops the owner with its graphs as soon as a leaf or the optimizer is
    freed, or the optimizer loads a state dict (its state tensors, which
    the graphs read, are replaced). ``captures``, ``capture_s`` and
    ``replays`` count over every owner."""

    captures = 0
    capture_s = 0.0
    replays = 0

    def __init__(self, device: torch.device):
        self.device = device
        self._graphs: Dict[Any, _Graph] = {}
        self._current: Optional[_Graph] = None  # whose gradients the leaves hold

    def step(self, key: Any, fn: Callable[..., torch.Tensor], params: Any,
             batch: Sequence[torch.Tensor], state: Any = None) -> Tuple[torch.Tensor, Any]:
        """One step of ``fn(*batch)`` (the eager step of ``params`` by this
        owner's optimizer; it returns the detached loss, and updates
        ``state`` in place when there is one), from the graph for ``key``
        and the batch's shapes and dtypes. Returns (loss, the state tree
        the graph updates: ``state`` itself at the shape's first call, and
        after it, with ``state``'s values copied in when another tree is
        given)."""
        leaves = transformer.leaves(params)
        gkey = (key, tuple((tuple(t.shape), t.dtype) for t in batch))
        graph = self._graphs.get(gkey)
        if graph is None:
            return self._first(gkey, fn, leaves, batch, state)
        for static, t in zip(graph.batch, batch):
            static.copy_(t)
        if state is not None and state is not graph.state:
            for static, t in zip(transformer.leaves(graph.state), transformer.leaves(state)):
                static.copy_(t)
        if self._current is not graph:
            for leaf, grad in zip(leaves, graph.grads):
                leaf.grad = grad
            self._current = graph
        graph.replay()
        add_launches(graph.launches)
        StepGraphs.replays += 1
        return graph.loss.clone(), graph.state

    def _first(self, gkey: Any, fn: Callable[..., torch.Tensor], leaves: List[torch.Tensor],
               batch: Sequence[torch.Tensor], state: Any) -> Tuple[torch.Tensor, Any]:
        static = tuple(t.to(self.device, copy=True) for t in batch)
        with _side_stream(self.device):
            loss = fn(*static)  # the real step, eagerly: the capture's warm-up
        # The warm-up's gradients wait on the host while the capture makes
        # its own buffers: beside them, the capture's peak would be the
        # eager step's plus a copy of every gradient (more than 80 GB at
        # Mixtral's widths).
        warm = [None if leaf.grad is None else _to_host(_local(leaf.grad)) for leaf in leaves]
        for leaf in leaves:
            leaf.grad = None  # so that the captured backward assigns them
        if self.device.type == "cuda":
            torch.cuda.empty_cache()  # the warm-up's activations
        before = kernel_launches()
        t0 = time.perf_counter()
        with _expandable_segments(self.device):
            replay, out = _capture(lambda: fn(*static))
        StepGraphs.capture_s += time.perf_counter() - t0
        StepGraphs.captures += 1
        counted = {k: n - before[k] for k, n in kernel_launches().items()}
        add_launches({k: -n for k, n in counted.items()})  # the capture launched nothing
        graph = _Graph(replay, out, static, state, [leaf.grad for leaf in leaves], counted)
        self._graphs[gkey] = graph
        # The leaves hold the warm-up's gradients until the next step: in the
        # graph's buffers, which its replays write.
        for leaf, grad, w in zip(leaves, graph.grads, warm):
            if grad is None:
                leaf.grad = None if w is None else _like(leaf, w.to(leaf.device))
            elif w is not None:
                _local(grad).copy_(w, non_blocking=True)
        self._current = graph
        return loss, state


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; a plain tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def _like(leaf: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """``local`` as ``leaf``'s gradient: for a DTensor leaf, a DTensor of
    the leaf's mesh, placements and global shape over ``local``."""
    if not isinstance(leaf, DTensor):
        return local
    return DTensor.from_local(local, leaf.device_mesh, leaf.placements, run_check=False,
                              shape=leaf.shape, stride=leaf.stride())


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A copy of a CUDA tensor in pinned host memory (a DMA at the link's
    rate: 6.8 GB of gradients took 3.0 s through pageable memory and 0.12 s
    pinned on one H100's host), synchronised; a CPU tensor itself."""
    if not t.is_cuda:
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host


# The live owners, by the identities of the optimizer and the tree's leaves.
# An entry leaves as soon as one of them is freed (``weakref.finalize``) or
# the optimizer loads a state dict, so no graph outlives the tensors it
# reads and writes.
_STEP_GRAPHS: Dict[Tuple[int, ...], StepGraphs] = {}


def _forget(key: Tuple[int, ...], ref: "weakref.ref[StepGraphs]") -> None:
    if ref() is not None and _STEP_GRAPHS.get(key) is ref():
        del _STEP_GRAPHS[key]


def step_graphs(params: Any, optimizer: torch.optim.Optimizer) -> StepGraphs:
    """The owner of the captured steps of ``params`` by ``optimizer``:
    found by their identities, made on first use. It lives while the
    optimizer and every leaf of the tree do, and no longer."""
    tensors = transformer.leaves(params)
    key = (id(optimizer), *map(id, tensors))
    owner = _STEP_GRAPHS.get(key)
    if owner is None:
        owner = _STEP_GRAPHS[key] = StepGraphs(tensors[0].device)
        ref = weakref.ref(owner)
        for obj in (optimizer, *tensors):
            weakref.finalize(obj, _forget, key, ref).atexit = False
        optimizer.register_load_state_dict_post_hook(lambda _: _forget(key, ref))
    return owner


def captured_step(
    params: Params,
    optimizer: torch.optim.Optimizer,
    tokens: torch.Tensor,
    config: transformer.TransformerConfig,
    device: Device = None,
    mesh: Any = None,
) -> torch.Tensor:
    """:func:`train_step` from the captured graph of ``params``' owner
    (:func:`step_graphs`) for ``tokens``' shape and ``mesh``, the batch
    copied into its static int64 buffer before each replay; on an active
    mesh the graph holds the rank's whole sharded step, its collectives
    included, whatever the attention over sp (Ulysses' all-to-alls or
    ring's shifts). The eager ``train_step`` runs for CPU parameters.
    Returns the loss (a copy, not synchronised)."""
    device = resolve_device(device)
    if not _graphed(transformer.leaves(params)[0]):
        return train_step(params, optimizer, tokens, config, device, mesh)
    return step_graphs(params, optimizer).step(
        ("llama", config, mesh), lambda t: train_step(params, optimizer, t, config, device, mesh),
        params, (tokens.to(torch.long),))[0]
