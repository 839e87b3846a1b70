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
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import Device, resolve_device
from ..parallel import sharding
from . import transformer

Params = transformer.Params

# Vocab sizes at or above this use the fused chunked loss: a [B, S, V] f32
# logits tensor at V = 128k, S = 8k is 4 GB that the chunked online
# logsumexp never materialises.
FUSED_LOSS_MIN_VOCAB = 32768
_LOSS_CHUNK = 8192  # vocab elements per chunk

Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _ce_update(carry: Carry, x: torch.Tensor, w: torch.Tensor,
               targets: torch.Tensor, start: int) -> Carry:
    """One vocab chunk of the online logsumexp: carry (running max m, running
    sum s of exp(logit - m), the target's logit tl). m is taken from detached
    logits: the logsumexp m + log(s) does not depend on it, so its gradient
    is exactly the softmax either way, without the m terms that cancel."""
    m, s, tl = carry
    logits = (x @ w).float()  # [N, width]
    width = logits.shape[1]
    m_new = torch.maximum(m, logits.detach().amax(dim=-1))
    s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=-1)
    local = targets - start
    in_chunk = (local >= 0) & (local < width)
    picked = logits.gather(1, local.clamp(0, width - 1)[:, None])[:, 0]
    return m_new, s, torch.where(in_chunk, picked, tl)


def _chunked_ce(
    x: torch.Tensor,  # [N, D] compute dtype (final hidden, scored rows)
    head: torch.Tensor,  # [D, V]
    targets: torch.Tensor,  # [N] int
    chunk: int,
) -> torch.Tensor:
    """Exact mean cross-entropy without [N, V] logits: an online logsumexp
    over vocab chunks, each chunk checkpointed (its logits are recomputed in
    backward), so the memory is O(N * chunk). A vocab that the chunk does
    not divide ends in one narrower chunk."""
    n = x.shape[0]
    carry = (
        torch.full((n,), -torch.inf, dtype=torch.float32, device=x.device),
        torch.zeros(n, dtype=torch.float32, device=x.device),
        torch.zeros(n, dtype=torch.float32, device=x.device),
    )
    # split: one backward node concatenates the chunks' head gradients.
    for i, w in enumerate(head.split(chunk, dim=1)):
        carry = checkpoint(_ce_update, carry, x, w, targets, i * chunk, use_reentrant=False)
    m, s, tl = carry
    return torch.mean(m + torch.log(s) - tl)


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


def make_optimizer(
    params: Params, learning_rate: float = 3e-4, weight_decay: float = 0.1
) -> torch.optim.AdamW:
    """AdamW over every leaf (no mask), with ``optax.adamw``'s settings:
    b1 0.9, b2 0.95, eps 1e-8. Torch's decoupled decay p -= lr * wd * p is
    optax's ``add_decayed_weights`` then ``scale(-lr)``. Marks every leaf as
    requiring grad."""
    leaves = transformer.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    return torch.optim.AdamW(
        leaves, lr=learning_rate, betas=(0.9, 0.95), eps=1e-8, weight_decay=weight_decay
    )


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
    placements of :func:`shardings_for`. Returns (params, optimizer). On an
    inactive mesh (one process, no group) they are ``model.init``'s plain
    tensors, for the unsharded step."""
    if sharding.is_active(mesh):
        params = model.init_distributed(config, mesh, generator, device, torch.float32)
    else:
        params = model.init(config, generator, device, torch.float32)
    return params, make_optimizer(params, learning_rate, weight_decay)


def make_train_step(
    config: transformer.TransformerConfig, mesh: Any, optimizer: torch.optim.Optimizer
) -> Callable[[Params, torch.Tensor], torch.Tensor]:
    """The sharded step, ``step(params, tokens) -> loss``: ``tokens`` are
    this rank's rows (``sharding.shard_batch``), the loss the global
    mean."""
    device = mesh.device_type

    def step(params: Params, tokens: torch.Tensor) -> torch.Tensor:
        return train_step(params, optimizer, tokens, config, device, mesh)

    return step
