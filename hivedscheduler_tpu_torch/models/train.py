"""Single-device training step: next-token loss, AdamW, f32 master weights.

Counterpart of ``hivedscheduler_tpu/models/train.py`` on one device. The
model computes in ``config.dtype`` from f32 master parameters
(``transformer.forward_hidden`` casts on entry), each block checkpointed
under ``config.remat_policy``; attention's backward runs the hand-written
flash backward kernels. The mesh functions (``shardings_for``,
``init_sharded``, ``make_train_step``) belong to the distributed slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import Device, resolve_device
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
) -> torch.Tensor:
    """Causal LM loss: predict tokens[:, 1:] from tokens[:, :-1]. The whole
    sequence goes through the model; the last position is not scored.
    ``fused`` (default: vocab >= FUSED_LOSS_MIN_VOCAB) takes the chunked
    logsumexp."""
    if fused is None:
        fused = config.vocab_size >= FUSED_LOSS_MIN_VOCAB
    targets = tokens[:, 1:]
    if fused:
        x, head = transformer.forward_hidden(params, tokens, config)
        b, s, d = x.shape
        return _chunked_ce(x[:, :-1].reshape(b * (s - 1), d), head, targets.reshape(-1), chunk)
    logits = transformer.forward(params, tokens, config)  # [B, S, V] f32
    logp = F.log_softmax(logits[:, :-1], dim=-1)
    return -logp.gather(-1, targets[..., None])[..., 0].mean()


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
) -> torch.Tensor:
    """One step: loss, backward, AdamW update of ``params`` in place.
    ``tokens`` may be any integer dtype (a token file's int32 rows). Returns
    the loss (a detached scalar, not synchronised). Runs on CUDA
    unless ``device`` names another; the parameters must live there. The
    step's gradients stay in each leaf's ``.grad`` until the next step."""
    device = resolve_device(device)
    first = transformer.leaves(params)[0]
    if first.device.type != device.type:
        raise ValueError(f"parameters on {first.device}, step asked for {device}")
    optimizer.zero_grad(set_to_none=True)
    loss = next_token_loss(params, tokens.to(device=device, dtype=torch.long), config)
    loss.backward()
    optimizer.step()
    return loss.detach()
