"""Ring attention: exact attention over sequence shards, K/V passed around
the ``sp`` ring.

Counterpart of ``hivedscheduler_tpu/parallel/ring.py``. Each rank holds a
contiguous sequence shard of Q/K/V. For ``sp`` steps it updates a
streaming softmax (running max ``m``, sum ``l`` and output ``o``, all f32)
of its queries against the K/V block it holds, then passes that block to
rank + 1 and takes rank - 1's (:func:`sharding.shift`, an autograd
function whose backward passes the gradient the other way). At step ``i``
the block held is shard ``(rank - i) mod sp``.

The local update is plain torch, as it is plain XLA in the JAX package. No
flash kernel applies to it: a ring step never sees the whole sequence, only
its query chunk against one K/V block, with a carry the kernels do not
take. This is the design, not a fallback: on the card ``sp_attention``
takes Ulysses (``parallel/ulysses.py``), which runs the kernels, wherever
the heads allow it. The queries are split into chunks
(``_q_chunk_size``) and each chunk's update is checkpointed, so neither
forward nor backward holds more than one chunk's scores.

Every rank updates against every block, those wholly in its causal
future too, as the JAX package does: skipping them would leave the K/V
passed on from such a block without a gradient on this rank, so its ring
would run fewer backward passes than its neighbours' and the gang would
wait forever. Parity with the JAX package: the output is computed in f32 and cast to
q's dtype; ``l`` is floored at 1e-20 (not the kernels' 1e-30); a row with
no key yet is guarded so that ``exp(NEG_INF - NEG_INF)`` is not 1.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.attention import NEG_INF
from .sharding import axes_size, shift

# Per-(batch, head) score budget of one local update: the query dim is
# chunked so that a ring step's scores stay within ~4M f32 elements a head.
_SCORE_BUDGET = 4 * 1024 * 1024


def _q_chunk_size(sq: int, sk: int, q_chunk: Optional[int]) -> int:
    if q_chunk is not None and q_chunk <= 0:
        raise ValueError(f"q_chunk must be positive, got {q_chunk}")
    if q_chunk is not None and sq % q_chunk == 0:
        return q_chunk
    if q_chunk is None and sq * sk <= _SCORE_BUDGET:
        return sq
    # Auto-size (or repair a non-divisor request): the largest divisor of
    # sq not above the target, never an unchunked fallback.
    target = q_chunk if q_chunk is not None else max(1, _SCORE_BUDGET // sk)
    best = 1
    c = 1
    while c * c <= sq:
        if sq % c == 0:
            if c <= target:
                best = max(best, c)
            if sq // c <= target:
                best = max(best, sq // c)
        c += 1
    return best


def _update(
    qc: torch.Tensor,  # [B, cq, H, D] f32
    oc: torch.Tensor,  # [B, cq, H, D] f32
    mc: torch.Tensor,  # [B, H, cq]
    lc: torch.Tensor,  # [B, H, cq]
    k_blk: torch.Tensor,  # [B, sk, Hkv, D]
    v_blk: torch.Tensor,
    q_pos0: int,
    k_pos0: int,
    causal: bool,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The streaming-softmax update of one query chunk against one K/V
    block; with ``causal``, queries from global position ``q_pos0`` see
    keys from ``k_pos0`` up to their own."""
    groups = qc.shape[2] // k_blk.shape[2]
    k32 = k_blk.float().repeat_interleave(groups, dim=2)
    v32 = v_blk.float().repeat_interleave(groups, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qc, k32) * scale  # [B, H, cq, sk]
    if causal:
        q_pos = q_pos0 + torch.arange(qc.shape[1], device=qc.device)
        k_pos = k_pos0 + torch.arange(k32.shape[1], device=qc.device)
        s = torch.where(q_pos[:, None] >= k_pos[None, :], s, NEG_INF)
    m_cur = torch.maximum(mc, s.amax(dim=-1))
    # Guard rows that have seen no key: exp(NEG_INF - NEG_INF) must not be 1.
    safe_m = torch.where(m_cur <= NEG_INF / 2, 0.0, m_cur)
    p = torch.exp(torch.where(s <= NEG_INF / 2, NEG_INF, s) - safe_m[..., None])
    alpha = torch.where(mc <= NEG_INF / 2, 0.0, torch.exp(mc - safe_m))
    l_cur = lc * alpha + p.sum(dim=-1)
    o_cur = oc * alpha.transpose(1, 2)[..., None] + torch.einsum("bhqk,bkhd->bqhd", p, v32)
    return o_cur, m_cur, l_cur


def ring_attention(
    q: torch.Tensor,  # [B, S/sp, H/tp, D]: this rank's shard
    k: torch.Tensor,  # [B, S/sp, Hkv/tp, D]
    v: torch.Tensor,
    mesh: Any,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    q_chunk: Optional[int] = None,
) -> torch.Tensor:
    """Exact attention over the whole sequence, sharded over ``sp``; returns
    this rank's ``[B, S/sp, H/tp, D]`` shard of the output in q's dtype.
    ``q_chunk`` bounds the local score tile (auto-sized by default)."""
    p = axes_size("sp", mesh)
    me = mesh.get_local_rank("sp") if p > 1 else 0
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    cq = _q_chunk_size(sq, sk, q_chunk)
    qs = q.float().split(cq, dim=1)
    o = [torch.zeros_like(qc) for qc in qs]
    m = [torch.full((b, hq, cq), NEG_INF, device=q.device) for _ in qs]
    l = [torch.zeros((b, hq, cq), device=q.device) for _ in qs]
    k_blk, v_blk = k, v
    for i in range(p):
        idx = (me - i) % p  # the shard this K/V block came from
        for c, qc in enumerate(qs):
            o[c], m[c], l[c] = checkpoint(
                _update, qc, o[c], m[c], l[c], k_blk, v_blk, me * sq + c * cq, idx * sk,
                causal, scale, use_reentrant=False)
        if i < p - 1:
            k_blk = shift(k_blk, mesh, "sp", 1)
            v_blk = shift(v_blk, mesh, "sp", 1)
    out = torch.cat([oc / lc.clamp_min(1e-20).transpose(1, 2)[..., None]
                     for oc, lc in zip(o, l)], dim=1)
    return out.to(q.dtype)
