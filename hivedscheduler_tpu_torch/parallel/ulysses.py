"""Ulysses sequence parallelism: all-to-all trades heads for sequence, and
the flash kernels run on the full sequence.

Counterpart of ``hivedscheduler_tpu/parallel/ulysses.py``. Q/K/V arrive as
this rank's shards, ``[b, S/sp, H/tp, D]``: sequence over ``sp``, heads
over ``tp``. One all-to-all over the sp group per tensor gives each rank
the whole sequence for ``H/(tp*sp)`` of the heads; attention then runs
locally through ``ops.attention.mha``, the hand-written flash kernels on
the card (forward and, under autograd, both backward kernels; the forward
still goes through ``hived::flash_fwd``, so remat "flash" keeps it); one
all-to-all on the output restores the sequence shards. Attention is
independent per head, so the result is exact.

Each all-to-all is an autograd function whose backward is the same
all-to-all on the gradient (with equal chunks it is its own transpose).
The heads dim is split into ``sp`` contiguous groups and moved to the
front before the exchange, so each chunk a rank sends is one contiguous
block.

Against ring attention (``parallel/ring.py``) Ulysses moves Q, K, V and O
once each and runs the kernels; it needs whole heads on every rank
(``can_ulysses``). Where ``sp`` does not divide the KV heads, K/V are
expanded to the query head count first, so that each rank's query heads
travel with their own KV heads.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..ops import attention
from .sharding import all_to_all, axes_size


def can_ulysses(
    mesh: Any,
    n_heads: int,
    n_kv_heads: int,
    seq_len: int,
    seq_axis: str = "sp",
    head_axis: str = "tp",
) -> bool:
    """Whether the all-to-all schedule applies (global sizes): every rank
    must receive a whole number of its tp shard's query heads, and the
    sequence must re-assemble evenly. K/V heads only need tp to divide
    them: where sp does not, they are expanded to the query head count,
    which needs the usual GQA condition per tp shard."""
    sp = axes_size(seq_axis, mesh)
    tp = axes_size(head_axis, mesh)
    if sp <= 1:
        return False
    if not (
        n_heads % (tp * sp) == 0
        and n_kv_heads % tp == 0
        and seq_len % sp == 0
    ):
        return False
    hq_tp = n_heads // tp
    hkv_tp = n_kv_heads // tp
    return hkv_tp % sp == 0 or hq_tp % hkv_tp == 0


def _heads_to_seq(x: torch.Tensor, mesh: Any) -> torch.Tensor:
    """[b, S/sp, h, D] -> [b, S, h/sp, D]: rank j keeps head group j of
    every rank's sequence shard."""
    sp = axes_size("sp", mesh)
    b, s, h, d = x.shape
    chunks = x.reshape(b, s, sp, h // sp, d).permute(2, 0, 1, 3, 4)  # [sp, b, s, h/sp, D]
    got = all_to_all(chunks, mesh, "sp")  # got[i]: rank i's sequence shard
    return got.permute(1, 0, 2, 3, 4).reshape(b, sp * s, h // sp, d)


def _seq_to_heads(x: torch.Tensor, mesh: Any) -> torch.Tensor:
    """[b, S, h/sp, D] -> [b, S/sp, h, D], the inverse of ``_heads_to_seq``."""
    sp = axes_size("sp", mesh)
    b, seq, hl, d = x.shape
    s = seq // sp
    chunks = x.reshape(b, sp, s, hl, d).permute(1, 0, 2, 3, 4)  # [sp, b, s, h/sp, D]
    got = all_to_all(chunks, mesh, "sp")  # got[i]: rank i's head group
    return got.permute(1, 2, 0, 3, 4).reshape(b, s, sp * hl, d)


def ulysses_attention(
    q: torch.Tensor,  # [b, S/sp, H/tp, D]: this rank's shard
    k: torch.Tensor,  # [b, S/sp, Hkv/tp, D]
    v: torch.Tensor,
    mesh: Any,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Exact attention over the whole sequence, sharded over ``sp``, by
    all-to-all head re-sharding; returns this rank's ``[b, S/sp, H/tp, D]``
    shard of the output. Raises where ``can_ulysses`` does not hold."""
    sp, tp = axes_size("sp", mesh), axes_size("tp", mesh)
    hq, hkv = q.shape[2], k.shape[2]
    if not can_ulysses(mesh, hq * tp, hkv * tp, q.shape[1] * sp):
        raise ValueError(
            f"ulysses_attention needs sp|heads and sp|seq: heads={hq * tp} "
            f"kv_heads={hkv * tp} seq={q.shape[1] * sp} sp={sp} tp={tp}")
    if hkv % sp != 0:
        # Splitting the raw KV heads would pair local query head j with KV
        # head j instead of j // group: expand to the query heads first.
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    k = _heads_to_seq(k, mesh)
    v = _heads_to_seq(v, mesh)
    q = _heads_to_seq(q, mesh)
    o = attention.mha(q, k, v, causal=causal, sm_scale=sm_scale)
    return _seq_to_heads(o, mesh)
