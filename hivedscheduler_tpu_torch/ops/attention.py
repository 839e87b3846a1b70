"""Attention ops: the plain PyTorch reference path and the hand-written
Hopper flash-attention kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``).

Counterpart of ``hivedscheduler_tpu/ops/attention.py``. The public layout is
the JAX package's ``[B, S, H, D]`` with GQA (``Hkv`` divides ``H``).

- ``mha_reference``: f32 scores, a -1e30 mask (not -inf), GQA by repeat,
  probs cast to the q dtype before PV.
- ``flash_attention_reference``: the plain version of the forward kernel,
  the same arithmetic step for step (unnormalised P cast to the V dtype, PV
  accumulated in f32, divided by max(l, 1e-30)); returns (out, lse).
- ``flash_bwd_dkdv_reference`` / ``flash_bwd_dq_reference``: the plain
  versions of the two backward kernels, in f32 as the JAX kernels compute
  (P recomputed from the LSE, Delta = rowsum(dO * O) from
  ``flash_bwd_delta``, the GQA group-sum over the query heads that share a
  KV head); ``flash_attention_bwd_reference`` chains them.
- ``flash_attention``, ``flash_bwd_dkdv``, ``flash_bwd_dq``: each launches
  its kernel for CUDA tensors (or raises: none falls back) and runs its
  plain version for CPU tensors; each counts its launches in ``.launches``.
- ``FlashAttention`` (``flash_attention_autograd``): the
  ``torch.autograd.Function`` standing in for the JAX ``custom_vjp``. Its
  forward goes through the ``hived::flash_fwd`` custom op, so that a
  selective-checkpoint policy can see the launch and keep its (out, lse)
  (``models/transformer._remat_policy``, "flash"); its backward is
  ``flash_attention_bwd``.
- ``mha``: the dispatcher, with the JAX package's gate (self-attention,
  ``sq == sk >= 256``). The kernels mask their ragged last tile themselves,
  so no tile-alignment rule narrows the gate.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

NEG_INF = -1e30
FLASH_MIN_SEQ = 256
KERNEL_HEAD_DIMS = (32, 64, 128)


def _repeat_kv(x: torch.Tensor, groups: int) -> torch.Tensor:
    return x if groups == 1 else x.repeat_interleave(groups, dim=2)


def _scale(d: int, sm_scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(d) if sm_scale is None else sm_scale


def mha_reference(
    q: torch.Tensor,  # [B, Sq, Hq, D]
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    v: torch.Tensor,  # [B, Sk, Hkv, D]
    causal: bool = True,
    sm_scale: Optional[float] = None,
    q_offset: int = 0,
    kv_offset: int = 0,
) -> torch.Tensor:
    """Plain multi-head attention with f32 softmax. ``q_offset`` and
    ``kv_offset`` are the absolute positions of the first query and key."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    k = _repeat_kv(k, hq // hkv)
    v = _repeat_kv(v, hq // hkv)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * _scale(d, sm_scale)
    if causal:
        q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
        k_pos = kv_offset + torch.arange(sk, device=q.device)[None, :]
        scores = torch.where(q_pos >= k_pos, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def flash_attention_reference(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, S, Hkv, D]
    v: torch.Tensor,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the flash forward kernel: (out [B, S, H, D]
    in the input dtype, lse [B*H, S] f32)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if h % hkv:
        raise ValueError(f"query heads {h} not a multiple of kv heads {hkv}")
    k = _repeat_kv(k, h // hkv)
    v = _repeat_kv(v, h // hkv)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * _scale(d, sm_scale)
    if causal:
        pos = torch.arange(s, device=q.device)
        scores = torch.where(pos[:, None] >= pos[None, :], scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = (acc / l.permute(0, 2, 1, 3)).to(q.dtype)
    lse = (m + torch.log(l)).reshape(b * h, s)
    return out, lse


# ---------------------------------------------------------------- backward


def flash_bwd_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Delta = rowsum(dO * O) in f32, [B*H, S] like the LSE. The JAX package
    leaves it to XLA outside its kernels; here it is a small torch pre-pass
    before both backward kernels."""
    b, s, h, _ = out.shape
    delta = (do.float() * out.float()).sum(dim=-1)  # [B, S, H]
    return delta.transpose(1, 2).reshape(b * h, s)


def _probs(q, k, lse, causal, scale) -> torch.Tensor:
    """P = exp(scale * Q K^T - LSE), f32 [B, H, S, S], 0 where the mask
    drops a pair (exp of -1e30 - LSE). Built in place: the S x S buffers are
    the plain version's whole memory."""
    b, s, h, _ = q.shape
    k = _repeat_kv(k, h // k.shape[2])
    p = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()).mul_(scale)
    if causal:
        pos = torch.arange(s, device=q.device)
        p.masked_fill_(pos[:, None] < pos[None, :], NEG_INF)
    return p.sub_(lse.reshape(b, h, s, 1)).exp_()


def _dscores(p, v, do, delta) -> torch.Tensor:
    """dS = P * (dO V^T - Delta), f32 [B, H, S, S]."""
    b, s, h, _ = do.shape
    v = _repeat_kv(v, h // v.shape[2])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return dp.sub_(delta.reshape(b, h, s, 1)).mul_(p)


def _group_sum(x: torch.Tensor, hkv: int) -> torch.Tensor:
    """[B, S, H, D] per query head -> [B, S, Hkv, D], summed over the query
    heads that share each KV head (head h reads KV head h // (H / Hkv))."""
    b, s, h, d = x.shape
    return x if h == hkv else x.reshape(b, s, hkv, h // hkv, d).sum(dim=3)


def flash_bwd_dkdv_reference(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, S, Hkv, D]
    v: torch.Tensor,
    do: torch.Tensor,  # [B, S, H, D]
    lse: torch.Tensor,  # [B*H, S] f32
    delta: torch.Tensor,  # [B*H, S] f32
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dK/dV kernel: dV = P^T dO, dK = scale dS^T Q,
    all four products in f32, group-summed to Hkv heads, then cast to k's
    dtype."""
    scale = _scale(q.shape[-1], sm_scale)
    hkv = k.shape[2]
    p = _probs(q, k, lse, causal, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    ds = _dscores(p, v, do, delta)
    del p
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return _group_sum(dk, hkv).to(k.dtype), _group_sum(dv, hkv).to(v.dtype)


def flash_bwd_dq_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of the dQ kernel: dQ = scale dS K in f32, cast to q's
    dtype."""
    scale = _scale(q.shape[-1], sm_scale)
    h = q.shape[2]
    ds = _dscores(_probs(q, k, lse, causal, scale), v, do, delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, _repeat_kv(k, h // k.shape[2]).float())
    return (dq * scale).to(q.dtype)


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of both backward kernels: (dq, dk, dv)."""
    delta = flash_bwd_delta(out, do)
    dk, dv = flash_bwd_dkdv_reference(q, k, v, do, lse, delta, causal, sm_scale)
    dq = flash_bwd_dq_reference(q, k, v, do, lse, delta, causal, sm_scale)
    return dq, dk, dv


# ----------------------------------------------------------------- kernels


def _flash_kernel_args(q, k, v) -> None:
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash kernel takes bf16 or f32 q/k/v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"expected q [B,S,H,D], k/v [B,S,Hkv,D]; got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel head_dim must be one of {KERNEL_HEAD_DIMS}, got {d}")
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("flash kernel needs 16-byte aligned q/k/v")


def _bwd_kernel_args(q, k, v, do, lse, delta) -> None:
    _flash_kernel_args(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"dO {tuple(do.shape)} {do.dtype} does not match q {tuple(q.shape)} {q.dtype}")
    b, s, h, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b * h, s) or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"{name} must be f32 [B*H, S] = {(b * h, s)}, got {tuple(t.shape)} {t.dtype}")


def _device_route(q: torch.Tensor, what: str) -> bool:
    """True for CUDA (launch the kernel), False for the CPU (plain version);
    any other device raises."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {q.device}")
    return True


def _launch(lib: str, symbol: str, tensors: Sequence[torch.Tensor], q, k,
            causal: bool, scale: float) -> None:
    """Call ``symbol`` of ``csrc/<lib>.cu`` on the current stream. Every
    entry point takes its tensors' pointers, then B, S, H, Hkv, D, causal,
    the scale, is_bf16 and the stream; it returns the launch's CUDA error."""
    from . import _build

    fn = getattr(_build.load_library(lib), symbol)
    fn.argtypes = [ctypes.c_void_p] * len(tensors) + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    b, s, h, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            *[t.data_ptr() for t in tensors], b, s, h, k.shape[2], d, int(causal),
            scale, int(q.dtype == torch.bfloat16), stream,
        )
    if err:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error {err}")


def flash_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, S, Hkv, D]
    v: torch.Tensor,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward: (out [B, S, H, D], lse [B*H, S] f32).

    CUDA tensors go to the hand-written kernel, and ``flash_attention.launches``
    counts each launch; an error building or launching it raises. CPU tensors
    go to ``flash_attention_reference``."""
    if not _device_route(q, "flash_attention"):
        return flash_attention_reference(q, k, v, causal, sm_scale)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _flash_kernel_args(q, k, v)
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b * h, s, dtype=torch.float32, device=q.device)
    _launch("flash_fwd", "hived_flash_fwd", (q, k, v, out, lse), q, k, causal,
            _scale(d, sm_scale))
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0


def flash_bwd_dkdv(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B, S, Hkv, D] in k's dtype: the dK/dV kernel for CUDA
    tensors (``flash_bwd_dkdv.launches`` counts), its plain version for CPU
    tensors."""
    if not _device_route(q, "flash_bwd_dkdv"):
        return flash_bwd_dkdv_reference(q, k, v, do, lse, delta, causal, sm_scale)
    q, k, v, do = q.contiguous(), k.contiguous(), v.contiguous(), do.contiguous()
    lse, delta = lse.contiguous(), delta.contiguous()
    _bwd_kernel_args(q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd", "hived_flash_bwd_dkdv", (q, k, v, do, lse, delta, dk, dv),
            q, k, causal, _scale(q.shape[-1], sm_scale))
    flash_bwd_dkdv.launches += 1
    return dk, dv


flash_bwd_dkdv.launches = 0


def flash_bwd_dq(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """dq [B, S, H, D] in q's dtype: the dQ kernel for CUDA tensors
    (``flash_bwd_dq.launches`` counts), its plain version for CPU tensors."""
    if not _device_route(q, "flash_bwd_dq"):
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, causal, sm_scale)
    q, k, v, do = q.contiguous(), k.contiguous(), v.contiguous(), do.contiguous()
    lse, delta = lse.contiguous(), delta.contiguous()
    _bwd_kernel_args(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    _launch("flash_bwd", "hived_flash_bwd_dq", (q, k, v, do, lse, delta, dq),
            q, k, causal, _scale(q.shape[-1], sm_scale))
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


_COUNTERS = {"flash_fwd": flash_attention, "flash_bwd_dkdv": flash_bwd_dkdv,
             "flash_bwd_dq": flash_bwd_dq}


def kernel_launches() -> Dict[str, int]:
    """Each kernel's launch count so far, by kernel name."""
    return {name: fn.launches for name, fn in _COUNTERS.items()}


def add_launches(counts: Dict[str, int]) -> None:
    """Add ``counts`` (by kernel name) to the kernels' launch counts. A CUDA
    graph's replay launches the kernels its capture recorded without
    running the wrappers: its owner adds them here (and takes back what
    the wrappers counted during the capture, which launched nothing)."""
    for name, n in counts.items():
        _COUNTERS[name].launches += n


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash-attention backward: (dq, dk, dv). The Delta pre-pass, then the
    dK/dV and dQ kernels (CUDA) or their plain versions (CPU)."""
    delta = flash_bwd_delta(out, do)
    dk, dv = flash_bwd_dkdv(q, k, v, do, lse, delta, causal, sm_scale)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, sm_scale)
    return dq, dk, dv


# ---------------------------------------------------------------- autograd


@torch.library.custom_op("hived::flash_fwd", mutates_args=())
def flash_fwd_op(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, sm_scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward launch as one dispatcher op: a selective-checkpoint policy
    sees ``torch.ops.hived.flash_fwd`` where it cannot see a ``ctypes``
    call, and can keep its outputs instead of launching again."""
    return flash_attention(q, k, v, causal, sm_scale)


@flash_fwd_op.register_fake
def _(q, k, v, causal, sm_scale):
    b, s, h, _ = q.shape
    return torch.empty_like(q), q.new_empty((b * h, s), dtype=torch.float32)


class FlashAttention(torch.autograd.Function):
    """Counterpart of ``flash_attention_tpu``'s ``custom_vjp``: the forward
    kernel saves (q, k, v, out, lse); the backward runs the two backward
    kernels, dK/dV already summed over each KV head's query heads."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float):
        out, lse = flash_fwd_op(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention_autograd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Differentiable flash attention: out [B, S, H, D]."""
    return FlashAttention.apply(q, k, v, causal, _scale(q.shape[-1], sm_scale))


def mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Dispatch: the flash kernels (forward, and backward under autograd)
    for self-attention of length >= 256, ``mha_reference`` otherwise."""
    sq, sk = q.shape[1], k.shape[1]
    if sq == sk and sq >= FLASH_MIN_SEQ:
        return flash_attention_autograd(q, k, v, causal, sm_scale)
    return mha_reference(q, k, v, causal=causal, sm_scale=sm_scale)
