"""Attention ops: the plain PyTorch reference path and the hand-written
Hopper flash-attention forward (``csrc/flash_fwd.cu``).

Counterpart of ``hivedscheduler_tpu/ops/attention.py``. The public layout is
the JAX package's ``[B, S, H, D]`` with GQA (``Hkv`` divides ``H``).

- ``mha_reference``: f32 scores, a -1e30 mask (not -inf), GQA by repeat,
  probs cast to the q dtype before PV.
- ``flash_attention_reference``: the plain version of the kernel, the same
  arithmetic step for step (unnormalised P cast to the V dtype, PV
  accumulated in f32, divided by max(l, 1e-30)); returns (out, lse).
- ``flash_attention``: launches the kernel for CUDA tensors (or raises: it
  never falls back) and runs the plain version for CPU tensors.
- ``mha``: the dispatcher, with the JAX package's gate (self-attention,
  ``sq == sk >= 256``). The kernel masks its ragged last tile itself, so no
  tile-alignment rule narrows the gate.

The backward kernels (``_bwd_dkdv_kernel``, ``_bwd_dq_kernel``) are not
ported yet: nothing here is differentiable through the kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
FLASH_MIN_SEQ = 256
KERNEL_HEAD_DIMS = (32, 64, 128)


def _repeat_kv(x: torch.Tensor, groups: int) -> torch.Tensor:
    return x if groups == 1 else x.repeat_interleave(groups, dim=2)


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
    scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
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
    scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
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
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    from . import _build

    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _flash_kernel_args(q, k, v)
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    out = torch.empty_like(q)
    lse = torch.empty(b * h, s, dtype=torch.float32, device=q.device)
    fn = _build.load_library("flash_fwd").hived_flash_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, s, h, k.shape[2], d, int(causal), scale,
            int(q.dtype == torch.bfloat16), stream,
        )
    if err:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0


def mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Dispatch: the flash forward for self-attention of length >= 256,
    ``mha_reference`` otherwise."""
    sq, sk = q.shape[1], k.shape[1]
    if sq == sk and sq >= FLASH_MIN_SEQ:
        return flash_attention(q, k, v, causal, sm_scale)[0]
    return mha_reference(q, k, v, causal=causal, sm_scale=sm_scale)
