"""What the references share: the precision they compute in, norms, RoPE,
plain attention and AdamW."""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

@contextlib.contextmanager
def exact_f32() -> Iterator[None]:
    """f32 products in f32: TF32 off for matmuls and convolutions."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def _round8(t: torch.Tensor, fmt: torch.dtype) -> torch.Tensor:
    """``t`` rounded to the float8 format ``fmt`` under a per-tensor scale
    (its largest magnitude at the format's largest), back in ``t``'s dtype."""
    scale = t.abs().amax().clamp_min(1e-30) / torch.finfo(fmt).max
    return (t / scale).to(fmt).to(t.dtype) * scale


def _sum_to(t: torch.Tensor, dims: int) -> torch.Tensor:
    """``t`` summed over the leading dimensions a broadcast operand lacked."""
    return t.sum(dim=tuple(range(t.dim() - dims))) if t.dim() > dims else t


class _Fp8MatMul(torch.autograd.Function):
    """``a @ b`` computed as a float8 step computes it: both operands in
    e4m3 forward, and backward the incoming gradient in e5m2 against the
    saved e4m3 operands (the usual hybrid recipe)."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _round8(a, torch.float8_e4m3fn), _round8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, grad):
        qa, qb = ctx.saved_tensors
        g = _round8(grad, torch.float8_e5m2)
        return (_sum_to(g @ qb.transpose(-1, -2), qa.dim()),
                _sum_to(qa.transpose(-1, -2) @ g, qb.dim()))


class Precision:
    """Where the reference rounds its matrix products: "f32" nowhere;
    "fp8" (the control, the nearest precision below the configurations'
    bf16) every operand of every product, the attention's included, forward
    and backward."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return a @ b if self.name == "f32" else _Fp8MatMul.apply(a, b)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).pow(2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, half-split: x [..., S, H, D], positions [S]."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d)
    angles = (positions.double()[:, None] * freqs[None, :]).float()
    cos, sin = torch.cos(angles)[:, None, :], torch.sin(angles)[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attend_row(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                prec: Precision) -> torch.Tensor:
    """One batch row: q [Sq, H, D], k and v [Sk, Hkv, D] -> [Sq, H, D]. A
    query head h reads KV head h // (H / Hkv)."""
    sq, h, d = q.shape
    sk, hkv = k.shape[0], k.shape[1]
    k = k.repeat_interleave(h // hkv, dim=1)
    v = v.repeat_interleave(h // hkv, dim=1)
    scores = prec.mm(q.transpose(0, 1), k.permute(1, 2, 0)) / math.sqrt(d)  # [H, Sq, Sk]
    if causal:
        qp = torch.arange(sq, device=q.device)[:, None]
        kp = torch.arange(sk, device=q.device)[None, :]
        scores = scores.masked_fill(kp > qp, -math.inf)
    probs = torch.softmax(scores, dim=-1)
    return prec.mm(probs, v.transpose(0, 1)).transpose(0, 1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
              prec: Precision) -> torch.Tensor:
    """Plain softmax attention, q [B, Sq, H, D] over k, v [B, Sk, Hkv, D],
    one batch row at a time (each under its own checkpoint when autograd
    records, so that only one row's scores live at once)."""
    rows = []
    for b in range(q.shape[0]):
        if torch.is_grad_enabled():
            rows.append(checkpoint(_attend_row, q[b], k[b], v[b], causal, prec,
                                   use_reentrant=False))
        else:
            rows.append(_attend_row(q[b], k[b], v[b], causal, prec))
    return torch.stack(rows)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood over the targets >= 0 (0 when none)."""
    logits = logits.reshape(-1, logits.shape[-1])
    targets = targets.reshape(-1)
    keep = targets >= 0
    nll = -F.log_softmax(logits, dim=-1).gather(1, targets.clamp_min(0)[:, None])[:, 0]
    return (nll * keep).sum() / keep.sum().clamp_min(1)


class AdamW:
    """AdamW with decoupled weight decay: p *= 1 - lr * wd, then the bias-
    corrected Adam step, as torch.optim.AdamW and optax.adamw compute it."""

    def __init__(self, leaves: List[torch.Tensor], lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        self.leaves, self.lr, self.betas, self.eps, self.wd = leaves, lr, betas, eps, weight_decay
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[Optional[torch.Tensor]]) -> None:
        self.t += 1
        b1, b2 = self.betas
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, g, m, v in zip(self.leaves, grads, self.m, self.v):
            if g is None:
                g = torch.zeros_like(p)
            p.mul_(1 - self.lr * self.wd)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v.sqrt() / math.sqrt(bc2)).add_(self.eps)
            p.addcdiv_(m, denom, value=-self.lr / bc1)
            del denom


def adamw(leaves: List[torch.Tensor], cfg: Dict) -> AdamW:
    """AdamW over ``leaves`` with the configuration's ``optimizer``."""
    o = cfg["optimizer"]
    return AdamW(leaves, o["lr"], (o["b1"], o["b2"]), o["eps"], o["weight_decay"])
