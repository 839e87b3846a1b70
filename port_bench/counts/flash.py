"""Operations and bytes of the port's flash-attention kernels, from their
shapes: each input read once and each output written once, whatever a kernel
reads again; operations over the (q, k) pairs the mask keeps."""

from __future__ import annotations

from typing import Tuple

from . import peaks

# Matrix products of [S, D] by [D, S] size that each kernel does over the
# (q, k) pairs the mask keeps: forward QK^T and PV; dK/dV S, dV, dP and dK;
# dQ S, dP and dQ.
PRODUCTS = {"fwd": 2, "dkdv": 4, "dq": 3}


def flops(kind: str, b: int, s: int, h: int, d: int, causal: bool) -> int:
    pairs = s * (s + 1) // 2 if causal else s * s
    return PRODUCTS[kind] * 2 * d * pairs * b * h


def nbytes(kind: str, b: int, s: int, h: int, hkv: int, d: int, elt: int = 2) -> int:
    """The forward reads q, k, v and writes o and the f32 LSE; each backward
    kernel reads q, k, v, dO, LSE and Delta and writes dK and dV, or dQ."""
    q_bytes, kv_bytes, row_bytes = elt * d * b * s * h, elt * d * b * s * hkv, 4 * b * h * s
    if kind == "fwd":
        return 2 * q_bytes + 2 * kv_bytes + row_bytes
    out = 2 * q_bytes + 2 * kv_bytes + 2 * row_bytes
    return out + (2 * kv_bytes if kind == "dkdv" else q_bytes)


def bound_s(kind: str, b: int, s: int, h: int, hkv: int, d: int, causal: bool,
            elt: int = 2) -> Tuple[float, str]:
    """(least seconds one launch can take on the card, what bounds it): the
    larger of its operations over the bf16 peak and its bytes over the
    memory rate."""
    t_ops = flops(kind, b, s, h, d, causal) / peaks.BF16_FLOPS
    t_bytes = nbytes(kind, b, s, h, hkv, d, elt) / peaks.BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
