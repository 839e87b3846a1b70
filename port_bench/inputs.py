"""Inputs made from ``--seed`` on the device: weights in the port's
parameter layout and training batches. Both sides of the
comparison take them from here, so the program and the reference start from
the same values. Each leaf and each batch has a generator of its own,
seeded from (seed, what it is), so any one can be made again alone."""

from __future__ import annotations

import hashlib
import math
from typing import Any, Dict, Iterator, List, Sequence, Tuple

import torch

# (path, shape, kind, fan_in, scale): kind "normal" draws normal(0, 1) *
# scale / sqrt(fan_in); "ones" and "zeros" are constants.
LeafSpec = Tuple[Tuple[str, ...], Tuple[int, ...], str, int, float]


DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def derive(seed: int, *tags: Any) -> int:
    """A 63-bit generator seed for (seed, tags): any seed, however large."""
    text = "/".join(str(t) for t in (seed, *tags)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def generator(device: torch.device, seed: int, *tags: Any) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *tags))


def make_leaf(seed: int, index: int, spec: LeafSpec, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    path, shape, kind, fan_in, scale = spec
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if kind == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    w = torch.empty(shape, dtype=torch.float32, device=device)
    w.normal_(generator=generator(device, seed, "leaf", index, ".".join(path)))
    w.mul_(scale / math.sqrt(fan_in))
    return w if dtype == torch.float32 else w.to(dtype)


def tree(items: Iterator[Tuple[Tuple[str, ...], Any]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, leaf in items:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def make_tree(seed: int, specs: Sequence[LeafSpec], dtype: torch.dtype,
              device: torch.device) -> Dict[str, Any]:
    """Every leaf of ``specs`` made on ``device`` in ``dtype``: one draw a
    leaf (f32, cast once)."""
    return tree((s[0], make_leaf(seed, i, s, dtype, device)) for i, s in enumerate(specs))


def flat(node: Dict[str, Any], path: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(dotted name, leaf) in the tree's insertion order."""
    out: List[Tuple[str, Any]] = []
    for k, v in node.items():
        if isinstance(v, dict):
            out.extend(flat(v, path + (k,)))
        else:
            out.append((".".join(path + (k,)), v))
    return out


def train_batch(seed: int, step: int, rows: int, seq: int, vocab: int, device: torch.device,
                mask_rate: float = 0.0, mask_id: int = 0) -> Dict[str, torch.Tensor]:
    """Step ``step``'s batch: ids uniform over the vocabulary. With
    ``mask_rate``, that share of positions (drawn alike) is masked: the token
    becomes ``mask_id`` and its target the original id; every other target is
    -100."""
    g = generator(device, seed, "batch", step)
    ids = torch.randint(0, vocab, (rows, seq), generator=g, device=device)
    if not mask_rate:
        return {"tokens": ids}
    masked = torch.rand((rows, seq), generator=g, device=device) < mask_rate
    return {"tokens": torch.where(masked, torch.full_like(ids, mask_id), ids),
            "targets": torch.where(masked, ids, torch.full_like(ids, -100))}


def sample_index(seed: int, index: int, numel: int, size: int,
                 device: torch.device) -> torch.Tensor:
    """A fixed sample of ``size`` element positions of leaf ``index`` (every
    position where the leaf has fewer), drawn from the seed: both sides of
    the comparison read the same elements."""
    if numel <= size:
        return torch.arange(numel, device=device)
    return torch.randint(0, numel, (size,), generator=generator(device, seed, "sample", index),
                         device=device)


def half(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The first half of a batch's rows (a fault: half the batch left out)."""
    return {k: v[: v.shape[0] // 2] for k, v in batch.items()}
