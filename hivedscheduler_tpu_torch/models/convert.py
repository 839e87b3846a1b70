"""Parameters of the JAX package, as numpy arrays, to the port's and back.

The two packages share one layout (stacked ``[n_layers, ...]`` leaves,
``[in, out]`` matrices, ResNet's HWIO conv weights), so conversion is a
leaf-by-leaf copy: no renames, no transposes. Trees are dicts and lists
(ResNet's ``stages`` are a list of lists of blocks). Int8-quantized leaves
(``{"w": int8, "scale": f32}``) keep their int8 weights.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .. import Device, resolve_device
from ..parallel import sharding


def params_from_jax(
    tree: Any, device: Device = None, dtype: torch.dtype = torch.float32,
    mesh: Any = None, axes: Any = None,
) -> Any:
    """Convert a parameter tree of numpy arrays (e.g. ``jax.tree.map(
    np.asarray, params)``) to torch tensors on ``device``. Float leaves
    become ``dtype``; int8 leaves stay int8. With an active ``mesh`` (every
    rank passing the same tree) the leaves are DTensors placed by the rule
    table from ``axes``, the tree's logical axes (an int8 tree's are
    ``quantize.quantized_axes`` of the model's): each rank keeps its own
    shards."""
    if sharding.is_active(mesh):
        from . import transformer

        return transformer.place(transformer._flatten(params_from_jax(tree, device, dtype)),
                                 axes, mesh)
    device = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, list):
            return [convert(v) for v in node]
        a = np.asarray(node)
        if a.dtype == np.int8:
            return torch.from_numpy(a.copy()).to(device)
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=device, dtype=dtype
        )

    return convert(tree)


def params_to_numpy(tree: Any) -> Any:
    """The inverse of ``params_from_jax``: a tree of numpy arrays on the
    host, float leaves as f32, int8 leaves as int8. DTensor leaves are
    gathered whole, so every rank of their mesh must call it."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_to_numpy(v) for v in tree]
    t = tree.detach()
    if hasattr(t, "full_tensor"):  # a DTensor: the whole leaf (a collective)
        t = t.full_tensor()
    t = t.cpu()
    return t.numpy().copy() if t.dtype == torch.int8 else t.float().numpy().copy()
