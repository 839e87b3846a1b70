"""Pipeline parallelism: GPipe microbatching over the ``pp`` mesh axis.

Counterpart of ``hivedscheduler_tpu/parallel/pipeline.py``. The stacked
layer parameters ``[L, ...]`` shard their leading dim over ``pp`` (the rule
table's ``"layers": "pp"``), so stage s holds layers ``[s*L/P, (s+1)*L/P)``.
dp, fsdp, sp and tp run inside each stage as on a mesh without pp: the
stage's blocks make their own collectives over their stage's groups.

The JAX package writes the schedule as one ``lax.scan`` over M + P - 1
ticks in which every stage computes every tick (bubble ticks on garbage)
and leaves the backward to ``jax.grad``. Here the schedule is an explicit
loop, one autograd function whose forward and backward each run the whole
of this stage's part:

- forward: for each microbatch in order, receive its input from stage s-1
  (stage 0 takes its rows of ``x``), apply the stage's layers, send the
  output to stage s+1;
- backward: for each microbatch in reverse order, take the gradient of its
  output (the last stage from the caller, the others from stage s+1), run
  backward through the stage's layers, send the input's gradient to stage
  s-1.

Every rank thus issues its P2P calls, and its stage's collectives, in one
fixed order; a graph of separate P2P nodes would leave that order to the
autograd engine, which may choose differently on different ranks. The
stages compute only on real microbatches, never on bubble ticks: the values
are the JAX ones, each microbatch the plain loop's computation.

The result lives on the last stage. There :func:`pipeline_blocks` returns
the stack's output; every other stage gets a zero f32 scalar, its
*anchor*: the caller finishes the loss on the last stage, returns the
anchor as the loss elsewhere, and ``backward()`` on it runs that stage's
part of the backward schedule. A caller that wants the output on every stage (the JAX package
broadcasts it by a masked psum) broadcasts it afterwards
(``sharding.broadcast_from``).

Microbatches split the rows this rank holds (the JAX package splits the
global batch and GSPMD shards each microbatch): rows are independent, so
only the schedule depends on the grouping.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from . import sharding

BlockFn = Callable[[torch.Tensor, Dict[str, torch.Tensor]], torch.Tensor]


def unstack(layers: Dict[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
    """Per-layer views of stacked ``[L, ...]`` leaves, one ``unbind`` a leaf:
    the backward stacks the layer gradients once, instead of scattering each
    into its own zero ``[L, ...]`` tensor as indexing would."""
    cols = {k: v.unbind(0) for k, v in layers.items()}
    n = len(next(iter(cols.values())))
    return [{k: col[i] for k, col in cols.items()} for i in range(n)]


def stages(mesh: Any, axis: str = "pp") -> int:
    """The pipeline's stage count on ``mesh`` (1 without a mesh)."""
    return sharding.axes_size(axis, mesh) if mesh is not None else 1


def is_last_stage(mesh: Any, axis: str = "pp") -> bool:
    return stages(mesh, axis) == 1 or mesh.get_local_rank(axis) == stages(mesh, axis) - 1


def check_layers(n_layers: int, p: int) -> None:
    if n_layers % p != 0:
        raise ValueError(f"n_layers={n_layers} not divisible by pp={p}")


def microbatches(batch: int, p: int, n_microbatches: Optional[int] = None) -> int:
    """The microbatch count M: ``n_microbatches`` where it divides the
    batch, else a ValueError; by default the largest divisor of the batch
    not above 2 * pp (the deepest fill that rejects no batch: batch 10 at
    pp 4 gives 5, a prime batch gives 1)."""
    if n_microbatches is not None:
        if batch % n_microbatches != 0:
            raise ValueError(f"batch={batch} not divisible by n_microbatches={n_microbatches}")
        return n_microbatches
    return max(d for d in range(1, min(batch, 2 * p) + 1) if batch % d == 0)


def pipeline_blocks(
    layers: Dict[str, torch.Tensor],  # stacked [L, ...] leaves: the whole stack
    x: torch.Tensor,  # [B, S, D] entering the stack (read on stage 0 only)
    mesh: Any,
    block_fn: BlockFn,  # (x, layer) -> x
    n_microbatches: Optional[int] = None,
    axis: str = "pp",
) -> torch.Tensor:
    """Apply all L stacked layers to ``x``, pipelined over the ``axis``
    stages: with pp <= 1 the plain layer loop; else this stage's L/P
    layers through :func:`stage_blocks`. On stages after the first ``x``
    gives only the microbatches' shape, dtype and device."""
    p = stages(mesh, axis)
    if p <= 1:
        for lp in unstack(layers):
            x = block_fn(x, lp)
        return x
    n_layers = next(iter(layers.values())).shape[0]
    check_layers(n_layers, p)
    per = n_layers // p
    s = mesh.get_local_rank(axis)
    mine = {k: v.narrow(0, s * per, per) for k, v in layers.items()}
    return stage_blocks(mine, x, mesh, block_fn, n_microbatches, axis)


def stage_blocks(
    stage_layers: Dict[str, torch.Tensor],  # this stage's stacked [L/P, ...] leaves
    x: torch.Tensor,
    mesh: Any,
    block_fn: BlockFn,
    n_microbatches: Optional[int] = None,
    axis: str = "pp",
) -> torch.Tensor:
    """The GPipe schedule on this stage's own layers (a sharded model's
    local shard of the stack). Returns the stack's output [B, S, D] on the
    last stage and the anchor (a zero scalar) on the others."""
    m = microbatches(x.shape[0], stages(mesh, axis), n_microbatches)
    per_layer = unstack(stage_layers)
    keys = [list(lp) for lp in per_layer]
    flat = [t for lp in per_layer for t in lp.values()]
    plan = _Plan(mesh, axis, block_fn, m, keys, torch.is_grad_enabled())
    return _Schedule.apply(plan, x, *flat)


class _Plan:
    """What the schedule needs besides tensors; it also carries the
    microbatches' graphs from the forward to the backward."""

    def __init__(self, mesh, axis, block_fn, m, keys, grad):
        self.mesh, self.axis, self.block_fn, self.m, self.keys = mesh, axis, block_fn, m, keys
        self.grad = grad
        self.params: List[torch.Tensor] = []
        self.ins: List[torch.Tensor] = []
        self.outs: List[torch.Tensor] = []

    def layers(self) -> List[Dict[str, torch.Tensor]]:
        it = iter(self.params)
        return [{k: next(it) for k in keys} for keys in self.keys]


class _Schedule(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, x, *params):
        mesh, axis = plan.mesh, plan.axis
        s, p = mesh.get_local_rank(axis), stages(mesh, axis)
        rows = x.shape[0] // plan.m
        shape = (rows,) + tuple(x.shape[1:])
        # The stage's own leaves, so that backward can hand their gradients
        # back through this function's outputs.
        plan.params = [t.detach().requires_grad_(t.requires_grad) for t in params]
        layers = plan.layers()
        with torch.set_grad_enabled(plan.grad):
            for i in range(plan.m):
                if s == 0:
                    inp = x.detach().narrow(0, i * rows, rows)
                    inp.requires_grad_(plan.grad and x.requires_grad)
                else:
                    inp = sharding.recv(shape, x.dtype, x.device, mesh, axis, s - 1)
                    inp.requires_grad_(plan.grad)
                h = inp
                for lp in layers:
                    h = plan.block_fn(h, lp)
                if s < p - 1:
                    sharding.send(h.detach(), mesh, axis, s + 1)
                plan.ins.append(inp)
                plan.outs.append(h)
        ctx.plan, ctx.x_grad = plan, s == 0 and x.requires_grad
        if s == p - 1:
            return torch.cat([h.detach() for h in plan.outs])
        # The anchor stands for the loss, which is f32 whatever the compute
        # dtype: the stages sum their losses over pp, and an all-reduce of a
        # bf16 zero against an f32 loss pairs two and four bytes.
        return torch.zeros((), dtype=torch.float32, device=x.device)

    @staticmethod
    def backward(ctx, grad):
        plan = ctx.plan
        mesh, axis = plan.mesh, plan.axis
        s, p = mesh.get_local_rank(axis), stages(mesh, axis)
        for i in reversed(range(plan.m)):
            out = plan.outs[i]
            if s == p - 1:
                g = grad.narrow(0, i * out.shape[0], out.shape[0])
            else:
                g = sharding.recv(tuple(out.shape), out.dtype, out.device, mesh, axis, s + 1)
            torch.autograd.backward(out, g)
            plan.outs[i] = None  # its graph is spent
            if s > 0:
                sharding.send(plan.ins[i].grad, mesh, axis, s - 1)
        gx = torch.cat([t.grad for t in plan.ins]) if ctx.x_grad else None
        grads = [t.grad for t in plan.params]
        plan.ins, plan.outs, plan.params = [], [], []
        return (None, gx, *grads)
