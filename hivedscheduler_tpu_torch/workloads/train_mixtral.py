"""Mixtral 8x7B training with expert parallelism over a gang's cards
(BASELINE config 5).

Counterpart of ``example/workloads/train_mixtral.py``::

    python -m hivedscheduler_tpu_torch.workloads.launch --bind-info FILE -- \\
        hivedscheduler_tpu_torch.workloads.train_mixtral --steps 30

Mesh: ep 8 when the card count divides by 8, else 4 when by 4, else 1; tp
2 when the cards divide by ep x 2; the rest fsdp (on four cards: ep 4, two
experts a rank, each rank holding every row). Each step draws a new batch
of 4 rows per batch shard (4 * dp * fsdp) of 4096 synthetic tokens and
prints ``step i loss x``. AdamW with ``optax.adamw(1e-4)``'s settings on
every leaf; the weights come from seed 0 and the rows from seed 1. The
loss is ``mixtral.lm_loss``: the cross entropy plus 0.01 times the
routers' load-balancing loss. On the card each step replays the CUDA graph
captured at the first (``captured_step``), on one card or on each rank of
the gang.

The port adds ``--steps``, ``--layers`` (cut the depth, widths kept),
``--model`` (``tiny`` for smoke tests), ``--seq``, ``--device`` and
``--plain`` (the eager step on the card too, the captured step's plain
version), and ends with one ``mixtral summary {...}`` JSON line: the
losses, the parameters' digest (``models/train.tree_digest``) and on the
card the peak memory. One process keeps the unsharded step.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..models import mixtral, train, transformer
from ..ops.attention import kernel_launches
from ..parallel import mesh as pmesh
from ..parallel import sharding
from .common import bootstrap_distributed, lift_env_block, synthetic_tokens
from .train_bert import make_optimizer  # noqa: F401 (optax.adamw(1e-4)'s settings)

SEQ = 4096
ROWS_PER_SHARD = 4
MODELS = {"mixtral_8x7b": mixtral.mixtral_8x7b, "tiny": mixtral.tiny}


def mesh_config(n: int) -> pmesh.MeshConfig:
    """ep from 8, 4, 1 dividing n; tp 2 where n divides by ep x 2; the rest
    fsdp (the JAX twin's layout)."""
    ep = 8 if n % 8 == 0 else (4 if n % 4 == 0 else 1)
    tp = 2 if n % (ep * 2) == 0 else 1
    return pmesh.infer_mesh_config(n, ep=ep, tp=tp)


def train_step(params: mixtral.Params, optimizer: torch.optim.Optimizer, tokens: torch.Tensor,
               config: mixtral.MixtralConfig, mesh: Any = None) -> torch.Tensor:
    """One step: ``mixtral.lm_loss``, backward, AdamW. On an active mesh
    ``tokens`` are this rank's rows; the loss returned (detached) and the
    gradients are the global batch's."""
    optimizer.zero_grad(set_to_none=True)
    loss = mixtral.lm_loss(params, tokens, config, mesh)
    loss.backward()
    if sharding.is_active(mesh):
        sharding.reduce_gradients(transformer.leaves(params), mesh)
        loss = sharding.mean_over_batch(loss, mesh)
    optimizer.step()
    return loss.detach()


def captured_step(params: mixtral.Params, optimizer: torch.optim.Optimizer,
                  tokens: torch.Tensor, config: mixtral.MixtralConfig,
                  mesh: Any = None) -> torch.Tensor:
    """:func:`train_step` from the captured graph of ``params``' owner
    (``models/train.step_graphs``) for ``tokens``' shape, copied into its
    static int64 buffer; the eager step for CPU parameters. The routing
    reads nothing back to the host and its shapes come from the batch's, so
    one graph serves every batch of a shape. On an active mesh the graph
    holds the rank's sharded step: ``copy_to`` and ``reduce_from`` over ep,
    the router's gathers and sums, the fsdp gathers and reduce-scatters."""
    if not train._graphed(transformer.leaves(params)[0]):
        return train_step(params, optimizer, tokens, config, mesh)
    return train.step_graphs(params, optimizer).step(
        ("mixtral", config, mesh), lambda t: train_step(params, optimizer, t, config, mesh),
        params, (tokens.to(torch.long),))[0]


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, object]]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--layers", type=int, default=None,
                        help="cut the depth to this many layers (widths stay)")
    parser.add_argument("--model", choices=sorted(MODELS), default="mixtral_8x7b",
                        help="tiny = smoke-test shapes")
    parser.add_argument("--seq", type=int, default=SEQ)
    parser.add_argument("--device", default=None,
                        help="default cuda; 'cpu' runs the plain versions")
    parser.add_argument("--plain", action="store_true",
                        help="the eager step on the card too (the captured step's plain "
                             "version)")
    args = parser.parse_args(argv)

    lift_env_block()  # the card grant, before anything initialises CUDA
    device = resolve_device(args.device)
    bootstrap_distributed(device)
    layout = mesh_config(pmesh.world_size())
    mesh = pmesh.make_mesh(layout, device)
    base = MODELS[args.model]()
    config = dataclasses.replace(base, n_layers=args.layers or base.n_layers)
    gen = torch.Generator(device=device).manual_seed(0)
    params = train.init_sharded(config, mesh, gen, device, model=mixtral)[0]
    optimizer = make_optimizer(params)
    batch = ROWS_PER_SHARD * layout.dp * layout.fsdp
    print(f"mixtral {args.model}: {config.n_layers} layers, batch {batch} x {args.seq}, mesh "
          f"fsdp {layout.fsdp} x ep {layout.ep} x tp {layout.tp} on {device}", flush=True)
    rng = np.random.default_rng(1)
    records = []
    for i in range(args.steps):
        tokens = torch.from_numpy(synthetic_tokens(rng, batch, args.seq, config.vocab_size))
        if sharding.is_active(mesh):
            tokens = sharding.shard_batch(tokens, mesh)
        tokens = tokens.to(device)
        before = kernel_launches()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        step = train_step if args.plain else captured_step
        loss = float(step(params, optimizer, tokens, config, mesh))
        seconds = time.perf_counter() - t0
        after = kernel_launches()
        rec = {"step": i, "loss": loss, "step_ms": seconds * 1e3,
               "tokens_per_s": batch * args.seq / seconds,
               "launches": {k: after[k] - before[k] for k in after}}
        records.append(rec)
        print(f"step {i} loss {loss:.6f} ({rec['step_ms']:.1f} ms, "
              f"{rec['tokens_per_s']:.0f} tok/s, launches {rec['launches']})", flush=True)
    summary = {"losses": [r["loss"] for r in records],
               "params_digest": train.tree_digest(transformer.leaves(params))}
    if device.type == "cuda":
        summary["peak_memory_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    print("mixtral summary " + json.dumps(summary), flush=True)
    return records


if __name__ == "__main__":
    main()
