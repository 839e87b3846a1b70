"""BERT-large MLM pretraining on a gang's cards.

Counterpart of ``example/workloads/train_bert.py``::

    python -m hivedscheduler_tpu_torch.workloads.launch --bind-info FILE -- \\
        hivedscheduler_tpu_torch.workloads.train_bert --steps 20

Mesh: tp = min(2, n), the rest fsdp (``infer_mesh_config``). Each step
draws a batch of 8 rows per batch shard (8 * dp * fsdp) of 512 tokens from
seed 1 and masks 15% of its positions: a masked position's token becomes
[MASK] (103) and its target the original token; every other target is
-100. AdamW with ``optax.adamw(1e-4)``'s settings on every leaf: lr 1e-4,
betas (0.9, 0.999), eps 1e-8, weight decay 1e-4. The weights come from
seed 0. Prints ``step i mlm loss x`` each step. On the card each step
replays the CUDA graph captured at the first (``captured_step``), on one
card or on each rank of the gang.

The port adds ``--steps``, ``--layers`` (cut the depth, widths kept) and
``--device``. One process keeps the unsharded step.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..models import bert, train, transformer
from ..ops.attention import kernel_launches
from ..parallel import mesh as pmesh
from ..parallel import sharding
from .common import bootstrap_distributed, lift_env_block, synthetic_tokens

SEQ = 512
ROWS_PER_SHARD = 8
MASK_ID, MASK_RATE, IGNORE = 103, 0.15, -100


def make_optimizer(params: bert.Params, learning_rate: float = 1e-4) -> torch.optim.AdamW:
    """AdamW over every leaf with ``optax.adamw(learning_rate)``'s defaults
    (betas 0.9 / 0.999, eps 1e-8, weight decay 1e-4). Marks every leaf as
    requiring grad. Capturable on CUDA leaves (a gang's DTensors too), as
    ``models/train.make_optimizer``."""
    leaves = transformer.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    return train.quiet_if_capturable(torch.optim.AdamW(
        leaves, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4,
        capturable=train.capturable(leaves)))


def masked_batch(rng: np.random.Generator, batch: int, seq: int,
                 vocab: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tokens, targets) [batch, seq]: 15% of positions masked."""
    tokens = synthetic_tokens(rng, batch, seq, vocab)
    mask = rng.random(tokens.shape) < MASK_RATE
    targets = np.where(mask, tokens, IGNORE)
    return torch.from_numpy(np.where(mask, MASK_ID, tokens)), torch.from_numpy(targets)


def train_step(params: bert.Params, optimizer: torch.optim.Optimizer, tokens: torch.Tensor,
               targets: torch.Tensor, config: bert.BertConfig, mesh: Any = None) -> torch.Tensor:
    """One step: the MLM loss, backward, AdamW. On an active mesh ``tokens``
    and ``targets`` are this rank's rows; the loss returned (detached) and
    the gradients are the global batch's."""
    optimizer.zero_grad(set_to_none=True)
    loss = bert.mlm_loss(params, tokens, targets, config, mesh)
    loss.backward()
    if sharding.is_active(mesh):
        sharding.reduce_gradients(transformer.leaves(params), mesh)
        loss = sharding.mean_over_batch(loss, mesh)
    optimizer.step()
    return loss.detach()


def captured_step(params: bert.Params, optimizer: torch.optim.Optimizer, tokens: torch.Tensor,
                  targets: torch.Tensor, config: bert.BertConfig, mesh: Any = None
                  ) -> torch.Tensor:
    """:func:`train_step` from the captured graph of ``params``' owner
    (``models/train.step_graphs``) for the batch's shape and ``mesh``,
    ``tokens`` and ``targets`` its static inputs (on an active mesh, the
    rank's sharded step with its collectives); the eager step for CPU
    parameters."""
    if not train._graphed(transformer.leaves(params)[0]):
        return train_step(params, optimizer, tokens, targets, config, mesh)
    return train.step_graphs(params, optimizer).step(
        ("bert", config, mesh), lambda t, y: train_step(params, optimizer, t, y, config, mesh),
        params, (tokens, targets))[0]


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, object]]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--layers", type=int, default=None,
                        help="cut the depth to this many layers (widths stay)")
    parser.add_argument("--device", default=None,
                        help="default cuda; 'cpu' runs the plain versions")
    args = parser.parse_args(argv)

    lift_env_block()  # the card grant, before anything initialises CUDA
    device = resolve_device(args.device)
    bootstrap_distributed(device)
    n = pmesh.world_size()
    layout = pmesh.infer_mesh_config(n, tp=min(2, n))
    mesh = pmesh.make_mesh(layout, device)
    base = bert.bert_large()
    config = dataclasses.replace(base, n_layers=args.layers or base.n_layers)
    params = bert.init_sharded(config, mesh, torch.Generator(device=device).manual_seed(0), device)
    optimizer = make_optimizer(params)
    batch = ROWS_PER_SHARD * layout.dp * layout.fsdp
    print(f"bert-large: {config.n_layers} layers, batch {batch} x {SEQ}, mesh fsdp "
          f"{layout.fsdp} x tp {layout.tp} on {device}", flush=True)
    rng = np.random.default_rng(1)
    records = []
    for i in range(args.steps):
        tokens, targets = masked_batch(rng, batch, SEQ, config.vocab_size)
        if sharding.is_active(mesh):
            tokens, targets = (sharding.shard_batch(t, mesh) for t in (tokens, targets))
        tokens, targets = tokens.to(device), targets.to(device)
        before = kernel_launches()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        loss = float(captured_step(params, optimizer, tokens, targets, config, mesh))
        seconds = time.perf_counter() - t0
        after = kernel_launches()
        rec = {"step": i, "loss": loss, "step_ms": seconds * 1e3,
               "tokens_per_s": batch * SEQ / seconds,
               "launches": {k: after[k] - before[k] for k in after}}
        records.append(rec)
        print(f"step {i} mlm loss {loss:.4f} ({rec['step_ms']:.1f} ms, "
              f"{rec['tokens_per_s']:.0f} tok/s, launches {rec['launches']})", flush=True)
    return records


if __name__ == "__main__":
    main()
