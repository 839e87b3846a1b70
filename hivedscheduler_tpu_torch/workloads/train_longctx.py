"""Long-context fine-tune: 128k-token sequences over a gang's cards.

Counterpart of ``example/workloads/train_longctx.py``::

    python -m hivedscheduler_tpu_torch.workloads.launch --bind-info FILE -- \\
        hivedscheduler_tpu_torch.workloads.train_longctx --steps 20

The batch is one row (long-context fine-tuning); the sequence is what must
scale. So the mesh gives tp the first of 4, 2, 1 that divides both the
process count and the KV heads (whole GQA groups per rank), and the rest
to sequence parallelism: sp = n / tp, each rank holding S / sp tokens.
Attention over sp goes through ``parallel/sharding.sp_attention``: Ulysses
on the card, where every rank runs the flash kernels over the whole
sequence at H / (tp * sp) heads, ring attention where the heads do not
allow it. Each step draws a new synthetic row [1, seq] from the seed,
takes this rank's shard (``sharding.shard_batch``) and prints the loss.
The weights come from seed 0 and the rows from seed 1, as the JAX twin's
keys do.

The JAX twin's flags (``--steps``, ``--seq``, ``--model``) plus the port's
``--layers`` (cut the depth, widths kept) and ``--device``, as
``train.main`` has them, and ``--plain`` (the eager step on the card
too). Blocks are checkpointed under remat "flash", the port's
``train.main`` default: the flash forward's outputs are kept, so every
step launches each kernel once a layer. One process keeps the
unsharded step. On the card each step replays the CUDA graph that each
rank captured at the first (``models/train.make_train_step``), Ulysses'
all-to-alls or ring's shifts inside.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..models import train, transformer
from ..ops.attention import kernel_launches
from ..parallel import mesh as pmesh
from ..parallel import sharding
from .common import bootstrap_distributed, lift_env_block, synthetic_tokens

SEQ_LEN = 128 * 1024
MODELS = {"llama8b": transformer.llama3_8b, "tiny": transformer.tiny}


def mesh_config(n: int, n_kv_heads: int) -> pmesh.MeshConfig:
    """tp: the first of 4, 2, 1 dividing both n and the KV heads; sp: the
    rest of the gang."""
    tp = next(t for t in (4, 2, 1) if n % t == 0 and n_kv_heads % t == 0)
    return pmesh.MeshConfig(sp=n // tp, tp=tp)


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, object]]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--seq", type=int, default=SEQ_LEN)
    parser.add_argument("--model", choices=sorted(MODELS), default="llama8b",
                        help="tiny = smoke-test shapes")
    parser.add_argument("--layers", type=int, default=None,
                        help="cut the depth to this many layers (widths stay)")
    parser.add_argument("--device", default=None,
                        help="default cuda; 'cpu' runs the plain versions")
    parser.add_argument("--plain", action="store_true",
                        help="the eager step on the card too (the captured step's plain "
                             "version)")
    args = parser.parse_args(argv)

    lift_env_block()  # the card grant, before anything initialises CUDA
    device = resolve_device(args.device)
    bootstrap_distributed(device)
    n = pmesh.world_size()
    base = MODELS[args.model]()
    config = dataclasses.replace(base, max_seq_len=args.seq, n_layers=args.layers or base.n_layers,
                                 remat=True, remat_policy="flash")
    layout = mesh_config(n, config.n_kv_heads)
    mesh = pmesh.make_mesh(layout, device)
    print(f"longctx {args.model}: {config.n_layers} layers, seq {args.seq}, mesh sp "
          f"{layout.sp} x tp {layout.tp} on {device}", flush=True)
    return run(config, mesh, device, args.steps, args.seq, args.plain)


def run(config: transformer.TransformerConfig, mesh, device: torch.device, steps: int,
        seq: int, plain: bool = False) -> List[Dict[str, object]]:
    """``steps`` steps from seed 0's weights on seed 1's rows through
    ``models/train.make_train_step`` (on the card, each rank's replay of
    the graph captured at the first step, the step's collectives inside),
    or the eager ``train_step`` with ``plain``. Returns each step's loss,
    ms, tokens/s and kernel launches, and prints them."""
    gen = torch.Generator(device=device).manual_seed(0)
    params, optimizer = train.init_sharded(config, mesh, gen, device)
    step = train.make_train_step(config, mesh, optimizer)
    rng = np.random.default_rng(1)
    records = []
    for i in range(steps):
        tokens = torch.from_numpy(synthetic_tokens(rng, 1, seq, config.vocab_size))
        if sharding.is_active(mesh):
            tokens = sharding.shard_batch(tokens, mesh)
        tokens = tokens.to(device)
        before = kernel_launches()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        # The scalar's fetch syncs the card.
        loss = float(train.train_step(params, optimizer, tokens, config, device, mesh) if plain
                     else step(params, tokens))
        seconds = time.perf_counter() - t0
        after = kernel_launches()
        rec = {"step": i, "loss": loss, "step_ms": seconds * 1e3,
               "tokens_per_s": seq / seconds,
               "launches": {k: after[k] - before[k] for k in after}}
        records.append(rec)
        print(f"step {i} loss {loss:.6f} ({rec['step_ms']:.1f} ms, "
              f"{rec['tokens_per_s']:.0f} tok/s, launches {rec['launches']})", flush=True)
    return records


if __name__ == "__main__":
    main()
