"""Pipeline-parallel pretraining: the layer stack split into two stages.

Counterpart of ``example/workloads/train_pp.py``::

    python -m hivedscheduler_tpu_torch.workloads.launch --bind-info FILE -- \\
        hivedscheduler_tpu_torch.workloads.train_pp --steps 20

A stage hop moves one microbatch's activations at a time, so the two
stages may sit in two cells joined by slower links, while fsdp, sp and tp
stay on each stage's own cards. Mesh: pp 2 x fsdp x tp (x sp with
``--sp``): tp the first of 4, 2, 1 that divides both the cards per stage
after sp and the KV heads, the rest fsdp. With ``--sp`` each stage also
shards the sequence (``sharding.sp_attention`` inside its blocks). The
refusals are the JAX twin's: an odd card count, ``--sp`` not dividing the
cards per stage, and stages that do not divide the layers.

The JAX twin's flags (``--steps``, ``--batch``, ``--seq``, ``--model``,
``--microbatches``, ``--sp``) plus the port's ``--layers`` (cut the depth,
widths kept), ``--device`` and ``--plain`` (the eager step on the card
too). The weights come from seed 0, and each step
draws a new synthetic batch [batch, seq] from seed 1, as the JAX twin's
keys do. Blocks are checkpointed under remat "flash" (the JAX twin: "full";
the values are the same): every step launches each kernel once a layer a
microbatch on each stage. On the card each step replays the CUDA graph
that each rank captured at the first (``models/train.captured_step``),
whatever the attention over sp.
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

PP = 2
MODELS = {"llama8b": transformer.llama3_8b, "tiny": transformer.tiny}


def mesh_config(n: int, sp: int, n_kv_heads: int) -> pmesh.MeshConfig:
    """pp 2, the requested sp, tp the first of 4, 2, 1 dividing both the
    cards per stage after sp and the KV heads, the rest fsdp. Raises
    SystemExit where the JAX twin refuses."""
    if n % PP != 0:
        raise SystemExit(f"pipeline demo needs an even device count, got {n}")
    if sp < 1 or n % (PP * sp) != 0:
        raise SystemExit(f"--sp {sp} must divide the per-stage device count "
                         f"({n} devices / pp={PP})")
    tp = next(t for t in (4, 2, 1) if (n // (PP * sp)) % t == 0 and n_kv_heads % t == 0)
    return pmesh.MeshConfig(pp=PP, sp=sp, fsdp=n // (PP * sp * tp), tp=tp)


def run(config: transformer.TransformerConfig, mesh, device: torch.device, steps: int,
        batch: int, seq: int, plain: bool = False) -> List[Dict[str, object]]:
    """``steps`` steps from seed 0's weights on seed 1's batches: the
    sharded step on an active mesh, the one-process step otherwise (the
    same model, seeds and batches, to hold a gang against), each through
    ``models/train.captured_step`` (on the card, a replay of the graph
    captured at the first step: on a mesh each stage's graph holds its
    part of the schedule, its sends and receives included, and with
    ``--sp`` its all-to-alls or shifts), or the eager ``train_step`` with
    ``plain``. Returns each step's loss, ms, tokens/s and kernel launches,
    and prints them."""
    gen = torch.Generator(device=device).manual_seed(0)
    params, optimizer = train.init_sharded(config, mesh, gen, device)
    step = train.train_step if plain else train.captured_step
    rng = np.random.default_rng(1)
    records = []
    for i in range(steps):
        tokens = torch.from_numpy(synthetic_tokens(rng, batch, seq, config.vocab_size))
        if sharding.is_active(mesh):
            tokens = sharding.shard_batch(tokens, mesh)
        tokens = tokens.to(device)
        before = kernel_launches()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        # The scalar's fetch syncs the card.
        loss = float(step(params, optimizer, tokens, config, device, mesh))
        seconds = time.perf_counter() - t0
        after = kernel_launches()
        rec = {"step": i, "loss": loss, "step_ms": seconds * 1e3,
               "tokens_per_s": batch * seq / seconds,
               "launches": {k: after[k] - before[k] for k in after}}
        records.append(rec)
        print(f"step {i} loss {loss:.6f} ({rec['step_ms']:.1f} ms, "
              f"{rec['tokens_per_s']:.0f} tok/s, launches {rec['launches']})", flush=True)
    return records


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, object]]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--seq", type=int, default=4096)
    parser.add_argument("--model", choices=sorted(MODELS), default="llama8b",
                        help="tiny = smoke-test shapes")
    parser.add_argument("--microbatches", type=int, default=None)
    parser.add_argument("--sp", type=int, default=1,
                        help="sequence-parallel degree inside each stage")
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
    layout = mesh_config(n, args.sp, base.n_kv_heads)
    config = dataclasses.replace(base, max_seq_len=args.seq, n_layers=args.layers or base.n_layers,
                                 pp_microbatches=args.microbatches, remat=True,
                                 remat_policy="flash")
    if config.n_layers % PP != 0:
        raise SystemExit(f"pp={PP} stages must divide n_layers={config.n_layers}")
    mesh = pmesh.make_mesh(layout, device)
    print(f"mesh: {dataclasses.asdict(layout)}", flush=True)
    return run(config, mesh, device, args.steps, args.batch, args.seq, args.plain)


if __name__ == "__main__":
    main()
