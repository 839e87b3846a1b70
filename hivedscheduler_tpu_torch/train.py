"""Train a Llama-style model: random f32 master weights from a seed,
batches from a token file or one fixed synthetic batch, AdamW, bf16
compute with the flash kernels in forward and backward; on one device, or
sharded over the processes of a gang.

Counterpart of ``example/workloads/train_llama.py``::

    python -m hivedscheduler_tpu_torch.train --model llama3_8b --layers 8 \\
        --batch 1 --seq 8192 --steps 6 --remat-policy flash
    python -m hivedscheduler_tpu_torch.train --model llama3_8b --layers 2 \\
        --data tokens.bin --steps 50

The job boots from the env block the scheduler writes at bind time
(``HIVED_TPU_ENV``, ``workloads/common.bootstrap_distributed``). With
``--data`` each step takes the next batch of a flat token file (rows of
``--seq`` tokens, default the model's ``max_seq_len``; the sample order
comes from seed 1 as in ``train_llama.py``), read and copied to the card
ahead of the step (on a side stream; the step copies it into its graph's
static buffer on the current stream, which waits for that copy first);
without it every step takes the same synthetic batch, as the JAX
package's ``perf.bench_train_step`` does. On the card every step
runs from the CUDA graph captured at the first step of its shape
(``models/train.captured_step``, as JAX jits the step; on a gang each
rank's graph holds its sharded step, collectives included): the first step
runs eagerly and captures, every later one copies its batch into the
graph's static buffer and replays. Each step prints its loss, its time
(host clock around a device sync), tokens/s, on CUDA the share of the
H100's dense bf16 peak that the model FLOPs (``models/perf.flops_per_token``)
reach, each kernel's launches (a replay's counted as its capture recorded
them) and whether it captured. ``--device cpu`` runs the plain versions,
the eager step; ``--layers`` cuts the depth and nothing else.

A gang of more than one process lays itself out as ``train_llama.py``
does: tp 4 when the world divides by 4, sp 1, the rest fsdp
(``parallel/mesh.infer_mesh_config``). The parameters and AdamW's state are
placed by the rule table (``models/train.init_sharded``: ZeRO-3 over fsdp,
tensor parallelism over tp), ``--batch`` rows go to each rank of the
batch's (dp, fsdp) shards, and each rank reads its own rows of every
global batch; the loss printed is the global batch's. One process keeps
the unsharded step.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import time
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from . import Device, resolve_device
from .models import perf, train, transformer
from .ops.attention import kernel_launches
from .parallel import sharding
from .parallel.mesh import infer_mesh_config, make_mesh, world_size
from .serve import MODELS
from .utils.data import TokenFileDataset, prefetch_to_device, sharded_batches
from .workloads.common import bootstrap_distributed, lift_env_block, synthetic_tokens

# Token ids above this need a uint32 token file (Llama-3's vocab is 128,256).
UINT16_VOCAB = 65536


def build(
    model: str,
    seed: int,
    device: Device = None,
    layers: Optional[int] = None,
    remat_policy: str = "flash",
    mesh: Any = None,
) -> Tuple[transformer.TransformerConfig, transformer.Params]:
    """The model's config (depth cut to ``layers``, every block
    checkpointed under ``remat_policy``) and f32 master parameters drawn on
    the device from ``seed``: on an active ``mesh``, the same values as
    DTensors placed by the rule table."""
    device = resolve_device(device)
    config = MODELS[model]()
    config = dataclasses.replace(
        config, n_layers=layers or config.n_layers, remat=True, remat_policy=remat_policy
    )
    gen = torch.Generator(device=device).manual_seed(seed)
    if sharding.is_active(mesh):
        return config, transformer.init_distributed(config, mesh, gen, device, torch.float32)
    return config, transformer.init(config, gen, device, dtype=torch.float32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(
    params: transformer.Params,
    config: transformer.TransformerConfig,
    tokens: Union[torch.Tensor, Iterable[torch.Tensor]],
    steps: int,
    optimizer: Optional[torch.optim.Optimizer] = None,
    mesh: Any = None,
) -> Iterator[Dict[str, object]]:
    """Take ``steps`` AdamW steps (a new ``make_optimizer`` unless one is
    given), each on the next of ``tokens``' batches, or on ``tokens`` itself
    when it is one [B, S] tensor, through ``models/train.captured_step``
    (on the card, from the graph of the batch's shape); yield one record a
    step: loss, step_ms, tokens_per_s, peak_share (CUDA only), launches and
    captured (whether the step captured its graph). On an active ``mesh``
    the batches are this rank's rows, tokens/s and the peak share this
    rank's, and the loss the global batch's."""
    batches = itertools.repeat(tokens) if isinstance(tokens, torch.Tensor) else iter(tokens)
    optimizer = optimizer or train.make_optimizer(params)
    n_param = perf.n_params(params)
    for i in range(steps):
        batch = next(batches)
        device = batch.device
        flops_tok = perf.flops_per_token(config, n_param, batch.shape[1])
        before, captures = kernel_launches(), train.StepGraphs.captures
        _sync(device)
        t0 = time.perf_counter()
        loss = float(train.captured_step(params, optimizer, batch, config, device, mesh))
        _sync(device)
        seconds = time.perf_counter() - t0
        after = kernel_launches()
        tok_s = batch.numel() / seconds
        yield {
            "step": i,
            "loss": loss,
            "step_ms": seconds * 1e3,
            "tokens_per_s": tok_s,
            "peak_share": (
                flops_tok * tok_s / perf.H100_BF16_FLOPS if device.type == "cuda" else None
            ),
            "launches": {k: after[k] - before[k] for k in after},
            "captured": train.StepGraphs.captures > captures,
        }


@dataclasses.dataclass
class TrainResult:
    """What ``main`` leaves behind: the trained state and each step's
    record."""

    config: transformer.TransformerConfig
    params: transformer.Params
    optimizer: torch.optim.Optimizer
    records: List[Dict[str, object]]


def token_dtype(vocab_size: int, name: Optional[str] = None) -> np.dtype:
    """A token file's id dtype: ``name`` when given, else uint16 when every
    id fits and uint32 when the vocab does not."""
    if name is None:
        name = "uint16" if vocab_size <= UINT16_VOCAB else "uint32"
    dtype = np.dtype(name)
    if np.iinfo(dtype).max < vocab_size - 1:
        raise ValueError(f"{name} cannot hold the ids of a {vocab_size}-token vocab")
    return dtype


def main(argv: Optional[Sequence[str]] = None) -> TrainResult:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model", choices=sorted(MODELS), default="tiny")
    parser.add_argument("--layers", type=int, default=None,
                        help="cut the depth to this many layers (widths stay)")
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--seq", type=int, default=None,
                        help="tokens a row (default: the model's max_seq_len)")
    parser.add_argument("--steps", type=int, default=6)
    parser.add_argument("--remat-policy", choices=transformer.REMAT_POLICIES, default="flash")
    parser.add_argument("--data", default=None,
                        help="flat token file (memory-mapped); omit for one synthetic batch")
    parser.add_argument("--data-dtype", choices=("uint16", "uint32"), default=None,
                        help="the token file's id dtype (default: uint32 when the "
                             "vocab exceeds 65,536 ids, else uint16)")
    parser.add_argument("--opportunistic", action="store_true",
                        help="accepted as train_llama.py accepts it; the scheduler reads it")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="default cuda; 'cpu' runs the plain versions")
    args = parser.parse_args(argv)

    lift_env_block()  # the card grant, before anything initialises CUDA
    device = resolve_device(args.device)
    bootstrap_distributed(device)
    n = world_size()
    mesh, per = None, 1
    if n > 1:
        layout = infer_mesh_config(n, tp=4 if n % 4 == 0 else 1, sp=1)
        mesh = make_mesh(layout, device)
        per = layout.dp * layout.fsdp
    config, params = build(args.model, args.seed, device, args.layers, args.remat_policy, mesh)
    seq = args.seq or config.max_seq_len
    gang = ("" if mesh is None else
            f", rank {dist.get_rank()} of mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    print(f"{args.model}: {config.n_layers} layers, {perf.n_params(params):,} parameters, "
          f"batch {args.batch} x {seq} on {device}{gang}", flush=True)
    stream = None
    if args.data:
        dataset = TokenFileDataset(args.data, seq - 1,
                                   dtype=token_dtype(config.vocab_size, args.data_dtype))
        stream = prefetch_to_device(
            sharded_batches(dataset, args.batch * per, mesh, seed=1), device)
        batches: Union[torch.Tensor, Iterator[torch.Tensor]] = stream
    else:
        rng = np.random.default_rng(args.seed + 1)
        batches = torch.from_numpy(
            synthetic_tokens(rng, args.batch * per, seq, config.vocab_size))
        if mesh is not None:
            batches = sharding.shard_batch(batches, mesh)
        batches = batches.to(device)
    optimizer = train.make_optimizer(params)
    records = []
    try:
        for rec in run(params, config, batches, args.steps, optimizer, mesh):
            records.append(rec)
            share = rec["peak_share"]
            print(
                f"step {rec['step']}: loss {rec['loss']:.4f}, {rec['step_ms']:.1f} ms, "
                f"{rec['tokens_per_s']:.0f} tok/s, bf16 peak share "
                f"{'n/a' if share is None else f'{share:.3f}'}, launches {rec['launches']}"
                + (", captured" if rec["captured"] else ""),
                flush=True,
            )
    finally:
        if stream is not None:
            stream.close()  # release the prefetch thread
    return TrainResult(config, params, optimizer, records)


if __name__ == "__main__":
    main()
