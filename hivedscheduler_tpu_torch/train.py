"""Train a Llama-style model on one device: random f32 master weights from
a seed, one fixed synthetic batch, AdamW, bf16 compute with the flash
kernels in forward and backward.

Single-card counterpart of ``example/workloads/train_llama.py`` (one rank
of that job, at its per-device batch)::

    python -m hivedscheduler_tpu_torch.train --model llama3_8b --layers 8 \\
        --batch 1 --seq 8192 --steps 6 --remat-policy flash

Each step prints its loss, its time (host clock around a device sync),
tokens/s, on CUDA the share of the H100's dense bf16 peak that the model
FLOPs (``models/perf.flops_per_token``) reach, and each kernel's launches.
Every step takes the same batch, as the JAX package's
``perf.bench_train_step`` does. ``--device cpu`` runs the plain versions;
``--layers`` cuts the depth and nothing else.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from . import Device, resolve_device
from .models import perf, train, transformer
from .ops import attention
from .serve import MODELS, synthetic_tokens


def build(
    model: str,
    seed: int,
    device: Device = None,
    layers: Optional[int] = None,
    remat_policy: str = "flash",
) -> Tuple[transformer.TransformerConfig, transformer.Params]:
    """The model's config (depth cut to ``layers``, every block
    checkpointed under ``remat_policy``) and f32 master parameters drawn on
    the device from ``seed``."""
    device = resolve_device(device)
    config = MODELS[model]()
    config = dataclasses.replace(
        config, n_layers=layers or config.n_layers, remat=True, remat_policy=remat_policy
    )
    gen = torch.Generator(device=device).manual_seed(seed)
    return config, transformer.init(config, gen, device, dtype=torch.float32)


def kernel_launches() -> Dict[str, int]:
    return {
        "flash_fwd": attention.flash_attention.launches,
        "flash_bwd_dkdv": attention.flash_bwd_dkdv.launches,
        "flash_bwd_dq": attention.flash_bwd_dq.launches,
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(
    params: transformer.Params,
    config: transformer.TransformerConfig,
    tokens: torch.Tensor,  # [B, S] on the parameters' device
    steps: int,
    optimizer: Optional[torch.optim.Optimizer] = None,
) -> Iterator[Dict[str, object]]:
    """Take ``steps`` AdamW steps on ``tokens`` (a new ``make_optimizer``
    unless one is given); yield one record a step: loss, step_ms,
    tokens_per_s, peak_share (CUDA only) and launches."""
    device = tokens.device
    optimizer = optimizer or train.make_optimizer(params)
    flops_tok = perf.flops_per_token(config, perf.n_params(params), tokens.shape[1])
    for i in range(steps):
        before = kernel_launches()
        _sync(device)
        t0 = time.perf_counter()
        loss = float(train.train_step(params, optimizer, tokens, config, device))
        _sync(device)
        seconds = time.perf_counter() - t0
        after = kernel_launches()
        tok_s = tokens.numel() / seconds
        yield {
            "step": i,
            "loss": loss,
            "step_ms": seconds * 1e3,
            "tokens_per_s": tok_s,
            "peak_share": (
                flops_tok * tok_s / perf.H100_BF16_FLOPS if device.type == "cuda" else None
            ),
            "launches": {k: after[k] - before[k] for k in after},
        }


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model", choices=sorted(MODELS), default="tiny")
    parser.add_argument("--layers", type=int, default=None,
                        help="cut the depth to this many layers (widths stay)")
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--seq", type=int, default=256)
    parser.add_argument("--steps", type=int, default=6)
    parser.add_argument("--remat-policy", choices=transformer.REMAT_POLICIES, default="flash")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="default cuda; 'cpu' runs the plain versions")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    config, params = build(args.model, args.seed, device, args.layers, args.remat_policy)
    rng = np.random.default_rng(args.seed + 1)
    tokens = torch.from_numpy(
        synthetic_tokens(rng, args.batch, args.seq, config.vocab_size)
    ).to(device)
    print(f"{args.model}: {config.n_layers} layers, {perf.n_params(params):,} parameters, "
          f"batch {args.batch} x {args.seq} on {device}", flush=True)
    for rec in run(params, config, tokens, args.steps):
        share = rec["peak_share"]
        print(
            f"step {rec['step']}: loss {rec['loss']:.4f}, {rec['step_ms']:.1f} ms, "
            f"{rec['tokens_per_s']:.0f} tok/s, bf16 peak share "
            f"{'n/a' if share is None else f'{share:.3f}'}, launches {rec['launches']}",
            flush=True,
        )


if __name__ == "__main__":
    main()
