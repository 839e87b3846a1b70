"""Serve a Llama-style model on one device: weights from a training
checkpoint or random from a seed, synthetic prompts, flash-kernel prefill
and KV-cache decode.

Single-device counterpart of ``example/workloads/serve_llama.py``::

    python -m hivedscheduler_tpu_torch.serve --model llama3_8b \\
        --batch 4 --prompt-len 2048 --new-tokens 32 --temperature 0
    python -m hivedscheduler_tpu_torch.serve --model llama3_8b --layers 2 \\
        --ckpt /path/to/checkpoints

The job boots from the scheduler's env block (``HIVED_TPU_ENV``). With
``--ckpt`` it restores the parameters of the checkpoint's latest step
(``models/checkpoint.TrainCheckpointer.restore_params``: the trainer's
optimizer state is never read), in the compute dtype; ``--layers`` cuts the
depth as ``train.py`` does, so a depth-cut trainer's checkpoint can be
served. Each request prints its time to first token (prefill + first
sample), its decode rate, and how many times the flash kernel launched. A
world of more than one process raises: the sharded serving mesh is a later
slice of the port.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import Device, resolve_device
from .models import checkpoint, generate, quantize, transformer
from .ops import attention
from .parallel.mesh import world_size
from .workloads.common import bootstrap_distributed, synthetic_tokens  # noqa: F401 (re-exported)

MODELS = {"tiny": transformer.tiny, "llama3_8b": transformer.llama3_8b}


def _empty(tree: Any, dtype: torch.dtype, device: torch.device) -> Any:
    """Uninitialised tensors in ``dtype`` on ``device``, shaped like
    ``tree``'s leaves."""
    if isinstance(tree, dict):
        return {k: _empty(v, dtype, device) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=dtype, device=device)


def build(
    model: str,
    seed: int,
    device: Device = None,
    int8: bool = False,
    layers: Optional[int] = None,
    ckpt: Optional[str] = None,
) -> Tuple[transformer.TransformerConfig, transformer.Params]:
    """The model's config (depth cut to ``layers``) and its parameters in
    the compute dtype: restored from the latest step under ``ckpt``, else
    drawn from ``seed``; int8-quantized linears when ``int8``."""
    device = resolve_device(device)
    config = MODELS[model]()
    config = dataclasses.replace(config, n_layers=layers or config.n_layers)
    if ckpt:
        # Shapes from an init on the meta device: nothing is drawn.
        shapes = transformer.init(config, torch.Generator(), "meta")
        like = _empty(shapes, config.dtype, device)
        params, step = checkpoint.TrainCheckpointer(ckpt).restore_params(like)
        print(f"restored checkpoint step {step} from {ckpt}", flush=True)
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = transformer.init(config, gen, device)
    if int8:
        params = quantize.quantize_params(params)
    return config, params


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_request(
    params: transformer.Params,
    prompt: torch.Tensor,
    config: transformer.TransformerConfig,
    new_tokens: int,
    temperature: float = 0.0,
    top_p: float = 1.0,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, object]:
    """Generate ``new_tokens`` after ``prompt`` and time it: TTFT is the
    prefill plus the first sample, the decode rate counts the tokens after
    the first over the time after it. Host clock around device syncs."""
    device = prompt.device
    launches0 = attention.flash_attention.launches
    _sync(device)
    t0 = time.perf_counter()
    stream = generate.generate_stream(
        params, prompt, config, new_tokens, temperature, generator, top_p=top_p
    )
    tokens = [next(stream)]
    _sync(device)
    t1 = time.perf_counter()
    tokens.extend(stream)
    _sync(device)
    t2 = time.perf_counter()
    b = prompt.shape[0]
    decode_s = t2 - t1
    return {
        "tokens": torch.stack(tokens, dim=1),  # [B, new_tokens]
        "ttft_ms": (t1 - t0) * 1e3,
        "decode_tok_s": b * (new_tokens - 1) / decode_s if new_tokens > 1 else None,
        "flash_launches": attention.flash_attention.launches - launches0,
    }


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, object]]:
    """Serve ``--requests`` requests; returns each request's result
    (``run_request``'s dict)."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model", choices=sorted(MODELS), default="tiny")
    parser.add_argument("--layers", type=int, default=None,
                        help="cut the depth to this many layers (widths stay)")
    parser.add_argument("--ckpt", default=None,
                        help="checkpoint directory (models/checkpoint.py); omit for random weights")
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--prompt-len", type=int, default=512)
    parser.add_argument("--new-tokens", type=int, default=32)
    parser.add_argument("--temperature", type=float, default=0.8)
    parser.add_argument("--top-p", type=float, default=0.95)
    parser.add_argument("--int8", action="store_true",
                        help="serve int8-quantized linears (models/quantize.py)")
    parser.add_argument("--requests", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="default cuda; 'cpu' runs the plain versions")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    bootstrap_distributed(device)
    # One process: serve_llama.py's snap of the batch to a multiple of
    # dp x fsdp is the identity here and comes with the sharded mesh.
    if world_size() > 1:
        raise NotImplementedError(
            f"serving across {world_size()} processes needs the sharded serving "
            "mesh (ROADMAP queue 1 item 8); this slice serves one process"
        )
    config, params = build(args.model, args.seed, device, args.int8, args.layers, args.ckpt)
    rng = np.random.default_rng(args.seed + 1)
    gen = torch.Generator(device=device).manual_seed(args.seed + 2)
    results = []
    for r in range(args.requests):
        prompt = torch.from_numpy(
            synthetic_tokens(rng, args.batch, args.prompt_len, config.vocab_size)
        ).to(device)
        res = run_request(
            params, prompt, config, args.new_tokens, args.temperature,
            args.top_p, gen,
        )
        results.append(res)
        rate = res["decode_tok_s"]
        print(
            f"request {r}: ttft {res['ttft_ms']:.1f} ms, decode "
            f"{'n/a' if rate is None else f'{rate:.1f}'} tok/s, "
            f"flash launches {res['flash_launches']}, first ids "
            f"{res['tokens'][0, :4].tolist()}",
            flush=True,
        )
    return results


if __name__ == "__main__":
    main()
