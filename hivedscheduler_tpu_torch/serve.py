"""Serve a Llama-style model on one device: random weights from a seed,
synthetic prompts, flash-kernel prefill and KV-cache decode.

Single-device counterpart of ``example/workloads/serve_llama.py``::

    python -m hivedscheduler_tpu_torch.serve --model llama3_8b \\
        --batch 4 --prompt-len 2048 --new-tokens 32 --temperature 0

Each request prints its time to first token (prefill + first sample), its
decode rate, and how many times the flash kernel launched. Checkpoints are
a later slice of the port.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import Device, resolve_device
from .models import generate, quantize, transformer
from .ops import attention

MODELS = {"tiny": transformer.tiny, "llama3_8b": transformer.llama3_8b}


def synthetic_tokens(
    rng: np.random.Generator, batch: int, seq: int, vocab: int
) -> np.ndarray:
    """Uniform random token ids [batch, seq], int64."""
    return rng.integers(0, vocab, size=(batch, seq), dtype=np.int64)


def build(
    model: str, seed: int, device: Device = None, int8: bool = False
) -> Tuple[transformer.TransformerConfig, transformer.Params]:
    """The model's config and random parameters drawn from ``seed``,
    int8-quantized linears when ``int8``."""
    device = resolve_device(device)
    config = MODELS[model]()
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


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model", choices=sorted(MODELS), default="tiny")
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
    config, params = build(args.model, args.seed, device, args.int8)
    rng = np.random.default_rng(args.seed + 1)
    gen = torch.Generator(device=device).manual_seed(args.seed + 2)
    for r in range(args.requests):
        prompt = torch.from_numpy(
            synthetic_tokens(rng, args.batch, args.prompt_len, config.vocab_size)
        ).to(device)
        res = run_request(
            params, prompt, config, args.new_tokens, args.temperature,
            args.top_p, gen,
        )
        rate = res["decode_tok_s"]
        print(
            f"request {r}: ttft {res['ttft_ms']:.1f} ms, decode "
            f"{'n/a' if rate is None else f'{rate:.1f}'} tok/s, "
            f"flash launches {res['flash_launches']}, first ids "
            f"{res['tokens'][0, :4].tolist()}",
            flush=True,
        )


if __name__ == "__main__":
    main()
