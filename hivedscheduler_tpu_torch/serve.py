"""Serve a Llama-style or Mixtral model: weights from a training checkpoint
or random from a seed, synthetic prompts, flash-kernel prefill and KV-cache
decode; on one device, or sharded over the processes of a gang.

Counterpart of ``example/workloads/serve_llama.py``::

    python -m hivedscheduler_tpu_torch.serve --model llama3_8b \\
        --batch 4 --prompt-len 2048 --new-tokens 32 --temperature 0
    python -m hivedscheduler_tpu_torch.serve --model llama3_8b --layers 2 \\
        --ckpt /path/to/checkpoints

The job boots from the scheduler's env block (``HIVED_TPU_ENV``). With
``--ckpt`` it restores the parameters of the checkpoint's latest step
(``models/checkpoint.TrainCheckpointer.restore_params``: the trainer's
optimizer state is never read), in the compute dtype; ``--layers`` cuts the
depth as ``train.py`` does, so a depth-cut trainer's checkpoint can be
served. ``--int8`` serves int8-quantized linears (``models/quantize.py``):
with ``--ckpt`` the linears are restored as the checkpoint's f32 values and
quantized from those, as the JAX twin quantizes the masters it restores.
Each request prints its time to first token (prefill + first sample), its
decode rate, how many times the flash kernel launched, how many decode
graphs it captured and in what time (on a card, alone or as a gang's
rank, the decode steps replay ``models/generate.py``'s captured step,
a rank's with its collectives inside; the first request of a shape
captures it), the first new token of each of the rank's rows and, on a
card, the peak memory.

A gang of more than one process lays itself out as ``serve_llama.py``
does: tp 4 when the world divides by 4, else 2 when by 2, the rest fsdp;
for ``mixtral_*`` ep = the expert count when it divides the world, else 2
when that does, the rest fsdp. The batch snaps to a multiple of dp x fsdp.
The weights are placed by the rule table, each rank serves its rows of
every request (the ranks of a tp or ep group the same rows, sampling
alike) and prints its own first row. The Mixtral models serve through the
same cache machinery, their routed FFN in ``generate``'s ``ffn`` hook
(``mixtral.decode_ffn``). With ``--int8`` the gang quantizes the placed
tree on the mesh (each rank its own shards, the per-channel max completed
over the axis that shards the in dim) and prints the digest of its int8
shards; ``--int8`` refuses the Mixtral models, whose expert weights it
does not quantize.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.tensor import empty as dtensor_empty

from . import Device, resolve_device
from .models import checkpoint, generate, mixtral, model_of, quantize, transformer
from .ops import attention
from .parallel import sharding
from .parallel.mesh import infer_mesh_config, make_mesh, world_size
from .workloads.common import (  # noqa: F401 (synthetic_tokens re-exported)
    bootstrap_distributed, lift_env_block, synthetic_tokens,
)

MODELS = {"tiny": transformer.tiny, "llama3_8b": transformer.llama3_8b,
          "mixtral_tiny": mixtral.tiny, "mixtral_8x7b": mixtral.mixtral_8x7b}
INT8_MOE = ("--int8 quantizes the dense family's linears; the MoE expert weights are out of "
            "scope (models/quantize.py)")


def _empty(tree: Any, dtype: Any, device: torch.device, placements: Any = None,
           mesh: Any = None) -> Any:
    """Uninitialised tensors on ``device``, shaped like ``tree``'s leaves,
    in ``dtype`` (one dtype, or a tree of them like ``tree``); DTensors on
    ``mesh`` where ``placements`` (a tree like ``tree``) are given."""
    if isinstance(tree, dict):
        return {k: _empty(v, dtype[k] if isinstance(dtype, dict) else dtype, device,
                          None if placements is None else placements[k], mesh)
                for k, v in tree.items()}
    if placements is not None:
        return dtensor_empty(tree.shape, dtype=dtype, device_mesh=mesh, placements=placements)
    return torch.empty(tree.shape, dtype=dtype, device=device)


def _restore_dtypes(shapes: transformer.Params, dtype: torch.dtype, int8: bool) -> Any:
    """The dtype each leaf is restored in: the compute dtype, but f32 (the
    checkpoint's own values) for the linears that ``int8`` quantizes."""
    if not int8:
        return dtype
    out = {k: dtype for k in shapes}
    out["layers"] = {k: (torch.float32 if k in quantize.LAYER_LINEAR_KEYS else dtype)
                     for k in shapes["layers"]}
    if "lm_head" in shapes:
        out["lm_head"] = torch.float32
    return out


def build(
    model: str,
    seed: int,
    device: Device = None,
    int8: bool = False,
    layers: Optional[int] = None,
    ckpt: Optional[str] = None,
    mesh: Any = None,
) -> Tuple[Any, transformer.Params]:
    """The model's config (depth cut to ``layers``) and its parameters in
    the compute dtype: restored from the latest step under ``ckpt``, else
    drawn from ``seed``; int8-quantized linears when ``int8`` (from a
    checkpoint, quantized from its f32 values). On an active ``mesh``,
    DTensors placed by the rule table (each rank reads or keeps its own
    shards, and quantizes them there)."""
    if int8 and model.startswith("mixtral"):
        raise ValueError(INT8_MOE)
    device = resolve_device(device)
    config = MODELS[model]()
    module = model_of(config)
    config = dataclasses.replace(config, n_layers=layers or config.n_layers)
    active = sharding.is_active(mesh)
    if active and sharding.axes_size("pp", mesh) > 1:
        raise NotImplementedError("serving runs unpipelined (pp 1), as the JAX package's "
                                  "generate.py does")
    axes = module.logical_axes(config)
    if ckpt:
        # Shapes from an init on the meta device: nothing is drawn.
        shapes = module.init(config, torch.Generator(), "meta")
        placements = None
        if active:
            placements = sharding.tree_shardings(sharding.param_mesh(mesh), axes)
        like = _empty(shapes, _restore_dtypes(shapes, config.dtype, int8), device, placements,
                      sharding.param_mesh(mesh) if active else None)
        params, step = checkpoint.TrainCheckpointer(ckpt).restore_params(like)
        print(f"restored checkpoint step {step} from {ckpt}", flush=True)
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        if active:
            params = module.init_distributed(config, mesh, gen, device)
        else:
            params = module.init(config, gen, device)
    if int8:
        # Rebinding frees the f32 linears once their int8 copies exist.
        params = quantize.quantize_params(params, axes if active else None)
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
    mesh: Any = None,
    ffn: Optional[Callable] = None,
    plain: bool = False,
) -> Dict[str, object]:
    """Generate ``new_tokens`` after ``prompt`` and time it: TTFT is the
    prefill plus the first sample, the decode rate counts the tokens after
    the first over the time after it. Host clock around device syncs. On an
    active ``mesh``, ``prompt`` is this rank's rows. ``ffn``: the MoE hook
    (:func:`decode_hook`). On a card, with an active mesh or without, the
    decode steps replay ``generate``'s captured graph (``plain``: the eager
    loop); a request whose shape is new captures it, and the decode time
    includes that capture, also given apart (``capture_ms``,
    ``captures``). On a gang every rank makes the same requests, so the
    ranks capture together."""
    device = prompt.device
    launches0 = attention.flash_attention.launches
    captures0, capture_s0 = generate.Decoder.captures, generate.Decoder.capture_s
    _sync(device)
    t0 = time.perf_counter()
    stream = generate.generate_stream(
        params, prompt, config, new_tokens, temperature, generator, top_p=top_p, mesh=mesh,
        ffn=ffn, plain=plain,
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
        "captures": generate.Decoder.captures - captures0,
        "capture_ms": (generate.Decoder.capture_s - capture_s0) * 1e3,
    }


def decode_hook(config: Any) -> Optional[Callable]:
    """``generate``'s ``ffn`` hook for a config: the routed MoE for
    Mixtral, None (the dense SwiGLU) otherwise."""
    return mixtral.decode_ffn(config) if isinstance(config, mixtral.MixtralConfig) else None


def mesh_layout(model: str, n: int) -> Any:
    """A gang's layout (``serve_llama.py``'s): ep over the experts for
    Mixtral, tp for the dense family, the rest fsdp."""
    if model.startswith("mixtral"):
        e = MODELS[model]().n_experts
        return infer_mesh_config(n, ep=e if n % e == 0 else (2 if n % 2 == 0 else 1))
    return infer_mesh_config(n, tp=4 if n % 4 == 0 else (2 if n % 2 == 0 else 1))


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
                        help="serve int8-quantized linears (models/quantize.py; the dense "
                             "family only)")
    parser.add_argument("--requests", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="default cuda; 'cpu' runs the plain versions")
    args = parser.parse_args(argv)
    if args.int8 and args.model.startswith("mixtral"):
        # Before any mesh, build or restore (a Mixtral restore is minutes of reading).
        raise SystemExit(INT8_MOE)

    lift_env_block()  # the card grant, before anything initialises CUDA
    device = resolve_device(args.device)
    bootstrap_distributed(device)
    n = world_size()
    mesh, batch, batch_rank = None, args.batch, 0
    if n > 1:
        layout = mesh_layout(args.model, n)
        mesh = make_mesh(layout, device)
        # serve_llama.py's snap: at least one row a (dp, fsdp) shard.
        per = layout.dp * layout.fsdp
        batch = max(args.batch // per, 1) * per
        if batch != args.batch:
            print(f"batch {args.batch} -> {batch} (multiple of dp*fsdp={per})", flush=True)
        batch_rank = sharding.batch_rank(mesh)
    config, params = build(args.model, args.seed, device, args.int8, args.layers, args.ckpt, mesh)
    if args.int8:
        print(f"serving int8-quantized linears, {'local ' if mesh else ''}shards sha256 "
              f"{quantize.shard_digest(params)}", flush=True)
    ffn = decode_hook(config)
    rng = np.random.default_rng(args.seed + 1)
    # One stream a batch shard: the ranks of a tp group sample alike.
    gen = torch.Generator(device=device).manual_seed(args.seed + 2 + batch_rank)
    results = []
    for r in range(args.requests):
        prompt = torch.from_numpy(
            synthetic_tokens(rng, batch, args.prompt_len, config.vocab_size))
        if mesh is not None:
            prompt = sharding.shard_batch(prompt, mesh)
        res = run_request(
            params, prompt.to(device), config, args.new_tokens, args.temperature,
            args.top_p, gen, mesh, ffn,
        )
        results.append(res)
        rate = res["decode_tok_s"]
        peak = (f", peak {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB"
                if device.type == "cuda" else "")
        print(
            f"request {r}: ttft {res['ttft_ms']:.1f} ms, decode "
            f"{'n/a' if rate is None else f'{rate:.1f}'} tok/s, "
            f"flash launches {res['flash_launches']}, decode graphs captured "
            f"{res['captures']} ({res['capture_ms']:.1f} ms), "
            f"first {'local ' if mesh else ''}ids "
            f"{res['tokens'][0, :4].tolist()}, first of each row "
            f"{res['tokens'][:, 0].tolist()}{peak}",
            flush=True,
        )
    return results


if __name__ == "__main__":
    main()
