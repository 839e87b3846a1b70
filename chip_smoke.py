#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``hivedscheduler_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py [--seed N] [--profile]

Phases, in order, one result line each; any failed check raises and the
script exits non-zero:

1. device  - needs CUDA; the card's name and power limit from nvidia-smi.
2. build   - compiles every kernel under hivedscheduler_tpu_torch/ops/csrc.
3. kernels - each kernel's wrapper against its plain PyTorch version on the
             card, at the main path's shapes and a few edge cases (ragged
             tile, non-causal, f32), with the tolerances below; times the
             kernel, the plain version and the library call that computes
             the same function (a yardstick only: the port never calls it).
4. serve   - full-width, 32-layer Llama-3-8B in bf16 with random weights
             from --seed: requests of batch 4 x prompt 2048 x 32 greedy new
             tokens through the serving entry point. Launch counts are set
             to 0 just before and read just after; every prefill layer must
             launch the flash kernel. Against the uncached ``forward()``
             over prompt + generated tokens, the first new token must be
             its argmax in >= 3 of 4 rows, and every generated token's logit
             must be within MAX_LOGIT_GAP of its position's best. Then a
             short int8 request, whose launches must count.

The lines before the last are nvidia-smi's name and power limit, then one
JSON object with each kernel's numbers; the last line is
``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

# Peaks of one H100 SXM (NVIDIA data sheet, dense): the bound of a kernel is
# the larger of its bytes over the memory rate and its operations over the
# peak rate of their type.
H100_BYTES_PER_S = 3.35e12
H100_BF16_FLOPS = 989e12
H100_F32_FLOPS = 67e12  # outside the tensor cores

# Kernel vs plain version. bf16: both take f32 scores and an f32 softmax;
# they differ by the summation order of QK^T and PV and by __expf, which can
# move an unnormalised probability across a bf16 rounding boundary (one bf16
# ulp is 2^-8 relative) and the output by about one bf16 ulp of |O| <= 1.
TOL_BF16 = {"o_max": 2e-2, "o_mean": 2e-3, "lse_max": 1e-3}
# f32: the same arithmetic in f32 throughout; only the order of sums and
# __expf's ~2 ulp differ.
TOL_F32 = {"o_max": 1e-4, "o_mean": 1e-5, "lse_max": 1e-4}

# Generated token vs forward()'s best logit at its position, on bf16 logits
# of magnitude < 16: 0.25 is four bf16 ulps there, the noise of two bf16
# paths through 32 layers (measured: at most 0.0625 at the 7% of decoded
# positions where the two argmaxes differ), while random weights put a
# random token's logit some 5 below the best.
MAX_LOGIT_GAP = 0.25

SERVE = {"batch": 4, "prompt": 2048, "new_tokens": 32, "requests": 2}
INT8 = {"batch": 1, "prompt": 512, "new_tokens": 4}


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` back-to-back calls,
    by CUDA events after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flash_bound_ms(b, s, h, hkv, d, causal, dtype) -> tuple:
    """Least time for the flash forward on this card: QK^T and PV over the
    (q, k) pairs the mask keeps, against q/k/v read once and o/lse written
    once."""
    import torch

    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 2 * 2 * d * pairs * b * h
    elt = torch.finfo(dtype).bits // 8
    nbytes = elt * d * b * s * (2 * h + 2 * hkv) + 4 * b * h * s
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_kernels(seed: int) -> dict:
    """Flash forward kernel vs its plain version; returns the numbers of the
    main-path case for the kernels line."""
    import torch
    import torch.nn.functional as F

    from hivedscheduler_tpu_torch.ops import attention as A

    # (name, B, S, H, Hkv, D, causal, dtype, timed)
    cases = [
        ("main_path", 4, 2048, 32, 8, 128, True, torch.bfloat16, True),
        ("b2_causal", 2, 2048, 32, 8, 128, True, torch.bfloat16, False),
        ("b2_full", 2, 2048, 32, 8, 128, False, torch.bfloat16, True),
        ("ragged_causal", 2, 1000, 32, 8, 128, True, torch.bfloat16, False),
        ("ragged_full", 2, 1000, 32, 8, 128, False, torch.bfloat16, False),
        ("f32_ragged_causal", 2, 1000, 32, 8, 128, True, torch.float32, False),
        ("f32_full_d64", 1, 512, 8, 2, 64, False, torch.float32, False),
        ("bf16_causal_d32", 1, 300, 4, 2, 32, True, torch.bfloat16, False),
    ]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    main = None
    for name, b, s, h, hkv, d, causal, dtype, timed in cases:
        q = torch.randn(b, s, h, d, device="cuda", dtype=dtype, generator=gen)
        k = torch.randn(b, s, hkv, d, device="cuda", dtype=dtype, generator=gen)
        v = torch.randn(b, s, hkv, d, device="cuda", dtype=dtype, generator=gen)
        out, lse = A.flash_attention(q, k, v, causal)
        torch.cuda.synchronize()
        ref_out, ref_lse = A.flash_attention_reference(q, k, v, causal)
        d_o = (out.float() - ref_out.float()).abs()
        d_lse = (lse - ref_lse).abs().max().item()
        tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_F32
        fields = {
            "case": name, "shape": [b, s, h, hkv, d], "causal": causal,
            "dtype": str(dtype).replace("torch.", ""),
            "o_max_abs_err": d_o.max().item(), "o_mean_abs_err": d_o.mean().item(),
            "lse_max_abs_err": d_lse, "tol": tol,
        }
        if not (torch.isfinite(out).all() and torch.isfinite(lse).all()):
            raise AssertionError(f"{name}: non-finite kernel output")
        if (fields["o_max_abs_err"] > tol["o_max"] or fields["o_mean_abs_err"] > tol["o_mean"]
                or d_lse > tol["lse_max"]):
            raise AssertionError(f"kernel disagrees with its plain version: {fields}")
        if timed:
            fields["kernel_ms"] = cuda_ms(lambda: A.flash_attention(q, k, v, causal), 20)
            fields["plain_ms"] = cuda_ms(
                lambda: A.flash_attention_reference(q, k, v, causal), 3, warmup=1
            )
            # Library yardstick: SDPA on [B, H, S, D] with K/V already
            # repeated to H heads (prepared outside the timed region).
            qt = q.transpose(1, 2).contiguous()
            kt = k.repeat_interleave(h // hkv, dim=2).transpose(1, 2).contiguous()
            vt = v.repeat_interleave(h // hkv, dim=2).transpose(1, 2).contiguous()
            fields["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal), 20
            )
            fields["bound_ms"], fields["bound_by"] = flash_bound_ms(
                b, s, h, hkv, d, causal, dtype
            )
            fields["kernel_tflops"] = (
                4 * d * (s * (s + 1) // 2 if causal else s * s) * b * h
                / (fields["kernel_ms"] * 1e-3) / 1e12
            )
            del qt, kt, vt
        log("kernels", **fields)
        if name == "main_path":
            main = fields
        del q, k, v, out, lse, ref_out, ref_lse, d_o
        torch.cuda.empty_cache()
    return main


def phase_serve(seed: int, profile: bool, model: str = "llama3_8b",
                device: str = "cuda") -> dict:
    import numpy as np
    import torch

    from hivedscheduler_tpu_torch import serve
    from hivedscheduler_tpu_torch.models import quantize, transformer
    from hivedscheduler_tpu_torch.ops import attention as A

    device = torch.device(device)
    t0 = time.perf_counter()
    config, params = serve.build(model, seed, device)
    torch.cuda.synchronize()
    log("serve", step="init", model=model, n_layers=config.n_layers,
        d_model=config.d_model, seconds=time.perf_counter() - t0,
        weights_gib=torch.cuda.memory_allocated() / 2**30)

    rng = np.random.default_rng(seed + 1)

    def prompt(batch, length):
        return torch.from_numpy(
            serve.synthetic_tokens(rng, batch, length, config.vocab_size)
        ).to(device)

    # Warm-up: cuBLAS handles, the kernel library's first load.
    serve.run_request(params, prompt(1, 256), config, 2)

    prompts = [prompt(SERVE["batch"], SERVE["prompt"]) for _ in range(SERVE["requests"])]
    torch.cuda.reset_peak_memory_stats()
    A.flash_attention.launches = 0
    results = [serve.run_request(params, p, config, SERVE["new_tokens"]) for p in prompts]
    launches = A.flash_attention.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if launches != config.n_layers * SERVE["requests"]:
        raise AssertionError(
            f"flash kernel launched {launches} times for {SERVE['requests']} "
            f"prefills of {config.n_layers} layers"
        )
    for r, res in enumerate(results):
        toks = res["tokens"]
        if toks.shape != (SERVE["batch"], SERVE["new_tokens"]):
            raise AssertionError(f"request {r}: tokens of shape {tuple(toks.shape)}")
        if not ((toks >= 0) & (toks < config.vocab_size)).all():
            raise AssertionError(f"request {r}: token ids out of range")
        log("serve", step="request", request=r, **SERVE,
            ttft_ms=res["ttft_ms"], decode_tok_s=res["decode_tok_s"],
            flash_launches=res["flash_launches"])

    # The uncached forward() over the prompt and the generated tokens, teacher
    # forced: its argmax at the prompt's last position must be the first new
    # token, and at each later position the next one (this holds the KV-cache
    # decode path against the flash path). bf16 near-ties may flip a few, so
    # each generated token's forward() logit must lie within MAX_LOGIT_GAP of
    # that row's best; a wrong cache position, mask or RoPE offset picks
    # tokens whose logit lies about as far below the best as a random one's.
    toks = results[-1]["tokens"]
    full = torch.cat([prompts[-1], toks[:, :-1]], dim=1)
    logits = transformer.forward(params, full, config)[:, SERVE["prompt"] - 1:]
    if not torch.isfinite(logits).all():
        raise AssertionError("forward() logits are not finite")
    pred = logits.argmax(-1)
    top2 = logits.topk(2, dim=-1).values
    gap = top2[..., 0] - logits.gather(-1, toks[..., None])[..., 0]  # 0 where agreed
    del logits
    agree = int((pred[:, 0] == toks[:, 0]).sum())
    decode_agree = (pred[:, 1:] == toks[:, 1:]).float().mean().item()
    if agree < 3:
        raise AssertionError(f"first token agrees with forward() argmax in {agree}/4 rows")
    if gap.max().item() > MAX_LOGIT_GAP:
        raise AssertionError(
            f"a generated token's forward() logit lies {gap.max().item()} below the best"
        )
    log("serve", step="check", first_token_agrees_rows=agree,
        decode_tokens_agree=decode_agree, max_logit_gap=gap.max().item(),
        median_top2_margin=(top2[..., 0] - top2[..., 1]).median().item(),
        peak_memory_gib=peak_gib)

    if profile:
        profile_request(params, prompts[-1], config, results[-1])

    qparams = quantize.quantize_params(params)
    del params
    torch.cuda.empty_cache()
    A.flash_attention.launches = 0
    res = serve.run_request(qparams, prompt(INT8["batch"], INT8["prompt"]), config,
                            INT8["new_tokens"])
    int8_launches = A.flash_attention.launches
    if int8_launches != config.n_layers:
        raise AssertionError(f"int8 request launched the flash kernel {int8_launches} times")
    if not ((res["tokens"] >= 0) & (res["tokens"] < config.vocab_size)).all():
        raise AssertionError("int8 request: token ids out of range")
    log("serve", step="int8", **INT8, ttft_ms=res["ttft_ms"],
        decode_tok_s=res["decode_tok_s"], flash_launches=int8_launches)
    return {"launches": launches, "results": results}


def profile_request(params, prompt, config, unprofiled: dict) -> None:
    """Device time by kernel over one request, prefill and decode apart
    (torch.profiler, kernel events only). The idle share is taken against
    the same request's wall time without the profiler (``unprofiled``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hivedscheduler_tpu_torch.models import generate

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    stream = generate.generate_stream(params, prompt, config, SERVE["new_tokens"])
    with profile(activities=activities) as prefill:
        next(stream)
        torch.cuda.synchronize()
    with profile(activities=activities) as decode:
        for _ in stream:
            pass
        torch.cuda.synchronize()
    walls = {
        "prefill": unprofiled["ttft_ms"],
        "decode": 1e3 * prompt.shape[0] * (SERVE["new_tokens"] - 1) / unprofiled["decode_tok_s"],
    }
    for name, prof in (("prefill", prefill), ("decode", decode)):
        rows = sorted(
            ((ev.self_device_time_total, ev.key, ev.count) for ev in prof.key_averages()
             if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0),
            reverse=True,
        )
        busy_ms = sum(r[0] for r in rows) / 1e3
        log("profile", window=name, wall_ms_unprofiled=walls[name],
            device_busy_ms=busy_ms, idle_share=1 - busy_ms / walls[name],
            kernel_launches=sum(r[2] for r in rows),
            top=[{"kernel": k[:90], "ms": us / 1e3, "calls": n} for us, k, n in rows[:10]])


def main() -> int:
    parser = argparse.ArgumentParser(description="smoke run of the port on one card")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", action="store_true",
                        help="also print device time by kernel over one request")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    log("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    from hivedscheduler_tpu_torch.ops import _build

    log("build", seconds=_build.build_all(), sources=[s.name for s in _build.sources()])
    k = phase_kernels(args.seed)
    s = phase_serve(args.seed, args.profile)

    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "hivedscheduler_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "hivedscheduler_tpu/ops/attention.py:133",
        "launches": s["launches"],
        "max_abs_err": k["o_max_abs_err"],
        "ms": k["kernel_ms"],
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"],
        "library_ms": k["library_ms"],
    }]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
