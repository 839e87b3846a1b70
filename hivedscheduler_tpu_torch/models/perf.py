"""Single-card model-performance harness: tokens/s and MFU of the training
step, flash vs plain attention, long-context steps and the decode sweep.

Counterpart of ``hivedscheduler_tpu/models/perf.py``. It runs a Llama-style
model's whole training step (forward, backward, AdamW) on one card and
reports tokens/s and model-FLOPs utilisation against the card's dense bf16
peak (each step replayed from the CUDA graph its first warm-up step
captured, ``train.captured_step``; ``capture_ms`` is that capture's time),
then a flash-vs-plain attention fwd+bwd at 8k tokens; optional
stages (``HIVED_PERF_LONGCTX=1``, ``HIVED_PERF_DECODE=1``) add train-step
rows at 16k and 32k tokens and a decode-throughput sweep, and
``HIVED_PERF_ZOO=1`` times the model zoo's steps on the card (BERT-large,
ResNet-50 and the bench model's decode, ``bench_zoo``). Run as::

    python -m hivedscheduler_tpu_torch.models.perf [--device cpu]

It prints one JSON object. A card run that passes the guards is persisted
to ``example/logs/perf_last_measured_torch*.json`` (``HIVED_PERF_ARTIFACT``
overrides the path). Nothing falls back: a kernel that fails raises and the
run exits non-zero; the optional stages record a failing row as an
``error`` row (the zoo, a whole stage, as an ``error`` dict).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import time
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..ops import attention as att
from . import generate, quantize, train, transformer

# Peaks of one H100 SXM (NVIDIA data sheet, dense), at its full 700 W power
# limit: bf16 on the tensor cores, f32 outside them, and the memory rate.
H100_BF16_FLOPS = 989e12
H100_F32_FLOPS = 67e12
H100_BYTES_PER_S = 3.35e12

# Dense bf16 FLOP/s by CUDA device name (``torch.cuda.get_device_name``),
# first matching substring wins (NVIDIA data sheets, without sparsity).
PEAK_BF16 = [
    ("h100 pcie", 756e12),
    ("h100", H100_BF16_FLOPS),
]


def peak_flops(device_name: str) -> Optional[float]:
    name = device_name.lower()
    for sub, peak in PEAK_BF16:
        if sub in name:
            return peak
    return None


def mfu_fields(flops_per_token: float, tokens_per_sec: float,
               device_name: str) -> dict:
    """MFU against the card's peak, with the plausibility guard: an MFU
    outside (0, 1] means the timing did not wait for the device, and is
    published as ``mfu_rejected``, never as ``mfu``. Shared by ``main`` and
    ``tools/mfu_sweep.py``."""
    peak = peak_flops(device_name)
    if peak is None:
        return {}
    fields: dict = {"peak_bf16_flops": peak}
    mfu = flops_per_token * tokens_per_sec / peak
    if 0.0 < mfu <= 1.0:
        fields["mfu"] = round(mfu, 4)
    else:
        fields["mfu"] = None
        fields["mfu_rejected"] = round(mfu, 4)
        fields["mfu_rejected_reason"] = (
            "MFU outside (0, 1] — timing sync not trustworthy"
        )
    return fields


# Model presets (HIVED_PERF_MODEL): the JAX package's two bench shapes,
# head_dim 128 both, 8 KV heads.
MODEL_PRESETS = {
    "268m": dict(d_model=1024, n_layers=12, n_heads=8, n_kv_heads=8,
                 d_ff=4096, default_batch=2),
    "800m": dict(d_model=2048, n_layers=12, n_heads=16, n_kv_heads=8,
                 d_ff=6912, default_batch=1),
}


def bench_config(on_gpu: bool, batch: Optional[int] = None,
                 seq: Optional[int] = None
                 ) -> Tuple[transformer.TransformerConfig, int, int]:
    """(config, batch, seq) of the bench. On the card: the
    ``HIVED_PERF_MODEL`` preset (default "268m"), bf16, remat
    ``HIVED_PERF_REMAT`` (default "flash"), batch ``HIVED_PERF_BATCH`` and
    seq ``HIVED_PERF_SEQ`` (8192), explicit arguments first. Off the card a
    miniature shape that ignores every override."""
    if on_gpu:
        preset = MODEL_PRESETS[os.environ.get("HIVED_PERF_MODEL", "268m")]
        if batch is None:
            batch = int(os.environ.get("HIVED_PERF_BATCH", str(preset["default_batch"])))
        if seq is None:
            seq = int(os.environ.get("HIVED_PERF_SEQ", "8192"))
        return transformer.TransformerConfig(
            vocab_size=32768,
            d_model=preset["d_model"],
            n_layers=preset["n_layers"],
            n_heads=preset["n_heads"],
            n_kv_heads=preset["n_kv_heads"],
            d_ff=preset["d_ff"],
            max_seq_len=seq,
            dtype=torch.bfloat16,
            remat=True,
            remat_policy=os.environ.get("HIVED_PERF_REMAT", "flash"),
        ), batch, seq
    return transformer.TransformerConfig(
        vocab_size=2048,
        d_model=256,
        n_layers=2,
        n_heads=2,
        n_kv_heads=2,
        d_ff=1024,
        max_seq_len=512,
        dtype=torch.float32,
        remat=False,
    ), 2, 512


def n_params(params: transformer.Params) -> int:
    return sum(t.numel() for t in transformer.leaves(params))


def flops_per_token(config: transformer.TransformerConfig, n_param: int, seq: int) -> float:
    """6*N for the matmuls (forward + backward) + the causal attention term
    6 * L * S * d_model (PaLM-style accounting, halved for causality)."""
    return 6.0 * n_param + 6.0 * config.n_layers * seq * config.d_model


def _device(on_gpu: bool) -> torch.device:
    return resolve_device(None if on_gpu else "cpu")


def host_sync(out: Any) -> float:
    """Wait for the device (``torch.cuda.synchronize`` on CUDA), then fetch
    a scalar of ``out``'s first tensor to the host: the timed window ends
    after the last kernel that made it."""
    leaf = out
    while not isinstance(leaf, torch.Tensor):
        leaf = next(iter(leaf.values())) if isinstance(leaf, dict) else leaf[0]
    if leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)
    return float(leaf.detach().float().sum())


def time_steps(fn, args, n_steps: int) -> float:
    """Seconds per call of ``fn(*args)``, after the caller has warmed it
    up; synced by ``host_sync`` on the last output."""
    t0 = time.perf_counter()
    out = None
    for _ in range(n_steps):
        out = fn(*args)
    host_sync(out)
    return (time.perf_counter() - t0) / n_steps


def _launches_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in att.kernel_launches().items()}


def bench_train_step(on_gpu: bool, batch: Optional[int] = None,
                     seq: Optional[int] = None) -> dict:
    """The bench model's training step: f32 master weights from seed 0,
    tokens from seed 1, two warm-up steps (the first captures the step's
    graph on the card), then the mean of 8 timed steps (3 off the card),
    each a replay. ``launches`` counts each kernel over the timed steps;
    ``capture_ms`` is the capture's time (0 off the card)."""
    config, batch, seq = bench_config(on_gpu, batch=batch, seq=seq)
    device = _device(on_gpu)
    gen = torch.Generator(device=device).manual_seed(0)
    params = transformer.init(config, gen, device, dtype=torch.float32)
    n_param = n_params(params)
    optimizer = train.make_optimizer(params)
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, config.vocab_size, size=(batch, seq))
    ).to(device)

    def step():
        return train.captured_step(params, optimizer, tokens, config, device)

    capture_s = train.StepGraphs.capture_s
    step()
    warm_loss = host_sync(step())
    capture_s = train.StepGraphs.capture_s - capture_s
    n_steps = 8 if on_gpu else 3
    before = att.kernel_launches()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        loss = step()
    final_loss = host_sync(loss)
    dt = (time.perf_counter() - t0) / n_steps

    out = {
        "model_params_m": round(n_param / 1e6, 1),
        "batch": batch,
        "seq": seq,
        "step_time_ms": round(dt * 1e3, 2),
        "tokens_per_sec_per_chip": round(batch * seq / dt, 1),
        "flops_per_token": flops_per_token(config, n_param, seq),
        "loss": round(final_loss, 4) if math.isfinite(final_loss) else None,
        "launches": _launches_since(before),
        "capture_ms": round(capture_s * 1e3, 1),
    }
    if not math.isfinite(final_loss):
        # Keep the JSON strict (no bare NaN) and show the divergence.
        out["loss_nonfinite"] = repr(final_loss)
        out["warmup_loss"] = round(warm_loss, 4) if math.isfinite(warm_loss) else None
    return out


def bench_attention(on_gpu: bool) -> dict:
    """Causal attention fwd+bwd at 8k tokens: the flash kernels (``mha``)
    against the plain version (``mha_reference``), on the same inputs."""
    b, s, h, d = (2, 8192, 8, 128) if on_gpu else (1, 512, 2, 64)
    dtype = torch.bfloat16 if on_gpu else torch.float32
    device = _device(on_gpu)
    gen = torch.Generator(device=device).manual_seed(2)
    q, k, v = (torch.randn(b, s, h, d, generator=gen, device=device, dtype=dtype)
               .requires_grad_() for _ in range(3))

    def grads_of(fn):
        return lambda: torch.autograd.grad(fn(q, k, v, causal=True).float().sum(), (q, k, v))

    out = {"attention_shape": [b, s, h, d]}
    n = 3 if on_gpu else 2
    plain = grads_of(att.mha_reference)
    host_sync(plain())  # warm-up
    out["plain_fwd_bwd_ms"] = round(time_steps(plain, (), n) * 1e3, 2)
    flash = grads_of(att.mha)
    host_sync(flash())
    before = att.kernel_launches()
    out["flash_fwd_bwd_ms"] = round(time_steps(flash, (), n) * 1e3, 2)
    out["attention_launches"] = _launches_since(before)
    out["flash_speedup"] = round(out["plain_fwd_bwd_ms"] / out["flash_fwd_bwd_ms"], 2)
    return out


def _env_int_csv(name: str, default: str) -> Iterator[Tuple[Optional[int], Optional[dict]]]:
    """A comma-separated integer env knob: ``(value, None)`` per parseable
    entry and ``(None, error_row)`` per garbage entry, so an optional sweep
    reports a bad entry as a row instead of crashing a run that already
    paid for the headline numbers."""
    for tok in os.environ.get(name, default).split(","):
        if not tok.strip():
            continue
        try:
            yield int(tok), None
        except ValueError:
            yield None, {"error": f"unparseable entry {tok!r} in {name}"}


def _flagship_params(config: transformer.TransformerConfig,
                     device: torch.device) -> transformer.Params:
    """The bench model's serving weights (seed 5, compute dtype), shared by
    the serving-side stages."""
    gen = torch.Generator(device=device).manual_seed(5)
    return transformer.init(config, gen, device)


def _error_row(exc: Exception, **fields) -> dict:
    return {**fields, "error": f"{type(exc).__name__}: {exc}"[:300]}


def bench_long_context(on_gpu: bool) -> List[dict]:
    """Optional (``HIVED_PERF_LONGCTX=1``): train-step rows at batch 1 and
    16k and 32k tokens (``HIVED_PERF_LONGCTX_SEQS`` overrides), through
    ``bench_train_step``, each with its guarded MFU. A failing row becomes
    an error row."""
    kind = torch.cuda.get_device_name(0) if on_gpu else "cpu"
    rows = []
    for seq, bad in _env_int_csv("HIVED_PERF_LONGCTX_SEQS", "16384,32768"):
        if bad is not None:
            rows.append(bad)
            continue
        try:
            row = bench_train_step(on_gpu, batch=1, seq=seq)
            fields = mfu_fields(row["flops_per_token"], row["tokens_per_sec_per_chip"], kind)
            row.update(fields)
            if fields.get("mfu") is not None:
                # flops/token is kept only where MFU could not be computed.
                row.pop("flops_per_token", None)
        except Exception as exc:  # optional stage: one error row
            row = _error_row(exc, seq=seq)
        rows.append(row)
    return rows


def bench_decode_sweep(on_gpu: bool) -> List[dict]:
    """Optional (``HIVED_PERF_DECODE=1``): decode throughput against batch
    (``HIVED_PERF_DECODE_BATCHES``, default 8, 32, 64), an int8 row at the
    largest batch and a prefill row at 2 x 8192 tokens (the flash forward).

    Each decode row times ``generate.generate_greedy_scan`` at two
    generation lengths and reports the marginal cost a token,
    ``(t_long - t_short) / (n_long - n_short)``: the prefill and set-up are
    the same in both and cancel. Each length is timed twice after a warm-up
    and the faster run kept. On the card the decode steps replay a captured
    graph; each length's warm-up captures it, and ``capture_ms`` is the
    row's capture time, outside the timed runs."""
    config, _, _ = bench_config(on_gpu)
    device = _device(on_gpu)
    params = _flagship_params(config, device)
    prompt_len = 128 if on_gpu else 16
    n_short, n_long = (16, 80) if on_gpu else (2, 6)
    rng = np.random.default_rng(6)

    def marginal_row(p, batch, extra=None):
        try:
            prompt = torch.from_numpy(
                rng.integers(0, config.vocab_size, size=(batch, prompt_len))).to(device)
            best = {}
            capture_s = generate.Decoder.capture_s
            for n_new in (n_short, n_long):
                host_sync(generate.generate_greedy_scan(p, prompt, config, n_new))
                for _ in range(2):
                    t0 = time.perf_counter()
                    host_sync(generate.generate_greedy_scan(p, prompt, config, n_new))
                    dt = time.perf_counter() - t0
                    best[n_new] = min(best.get(n_new, dt), dt)
            marginal = (best[n_long] - best[n_short]) / (n_long - n_short)
            if marginal <= 0:
                return {"batch": batch, "error": "non-positive marginal step time "
                        "(host timing jitter)", **(extra or {})}
            return {
                "batch": batch,
                "decode_ms_per_token": round(marginal * 1e3, 3),
                "tokens_per_sec": round(batch / marginal, 1),
                "capture_ms": round((generate.Decoder.capture_s - capture_s) * 1e3, 1),
                **(extra or {}),
            }
        except Exception as exc:  # optional stage: one error row
            return _error_row(exc, batch=batch, **(extra or {}))

    rows, batches = [], []
    for batch, bad in _env_int_csv("HIVED_PERF_DECODE_BATCHES", "8,32,64"):
        if bad is not None:
            rows.append(bad)
            continue
        batches.append(batch)
        rows.append(marginal_row(params, batch))
    if batches:
        # Int8 weights at the largest batch: the weight-read half of the
        # decode roofline against the bf16 row above.
        rows.append(marginal_row(quantize.quantize_params(params), max(batches),
                                 extra={"int8": True}))

    # Time to fill the cache from a long prompt: the prefill runs its causal
    # self-attention through the flash forward (generate._block_cached).
    pbatch, plen = (2, 8192) if on_gpu else (2, 64)
    try:
        prompt = torch.from_numpy(
            np.random.default_rng(7).integers(0, config.vocab_size, size=(pbatch, plen))
        ).to(device)
        best = None
        for i in range(4):  # a warm-up, then the best of three
            cache = generate.init_cache(config, pbatch, plen + 64, device=device)
            host_sync(cache.k)
            t0 = time.perf_counter()
            logits, _ = generate.prefill(params, prompt, cache, config)
            host_sync(logits)
            dt = time.perf_counter() - t0
            if i:
                best = dt if best is None else min(best, dt)
        rows.append({
            "batch": pbatch,
            "prefill_len": plen,
            "prefill_ms": round(best * 1e3, 1),
            "prefill_tokens_per_sec": round(pbatch * plen / best, 1),
        })
    except Exception as exc:  # optional stage: one error row
        rows.append(_error_row(exc, prefill_len=plen))
    return rows


def bench_zoo(on_gpu: bool) -> dict:
    """Optional (``HIVED_PERF_ZOO=1``): one-card step timings of the other
    model families, the JAX package's ``bench_zoo`` at its sizes. On the
    card: BERT-large's training step at 8 x 512 with ``optax.adamw(1e-4)``'s
    AdamW, ResNet-50's at 64 x 224^2 in bf16 with SGD(0.1, momentum 0.9),
    and the bench model's decode at batch 8 after a 128-token prompt, 32 new
    tokens (``decode_step`` in a loop, then ``generate_greedy_scan``); off
    it, BERT tiny at 2 x 64, ResNet-50 at 2 x 32^2 and decode at batch 2
    after 16 tokens, 8 new. Each training stage takes one warm-up step, then
    the mean of n timed steps (4 on the card, 2 off it).

    The BERT step keeps the JAX package's quirk: it passes the boolean mask
    as ``mlm_loss``'s targets, whose ``targets >= 0`` then holds everywhere,
    so every position is scored against token 0 or 1 (not the MLM
    objective). The port passes ``mask.long()``, the same function at the
    same cost. ``launches`` counts each kernel by stage over its warm-up and
    timed calls (the BERT step runs all three; the 128-token prefill is
    shorter than the flash dispatch's 256 and runs the plain attention, in
    both packages). The BERT and ResNet steps are their twins'
    ``captured_step``: the warm-up captures, the timed calls replay."""
    from ..workloads import train_bert, train_resnet
    from . import bert, resnet

    device = _device(on_gpu)
    n = 4 if on_gpu else 2
    out: dict = {"launches": {}}

    def timed(name, step):
        before = att.kernel_launches()
        host_sync(step())  # warm-up
        dt = time_steps(step, (), n)
        out["launches"][name] = _launches_since(before)
        return dt

    bconfig = bert.bert_large() if on_gpu else bert.tiny()
    bbatch, bseq = (8, 512) if on_gpu else (2, 64)
    bparams = bert.init(bconfig, torch.Generator(device=device).manual_seed(0), device)
    bopt = train_bert.make_optimizer(bparams)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, bconfig.vocab_size, size=(bbatch, bseq))).to(device)
    mask = torch.from_numpy(np.random.default_rng(2).random((bbatch, bseq)) < 0.15).to(device)
    targets = mask.long()
    bdt = timed("bert", lambda: train_bert.captured_step(bparams, bopt, tokens, targets,
                                                         bconfig))
    out["bert_large_step_ms"] = round(bdt * 1e3, 2)
    out["bert_tokens_per_sec"] = round(bbatch * bseq / bdt, 1)
    del bparams, bopt

    rconfig = resnet.ResNetConfig()
    rbatch, rsize = (64, 224) if on_gpu else (2, 32)
    rparams, rstats = resnet.init(rconfig, torch.Generator(device=device).manual_seed(0), device)
    ropt = train_resnet.make_optimizer(rparams)
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.standard_normal((rbatch, rsize, rsize, 3), dtype=np.float32)
                              ).to(device, torch.bfloat16)
    labels = torch.from_numpy(np.random.default_rng(4).integers(
        0, rconfig.num_classes, rbatch)).to(device)
    state = {"stats": rstats}

    def resnet_step():
        loss, state["stats"] = train_resnet.captured_step(rparams, state["stats"], ropt,
                                                          images, labels, rconfig)
        return loss

    rdt = timed("resnet", resnet_step)
    out["resnet50_step_ms"] = round(rdt * 1e3, 2)
    out["resnet50_images_per_sec"] = round(rbatch / rdt, 1)
    del rparams, ropt, state
    if on_gpu:
        torch.cuda.empty_cache()

    gconfig, _, _ = bench_config(on_gpu)
    gparams = _flagship_params(gconfig, device)
    gbatch, prompt_len, new_tokens = (8, 128, 32) if on_gpu else (2, 16, 8)
    prompt = torch.from_numpy(np.random.default_rng(6).integers(
        0, gconfig.vocab_size, size=(gbatch, prompt_len))).to(device)
    before = att.kernel_launches()
    with torch.inference_mode():
        # On the card decode_step replays the captured step of the owner
        # that made its cache.
        cache = generate.decoder(gparams, gconfig).init_cache(gbatch,
                                                              prompt_len + new_tokens + 1)
        logits, cache = generate.prefill(gparams, prompt, cache, gconfig)
        token = logits.argmax(-1)
        # Warm decode_step (its capture), then time the steady-state loop on
        # the same token.
        capture_s = generate.Decoder.capture_s
        host_sync(generate.decode_step(gparams, token, cache, gconfig)[0])
        t0 = time.perf_counter()
        for _ in range(new_tokens):
            logits, cache = generate.decode_step(gparams, token, cache, gconfig)
        host_sync(logits)
        gdt = (time.perf_counter() - t0) / new_tokens
    out["decode_step_ms"] = round(gdt * 1e3, 2)
    out["decode_tokens_per_sec"] = round(gbatch / gdt, 1)

    # Prefill and every step in one call, as the JAX package's one program
    # (its warm-up captures the step at this shape).
    host_sync(generate.generate_greedy_scan(gparams, prompt, gconfig, new_tokens))
    if on_gpu:
        out["decode_capture_ms"] = round((generate.Decoder.capture_s - capture_s) * 1e3, 2)
    t0 = time.perf_counter()
    host_sync(generate.generate_greedy_scan(gparams, prompt, gconfig, new_tokens))
    sdt = (time.perf_counter() - t0) / new_tokens
    out["decode_scan_step_ms"] = round(sdt * 1e3, 2)
    out["decode_scan_tokens_per_sec"] = round(gbatch / sdt, 1)
    out["launches"]["decode"] = _launches_since(before)
    return out


def artifact_path(model: Optional[str] = None) -> str:
    """Where a successful card run is persisted: ``example/logs/``, beside
    the JAX package's artifacts and never over them
    (``perf_last_measured_torch.json`` for the "268m" preset,
    ``perf_last_measured_torch_<model>.json`` for another).

    ``model=None`` names the current run's artifact: the
    ``HIVED_PERF_MODEL`` preset, with ``HIVED_PERF_ARTIFACT`` overriding
    the whole path. An explicit ``model`` names that preset's default
    artifact, which the override does not redirect."""
    override = os.environ.get("HIVED_PERF_ARTIFACT") if model is None else None
    if override:
        return override
    if model is None:
        model = os.environ.get("HIVED_PERF_MODEL", "268m")
    name = (
        "perf_last_measured_torch.json" if model == "268m"
        else f"perf_last_measured_torch_{model}.json"
    )
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "example", "logs", name)


# The optional stages that persist_result carries forward across runs.
CARRY_STAGES = ("long_context", "zoo", "decode_sweep")


def carried_provenance(record: dict, stage: str) -> dict:
    """The origin provenance of ``stage``'s rows in a persisted artifact:
    the ``carried_forward`` marker's entry when it names the stage (a
    legacy list marker names no provenance), else the artifact's own."""
    marker = record.get("carried_forward")
    if isinstance(marker, dict) and stage in marker:
        return marker[stage]
    return record.get("provenance", {})


def stage_rows_clean(val):
    """An optional stage's value without its bad rows: a list keeps only
    rows with neither ``error`` nor ``mfu_rejected`` (None when none
    survive); a whole-stage error dict is None; anything else is clean."""
    if isinstance(val, list):
        clean = [r for r in val
                 if "error" not in r and "mfu_rejected" not in r]
        return clean or None
    if isinstance(val, dict) and "error" in val:
        return None
    return val


def attach_carried(dst: dict, src: dict, stage: str) -> None:
    """Copy ``src``'s rows for ``stage`` into ``dst`` and mark them as
    carried, with their origin's provenance (a legacy list marker on
    ``dst`` is replaced by the dict form)."""
    dst[stage] = src[stage]
    cf = dst.get("carried_forward")
    marker = dict(cf) if isinstance(cf, dict) else {}
    marker[stage] = carried_provenance(src, stage)
    dst["carried_forward"] = marker


def _git_commit() -> Optional[str]:
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True, timeout=10,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        ).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def persist_result(result: dict, on_gpu: bool) -> None:
    """Persist a successful card run atomically. A CPU run, a run without a
    training number and a run whose MFU was rejected persist nothing. The
    optional stages are cleaned row by row: a stage left with no clean row
    keeps the previous artifact's rows, marked with their origin's
    provenance. Failing to write does not fail the run."""
    if not on_gpu or "tokens_per_sec_per_chip" not in result or "mfu_rejected" in result:
        return
    path = artifact_path()
    try:
        with open(path) as f:
            prev = json.load(f)
    except (OSError, json.JSONDecodeError):
        prev = {}
    record = {
        **result,
        "provenance": {
            "measured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "git_commit": _git_commit(),
            "recorded_by": "hivedscheduler_tpu_torch.models.perf",
            "env_overrides": {
                k: v for k, v in os.environ.items() if k.startswith("HIVED_PERF_")
            },
        },
    }
    for stage in CARRY_STAGES:
        if stage in record:
            clean = stage_rows_clean(record[stage])
            if clean is None:
                record.pop(stage)
            else:
                record[stage] = clean
        if stage not in record and stage in prev:
            attach_carried(record, prev, stage)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(record, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
    except OSError:
        pass


def card_info() -> Optional[str]:
    """The card's name and power limit as nvidia-smi prints them, or None
    where nvidia-smi cannot say."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else None


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the harness, persist a clean card run, print the result as one
    JSON object and return it."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None,
                        help="default cuda; 'cpu' runs the miniature shapes on the plain versions")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    on_gpu = device.type == "cuda"
    kind = torch.cuda.get_device_name(0) if on_gpu else "cpu"
    result: dict = {"backend": device.type, "device_kind": kind}
    if on_gpu:
        result.update(device_count=torch.cuda.device_count(), card=card_info())
    result.update(bench_train_step(on_gpu))
    result.update(mfu_fields(result["flops_per_token"], result["tokens_per_sec_per_chip"], kind))
    result.update(bench_attention(on_gpu))
    if os.environ.get("HIVED_PERF_LONGCTX", "0") == "1":
        result["long_context"] = bench_long_context(on_gpu)
    if os.environ.get("HIVED_PERF_ZOO", "0") == "1":
        try:
            result["zoo"] = bench_zoo(on_gpu)
        except Exception as exc:  # optional stage: degrade to an error dict
            result["zoo"] = _error_row(exc)
    if os.environ.get("HIVED_PERF_DECODE", "0") == "1":
        result["decode_sweep"] = bench_decode_sweep(on_gpu)
    persist_result(result, on_gpu)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
