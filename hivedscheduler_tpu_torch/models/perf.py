"""Model FLOP accounting for the training step, and the H100's peaks.

The part of ``hivedscheduler_tpu/models/perf.py`` that the single-card
training entry needs; the benchmark stages and their guards are a later
slice of the port.
"""

from __future__ import annotations

from . import transformer

# Peaks of one H100 SXM (NVIDIA data sheet, dense), at its full 700 W power
# limit: bf16 on the tensor cores, f32 outside them, and the memory rate.
H100_BF16_FLOPS = 989e12
H100_F32_FLOPS = 67e12
H100_BYTES_PER_S = 3.35e12


def n_params(params: transformer.Params) -> int:
    return sum(t.numel() for t in transformer.leaves(params))


def flops_per_token(config: transformer.TransformerConfig, n_param: int, seq: int) -> float:
    """6*N for the matmuls (forward + backward) + the causal attention term
    6 * L * S * d_model (PaLM-style accounting, halved for causality)."""
    return 6.0 * n_param + 6.0 * config.n_layers * seq * config.d_model
