"""Tiny cells for the CPU tests: the benchmark's own configurations and
mixes with every size cut down, run on the CPU through the same drivers."""

from __future__ import annotations

import copy
import time
from typing import Any, Dict

import torch

from port_bench import harness

TINY = {
    "mixtral-8x7b-l2": {"hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
                        "num_key_value_heads": 2, "num_local_experts": 4, "vocab_size": 512,
                        "torch_dtype": "float32"},
    "bert-large": {"hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
                   "num_hidden_layers": 2, "vocab_size": 512, "max_position_embeddings": 64,
                   "torch_dtype": "float32"},
}
TINY_TRAFFIC = {
    "train-4x4096": {"rows": 4, "seq": 32},
    "mlm-64x512": {"rows": 8, "seq": 32},
}


def cell(name: str) -> harness.Cell:
    """The named cell of BENCHMARK.json at test size."""
    c = harness.find_cell(name)
    config = copy.deepcopy(c.config)
    config.update(TINY[c.workload["config"]])
    traffic = copy.deepcopy(c.traffic)
    traffic.update(TINY_TRAFFIC[c.workload["traffic"]])
    return harness.Cell(c.name, c.spec, c.workload, config, traffic)


def run(name: str, seed: int = 3, seconds: float = 0.0, trace: bool = False,
        variant: str = "", c: Any = None) -> harness.Outcome:
    torch.manual_seed(0)
    c = cell(name) if c is None else c
    r = harness.Run(c, seed, seconds, trace, torch.device("cpu"), time.perf_counter(), variant)
    return harness.driver(c).run(r)


def judged(name: str, outcome: harness.Outcome, c: Any = None) -> Dict[str, Any]:
    from port_bench import compare

    c = cell(name) if c is None else c
    ok, checks = compare.judge(outcome.numbers, harness.limits(c))
    return {"correct": ok and outcome.failed == 0, "checks": checks}
