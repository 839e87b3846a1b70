"""Shared workload bootstrap: lift the scheduler's pod env block (delivered
in the ``HIVED_TPU_ENV`` env var) into the process env and start
``torch.distributed`` from it.

Counterpart of ``example/workloads/common.py``. The block is the flat
``KEY: value`` map that the scheduler writes at bind time (its
``to_yaml_fast`` emitter): each value bare or JSON-quoted. It is parsed
here, without PyYAML, which the port does not need.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from .. import Device
from ..parallel.mesh import apply_chip_grant, initialize_from_env, process_rank

ENV_BLOCK_VAR = "HIVED_TPU_ENV"


def parse_env_block(text: str) -> Dict[str, str]:
    """The scheduler's flat ``KEY: value`` block as a dict of strings:
    a JSON-quoted value is unquoted, a bare one taken as written. Blank
    lines and ``#`` comments are skipped; anything nested raises."""
    env = {}
    for line in text.splitlines():
        if not line.strip() or line.lstrip().startswith("#"):
            continue
        key, sep, value = line.partition(":")
        value = value.strip()
        if not sep or line[0].isspace() or not key.strip() or not value:
            raise ValueError(f"{ENV_BLOCK_VAR}: not a flat 'KEY: value' line: {line!r}")
        env[key.strip()] = json.loads(value) if value.startswith('"') else value
    return env


def lift_env_block() -> None:
    """Lift ``HIVED_TPU_ENV`` into ``os.environ`` (a variable already set
    wins) and map the pod's card grant into ``CUDA_VISIBLE_DEVICES``
    (``parallel.mesh.apply_chip_grant``). Touches no CUDA API, so an entry
    point calls it before it resolves its device."""
    for key, value in parse_env_block(os.environ.get(ENV_BLOCK_VAR, "")).items():
        os.environ.setdefault(key, str(value))
    apply_chip_grant()


def bootstrap_distributed(device: Device = None) -> int:
    """``lift_env_block``, then start the process group from the
    environment (a no-op for one process); returns this worker's rank: the
    per-card block's ``RANK`` where the launcher set one, else the JAX
    block's ``JAX_PROCESS_ID`` (0 for a single-process job)."""
    lift_env_block()
    initialize_from_env(device=device)
    return process_rank()


def synthetic_tokens(
    rng: np.random.Generator, batch: int, seq: int, vocab: int
) -> np.ndarray:
    """Uniform random token ids [batch, seq], int64."""
    return rng.integers(0, vocab, size=(batch, seq), dtype=np.int64)
