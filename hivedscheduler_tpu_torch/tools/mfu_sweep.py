"""MFU sweep on the card: batch size x remat policy of the perf harness's
training step.

Counterpart of ``hack/mfu_sweep.py``. Runs ``models/perf.bench_train_step``
under each setting of ``CONFIGS`` (``HIVED_PERF_BATCH``,
``HIVED_PERF_REMAT``) and prints one JSON line each, with the guarded MFU
of ``models/perf.mfu_fields``; a setting that fails prints an error row.
Use it to pick the bench shape after a kernel change::

    python -m hivedscheduler_tpu_torch.tools.mfu_sweep [--device cpu]

The JAX sweep's block-size rows have no counterpart: the port's kernels
have fixed tiles and no ``HIVED_FLASH_BLOCK_*`` knobs. Off the card the
harness runs its miniature shape, which ignores the settings.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional, Sequence

import torch

from .. import resolve_device
from ..models import perf

CONFIGS = [
    {"HIVED_PERF_BATCH": "2", "HIVED_PERF_REMAT": "flash"},  # the harness's default
    {"HIVED_PERF_BATCH": "2", "HIVED_PERF_REMAT": "full"},
    {"HIVED_PERF_BATCH": "2", "HIVED_PERF_REMAT": "dots+flash"},
    {"HIVED_PERF_BATCH": "4", "HIVED_PERF_REMAT": "flash"},
    {"HIVED_PERF_BATCH": "8", "HIVED_PERF_REMAT": "flash"},
]


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None,
                        help="default cuda; 'cpu' runs the harness's miniature shape")
    args = parser.parse_args(argv)
    on_gpu = resolve_device(args.device).type == "cuda"
    kind = torch.cuda.get_device_name(0) if on_gpu else "cpu"
    rows = []
    for cfg in CONFIGS:
        saved = {k: os.environ.get(k) for k in cfg}
        os.environ.update(cfg)
        try:
            r = perf.bench_train_step(on_gpu)
            r["config"] = cfg
            r.update(perf.mfu_fields(r["flops_per_token"], r["tokens_per_sec_per_chip"], kind))
        except Exception as exc:  # one setting's failure is its row
            r = {"config": cfg, "error": f"{type(exc).__name__}: {exc}"[:300]}
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        print(json.dumps(r), flush=True)
        rows.append(r)
    return rows


if __name__ == "__main__":
    main()
