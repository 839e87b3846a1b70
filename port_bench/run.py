#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 port_bench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout. The run makes its weights and inputs from
``--seed`` on the card, warms up the cell's shapes (counted in
``setup_s``), measures for ``--seconds``, with ``--trace 1`` profiles a
traced region after the window, then compares what the timed path produced
with the plain reference. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each compared number
beside its limit); the last lines of standard error give the checks too.
It exits non-zero and prints no result where the cell's cards are missing,
where anything fails, or where the process has loaded JAX or the JAX
package."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Caches at fixed paths inside the checkout, so that only a checkout's first
# run builds; the port's own kernels build into its ops/_kernels_build/.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / ".bench_cache" / sub)
os.environ["USE_FLAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def forbidden_modules():
    from port_bench.harness import FORBIDDEN

    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from port_bench import compare, harness

    cell = harness.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has {have}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run = harness.Run(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    outcome = harness.driver(cell).run(run)
    correct, checks = compare.judge(outcome.numbers, harness.limits(cell))
    correct = correct and outcome.failed == 0
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
            "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    if args.trace:
        info["busy_s"] = outcome.measures.trace.busy_s()
        info["window_s"] = outcome.measures.trace.window_s()
        if info["busy_s"] <= 0:
            raise RuntimeError("the trace shows no operation on the device")
    line, missing = harness.result_line(cell, bool(args.trace), outcome, info, checks, correct)
    if not args.trace and missing:
        raise RuntimeError(f"end-to-end metrics not read: {missing}")
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: no result", file=sys.stderr)
        return 3
    print(json.dumps({"notes": outcome.notes, "numbers": outcome.numbers,
                      "per_layer_not_read": missing}), file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {correct}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
