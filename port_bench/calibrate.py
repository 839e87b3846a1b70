#!/usr/bin/env python3
"""The readings a cell's limits are set from: the program's compared
numbers on many seeds, and the control's and the faults' on a few, each a
run of the cell's driver in one process (the benchmark's own runs run
none of this).

    python3 port_bench/calibrate.py --workload NAME --seeds 1,2,3 \\
        [--variant fp8|half_batch] [--seconds 0] [--out FILE]

Without ``--variant`` each seed runs the program as ``run.py`` does (a
window of ``--seconds``, default none); ``fp8`` puts the reference computed
in float8 (every operand of every product) in the program's place, and
``half_batch`` the f32 reference that leaves half of each batch out. Each
run's numbers go to standard output as one JSON line, and to ``--out``."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--variant", default="", choices=("", "fp8", "half_batch"))
    parser.add_argument("--seconds", type=float, default=0.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    import torch

    from port_bench import compare, harness

    cell = harness.find_cell(args.workload)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.cuda.init()
    limits = harness.limits(cell)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(device)
        r = harness.Run(cell, seed, args.seconds, False, device, t0, args.variant)
        outcome = harness.driver(cell).run(r)
        correct, _ = compare.judge(outcome.numbers, limits)
        row = {"workload": cell.name, "variant": args.variant or "program", "seed": seed,
               "numbers": outcome.numbers, "correct_under_limits": correct,
               "end_to_end": outcome.end_to_end, "seconds": time.perf_counter() - t0,
               "peak_bytes": outcome.memory_peak_bytes, "notes": outcome.notes}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
