"""The numbers that decide ``correct``: the program's readings against the
reference's, and each against its limit from ``limits/<workload>.json``."""

from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

# A leaf whose reference gradient is under this share of the median leaf's
# moves under Adam by round-off alone: its change is not compared.
STILL_LEAF = 1e-3


def _gaps(ref: Dict[str, float], leaves: List[str], gap) -> List[float]:
    """Each leaf's gap, over the larger of that leaf's reference norm and
    the median leaf's."""
    med = statistics.median(ref[n] for n in leaves)
    return [gap(n) / max(ref[n], med) for n in leaves]


def train_numbers(prog: Dict, ref: Dict, by_leaf: Dict = None) -> Dict[str, float]:
    """Training readings, each the worst over the checked steps or leaves.
    ``loss_gap``: the largest |loss - reference loss|. ``grad_gap``,
    ``replay_grad_gap`` and ``update_gap``: the gap between a leaf's norm
    and the reference's, of the first step's gradient, of the last checked
    step's (in the program a replay of the captured graph) and of the
    parameters' change after the checked steps. ``*_diff``: the norm of
    the difference of the same at each leaf's sampled elements; ``*_median``
    the median leaf's of these. Each is over the larger of the leaf's
    reference norm and the median leaf's; the change's only over the leaves
    the reference moves. ``by_leaf``, when given, receives each leaf's
    three sampled differences (first gradient, last gradient, change)."""
    by_leaf = {} if by_leaf is None else by_leaf
    g = ref["grads"]
    leaves = list(g["norms"])
    moved = [n for n in leaves if g["norms"][n] >= STILL_LEAF * statistics.median(
        g["norms"].values())]
    numbers = {"loss_gap": max(abs(a - b) for a, b in zip(prog["losses"], ref["losses"]))}
    diffs = {}
    for key, name, over in (("grads", "grad", leaves), ("replay_grads", "replay_grad", leaves),
                            ("changes", "update", moved)):
        p, r = prog[key], ref[key]
        sample_norms = {n: float(r["samples"][n].norm()) for n in over}
        diff = _gaps(sample_norms, over,
                     lambda n: float((p["samples"][n] - r["samples"][n]).norm()))
        diffs[name] = dict(zip(over, diff))
        numbers[f"{name}_gap"] = max(_gaps(r["norms"], over,
                                           lambda n: abs(p["norms"][n] - r["norms"][n])))
        numbers[f"{name}_diff"] = max(diff)
        numbers[f"{name}_diff_median"] = statistics.median(diff)
    by_leaf.update({n: [round(diffs[k].get(n, 0.0), 6) for k in diffs] for n in leaves})
    return numbers


def judge(numbers: Dict[str, float], limits: Dict[str, Dict]) -> Tuple[bool, Dict[str, Dict]]:
    """(every limited number within its limit, {name: {value, limit}});
    a limited number that the run did not read fails."""
    checks, ok = {}, True
    for name, entry in limits.items():
        value = numbers.get(name)
        good = value is not None and value == value and value <= entry["limit"]
        ok = ok and good
        checks[name] = {"value": value, "limit": entry["limit"]}
    return ok, checks
