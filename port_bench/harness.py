"""The harness: a cell of ``BENCHMARK.json`` found by name, with its
configuration, traffic mix, driver, family, reference, per-layer metric
readers and limits, each found by the name the file gives; the run's
context and outcome; the result line."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Whole top-level module names that no run may load (the JAX package, JAX).
FORBIDDEN = ("jax", "jaxlib", "flax", "hivedscheduler_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    spec: Dict[str, Any]  # BENCHMARK.json
    workload: Dict[str, Any]
    config: Dict[str, Any]  # configs/<config>.json
    traffic: Dict[str, Any]  # traffic/<mix>.json

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def load_spec(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def find_cell(name: str, spec: Optional[Dict[str, Any]] = None, root: Path = ROOT) -> Cell:
    spec = load_spec(root) if spec is None else spec
    workloads = {w["name"]: w for w in spec["workloads"]}
    if name not in workloads:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has {sorted(workloads)}")
    w = workloads[name]
    configs = {c["name"]: c for c in spec["configs"]}
    return Cell(name, spec, w, _json(root / configs[w["config"]]["file"]),
                _json(HERE / "traffic" / f"{w['traffic']}.json"))


def _module(kind: str, name: str) -> ModuleType:
    return importlib.import_module(f"port_bench.{kind}.{name}")


def driver(cell: Cell) -> ModuleType:
    return _module("drivers", cell.traffic["driver"])


def family(cell: Cell) -> ModuleType:
    """The port's side of the cell's model family (imports the port)."""
    return _module("families", cell.config["family"])


def reference(cell: Cell) -> ModuleType:
    return _module("reference", cell.config["family"])


def limits(cell: Cell) -> Dict[str, Dict]:
    """The cell's compared numbers and their limits."""
    return _json(HERE / "limits" / f"{cell.name}.json")["limits"]


def _reports(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end(cell: Cell) -> List[Dict[str, Any]]:
    """The end-to-end metrics this cell reports."""
    return [m for m in cell.spec["end_to_end"] if _reports(m, cell.name)]


def per_layer(cell: Cell) -> List[Dict[str, Any]]:
    """The per-layer metrics this cell reports: those that list it, or that
    list no cells and move an end-to-end metric the cell reports."""
    reported = {m["name"] for m in end_to_end(cell)}
    return [m for m in cell.spec["per_layer"]
            if (cell.name in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def reader(metric: str) -> ModuleType:
    """``metrics/<metric>.py``, loaded by its path (a name may hold dots)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Run:
    """What a driver is given: the cell, the seed, the window, whether to
    trace, the device, when the process started, and ``variant``: "" for
    the program; "fp8" (the control) or "half_batch" (a fault) for the
    reference put in its place."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float
    variant: str = ""

    @property
    def family(self) -> ModuleType:
        return family(self.cell)

    @property
    def reference(self) -> ModuleType:
        return reference(self.cell)


@dataclasses.dataclass
class Measures:
    """What the per-layer readers read: the trace's summary, the port's
    launch counts over the traced region, the least times of those
    launches by kind, and the window's figures."""

    kind: str
    trace: Any = None
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    bounds: Dict[str, float] = dataclasses.field(default_factory=dict)
    window: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    numbers: Dict[str, float]
    memory_peak_bytes: int
    measures: Measures
    notes: Dict[str, Any] = dataclasses.field(default_factory=dict)


def result_line(cell: Cell, trace: bool, outcome: Outcome, device: Dict[str, Any],
                checks: Dict[str, Dict], correct: bool) -> Tuple[Dict[str, Any], List[str]]:
    """The result's JSON object (its compared numbers last) and the names
    of the metrics the run could not read."""
    wanted = per_layer(cell) if trace else end_to_end(cell)
    metrics, missing = {}, []
    for m in wanted:
        if trace:
            value = reader(m["name"]).read(outcome.measures)
        else:
            value = outcome.end_to_end.get(m["name"])
        if value is None:
            missing.append(m["name"])
        else:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line: Dict[str, Any] = {"correct": correct, "attempted": outcome.attempted,
                            "failed": outcome.failed, "metrics": metrics, "device": device}
    if trace and outcome.measures.trace is not None:
        line["breakdown"] = {"device_ops": outcome.measures.trace.top_ops(),
                             "idle_gaps": outcome.measures.trace.idle_gaps()}
    line["checks"] = checks
    return line, missing
