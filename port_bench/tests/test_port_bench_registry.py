"""BENCHMARK.json against the rules of its format (names, units, keys, sizes), and the harness's
registry: every item is found by its name in files of its own, so a cell,
a configuration, a mix or a metric is added by adding files."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from port_bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


def _line_ok(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert 1 <= len(SPEC["paths"]) <= 16 and len(SPEC["command"]) <= 32
    assert all(_line_ok(w) for w in SPEC["command"])
    assert (harness.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/") and not p.endswith("_torch")


def test_every_name_and_unit_is_of_the_allowed_characters():
    names = [c["name"] for c in SPEC["configs"]] + CELLS
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["config"] for w in SPEC["workloads"]] + [w["traffic"] for w in SPEC["workloads"]]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    units = [m["unit"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert all(UNIT.match(u) for u in units), units
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in SPEC[group]}) == len(SPEC[group])


def test_entries_have_just_their_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line_ok(c["why"]) and _line_ok(c["source"]) and len(c["reduced"]) <= 16
        assert (harness.ROOT / c["file"]).is_file() and c["file"].startswith("port_bench/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line_ok(w["why"])
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line_ok(m["layer"])


def test_pairs_are_unique_and_four_chips_are_rare():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(CELLS) // 4)
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    c = harness.find_cell(cell)
    e2e = {m["name"] for m in harness.end_to_end(c)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.per_layer(c)


@pytest.mark.parametrize("cell", CELLS)
def test_every_layer_metric_moves_a_metric_its_cell_reports(cell):
    c = harness.find_cell(cell)
    e2e = {m["name"] for m in harness.end_to_end(c)}
    for m in harness.per_layer(c):
        assert m["moves"] in e2e, (cell, m["name"])


def test_metrics_of_one_layer_name_it_alike():
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files_by_name(cell):
    c = harness.find_cell(cell)
    assert harness.driver(c).run and harness.reference(c).leaf_specs(c.config)
    assert harness.limits(c)
    for m in harness.per_layer(c):
        assert callable(harness.reader(m["name"]).read)


def test_a_new_config_mix_metric_and_cell_are_found_from_new_files(tmp_path):
    """A copy of the benchmark gains a configuration, a mix, a metric, a
    cell, its limits and a new family's counts as new files and entries
    only: the harness finds them all by name, and no file it had is
    edited."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (root / "port_bench").rglob("*") if p.is_file()}
    spec = json.loads(json.dumps(SPEC))
    cfg = json.loads((harness.ROOT / spec["configs"][0]["file"]).read_text())
    cfg["num_hidden_layers"] = 1
    (root / "port_bench/configs/mixtral-l1.json").write_text(json.dumps(cfg))
    (root / "port_bench/traffic/train-2x512.json").write_text(json.dumps(
        {"driver": "train", "rows": 2, "seq": 512, "checked_steps": 3, "traced_steps": 1}))
    (root / "port_bench/counts/newfam.py").write_text(
        "def train_flops_per_token(cfg, seq):\n    return 7.0 * seq\n")
    (root / "port_bench/metrics/new_share.py").write_text(
        "def read(m):\n    return 42.0\n")
    (root / "port_bench/limits/mixtral-l1-train.json").write_text(
        json.dumps({"limits": {"loss_gap": {"limit": 1.0}}}))
    spec["configs"].append({"name": "mixtral-l1", "source": "https://example.org/x",
                            "file": "port_bench/configs/mixtral-l1.json", "reduced": [],
                            "why": "one layer"})
    spec["workloads"].append({"name": "mixtral-l1-train", "config": "mixtral-l1",
                              "traffic": "train-2x512", "chips": 1, "why": "a new cell"})
    spec["end_to_end"][0]["workloads"].append("mixtral-l1-train")
    spec["per_layer"].append({"name": "new_share", "unit": "%", "better": "higher",
                              "source": "device_trace", "layer": "device",
                              "moves": "train_tokens_per_s", "workloads": ["mixtral-l1-train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("from pathlib import Path\n"
            "from port_bench import harness\n"
            "root = Path('.').resolve()\n"
            "c = harness.find_cell('mixtral-l1-train', root=root)\n"
            "assert c.config['num_hidden_layers'] == 1 and c.traffic['seq'] == 512\n"
            "assert harness.driver(c).__name__ == 'port_bench.drivers.train'\n"
            "assert harness.reference(c).__name__ == 'port_bench.reference.mixtral'\n"
            "assert harness.limits(c) == {'loss_gap': {'limit': 1.0}}\n"
            "names = [m['name'] for m in harness.per_layer(c)]\n"
            "assert 'new_share' in names, names\n"
            "assert harness.reader('new_share').read(None) == 42.0\n"
            "from port_bench.counts import model\n"
            "assert model.train_flops_per_token({'family': 'newfam'}, 3) == 21.0\n"
            "print('found')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True)
    assert out.returncode == 0 and "found" in out.stdout, out.stderr
    after = {p: p.read_bytes() for p in (root / "port_bench").rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[p] == b for p, b in before.items())
