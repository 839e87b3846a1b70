"""The port stands alone: hivedscheduler_tpu_torch imports neither jax nor
hivedscheduler_tpu, and its entry points never drift onto the CPU."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import hivedscheduler_tpu_torch as port
from hivedscheduler_tpu_torch import serve
from hivedscheduler_tpu_torch import train as train_entry
from hivedscheduler_tpu_torch.models import generate, train, transformer

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "hivedscheduler_tpu_torch"
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|hivedscheduler_tpu)(\.|\s|$)", re.MULTILINE
)


def submodules():
    return ["hivedscheduler_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages([str(PKG)], "hivedscheduler_tpu_torch.")
    ]


def test_import_pulls_in_no_jax():
    mods = submodules()
    assert "hivedscheduler_tpu_torch.ops.attention" in mods
    assert "hivedscheduler_tpu_torch.serve" in mods
    assert "hivedscheduler_tpu_torch.train" in mods
    assert "hivedscheduler_tpu_torch.models.train" in mods
    assert "hivedscheduler_tpu_torch.models.perf" in mods
    for name in ("parallel.mesh", "parallel.sharding", "utils.data", "workloads.common",
                 "models.checkpoint", "tools.mfu_sweep", "tools.dryrun", "models.mixtral",
                 "workloads.train_mixtral", "models.resnet", "workloads.train_resnet",
                 "workloads.train_mnist"):
        assert f"hivedscheduler_tpu_torch.{name}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'hivedscheduler_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    + sorted((ROOT / "tests").glob("_torch_*worker.py")),
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_sources_import_no_jax(path):
    assert not FORBIDDEN.search(path.read_text()), path


def test_resolve_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.resolve_device("cuda")
    assert port.resolve_device("cpu") == torch.device("cpu")


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.build("tiny", seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer.init(transformer.tiny(), torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        generate.init_cache(transformer.tiny(), 1, 8)


def test_training_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_entry.main(["--model", "tiny", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_entry.build("tiny", seed=0)
    config = transformer.tiny()
    params = transformer.init(config, torch.Generator(), device="cpu")
    opt = train.make_optimizer(params)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.train_step(params, opt, torch.zeros(1, 8, dtype=torch.long), config)


def test_job_entry_points_default_to_cuda(monkeypatch, tmp_path):
    from hivedscheduler_tpu_torch.models import perf
    from hivedscheduler_tpu_torch.parallel import mesh
    from hivedscheduler_tpu_torch.tools import mfu_sweep
    from hivedscheduler_tpu_torch.workloads import train_mixtral

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (serve.main, perf.main, mfu_sweep.main, train_mixtral.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_entry.main(["--data", str(tmp_path / "tokens.bin")])
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.single_device_mesh()
