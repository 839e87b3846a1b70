"""The port's meshes and env bootstrap (hivedscheduler_tpu_torch.parallel.mesh)
against the JAX package: the same mesh layouts, and the scheduler's
bind-time env block booting a real two-process ``torch.distributed`` gang
(gloo) the way it boots ``jax.distributed`` in tests/test_env_multiproc.py.
"""

import itertools
import logging
import os

import numpy as np
import pytest
import torch.distributed as dist
import yaml

from hivedscheduler_tpu import common
from hivedscheduler_tpu.api import constants
from hivedscheduler_tpu.parallel import mesh as JM
from hivedscheduler_tpu_torch.parallel import mesh as TM
from hivedscheduler_tpu_torch.utils import data as TD
from hivedscheduler_tpu_torch.workloads.common import parse_env_block

from ._multiproc import run_workers
from ._torch_rendezvous import gang_store
from .test_core import Sim, make_pod

common.init_logging(logging.ERROR)

GANG_SIZE = 2


def _layout(fn, *args, **kwargs):
    """A MeshConfig's axis sizes, or the ValueError's text."""
    try:
        return fn(*args, **kwargs).axis_sizes
    except ValueError as e:
        return f"ValueError: {e}"


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8, 16])
def test_infer_mesh_config_matches_jax(n):
    assert TM.MESH_AXES == JM.MESH_AXES
    for tp, sp, ep, pp, fsdp in itertools.product(
        (1, 2, 4), (1, 2), (1, 2), (1, 2), (None, 1, 2, 4)
    ):
        kw = dict(tp=tp, sp=sp, ep=ep, pp=pp, fsdp=fsdp)
        ref = _layout(JM.infer_mesh_config, n, **kw)
        assert _layout(TM.infer_mesh_config, n, **kw) == ref, kw


def test_mesh_config_matches_jax():
    for sizes in [(1,) * 6, (2, 1, 4, 1, 2, 1), (1, 2, 2, 2, 1, 2)]:
        t, j = TM.MeshConfig(*sizes), JM.MeshConfig(*sizes)
        assert t.axis_sizes == j.axis_sizes and t.total() == j.total()


def test_one_process_mesh_needs_no_process_group(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    TM.initialize_from_env({}, device="cpu")  # no block: one process
    TM.initialize_from_env({"JAX_NUM_PROCESSES": "1"}, device="cpu")
    mesh = TM.single_device_mesh("cpu")
    assert not dist.is_initialized()
    assert mesh.mesh_dim_names == TM.MESH_AXES
    assert tuple(mesh.shape) == (1,) * 6
    assert list(mesh.get_coordinate()) == [0] * 6
    with pytest.raises(ValueError, match="needs 2 processes, got 1"):
        TM.make_mesh(TM.MeshConfig(fsdp=2), "cpu")


def test_gang_env_blocks_boot_a_two_process_gloo_group(tmp_path):
    sim = Sim()
    gang = {"name": "torch-gang", "members": [{"podNumber": GANG_SIZE, "leafCellNumber": 4}]}
    bound = [
        sim.schedule_and_bind(
            make_pod(f"tg-{i}", f"tgu{i}", "VC1", 0, "v5e-chip", 4, group=gang)
        )
        for i in range(GANG_SIZE)
    ]
    blocks = [bp.annotations[constants.ANNOTATION_POD_TPU_ENV] for bp in bound]
    envs = [yaml.safe_load(b) for b in blocks]
    # The port's parser reads the scheduler's block as PyYAML does.
    for block, env in zip(blocks, envs):
        assert parse_env_block(block) == {k: str(v) for k, v in env.items()}
    assert len({e["JAX_COORDINATOR_ADDRESS"] for e in envs}) == 1

    path = tmp_path / "tokens.bin"
    np.random.default_rng(3).integers(0, 500, size=2048, dtype=np.uint16).tofile(path)
    worker = os.path.join(os.path.dirname(__file__), "_torch_env_worker.py")
    with gang_store(GANG_SIZE) as port:
        outs = run_workers(worker, [[b, str(port), str(path)] for b in blocks], timeout=120)

    assert sorted(o["rank"] for o in outs) == sorted(int(e["JAX_PROCESS_ID"]) for e in envs)
    assert sorted(o["rank"] for o in outs) == list(range(GANG_SIZE))
    assert all(o["world"] == GANG_SIZE and o["sum"] == 3 for o in outs)
    assert all(o["mesh_shape"] == [1, 1, GANG_SIZE, 1, 1, 1] for o in outs)
    # Each rank holds its own fsdp coordinate and its own half of each
    # batch; stacked in rank order they are the whole batch, row for row.
    by_rank = sorted(outs, key=lambda o: o["rank"])
    assert [o["coordinate"][2] for o in by_rank] == list(range(GANG_SIZE))
    whole = list(TD.TokenFileDataset(str(path), seq_len=16).batches(4, seed=7, epochs=1))
    assert len(whole) > 0 and all(len(o["blocks"]) == len(whole) for o in outs)
    for i, batch in enumerate(whole):
        stacked = np.concatenate([np.asarray(o["blocks"][i]) for o in by_rank])
        np.testing.assert_array_equal(stacked, batch)
