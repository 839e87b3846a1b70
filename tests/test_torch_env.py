"""The port's device contract: one process per granted card.

``gpu/env.pod_gpu_env`` against the JAX package's ``pod_tpu_env`` on random
gangs (the pod order, ranks and rendezvous), ``gpu/topology.py`` against
``tpu/topology.py`` and the config compiler, the per-card block winning
over the JAX block in the boot, and the pod launcher
(``workloads/launch.py``): two pods of two "cards" boot a 4-rank gloo
``train.main`` whose losses equal a gang booted from JAX blocks, and a
launcher whose child fails ends the rest and exits with its code.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from hivedscheduler_tpu import common as jcommon
from hivedscheduler_tpu.algorithm import compiler
from hivedscheduler_tpu.api import types as api
from hivedscheduler_tpu.api.config import Config
from hivedscheduler_tpu.tpu import topology as jtopology
from hivedscheduler_tpu.tpu.env import pod_tpu_env
from hivedscheduler_tpu_torch.gpu import env as genv
from hivedscheduler_tpu_torch.gpu import topology
from hivedscheduler_tpu_torch.parallel import mesh
from hivedscheduler_tpu_torch.workloads import common, launch

from ._torch_entry_worker import OUT_DIR as ENTRY_OUT_DIR
from ._torch_entry_worker import parting_leaf
from ._torch_rendezvous import AGENT_STORE, gang_store
from .test_torch_workloads import gang

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def random_gang(seed: int):
    """A gang of 1-3 members on up to 16 eight-card nodes named h100-w<i>
    (so the natural sort matters), each pod 1-8 cards listed in a random
    order; returns the PodBindInfo of each pod, in the order made."""
    rng = np.random.default_rng(seed)
    n_nodes = int(rng.integers(1, 17))
    nodes = [f"h100-w{i}" for i in rng.permutation(16)[:n_nodes]]
    free = {n: list(rng.permutation(8)) for n in nodes}
    members = []
    for _ in range(int(rng.integers(1, 4))):
        cards = int(rng.choice([1, 2, 3, 4, 8]))
        pods = []
        for _ in range(int(rng.integers(1, 5))):
            fits = [n for n in nodes if len(free[n]) >= cards]
            if not fits:
                break
            node = fits[int(rng.integers(len(fits)))]
            taken, free[node] = free[node][:cards], free[node][cards:]
            pods.append(api.PodPlacementInfo(physical_node=node,
                                             physical_leaf_cell_indices=[int(c) for c in taken]))
        if pods:
            members.append(api.AffinityGroupMemberBindInfo(pod_placements=pods))
    return [api.PodBindInfo(node=p.physical_node, leaf_cell_isolation=list(p.physical_leaf_cell_indices),
                            cell_chain="h100-32", affinity_group_bind_info=members)
            for m in members for p in m.pod_placements]


@pytest.mark.parametrize("seed", range(24))
def test_pod_gpu_env_follows_the_jax_worker_order(seed):
    infos = random_gang(seed)
    jax_blocks = [pod_tpu_env(info) for info in infos]
    blocks = [genv.pod_gpu_env(info.to_dict()) for info in infos]
    world = sum(len(info.leaf_cell_isolation) for info in infos)
    host = jax_blocks[0]["JAX_COORDINATOR_ADDRESS"].rsplit(":", 1)[0]
    ranks = []
    for _, info, pod in sorted(zip((int(j["TPU_WORKER_ID"]) for j in jax_blocks), infos, blocks),
                               key=lambda t: t[0]):
        assert [b["CUDA_VISIBLE_DEVICES"] for b in pod] == [str(c) for c in info.leaf_cell_isolation]
        assert [b["LOCAL_RANK"] for b in pod] == [str(i) for i in range(len(pod))]
        for b in pod:
            assert b["WORLD_SIZE"] == str(world)
            assert (b["MASTER_ADDR"], b["MASTER_PORT"]) == (host, str(genv.MASTER_PORT))
        ranks += [int(b["RANK"]) for b in pod]
    # Pods in TPU_WORKER_ID order, each pod's cards in placement order:
    # contiguous, unique ranks 0 .. world - 1.
    assert ranks == list(range(world))


def test_natural_sort_puts_w2_before_w10():
    members = [{"podPlacements": [{"physicalNode": f"w{i}", "physicalLeafCellIndices": [0]}
                                  for i in (10, 2, 1)]}]
    ranks = {n: genv.pod_gpu_env({"node": n, "leafCellIsolation": [0],
                                  "affinityGroupBindInfo": members})[0]["RANK"]
             for n in ("w1", "w2", "w10")}
    assert ranks == {"w1": "0", "w2": "1", "w10": "2"}


def test_a_pod_missing_from_its_own_bind_info_raises():
    info = random_gang(0)[0].to_dict()
    info["leafCellIsolation"] = [99]
    with pytest.raises(ValueError, match="not found in its own affinity group"):
        genv.pod_gpu_env(info)


def test_h100_cell_types_equal_the_jax_presets():
    want = {k: v.to_dict() for k, v in jtopology.make_cell_types("h100", 8, (4,)).items()}
    assert topology.h100_cell_types() == want
    assert list(want) == ["h100-2-chip", "h100-4-chip", "h100-host", "h100-32"]
    for args in (("a100", 4, (2, 8)), ("x", 6, (3,)), ("x", 8, (), False)):
        assert topology.make_cell_types(*args) == {
            k: v.to_dict() for k, v in jtopology.make_cell_types(*args).items()}
    with pytest.raises(ValueError, match="must nest"):
        topology.make_cell_types("h100", 8, (4, 6))


def test_physical_cells_equal_the_jax_ones():
    nodes = [f"h100-w{i}" for i in range(8)]
    types = topology.make_cell_types("h100", 8, (4, 8))
    jtypes = jtopology.make_cell_types("h100", 8, (4, 8))
    for cell, names in (("h100-64", nodes), ("h100-32", nodes[:4]), ("h100-host", nodes[:1])):
        got = topology.make_physical_cell(cell, names, types, pinned_cell_id="pin")
        assert got == jtopology.make_physical_cell(cell, names, jtypes, "pin").to_dict()
    with pytest.raises(ValueError, match="contains 4 hosts but 3"):
        topology.make_physical_cell("h100-32", nodes[:3], types)


def test_h100_presets_compile_through_the_schedulers_config():
    types = topology.h100_cell_types()
    elements = compiler.build_cell_chains(
        {k: api.CellTypeSpec.from_dict(v) for k, v in types.items()})
    card, node, group = elements["h100-chip"], elements["h100-host"], elements["h100-32"]
    assert card.level == 1 and card.leaf_cell_number == 1 and not card.has_node
    assert node.leaf_cell_number == 8 and node.has_node and not node.is_multi_nodes
    # card(1) -> 2-card(2) -> 4-card(3) -> node(4) -> h100-32(5)
    assert group.level == 5 and group.leaf_cell_number == 32 and group.is_multi_nodes
    nodes = [f"h100-w{i}" for i in range(4)]
    cfg = Config.from_dict({
        "physicalCluster": {
            "cellTypes": types,
            "physicalCells": [topology.make_physical_cell("h100-32", nodes, types)]},
        "virtualClusters": {"vc1": {"virtualCells": [{"cellType": "h100-32", "cellNumber": 1}]}},
    })
    top = cfg.physical_cluster.physical_cells[0]
    assert [c.cell_address for c in top.cell_children] == [f"0/{n}" for n in nodes]


# ------------------------------------------------------------ the boot


def _clear(monkeypatch, *keys):
    for key in keys:  # set, then unset: the test's changes are undone after it
        monkeypatch.setenv(key, "")
        monkeypatch.delenv(key)


JAX_BLOCK = {"TPU_VISIBLE_CHIPS": "2,3", "JAX_PROCESS_ID": "1", "JAX_NUM_PROCESSES": "2",
             "JAX_COORDINATOR_ADDRESS": "pod-0:8476"}
CARD_BLOCK = {"CUDA_VISIBLE_DEVICES": "3", "RANK": "3", "LOCAL_RANK": "1", "WORLD_SIZE": "4",
              "MASTER_ADDR": "pod-0", "MASTER_PORT": "29500"}


@pytest.mark.parametrize("card_block", [True, False])
def test_the_per_card_block_wins_over_the_jax_block(monkeypatch, card_block):
    env = {**JAX_BLOCK, **(CARD_BLOCK if card_block else {})}
    seen = {}
    monkeypatch.setattr(mesh.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(mesh.dist, "init_process_group", lambda **kw: seen.update(kw))
    mesh.initialize_from_env(env, device="cpu")
    if card_block:
        assert seen == {"backend": "gloo", "init_method": "tcp://pod-0:29500",
                        "world_size": 4, "rank": 3}
    else:
        assert seen == {"backend": "gloo", "init_method": "tcp://pod-0:8476",
                        "world_size": 2, "rank": 1}
    assert mesh.process_rank(env) == (3 if card_block else 1)


@pytest.mark.parametrize("given", [None, "1"])
def test_nccl_env_turns_graph_registration_off_unless_set(monkeypatch, given):
    # Captured collectives take the eager path's buffers; a value the
    # environment gives is kept.
    if given is None:
        monkeypatch.delenv("NCCL_GRAPH_REGISTER", raising=False)
    else:
        monkeypatch.setenv("NCCL_GRAPH_REGISTER", given)
    mesh.nccl_env()
    assert os.environ["NCCL_GRAPH_REGISTER"] == (given or "0")


def test_bootstrap_returns_the_per_card_rank_and_keeps_its_card(monkeypatch):
    _clear(monkeypatch, *JAX_BLOCK, *CARD_BLOCK, common.ENV_BLOCK_VAR)
    for k, v in CARD_BLOCK.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv(common.ENV_BLOCK_VAR, jcommon.to_yaml_fast(JAX_BLOCK))
    monkeypatch.setattr(common, "initialize_from_env", lambda device=None: None)
    assert common.bootstrap_distributed("cpu") == 3
    # The pod's grant is lifted, but the launcher's one card survives it.
    assert os.environ["TPU_VISIBLE_CHIPS"] == "2,3"
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "3"


def test_child_envs_put_each_block_over_the_environment(monkeypatch, tmp_path):
    info = random_gang(3)[0]
    path = tmp_path / "bind.json"
    path.write_text(json.dumps(info.to_dict()))
    monkeypatch.setenv("SOME_VAR", "kept")
    envs = launch.child_envs(str(path), master_port=1234)
    assert len(envs) == len(info.leaf_cell_isolation)
    for env, block in zip(envs, genv.pod_gpu_env(info.to_dict(), 1234)):
        assert env["SOME_VAR"] == "kept" and block.items() <= env.items()
    assert launch.child_envs(None) == [dict(os.environ)]


# ------------------------------------------------------------ the launcher


def _two_pods():
    """Two pods of two cards on two nodes; worker 0's node is localhost."""
    members = [api.AffinityGroupMemberBindInfo(pod_placements=[
        api.PodPlacementInfo(physical_node=node, physical_leaf_cell_indices=cards)
        for node, cards in (("worker-b", [5, 4]), ("localhost", [0, 1]))])]
    return [api.PodBindInfo(node=p.physical_node, leaf_cell_isolation=p.physical_leaf_cell_indices,
                            affinity_group_bind_info=members) for p in members[0].pod_placements]


def _launcher(bind_info, module_argv, tmp_path, name, port, timeout=None, env_block=None,
              extra_env=None):
    """The pod's launcher for ``bind_info``, its gang's rendezvous at the
    test's store on ``port`` (``gang_store``): every rank joins it as a
    client (``AGENT_STORE``), while the launcher and the boot code run as
    they run under HiveD."""
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(bind_info.to_dict()))
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", *CARD_BLOCK)}
    env.update(AGENT_STORE, **(extra_env or {}))
    if env_block is not None:
        env[common.ENV_BLOCK_VAR] = jcommon.to_yaml_fast(env_block)
    cmd = [sys.executable, "-m", "hivedscheduler_tpu_torch.workloads.launch",
           "--bind-info", str(path), "--master-port", str(port)]
    if timeout is not None:
        cmd += ["--timeout", str(timeout)]
    return subprocess.Popen(cmd + ["--", *module_argv], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def launched_pods(mode, argv, tmp_path):
    """The entry worker's ``mode`` (``launched``, ``launched_pp``) with
    ``argv`` on the two pods of ``_two_pods`` as their launchers start it,
    one gang of four ranks on a store of its own; each rank's result."""
    out_dir = tmp_path / f"{mode}_out"
    out_dir.mkdir()
    with gang_store(4) as port:
        procs = [_launcher(info, ["tests._torch_entry_worker", mode, *argv], tmp_path,
                           f"pod{i}", port, timeout=240, env_block=pod_tpu_env(info),
                           extra_env={ENTRY_OUT_DIR: str(out_dir)})
                 for i, info in enumerate(_two_pods())]
        try:
            for p in procs:
                _, err = p.communicate(timeout=300)
                assert p.returncode == 0, err[-3000:]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    return [json.loads(f.read_text()) for f in sorted(out_dir.glob("rank*.json"))]


def test_two_launched_pods_train_like_a_gang_booted_from_jax_blocks(tmp_path):
    argv = ["--model", "tiny", "--seq", "64", "--steps", "2"]
    outs = launched_pods("launched", argv, tmp_path)
    ref = gang("train", 4, argv)
    assert sorted(o["rank"] for o in outs) == [0, 1, 2, 3]
    for o in outs:
        # The per-card block won over the pod's JAX block (2 processes).
        assert o["world"] == 4 and o["env"]["JAX_NUM_PROCESSES"] == "2"
        assert o["env"]["WORLD_SIZE"] == "4" and o["env"]["RANK"] == str(o["rank"])
        assert o["losses"] == ref[0]["losses"], (o["losses"], ref[0]["losses"],
                                                 parting_leaf(outs, ref))
    by_rank = {o["rank"]: o["env"]["CUDA_VISIBLE_DEVICES"] for o in outs}
    assert by_rank == {0: "0", 1: "1", 2: "5", 3: "4"}  # localhost is worker 0


@pytest.mark.parametrize("case", ["child_fails", "timeout"])
def test_the_launcher_never_waits_on_a_dead_rank(tmp_path, case):
    info = _two_pods()[1]
    # fail-or-hang: rank 1 exits 3, rank 0 sleeps; "timeout" has no rank 1
    # failing (its pod holds ranks 2 and 3), so both sleep past --timeout.
    pod = info if case == "child_fails" else _two_pods()[0]
    t0 = time.monotonic()
    with gang_store(4) as port:  # the ranks never meet
        p = _launcher(pod, ["tests._torch_entry_worker", "fail-or-hang"], tmp_path, case, port,
                      timeout=3 if case == "timeout" else 120)
        _, err = p.communicate(timeout=60)
    assert time.monotonic() - t0 < 60
    assert p.returncode == (3 if case == "child_fails" else launch.TIMEOUT_EXIT), err[-2000:]
