"""The rendezvous of the port's test gangs (``tests/_torch_rendezvous.py``):
one TCP store a gang, held by the test process on a port the OS gives it,
every rank a client. A port chosen by binding port 0 and closing the socket
could be taken by any process on the host before the gang's rank 0 bound it
again (gloo's ``connectFullMesh`` closed by a peer, ``EADDRINUSE``). And
every rank's CPU set-up, ``cpu_rank``: one thread, deterministic sums."""

import glob
import json
import os
import socket
import subprocess
import sys

import pytest

from ._multiproc import run_workers
from ._torch_rendezvous import AGENT_STORE, HOST, gang_store

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_rendezvous.py")
GANG_WORKERS = sorted(glob.glob(os.path.join(ROOT, "tests", "_torch_*_worker.py")))


def _bindable(port: int) -> bool:
    with socket.socket() as s:
        try:
            s.bind((HOST, port))
        except OSError:
            return False
        return True


def test_a_four_process_gloo_gang_meets_on_the_test_store():
    with gang_store(4) as port:
        outs = run_workers(WORKER, [[str(r), "4", str(port)] for r in range(4)], timeout=120)
    assert [o["rank"] for o in outs] == [0, 1, 2, 3]
    assert all(o["world"] == 4 and o["sum"] == 1 + 2 + 3 + 4 for o in outs)


def test_two_open_stores_hold_two_ports_each_bound_until_it_closes():
    with gang_store(4) as first:
        with gang_store(4) as second:
            assert first != second
            assert not _bindable(first) and not _bindable(second)
        assert not _bindable(first)
    # The ports go back to the OS once their stores close (no other
    # process can have been given them while they were bound).
    assert _bindable(second) and _bindable(first)


def _launched_pod(tmp_path, port, env):
    """A pod granted two cards, through the port's launcher: each rank
    boots from its per-card block (``initialize_from_env``, ``tcp://``
    rendezvous at worker 0's node and ``port``)."""
    cards = [0, 1]
    path = tmp_path / "pod-bind-info.json"
    path.write_text(json.dumps({
        "node": "localhost", "leafCellIsolation": cards,
        "affinityGroupBindInfo": [{"podPlacements": [
            {"physicalNode": "localhost", "physicalLeafCellIndices": cards}]}]}))
    return subprocess.run(
        [sys.executable, "-m", "hivedscheduler_tpu_torch.workloads.launch", "--bind-info",
         str(path), "--master-port", str(port), "--timeout", "60", "--",
         "tests._torch_rendezvous"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("agent_store", [True, False])
def test_a_launched_rank_joins_the_test_store_as_a_client(tmp_path, agent_store):
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    if agent_store:
        env.update(AGENT_STORE)
    with gang_store(2) as port:
        proc = _launched_pod(tmp_path, port, env)
    if agent_store:
        assert proc.returncode == 0, proc.stderr[-3000:]
        outs = sorted((json.loads(line) for line in proc.stdout.splitlines()),
                      key=lambda o: o["rank"])
        assert outs == [{"rank": 0, "world": 2, "sum": 3}, {"rank": 1, "world": 2, "sum": 3}]
    else:
        # Without it rank 0 starts a store server of its own on the port,
        # which the test's store holds: the launcher ends the pod.
        assert proc.returncode != 0
        assert "EADDRINUSE" in proc.stderr or "address already in use" in proc.stderr.lower(), \
            proc.stderr[-3000:]


@pytest.mark.parametrize("path", GANG_WORKERS, ids=os.path.basename)
def test_every_gang_worker_sets_up_its_cpu_through_cpu_rank(path):
    # One place sets a rank's threads and sums (ROADMAP queue 3, F5): a
    # worker that set its own could run two threads again.
    source = open(path).read()
    assert "cpu_rank()" in source
    assert "set_num_threads(" not in source and "use_deterministic_algorithms(" not in source


def test_a_cpu_rank_runs_one_thread_with_deterministic_sums():
    code = ("import json, torch; from tests._torch_rendezvous import cpu_rank; cpu_rank(); "
            "print(json.dumps([torch.get_num_threads(), "
            "torch.are_deterministic_algorithms_enabled(), torch.__config__.parallel_info()]))")
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    threads, deterministic, info = json.loads(proc.stdout.strip().splitlines()[-1])
    assert threads == 1 and deterministic
    # MKL's GEMMs too run on the one thread (torch sets its count with OpenMP's).
    assert "mkl_get_max_threads() : 1" in info, info
