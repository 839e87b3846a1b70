"""The pod's launcher: one process per card the scheduler granted the pod.

    python -m hivedscheduler_tpu_torch.workloads.launch --bind-info FILE \\
        [--timeout SECONDS] [--master-port PORT] -- <module> <args...>

``FILE`` is the pod's ``pod-bind-info`` annotation (JSON) as the pod mounts
it. The launcher lifts ``HIVED_TPU_ENV`` into its environment as every
entry point does (``workloads/common.lift_env_block``), then starts
``python -m <module> <args...>`` once per block of
``gpu/env.pod_gpu_env``, each with its block over the environment: one
card, its rank in the gang, the world size and the rendezvous. The
children boot from that block (``parallel/mesh.initialize_from_env`` reads
it before the pod's JAX block, which they inherit too).

It waits for all of them. When one fails it ends the rest and exits with
the failing process's code, so a gang never waits on a dead rank; past
``--timeout`` it ends them all and exits 124. Without ``--bind-info`` it
runs the module once, in the environment as it is: one process a pod,
booted from the JAX block.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

from ..gpu.env import MASTER_PORT, pod_gpu_env
from .common import lift_env_block

TIMEOUT_EXIT = 124
_POLL_S = 0.1
_GRACE_S = 5.0


def _split(argv: Sequence[str]):
    """(the launcher's own arguments, the child's command) around ``--``."""
    argv = list(argv)
    if "--" not in argv:
        raise SystemExit("launch: give the module to run after '--'")
    i = argv.index("--")
    if i == len(argv) - 1:
        raise SystemExit("launch: no module after '--'")
    return argv[:i], argv[i + 1:]


def _end(procs: Sequence[subprocess.Popen]) -> None:
    """Terminate every child still running; kill one that outlives the
    grace period."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + _GRACE_S
    for p in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _exit_code(rc: int) -> int:
    """A child's return code as an exit code (a signal N as 128 + N)."""
    return rc if rc >= 0 else 128 - rc


def wait_all(procs: Sequence[subprocess.Popen], timeout: Optional[float] = None) -> int:
    """Wait for every child: 0 when all exit 0; the first failure's code
    (the rest ended at once); ``TIMEOUT_EXIT`` past ``timeout`` seconds.
    Leaves no child running."""
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [rc for rc in codes if rc not in (None, 0)]
            if failed:
                return _exit_code(failed[0])
            if all(rc == 0 for rc in codes):
                return 0
            if deadline is not None and time.monotonic() > deadline:
                return TIMEOUT_EXIT
            time.sleep(_POLL_S)
    finally:
        _end(procs)


def child_envs(bind_info_path: Optional[str], master_port: int = MASTER_PORT) -> List[Dict[str, str]]:
    """The environment of each child: the launcher's, with one per-card
    block over it per granted card; the environment alone without a bind
    info."""
    base = dict(os.environ)
    if bind_info_path is None:
        return [base]
    with open(bind_info_path) as f:
        blocks = pod_gpu_env(json.load(f), master_port)
    if not blocks:
        raise ValueError(f"{bind_info_path}: the pod was granted no card")
    return [{**base, **block} for block in blocks]


def main(argv: Optional[Sequence[str]] = None) -> int:
    own, command = _split(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--bind-info", default=None,
                        help="the pod's pod-bind-info annotation (JSON); omit for one process")
    parser.add_argument("--timeout", type=float, default=None,
                        help="end every process and exit 124 after this many seconds")
    parser.add_argument("--master-port", type=int, default=MASTER_PORT,
                        help="the rendezvous port on worker 0's node; the whole gang must agree")
    args = parser.parse_args(own)
    lift_env_block()
    envs = child_envs(args.bind_info, args.master_port)
    procs: List[subprocess.Popen] = []

    def stop(signum, _frame):  # the pod is being deleted: take the children along
        raise SystemExit(128 + signum)

    signal.signal(signal.SIGTERM, stop)
    try:
        for env in envs:
            procs.append(subprocess.Popen([sys.executable, "-m", *command], env=env))
        return wait_all(procs, args.timeout)
    finally:
        _end(procs)


if __name__ == "__main__":
    sys.exit(main())
