"""The rendezvous of the port's test gangs: one store a gang, held by the
test process.

A test opens ``gang_store(world)`` around the gang's whole life. The store
listens on a port the OS gives it and stays bound until the gang has been
reaped, so no other process on the host (another gang, a gloo pair
listener) can take the port between its choice and the gang's rendezvous,
and no two gangs share keys. Every rank is a client:

- a ``run_workers`` worker calls ``join(port, world, rank)``;
- a process that boots through the port's own code
  (``parallel/mesh.initialize_from_env``, whose ``tcp://`` rendezvous makes
  rank 0 a store server) runs with ``AGENT_STORE`` in its environment:
  torch then makes every rank a client of the store at that address, as
  under torchelastic's agent. The port's boot code stays as HiveD runs it.

Run as a process, this module is the trivial rank of
``tests/test_torch_rendezvous.py``: it joins a gang, all-reduces its rank
plus one and prints one JSON line (rank, world, sum):

    python _torch_rendezvous.py <rank> <world> <port>   # join()
    python -m tests._torch_rendezvous                   # initialize_from_env
"""

from __future__ import annotations

import contextlib
import datetime
import json
import os
import sys
from typing import Iterator

HOST = "127.0.0.1"
TIMEOUT = datetime.timedelta(seconds=300)
# torch.distributed.rendezvous: every rank of a tcp:// or env:// rendezvous
# joins the store at the address as a client; none starts a server.
AGENT_STORE = {"TORCHELASTIC_USE_AGENT_STORE": "True"}


@contextlib.contextmanager
def gang_store(world: int) -> Iterator[int]:
    """A TCP store for one gang of ``world`` ranks, in this process, on a
    port the OS gives it; yields the port and closes the store on exit."""
    import torch.distributed as dist

    store = dist.TCPStore(HOST, 0, world_size=world, is_master=True, wait_for_workers=False)
    try:
        yield store.port
    finally:
        del store  # the last reference: the server stops and frees the port


def cpu_rank() -> None:
    """Set this process up as a CPU rank of a test gang, before its first
    op: one intra-op thread and torch's deterministic algorithms. Every
    gang worker calls it.

    The tests hold gangs' losses, tokens, digests and leaves bitwise, so
    two ranks that run the same step must add in the same order. At two
    threads the embedding's backward (``index_put_`` with accumulate) adds
    a token's rows in no fixed order; the deterministic algorithms sort
    them. At two threads a weight gradient's GEMM (MKL) adds in another
    order than at one, and deterministic gangs at two threads a rank have
    parted by an ulp under six loaded xdist workers, a process with no
    peer too, for a cause below the port that no run pinned (ROADMAP
    queue 3, F5); none has parted at one thread. The ranks also share the
    host's cores."""
    import torch

    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)


def join(port, world, rank, backend: str = "gloo") -> None:
    """The default process group of rank ``rank`` of ``world``, through the
    test's store at ``port`` (``gang_store``)."""
    import torch.distributed as dist

    store = dist.TCPStore(HOST, int(port), world_size=int(world), is_master=False,
                          timeout=TIMEOUT)
    dist.init_process_group(backend, store=store, rank=int(rank), world_size=int(world))


def main(argv) -> None:
    import torch
    import torch.distributed as dist

    if argv:
        rank, world, port = argv
        join(port, world, rank)
    else:  # a launched rank: the per-card block and AGENT_STORE in the environment
        from hivedscheduler_tpu_torch.parallel import mesh

        mesh.initialize_from_env(device="cpu")
    total = torch.tensor([dist.get_rank() + 1])
    dist.all_reduce(total)
    line = json.dumps({"rank": dist.get_rank(), "world": dist.get_world_size(),
                       "sum": int(total.item())})
    dist.destroy_process_group()
    # One write: a pod's ranks share the launcher's stdout pipe.
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main(sys.argv[1:])
