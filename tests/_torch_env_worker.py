"""Worker process for the port's multi-process env-contract test.

Boots ``torch.distributed`` (gloo) through the port's
``initialize_from_env`` from the env block the scheduler emitted at bind
time, builds a two-process mesh, runs one ``all_reduce`` and reads its own
block of a shared token file through ``sharded_batches``. Run as:

    python _torch_env_worker.py '<env-block-yaml>' <coordinator-port> <token-file>

The scheduler emits real cluster hostnames in JAX_COORDINATOR_ADDRESS; they
do not resolve inside the test harness, so the coordinator address is
rewritten to the store the test holds on loopback (``_torch_rendezvous``),
which every rank joins as a client. The rank and the world size are the
block's own. Prints one JSON line.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    block, port, path = sys.argv[1], sys.argv[2], sys.argv[3]

    import torch
    import torch.distributed as dist

    from hivedscheduler_tpu_torch.parallel import mesh as pmesh
    from hivedscheduler_tpu_torch.utils import data
    from hivedscheduler_tpu_torch.workloads.common import parse_env_block
    from tests._torch_rendezvous import AGENT_STORE, cpu_rank

    cpu_rank()
    os.environ.update(AGENT_STORE)
    env = parse_env_block(block)
    env["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
    pmesh.initialize_from_env(env, device="cpu")
    rank, world = dist.get_rank(), dist.get_world_size()
    assert rank == int(env["JAX_PROCESS_ID"]), (rank, env)
    assert world == int(env["JAX_NUM_PROCESSES"]), (world, env)

    total = torch.tensor([rank + 1])
    dist.all_reduce(total)

    mesh = pmesh.make_mesh(pmesh.MeshConfig(fsdp=world), device="cpu")
    ds = data.TokenFileDataset(path, seq_len=16)
    blocks = [b.tolist() for b in data.sharded_batches(ds, 4, mesh, seed=7, epochs=1)]
    print(json.dumps({
        "rank": rank, "world": world, "sum": int(total.item()),
        "coordinate": mesh.get_coordinate(), "mesh_shape": list(mesh.shape),
        "blocks": blocks,
    }), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
