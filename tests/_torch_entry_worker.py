"""Worker process for the port's multi-process entry-point tests (gloo).

    python _torch_entry_worker.py train|serve <rank> <world> <port> <arg>...

Writes the gang's env block (the keys the scheduler emits, coordinator on
loopback) into ``HIVED_TPU_ENV`` and runs ``train.main`` or ``serve.main``
on the CPU with the remaining arguments. Prints one JSON line: the losses
of each step, or each request's tokens (this rank's rows).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    mode, rank, world, port, argv = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4], sys.argv[5:]
    block = {"TPU_WORKER_ID": rank, "JAX_PROCESS_ID": rank, "JAX_NUM_PROCESSES": world,
             "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}"}
    os.environ["HIVED_TPU_ENV"] = "".join(f'{k}: "{v}"\n' for k, v in block.items())

    import torch
    import torch.distributed as dist

    torch.set_num_threads(2)  # the ranks share the host's cores

    from hivedscheduler_tpu_torch import serve, train

    try:
        if mode == "train":
            out = {"losses": [r["loss"] for r in train.main(argv + ["--device", "cpu"]).records]}
        else:
            out = {"tokens": [r["tokens"].tolist() for r in serve.main(argv + ["--device", "cpu"])]}
        out["world"] = dist.get_world_size()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
