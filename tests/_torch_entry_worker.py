"""Worker process for the port's multi-process entry-point tests (gloo).

    python _torch_entry_worker.py train|train_pp|serve <rank> <world> <port> <arg>...
    python -m tests._torch_entry_worker launched|launched_pp <arg>...
    python -m tests._torch_entry_worker fail-or-hang

``train``/``train_pp``/``serve`` write the gang's env block (the keys the
scheduler emits, coordinator on loopback) into ``HIVED_TPU_ENV`` and run
``train.main``, ``workloads/train_pp.main`` or ``serve.main`` on the CPU
with the remaining arguments. ``launched`` (``launched_pp``) runs
``train.main`` (``train_pp.main``) in the environment the pod's launcher
(``workloads/launch.py``) gave it. Each prints one JSON line: the rank, the
losses of each step or each request's tokens (this rank's rows), the world
size. ``fail-or-hang`` exits 3 as rank 1 and sleeps as any other rank.

Every process that runs a step takes one thread and turns on
``torch.use_deterministic_algorithms`` (``deterministic``), as the
train-graph gang worker does: the tests hold two gangs' losses equal with
``==``, and the embedding lookup's backward (``index_put_`` with
accumulate) adds a token's rows in no fixed order on two threads. Two
gangs of two deterministic threads a rank under load have also parted by
two ulps in a loss, for a cause not found (unloaded, 1 to 8 threads give
the same bits); one thread works around that open fault.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _train_losses(mode, argv):
    from hivedscheduler_tpu_torch import train
    from hivedscheduler_tpu_torch.workloads import train_pp

    if mode.endswith("_pp"):
        return [r["loss"] for r in train_pp.main(argv + ["--device", "cpu"])]
    return [r["loss"] for r in train.main(argv + ["--device", "cpu"]).records]


def deterministic() -> None:
    """One thread a process (the ranks share the host's cores) and sums in
    one order: the same step gives the same bits in every gang."""
    import torch

    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)


def launched(mode, argv) -> None:
    import torch.distributed as dist

    deterministic()  # as the train/serve gangs: the same sums, the same losses

    try:
        out = {"losses": _train_losses(mode, argv)}
        out["rank"], out["world"] = dist.get_rank(), dist.get_world_size()
        out["env"] = {k: os.environ.get(k) for k in
                      ("RANK", "LOCAL_RANK", "WORLD_SIZE", "CUDA_VISIBLE_DEVICES", "JAX_NUM_PROCESSES")}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    # One write: a pod's children share the launcher's stdout pipe, and a
    # pipe write of < 4096 bytes is atomic, so two lines cannot interleave.
    sys.stdout.write(json.dumps(out) + "\n")
    sys.stdout.flush()


def main() -> None:
    if sys.argv[1] in ("launched", "launched_pp"):
        return launched(sys.argv[1], sys.argv[2:])
    if sys.argv[1] == "fail-or-hang":
        if os.environ["RANK"] == "1":
            sys.exit(3)
        time.sleep(600)
        return None
    mode, rank, world, port, argv = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4], sys.argv[5:]
    block = {"TPU_WORKER_ID": rank, "JAX_PROCESS_ID": rank, "JAX_NUM_PROCESSES": world,
             "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}"}
    os.environ["HIVED_TPU_ENV"] = "".join(f'{k}: "{v}"\n' for k, v in block.items())

    import torch.distributed as dist

    deterministic()

    from hivedscheduler_tpu_torch import serve

    try:
        if mode in ("train", "train_pp"):
            out = {"losses": _train_losses(mode, argv)}
        else:
            out = {"tokens": [r["tokens"].tolist() for r in serve.main(argv + ["--device", "cpu"])]}
        out["world"] = dist.get_world_size()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
