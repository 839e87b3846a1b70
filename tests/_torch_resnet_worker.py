"""Worker process for the port's data-parallel ResNet tests (gloo, on the
CPU).

    python _torch_resnet_worker.py <rank> <world> <port> <workdir>

Reads ``cases.json`` (each case's mesh sizes and whether batch norm is left
local to the rank), ``params.npz`` and ``stats.npz`` (an f64 ResNet's
parameters and batch stats, keys joined by "/", list indices as numbers)
and ``batch.npz`` (images and labels) from ``workdir``. For each case it
replicates the parameters on the mesh and takes one step of
``workloads/train_resnet.train_step`` on this rank's rows; rank 0 writes
the gradients to ``grads_<case>.npz``, and every rank writes its new stats
to ``stats_<case>_<rank>.npz``. A local case replaces the global batch mean
(``resnet.batch_mean``) with the rank's own. Prints one JSON line: each
case's loss and this rank's row count.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def flat(tree, prefix=""):
    """{"a/0/b": leaf} of a tree of dicts and lists."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        key = f"{prefix}{k}"
        out.update(flat(v, key + "/") if isinstance(v, (dict, list)) else {key: v})
    return out


def unflat(leaves):
    """``flat``'s inverse: a path's numeric parts index lists."""
    root = {}
    for key, v in leaves.items():
        parts = [int(p) if p.isdigit() else p for p in key.split("/")]
        node = root
        for p, nxt in zip(parts, parts[1:] + [None]):
            if isinstance(node, list):
                node.extend([None] * (p + 1 - len(node)))
            if nxt is None:
                node[p] = v
                continue
            if (node.get(p) if isinstance(node, dict) else node[p]) is None:
                node[p] = [] if isinstance(nxt, int) else {}
            node = node[p]
    return root


def main() -> None:
    rank, world, port, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]

    import numpy as np
    import torch
    import torch.distributed as dist

    from tests._torch_rendezvous import cpu_rank, join

    cpu_rank()
    join(port, world, rank)  # a client of the test's store

    from hivedscheduler_tpu_torch.models import convert, resnet
    from hivedscheduler_tpu_torch.parallel import mesh as pmesh
    from hivedscheduler_tpu_torch.parallel import sharding
    from hivedscheduler_tpu_torch.workloads import train_resnet

    def load(name):
        return unflat(dict(np.load(os.path.join(workdir, name))))

    cases = json.load(open(os.path.join(workdir, "cases.json")))
    full = convert.params_from_jax(load("params.npz"), "cpu", torch.float64)
    stats = convert.params_from_jax(load("stats.npz"), "cpu", torch.float64)
    batch = dict(np.load(os.path.join(workdir, "batch.npz")))
    config = resnet.ResNetConfig(int(batch["classes"]), int(batch["width"]), torch.float64)
    global_mean = resnet.batch_mean
    result = {"rank": rank, "losses": {}, "rows": {}}
    try:
        for name, case in cases.items():
            mesh = pmesh.make_mesh(pmesh.MeshConfig(**case["mesh"]), "cpu")
            params = resnet.distribute(full, mesh)
            images = sharding.shard_batch(torch.from_numpy(batch["images"]), mesh)
            labels = sharding.shard_batch(torch.from_numpy(batch["labels"]), mesh)
            if case["local_bn"]:
                resnet.batch_mean = lambda t, mesh=None: t.mean(dim=(0, 2, 3))
            try:
                opt = train_resnet.make_optimizer(params)
                loss, new_stats = train_resnet.train_step(params, stats, opt, images, labels,
                                                          config, mesh)
            finally:
                resnet.batch_mean = global_mean
            result["losses"][name] = loss.item()
            result["rows"][name] = images.shape[0]
            np.savez(os.path.join(workdir, f"stats_{name}_{rank}.npz"),
                     **{k: v.numpy() for k, v in flat(new_stats).items()})
            if rank == 0:
                grads = {k: v.grad.full_tensor().numpy() for k, v in flat(params).items()}
                np.savez(os.path.join(workdir, f"grads_{name}.npz"), **grads)
    finally:
        dist.destroy_process_group()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
