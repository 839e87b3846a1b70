"""Worker process for the port's sharded BERT tests (gloo, on the CPU).

    python _torch_bert_worker.py <rank> <world> <port> <workdir>

Reads ``cases.json`` (each case's mesh sizes and target set),
``params.npz`` (BERT tiny's parameters from the JAX package's ``init``,
keys joined by "/") and ``batch.npz`` (tokens and each target set) from
``workdir``. For each case it places the parameters with the rule table
and takes one step of ``workloads/train_bert.train_step`` on this rank's
rows; rank 0 writes the gathered gradients to ``grads_<case>.npz``. It
also writes rank 0's logits of each case to ``logits_<case>.npz`` (its
tp shard of the vocab). Prints one JSON line: each case's loss and the
query heads each ``attention.mha`` call took.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from _torch_sharding_worker import _flat, _unflat  # noqa: E402


def main() -> None:
    rank, world, port, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]

    import numpy as np
    import torch
    import torch.distributed as dist

    from tests._torch_rendezvous import cpu_rank, join

    cpu_rank()
    join(port, world, rank)  # a client of the test's store

    from hivedscheduler_tpu_torch.models import bert, convert
    from hivedscheduler_tpu_torch.ops import attention
    from hivedscheduler_tpu_torch.parallel import mesh as pmesh
    from hivedscheduler_tpu_torch.parallel import sharding
    from hivedscheduler_tpu_torch.workloads import train_bert

    heads = []
    real_mha = attention.mha

    def mha(q, *a, **kw):
        heads.append(q.shape[2])
        return real_mha(q, *a, **kw)

    attention.mha = mha
    cases = json.load(open(os.path.join(workdir, "cases.json")))
    full = convert.params_from_jax(_unflat(dict(np.load(os.path.join(workdir, "params.npz")))),
                                   device="cpu")
    batch = dict(np.load(os.path.join(workdir, "batch.npz")))
    config = bert.tiny()
    result = {"rank": rank, "losses": {}, "heads": {}}
    try:
        for name, case in cases.items():
            mesh = pmesh.make_mesh(pmesh.MeshConfig(**case["mesh"]), "cpu")
            params = bert.distribute(full, config, mesh)
            tokens = sharding.shard_batch(torch.from_numpy(batch["tokens"]), mesh)
            targets = sharding.shard_batch(torch.from_numpy(batch[case["targets"]]), mesh)
            with torch.no_grad():
                logits = bert.forward(params, tokens, config, mesh)
            if rank == 0:
                np.save(os.path.join(workdir, f"logits_{name}.npy"), logits.numpy())
            heads.clear()
            opt = train_bert.make_optimizer(params)
            result["losses"][name] = train_bert.train_step(params, opt, tokens, targets, config,
                                                           mesh).item()
            result["heads"][name] = list(heads)
            grads = {k: v.grad.full_tensor().numpy() for k, v in _flat(params).items()}
            if rank == 0:
                np.savez(os.path.join(workdir, f"grads_{name}.npz"), **grads)
    finally:
        dist.destroy_process_group()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
