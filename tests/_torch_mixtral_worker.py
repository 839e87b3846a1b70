"""Worker process for the port's Mixtral gang tests (gloo, on the CPU).

    python _torch_mixtral_worker.py <rank> <world> <port> <workdir>

Reads ``cases.json`` (each case's mesh sizes and sp_mode), ``params.npz``
(Mixtral tiny's parameters from the JAX package's ``init``, keys joined by
"/") and ``batch.npz`` (the step's tokens, the decode prompt and the
served prompt) from ``workdir``. For each case it places the parameters
with the rule table, runs the forward on this rank's block (rank 0 writes
its logits to ``logits_<case>.npy``) and takes one step of
``workloads/train_mixtral.train_step``; rank 0 writes the gathered
gradients to ``grads_<case>.npz``. On fsdp 2 x ep 2 it also runs a cached
decode at capacity factor 16 and at the default (``decode_<cf>.npy``: the
prefill's and each step's logits, every row) and serves the one-process
checkpoint under ``ckpt`` through ``serve.build(ckpt=...)``
(``served.npy``: the greedy tokens, every row). Prints one JSON line: each
case's loss and aux loss.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from _torch_sharding_worker import _flat, _unflat  # noqa: E402

DECODE_PREFILL, SERVED_TOKENS = 6, 4


def main() -> None:
    rank, world, port, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]

    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from tests._torch_rendezvous import cpu_rank, join

    cpu_rank()
    join(port, world, rank)  # a client of the test's store

    from hivedscheduler_tpu_torch import serve
    from hivedscheduler_tpu_torch.models import convert, generate, mixtral
    from hivedscheduler_tpu_torch.parallel import mesh as pmesh
    from hivedscheduler_tpu_torch.parallel import sharding
    from hivedscheduler_tpu_torch.workloads import train_mixtral

    def save(name, array):
        if rank == 0:
            np.save(os.path.join(workdir, name), array)

    cases = json.load(open(os.path.join(workdir, "cases.json")))
    full = convert.params_from_jax(_unflat(dict(np.load(os.path.join(workdir, "params.npz")))),
                                   device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(workdir, "batch.npz")).items()}
    result = {"rank": rank, "losses": {}, "aux": {}}
    try:
        for name, case in cases.items():
            mesh = pmesh.make_mesh(pmesh.MeshConfig(**case["mesh"]), "cpu")
            config = dataclasses.replace(mixtral.tiny(), sp_mode=case["sp_mode"])
            params = mixtral.distribute(full, config, mesh)
            tokens = sharding.shard_batch(batch["tokens"], mesh)
            with torch.no_grad():
                logits, aux = mixtral.forward(params, tokens, config, mesh)
            save(f"logits_{name}.npy", logits.numpy())
            result["aux"][name] = aux.item()
            opt = train_mixtral.make_optimizer(params, 1e-3)
            result["losses"][name] = train_mixtral.train_step(params, opt, tokens, config,
                                                              mesh).item()
            grads = {k: v.grad.full_tensor().numpy() for k, v in _flat(params).items()}
            if rank == 0:
                np.savez(os.path.join(workdir, f"grads_{name}.npz"), **grads)

        mesh = pmesh.make_mesh(pmesh.MeshConfig(fsdp=2, ep=2), "cpu")
        prompt = batch["decode"]
        for cf in (16.0, mixtral.tiny().capacity_factor):
            config = dataclasses.replace(mixtral.tiny(), capacity_factor=cf)
            params = mixtral.distribute(full, config, mesh)
            ffn = mixtral.decode_ffn(config)
            local = sharding.shard_batch(prompt, mesh)
            cache = generate.init_cache(config, local.shape[0], prompt.shape[1], "cpu", mesh)
            logits, cache = generate.prefill(params, local[:, :DECODE_PREFILL], cache, config,
                                             mesh=mesh, ffn=ffn)
            steps = [logits]
            for t in range(DECODE_PREFILL, prompt.shape[1]):
                logits, cache = generate.decode_step(params, local[:, t], cache, config, mesh,
                                                     ffn)
                steps.append(logits)
            save(f"decode_{cf}.npy", sharding.gather_tokens(torch.stack(steps, 1), mesh).numpy())

        config, params = serve.build("mixtral_tiny", 0, "cpu", ckpt=os.path.join(workdir, "ckpt"),
                                     mesh=mesh)
        res = serve.run_request(params, sharding.shard_batch(batch["served"], mesh), config,
                                SERVED_TOKENS, mesh=mesh, ffn=serve.decode_hook(config))
        save("served.npy", sharding.gather_tokens(res["tokens"], mesh).numpy())
    finally:
        dist.destroy_process_group()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
