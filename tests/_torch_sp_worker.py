"""Worker process for the port's sequence-parallel tests (gloo, on the CPU).

    python _torch_sp_worker.py <rank> <world> <port> <workdir>

Reads ``attn.npz`` (each case's global q, k, v and output cotangent w),
``cases.json`` (each attention case's mesh sizes, backend, causality and
query chunk, and each step case's mesh sizes and sp_mode), ``params.npz``
(the tiny model's parameters, keys joined by "/") and ``tokens.npz`` from
``workdir``. Attention: this rank's shards through ``ulysses_attention`` or
``ring_attention``, then backward of sum(out * w); writes its output and
gradient shards to ``attn_<rank>.npz``. Exchange: this rank's x through
``sharding.all_to_all`` over sp, then backward of sum(y * w); writes y and
x's gradient to ``exchange_<rank>.npz`` and counts funcol's and c10d's
all-to-all calls. Steps: one sharded train step of
the tiny model per case on this rank's block of the tokens; rank 0 writes
the gathered gradients to ``grads_<case>.npz``. Counts the calls of
``attention.mha`` (and the query heads each took) and of
``ring.ring_attention``. Prints one JSON line.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def _unflat(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, last = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def local(x, mesh, sp_dim=1, head_dim=2):
    """This rank's shard of a global [B, S, H, ...] array: S over sp, H over tp."""
    from hivedscheduler_tpu_torch.parallel import sharding

    for dim, axis in ((sp_dim, "sp"), (head_dim, "tp")):
        n = sharding.axes_size(axis, mesh)
        width = x.shape[dim] // n
        x = x.narrow(dim, mesh.get_local_rank(axis) * width, width)
    return x.contiguous()


def main() -> None:
    rank, world, port, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]

    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from tests._torch_rendezvous import cpu_rank, join

    cpu_rank()
    join(port, world, rank)  # a client of the test's store

    from hivedscheduler_tpu_torch.models import convert, train, transformer
    from hivedscheduler_tpu_torch.ops import attention
    from hivedscheduler_tpu_torch.parallel import mesh as pmesh
    from hivedscheduler_tpu_torch.parallel import ring, sharding, ulysses

    cases = json.load(open(os.path.join(workdir, "cases.json")))
    routes = {"mha": 0, "heads": [], "ring": 0}
    real_mha, real_ring = attention.mha, ring.ring_attention

    def mha(q, *a, **kw):
        routes["mha"] += 1
        routes["heads"].append(q.shape[2])
        return real_mha(q, *a, **kw)

    def ring_attention(*a, **kw):
        routes["ring"] += 1
        return real_ring(*a, **kw)

    attention.mha, ring.ring_attention = mha, ring_attention

    def reset():
        routes.update(mha=0, heads=[], ring=0)

    result = {"rank": rank, "attn_routes": {}, "losses": {}, "step_routes": {},
              "exchange_calls": {}}
    try:
        import torch.distributed._functional_collectives as funcol

        calls = {"funcol": 0, "c10d": 0}

        def counted(route, inner):
            def call(*a, **kw):
                calls[route] += 1
                return inner(*a, **kw)
            return call

        data = dict(np.load(os.path.join(workdir, "exchange.npz")))
        exchanged = {}
        real = funcol.all_to_all_single, dist.all_to_all_single
        funcol.all_to_all_single = counted("funcol", real[0])
        dist.all_to_all_single = counted("c10d", real[1])
        try:
            for name, sizes in cases["exchange"].items():
                mesh = pmesh.make_mesh(pmesh.MeshConfig(**sizes), "cpu")
                calls.update(funcol=0, c10d=0)
                x = torch.from_numpy(data[f"{name}/x{rank}"]).requires_grad_()
                y = sharding.all_to_all(x, mesh, "sp")
                (y * torch.from_numpy(data[f"{name}/w{rank}"])).sum().backward()
                result["exchange_calls"][name] = dict(calls)
                exchanged[f"{name}/y"] = y.detach().numpy()
                exchanged[f"{name}/dx"] = x.grad.numpy()
        finally:
            funcol.all_to_all_single, dist.all_to_all_single = real
        np.savez(os.path.join(workdir, f"exchange_{rank}.npz"), **exchanged)

        data = dict(np.load(os.path.join(workdir, "attn.npz")))
        shards = {}
        for name, case in cases["attn"].items():
            mesh = pmesh.make_mesh(pmesh.MeshConfig(**case["mesh"]), "cpu")
            q, k, v, w = (local(torch.from_numpy(data[f"{name}/{t}"]), mesh) for t in "qkvw")
            q, k, v = (t.requires_grad_() for t in (q, k, v))
            reset()
            if case["backend"] == "ulysses":
                out = ulysses.ulysses_attention(q, k, v, mesh, causal=case["causal"])
            else:
                out = ring.ring_attention(q, k, v, mesh, causal=case["causal"],
                                          q_chunk=case["q_chunk"])
            (out * w).sum().backward()
            result["attn_routes"][name] = dict(routes, heads=list(routes["heads"]))
            for t, x in (("out", out), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
                shards[f"{name}/{t}"] = x.detach().numpy()
        np.savez(os.path.join(workdir, f"attn_{rank}.npz"), **shards)

        full = convert.params_from_jax(
            _unflat(dict(np.load(os.path.join(workdir, "params.npz")))), device="cpu")
        tokens = dict(np.load(os.path.join(workdir, "tokens.npz")))
        for name, case in cases["step"].items():
            config = dataclasses.replace(transformer.tiny(), sp_mode=case["sp_mode"])
            mesh = pmesh.make_mesh(pmesh.MeshConfig(**case["mesh"]), "cpu")
            params = transformer.distribute(full, config, mesh)
            opt = train.make_optimizer(params)
            reset()
            toks = sharding.shard_batch(torch.from_numpy(tokens[case["tokens"]]), mesh)
            result["losses"][name] = train.train_step(params, opt, toks, config, "cpu",
                                                      mesh).item()
            result["step_routes"][name] = dict(routes, heads=list(routes["heads"]))
            grads = {k: v.grad.full_tensor().numpy() for k, v in _flat(params).items()}
            if rank == 0:
                np.savez(os.path.join(workdir, f"grads_{name}.npz"), **grads)
    finally:
        dist.destroy_process_group()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
