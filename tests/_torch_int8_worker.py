"""Worker process for the port's int8 serving-gang tests (gloo, on the CPU).

    python _torch_int8_worker.py <rank> <world> <port> <workdir>

Reads from ``workdir``: ``params.npz`` (the tiny model's f32 parameters
from the JAX package's init, keys joined by "/"), ``int8.npz`` (JAX's
``quantize_params`` of them), ``prompt.npy`` and ``ckpt`` (a one-process
checkpoint of the same parameters). For each layout (fsdp2 x tp2, tp4) it
places the f32 parameters by the rule table and quantizes them on the mesh,
writes this rank's int8 shards to ``int8_<layout>_rank<r>.npz``, places
JAX's int8 tree through ``convert`` and compares the two, serves the prompt
greedily from each (this rank's rows) and serves ``ckpt`` through
``serve.build(..., int8=True)``. Prints one JSON line.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LAYOUTS = {"fsdp2_tp2": dict(fsdp=2, tp=2), "tp4": dict(tp=4)}
NEW_TOKENS = 8


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


def gang(rank, workdir):
    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor

    from hivedscheduler_tpu_torch import serve
    from hivedscheduler_tpu_torch.models import convert, quantize, transformer
    from hivedscheduler_tpu_torch.parallel import mesh as pmesh
    from hivedscheduler_tpu_torch.parallel import sharding

    config = transformer.tiny()
    axes = transformer.logical_axes(config)
    int8_axes = quantize.quantized_axes(axes)
    masters = _unflat(dict(np.load(os.path.join(workdir, "params.npz"))))
    jax_int8 = _unflat(dict(np.load(os.path.join(workdir, "int8.npz"))))
    prompt = torch.from_numpy(np.load(os.path.join(workdir, "prompt.npy")))
    result = {"rank": rank, "layouts": {}}
    for layout, sizes in LAYOUTS.items():
        mesh = pmesh.make_mesh(pmesh.MeshConfig(**sizes), device="cpu")
        params = convert.params_from_jax(masters, "cpu", mesh=mesh, axes=axes)
        q = quantize.quantize_params(params, axes)
        local = {k: v.to_local() for k, v in _flat(q).items()}
        np.savez(os.path.join(workdir, f"int8_{layout}_rank{rank}.npz"),
                 **{k: v.numpy() for k, v in local.items()})
        want = _flat(sharding.tree_shardings(sharding.param_mesh(mesh), int8_axes))
        placed = convert.params_from_jax(jax_int8, "cpu", mesh=mesh, axes=int8_axes)
        rows = sharding.shard_batch(prompt, mesh)

        def tokens(p):
            res = serve.run_request(p, rows, config, NEW_TOKENS, mesh=mesh)
            return res["tokens"].tolist()

        _, from_ckpt = serve.build("tiny", 0, "cpu", int8=True, mesh=mesh,
                                   ckpt=os.path.join(workdir, "ckpt"))
        result["layouts"][layout] = {
            "coords": {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names},
            "batch_rank": sharding.batch_rank(mesh),
            "dtypes": {k: str(v.dtype) for k, v in local.items()
                       if k.endswith(("/w", "/scale"))},
            "placements_match": all(
                isinstance(v, DTensor) and tuple(v.placements) == tuple(want[k])
                for k, v in _flat(q).items()),
            "jax_placed_equal": all(torch.equal(v.to_local(), local[k])
                                    for k, v in _flat(placed).items()),
            "ckpt_equal": all(torch.equal(v.to_local(), local[k])
                              for k, v in _flat(from_ckpt).items()),
            "digest": quantize.shard_digest(q),
            "tokens": tokens(q),
            "jax_placed_tokens": tokens(placed),
            "ckpt_tokens": tokens(from_ckpt),
        }
    return result


def main() -> None:
    rank, world, port, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]

    import torch.distributed as dist

    from tests._torch_rendezvous import cpu_rank, join

    cpu_rank()
    join(port, world, rank)  # a client of the test's store
    try:
        out = gang(rank, workdir)
    finally:
        dist.destroy_process_group()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
