"""Worker process for the port's pipeline tests (gloo, on the CPU).

    python _torch_pipeline_worker.py <rank> <world> <port> <workdir> [<cases file>]

Reads ``cases.json`` (or the named cases file), ``mlp.npz (each MLP case's stacked layers ``w``,
``b``, input ``x`` and output cotangent ``c``), ``params.npz`` (the tiny
model's parameters, keys joined by "/"), ``tokens.npz`` and ``ckpt_one``
(a one-process train state) from ``workdir``.

- MLP cases: ``pipeline_blocks`` over a (pp, fsdp) mesh on this rank's
  rows of ``x``; the last stage backpropagates sum(out * c), the others
  their anchor. Writes ``mlp_<case>_<rank>.npz``: the output (last stage),
  dx (stage 0) and the layers' gradients (this stage's rows).
- Step cases: one sharded train step of the tiny model; rank 0 writes the
  gathered gradients to ``grads_<case>.npz``; every rank writes its local
  ``embed``, ``ln_f`` and ``lm_head`` after the step to
  ``replicated_<case>_<rank>.npz`` and reports its kernel-entry calls.
- Where the cases ask for ``extras`` (a 4-rank gang):
- Logits: ``transformer.forward`` on pp 2 x tp 2 (rank 0 writes them).
- Checkpoints: ``ckpt_one`` restored into pp 2 x tp 2 (state written to
  ``restored.npz``), a step, saved to ``ckpt_pp`` (state written to
  ``pp_state.npz``).

Prints one JSON line.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from _torch_sharding_worker import _flat, _state_arrays, _unflat  # noqa: E402


def local_rows(x, mesh):
    from hivedscheduler_tpu_torch.parallel import sharding

    n = sharding.axes_size(sharding.BATCH_AXES, mesh)
    rows = x.shape[0] // n
    return x.narrow(0, sharding.batch_rank(mesh) * rows, rows).contiguous()


def mlp_case(name, case, data, rank, workdir):
    import numpy as np
    import torch

    from hivedscheduler_tpu_torch.parallel import mesh as pmesh
    from hivedscheduler_tpu_torch.parallel import pipeline, sharding

    mesh = pmesh.make_mesh(pmesh.MeshConfig(pp=case["pp"], fsdp=case["fsdp"]), "cpu")
    layers = {k: torch.from_numpy(data[f"{name}/{k}"]).requires_grad_() for k in ("w", "b")}
    x = local_rows(torch.from_numpy(data[f"{name}/x"]), mesh).requires_grad_()
    c = local_rows(torch.from_numpy(data[f"{name}/c"]), mesh)

    def block(h, layer):
        return torch.tanh(h @ layer["w"] + layer["b"])

    out = pipeline.pipeline_blocks(layers, x, mesh, block, case["m"])
    last = pipeline.is_last_stage(mesh)
    (out * c).sum().backward() if last else out.backward()
    arrays = {"dw": layers["w"].grad.numpy(), "db": layers["b"].grad.numpy()}
    if last:
        arrays["out"] = out.detach().numpy()
    if mesh.get_local_rank("pp") == 0:
        arrays["dx"] = x.grad.numpy()
    np.savez(os.path.join(workdir, f"mlp_{name}_{rank}.npz"), **arrays)
    return {"stage": mesh.get_local_rank("pp"), "batch_rank": sharding.batch_rank(mesh),
            "anchor": None if last else out.item()}


def extras(full, tokens, rank, workdir, result):
    """Logits on pp 2 x tp 2, and a train state moved between one process
    and pp 2 x tp 2."""
    import numpy as np
    import torch

    from hivedscheduler_tpu_torch.models import checkpoint, train, transformer
    from hivedscheduler_tpu_torch.parallel import mesh as pmesh
    from hivedscheduler_tpu_torch.parallel import sharding

    config = transformer.tiny()
    mesh = pmesh.make_mesh(pmesh.MeshConfig(pp=2, tp=2), "cpu")
    params = transformer.distribute(full, config, mesh)
    with torch.no_grad():
        logits = transformer.forward(params, torch.from_numpy(tokens["rng"]), config, mesh)
    if rank == 0:
        np.save(os.path.join(workdir, "logits_pp.npy"), logits.numpy())
    result["logits_shape"] = list(logits.shape)

    # A one-process checkpoint restored into pp 2 x tp 2, a step, a save.
    params = transformer.distribute(transformer.init(
        config, torch.Generator().manual_seed(9), "cpu", torch.float32), config, mesh)
    opt = train.make_optimizer(params)
    _, _, step = checkpoint.TrainCheckpointer(os.path.join(workdir, "ckpt_one")).restore(
        params, opt)
    arrays = _state_arrays(params, opt)
    if rank == 0:
        np.savez(os.path.join(workdir, "restored.npz"), **arrays)
    local = sharding.shard_batch(torch.from_numpy(tokens["rng"]), mesh)
    train.train_step(params, opt, local, config, "cpu", mesh)
    checkpoint.TrainCheckpointer(os.path.join(workdir, "ckpt_pp")).save(step + 1, params, opt)
    arrays = _state_arrays(params, opt)
    if rank == 0:
        np.savez(os.path.join(workdir, "pp_state.npz"), **arrays)
    result["restored_step"] = step


def main() -> None:
    rank, world, port, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    cases_file = sys.argv[5] if len(sys.argv) > 5 else "cases.json"

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
    from hivedscheduler_tpu_torch.parallel import ring, sharding

    cases = json.load(open(os.path.join(workdir, cases_file)))
    routes = {"mha": 0, "ring": 0}
    real_mha, real_ring = attention.mha, ring.ring_attention

    def mha(*a, **kw):
        routes["mha"] += 1
        return real_mha(*a, **kw)

    def ring_attention(*a, **kw):
        routes["ring"] += 1
        return real_ring(*a, **kw)

    attention.mha, ring.ring_attention = mha, ring_attention
    result = {"rank": rank, "mlp": {}, "losses": {}, "routes": {}}
    try:
        for name, case in cases["mlp"].items():
            data = dict(np.load(os.path.join(workdir, "mlp.npz")))
            result["mlp"][name] = mlp_case(name, case, data, rank, workdir)

        full = convert.params_from_jax(
            _unflat(dict(np.load(os.path.join(workdir, "params.npz")))), device="cpu")
        tokens = dict(np.load(os.path.join(workdir, "tokens.npz")))
        for name, case in cases["step"].items():
            fields = dict(case["config"])
            if "dtype" in fields:
                fields["dtype"] = getattr(torch, fields["dtype"])
            config = dataclasses.replace(transformer.tiny(), **fields)
            mesh = pmesh.make_mesh(pmesh.MeshConfig(**case["mesh"]), "cpu")
            params = transformer.distribute(full, config, mesh)
            opt = train.make_optimizer(params)
            routes.update(mha=0, ring=0)
            toks = sharding.shard_batch(torch.from_numpy(tokens[case["tokens"]]), mesh)
            result["losses"][name] = train.train_step(params, opt, toks, config, "cpu",
                                                      mesh).item()
            result["routes"][name] = dict(routes)
            grads = {k: v.grad.full_tensor().numpy() for k, v in _flat(params).items()}
            if rank == 0:
                np.savez(os.path.join(workdir, f"grads_{name}.npz"), **grads)
            np.savez(os.path.join(workdir, f"replicated_{name}_{rank}.npz"),
                     **{k: params[k].to_local().detach().numpy()
                        for k in ("embed", "ln_f", "lm_head")})
            result.setdefault("coords", {})[name] = {
                a: mesh.get_local_rank(a) for a in pmesh.MESH_AXES}

        if cases["extras"]:
            extras(full, tokens, rank, workdir, result)
    finally:
        dist.destroy_process_group()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
