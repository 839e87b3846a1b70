"""Worker process for the port's sharded-step tests (gloo, on the CPU).

    python _torch_sharding_worker.py gang <rank> <world> <port> <workdir>
    python _torch_sharding_worker.py one <rank> 1 <port> <workdir>

``gang`` (4 ranks) reads ``params.npz`` (the tiny model's parameters, keys
joined by "/") and ``tokens.npz`` from ``workdir``. For each layout
(fsdp2 x tp2, dp2 x fsdp2, tp4) and token set it places the parameters
with the rule table, takes one sharded step on this rank's rows, and
writes the gathered gradients to ``grads_<layout>_<tokens>.npz`` (rank 0).
It holds ``sharded_mha`` and the vocab-parallel lookup against the whole
computation, restores ``ckpt_one`` (written by one process) into the
fsdp2 x tp2 layout, writes the restored state to ``restored.npz``, takes a
step, saves it to ``ckpt_gang`` and writes that state to
``gang_state.npz``. ``one`` runs a one-rank gloo mesh against the unsharded
step. Prints one JSON line.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LAYOUTS = {"fsdp2_tp2": dict(fsdp=2, tp=2), "dp2_fsdp2": dict(dp=2, fsdp=2), "tp4": dict(tp=4)}


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


def _state_arrays(params, optimizer):
    """The whole parameters and AdamW moments as numpy, keyed by path."""
    import numpy as np

    from hivedscheduler_tpu_torch.models import convert, transformer

    out = {f"params/{k}": v for k, v in _flat(convert.params_to_numpy(params)).items()}
    names = list(_flat(params))
    for name, p in zip(names, transformer.leaves(params)):
        for m in ("exp_avg", "exp_avg_sq"):
            t = optimizer.state[p][m].detach()
            out[f"{m}/{name}"] = (t.full_tensor() if hasattr(t, "full_tensor") else t).numpy()
        out[f"step/{name}"] = np.asarray(optimizer.state[p]["step"].item())
    return out


def gang(rank, workdir):
    import numpy as np
    import torch
    import torch.distributed as dist

    from hivedscheduler_tpu_torch.models import checkpoint, convert, train, transformer
    from hivedscheduler_tpu_torch.ops import attention
    from hivedscheduler_tpu_torch.parallel import mesh as pmesh
    from hivedscheduler_tpu_torch.parallel import sharding

    config = transformer.tiny()
    full = convert.params_from_jax(_unflat(dict(np.load(os.path.join(workdir, "params.npz")))),
                                   device="cpu")
    tokens = dict(np.load(os.path.join(workdir, "tokens.npz")))
    # Calls of each attention entry, and the query heads each mha call took.
    routes = {"mha": 0, "mha_reference": 0, "heads": []}
    for name in ("mha", "mha_reference"):
        fn = getattr(attention, name)

        def counted(q, *a, _fn=fn, _name=name, **kw):
            routes[_name] += 1
            if _name == "mha":
                routes["heads"].append(q.shape[2])
            return _fn(q, *a, **kw)

        setattr(attention, name, counted)

    def reset_routes():
        routes.update(mha=0, mha_reference=0, heads=[])

    result = {"rank": rank, "losses": {}, "routes": {}, "moment_placements_match": True}
    for layout, sizes in LAYOUTS.items():
        mesh = pmesh.make_mesh(pmesh.MeshConfig(**sizes), device="cpu")
        for tok_name, toks in tokens.items():
            if layout == "tp4" and tok_name == "zeros":
                continue
            params = transformer.distribute(full, config, mesh)
            opt = train.make_optimizer(params)
            reset_routes()
            local = sharding.shard_batch(torch.from_numpy(toks), mesh)
            loss = train.train_step(params, opt, local, config, "cpu", mesh)
            result["losses"][f"{layout}_{tok_name}"] = loss.item()
            result["routes"][f"{layout}_{tok_name}"] = dict(routes, heads=list(routes["heads"]))
            grads = {k: (v.grad.full_tensor()).numpy() for k, v in _flat(params).items()}
            if rank == 0:
                np.savez(os.path.join(workdir, f"grads_{layout}_{tok_name}.npz"), **grads)
            _, opt_pl = train.shardings_for(config, mesh)
            placed = _flat(opt_pl["exp_avg"])
            for path, p in _flat(params).items():
                st, pl = opt.state[p], placed[path]
                result["moment_placements_match"] &= (
                    tuple(st["exp_avg"].placements) == tuple(pl) == tuple(p.placements)
                    and tuple(st["exp_avg_sq"].placements) == tuple(pl))

    # sharded_mha on both sides of its gate, against the whole computation.
    mesh = pmesh.make_mesh(pmesh.MeshConfig(fsdp=2, tp=2), device="cpu")
    gen = torch.Generator().manual_seed(5)
    b, s, d = 4, 256, 32
    errs = {}
    for heads, kv in ((4, 2), (4, 1)):  # tp | kv_heads, and not
        q = torch.randn(b, s, heads * d, generator=gen)
        k = torch.randn(b, s, kv * d, generator=gen)
        v = torch.randn(b, s, kv * d, generator=gen)
        pos = torch.arange(s)

        def rot(t):
            return transformer.rope(t, pos, config.rope_theta)

        want = attention.mha_reference(rot(q.reshape(b, s, heads, d)), rot(k.reshape(b, s, kv, d)),
                                       v.reshape(b, s, kv, d)).reshape(b, s, heads * d)
        tp_r, width = mesh.get_local_rank("tp"), heads * d // 2
        kvw = kv * d // 2

        def cols(t, w):
            return sharding.shard_batch(t, mesh)[:, :, tp_r * w:(tp_r + 1) * w]

        reset_routes()
        got = sharding.sharded_mha(cols(q, width), cols(k, kvw), cols(v, kvw), mesh, heads, kv,
                                   rotary=rot)
        ref = cols(want, width)
        errs[f"h{heads}_kv{kv}"] = {"max_err": (got - ref).abs().max().item(),
                                   "gate": sharding.mha_shardable(b, heads, kv, mesh),
                                   "routes": dict(routes, heads=list(routes["heads"]))}
    result["sharded_mha"] = errs

    table = torch.randn(config.vocab_size, config.d_model, generator=gen)
    toks = torch.randint(0, config.vocab_size, (4, 16), generator=gen)
    pmesh_ = sharding.param_mesh(mesh)
    local_table = sharding.local_shard(table, sharding.placements_for(("vocab", "embed"), pmesh_),
                                       pmesh_)
    got = sharding.embed_lookup(local_table, sharding.shard_batch(toks, mesh), mesh)
    result["embed_equal"] = bool(torch.equal(got, sharding.shard_batch(table[toks], mesh)))

    # A one-process checkpoint restored into fsdp2 x tp2, a step, a save.
    params = transformer.distribute(transformer.init(config, torch.Generator().manual_seed(9),
                                                     "cpu", torch.float32), config, mesh)
    opt = train.make_optimizer(params)
    ckpt = checkpoint.TrainCheckpointer(os.path.join(workdir, "ckpt_one"))
    _, _, step = ckpt.restore(params, opt)
    arrays = _state_arrays(params, opt)
    if rank == 0:
        np.savez(os.path.join(workdir, "restored.npz"), **arrays)
    local = sharding.shard_batch(torch.from_numpy(tokens["rng"]), mesh)
    result["loss_after_restore"] = train.train_step(params, opt, local, config, "cpu", mesh).item()
    checkpoint.TrainCheckpointer(os.path.join(workdir, "ckpt_gang")).save(step + 1, params, opt)
    arrays = _state_arrays(params, opt)
    if rank == 0:
        np.savez(os.path.join(workdir, "gang_state.npz"), **arrays)
    result["restored_step"] = step
    return result


def one(workdir):
    """A one-rank gloo mesh: the sharded init and two sharded steps against
    the unsharded ones, bit for bit."""
    import numpy as np
    import torch

    from hivedscheduler_tpu_torch.models import train, transformer
    from hivedscheduler_tpu_torch.parallel import mesh as pmesh
    from hivedscheduler_tpu_torch.parallel import sharding

    config = transformer.tiny()
    mesh = pmesh.make_mesh(pmesh.MeshConfig(), device="cpu")
    toks = torch.from_numpy(dict(np.load(os.path.join(workdir, "tokens.npz")))["rng"])
    ref = transformer.init(config, torch.Generator().manual_seed(0), "cpu", torch.float32)
    ref_opt = train.make_optimizer(ref)
    params, opt = train.init_sharded(config, mesh, torch.Generator().manual_seed(0), "cpu")
    init_equal = all(torch.equal(a, b.to_local()) for a, b in
                     zip(transformer.leaves(ref), transformer.leaves(params)))
    step = train.make_train_step(config, mesh, opt)
    ref_losses, losses = [], []
    for _ in range(2):
        ref_losses.append(train.train_step(ref, ref_opt, toks, config, "cpu"))
        losses.append(step(params, sharding.shard_batch(toks, mesh)))
    return {
        "init_equal": init_equal,
        "losses_equal": all(torch.equal(a, b) for a, b in zip(ref_losses, losses)),
        "params_equal": all(torch.equal(a, b.to_local()) for a, b in
                            zip(transformer.leaves(ref), transformer.leaves(params))),
        "losses": [x.item() for x in losses],
    }


def main() -> None:
    mode, rank, world, port, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
        sys.argv[4], sys.argv[5]

    import torch.distributed as dist

    from tests._torch_rendezvous import cpu_rank, join

    cpu_rank()
    join(port, world, rank)  # a client of the test's store
    try:
        out = gang(rank, workdir) if mode == "gang" else one(workdir)
    finally:
        dist.destroy_process_group()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
