"""Worker process for the captured training step on a mesh (gloo, on the CPU).

    python _torch_train_graph_mesh_worker.py <rank> <world> <port> <workdir>

Reads from ``workdir``: ``llama.npz`` (the tiny dense model's f32
parameters from the JAX package's init, keys joined by "/") and
``tokens.npz`` (``steps``: [STEPS, B, S] global token batches). The CUDA
graph capture is stood in for as ``test_torch_train_graph.py`` does:
``train._graphed`` is True and ``train._capture`` runs nothing at the
capture and the step again at each replay, so each model's
``captured_step`` takes its owner's path on a mesh, collectives and all.
As on the card, every Adam is capturable (``train.capturable`` says so for
the card's leaves; here it is made to, and the CPU is let through Adam's
supported-device check): its step count is a tensor on the leaves'
device. For each case of ``CASES`` it places fresh weights on the case's
mesh, takes STEPS eager gang steps (each twin's ``train_step``), then
STEPS owner steps from fresh weights of the same seed. Prints one JSON
line: each case's losses, the digests of the parameters (with ResNet's
running statistics) and of the last step's gradients on both sides, and
the owner's captures and replays.
"""

import functools
import importlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# name -> (mesh sizes, model); "llama_ulysses": the tiny Llama with
# sp_mode "ulysses" (on the CPU "auto" takes ring), its attention over sp
# two all-to-alls a tensor through Ulysses' exchange, forward and backward.
CASES = {
    "llama-fsdp2_tp2": ({"fsdp": 2, "tp": 2}, "llama"),
    "llama_ulysses-sp2_tp2": ({"sp": 2, "tp": 2}, "llama_ulysses"),
    "llama-dp2_fsdp2": ({"dp": 2, "fsdp": 2}, "llama"),
    "llama-tp4": ({"tp": 4}, "llama"),
    "mixtral-fsdp2_ep2": ({"fsdp": 2, "ep": 2}, "mixtral"),
    "bert-dp2_tp2": ({"dp": 2, "tp": 2}, "bert"),
    "resnet_f64-dp4": ({"dp": 4}, "resnet_f64"),
    "pipeline-pp2_tp2": ({"pp": 2, "tp": 2}, "pipeline"),
}
STEPS = 3
B, S = 4, 64
MOE_S = 32  # Mixtral's rows: its step costs the most here
RESNET = {"classes": 10, "width": 16, "batch": 4, "size": 32}  # a row a rank


def rerun_capture(fn, dtype):
    """``train._capture`` on the CPU: nothing runs at the capture (a real
    one executes nothing on the card); each replay runs ``fn`` again and
    writes its loss (of ``dtype``) into the graph's output tensor."""
    import torch

    static = torch.zeros((), dtype=dtype)

    def replay():
        static.copy_(fn())

    return replay, static


def _unflat(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, last = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def model_steps(workdir, sizes, kind):
    """(mesh, make() -> (params, optimizer, state), step(fn, params,
    optimizer, state, i) -> (loss, state), the eager and the captured step
    functions, the loss's dtype)."""
    import dataclasses

    import numpy as np
    import torch

    from hivedscheduler_tpu_torch.models import bert, convert, mixtral, resnet, train, transformer
    from hivedscheduler_tpu_torch.parallel import mesh as pmesh
    from hivedscheduler_tpu_torch.parallel import sharding
    from hivedscheduler_tpu_torch.workloads import train_bert, train_mixtral, train_resnet

    mesh = pmesh.make_mesh(pmesh.MeshConfig(**sizes), "cpu")
    tokens = np.load(os.path.join(workdir, "tokens.npz"))["steps"]

    def local(t):
        return sharding.shard_batch(torch.from_numpy(np.asarray(t)), mesh)

    if kind in ("llama", "llama_ulysses", "pipeline"):
        config = transformer.tiny()
        if kind == "llama_ulysses":
            config = dataclasses.replace(config, sp_mode="ulysses")
        if kind == "pipeline":
            config = dataclasses.replace(config, pp_microbatches=2, remat=True,
                                         remat_policy="flash")
        masters = _unflat(dict(np.load(os.path.join(workdir, "llama.npz"))))

        def make():
            params = convert.params_from_jax(masters, "cpu", mesh=mesh,
                                             axes=transformer.logical_axes(config))
            return params, train.make_optimizer(params), None

        def step(fn, p, o, s, i):
            return fn(p, o, local(tokens[i]), config, "cpu", mesh), s

        return mesh, make, step, train.train_step, train.captured_step, torch.float32
    if kind == "mixtral":
        config = mixtral.tiny()

        def make():
            gen = torch.Generator().manual_seed(2)
            params = train.init_sharded(config, mesh, gen, "cpu", model=mixtral)[0]
            return params, train_mixtral.make_optimizer(params), None

        def step(fn, p, o, s, i):
            return fn(p, o, local(tokens[i, :, :MOE_S]), config, mesh), s

        return (mesh, make, step, train_mixtral.train_step, train_mixtral.captured_step,
                torch.float32)
    if kind == "bert":
        config = bert.tiny()

        def make():
            params = bert.init_sharded(config, mesh, torch.Generator().manual_seed(1), "cpu")
            return params, train_bert.make_optimizer(params), None

        def step(fn, p, o, s, i):
            toks, targets = train_bert.masked_batch(np.random.default_rng(i), B, S,
                                                    config.vocab_size)
            return fn(p, o, local(toks), local(targets), config, mesh), s

        return mesh, make, step, train_bert.train_step, train_bert.captured_step, torch.float32
    config = resnet.ResNetConfig(RESNET["classes"], RESNET["width"], torch.float64)

    def make():
        params, stats = resnet.init(config, torch.Generator().manual_seed(3), "cpu")
        params, stats = (convert.params_from_jax(convert.params_to_numpy(t), "cpu", torch.float64)
                         for t in (params, stats))
        params = resnet.distribute(params, mesh)
        return params, train_resnet.make_optimizer(params), stats

    def step(fn, p, o, s, i):
        images, labels = train_resnet.synthetic_batch(
            np.random.default_rng(i), RESNET["batch"], RESNET["size"], config.num_classes)
        return fn(p, s, o, local(images.double()), local(labels), config, mesh)

    return (mesh, make, step, train_resnet.train_step, train_resnet.captured_step,
            torch.float64)


def case(workdir, sizes, kind):
    import torch

    from hivedscheduler_tpu_torch.models import train, transformer

    mesh, make, step, eager, captured, dtype = model_steps(workdir, sizes, kind)
    train._capture = functools.partial(rerun_capture, dtype=dtype)

    def trajectory(fn):
        params, opt, state = make()
        losses = []
        for i in range(STEPS):
            loss, state = step(fn, params, opt, state, i)
            losses.append(float(loss))
        grads = [p.grad for p in transformer.leaves(params)]
        return {"losses": losses,
                "digest": train.tree_digest([params] if state is None else [params, state]),
                "grads_digest": train.tree_digest([g for g in grads if g is not None]),
                "grads": sum(g is not None for g in grads)}, params, opt

    ref, _, _ = trajectory(eager)
    captures, replays = train.StepGraphs.captures, train.StepGraphs.replays
    got, params, opt = trajectory(captured)
    owner = train.step_graphs(params, opt)
    keys = [k for k, _ in owner._graphs]
    return {
        "eager": ref, "owner": got,
        "captures": train.StepGraphs.captures - captures,
        "replays": train.StepGraphs.replays - replays,
        "keyed_by_mesh": len(keys) == 1 and keys[0][-1] is mesh,
        "capturable": all(g.get("capturable", False) for g in opt.param_groups)
        if isinstance(opt, torch.optim.Adam | torch.optim.AdamW) else None,
    }


def main() -> None:
    rank, world, port, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]

    import torch.distributed as dist

    from tests._torch_rendezvous import cpu_rank, join

    from hivedscheduler_tpu_torch.models import train

    cpu_rank()
    adam = importlib.import_module("torch.optim.adam")
    adam._get_capturable_supported_devices = lambda supports_xla=True: ["cuda", "cpu"]
    train._graphed = lambda t: True
    train.capturable = lambda leaves, asked=None: True if asked is None else asked
    join(port, world, rank)  # a client of the test's store
    try:
        out = {"rank": rank, "cases": {name: case(workdir, *spec) for name, spec in CASES.items()}}
    finally:
        dist.destroy_process_group()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
