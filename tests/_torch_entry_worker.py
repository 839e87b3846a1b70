"""Worker process for the port's multi-process entry-point tests (gloo).

    python _torch_entry_worker.py train|train_pp|serve <rank> <world> <port> <arg>...
    python -m tests._torch_entry_worker launched|launched_pp <arg>...
    python -m tests._torch_entry_worker fail-or-hang

``train``/``train_pp``/``serve`` write the gang's env block (the keys the
scheduler emits, coordinator on loopback) into ``HIVED_TPU_ENV`` and run
``train.main``, ``workloads/train_pp.main`` or ``serve.main`` on the CPU
with the remaining arguments. ``launched`` (``launched_pp``) runs
``train.main`` (``train_pp.main``) in the environment the pod's launcher
(``workloads/launch.py``) gave it. Each prints one JSON line (a launched
rank writes it to ``rank<r>.json`` in ``$ENTRY_WORKER_OUT``): the rank,
the losses of each step or each request's tokens (this rank's rows), the
world size. ``fail-or-hang`` exits 3 as rank 1 and sleeps as any other rank.

Every process is a CPU rank of a test gang (``_torch_rendezvous.cpu_rank``:
one thread, deterministic algorithms), as every gang worker is: the tests
hold two gangs' losses equal with ``==``. So that a parting names where
it starts, every training mode's line also holds ``digests``
of this rank's first step, which ``parting_leaf`` compares across gangs:
its batch, each parameter leaf before it, each block's output in it (in
call order, a checkpointed block's recompute included), and each leaf and
its gradient after it (``leaf_digests``); and ``mesh``, the axes and the
global ranks of the mesh the step ran on.

``<port>`` is the port of a store the test holds (``_torch_rendezvous``):
every rank joins it as a client (``AGENT_STORE``), also when it boots
through the port's ``initialize_from_env``.
"""

import hashlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# The environment variable naming the directory where a launched rank
# writes its result (``launched``).
OUT_DIR = "ENTRY_WORKER_OUT"


def _named(tree, path=()):
    """(name, leaf) of a parameter tree of dicts and lists, in the model's
    (insertion) order, as ``transformer.leaves`` walks it."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in items:
            yield from _named(v, path + (str(k),))
    else:
        yield "/".join(path), tree


def _digest(t):
    """The first 16 hex digits of the sha256 of this rank's shard's bits."""
    import torch

    if t is None:
        return None
    t = t.to_local() if hasattr(t, "to_local") else t
    raw = t.detach().contiguous().reshape(-1).view(torch.uint8).numpy()
    return hashlib.sha256(raw.tobytes()).hexdigest()[:16]


def leaf_digests(params) -> dict:
    """{leaf name: {"param": digest, "grad": digest}} of this rank's shards,
    in the model's order (the step leaves its gradients in ``.grad``)."""
    return {name: {"param": _digest(t), "grad": _digest(t.grad)} for name, t in _named(params)}


def _partings(mine, theirs):
    """Where two ranks' ``digests`` part, in the order the step makes them."""
    yield "batch", mine["batch"] != theirs["batch"]
    for name, d in mine["init"].items():
        yield f"{name} before the step", d != theirs["init"][name]
    for i, d in enumerate(mine["blocks"]):
        yield f"block call {i}'s output", d != theirs["blocks"][i]
    for name, d in mine["leaves"].items():
        for kind in ("grad", "param"):
            yield f"{name} ({kind}) after the step", d[kind] != theirs["leaves"][name][kind]


def parting_leaf(gang, ref) -> str:
    """The first place, in the order the first step makes them, where the
    digests of two gangs' ranks of the same rank (each a list of their
    ranks' JSON lines) differ, with both ranks' meshes; or that none does."""
    ref = {o["rank"]: o for o in ref}
    for o in sorted(gang, key=lambda o: o["rank"]):
        theirs = ref[o["rank"]]
        for where, parted in _partings(o["digests"], theirs["digests"]):
            if parted:
                return (f"rank {o['rank']} first parts at {where} "
                        f"(meshes {o['mesh']}, {theirs['mesh']})")
    return "every rank's first step equal"


def _train_losses(mode, argv, digests):
    """The losses of the mode's training run; ``digests`` receives this
    rank's digests of its first step and ``mesh`` its mesh."""
    from hivedscheduler_tpu_torch import train
    from hivedscheduler_tpu_torch.models import train as model_train
    from hivedscheduler_tpu_torch.models import transformer
    from hivedscheduler_tpu_torch.workloads import train_pp

    step = model_train.captured_step  # both entry points take the step from here
    block = transformer._block
    blocks = []

    def recorded_block(*args, **kwargs):
        out = block(*args, **kwargs)
        if "blocks" not in digests:
            blocks.append(_digest(out))
        return out

    def first_digested(params, optimizer, tokens, config, device, mesh):
        first = "leaves" not in digests
        if first:
            digests["batch"] = _digest(tokens)
            digests["init"] = {name: _digest(t) for name, t in _named(params)}
            digests["mesh"] = (None if getattr(mesh, "mesh_dim_names", None) is None else
                               {"axes": list(mesh.mesh_dim_names), "ranks": mesh.mesh.tolist()})
        loss = step(params, optimizer, tokens, config, device, mesh)
        if first:
            digests["blocks"] = list(blocks)
            digests["leaves"] = leaf_digests(params)
        return loss

    transformer._block = recorded_block
    model_train.captured_step = first_digested
    if mode.endswith("_pp"):
        return [r["loss"] for r in train_pp.main(argv + ["--device", "cpu"])]
    return [r["loss"] for r in train.main(argv + ["--device", "cpu"]).records]


def launched(mode, argv) -> None:
    import torch.distributed as dist

    from tests._torch_rendezvous import cpu_rank

    cpu_rank()

    digests = {}
    try:
        out = {"losses": _train_losses(mode, argv, digests), "digests": digests}
        out["mesh"] = digests.pop("mesh")
        out["rank"], out["world"] = dist.get_rank(), dist.get_world_size()
        out["env"] = {k: os.environ.get(k) for k in
                      ("RANK", "LOCAL_RANK", "WORLD_SIZE", "CUDA_VISIBLE_DEVICES", "JAX_NUM_PROCESSES")}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    # A file of its own: a pod's children share the launcher's stdout pipe.
    path = os.path.join(os.environ[OUT_DIR], f"rank{out['rank']}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(path + ".tmp", path)


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

    from tests._torch_rendezvous import AGENT_STORE, cpu_rank

    os.environ.update(AGENT_STORE)  # rank 0 too joins the test's store
    cpu_rank()

    from hivedscheduler_tpu_torch import serve

    digests = {}
    try:
        if mode in ("train", "train_pp"):
            out = {"losses": _train_losses(mode, argv, digests), "digests": digests}
            out["mesh"] = digests.pop("mesh")
        else:
            out = {"tokens": [r["tokens"].tolist() for r in serve.main(argv + ["--device", "cpu"])]}
        out["rank"], out["world"] = dist.get_rank(), dist.get_world_size()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
