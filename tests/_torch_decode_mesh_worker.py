"""Worker process for the captured decode step on a mesh (gloo, on the CPU).

    python _torch_decode_mesh_worker.py <rank> <world> <port> <workdir>

Reads from ``workdir``: ``dense.npz`` and ``mixtral.npz`` (the tiny
models' f32 parameters from the JAX package's init, keys joined by "/")
and ``prompts.npy`` ([2, B, T]: the first and the second request). The
CUDA graph capture is stood in for as ``test_torch_decode_graph.py`` does:
``generate._graphed`` is True and ``generate._capture`` runs the step
again at each replay, so the owner of the captured steps
(``generate.decoder``) takes its mesh path on the CPU, collectives and
all. For each case of ``CASES`` it places the tree on the case's mesh,
serves both requests through the owner and through the eager mesh loop
(``plain=True``), drives ``decode_step`` through the owner's cache and
drops a tree to see its owner go. Prints one JSON line.
"""

import gc
import json
import os
import sys
import weakref

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# name -> (mesh sizes, tree: "dense", "int8" or "mixtral", sampled)
CASES = {
    "fsdp2_tp2-dense-greedy": ({"fsdp": 2, "tp": 2}, "dense", False),
    "fsdp2_tp2-dense-sampled": ({"fsdp": 2, "tp": 2}, "dense", True),
    "fsdp2_tp2-int8-greedy": ({"fsdp": 2, "tp": 2}, "int8", False),
    "tp4-dense-greedy": ({"tp": 4}, "dense", False),
    "tp4-dense-sampled": ({"tp": 4}, "dense", True),
    "tp4-int8-greedy": ({"tp": 4}, "int8", False),
    "fsdp2_ep2-mixtral-greedy": ({"fsdp": 2, "ep": 2}, "mixtral", False),
}
NEW_TOKENS = 8
DECODE_STEPS = 3
SAMPLING = {"temperature": 0.8, "top_k": 40, "top_p": 0.9}


def rerun_capture(fn, restore):
    """``generate._capture`` on the CPU: a warm-up run, then a replay that
    runs ``fn`` again and writes its output into the same tensor."""
    static = fn().clone()
    restore()

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


def case(workdir, sizes, kind, sampled):
    import numpy as np
    import torch

    from hivedscheduler_tpu_torch.models import convert, generate, mixtral, quantize, transformer
    from hivedscheduler_tpu_torch.parallel import mesh as pmesh
    from hivedscheduler_tpu_torch.parallel import sharding

    mesh = pmesh.make_mesh(pmesh.MeshConfig(**sizes), "cpu")
    family = mixtral if kind == "mixtral" else transformer
    config = family.tiny()
    axes = family.logical_axes(config)
    source = "mixtral" if kind == "mixtral" else "dense"
    masters = _unflat(dict(np.load(os.path.join(workdir, f"{source}.npz"))))

    def tree():
        placed = convert.params_from_jax(masters, "cpu", mesh=mesh, axes=axes)
        return quantize.quantize_params(placed, axes) if kind == "int8" else placed

    params = tree()
    ffn = mixtral.decode_ffn(config) if kind == "mixtral" else None
    prompts = [sharding.shard_batch(torch.from_numpy(p), mesh)
               for p in np.load(os.path.join(workdir, "prompts.npy"))]
    b, t = prompts[0].shape

    def run(prompt, plain):
        # One stream a batch shard: the ranks of a tp or ep group sample alike.
        gen = torch.Generator().manual_seed(7 + sharding.batch_rank(mesh)) if sampled else None
        out = generate.generate(params, prompt, config, NEW_TOKENS, generator=gen, ffn=ffn,
                                plain=plain, mesh=mesh, **(SAMPLING if sampled else {}))
        return out[:, t:].tolist()

    graph, counts = [], []
    for prompt in prompts:
        captures, replays = generate.Decoder.captures, generate.Decoder.replays
        graph.append(run(prompt, False))
        counts.append((generate.Decoder.captures - captures, generate.Decoder.replays - replays))
    plain = [run(prompt, True) for prompt in prompts]
    owner = generate.decoder(params, config, mesh)
    cache_shape = list(owner._slots[(b, t + NEW_TOKENS)].cache.k.shape)

    # decode_step through the owner's cache, against the eager step on a
    # cache of init_cache's; a cache the owner did not make is refused.
    cache = owner.init_cache(b, t + DECODE_STEPS)
    logits, cache = generate.prefill(params, prompts[0], cache, config, mesh=mesh, ffn=ffn)
    other = generate.init_cache(config, b, t + DECODE_STEPS, "cpu", mesh)
    _, other = generate.prefill(params, prompts[0], other, config, mesh=mesh, ffn=ffn)
    token, step_equal, refused = logits.argmax(-1), True, True
    for _ in range(DECODE_STEPS):
        logits, cache = generate.decode_step(params, token, cache, config, mesh, ffn)
        try:
            generate.decode_step(params, token, other, config, mesh, ffn)
            refused = False
        except ValueError:
            pass
        ref, other = generate._forward_cached(params, token[:, None], other, config, mesh=mesh,
                                              ffn=ffn)
        step_equal &= torch.equal(logits, ref[:, 0])
        token = logits.argmax(-1)

    # The owner goes with the weights: one DTensor leaf freed is enough.
    fresh = tree()
    generate.generate(fresh, prompts[0], config, 3, ffn=ffn, mesh=mesh)
    ref_owner = weakref.ref(generate.decoder(fresh, config, mesh))
    live = len(generate._DECODERS)
    del fresh["layers"]["wq"]
    gc.collect()
    return {
        "batch_rank": sharding.batch_rank(mesh),
        "heads_local": generate._heads_local(config, b, mesh),
        "graph": graph, "plain": plain, "counts": counts, "cache_shape": cache_shape,
        "decode_step_equal": step_equal, "decode_step_refused_other_cache": refused,
        "decode_step_fill": [cache.issued, int(cache.length)],
        "owner_gone": ref_owner() is None and len(generate._DECODERS) == live - 1,
    }


def main() -> None:
    rank, world, port, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]

    import torch.distributed as dist

    from tests._torch_rendezvous import cpu_rank, join

    from hivedscheduler_tpu_torch.models import generate

    cpu_rank()
    generate._graphed = lambda x: True
    generate._capture = rerun_capture
    join(port, world, rank)  # a client of the test's store
    try:
        out = {"rank": rank,
               "cases": {name: case(workdir, *spec) for name, spec in CASES.items()}}
    finally:
        dist.destroy_process_group()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
