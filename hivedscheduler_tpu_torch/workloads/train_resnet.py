"""ResNet-50 data-parallel training on a pod's cards (BASELINE config 2).

Counterpart of ``example/workloads/train_resnet.py``::

    python -m hivedscheduler_tpu_torch.workloads.launch --bind-info FILE -- \\
        hivedscheduler_tpu_torch.workloads.train_resnet --steps 20

Mesh: dp = the gang's world size. ``ResNetConfig()`` (1000 classes, bf16
compute, f32 master weights) from seed 0; SGD with ``optax.sgd(0.1,
momentum=0.9)``'s update (trace = g + 0.9 * trace, p -= 0.1 * trace; the
trace starts at 0). Each step draws ``--batch`` images a card (32) of
``--image-size`` (224) from a normal and as many labels in [0, 1000), from
numpy seed 1 (the port keeps its own seeds; it does not re-implement
``jax.random``): every rank draws the global batch and keeps its rows, so a
gang and one card at the global batch see the same images. Batch norm's
statistics are the global batch's (``models/resnet.py``).

The reference's env knobs (``TRAIN_STEPS``, ``TRAIN_BATCH``,
``TRAIN_IMAGE_SIZE``) are the flags ``--steps``, ``--batch`` and
``--image-size``; ``--device`` as in the other twins. Each step prints
``step i loss x (ms, img/s, launches {...})``; the end prints one
``resnet summary {...}`` JSON line with the running stats' digest (equal on
every rank of a gang), how far they moved from (0, 1), the parameters'
digest, the losses, the captured graphs' counts (``graph``: captures,
replays, capture ms) and the peak device memory. On the card each step
replays the CUDA graph captured at the first (``captured_step``), on one
card or on each rank of the gang; ``--plain`` runs the eager step, its
plain version.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..models import resnet, train, transformer
from ..ops.attention import kernel_launches
from ..parallel import mesh as pmesh
from ..parallel import sharding
from .common import bootstrap_distributed, lift_env_block

ROWS_PER_CARD, IMAGE_SIZE, STEPS = 32, 224, 20


def make_optimizer(params: resnet.Params, learning_rate: float = 0.1) -> torch.optim.SGD:
    """SGD with ``optax.sgd(learning_rate, momentum=0.9)``'s update over
    every leaf (no dampening, no Nesterov, no decay). Marks every leaf as
    requiring grad."""
    leaves = transformer.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    return torch.optim.SGD(leaves, lr=learning_rate, momentum=0.9, dampening=0.0)


def train_step(params: resnet.Params, stats: resnet.Params, optimizer: torch.optim.Optimizer,
               images: torch.Tensor, labels: torch.Tensor, config: resnet.ResNetConfig,
               mesh: Any = None) -> Tuple[torch.Tensor, resnet.Params]:
    """One step: the loss with the batch's statistics, backward, SGD.
    Returns (loss, new_stats). On an active mesh ``images`` and ``labels``
    are this rank's rows; the loss (detached), the gradients and the new
    stats are the global batch's."""
    optimizer.zero_grad(set_to_none=True)
    loss, new_stats = resnet.loss_fn(params, stats, images, labels, config, train=True,
                                     mesh=mesh)
    loss.backward()
    if sharding.is_active(mesh):
        sharding.reduce_gradients(transformer.leaves(params), mesh)
        loss = sharding.mean_over_batch(loss, mesh)
    optimizer.step()
    return loss.detach(), new_stats


def captured_step(params: resnet.Params, stats: resnet.Params, optimizer: torch.optim.Optimizer,
                  images: torch.Tensor, labels: torch.Tensor, config: resnet.ResNetConfig,
                  mesh: Any = None) -> Tuple[torch.Tensor, resnet.Params]:
    """:func:`train_step` from the captured graph of ``params``' owner
    (``models/train.step_graphs``) for the batch's shape, ``images`` and
    ``labels`` its static inputs. The graph copies the new statistics into
    its stats tree, which it returns: ``stats`` itself at a shape's first
    call, which keeps its identity and holds each step's statistics (a
    later call that passes another tree has its values copied in first).
    On an active mesh the graph holds batch norm's sums over the batch
    axes, the gradients' reductions and the loss's mean. The eager step,
    which returns new tensors, for CPU parameters."""
    if not train._graphed(transformer.leaves(params)[0]):
        return train_step(params, stats, optimizer, images, labels, config, mesh)

    def step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        loss, new = train_step(params, stats, optimizer, x, y, config, mesh)
        torch._foreach_copy_(transformer.leaves(stats), transformer.leaves(new))
        return loss

    return train.step_graphs(params, optimizer).step(("resnet", config, mesh), step, params,
                                                     (images, labels), stats)


def synthetic_batch(rng: np.random.Generator, batch: int, size: int,
                    classes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(images [batch, size, size, 3] f32 from a normal, labels [batch])."""
    images = rng.standard_normal((batch, size, size, 3), dtype=np.float32)
    return torch.from_numpy(images), torch.from_numpy(rng.integers(0, classes, batch))


def stats_summary(stats: resnet.Params) -> Dict[str, Any]:
    """The running stats' sha256 over their bytes, and their largest |mean|
    and |var - 1| (0 and 0 before any training step)."""
    leaves = transformer.leaves(stats)  # each batch norm's mean, then its var
    digest = hashlib.sha256()
    for t in leaves:
        digest.update(t.detach().cpu().numpy().tobytes())
    return {"bn_stats_digest": digest.hexdigest(),
            "bn_mean_abs_max": max(float(t.abs().max()) for t in leaves[0::2]),
            "bn_var_dev_max": max(float((t - 1).abs().max()) for t in leaves[1::2])}


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, object]]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=STEPS)
    parser.add_argument("--batch", type=int, default=ROWS_PER_CARD, help="images a card")
    parser.add_argument("--image-size", type=int, default=IMAGE_SIZE)
    parser.add_argument("--device", default=None,
                        help="default cuda; 'cpu' runs on the CPU")
    parser.add_argument("--plain", action="store_true",
                        help="the eager step on the card too (the captured step's plain "
                             "version)")
    args = parser.parse_args(argv)

    lift_env_block()  # the card grant, before anything initialises CUDA
    device = resolve_device(args.device)
    bootstrap_distributed(device)
    n = pmesh.world_size()
    mesh = pmesh.make_mesh(pmesh.MeshConfig(dp=n), device)
    config = resnet.ResNetConfig()
    params, stats = resnet.init(config, torch.Generator(device=device).manual_seed(0), device)
    if sharding.is_active(mesh):
        params = resnet.distribute(params, mesh)
    optimizer = make_optimizer(params)
    batch = args.batch * n
    print(f"resnet-50: batch {batch} x {args.image_size}^2, dp {n} on {device}", flush=True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    rng = np.random.default_rng(1)
    records = []
    for i in range(args.steps):
        images, labels = synthetic_batch(rng, batch, args.image_size, config.num_classes)
        if sharding.is_active(mesh):
            images, labels = (sharding.shard_batch(t, mesh) for t in (images, labels))
        images, labels = images.to(device), labels.to(device)
        before = kernel_launches()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        step = train_step if args.plain else captured_step
        loss, stats = step(params, stats, optimizer, images, labels, config, mesh)
        loss = float(loss)
        seconds = time.perf_counter() - t0
        after = kernel_launches()
        rec = {"step": i, "loss": loss, "step_ms": seconds * 1e3,
               "images_per_s": batch / seconds,
               "launches": {k: after[k] - before[k] for k in after}}
        records.append(rec)
        print(f"step {i} loss {loss:.4f} ({rec['step_ms']:.1f} ms, "
              f"{rec['images_per_s']:.0f} img/s, launches {rec['launches']})", flush=True)
    summary = {**stats_summary(stats), "params_digest": train.tree_digest(params),
               "losses": [r["loss"] for r in records],
               "graph": {"captures": train.StepGraphs.captures,
                         "replays": train.StepGraphs.replays,
                         "capture_ms": train.StepGraphs.capture_s * 1e3}}
    if device.type == "cuda":
        summary["peak_memory_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    print("resnet summary " + json.dumps(summary), flush=True)
    return records


if __name__ == "__main__":
    main()
