"""Where a ResNet twin step's time goes, on one card or on each rank of a
dp gang: the forward (and how much of it the host took to issue), the
backward, the gradients' reduction over the batch axes and the optimizer,
each closed by a device sync. The syncs cost the overlap a real step has,
so the sum is a little above the twin's step time. Run as::

    python -m hivedscheduler_tpu_torch.tools.step_breakdown            # one card
    python -m hivedscheduler_tpu_torch.workloads.launch --bind-info FILE -- \\
        hivedscheduler_tpu_torch.tools.step_breakdown                  # a gang

The twin's model, optimizer, seeds and batch (``--batch`` images a card,
``--image-size``); one batch, reused. Prints one JSON line a step and
rank.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..models import resnet, transformer
from ..parallel import mesh as pmesh
from ..parallel import sharding
from ..workloads import train_resnet
from ..workloads.common import bootstrap_distributed, lift_env_block


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--batch", type=int, default=train_resnet.ROWS_PER_CARD)
    parser.add_argument("--image-size", type=int, default=train_resnet.IMAGE_SIZE)
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)
    lift_env_block()
    device = resolve_device(args.device)
    rank = bootstrap_distributed(device)
    n = pmesh.world_size()
    mesh = pmesh.make_mesh(pmesh.MeshConfig(dp=n), device)
    config = resnet.ResNetConfig()
    params, stats = resnet.init(config, torch.Generator(device=device).manual_seed(0), device)
    if sharding.is_active(mesh):
        params = resnet.distribute(params, mesh)
    optimizer = train_resnet.make_optimizer(params)
    images, labels = train_resnet.synthetic_batch(np.random.default_rng(1), args.batch * n,
                                                  args.image_size, config.num_classes)
    if sharding.is_active(mesh):
        images, labels = (sharding.shard_batch(t, mesh) for t in (images, labels))
    images, labels = images.to(device), labels.to(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for i in range(args.steps):
        sync()
        t0 = time.perf_counter()
        optimizer.zero_grad(set_to_none=True)
        loss, stats = resnet.loss_fn(params, stats, images, labels, config, mesh=mesh)
        issued = time.perf_counter()
        sync()
        t1 = time.perf_counter()
        loss.backward()
        sync()
        t2 = time.perf_counter()
        if sharding.is_active(mesh):
            sharding.reduce_gradients(transformer.leaves(params), mesh)
        sync()
        t3 = time.perf_counter()
        optimizer.step()
        sync()
        t4 = time.perf_counter()
        print(json.dumps({"world": n, "rank": rank, "step": i, "batch_per_card": args.batch,
                          "forward_ms": (t1 - t0) * 1e3, "forward_host_ms": (issued - t0) * 1e3,
                          "backward_ms": (t2 - t1) * 1e3, "reduce_gradients_ms": (t3 - t2) * 1e3,
                          "optimizer_ms": (t4 - t3) * 1e3, "total_ms": (t4 - t0) * 1e3}),
              flush=True)


if __name__ == "__main__":
    main()
