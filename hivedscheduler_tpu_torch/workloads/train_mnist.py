"""A minimal MLP on synthetic MNIST-shaped data (BASELINE config 1).

Counterpart of ``example/workloads/train_mnist.py``::

    python -m hivedscheduler_tpu_torch.workloads.train_mnist [--device cpu]

A 784-256-10 MLP with ReLU (weights normal * 0.05, biases 0) on 512
synthetic rows (images from a normal, labels in [0, 10)), full-batch, with
Adam as ``optax.adam(1e-3)`` (betas 0.9 / 0.999, eps 1e-8 added to the
root, no decay). Weights and data come from numpy seed 0 (the port keeps
its own seeds). Prints every 20th step's loss, then ``done``. It launches
none of the port's kernels. ``--device cpu`` is the configuration's own
cell (one CPU socket); ``--steps`` defaults to the reference's 100. On the
card the whole batch is one graph's static input: the first step captures
it and every later step replays it (``captured_step``).
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..models import train

ROWS, STEPS = 512, 100


def init(rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """The MLP's f32 parameters: ``w1`` [784, 256], ``b1``, ``w2`` [256,
    10], ``b2``."""
    return {"w1": (rng.standard_normal((784, 256)) * 0.05).astype(np.float32),
            "b1": np.zeros(256, np.float32),
            "w2": (rng.standard_normal((256, 10)) * 0.05).astype(np.float32),
            "b2": np.zeros(10, np.float32)}


def synthetic_data(rng: np.random.Generator, rows: int = ROWS) -> Tuple[np.ndarray, np.ndarray]:
    """(images [rows, 784] f32, labels [rows] in [0, 10))."""
    return rng.standard_normal((rows, 784)).astype(np.float32), rng.integers(0, 10, rows)


def loss_fn(p: Dict[str, torch.Tensor], x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``y`` under the MLP's logits."""
    logits = F.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
    return -F.log_softmax(logits, dim=-1).gather(-1, y[:, None]).mean()


def make_optimizer(params: Dict[str, torch.Tensor], learning_rate: float = 1e-3
                   ) -> torch.optim.Adam:
    """Adam with ``optax.adam(learning_rate)``'s settings; marks every leaf
    as requiring grad. Capturable on CUDA leaves, as
    ``models/train.make_optimizer``."""
    leaves = list(params.values())
    for t in leaves:
        t.requires_grad_(True)
    return train.quiet_if_capturable(torch.optim.Adam(
        leaves, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
        capturable=train.capturable(leaves)))


def train_step(params: Dict[str, torch.Tensor], optimizer: torch.optim.Optimizer,
               x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(params, x, y)
    loss.backward()
    optimizer.step()
    return loss.detach()


def captured_step(params: Dict[str, torch.Tensor], optimizer: torch.optim.Optimizer,
                  x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """:func:`train_step` from the captured graph of ``params``' owner
    (``models/train.step_graphs``), ``x`` and ``y`` its static inputs; the
    eager step for CPU parameters."""
    if not train._graphed(next(iter(params.values()))):
        return train_step(params, optimizer, x, y)
    return train.step_graphs(params, optimizer).step(
        "mnist", lambda a, b: train_step(params, optimizer, a, b), params, (x, y))[0]


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=STEPS)
    parser.add_argument("--device", default=None, help="default cuda; 'cpu' runs on the CPU")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    params = {k: torch.from_numpy(v).to(device) for k, v in init(rng).items()}
    x, y = (torch.from_numpy(a).to(device) for a in synthetic_data(rng))
    optimizer = make_optimizer(params)
    losses = []
    for i in range(args.steps):
        losses.append(captured_step(params, optimizer, x, y))
        if i % 20 == 0:
            print(f"step {i} loss {float(losses[-1]):.4f}", flush=True)
    print("done", flush=True)
    return [float(t) for t in losses]


if __name__ == "__main__":
    main()
