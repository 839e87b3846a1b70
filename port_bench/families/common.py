"""What every family's trainer shares: the port's parameter tree and
optimizer, the readings the comparison takes from them, and the counters
that show no capture inside a window."""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from hivedscheduler_tpu_torch.models import train as port_train
from hivedscheduler_tpu_torch.ops import attention

from .. import inputs


def launches() -> Dict[str, int]:
    """The port's flash-kernel launch counters (a graph's replay adds what
    its capture recorded)."""
    return attention.kernel_launches()


def captures() -> Dict[str, int]:
    """The port's capture and replay counters of training steps."""
    return {"train_captures": port_train.StepGraphs.captures,
            "train_replays": port_train.StepGraphs.replays}


def require(what: str, stated, runs) -> None:
    """The program has to run as the configuration states it."""
    same = math.isclose(stated, runs, rel_tol=1e-12) if isinstance(stated, float) else stated == runs
    if not same:
        raise ValueError(f"the configuration states {what} {stated!r}; the port runs {runs!r}")


def check_adamw(opt: torch.optim.Optimizer, cfg: Dict) -> None:
    o, g = cfg["optimizer"], opt.param_groups[0]
    require("lr", o["lr"], g["lr"])
    require("betas", (o["b1"], o["b2"]), tuple(g["betas"]))
    require("eps", o["eps"], g["eps"])
    require("weight_decay", o["weight_decay"], g["weight_decay"])


class Trainer:
    """A family's training step over the port's tree: ``step(batch)`` runs
    one step through the family's entry point and returns its loss."""

    def __init__(self, params: Dict, opt: torch.optim.Optimizer):
        self.params, self.opt = params, opt
        self.names = [n for n, _ in inputs.flat(params)]
        self.leaves: List[torch.Tensor] = [t for _, t in inputs.flat(params)]

    def step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def _moment(self, i: int) -> torch.Tensor:
        return self.opt.state[self.leaves[i]]["exp_avg"]

    def moments(self) -> List[torch.Tensor]:
        """Each leaf's first moment as it stands."""
        return [self._moment(i) for i in range(len(self.leaves))]

    def first_grad(self, i: int) -> torch.Tensor:
        """Leaf ``i``'s first gradient as the optimizer got it: its first
        moment after one step over (1 - b1)."""
        b1 = self.opt.param_groups[0]["betas"][0]
        return self._moment(i) / (1 - b1)

    def step_grad(self, i: int, before: torch.Tensor) -> torch.Tensor:
        """Leaf ``i``'s gradient of the last step as the optimizer got it,
        from its first moment ``before`` that step and after it."""
        b1 = self.opt.param_groups[0]["betas"][0]
        m = self._moment(i)
        return (m - b1 * before.to(m.device)) / (1 - b1)

    def close(self) -> None:
        """Drop the tree and the optimizer: the port's captured graphs go
        with them."""
        self.params, self.opt, self.leaves = {}, None, []
