"""The reference's training steps: a family's plain loss, autograd and
plain AdamW, in f32 (or the control's precision), from the same weights and
batches as the program."""

from __future__ import annotations

from typing import Dict, List

import torch

from .. import inputs
from .common import Precision, adamw, exact_f32


class Trainer:
    """The reference in a training cell: ``step(batch)`` returns the loss;
    ``fault="half_batch"`` (a fault read against the limits) takes the mean
    over the first half of each batch's rows."""

    def __init__(self, family, cfg: Dict, params: Dict, precision: str = "f32",
                 fault: str = ""):
        self.family, self.cfg, self.params = family, cfg, params
        self.prec = Precision(precision)
        self.fault = fault
        self.names = [n for n, _ in inputs.flat(params)]
        self.leaves: List[torch.Tensor] = [t.requires_grad_(True) for _, t in inputs.flat(params)]
        self.opt = adamw(self.leaves, cfg)

    def step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if self.fault == "half_batch":
            batch = inputs.half(batch)
        with exact_f32():
            for p in self.leaves:
                p.grad = None
            loss = self.family.loss(self.params, batch, self.cfg, self.prec)
            loss.backward()
            self.opt.step([p.grad for p in self.leaves])
        return loss.detach()

    def moments(self) -> List[torch.Tensor]:
        """Each leaf's first moment as it stands."""
        return list(self.opt.m)

    def first_grad(self, i: int) -> torch.Tensor:
        """Leaf ``i``'s first gradient, from the first moment after one step."""
        return self.opt.m[i] / (1 - self.opt.betas[0])

    def step_grad(self, i: int, before: torch.Tensor) -> torch.Tensor:
        """Leaf ``i``'s gradient of the last step, from its first moment
        ``before`` that step and after it."""
        m, b1 = self.opt.m[i], self.opt.betas[0]
        return (m - b1 * before.to(m.device)) / (1 - b1)

    def close(self) -> None:
        for p in self.leaves:
            p.grad = None
        self.leaves, self.params, self.opt = [], {}, None
