"""The control on the card at a cell's own size (``pytest -m cuda
port_bench/tests``): the program's run comes out correct and the control's
(the reference computed in float8, in the program's place) does not.
Skips without a card, decided inside each test."""

import time

import pytest
import torch

from port_bench import compare, harness

TRAIN = ["mixtral-train-4x4k", "bert-train-64x512"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _judge(cell, variant, seconds=0.0, seed=2026):
    device = _card()
    c = harness.find_cell(cell)
    r = harness.Run(c, seed, seconds, False, device, time.perf_counter(), variant)
    outcome = harness.driver(c).run(r)
    return compare.judge(outcome.numbers, harness.limits(c))[0]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", TRAIN)
def test_training_control_at_the_cells_size(cell):
    assert _judge(cell, "")
    assert not _judge(cell, "fp8")

