"""A run of each cell at test size on the CPU, through its driver with the
look for a card skipped: sound, it comes out correct; with the timed path
broken underneath (each fault a cell can have), or with the control (the
reference computed in float8 in the program's place), not correct. A step
that hands the optimizer a stale gradient after the first step, as a graph
replay with stale buffers would, fails the last step's gradient."""

import pytest
import torch

from port_bench import inputs
from port_bench.tests import tiny

TRAIN = ["mixtral-train-4x4k", "bert-train-64x512"]


def _correct(cell, **kw):
    return tiny.judged(cell, tiny.run(cell, **kw))


@pytest.mark.parametrize("cell", TRAIN)
def test_a_sound_run_is_correct(cell):
    verdict = _correct(cell, seconds=0.2)
    assert verdict["correct"], verdict


def _family_trainer(cell):
    return tiny.harness.family(tiny.cell(cell)).Trainer


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_leaves_the_state_unchanged_is_not_correct(cell, monkeypatch):
    trainer = _family_trainer(cell)
    step = trainer.step

    def unchanged(self, batch):
        saved = [p.detach().clone() for p in self.leaves]
        loss = step(self, batch)
        with torch.no_grad():
            for p, s in zip(self.leaves, saved):
                p.copy_(s)
        return loss

    monkeypatch.setattr(trainer, "step", unchanged)
    verdict = _correct(cell)
    assert not verdict["correct"]
    assert verdict["checks"]["update_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", TRAIN)
def test_half_the_batch_left_out_is_not_correct(cell, monkeypatch):
    trainer = _family_trainer(cell)
    step = trainer.step
    monkeypatch.setattr(trainer, "step", lambda self, batch: step(self, inputs.half(batch)))
    assert not _correct(cell)["correct"]


@pytest.mark.parametrize("cell", TRAIN)
def test_the_control_in_the_programs_place_is_not_correct(cell):
    verdict = _correct(cell, variant="fp8")
    assert not verdict["correct"], verdict



@pytest.mark.parametrize("cell", TRAIN)
def test_a_later_step_that_repeats_the_first_gradient_is_not_correct(cell, monkeypatch):
    trainer = _family_trainer(cell)
    step = trainer.step
    first = {}

    def stale(self, batch):
        if "batch" not in first:
            first["batch"] = {k: v.clone() for k, v in batch.items()}
        return step(self, first["batch"])

    monkeypatch.setattr(trainer, "step", stale)
    outcome = tiny.run(cell)
    assert not tiny.judged(cell, outcome)["correct"]
    assert outcome.numbers["replay_grad_diff"] > 0.5, outcome.numbers
