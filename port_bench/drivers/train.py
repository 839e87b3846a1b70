"""Training cells, closed loop: one step after another, a new batch each
step (``inputs.train_batch``), each through the family's entry point (on
the card a replay of the port's captured step).

Set-up makes the weights from the seed and runs the checked steps (the
first runs eagerly and captures the step's graph, the later ones replay
it), reading the losses, two gradients as the optimizer got them (the
first step's, and the last checked step's: a replay's) and the
parameters' change after them; the window then times later steps; the
traced run profiles ``traced_steps`` more. Once the program's state is
freed, the reference runs the checked steps from the same weights and
batches."""

from __future__ import annotations

import time
from typing import Dict

import torch

from .. import compare, inputs, trace
from ..counts import flash, model
from ..harness import Measures, Outcome, Run
from ..reference import train as reference_train
from . import device as dev

KINDS = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")
BOUND_KIND = {"flash_fwd": "fwd", "flash_bwd_dkdv": "dkdv", "flash_bwd_dq": "dq"}


SAMPLE = 65536  # elements of each leaf whose values are compared


@torch.no_grad()
def _observe(tensors, index) -> Dict[str, Dict]:
    """Each leaf's norm and its values at the sampled positions."""
    norms, samples = {}, {}
    for i, (name, t) in enumerate(tensors):
        norms[name] = float(t.norm())
        samples[name] = t.reshape(-1)[index(i, t.numel())].float().cpu()
    return {"norms": norms, "samples": samples}


def _readings(system, batch, n: int, initial, index) -> Dict:
    """The losses of the checked steps; the first step's gradient and the
    last one's, each worked out from the optimizer's first moment (the
    last from its moments before and after that step, the one before held
    on the host); the parameters' change after them."""
    losses = []
    for i in range(n):
        if i == n - 1:
            before = [m.to("cpu", copy=True) for m in system.moments()]
        losses.append(system.step(batch(i)))
        if i == 0:
            grads = _observe(((name, system.first_grad(j)) for j, name in
                              enumerate(system.names)), index)
    last = _observe(((name, system.step_grad(j, before[j])) for j, name in
                     enumerate(system.names)), index)
    del before
    changes = _observe(((name, p.detach() - initial(j)) for j, (name, p) in
                        enumerate(zip(system.names, system.leaves))), index)
    return {"losses": [float(x) for x in losses], "grads": grads, "replay_grads": last,
            "changes": changes}


def run(r: Run) -> Outcome:
    cfg, traffic = r.cell.config, r.cell.traffic
    ref = r.reference
    specs = ref.leaf_specs(cfg)
    rows, seq, checked = traffic["rows"], traffic["seq"], traffic["checked_steps"]

    def batch(i: int) -> Dict[str, torch.Tensor]:
        return inputs.train_batch(r.seed, i, rows, seq, cfg["vocab_size"], r.device,
                                  traffic.get("mask_rate", 0.0), cfg.get("mask_token_id", 0))

    def initial(i: int) -> torch.Tensor:
        return inputs.make_leaf(r.seed, i, specs[i], torch.float32, r.device)

    def index(i: int, numel: int) -> torch.Tensor:
        return inputs.sample_index(r.seed, i, numel, SAMPLE, r.device)

    params = inputs.make_tree(r.seed, specs, torch.float32, r.device)
    if r.variant:
        system = reference_train.Trainer(ref, cfg, params, "fp8" if r.variant == "fp8" else "f32",
                                         "" if r.variant == "fp8" else r.variant)
    else:
        system = r.family.Trainer(cfg, params)
    del params
    prog = _readings(system, batch, checked, initial, index)
    dev.sync(r.device)
    setup_s = time.perf_counter() - r.t_start

    counters = r.family.common.captures() if not r.variant else {}
    fence = dev.Fence(r.device)
    steps, bad, step = 0, torch.zeros((), dtype=torch.int64, device=r.device), checked
    marks = []  # host clock as each step's predecessor had finished
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < r.seconds:
        loss = system.step(batch(step))
        bad += (~torch.isfinite(loss)).long()
        step, steps = step + 1, steps + 1
        fence.pass_()
        marks.append(time.perf_counter())
    dev.sync(r.device)
    elapsed = time.perf_counter() - t0
    tokens_per_s = steps * rows * seq / elapsed if steps else 0.0

    measures = Measures("train", window={
        "steps": steps, "seconds": elapsed, "tokens_per_s": tokens_per_s,
        "flops_per_token": model.train_flops_per_token(cfg, seq)})
    if r.trace:
        launches0 = r.family.common.launches()
        with dev.profiled(r.device) as prof:
            with torch.profiler.record_function(trace.WINDOW):
                for _ in range(traffic["traced_steps"]):
                    system.step(batch(step))
                    step += 1
                dev.sync(r.device)
        measures.trace = trace.Summary(prof)
        after = r.family.common.launches()
        measures.launches = {k: after[k] - launches0[k] for k in KINDS}
        shape = model.attention_shape(cfg, rows, seq)
        measures.bounds = {k: measures.launches[k] * flash.bound_s(BOUND_KIND[k], *shape)[0]
                           for k in KINDS}
    notes = {"setup_s": setup_s, "step_ms": [round(1e3 * (b - a), 2) for a, b in zip(marks, marks[1:])]}
    if counters:
        now = r.family.common.captures()
        notes.update({k: now[k] - counters[k] for k in counters})
        notes["captures_before_window"] = counters["train_captures"]
        if notes["train_captures"] != 0:
            raise RuntimeError(f"a step captured inside the window: {notes}")
    peak = dev.peak_bytes(r.device)
    failed = int(bad)
    system.close()
    del system
    dev.release(r.device)

    reference = reference_train.Trainer(ref, cfg, inputs.make_tree(r.seed, specs, torch.float32,
                                                                    r.device))
    t_ref = time.perf_counter()
    refrec = _readings(reference, batch, checked, initial, index)
    reference.close()
    del reference
    dev.release(r.device)
    notes["reference_s"] = time.perf_counter() - t_ref
    notes["losses"] = prog["losses"]
    notes["reference_losses"] = refrec["losses"]
    notes["diff_by_leaf"] = {}
    numbers = compare.train_numbers(prog, refrec, notes["diff_by_leaf"])
    return Outcome(
        attempted=steps, failed=failed,
        end_to_end={"train_tokens_per_s": tokens_per_s, "setup_s": setup_s},
        numbers=numbers, memory_peak_bytes=peak,
        measures=measures, notes=notes)
