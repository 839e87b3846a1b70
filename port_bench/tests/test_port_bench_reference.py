"""The plain references against the port at test size on the CPU (the test
may import the port; the references never do), and the import rules: no
module of the yardstick loads the port, and no run loads JAX or the JAX
package, judged by whole top-level names."""

import dataclasses
import subprocess
import sys

import pytest
import torch

from port_bench import inputs
from port_bench.reference import bert as ref_bert
from port_bench.reference import common
from port_bench.reference import mixtral as ref_mixtral
from port_bench.tests import tiny


def _flat_grads(params):
    return {n: t.grad.clone() for n, t in inputs.flat(params)}


def _close(a, b, rtol=2e-5, atol=2e-6):
    for n in a:
        torch.testing.assert_close(a[n], b[n], rtol=rtol, atol=atol, msg=n)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_mixtral_loss_and_gradients_match_the_port(capacity_factor):
    from hivedscheduler_tpu_torch.models import mixtral as port

    from port_bench.families import mixtral as fam

    cfg = dict(tiny.cell("mixtral-train-4x4k").config, router_capacity_factor=capacity_factor)
    specs = ref_mixtral.leaf_specs(cfg)
    config = dataclasses.replace(fam.port_config(cfg), remat=False)
    batch = inputs.train_batch(5, 0, 4, 32, cfg["vocab_size"], torch.device("cpu"))
    ours = inputs.make_tree(5, specs, torch.float32, torch.device("cpu"))
    theirs = inputs.make_tree(5, specs, torch.float32, torch.device("cpu"))
    for _, t in inputs.flat(ours) + inputs.flat(theirs):
        t.requires_grad_(True)
    a = ref_mixtral.loss(ours, batch, cfg, common.Precision("f32"))
    b = port.lm_loss(theirs, batch["tokens"], config)
    a.backward()
    b.backward()
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    _close(_flat_grads(ours), _flat_grads(theirs))
    if capacity_factor < 1:  # fewer slots than picks: tokens dropped on both sides alike
        tokens, experts, k = 4 * 32, cfg["num_local_experts"], cfg["num_experts_per_tok"]
        assert ref_mixtral.capacity(cfg, tokens) * experts < k * tokens


def test_bert_loss_and_gradients_match_the_port():
    from hivedscheduler_tpu_torch.models import bert as port

    from port_bench.families import bert as fam

    c = tiny.cell("bert-train-64x512")
    cfg = c.config
    specs = ref_bert.leaf_specs(cfg)
    config = dataclasses.replace(fam.port_config(cfg), remat=False)
    batch = inputs.train_batch(7, 0, 8, 32, cfg["vocab_size"], torch.device("cpu"),
                               c.traffic["mask_rate"], cfg["mask_token_id"])
    assert (batch["targets"] >= 0).any() and (batch["targets"] < 0).any()
    ours = inputs.make_tree(7, specs, torch.float32, torch.device("cpu"))
    theirs = inputs.make_tree(7, specs, torch.float32, torch.device("cpu"))
    for _, t in inputs.flat(ours) + inputs.flat(theirs):
        t.requires_grad_(True)
    a = ref_bert.loss(ours, batch, cfg, common.Precision("f32"))
    b = port.mlm_loss(theirs, batch["tokens"], batch["targets"], config)
    a.backward()
    b.backward()
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    _close(_flat_grads(ours), _flat_grads(theirs))


def test_adamw_matches_torch():
    torch.manual_seed(0)
    ours = [torch.randn(5, 3), torch.randn(7)]
    theirs = [t.clone().requires_grad_(True) for t in ours]
    opt = common.AdamW(ours, 1e-2, (0.9, 0.999), 1e-8, 1e-2)
    ref = torch.optim.AdamW(theirs, lr=1e-2, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2)
    for step in range(3):
        grads = [torch.randn_like(t) for t in ours]
        opt.step(grads)
        for t, g in zip(theirs, grads):
            t.grad = g
        ref.step()
        if step == 0:
            first = opt.m[0] / (1 - opt.betas[0])
            assert float(first.norm()) == pytest.approx(float(grads[0].norm()), rel=1e-6)
    for a, b in zip(ours, theirs):
        torch.testing.assert_close(a, b.detach(), rtol=1e-6, atol=1e-7)


def test_the_last_steps_gradient_is_read_from_the_moments_on_both_sides():
    """``step_grad`` works the last step's gradient out from the first
    moment before and after it: the gradient that step handed the optimizer,
    for the reference and for the port's trainer (on the CPU its eager
    step, whose gradients stay in the leaves)."""
    from port_bench.families import mixtral as fam
    from port_bench.reference import train as ref_train

    c = tiny.cell("mixtral-train-4x4k")
    cfg, cpu = c.config, torch.device("cpu")
    specs = ref_mixtral.leaf_specs(cfg)
    for make in (lambda p: fam.Trainer(cfg, p), lambda p: ref_train.Trainer(ref_mixtral, cfg, p)):
        system = make(inputs.make_tree(5, specs, torch.float32, cpu))
        system.step(inputs.train_batch(5, 0, 4, 32, cfg["vocab_size"], cpu))
        before = [m.clone() for m in system.moments()]
        system.step(inputs.train_batch(5, 1, 4, 32, cfg["vocab_size"], cpu))
        for i, p in enumerate(system.leaves):
            torch.testing.assert_close(system.step_grad(i, before[i]), p.grad,
                                       rtol=1e-4, atol=1e-6 * float(p.grad.abs().max()))


def test_fp8_control_rounds_every_product_forward_and_backward():
    torch.manual_seed(0)
    a = torch.randn(3, 64, 32, requires_grad=True)
    b = torch.randn(32, 16, requires_grad=True)
    exact = a @ b
    low = common.Precision("fp8").mm(a, b)
    assert 0 < (low - exact).abs().max() < exact.abs().max() / 4
    g = torch.randn_like(exact)
    ga, gb = torch.autograd.grad(low, (a, b), g)
    ea, eb = torch.autograd.grad(exact, (a, b), g)
    assert gb.shape == b.shape and not torch.equal(ga, ea) and not torch.equal(gb, eb)
    torch.testing.assert_close(ga, ea, rtol=0.3, atol=0.3 * float(ea.abs().max()))
    assert torch.equal(common.Precision("f32").mm(a, b), exact)


YARDSTICK = ["port_bench.inputs", "port_bench.compare", "port_bench.trace",
             "port_bench.counts.flash", "port_bench.counts.model",
             "port_bench.counts.mixtral", "port_bench.counts.bert",
             "port_bench.reference.common", "port_bench.reference.mixtral",
             "port_bench.reference.bert", "port_bench.reference.train"]


def _loaded_top_names(modules):
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=str(tiny.harness.ROOT))
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_the_yardstick_imports_nothing_of_the_port():
    names = _loaded_top_names(YARDSTICK)
    assert "torch" in names
    assert not names & {"hivedscheduler_tpu_torch", "hivedscheduler_tpu", "jax", "jaxlib",
                        "flax"}


def test_a_run_loads_no_jax_and_no_jax_package():
    """Every module a chip run loads (the drivers, the families over the
    port, every metric reader), compared by whole top-level names: the port
    begins with the JAX package's name and is not it."""
    from port_bench import harness

    spec = harness.load_spec()
    modules = YARDSTICK + ["port_bench.harness", "port_bench.run", "port_bench.drivers.train",
                           "port_bench.families.mixtral",
                           "port_bench.families.bert"]
    names = _loaded_top_names(modules)
    assert "hivedscheduler_tpu_torch" in names
    assert not names & set(harness.FORBIDDEN)
    for m in spec["per_layer"]:
        assert callable(harness.reader(m["name"]).read)
