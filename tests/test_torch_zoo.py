"""The perf harness's model zoo (``models/perf.bench_zoo``) and the MNIST
twin (``workloads/train_mnist.py``) against the JAX package's.

``bench_zoo`` runs at the JAX package's CPU sizes and reports every row the
JAX package's does; its BERT step keeps the JAX package's quirk (the
boolean mask passed as ``mlm_loss``'s targets), held here against JAX's
``mlm_loss`` called that way. A failing zoo degrades to an ``error`` dict,
as the JAX harness's does. The MNIST twin's loss and Adam steps are held
against the reference's loss (``example/workloads/train_mnist.py``) and
``optax.adam(1e-3)`` on the same numpy weights and data.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hivedscheduler_tpu.models import bert as JB
from hivedscheduler_tpu_torch.models import bert, convert, perf
from hivedscheduler_tpu_torch.workloads import train_mnist

ZOO_ROWS = ("bert_large_step_ms", "bert_tokens_per_sec", "resnet50_step_ms",
            "resnet50_images_per_sec", "decode_step_ms", "decode_tokens_per_sec",
            "decode_scan_step_ms", "decode_scan_tokens_per_sec")


def test_bench_zoo_on_cpu_has_every_reference_row():
    out = perf.bench_zoo(False)
    for row in ZOO_ROWS:
        assert math.isfinite(out[row]) and out[row] > 0, row
    assert set(out["launches"]) == {"bert", "resnet", "decode"}
    # The plain versions run on the CPU: no kernel launches.
    assert all(set(n.values()) == {0} for n in out["launches"].values())


def test_zoo_failure_degrades_to_an_error_dict(monkeypatch):
    monkeypatch.setenv("HIVED_PERF_ZOO", "1")

    def broken(on_gpu):
        raise RuntimeError("zoo stage failed")

    monkeypatch.setattr(perf, "bench_zoo", broken)
    result = perf.main(["--device", "cpu"])
    assert result["zoo"] == {"error": "RuntimeError: zoo stage failed"}
    assert perf.stage_rows_clean(result["zoo"]) is None
    assert "zoo" in perf.CARRY_STAGES


def test_zoo_bert_loss_is_jax_mlm_loss_on_the_boolean_mask():
    jparams = JB.init(JB.tiny(), jax.random.PRNGKey(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, JB.tiny().vocab_size, (2, 64))
    mask = rng.random((2, 64)) < 0.15
    want = float(JB.mlm_loss(jparams, jnp.asarray(tokens), jnp.asarray(mask), JB.tiny()))
    got = bert.mlm_loss(params, torch.from_numpy(tokens), torch.from_numpy(mask).long(),
                        bert.tiny()).item()
    assert abs(got - want) < 1e-4
    # Every position counts, scored against token 0 or 1: not the MLM loss.
    real = np.where(mask, tokens, -100)
    mlm = bert.mlm_loss(params, torch.from_numpy(tokens), torch.from_numpy(real),
                        bert.tiny()).item()
    assert abs(got - mlm) > 1e-2


def _jax_mnist_loss(p, x, y):
    """``example/workloads/train_mnist.py``'s loss."""
    h = jax.nn.relu(x @ p["w1"] + p["b1"])
    logits = h @ p["w2"] + p["b2"]
    return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits), y[:, None], axis=-1))


@pytest.mark.parametrize("steps", [1, 3])
def test_mnist_loss_and_adam_match_optax(steps):
    """In f64 on both sides: Adam's first update is about lr * sign(g), so
    an f32 gradient near 0 that the two sides round to opposite signs moves
    its weight apart however close the gradients are."""
    rng = np.random.default_rng(0)
    weights = {k: v.astype(np.float64) for k, v in train_mnist.init(rng).items()}
    x, y = train_mnist.synthetic_data(rng)
    x = x.astype(np.float64)
    opt = optax.adam(1e-3)
    with jax.enable_x64(True):
        want, state, want_losses = weights, opt.init(weights), []
        for _ in range(steps):
            loss, grads = jax.value_and_grad(_jax_mnist_loss)(want, x, y)
            updates, state = opt.update(grads, state)
            want = jax.tree.map(np.asarray, optax.apply_updates(want, updates))
            want_losses.append(float(loss))
    params = {k: torch.from_numpy(v.copy()) for k, v in weights.items()}
    adam = train_mnist.make_optimizer(params)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    losses = [train_mnist.train_step(params, adam, xt, yt).item() for _ in range(steps)]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-12)
    for k in weights:
        assert want[k].dtype == np.float64
        np.testing.assert_allclose(params[k].detach().numpy(), want[k], atol=1e-12, rtol=1e-9,
                                   err_msg=k)


def test_mnist_init_and_data():
    rng = np.random.default_rng(0)
    weights = train_mnist.init(rng)
    assert {k: v.shape for k, v in weights.items()} == {
        "w1": (784, 256), "b1": (256,), "w2": (256, 10), "b2": (10,)}
    assert weights["w1"].std() == pytest.approx(0.05, rel=0.02)
    assert not weights["b1"].any() and not weights["b2"].any()
    x, y = train_mnist.synthetic_data(rng)
    assert x.shape == (512, 784) and x.dtype == np.float32
    assert y.min() >= 0 and y.max() <= 9


def test_train_mnist_main_on_cpu(capsys):
    losses = train_mnist.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(losses) == 100 and losses[-1] < losses[0]
    assert [line.split()[1] for line in lines[:-1]] == ["0", "20", "40", "60", "80"]
    assert lines[-1] == "done"
