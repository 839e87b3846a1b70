"""Synchronised batch norm in the port's data-parallel ResNet
(models/resnet.py, workloads/train_resnet.py) on a 4-process gloo gang.

Batch 4 at 32x32 (width 16, 10 classes), so that at dp 4 each rank holds
one row and the last stage's local statistics would be over one value.
Each case takes one step of the twin's ``train_step``; its loss, new stats
and gradients are held against the JAX package's ``value_and_grad`` over
the whole batch in one process and against the port's one process, in f64
on every side (``tests/test_torch_resnet.py`` says why: in f32 this
forward's rounding alone moves the gradients by percents). The new stats
must be the same on every rank. A control case leaves the statistics local
to each rank; its loss and stats must differ, which shows that the
reduction over the batch axes is what makes the gang compute the
reference's function.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivedscheduler_tpu.models import resnet as JR
from hivedscheduler_tpu_torch.models import convert, resnet
from hivedscheduler_tpu_torch.workloads import train_resnet

from ._multiproc import run_workers
from ._torch_rendezvous import gang_store
from ._torch_resnet_worker import flat
from .test_torch_resnet import GRAD, LOSS_TOL, STATS_TOL, jax_f64

WORKER = os.path.join(os.path.dirname(__file__), "_torch_resnet_worker.py")
BATCH, SIZE, CLASSES, WIDTH = 4, 32, 10, 16
CASES = {
    "dp4": {"mesh": {"dp": 4}, "local_bn": False},
    "dp2_fsdp2": {"mesh": {"dp": 2, "fsdp": 2}, "local_bn": False},
    "dp4_local_bn": {"mesh": {"dp": 4}, "local_bn": True},
}
SYNCED = [name for name, case in CASES.items() if not case["local_bn"]]


def _inputs():
    config = resnet.ResNetConfig(CLASSES, WIDTH, torch.float32)
    params, stats = resnet.init(config, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(11)
    return (convert.params_to_numpy(params), convert.params_to_numpy(stats),
            rng.standard_normal((BATCH, SIZE, SIZE, 3)), rng.integers(0, CLASSES, BATCH))


@pytest.fixture(scope="module")
def reference():
    """The whole batch in one process, f64: the JAX package's loss, new
    stats and gradients, and the port's."""
    params, stats, images, labels = _inputs()
    as64 = lambda t: jax.tree.map(lambda a: a.astype(np.float64), t)
    with jax_f64():
        config = JR.ResNetConfig(CLASSES, WIDTH, jnp.float64)
        (loss, new_stats), grads = jax.jit(jax.value_and_grad(
            lambda p, s, x, y: JR.loss_fn(p, s, x, y, config), has_aux=True))(
                as64(params), as64(stats), images, labels)
    jax_out = {"loss": float(loss), "stats": flat(jax.tree.map(np.asarray, new_stats)),
               "grads": flat(jax.tree.map(np.asarray, grads))}
    tparams = convert.params_from_jax(params, "cpu", torch.float64)
    tstats = convert.params_from_jax(stats, "cpu", torch.float64)
    opt = train_resnet.make_optimizer(tparams)
    tloss, tnew = train_resnet.train_step(tparams, tstats, opt, torch.from_numpy(images),
                                          torch.from_numpy(labels),
                                          resnet.ResNetConfig(CLASSES, WIDTH, torch.float64))
    port_out = {"loss": tloss.item(), "stats": {k: v.numpy() for k, v in flat(tnew).items()},
                "grads": {k: v.grad.numpy() for k, v in flat(tparams).items()}}
    return {"jax": jax_out, "port": port_out}


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    work = tmp_path_factory.mktemp("resnet_gang")
    params, stats, images, labels = _inputs()
    np.savez(work / "params.npz", **flat(params))
    np.savez(work / "stats.npz", **flat(stats))
    np.savez(work / "batch.npz", images=images, labels=labels, classes=CLASSES, width=WIDTH)
    (work / "cases.json").write_text(json.dumps(CASES))
    with gang_store(4) as port:
        outs = run_workers(WORKER, [[str(r), "4", str(port), str(work)] for r in range(4)],
                           timeout=240)

    def load(name):
        return {k: v for k, v in np.load(work / name).items()}

    return {"outs": outs,
            "grads": {c: load(f"grads_{c}.npz") for c in CASES},
            "stats": {c: [load(f"stats_{c}_{r}.npz") for r in range(4)] for c in CASES}}


def test_each_rank_holds_its_rows(gang):
    for out in gang["outs"]:
        assert out["rows"] == {"dp4": 1, "dp2_fsdp2": 1, "dp4_local_bn": 1}


@pytest.mark.parametrize("name", SYNCED)
def test_loss_matches_jax_and_one_process(gang, reference, name):
    losses = {out["losses"][name] for out in gang["outs"]}
    assert len(losses) == 1
    loss = losses.pop()
    assert abs(loss - reference["jax"]["loss"]) < LOSS_TOL
    assert abs(loss - reference["port"]["loss"]) < LOSS_TOL


@pytest.mark.parametrize("name", SYNCED)
def test_stats_match_jax_and_are_equal_on_every_rank(gang, reference, name):
    ranks = gang["stats"][name]
    for path, want in reference["jax"]["stats"].items():
        for rank in ranks:
            np.testing.assert_array_equal(rank[path], ranks[0][path], err_msg=path)
        np.testing.assert_allclose(ranks[0][path], want, atol=STATS_TOL, rtol=0, err_msg=path)
        np.testing.assert_allclose(ranks[0][path], reference["port"]["stats"][path],
                                   atol=STATS_TOL, rtol=0, err_msg=path)


@pytest.mark.parametrize("name", SYNCED)
def test_gradients_match_jax_and_one_process(gang, reference, name):
    got = gang["grads"][name]
    for side in ("jax", "port"):
        want = reference[side]["grads"]
        assert got.keys() == want.keys()
        for path in want:
            np.testing.assert_allclose(got[path], want[path], err_msg=f"{side} {path}", **GRAD)


def test_local_batch_norm_computes_another_function(gang, reference):
    name = "dp4_local_bn"
    losses = [out["losses"][name] for out in gang["outs"]]
    assert abs(losses[0] - reference["jax"]["loss"]) > 100 * LOSS_TOL
    ranks = gang["stats"][name]
    want = reference["jax"]["stats"]
    assert max(np.abs(ranks[0][p] - want[p]).max() for p in want) > 100 * STATS_TOL
    # Each rank normalised its own row: the ranks' stats disagree.
    assert any(not np.array_equal(ranks[0][p], ranks[1][p]) for p in want)
