"""The captured training step on a mesh (each model's ``captured_step`` and
``models/train.make_train_step`` on an active mesh, through the owner
``models/train.step_graphs``) on a CPU gloo gang, against the eager gang
step and the JAX package's jitted, sharded ``make_train_step`` on a JAX
mesh of the same layout.

One 4-process gang (``_torch_train_graph_mesh_worker.py``) stands the CUDA
graph capture in as ``test_torch_train_graph.py`` does and takes three
steps of each case through the owner and three eager gang steps from the
same weights: the tiny Llama from the JAX package's ``init`` (PRNGKey(0))
on fsdp2 x tp2, dp2 x fsdp2 and tp4; Mixtral tiny on fsdp2 x ep2; BERT
tiny on dp2 x tp2; an f64 ResNet (width 16) on dp4; the tiny Llama's
pipeline on pp2 x tp2; the tiny Llama on sp2 x tp2 with sp_mode "ulysses"
(Ulysses' all-to-alls inside the step, forward and backward). Each case's
owner steps must be the eager steps bit for bit, with one capture; the
Llama's losses must be JAX's within RTOL, at the case's sp_mode.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate

from hivedscheduler_tpu.models import train as JTR
from hivedscheduler_tpu.models import transformer as JT
from hivedscheduler_tpu.parallel import mesh as jmesh
from hivedscheduler_tpu.parallel import sharding as JS
from hivedscheduler_tpu_torch.models import train as TTR

from ._multiproc import run_workers
from ._torch_rendezvous import gang_store
from ._torch_train_graph_mesh_worker import B, CASES, S, STEPS
from .test_torch_train_graph import ADAM, RTOL

WORKER = os.path.join(os.path.dirname(__file__), "_torch_train_graph_mesh_worker.py")
TOKENS = np.random.default_rng(5).integers(0, 512, (STEPS, B, S))
LLAMA = [name for name, (_, kind) in CASES.items() if kind in ("llama", "llama_ulysses")]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


@pytest.fixture(scope="module")
def masters():
    return jax.tree.map(np.asarray, JT.init(JT.tiny(), jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, masters):
    work = tmp_path_factory.mktemp("train_graph_mesh")
    np.savez(work / "llama.npz", **_flat(masters))
    np.savez(work / "tokens.npz", steps=TOKENS)
    with gang_store(4) as port:
        outs = run_workers(WORKER, [[str(r), "4", str(port), str(work)] for r in range(4)],
                           timeout=300)
    return {o["rank"]: o for o in outs}


@pytest.fixture(scope="module")
def gang(ranks):
    return {rank: out["cases"] for rank, out in ranks.items()}


def jax_losses(masters, name):
    """The JAX package's jitted, sharded, donating step on a JAX mesh of
    the case's layout (the virtual CPU devices) at the case's sp_mode,
    from the same weights and batches."""
    sizes, kind = CASES[name]
    config = JT.tiny()
    if kind == "llama_ulysses":
        config = dataclasses.replace(config, sp_mode="ulysses")
    mesh = jmesh.make_mesh(jmesh.MeshConfig(**sizes), devices=jax.devices()[:4])
    optimizer = JTR.make_optimizer()
    with jax.set_mesh(mesh):
        param_sh, opt_sh, _, _ = JTR.shardings_for(config, mesh, optimizer)
        params = jax.device_put(masters, param_sh)
        opt_state = jax.jit(optimizer.init, out_shardings=opt_sh)(params)
        step = JTR.make_train_step(config, mesh, optimizer, param_sh, opt_sh)
        losses = []
        for tokens in TOKENS:
            params, opt_state, loss = step(params, opt_state,
                                           JS.shard_batch(jnp.asarray(tokens, jnp.int32), mesh))
            losses.append(float(loss))
    return losses


@pytest.mark.parametrize("name", list(CASES))
def test_owner_steps_equal_the_eager_gang_steps_bitwise(gang, name):
    for rank, cases in gang.items():
        got = cases[name]
        assert got["owner"]["losses"] == got["eager"]["losses"], rank
        assert got["owner"]["digest"] == got["eager"]["digest"], rank
        # The leaves hold the last step's gradients, as the eager step leaves them.
        assert got["owner"]["grads_digest"] == got["eager"]["grads_digest"], rank
        assert got["owner"]["grads"] == got["eager"]["grads"] > 0, rank
    # Every rank reports the global batch's loss.
    assert len({tuple(cases[name]["owner"]["losses"]) for cases in gang.values()}) == 1
    assert all(np.isfinite(gang[0][name]["owner"]["losses"]))


@pytest.mark.parametrize("name", list(CASES))
def test_one_capture_a_shape_keyed_by_the_mesh(gang, name):
    for cases in gang.values():
        got = cases[name]
        assert (got["captures"], got["replays"]) == (1, STEPS - 1)
        assert got["keyed_by_mesh"]
        # A gang's AdamW keeps its step count on the device, as the graph needs.
        assert got["capturable"] in (True, None)


def test_resnet_running_stats_are_equal_on_every_rank(gang):
    # Batch norm's statistics are the global batch's: the parameters and
    # the running stats (one digest over both) agree across the ranks.
    assert len({cases["resnet_f64-dp4"]["owner"]["digest"] for cases in gang.values()}) == 1


@pytest.mark.parametrize("name", LLAMA)
def test_owner_llama_losses_match_jax_on_a_mesh(gang, masters, name):
    want = jax_losses(masters, name)
    for cases in gang.values():
        np.testing.assert_allclose(cases[name]["owner"]["losses"], want, rtol=RTOL)


@pytest.fixture
def one_rank_group():
    """A one-process gloo group over an in-memory store (no rendezvous)."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield DeviceMesh("cpu", [0], mesh_dim_names=("dp",))
    finally:
        dist.destroy_process_group()


def test_capturable_on_cuda_dtensor_leaves(one_rank_group, monkeypatch):
    # A gang's parameters are DTensors: on the card (here DTensor.is_cuda
    # stands in for it), their AdamW keeps its step count on the device.
    leaf = DTensor.from_local(torch.zeros(4), one_rank_group, (Replicate(),))
    assert TTR.capturable([leaf]) is False  # CPU leaves
    monkeypatch.setattr(DTensor, "is_cuda", property(lambda self: True))
    assert TTR.capturable([leaf]) is True
    assert TTR.capturable([leaf, torch.zeros(1)]) is False  # a CPU leaf among them
    monkeypatch.setattr(ADAM, "_get_capturable_supported_devices",
                        lambda supports_xla=True: ["cuda", "cpu"])
    assert TTR.make_optimizer({"w": leaf}).param_groups[0]["capturable"]
