"""The port's Mixtral on CPU gloo gangs (expert parallelism) against the JAX
package's single-device Mixtral and the port's one process.

One 4-process gang (``_torch_mixtral_worker.py``) runs Mixtral tiny from
the JAX package's ``init`` on fsdp 2 x ep 2, ep 2 x tp 2, and sp 2 x ep 2
under ring and under Ulysses: the forward, the aux loss, one step's loss
and every gradient, held to the JAX package's ``forward`` and
``value_and_grad(lm_loss)`` at ``tests/test_model_zoo.py``'s tolerances
(atol 2e-4 / rtol 2e-3; 5e-4 / 5e-3 with sp) and to the port's one process
within 1e-5. On fsdp 2 x ep 2 it also decodes against the JAX package's
cached decode (capacity factor 16, as ``tests/test_generate.py``, and the
default) and serves a one-process checkpoint whose greedy tokens must be
the one process's. The dryrun's ``ep-moe`` row runs as its own gang.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivedscheduler_tpu.models import generate as JG
from hivedscheduler_tpu.models import mixtral as JM
from hivedscheduler_tpu_torch import serve
from hivedscheduler_tpu_torch.models import checkpoint, convert, mixtral
from hivedscheduler_tpu_torch.tools import dryrun
from hivedscheduler_tpu_torch.workloads import train_mixtral

from ._multiproc import run_workers
from ._torch_rendezvous import gang_store

WORKER = os.path.join(os.path.dirname(__file__), "_torch_mixtral_worker.py")
CASES = {
    "fsdp2_ep2": ({"fsdp": 2, "ep": 2}, "auto"),
    "ep2_tp2": ({"ep": 2, "tp": 2}, "auto"),
    "sp2_ep2_ring": ({"sp": 2, "ep": 2}, "ring"),
    "sp2_ep2_ulysses": ({"sp": 2, "ep": 2}, "ulysses"),
}
# test_model_zoo.py's tolerances: the ep mesh's, and the sp x ep mesh's.
JAX_TOL = {"atol": 2e-4, "rtol": 2e-3}
JAX_SP_TOL = {"atol": 5e-4, "rtol": 5e-3}
AUX_RTOL, PORT_TOL, GRAD_REL = 1e-4, 1e-5, 1e-4
B, S = 4, 64
DECODE_PREFILL, SERVED_TOKENS = 6, 4


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def _batch():
    rng = np.random.default_rng(11)
    return {"tokens": rng.integers(0, 512, (B, S)), "decode": rng.integers(0, 512, (2, 10)),
            "served": rng.integers(0, 512, (2, 16))}


BATCH = _batch()


def _tol(name):
    return JAX_SP_TOL if CASES[name][0].get("sp", 1) > 1 else JAX_TOL


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, JM.init(JM.tiny(), jax.random.PRNGKey(0)))


def _port(jax_params):
    return convert.params_from_jax(jax_params, device="cpu")


@pytest.fixture(scope="module")
def reference(jax_params):
    """JAX's logits, aux, loss and gradients; the port's one-process ones."""
    jp = jax.tree.map(jnp.asarray, jax_params)
    tokens = jnp.asarray(BATCH["tokens"])
    logits, aux = JM.forward(jp, tokens, JM.tiny())
    loss, grads = jax.value_and_grad(JM.lm_loss)(jp, tokens, JM.tiny())
    params = _port(jax_params)
    t = torch.from_numpy(BATCH["tokens"])
    with torch.no_grad():
        plogits, paux = mixtral.forward(params, t, mixtral.tiny())
    opt = train_mixtral.make_optimizer(params, 1e-3)
    ploss = train_mixtral.train_step(params, opt, t, mixtral.tiny())
    return {"logits": np.asarray(logits), "aux": float(aux), "loss": float(loss),
            "grads": {k: np.asarray(v) for k, v in _flat(grads).items()},
            "port_logits": plogits.numpy(), "port_aux": paux.item(), "port_loss": ploss.item(),
            "port_grads": {k: v.grad.numpy() for k, v in _flat(params).items()}}


@pytest.fixture(scope="module")
def gang(tmp_path_factory, jax_params):
    work = tmp_path_factory.mktemp("mixtral")
    (work / "cases.json").write_text(json.dumps(
        {n: {"mesh": m, "sp_mode": mode} for n, (m, mode) in CASES.items()}))
    np.savez(work / "params.npz", **_flat(jax_params))
    np.savez(work / "batch.npz", **BATCH)
    # A one-process checkpoint (step 1) for the gang to serve.
    params = _port(jax_params)
    opt = train_mixtral.make_optimizer(params)
    train_mixtral.train_step(params, opt, torch.from_numpy(BATCH["tokens"]), mixtral.tiny())
    ckpt = checkpoint.TrainCheckpointer(str(work / "ckpt"))
    ckpt.save(1, params, opt)
    ckpt.close()
    with gang_store(4) as port:
        outs = run_workers(WORKER, [[str(r), "4", str(port), str(work)] for r in range(4)],
                           timeout=360)
    return {"outs": outs, "work": work}


@pytest.mark.parametrize("name", sorted(CASES))
def test_gang_forward_matches_jax_and_one_process(gang, reference, name):
    mesh = CASES[name][0]
    rows = B // mesh.get("fsdp", 1)
    cols = S // mesh.get("sp", 1)
    vocab = 512 // mesh.get("tp", 1)
    got = np.load(gang["work"] / f"logits_{name}.npy")  # rank 0's block
    np.testing.assert_allclose(got, reference["logits"][:rows, :cols, :vocab], **_tol(name))
    assert np.abs(got - reference["port_logits"][:rows, :cols, :vocab]).max() <= PORT_TOL
    for o in gang["outs"]:  # the gang's aux loss, on every rank
        assert abs(o["aux"][name] - reference["aux"]) <= AUX_RTOL * abs(reference["aux"])
        assert abs(o["aux"][name] - reference["port_aux"]) <= PORT_TOL


@pytest.mark.parametrize("name", sorted(CASES))
def test_gang_loss_and_gradients_match_jax_and_one_process(gang, reference, name):
    losses = [o["losses"][name] for o in gang["outs"]]
    assert len(set(losses)) == 1, losses
    assert abs(losses[0] - reference["loss"]) <= _tol(name)["atol"]
    assert abs(losses[0] - reference["port_loss"]) <= PORT_TOL
    got = dict(np.load(gang["work"] / f"grads_{name}.npz"))
    assert sorted(got) == sorted(reference["grads"])
    step_max = max(np.abs(g).max() for g in reference["port_grads"].values())
    for path, g in reference["port_grads"].items():
        np.testing.assert_allclose(got[path], reference["grads"][path], err_msg=path,
                                   **_tol(name))
        assert np.abs(got[path] - g).max() <= GRAD_REL * step_max, path


@pytest.mark.parametrize("cf", [16.0, 1.25])
def test_gang_decode_matches_jax_cached_decode(gang, jax_params, cf):
    config = dataclasses.replace(JM.tiny(), capacity_factor=cf)
    jp = jax.tree.map(jnp.asarray, jax_params)
    ffn = JM.decode_ffn(config)
    prompt = jnp.asarray(BATCH["decode"])
    cache = JG.init_cache(config, prompt.shape[0], prompt.shape[1])
    logits, cache = JG.prefill(jp, prompt[:, :DECODE_PREFILL], cache, config, ffn=ffn)
    want = [logits]
    for t in range(DECODE_PREFILL, prompt.shape[1]):
        logits, cache = JG.decode_step(jp, prompt[:, t], cache, config, ffn=ffn)
        want.append(logits)
    got = np.load(gang["work"] / f"decode_{cf}.npy")
    np.testing.assert_allclose(got, np.stack([np.asarray(w) for w in want], 1), **JAX_TOL)


def test_one_process_checkpoint_serves_on_fsdp2_ep2(gang):
    config, params = serve.build("mixtral_tiny", 0, "cpu", ckpt=str(gang["work"] / "ckpt"))
    res = serve.run_request(params, torch.from_numpy(BATCH["served"]), config, SERVED_TOKENS,
                            ffn=serve.decode_hook(config))
    got = np.load(gang["work"] / "served.npy")
    assert got.shape == (2, SERVED_TOKENS)
    assert np.array_equal(got, res["tokens"].numpy())


def test_dryrun_ep_moe_row_at_four_processes():
    result = dryrun.dryrun(4, rows=("ep-moe",), device="cpu", timeout=300)
    assert dryrun.layouts(4, ["ep-moe"]) == {"ep-moe": dict(fsdp=2, ep=2)}
    # Held to the one-process Mixtral step on the same 4 zero rows, not the dense one.
    assert result["references"]["ep-moe"] == dryrun.reference_loss("cpu", "ep-moe", 4)
    assert abs(result["rows"]["ep-moe"] - result["references"]["ep-moe"]) <= dryrun.TOL
    assert abs(result["references"]["ep-moe"] - result["reference"]) > dryrun.TOL
    assert result["expected"] == {"ep-moe": 0}  # tiny's heads of 16: no kernel
