"""The captured decode step on a mesh (hivedscheduler_tpu_torch.models.generate's
owner, ``generate.decoder(params, config, mesh)``) on a CPU gloo gang,
against the eager mesh loop and the JAX package's ``generate`` on a JAX
mesh of the same layout.

One 4-process gang (``_torch_decode_mesh_worker.py``) stands the CUDA
graph capture in as ``test_torch_decode_graph.py`` does and, on fsdp2 x
tp2 and tp4, serves the tiny dense model from the JAX package's ``init``
(PRNGKey(0)) greedily and sampled, and its int8 tree quantized on the
mesh greedily; on fsdp2 x ep2, Mixtral tiny greedily. In f32, so each
case's owner must give the eager loop's tokens bit for bit and its greedy
tokens must be JAX's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hivedscheduler_tpu.models import generate as JG
from hivedscheduler_tpu.models import mixtral as JM
from hivedscheduler_tpu.models import quantize as JQ
from hivedscheduler_tpu.models import transformer as JT
from hivedscheduler_tpu.parallel import mesh as jmesh
from hivedscheduler_tpu.parallel import sharding as JS

from ._multiproc import run_workers
from ._torch_rendezvous import gang_store
from ._torch_decode_mesh_worker import CASES, DECODE_STEPS, NEW_TOKENS

WORKER = os.path.join(os.path.dirname(__file__), "_torch_decode_mesh_worker.py")
B, T = 4, 16
PROMPTS = np.random.default_rng(3).integers(0, 512, (2, B, T))
GREEDY = [name for name, (_, _, sampled) in CASES.items() if not sampled]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


@pytest.fixture(scope="module")
def masters():
    return {"dense": jax.tree.map(np.asarray, JT.init(JT.tiny(), jax.random.PRNGKey(0))),
            "mixtral": jax.tree.map(np.asarray, JM.init(JM.tiny(), jax.random.PRNGKey(0)))}


@pytest.fixture(scope="module")
def gang(tmp_path_factory, masters):
    work = tmp_path_factory.mktemp("decode_mesh")
    for name, tree in masters.items():
        np.savez(work / f"{name}.npz", **_flat(tree))
    np.save(work / "prompts.npy", PROMPTS)
    with gang_store(4) as port:
        outs = run_workers(WORKER, [[str(r), "4", str(port), str(work)] for r in range(4)],
                           timeout=300)
    return {o["rank"]: o["cases"] for o in outs}


def jax_tokens(masters, name):
    """JAX's greedy tokens for the first prompt on a JAX mesh of the case's
    layout (the virtual CPU devices), as ``test_torch_int8_gang.py``
    builds its reference."""
    sizes, kind, _ = CASES[name]
    module, family = (JM, "mixtral") if kind == "mixtral" else (JT, "dense")
    config = module.tiny()
    mesh = jmesh.make_mesh(jmesh.MeshConfig(**sizes), devices=jax.devices()[:4])
    with jax.set_mesh(mesh):
        placed = jax.device_put(masters[family],
                                JS.tree_shardings(mesh, module.logical_axes(config)))
        if kind == "int8":
            placed = JQ.quantize_params(placed)
        prompt = JS.shard_batch(jnp.asarray(PROMPTS[0], jnp.int32), mesh)
        ffn = JM.decode_ffn(config) if kind == "mixtral" else None
        out = JG.generate(placed, prompt, config, max_new_tokens=NEW_TOKENS, ffn=ffn)
    return np.asarray(out)[:, T:]


def _local_rows(name):
    sizes = CASES[name][0]
    return B // (sizes.get("dp", 1) * sizes.get("fsdp", 1))


def _rows(got, name):
    n = _local_rows(name)
    return slice(got["batch_rank"] * n, (got["batch_rank"] + 1) * n)


@pytest.mark.parametrize("name", list(CASES))
def test_owner_tokens_equal_the_eager_mesh_loop(gang, name):
    for rank, cases in gang.items():
        got = cases[name]
        for request in range(2):
            assert got["graph"][request] == got["plain"][request], (rank, request)
            assert np.asarray(got["graph"][request]).shape == (_local_rows(name), NEW_TOKENS)
    # The ranks that share rows (a tp or ep group) made the same tokens,
    # sampled ones too: their generators were in one state.
    by_rows = {}
    for cases in gang.values():
        by_rows.setdefault(cases[name]["batch_rank"], []).append(cases[name]["graph"])
    assert len(by_rows) == B // _local_rows(name)
    assert all(g == group[0] for group in by_rows.values() for g in group)


@pytest.mark.parametrize("name", GREEDY)
def test_owner_greedy_tokens_equal_jax_on_a_mesh(gang, masters, name):
    want = jax_tokens(masters, name)
    assert want.shape == (B, NEW_TOKENS)
    for cases in gang.values():
        got = cases[name]
        np.testing.assert_array_equal(got["graph"][0], want[_rows(got, name)])


@pytest.mark.parametrize("name", list(CASES))
def test_owner_cache_holds_the_ranks_rows_and_kv_heads(gang, name):
    sizes, kind, _ = CASES[name]
    config = (JM if kind == "mixtral" else JT).tiny()
    tp = sizes.get("tp", 1)
    for cases in gang.values():
        got = cases[name]
        # tiny's 2 KV heads split over tp 2; over tp 4 they do not divide,
        # and every rank attends all of them (the JAX package's fallback).
        assert got["heads_local"] == (config.n_kv_heads % tp == 0)
        kv = config.n_kv_heads // tp if got["heads_local"] else config.n_kv_heads
        assert got["cache_shape"] == [config.n_layers, _local_rows(name), T + NEW_TOKENS, kv,
                                      config.d_model // config.n_heads]


@pytest.mark.parametrize("name", list(CASES))
def test_a_second_request_captures_nothing(gang, name):
    for cases in gang.values():
        (c1, r1), (c2, r2) = cases[name]["counts"]
        assert (c1, r1) == (1, NEW_TOKENS - 1)
        assert (c2, r2) == (0, NEW_TOKENS - 1)
        assert cases[name]["graph"][0] != cases[name]["graph"][1]


@pytest.mark.parametrize("name", list(CASES))
def test_decode_step_on_the_mesh_replays_its_owners_cache_only(gang, name):
    for cases in gang.values():
        got = cases[name]
        assert got["decode_step_equal"] and got["decode_step_refused_other_cache"]
        assert got["decode_step_fill"] == [T + DECODE_STEPS] * 2


@pytest.mark.parametrize("name", list(CASES))
def test_the_mesh_owner_goes_with_the_weights(gang, name):
    assert all(cases[name]["owner_gone"] for cases in gang.values())
