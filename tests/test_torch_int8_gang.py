"""Int8 serving on a gang (hivedscheduler_tpu_torch.models.quantize on a
mesh, the int8 gathers of parallel/sharding.py and models/transformer.py,
serve.build) against the JAX package and the port's one process.

One 4-process gloo gang (``_torch_int8_worker.py``) starts from the JAX
package's ``init`` of the tiny model (PRNGKey(0)) through ``convert`` and,
at fsdp2 x tp2 and at tp4, quantizes the placed tree on the mesh: every
rank's int8 shards must be, bit for bit, the matching blocks of the port's
one-process ``quantize_params`` and of JAX's; its greedy tokens must be
JAX's int8 ``generate`` on a JAX fsdp2 x tp2 mesh of the virtual CPU
devices and the port's one-process int8 tokens; and a one-process
checkpoint served with ``int8=True`` on the gang must give those tokens.
"""

import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivedscheduler_tpu.models import generate as JG
from hivedscheduler_tpu.models import quantize as JQ
from hivedscheduler_tpu.models import transformer as JT
from hivedscheduler_tpu.parallel import mesh as jmesh
from hivedscheduler_tpu.parallel import sharding as JS
from hivedscheduler_tpu_torch.models import checkpoint, convert, generate, quantize, train
from hivedscheduler_tpu_torch.models import transformer
from hivedscheduler_tpu_torch.parallel import sharding

from ._multiproc import run_workers
from ._torch_rendezvous import gang_store
from ._torch_int8_worker import LAYOUTS, NEW_TOKENS, _flat

WORKER = os.path.join(os.path.dirname(__file__), "_torch_int8_worker.py")
CONFIG = transformer.tiny()
PROMPT = np.random.default_rng(1).integers(0, CONFIG.vocab_size, (4, 32))


@pytest.fixture(scope="module")
def masters():
    return jax.tree.map(np.asarray, JT.init(JT.tiny(), jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def reference(masters):
    """JAX's int8 tree and its greedy tokens on a JAX fsdp2 x tp2 mesh; the
    port's one-process int8 tree and tokens."""
    jcfg = JT.tiny()
    mesh = jmesh.make_mesh(jmesh.MeshConfig(fsdp=2, tp=2), devices=jax.devices()[:4])
    with jax.set_mesh(mesh):
        placed = jax.device_put(masters, JS.tree_shardings(mesh, JT.logical_axes(jcfg)))
        prompt = JS.shard_batch(jnp.asarray(PROMPT, jnp.int32), mesh)
        jax_tokens = JG.generate(JQ.quantize_params(placed), prompt, jcfg,
                                 max_new_tokens=NEW_TOKENS)
    port = quantize.quantize_params(convert.params_from_jax(masters, device="cpu"))
    tokens = generate.generate(port, torch.from_numpy(PROMPT), CONFIG, NEW_TOKENS)
    return {"jax": _flat(jax.tree.map(np.asarray, JQ.quantize_params(masters))),
            "jax_mesh_tokens": np.asarray(jax_tokens)[:, PROMPT.shape[1]:],
            "port": {k: v.numpy() for k, v in _flat(port).items()},
            "port_tokens": tokens[:, PROMPT.shape[1]:].numpy()}


@pytest.fixture(scope="module")
def gang(tmp_path_factory, masters):
    work = tmp_path_factory.mktemp("int8_gang")
    np.savez(work / "params.npz", **_flat(masters))
    np.savez(work / "int8.npz", **_flat(jax.tree.map(np.asarray, JQ.quantize_params(masters))))
    np.save(work / "prompt.npy", PROMPT)
    params = convert.params_from_jax(masters, device="cpu")
    checkpoint.TrainCheckpointer(str(work / "ckpt")).save(1, params,
                                                        train.make_optimizer(params))
    with gang_store(4) as port:
        outs = run_workers(WORKER, [[str(r), "4", str(port), str(work)] for r in range(4)],
                           timeout=300)
    return {"outs": outs, "work": work}


def rank_block(full, names, layout, coords):
    """The block of ``full`` a rank at ``coords`` holds under the rule table
    (plain numpy: each dim split over the mesh axis its name maps to)."""
    for d, axis in enumerate(sharding.spec_for(names)):
        n = LAYOUTS[layout].get(axis, 1) if axis else 1
        full = np.split(full, n, axis=d)[coords[axis]] if n > 1 else full
    return full


INT8_AXES = _flat(quantize.quantized_axes(transformer.logical_axes(CONFIG)))
INT8_KEYS = [k for k in INT8_AXES if k.endswith(("/w", "/scale"))]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_int8_shards_equal_the_one_process_and_jax_trees(gang, reference, layout):
    assert len(INT8_KEYS) == 2 * (len(quantize.LAYER_LINEAR_KEYS) + 1)
    for o in gang["outs"]:
        got = o["layouts"][layout]
        assert got["placements_match"] and got["jax_placed_equal"]
        shards = dict(np.load(gang["work"] / f"int8_{layout}_rank{o['rank']}.npz"))
        assert sorted(shards) == sorted(reference["port"])
        for key in INT8_KEYS:
            assert got["dtypes"][key] == ("torch.int8" if key.endswith("/w") else "torch.float32")
            for tree in ("port", "jax"):
                want = rank_block(reference[tree][key], INT8_AXES[key], layout, got["coords"])
                assert shards[key].dtype == want.dtype, key
                np.testing.assert_array_equal(shards[key], want, err_msg=f"{tree} {key}")


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_shard_digest_is_the_digest_of_the_rank_blocks(gang, reference, layout):
    for o in gang["outs"]:
        got = o["layouts"][layout]
        h = hashlib.sha256()
        for key in INT8_KEYS:
            h.update(np.ascontiguousarray(
                rank_block(reference["port"][key], INT8_AXES[key], layout, got["coords"])))
        assert got["digest"] == h.hexdigest()
    assert len({o["layouts"][layout]["digest"] for o in gang["outs"]}) == 4  # distinct blocks


def _rows(o, layout):
    got = o["layouts"][layout]
    n = len(got["tokens"])
    return slice(got["batch_rank"] * n, (got["batch_rank"] + 1) * n)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_gang_int8_tokens_equal_jax_on_a_mesh_and_one_process(gang, reference, layout):
    np.testing.assert_array_equal(reference["jax_mesh_tokens"], reference["port_tokens"])
    for o in gang["outs"]:
        rows = _rows(o, layout)
        got = o["layouts"][layout]
        np.testing.assert_array_equal(got["tokens"], reference["jax_mesh_tokens"][rows])
        np.testing.assert_array_equal(got["jax_placed_tokens"], reference["port_tokens"][rows])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_one_process_checkpoint_served_int8_on_the_gang(gang, reference, layout):
    for o in gang["outs"]:
        got = o["layouts"][layout]
        assert got["ckpt_equal"]
        np.testing.assert_array_equal(got["ckpt_tokens"], reference["port_tokens"][_rows(o, layout)])


def test_quantized_axes_place_the_scale_by_its_out_dim():
    axes = quantize.quantized_axes(transformer.logical_axes(CONFIG))
    assert axes["layers"]["wq"] == {"w": ("layers", "embed", "heads"),
                                    "scale": ("layers", "heads")}
    # wo and w_down: in dim over tp (the max's all-reduce), out dim over fsdp.
    for key, inner in (("wo", "heads"), ("w_down", "mlp")):
        assert axes["layers"][key] == {"w": ("layers", inner, "embed"),
                                       "scale": ("layers", "embed")}
        assert sharding.spec_for(axes["layers"][key]["w"])[1] == "tp"
        assert sharding.fsdp_dim(axes["layers"][key]["scale"][1:]) == 0
    assert axes["lm_head"] == {"w": ("embed", "vocab"), "scale": ("vocab",)}
    assert axes["layers"]["ln1"] == ("layers", None) and axes["embed"] == ("vocab", "embed")

