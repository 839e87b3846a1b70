"""The port's sharded step (hivedscheduler_tpu_torch.parallel.sharding, the
mesh half of models/train.py, transformer.logical_axes) against the JAX
package and against the port's own one-process step.

One 4-process gloo gang (``_torch_sharding_worker.py gang``) takes one step
of the tiny model under fsdp2 x tp2, dp2 x fsdp2 and tp4 from the JAX
package's ``init`` (PRNGKey(0)) on all-zero tokens (the dryrun's batch) and
on seeded random ones; it also holds ``sharded_mha`` and the vocab-parallel
lookup against the whole computation and moves checkpoints between one
process and the fsdp2 x tp2 layout. A one-rank gloo mesh must equal the
unsharded step bit for bit.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from hivedscheduler_tpu.models import train as JTR
from hivedscheduler_tpu.models import transformer as JT
from hivedscheduler_tpu.parallel import sharding as JS
from hivedscheduler_tpu_torch.models import checkpoint, convert, train, transformer
from hivedscheduler_tpu_torch.parallel import mesh as pmesh
from hivedscheduler_tpu_torch.parallel import sharding
from hivedscheduler_tpu_torch.tools import dryrun

from ._multiproc import run_workers
from ._torch_rendezvous import gang_store

WORKER = os.path.join(os.path.dirname(__file__), "_torch_sharding_worker.py")
TOKENS = {"zeros": np.zeros((4, 256), np.int64),
          "rng": np.random.default_rng(0).integers(0, 512, (4, 256))}
CASES = ["fsdp2_tp2_zeros", "fsdp2_tp2_rng", "dp2_fsdp2_zeros", "dp2_fsdp2_rng", "tp4_rng"]
# The dryrun's gate against the JAX step; the port's own one-process step
# does the same arithmetic in another order of sums.
JAX_TOL, PORT_TOL, GRAD_REL = 5e-3, 1e-5, 1e-4
CONFIG = transformer.tiny()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def _one_process(seed=3):
    params = transformer.init(CONFIG, torch.Generator().manual_seed(seed), "cpu", torch.float32)
    return params, train.make_optimizer(params)


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, JT.init(JT.tiny(), jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def reference(jax_params):
    """Per token set: the JAX step's loss, the port's one-process loss and
    gradients (by path)."""
    optimizer = JTR.make_optimizer()
    out = {}
    for name, toks in TOKENS.items():
        jp = jax.tree.map(jnp.asarray, jax_params)
        _, _, jloss = JTR.train_step(jp, optimizer.init(jp), jnp.asarray(toks, jnp.int32),
                                     JT.tiny(), optimizer)
        params = convert.params_from_jax(jax_params, device="cpu")
        opt = train.make_optimizer(params)
        loss = train.train_step(params, opt, torch.from_numpy(toks), CONFIG, "cpu")
        out[name] = {"jax": float(jloss), "port": loss.item(),
                     "grads": {k: v.grad.numpy() for k, v in _flat(params).items()}}
    return out


@pytest.fixture(scope="module")
def gang(tmp_path_factory, jax_params):
    work = tmp_path_factory.mktemp("gang")
    np.savez(work / "params.npz", **_flat(jax_params))
    np.savez(work / "tokens.npz", **TOKENS)
    params, opt = _one_process()
    train.train_step(params, opt, torch.from_numpy(TOKENS["rng"][:2, :64]), CONFIG, "cpu")
    checkpoint.TrainCheckpointer(str(work / "ckpt_one")).save(1, params, opt)
    with gang_store(4) as port:
        outs = run_workers(WORKER, [["gang", str(r), "4", str(port), str(work)] for r in range(4)],
                           timeout=400)
    return {"outs": outs, "work": work, "saved": (params, opt)}


@pytest.mark.parametrize("case", CASES)
def test_sharded_loss_matches_jax_and_one_process(gang, reference, case):
    ref = reference[case.rsplit("_", 1)[1]]
    losses = [o["losses"][case] for o in gang["outs"]]
    assert len(set(losses)) == 1, losses  # every rank reports the global mean
    assert abs(losses[0] - ref["jax"]) <= JAX_TOL
    assert abs(losses[0] - ref["port"]) <= PORT_TOL


@pytest.mark.parametrize("case", CASES)
def test_sharded_gradients_match_one_process(gang, reference, case):
    want = reference[case.rsplit("_", 1)[1]]["grads"]
    got = dict(np.load(gang["work"] / f"grads_{case}.npz"))
    assert sorted(got) == sorted(want)
    step_max = max(np.abs(g).max() for g in want.values())
    for name, g in want.items():
        # All-zero tokens make every position alike: the q and k
        # projections' gradients cancel to ~1e-8 of the step's largest,
        # where the two runs' orders of summation alone differ. Such a leaf
        # is held at the floor of GRAD_REL of the step's largest.
        scale = max(np.abs(g).max(), GRAD_REL * step_max)
        assert np.abs(got[name] - g).max() <= GRAD_REL * scale, name


@pytest.mark.parametrize("case,heads", [
    ("fsdp2_tp2_rng", CONFIG.n_heads // 2), ("dp2_fsdp2_rng", CONFIG.n_heads),
    ("tp4_rng", CONFIG.n_heads),
])
def test_attention_takes_the_kernels_on_both_sides_of_the_gate(gang, case, heads):
    # tiny has 2 KV heads: tp 4 does not divide them, so each rank gathers
    # every head and still goes through mha (the kernels on the card).
    for o in gang["outs"]:
        assert o["routes"][case] == {"mha": CONFIG.n_layers, "mha_reference": 0,
                                     "heads": [heads] * CONFIG.n_layers}


@pytest.mark.parametrize("case,gate", [("h4_kv2", True), ("h4_kv1", False)])
def test_sharded_mha_on_both_sides_of_its_gate(gang, case, gate):
    for o in gang["outs"]:
        got = o["sharded_mha"][case]
        assert got["gate"] is gate
        # The gate decides the heads mha takes (this rank's 2 of 4, or all
        # 4 gathered), never whether mha runs.
        assert got["routes"] == {"mha": 1, "mha_reference": 0, "heads": [2 if gate else 4]}
        assert got["max_err"] <= 1e-5


def test_vocab_parallel_lookup_equals_the_gather(gang):
    assert all(o["embed_equal"] for o in gang["outs"])


def test_moments_are_placed_like_their_parameters(gang):
    assert all(o["moment_placements_match"] for o in gang["outs"])


def _assert_state_equal(arrays, params, opt):
    from ._torch_sharding_worker import _state_arrays

    want = _state_arrays(params, opt)
    assert sorted(arrays) == sorted(want)
    for k, v in want.items():
        assert arrays[k].dtype == v.dtype and np.array_equal(arrays[k], v), k


def test_one_process_checkpoint_restores_into_the_gang_bitwise(gang):
    assert all(o["restored_step"] == 1 for o in gang["outs"])
    _assert_state_equal(dict(np.load(gang["work"] / "restored.npz")), *gang["saved"])


def test_gang_checkpoint_restores_in_one_process_bitwise(gang):
    params, opt = _one_process(seed=11)
    _, _, step = checkpoint.TrainCheckpointer(str(gang["work"] / "ckpt_gang")).restore(params, opt)
    assert step == 2
    _assert_state_equal(dict(np.load(gang["work"] / "gang_state.npz")), params, opt)


def test_one_rank_mesh_equals_the_unsharded_step_bitwise(tmp_path):
    np.savez(tmp_path / "tokens.npz", **TOKENS)
    with gang_store(1) as port:
        (out,) = run_workers(WORKER, [["one", "0", "1", str(port), str(tmp_path)]], timeout=240)
    assert out["init_equal"] and out["losses_equal"] and out["params_equal"], out


def test_logical_axes_and_specs_match_jax():
    for tcfg, jcfg in ((transformer.tiny(), JT.tiny()), (transformer.llama3_8b(), JT.llama3_8b())):
        t_axes, j_axes = transformer.logical_axes(tcfg), JT.logical_axes(jcfg)
        assert t_axes == j_axes
        for axes in _flat(t_axes).values():
            assert sharding.spec_for(axes) == tuple(JS.spec_for(axes))
    assert sharding.DEFAULT_RULES == JS.DEFAULT_RULES


def _mesh(**sizes):
    """A stand-in with a DeviceMesh's names, shape and local ranks (rank 0
    on every axis unless ``coord`` says otherwise)."""
    coord = sizes.pop("coord", {})
    names = pmesh.MESH_AXES
    return types.SimpleNamespace(
        mesh_dim_names=names, shape=tuple(sizes.get(a, 1) for a in names),
        get_local_rank=lambda a: coord.get(a, 0))


def test_placements_under_default_rules():
    mesh = _mesh(fsdp=2, tp=2)
    axes = transformer.logical_axes(CONFIG)
    R = Replicate()
    placements = sharding.tree_shardings(mesh, axes)
    # (dp, pp, fsdp, ep, sp, tp); the layer dim maps to pp.
    assert placements["embed"] == (R, R, Shard(1), R, R, Shard(0))
    assert placements["lm_head"] == (R, R, Shard(0), R, R, Shard(1))
    assert placements["layers"]["wq"] == (R, Shard(0), Shard(1), R, R, Shard(2))
    assert placements["layers"]["wo"] == (R, Shard(0), Shard(2), R, R, Shard(1))
    assert placements["layers"]["w_down"] == (R, Shard(0), Shard(2), R, R, Shard(1))
    assert placements["layers"]["ln1"] == (R, Shard(0), R, R, R, R)
    assert placements["ln_f"] == (R,) * 6
    assert sharding.fsdp_dim(axes["layers"]["wo"][1:]) == 1
    assert sharding.fsdp_dim(axes["layers"]["ln1"][1:]) is None
    with pytest.raises(ValueError, match="shards two dims"):
        sharding.placements_for(("embed", "embed"), mesh)


@pytest.mark.parametrize("batch,heads,kv,sizes,want", [
    (4, 32, 8, dict(fsdp=2, tp=8), True),
    (4, 4, 2, dict(tp=2), True),
    (4, 4, 2, dict(tp=4), False),  # tp does not divide the KV heads
    (3, 4, 2, dict(fsdp=2), False),  # the batch does not divide dp x fsdp
    (4, 6, 2, dict(tp=4), False),
    (4, 4, 2, dict(sp=2), False),  # sp > 1 is ring/Ulysses attention's
])
def test_mha_gate_is_the_jax_gate(batch, heads, kv, sizes, want):
    assert sharding.mha_shardable(batch, heads, kv, _mesh(**sizes)) is want


def test_shard_batch_takes_this_ranks_rows():
    batch = torch.arange(8 * 6).reshape(8, 6)
    mesh = _mesh(dp=2, fsdp=2, tp=2, coord={"dp": 1, "fsdp": 0, "tp": 1})
    assert torch.equal(sharding.shard_batch(batch, mesh), batch[4:6])
    with pytest.raises(ValueError, match="does not split"):
        sharding.shard_batch(batch[:6], mesh)


@pytest.mark.parametrize("axis,item", [("ep", 12)])
def test_later_axes_raise(axis, item):
    # ROADMAP queue 1 item 12 ported expert parallelism: ep is accepted and
    # placed; only a mesh without the six axes is refused.
    sharding.check_supported(_mesh(**{axis: 2}))
    assert axis in sharding.param_axes(_mesh(**{axis: 2}))
    with pytest.raises(ValueError, match="not"):
        sharding.check_supported(types.SimpleNamespace(mesh_dim_names=("fsdp", axis), shape=(2, 2)))


def test_sequence_parallelism_is_supported():
    sharding.check_supported(_mesh(sp=2, tp=2))  # no longer raises


def test_inactive_meshes_keep_the_unsharded_path():
    assert not sharding.is_active(None)
    assert not sharding.is_active(pmesh.single_device_mesh("cpu"))  # no process group


def test_dryrun_four_processes():
    result = dryrun.dryrun(4, device="cpu", timeout=300)
    assert sorted(result["rows"]) == ["dp", "ep-moe", "fsdp", "fsdp_sp_tp", "fsdp_tp", "pp",
                                      "pp-x-sp", "ulysses-sp"]
    # Each row against its own one-process step (ep-moe: Mixtral's).
    assert all(abs(v - result["references"][row]) <= dryrun.TOL
               for row, v in result["rows"].items())
    assert all(result["references"][row] == result["reference"]
               for row in result["rows"] if row != "ep-moe")


def test_dryrun_record_is_empty_when_every_rank_ends(tmp_path):
    # --record arms each rank's stack dump and its process group's timeout;
    # a gang that ends in time leaves empty stacks and no recorder dump.
    result = dryrun.dryrun(2, rows=("fsdp",), device="cpu", timeout=300, record=str(tmp_path))
    assert abs(result["rows"]["fsdp"] - result["reference"]) <= dryrun.TOL
    assert sorted(p.name for p in tmp_path.iterdir()) == ["rank0.stacks", "rank1.stacks"]
    assert all(p.stat().st_size == 0 for p in tmp_path.iterdir())


def test_dryrun_without_a_device_needs_cuda(monkeypatch):
    # As every entry point of the port: CUDA unless the CPU is asked for,
    # and no process is started when there is none.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(dryrun.subprocess, "Popen", lambda *a, **kw: pytest.fail("spawned"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun(4, rows=("fsdp",))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.reference_loss()


@pytest.mark.parametrize("row,item", [("ep-moe", 12)])
def test_dryrun_names_the_item_of_a_later_row(row, item):
    # Item 12 ported the last later row: none is left, and ep-moe lays out
    # as the JAX dryrun's expert row.
    assert dryrun.LATER_ROWS == {} and row in dryrun.ROWS
    assert dryrun.layouts(4, [row]) == {row: dict(fsdp=2, ep=2)}
    assert dryrun.layouts(3, [row]) == {}  # n odd: the JAX dryrun skips it
