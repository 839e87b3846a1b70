"""Pipeline parallelism in the port (parallel/pipeline.py, the pp half of the
sharded step, the ``pp`` and ``pp-x-sp`` dryrun rows, the ``train_pp`` twin)
against the plain layer loop and the JAX package.

A 4-process gloo gang (``_torch_pipeline_worker.py``) runs
``pipeline_blocks`` over an MLP stack at (pp, fsdp) = (2, 2) and (4, 1)
with several microbatch counts, awkward batches and M = 1, held against
the plain loop (outputs within 1e-5, gradients within 1e-4 of their
largest, as ``tests/test_models.py`` holds the JAX pipeline). The same gang
takes one sharded step of the tiny model on pp 2 x tp 2 (the dryrun's
``pp``), pp 2 x fsdp 2 and pp 2 x sp 2 under ring and Ulysses (the dryrun's
``pp-x-sp``), and an 8-process gang pp 2 x sp 2 x tp 2 (the JAX test's
mesh) takes it too, held against JAX's ``train_step`` (5e-3) and gradients
(atol 2e-3, rtol 2e-2), against the port's one-process step (1e-5), and
with the leaves replicated over pp bitwise equal on every stage; it moves
a train state between one process and pp 2 x tp 2. Two launched pods of
two "cards" run the ``train_pp`` twin like a gang booted from JAX blocks.
"""

import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivedscheduler_tpu.models import train as JTR
from hivedscheduler_tpu.models import transformer as JT
from hivedscheduler_tpu.parallel import mesh as jmesh
from hivedscheduler_tpu.parallel import pipeline as jpipeline
from hivedscheduler_tpu_torch import serve
from hivedscheduler_tpu_torch.models import checkpoint, convert, train, transformer
from hivedscheduler_tpu_torch.parallel import mesh as pmesh
from hivedscheduler_tpu_torch.parallel import pipeline, sharding
from hivedscheduler_tpu_torch.tools import dryrun
from hivedscheduler_tpu_torch.workloads import train_pp

from ._multiproc import run_workers
from ._torch_entry_worker import parting_leaf
from ._torch_rendezvous import gang_store
from .test_torch_env import launched_pods
from .test_torch_workloads import gang as entry_gang

WORKER = os.path.join(os.path.dirname(__file__), "_torch_pipeline_worker.py")
FWD_TOL, GRAD_REL = 1e-5, 1e-4
JAX_TOL, PORT_TOL = 5e-3, 1e-5
JAX_GRAD = {"atol": 2e-3, "rtol": 2e-2}
D, SEQ = 32, 8
# name: (pp, fsdp, microbatches, layers, global batch)
MLP = {
    "pp2_fsdp2_m2_L4_B8": (2, 2, 2, 4, 8),
    "pp2_fsdp2_default_L2_B4": (2, 2, None, 2, 4),
    "pp2_fsdp2_m1_L4_B6": (2, 2, 1, 4, 6),  # M = 1: the stages in turn
    "pp2_fsdp2_default_L4_B6": (2, 2, None, 4, 6),  # 3 rows a rank: M = 3
    "pp4_fsdp1_m4_L4_B4": (4, 1, 4, 4, 4),
    "pp4_fsdp1_m8_L4_B8": (4, 1, 8, 4, 8),  # more microbatches than stages
    "pp4_fsdp1_default_L8_B5": (4, 1, None, 8, 5),  # M = 5
    "pp4_fsdp1_m2_L8_B6": (4, 1, 2, 8, 6),
    "pp4_fsdp1_m1_L4_B3": (4, 1, 1, 4, 3),
}
PP_TP2, PP_SP2 = {"pp": 2, "tp": 2}, {"pp": 2, "sp": 2}
# name: (mesh, config fields, tokens); "pp" and "pp-x-sp" are the dryrun's rows.
STEPS = {
    "pp_tp2_rng": (PP_TP2, {}, "rng"),
    "pp_tp2_zeros": (PP_TP2, {}, "zeros"),
    "pp_tp2_m1_remat_full_rng": (PP_TP2, {"pp_microbatches": 1, "remat": True}, "rng"),
    "pp_fsdp2_rng": ({"pp": 2, "fsdp": 2}, {}, "rng"),
    "pp_sp2_ring_rng": (PP_SP2, {"sp_mode": "ring"}, "rng"),
    "pp_sp2_ulysses_remat_flash_rng": (
        PP_SP2, {"sp_mode": "ulysses", "remat": True, "remat_policy": "flash"}, "rng"),
    # An 8-process gang on the JAX test's mesh (test_pp_x_sp_matches_single_device).
    "pp2_sp2_tp2_ring_zeros": ({"pp": 2, "sp": 2, "tp": 2}, {"sp_mode": "ring"}, "zeros"),
    "pp2_sp2_tp2_ulysses_rng": ({"pp": 2, "sp": 2, "tp": 2}, {"sp_mode": "ulysses"}, "rng"),
}
# bf16 compute: the anchor of a stage before the last must be an f32 zero
# like the loss it stands for (the stages' losses are summed over pp).
BF16_STEPS = {"pp_tp2_bf16_rng": (PP_TP2, {"dtype": "bfloat16"}, "rng")}
BF16_TOL = 5e-2  # bf16 activations against the f32 one-process loss
TOKENS = {"zeros": np.zeros((4, 256), np.int64),
          "rng": np.random.default_rng(0).integers(0, 512, (4, 256))}
CONFIG = transformer.tiny()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def _mlp_inputs(name):
    _, _, _, layers, batch = MLP[name]
    rng = np.random.default_rng(sorted(MLP).index(name))
    f = np.float32
    return {"w": (rng.standard_normal((layers, D, D)) * 0.3).astype(f),
            "b": (rng.standard_normal((layers, D)) * 0.1).astype(f),
            "x": rng.standard_normal((batch, SEQ, D)).astype(f),
            "c": rng.standard_normal((batch, SEQ, D)).astype(f)}


def _one_process(seed=3):
    params = transformer.init(CONFIG, torch.Generator().manual_seed(seed), "cpu", torch.float32)
    return params, train.make_optimizer(params)


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, JT.init(JT.tiny(), jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def gang(tmp_path_factory, jax_params):
    work = tmp_path_factory.mktemp("pp")
    inputs = {name: _mlp_inputs(name) for name in MLP}
    np.savez(work / "mlp.npz", **{f"{n}/{t}": a for n, d in inputs.items() for t, a in d.items()})
    for world in (4, 8):
        steps = {n: {"mesh": m, "config": c, "tokens": t}
                 for n, (m, c, t) in {**STEPS, **BF16_STEPS}.items()
                 if np.prod(list(m.values())) == world}
        mlp = {n: {"pp": pp, "fsdp": f, "m": m} for n, (pp, f, m, _, _) in MLP.items()}
        cases = {"mlp": mlp if world == 4 else {}, "step": steps, "extras": world == 4}
        (work / f"cases{world}.json").write_text(json.dumps(cases))
    np.savez(work / "params.npz", **_flat(jax_params))
    np.savez(work / "tokens.npz", **TOKENS)
    params, opt = _one_process()
    train.train_step(params, opt, torch.from_numpy(TOKENS["rng"][:2, :64]), CONFIG, "cpu")
    checkpoint.TrainCheckpointer(str(work / "ckpt_one")).save(1, params, opt)
    outs = {}
    for world in (4, 8):
        with gang_store(world) as port:
            outs[world] = run_workers(WORKER, [[str(r), str(world), str(port), str(work),
                                                f"cases{world}.json"] for r in range(world)],
                                      timeout=400)
    return {"outs": outs[4], "outs8": outs[8], "work": work, "inputs": inputs,
            "saved": (params, opt)}


def _step_outs(gang, name):
    """The ranks' results of a step case (the gang its mesh needs)."""
    return gang["outs"] if np.prod(list(STEPS[name][0].values())) == 4 else gang["outs8"]


def _plain_mlp(inputs):
    w, b = (torch.from_numpy(inputs[k]).requires_grad_() for k in "wb")
    x = torch.from_numpy(inputs["x"]).requires_grad_()
    h = x
    for i in range(w.shape[0]):
        h = torch.tanh(h @ w[i] + b[i])
    (h * torch.from_numpy(inputs["c"])).sum().backward()
    return h.detach().numpy(), {"dx": x.grad.numpy(), "dw": w.grad.numpy(), "db": b.grad.numpy()}


def _mlp_results(gang, name):
    """The gang's output and gradients, assembled: the last stage's rows in
    batch order, stage 0's dx, the layers' gradients summed over ranks."""
    outs = {}
    for o in gang["outs"]:
        info = o["mlp"][name]
        arrays = dict(np.load(gang["work"] / f"mlp_{name}_{o['rank']}.npz"))
        for k in ("out", "dx"):
            if k in arrays:
                outs.setdefault(k, {})[info["batch_rank"]] = arrays[k]
        for k in ("dw", "db"):
            outs[k] = outs.get(k, 0) + arrays[k]
    for k in ("out", "dx"):
        outs[k] = np.concatenate([outs[k][i] for i in sorted(outs[k])])
    return outs


@pytest.mark.parametrize("name", sorted(MLP))
def test_pipeline_matches_the_plain_loop(gang, name):
    want, _ = _plain_mlp(gang["inputs"][name])
    got = _mlp_results(gang, name)["out"]
    assert got.shape == want.shape
    assert np.abs(got - want).max() < FWD_TOL
    for o in gang["outs"]:  # every stage before the last returns its zero anchor
        info = o["mlp"][name]
        assert (info["anchor"] is None) == (info["stage"] == MLP[name][0] - 1)
        assert info["anchor"] in (None, 0.0)


@pytest.mark.parametrize("name", sorted(MLP))
def test_pipeline_gradients_match_the_plain_loop(gang, name):
    _, want = _plain_mlp(gang["inputs"][name])
    got = _mlp_results(gang, name)
    for k, g in want.items():
        assert np.abs(got[k] - g).max() <= GRAD_REL * np.abs(g).max(), k


@pytest.mark.parametrize("batch,pp,want", [(10, 4, 5), (3, 2, 3), (8, 2, 4), (6, 2, 3),
                                           (7, 4, 7), (11, 4, 1), (4, 8, 4), (1, 2, 1)])
def test_default_microbatches_is_the_jax_rule(batch, pp, want):
    # pipeline_blocks' rule (hivedscheduler_tpu/parallel/pipeline.py): the
    # largest divisor of the batch not above 2 * pp.
    assert pipeline.microbatches(batch, pp) == want
    jax_rule = max(d for d in range(1, min(batch, 2 * pp) + 1) if batch % d == 0)
    assert want == jax_rule


def _stand_in(**sizes):
    return types.SimpleNamespace(mesh_dim_names=pmesh.MESH_AXES,
                                 shape=tuple(sizes.get(a, 1) for a in pmesh.MESH_AXES),
                                 get_local_rank=lambda a: 0)


@pytest.mark.parametrize("layers,m,match", [(6, None, "n_layers"), (8, 3, "n_microbatches")])
def test_divisibility_errors_are_the_jax_ones(layers, m, match):
    def block_t(h, layer):
        return torch.tanh(h @ layer["w"])

    def block_j(h, layer):
        return jnp.tanh(h @ layer["w"]), None

    w = np.zeros((layers, 32, 32), np.float32)
    x = np.zeros((4, 16, 32), np.float32)
    jm = jmesh.make_mesh(jmesh.MeshConfig(pp=4, fsdp=2), devices=jax.devices())
    with pytest.raises(ValueError, match=match) as jerr:
        jpipeline.pipeline_blocks({"w": jnp.asarray(w)}, jnp.asarray(x), jm, block_j,
                                  n_microbatches=m)
    with pytest.raises(ValueError, match=match) as terr:
        pipeline.pipeline_blocks({"w": torch.from_numpy(w)}, torch.from_numpy(x),
                                 _stand_in(pp=4, fsdp=2), block_t, n_microbatches=m)
    assert str(terr.value) == str(jerr.value)


def test_one_stage_is_the_plain_loop():
    w = torch.randn(3, 8, 8, generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 4, 8, generator=torch.Generator().manual_seed(1))
    got = pipeline.pipeline_blocks({"w": w}, x, _stand_in(fsdp=4), lambda h, l: h @ l["w"])
    assert torch.equal(got, x @ w[0] @ w[1] @ w[2])
    assert torch.equal(pipeline.pipeline_blocks({"w": w}, x, None, lambda h, l: h @ l["w"]), got)


@pytest.fixture(scope="module")
def reference(jax_params):
    """Per token set: JAX's step loss and gradients, the port's one-process
    loss and gradients (by path) and logits."""
    optimizer = JTR.make_optimizer()
    out = {}
    for name, toks in TOKENS.items():
        jp = jax.tree.map(jnp.asarray, jax_params)
        jt = jnp.asarray(toks, jnp.int32)
        _, _, jloss = JTR.train_step(jp, optimizer.init(jp), jt, JT.tiny(), optimizer)
        jgrads = jax.grad(lambda p: JTR.next_token_loss(p, jt, JT.tiny(), None))(jp)
        params = convert.params_from_jax(jax_params, device="cpu")
        with torch.no_grad():
            logits = transformer.forward(params, torch.from_numpy(toks), CONFIG).numpy()
        loss = train.train_step(params, train.make_optimizer(params), torch.from_numpy(toks),
                                CONFIG, "cpu")
        out[name] = {"jax": float(jloss), "port": loss.item(), "logits": logits,
                     "jax_grads": {k: np.asarray(v) for k, v in _flat(jgrads).items()},
                     "grads": {k: v.grad.numpy() for k, v in _flat(params).items()}}
    return out


@pytest.mark.parametrize("name", sorted(STEPS))
def test_pp_step_loss_matches_jax_and_one_process(gang, reference, name):
    ref = reference[STEPS[name][2]]
    losses = [o["losses"][name] for o in _step_outs(gang, name)]
    assert len(set(losses)) == 1, losses  # every rank reports the global mean
    assert abs(losses[0] - ref["jax"]) <= JAX_TOL
    assert abs(losses[0] - ref["port"]) <= PORT_TOL


@pytest.mark.parametrize("name", sorted(BF16_STEPS))
def test_pp_step_in_bf16_reports_one_loss_on_every_rank(gang, reference, name):
    losses = [o["losses"][name] for o in gang["outs"]]
    assert len(set(losses)) == 1, losses
    assert abs(losses[0] - reference[BF16_STEPS[name][2]]["port"]) <= BF16_TOL


@pytest.mark.parametrize("name", sorted(STEPS))
def test_pp_step_gradients_match_jax_and_one_process(gang, reference, name):
    ref = reference[STEPS[name][2]]
    got = dict(np.load(gang["work"] / f"grads_{name}.npz"))
    assert sorted(got) == sorted(ref["grads"]) == sorted(ref["jax_grads"])
    step_max = max(np.abs(g).max() for g in ref["grads"].values())
    for path, g in ref["grads"].items():
        np.testing.assert_allclose(got[path], ref["jax_grads"][path], err_msg=path, **JAX_GRAD)
        # All-zero tokens: see test_torch_sharding.py (a floor of GRAD_REL
        # of the step's largest for leaves whose gradients cancel).
        scale = max(np.abs(g).max(), GRAD_REL * step_max)
        assert np.abs(got[path] - g).max() <= GRAD_REL * scale, path


@pytest.mark.parametrize("name", sorted(STEPS))
def test_pp_replicated_leaves_are_bitwise_equal_on_every_stage(gang, name):
    groups = {}
    for o in _step_outs(gang, name):
        coord = o["coords"][name]
        key = tuple(v for a, v in sorted(coord.items()) if a != "pp")
        arrays = dict(np.load(gang["work"] / f"replicated_{name}_{o['rank']}.npz"))
        groups.setdefault(key, []).append(arrays)
    assert all(len(g) == 2 for g in groups.values())  # two stages a group
    for first, second in groups.values():
        for k in ("embed", "ln_f", "lm_head"):
            assert first[k].tobytes() == second[k].tobytes(), k


@pytest.mark.parametrize("name", sorted(STEPS))
def test_pp_step_attends_through_its_backend(gang, name):
    mesh, fields, _ = STEPS[name]
    config = dataclasses.replace(CONFIG, **fields)
    per_stage = CONFIG.n_layers // mesh["pp"]
    rows = 4 // mesh.get("fsdp", 1)
    calls = per_stage * pipeline.microbatches(rows, mesh["pp"], config.pp_microbatches)
    if config.remat:
        calls *= 2  # the recompute attends again ("flash" keeps the kernel's outputs)
    for o in _step_outs(gang, name):
        if fields.get("sp_mode") == "ring":  # ring's local step is plain torch
            assert o["routes"][name] == {"mha": 0, "ring": calls}
        else:
            assert o["routes"][name] == {"mha": calls, "ring": 0}


def test_pp_forward_broadcasts_the_last_stages_logits(gang, reference):
    got = np.load(gang["work"] / "logits_pp.npy")  # rank 0: stage 0, tp rank 0
    want = reference["rng"]["logits"][..., : CONFIG.vocab_size // 2]
    assert all(o["logits_shape"] == list(got.shape) for o in gang["outs"])
    assert np.abs(got - want).max() <= FWD_TOL


def _assert_state_equal(arrays, params, opt):
    from ._torch_sharding_worker import _state_arrays

    want = _state_arrays(params, opt)
    assert sorted(arrays) == sorted(want)
    for k, v in want.items():
        assert arrays[k].dtype == v.dtype and np.array_equal(arrays[k], v), k


def test_one_process_checkpoint_restores_into_pp_stages_bitwise(gang):
    assert all(o["restored_step"] == 1 for o in gang["outs"])
    _assert_state_equal(dict(np.load(gang["work"] / "restored.npz")), *gang["saved"])


def test_pp_checkpoint_restores_in_one_process_bitwise(gang):
    params, opt = _one_process(seed=11)
    _, _, step = checkpoint.TrainCheckpointer(str(gang["work"] / "ckpt_pp")).restore(params, opt)
    assert step == 2
    _assert_state_equal(dict(np.load(gang["work"] / "pp_state.npz")), params, opt)


def test_pipeline_axis_is_supported_and_expert_parallelism_still_raises():
    sharding.check_supported(_stand_in(pp=2, sp=2, tp=2))  # no longer raises
    assert sharding.param_axes(_stand_in(pp=2, tp=2)) == ("dp", "pp", "fsdp", "tp")
    assert sharding.param_axes(_stand_in(fsdp=2, tp=2)) == ("dp", "fsdp", "tp")
    # Expert parallelism is ported too (ROADMAP queue 1 item 12): ep joins
    # the parameter sub-mesh in mesh order where it has more than one rank.
    sharding.check_supported(_stand_in(ep=2))
    assert sharding.param_axes(_stand_in(fsdp=2, ep=2)) == ("dp", "fsdp", "ep", "tp")
    assert sharding.param_axes(_stand_in(pp=2, ep=2, tp=2)) == ("dp", "pp", "fsdp", "ep", "tp")


def test_serving_refuses_a_pipelined_mesh(monkeypatch):
    monkeypatch.setattr(sharding, "is_active", lambda mesh: True)
    with pytest.raises(NotImplementedError, match="unpipelined"):
        serve.build("tiny", 0, "cpu", mesh=_stand_in(pp=2, tp=2))


def test_dryrun_pipeline_rows_at_four_processes():
    result = dryrun.dryrun(4, rows=("pp", "pp-x-sp"), device="cpu", timeout=300)
    assert sorted(result["rows"]) == ["pp", "pp-x-sp"]
    assert all(abs(v - result["reference"]) <= dryrun.TOL for v in result["rows"].values())
    assert dryrun.layouts(4, ["pp", "pp-x-sp"]) == {"pp": dict(pp=2, fsdp=1, tp=2),
                                                   "pp-x-sp": dict(pp=2, sp=2, fsdp=1)}
    assert dryrun.layouts(8, ["pp"]) == {"pp": dict(pp=2, fsdp=2, tp=2)}
    assert dryrun.layouts(2, ["pp", "pp-x-sp"]) == {}  # n % 4 != 0: the JAX dryrun skips them
    # One of tiny's 2 layers a stage, 4 microbatches of the 4 rows.
    assert result["expected"] == {"pp": 4, "pp-x-sp": 4}


@pytest.mark.parametrize("n,sp,kv,want", [
    (4, 1, 8, dict(pp=2, sp=1, fsdp=1, tp=2)), (8, 1, 8, dict(pp=2, sp=1, fsdp=1, tp=4)),
    (16, 1, 8, dict(pp=2, sp=1, fsdp=2, tp=4)), (8, 2, 8, dict(pp=2, sp=2, fsdp=1, tp=2)),
    (2, 1, 8, dict(pp=2, sp=1, fsdp=1, tp=1)), (16, 1, 2, dict(pp=2, sp=1, fsdp=4, tp=2)),
])
def test_train_pp_mesh_is_the_jax_twins(n, sp, kv, want):
    # tp: the first of 4, 2, 1 dividing the cards per stage and the KV heads.
    got = train_pp.mesh_config(n, sp, kv)
    assert dataclasses.asdict(got) == {"dp": 1, "ep": 1, **want}


@pytest.mark.parametrize("n,sp,match", [(3, 1, "even device count"), (4, 3, "must divide")])
def test_train_pp_refuses_what_the_jax_twin_refuses(n, sp, match):
    with pytest.raises(SystemExit, match=match):
        train_pp.mesh_config(n, sp, 2)


def test_two_launched_pods_run_train_pp_like_a_gang_booted_from_jax_blocks(tmp_path):
    argv = ["--model", "tiny", "--seq", "256", "--batch", "4", "--steps", "2"]
    outs = launched_pods("launched_pp", argv, tmp_path)
    ref = entry_gang("train_pp", 4, argv)
    assert sorted(o["rank"] for o in outs) == [0, 1, 2, 3]
    for o in outs + ref:
        # Two gangs of one run: a parting names the first leaf whose bits
        # differ after the first step (ROADMAP queue 3, F5's rest).
        assert o["world"] == 4 and o["losses"] == ref[0]["losses"], (
            o["rank"], o["losses"], ref[0]["losses"], parting_leaf(outs, ref))
    assert len(ref[0]["losses"]) == 2 and all(np.isfinite(ref[0]["losses"]))

