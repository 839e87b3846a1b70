"""Sequence parallelism in the port (parallel/ulysses.py, parallel/ring.py,
``sharding.sp_attention``, the sp half of the sharded step) against the
JAX package.

One 4-process gloo gang (``_torch_sp_worker.py``) runs Ulysses and ring
attention on seeded inputs over sp 4 and over sp 2 x tp 2, forward and
backward, held against the JAX package's ``ulysses_attention`` and
``ring_attention`` on the test process's 8 virtual CPU devices (rtol 2e-4 /
atol 2e-5, ``tests/test_flash_attention.py``'s; gradients within 1e-4 of
their largest). The same gang takes one sharded train step of the tiny
model on the dryrun's ``fsdp_sp_tp`` and ``ulysses-sp`` layouts and on
sp 4 with either backend, held against JAX's ``train_step`` and the port's
one-process step: seeded tokens catch a target lost at a shard boundary
and a gradient not summed over sp. It also runs Ulysses' exchange
(``sharding.all_to_all``) alone over sp 4 and over sp 2 x tp 2, forward
and backward, held bit for bit against the plain chunk exchange and to
its collective route (funcol's all-to-all, never c10d's synchronous one).
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from hivedscheduler_tpu.models import train as JTR
from hivedscheduler_tpu.models import transformer as JT
from hivedscheduler_tpu.parallel import mesh as jmesh
from hivedscheduler_tpu.parallel import ring as jring
from hivedscheduler_tpu.parallel import sharding as JS
from hivedscheduler_tpu.parallel import ulysses as julysses
from hivedscheduler_tpu_torch.models import convert, train, transformer
from hivedscheduler_tpu_torch.parallel import mesh as pmesh
from hivedscheduler_tpu_torch.parallel import ring, sharding, ulysses
from hivedscheduler_tpu_torch.tools import dryrun

from ._multiproc import run_workers
from ._torch_rendezvous import gang_store

WORKER = os.path.join(os.path.dirname(__file__), "_torch_sp_worker.py")
B, S, D = 2, 64, 16
RTOL, ATOL, GRAD_REL = 2e-4, 2e-5, 1e-4
JAX_TOL, PORT_TOL = 5e-3, 1e-5
SP4, SP2TP2 = {"sp": 4}, {"sp": 2, "tp": 2}
# name: (mesh, backend, heads, kv heads, causal, q_chunk)
ATTN = {
    "ulysses_sp4_h8kv4_causal": (SP4, "ulysses", 8, 4, True, None),
    "ulysses_sp4_h4kv2_causal_expand": (SP4, "ulysses", 4, 2, True, None),
    "ulysses_sp2tp2_h4kv2_full_expand": (SP2TP2, "ulysses", 4, 2, False, None),
    "ulysses_sp2tp2_h8kv4_causal": (SP2TP2, "ulysses", 8, 4, True, None),
    "ring_sp4_h4kv2_causal": (SP4, "ring", 4, 2, True, None),
    "ring_sp4_h4kv2_causal_qchunk4": (SP4, "ring", 4, 2, True, 4),
    "ring_sp2tp2_h4kv2_full": (SP2TP2, "ring", 4, 2, False, None),
    "ring_sp2tp2_h8kv4_causal_qchunk8": (SP2TP2, "ring", 8, 4, True, 8),
}
# name: (mesh, sp_mode, tokens); fsdp_sp_tp and ulysses-sp are the
# dryrun's rows at n = 4.
STEPS = {
    "fsdp_sp_tp_zeros": (SP2TP2, "auto", "zeros"),
    "fsdp_sp_tp_rng": (SP2TP2, "auto", "rng"),
    "ulysses-sp_zeros": (SP2TP2, "ulysses", "zeros"),
    "ulysses-sp_rng": (SP2TP2, "ulysses", "rng"),
    "sp4_ring_rng": (SP4, "ring", "rng"),
    "sp4_ulysses_rng": (SP4, "ulysses", "rng"),
}
# name: mesh of Ulysses' exchange alone; each rank's input and cotangent
# are [sp, 3, 5], dim 0 the axis size in equal chunks.
EXCHANGE = {"sp4": SP4, "sp2_tp2": SP2TP2}
TOKENS = {"zeros": np.zeros((4, 256), np.int64),
          "rng": np.random.default_rng(0).integers(0, 512, (4, 256))}
CONFIG = transformer.tiny()


def _inputs(name):
    _, _, h, hkv, _, _ = ATTN[name]
    rng = np.random.default_rng(sorted(ATTN).index(name))
    return {t: rng.standard_normal(shape).astype(np.float32) for t, shape in
            (("q", (B, S, h, D)), ("k", (B, S, hkv, D)), ("v", (B, S, hkv, D)),
             ("w", (B, S, h, D)))}


def _exchange_inputs(name):
    """Each rank's input x and cotangent w of the exchange case."""
    sp = EXCHANGE[name]["sp"]
    rng = np.random.default_rng(100 + sorted(EXCHANGE).index(name))
    return {f"{t}{r}": rng.standard_normal((sp, 3, 5)).astype(np.float32)
            for r in range(4) for t in "xw"}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, JT.init(JT.tiny(), jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def gang(tmp_path_factory, jax_params):
    work = tmp_path_factory.mktemp("sp")
    inputs = {name: _inputs(name) for name in ATTN}
    np.savez(work / "attn.npz", **{f"{n}/{t}": a for n, d in inputs.items() for t, a in d.items()})
    exchange = {name: _exchange_inputs(name) for name in EXCHANGE}
    np.savez(work / "exchange.npz",
             **{f"{n}/{t}": a for n, d in exchange.items() for t, a in d.items()})
    cases = {"attn": {n: {"mesh": m, "backend": be, "causal": c, "q_chunk": qc}
                      for n, (m, be, _, _, c, qc) in ATTN.items()},
             "exchange": EXCHANGE,
             "step": {n: {"mesh": m, "sp_mode": mode, "tokens": t}
                      for n, (m, mode, t) in STEPS.items()}}
    (work / "cases.json").write_text(json.dumps(cases))
    np.savez(work / "params.npz", **_flat(jax_params))
    np.savez(work / "tokens.npz", **TOKENS)
    with gang_store(4) as port:
        outs = run_workers(WORKER, [[str(r), "4", str(port), str(work)] for r in range(4)],
                           timeout=400)
    shards = [dict(np.load(work / f"attn_{r}.npz")) for r in range(4)]
    exchanged = [dict(np.load(work / f"exchange_{r}.npz")) for r in range(4)]
    return {"outs": outs, "work": work, "shards": shards, "inputs": inputs,
            "exchange": exchange, "exchanged": exchanged}


def _assemble(shards, name, t, mesh):
    """The global array from the 4 ranks' shards (rank = sp_rank * tp + tp_rank)."""
    sp, tp = mesh.get("sp", 1), mesh.get("tp", 1)
    rows = [np.concatenate([shards[s * tp + t_][f"{name}/{t}"] for t_ in range(tp)], axis=2)
            for s in range(sp)]
    return np.concatenate(rows, axis=1)


def _jax_attention(name, inputs):
    """JAX's output and gradients of sum(out * w) on 4 virtual CPU devices."""
    mesh_sizes, backend, _, _, causal, q_chunk = ATTN[name]
    mesh = jmesh.make_mesh(jmesh.MeshConfig(**mesh_sizes), devices=jax.devices()[:4])
    spec = NamedSharding(mesh, P(("dp", "fsdp"), "sp", "tp", None))
    q, k, v = (jax.device_put(jnp.asarray(inputs[t]), spec) for t in "qkv")
    w = jnp.asarray(inputs["w"])

    def attend(q, k, v):
        if backend == "ulysses":
            return julysses.ulysses_attention(q, k, v, mesh, causal=causal)
        return jring.ring_attention(q, k, v, mesh, causal=causal, q_chunk=q_chunk)

    out = jax.jit(attend)(q, k, v)
    grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(attend(q, k, v) * w), argnums=(0, 1, 2)))(
        q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", sorted(ATTN))
def test_attention_matches_jax(gang, name):
    want, _ = _jax_attention(name, gang["inputs"][name])
    got = _assemble(gang["shards"], name, "out", ATTN[name][0])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(ATTN))
def test_attention_gradients_match_jax(gang, name):
    _, grads = _jax_attention(name, gang["inputs"][name])
    for t, want in zip(("dq", "dk", "dv"), grads):
        got = _assemble(gang["shards"], name, t, ATTN[name][0])
        assert np.abs(got - want).max() <= GRAD_REL * np.abs(want).max(), t


@pytest.mark.parametrize("name", sorted(ATTN))
def test_attention_routes(gang, name):
    mesh, backend, h, hkv, _, _ = ATTN[name]
    heads = h // (mesh.get("tp", 1) * mesh["sp"])
    for o in gang["outs"]:
        got = o["attn_routes"][name]
        if backend == "ulysses":  # one local call at the full sequence, H/(tp*sp) heads
            assert got == {"mha": 1, "heads": [heads], "ring": 0}
        else:  # ring's local step is plain torch: no mha call
            assert got == {"mha": 0, "heads": [], "ring": 1}


@pytest.mark.parametrize("name", sorted(EXCHANGE))
def test_all_to_all_is_the_plain_chunk_exchange_bitwise(gang, name):
    # Rank r (sp index s, tp index t) receives chunk s of each sp peer's
    # input, in the peers' sp order; backward sends each peer its chunk of
    # the cotangent back: dx[j] = chunk s of peer j's cotangent.
    sizes, data = EXCHANGE[name], gang["exchange"][name]
    sp, tp = sizes["sp"], sizes.get("tp", 1)
    for r in range(4):
        s, t = divmod(r, tp)
        peers = [i * tp + t for i in range(sp)]
        got = gang["exchanged"][r]
        assert np.array_equal(got[f"{name}/y"], np.stack([data[f"x{p}"][s] for p in peers]))
        assert np.array_equal(got[f"{name}/dx"], np.stack([data[f"w{p}"][s] for p in peers]))


@pytest.mark.parametrize("name", sorted(EXCHANGE))
def test_all_to_all_takes_the_collective_route_that_captures(gang, name):
    # One funcol all-to-all forward and one backward (its async call, then
    # wait_tensor, as every other collective of a step), no synchronous
    # c10d all-to-all, whose NCCL call runs on the calling thread's stream.
    for o in gang["outs"]:
        assert o["exchange_calls"][name] == {"funcol": 2, "c10d": 0}


@pytest.fixture(scope="module")
def reference(jax_params):
    """Per token set: JAX's step loss, the port's one-process loss and
    gradients (by path)."""
    optimizer = JTR.make_optimizer()
    out = {}
    for name, toks in TOKENS.items():
        jp = jax.tree.map(jnp.asarray, jax_params)
        _, _, jloss = JTR.train_step(jp, optimizer.init(jp), jnp.asarray(toks, jnp.int32),
                                     JT.tiny(), optimizer)
        params = convert.params_from_jax(jax_params, device="cpu")
        loss = train.train_step(params, train.make_optimizer(params), torch.from_numpy(toks),
                                CONFIG, "cpu")
        out[name] = {"jax": float(jloss), "port": loss.item(),
                     "grads": {k: v.grad.numpy() for k, v in _flat(params).items()}}
    return out


@pytest.mark.parametrize("name", sorted(STEPS))
def test_sp_step_loss_matches_jax_and_one_process(gang, reference, name):
    ref = reference[STEPS[name][2]]
    losses = [o["losses"][name] for o in gang["outs"]]
    assert len(set(losses)) == 1, losses  # every rank reports the global mean
    assert abs(losses[0] - ref["jax"]) <= JAX_TOL
    assert abs(losses[0] - ref["port"]) <= PORT_TOL


@pytest.mark.parametrize("name", sorted(STEPS))
def test_sp_step_gradients_match_one_process(gang, reference, name):
    want = reference[STEPS[name][2]]["grads"]
    got = dict(np.load(gang["work"] / f"grads_{name}.npz"))
    assert sorted(got) == sorted(want)
    step_max = max(np.abs(g).max() for g in want.values())
    for path, g in want.items():
        # All-zero tokens make the q and k projections' gradients cancel to
        # ~1e-8 of the step's largest (test_torch_sharding.py): such a leaf
        # is held at the floor of GRAD_REL of the step's largest.
        scale = max(np.abs(g).max(), GRAD_REL * step_max)
        assert np.abs(got[path] - g).max() <= GRAD_REL * scale, path


@pytest.mark.parametrize("name", sorted(STEPS))
def test_sp_step_attends_through_its_backend(gang, name):
    mesh, mode, _ = STEPS[name]
    heads = CONFIG.n_heads // (mesh.get("tp", 1) * mesh["sp"])
    layers = CONFIG.n_layers
    for o in gang["outs"]:
        got = o["step_routes"][name]
        if mode == "ulysses":  # the kernels' path: mha at the full sequence
            assert got == {"mha": layers, "heads": [heads] * layers, "ring": 0}
        else:  # "auto" on the CPU, and "ring": ring attention
            assert got == {"mha": 0, "heads": [], "ring": layers}


def _mesh(**sizes):
    return types.SimpleNamespace(mesh_dim_names=pmesh.MESH_AXES,
                                 shape=tuple(sizes.get(a, 1) for a in pmesh.MESH_AXES))


@pytest.mark.parametrize("h,hkv,s,sizes", [
    (4, 4, 64, dict(sp=4, fsdp=2)), (8, 2, 64, dict(sp=4, fsdp=2)),
    (6, 6, 64, dict(sp=4, fsdp=2)), (4, 4, 66, dict(sp=4, fsdp=2)),
    (4, 3, 64, dict(sp=4, fsdp=2)), (8, 8, 64, dict(fsdp=8)),
    (4, 2, 256, dict(sp=2, tp=2)), (32, 8, 131072, dict(sp=2, tp=4)),
    (32, 8, 131072, dict(sp=4, tp=4)), (32, 8, 131072, dict(sp=8, tp=4)),
    (4, 2, 64, dict(sp=2, tp=4)),
])
def test_can_ulysses_is_the_jax_gate(h, hkv, s, sizes):
    # The JAX gate reads only the mesh's axis sizes (its ``shape`` map), so
    # a stand-in holds meshes larger than the test process's 8 devices.
    jm = types.SimpleNamespace(shape={a: sizes.get(a, 1) for a in jmesh.MESH_AXES})
    assert ulysses.can_ulysses(_mesh(**sizes), h, hkv, s) == julysses.can_ulysses(jm, h, hkv, s)


@pytest.mark.parametrize("mode,legal,on_cuda,want", [
    ("auto", True, True, "ulysses"),  # the card: the kernels run on the full sequence
    ("auto", True, False, "ring"),  # the CPU, as the JAX package off the TPU
    ("auto", False, True, "ring"),
    ("ring", True, True, "ring"),
    ("ulysses", True, False, "ulysses"),
])
def test_sp_backend_choice(mode, legal, on_cuda, want):
    h, hkv = (4, 2) if legal else (6, 6)
    assert sharding.sp_backend(_mesh(sp=4), h, hkv, 64, mode, on_cuda) == want


def test_an_explicit_ulysses_on_an_illegal_mesh_raises():
    with pytest.raises(ValueError, match="sp_mode='ulysses' but heads/seq"):
        sharding.sp_backend(_mesh(sp=4), 6, 6, 64, "ulysses", True)
    with pytest.raises(ValueError, match="unknown sp_mode"):
        sharding.sp_backend(_mesh(sp=4), 4, 4, 64, "zigzag", True)
    with pytest.raises(ValueError, match="unknown sp_mode"):
        transformer.tiny().__class__(sp_mode="zigzag")
    assert sharding.SP_MODES == JS.SP_MODES


@pytest.mark.parametrize("sq,sk,q_chunk", [(64, 64, None), (16, 16, 4), (4096, 4096, None),
                                           (8192, 8192, None), (100, 100, 7), (96, 3000, 40)])
def test_q_chunk_size_is_the_jax_one(sq, sk, q_chunk):
    assert ring._q_chunk_size(sq, sk, q_chunk) == jring._q_chunk_size(sq, sk, q_chunk)


def test_dryrun_sequence_rows_at_four_processes():
    result = dryrun.dryrun(4, rows=("fsdp_sp_tp", "ulysses-sp"), device="cpu", timeout=300)
    assert sorted(result["rows"]) == ["fsdp_sp_tp", "ulysses-sp"]
    assert all(abs(v - result["reference"]) <= dryrun.TOL for v in result["rows"].values())
    assert dryrun.layouts(4, ["fsdp_sp_tp"]) == {"fsdp_sp_tp": dict(fsdp=1, sp=2, tp=2)}
    # sp does not fit 2 processes next to tp 2: no ulysses-sp row there.
    assert dryrun.layouts(2, ["fsdp_sp_tp", "ulysses-sp"]) == {
        "fsdp_sp_tp": dict(fsdp=1, sp=1, tp=2)}
