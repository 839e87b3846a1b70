"""BERT in the port (models/bert.py, workloads/train_bert.py) against the
JAX package's ``models/bert.py`` and its twin.

On one process: BERT tiny's forward on the JAX package's weights at
``tests/test_model_zoo.py``'s tolerance (atol 2e-4, rtol 2e-3), the masked
loss (exactly 0 with nothing masked, JAX's value with every or some
positions masked) and its gradients, the tanh GELU, the population-variance
LayerNorm, the tree's layout, and the twin's AdamW against
``optax.adamw(1e-4)``. One 4-process gloo gang (``_torch_bert_worker.py``)
takes a step on fsdp 2 x tp 2, dp 2 x tp 2 and tp 4 with unequal masked
counts per batch shard (the global masked mean, the fused QKV split over
tp), held against JAX's ``value_and_grad(mlm_loss)`` and the port's one
process.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from hivedscheduler_tpu.models import bert as JB
from hivedscheduler_tpu_torch.models import bert, convert
from hivedscheduler_tpu_torch.workloads import train_bert

from ._multiproc import run_workers
from ._torch_rendezvous import gang_store

WORKER = os.path.join(os.path.dirname(__file__), "_torch_bert_worker.py")
FWD = {"atol": 2e-4, "rtol": 2e-3}
JAX_GRAD = {"atol": 2e-3, "rtol": 2e-2}
LOSS_TOL, PORT_TOL, GRAD_REL = 1e-4, 1e-5, 1e-4
CONFIG = bert.tiny()
B, S = 4, 64
# Unequal masked counts per row, so per batch shard (rows 0-1 vs 2-3).
ROW_MASKED = (40, 20, 5, 1)
CASES = {
    "fsdp2_tp2_uneven": ({"fsdp": 2, "tp": 2}, "uneven"),
    "dp2_tp2_uneven": ({"dp": 2, "tp": 2}, "uneven"),
    "tp4_uneven": ({"tp": 4}, "uneven"),
    "fsdp2_tp2_none": ({"fsdp": 2, "tp": 2}, "none"),
}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def _batch():
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, CONFIG.vocab_size, (B, S))
    uneven = np.full((B, S), -100)
    for row, n in enumerate(ROW_MASKED):
        cols = rng.choice(S, n, replace=False)
        uneven[row, cols] = tokens[row, cols]
    return {"tokens": tokens, "uneven": uneven, "none": np.full((B, S), -100),
            "all": tokens.copy()}


BATCH = _batch()


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, JB.init(JB.tiny(), jax.random.PRNGKey(0)))


def _port(jax_params):
    return convert.params_from_jax(jax_params, device="cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


@pytest.mark.parametrize("batch,seq", [(2, 32), (4, 128)])
def test_forward_matches_jax(jax_params, batch, seq):
    tokens = np.random.default_rng(seq).integers(0, CONFIG.vocab_size, (batch, seq))
    want = np.asarray(JB.forward(jax.tree.map(jnp.asarray, jax_params), jnp.asarray(tokens),
                                 JB.tiny()))
    with torch.no_grad():
        got = bert.forward(_port(jax_params), _t(tokens), CONFIG).numpy()
    assert got.shape == (batch, seq, CONFIG.vocab_size)
    np.testing.assert_allclose(got, want, **FWD)


@pytest.mark.parametrize("targets", ["none", "all", "uneven"])
def test_mlm_loss_matches_jax(jax_params, targets):
    jp = jax.tree.map(jnp.asarray, jax_params)
    want = float(JB.mlm_loss(jp, jnp.asarray(BATCH["tokens"]), jnp.asarray(BATCH[targets]),
                             JB.tiny()))
    got = bert.mlm_loss(_port(jax_params), _t(BATCH["tokens"]), _t(BATCH[targets]), CONFIG).item()
    if targets == "none":
        assert got == 0.0 and want == 0.0  # only masked positions count
    else:
        assert got > 0.0 and abs(got - want) <= LOSS_TOL


@pytest.fixture(scope="module")
def reference(jax_params):
    """Per target set: JAX's loss and gradients, the port's one-process
    loss, gradients and logits."""
    jp = jax.tree.map(jnp.asarray, jax_params)
    out = {}
    for name in ("uneven", "none"):
        jloss, jgrads = jax.value_and_grad(JB.mlm_loss)(
            jp, jnp.asarray(BATCH["tokens"]), jnp.asarray(BATCH[name]), JB.tiny())
        params = _port(jax_params)
        with torch.no_grad():
            logits = bert.forward(params, _t(BATCH["tokens"]), CONFIG).numpy()
        opt = train_bert.make_optimizer(params)
        loss = train_bert.train_step(params, opt, _t(BATCH["tokens"]), _t(BATCH[name]), CONFIG)
        out[name] = {"jax": float(jloss), "port": loss.item(), "logits": logits,
                     "jax_grads": {k: np.asarray(v) for k, v in _flat(jgrads).items()},
                     "grads": {k: v.grad.numpy() for k, v in _flat(params).items()}}
    return out


def test_one_process_gradients_match_jax(reference):
    ref = reference["uneven"]
    step_max = max(np.abs(g).max() for g in ref["jax_grads"].values())
    for path, g in ref["jax_grads"].items():
        assert np.abs(ref["grads"][path] - g).max() <= GRAD_REL * step_max, path


def test_gelu_is_the_tanh_approximation():
    rng = np.random.default_rng(0)
    h, w_up, w_down = (rng.standard_normal(s).astype(np.float32) * 2
                       for s in ((8, 16), (16, 32), (32, 16)))
    want = np.asarray(jax.nn.gelu(jnp.asarray(h) @ w_up) @ w_down)
    got = bert.ffn(*(torch.from_numpy(a) for a in (h, w_up, w_down))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    erf = (F.gelu(torch.from_numpy(h) @ torch.from_numpy(w_up)) @ torch.from_numpy(w_down)).numpy()
    assert np.abs(erf - want).max() > 1e-3  # torch's default GELU would not pass


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((4, 8, 64)) * 3 + 1).astype(np.float32)
    scale, bias = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    jx, tx = jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))
    js, jb = (jnp.asarray(a, getattr(jnp, dtype)) for a in (scale, bias))
    ts, tb = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (scale, bias))
    want = np.asarray(JB.layer_norm(jx, js, jb).astype(jnp.float32))
    got = bert.layer_norm(tx, ts, tb)
    assert got.dtype == tx.dtype
    # bf16: scale and bias apply in f32, then one rounding (one bf16 ulp of
    # the output at most between two f32 paths).
    tol = 1e-5 if dtype == "float32" else 2 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)
    x32 = tx.float()  # the sample variance (torch's default) would not pass
    sample = (x32 - x32.mean(-1, keepdim=True)) * torch.rsqrt(x32.var(-1, keepdim=True) + 1e-5)
    assert np.abs((sample * ts.float() + tb.float()).numpy() - want).max() > tol


def test_tree_layout_configs_and_conversion_match_jax(jax_params):
    for port_cfg, jax_cfg in ((bert.bert_large(), JB.bert_large()), (bert.tiny(), JB.tiny())):
        fields = {f.name: getattr(port_cfg, f.name) for f in dataclasses.fields(port_cfg)}
        jfields = {k: v for k, v in jax_cfg.__dict__.items() if k != "dtype"}
        assert {k: v for k, v in fields.items() if k != "dtype"} == jfields
        assert bert.logical_axes(port_cfg) == JB.logical_axes(jax_cfg)
    ours = bert.init(CONFIG, torch.Generator().manual_seed(0), "cpu")
    shapes = {k: tuple(v.shape) for k, v in _flat(ours).items()}
    assert shapes == {k: v.shape for k, v in _flat(jax_params).items()}
    back = _flat(convert.params_to_numpy(_port(jax_params)))
    assert all(np.array_equal(back[k], v) for k, v in _flat(jax_params).items())


def test_adamw_is_optax_adamw(jax_params, reference):
    jp = jax.tree.map(jnp.asarray, jax_params)
    opt = optax.adamw(1e-4)
    _, grads = jax.value_and_grad(JB.mlm_loss)(jp, jnp.asarray(BATCH["tokens"]),
                                               jnp.asarray(BATCH["uneven"]), JB.tiny())
    updates, _ = opt.update(grads, opt.init(jp), jp)
    want = _flat(jax.tree.map(np.asarray, optax.apply_updates(jp, updates)))
    params = _port(jax_params)
    train_bert.train_step(params, train_bert.make_optimizer(params), _t(BATCH["tokens"]),
                          _t(BATCH["uneven"]), CONFIG)
    got = _flat(convert.params_to_numpy(params))
    # Adam's first update is lr * sign(g) element by element: a gradient
    # near 0 that the two sides round to opposite signs moves its element
    # 2 lr apart, however close the gradients are; the mean stays small.
    diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert diffs.max() <= 2 * 1e-4 + 1e-6 and diffs.mean() <= 1e-6


def test_masked_batch_is_the_jax_twins():
    tokens, targets = train_bert.masked_batch(np.random.default_rng(1), 8, 512, 30522)
    masked = targets >= 0
    assert abs(masked.float().mean().item() - 0.15) < 0.01
    assert bool((tokens[masked] == 103).all()) and bool((targets[~masked] == -100).all())


def test_train_bert_main_on_cpu(capsys):
    records = train_bert.main(["--layers", "1", "--steps", "2", "--device", "cpu"])
    assert [r["step"] for r in records] == [0, 1]
    assert all(np.isfinite(r["loss"]) and abs(r["loss"] - np.log(30522)) < 1.5 for r in records)
    assert "step 1 mlm loss" in capsys.readouterr().out


@pytest.fixture(scope="module")
def gang(tmp_path_factory, jax_params):
    work = tmp_path_factory.mktemp("bert")
    (work / "cases.json").write_text(json.dumps(
        {n: {"mesh": m, "targets": t} for n, (m, t) in CASES.items()}))
    np.savez(work / "params.npz", **_flat(jax_params))
    np.savez(work / "batch.npz", **BATCH)
    with gang_store(4) as port:
        outs = run_workers(WORKER, [[str(r), "4", str(port), str(work)] for r in range(4)],
                           timeout=300)
    return {"outs": outs, "work": work}


def test_batch_shards_hold_unequal_mask_counts():
    counts = (BATCH["uneven"] >= 0).sum(axis=1)
    assert counts[:2].sum() != counts[2:].sum()


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_loss_matches_jax_and_one_process(gang, reference, name):
    ref = reference[CASES[name][1]]
    losses = [o["losses"][name] for o in gang["outs"]]
    assert len(set(losses)) == 1, losses  # every rank reports the global masked mean
    if CASES[name][1] == "none":
        assert losses[0] == 0.0
    assert abs(losses[0] - ref["jax"]) <= LOSS_TOL
    assert abs(losses[0] - ref["port"]) <= PORT_TOL


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_gradients_match_jax_and_one_process(gang, reference, name):
    ref = reference[CASES[name][1]]
    got = dict(np.load(gang["work"] / f"grads_{name}.npz"))
    assert sorted(got) == sorted(ref["grads"])
    step_max = max(np.abs(g).max() for g in ref["grads"].values())
    for path, g in ref["grads"].items():
        np.testing.assert_allclose(got[path], ref["jax_grads"][path], err_msg=path, **JAX_GRAD)
        assert np.abs(got[path] - g).max() <= GRAD_REL * max(step_max, 1e-30), path


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_forward_and_heads(gang, reference, name):
    mesh, targets = CASES[name]
    tp = mesh.get("tp", 1)
    rows = B // (mesh.get("dp", 1) * mesh.get("fsdp", 1))
    got = np.load(gang["work"] / f"logits_{name}.npy")  # rank 0's rows and vocab shard
    want = reference[targets]["logits"][:rows, :, : CONFIG.vocab_size // tp]
    np.testing.assert_allclose(got, want, **FWD)
    for o in gang["outs"]:  # each tp rank attends over its own heads, once a layer
        assert o["heads"][name] == [CONFIG.n_heads // tp] * CONFIG.n_layers
