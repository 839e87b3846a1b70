"""Mixtral in the port (models/mixtral.py, the ``ffn`` hook of
models/generate.py, workloads/train_mixtral.py) against the JAX package's
``models/mixtral.py`` on one process.

The JAX package's ``mixtral.init(tiny(), PRNGKey(0))`` weights go across
through ``convert.params_from_jax``. Routing (each round's picks and
positions, exactly), ``moe_ffn``'s output and aux loss, ``forward``,
``lm_loss`` and every gradient at ``tests/test_model_zoo.py``'s tolerances
(atol 2e-4 / rtol 2e-3, aux rtol 1e-4); a 6-step AdamW run against
optax's; prefill and decode through the ``ffn`` hook against the JAX
package's cached decode, at capacity factor 16 and at the default; the
refusal of pp > 1; the train-state plan of Mixtral-8x7B on a stand-in
fsdp 8 x ep 8 mesh, without allocating.
"""

import dataclasses
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.distributed.tensor import Shard

from hivedscheduler_tpu.models import generate as JG
from hivedscheduler_tpu.models import mixtral as JM
from hivedscheduler_tpu_torch import serve
from hivedscheduler_tpu_torch.models import convert, generate, mixtral, model_of, train
from hivedscheduler_tpu_torch.models import transformer
from hivedscheduler_tpu_torch.parallel import mesh as pmesh
from hivedscheduler_tpu_torch.workloads import train_mixtral

TOL = {"atol": 2e-4, "rtol": 2e-3}
AUX_RTOL = 1e-4
CONFIG = mixtral.tiny()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, JM.init(JM.tiny(), jax.random.PRNGKey(0)))


def _port(jax_params, dtype=torch.float32):
    return convert.params_from_jax(jax_params, device="cpu", dtype=dtype)


def _layer0(tree):
    return {k: v[0] for k, v in tree["layers"].items()}


def _jax_routing(gates, config, T):
    """The reference's routing loop (``mixtral.moe_ffn``), each round's
    picks and positions."""
    E, K = config.n_experts, config.experts_per_token
    remaining, occupancy = gates, jnp.zeros((E,), jnp.float32)
    picks, positions = [], []
    for _ in range(K):
        idx = jnp.argmax(remaining, axis=-1)
        onehot = jax.nn.one_hot(idx, E, dtype=jnp.float32)
        pos = (jnp.cumsum(onehot, axis=0) - onehot) + occupancy[None, :]
        picks.append(np.asarray(idx))
        positions.append(np.asarray(jnp.sum(pos * onehot, axis=-1).astype(jnp.int32)))
        occupancy = occupancy + jnp.sum(onehot, axis=0)
        remaining = remaining * (1.0 - onehot)
    return np.stack(picks), np.stack(positions)


def _gates(kind, shape, E):
    rng = np.random.default_rng(3)
    if kind == "random":
        logits = rng.standard_normal(shape + (E,)).astype(np.float32) * 2
    elif kind == "skewed":  # most tokens want expert 0: drops past the capacity
        logits = rng.standard_normal(shape + (E,)).astype(np.float32)
        logits[..., 0] += 3.0
    else:  # ties: the first maximum wins in both
        logits = np.zeros(shape + (E,), np.float32)
        logits[::2, ..., 1] = 1.0
    return np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))


@pytest.mark.parametrize("kind", ["random", "skewed", "ties"])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_routing_picks_and_positions_equal_jax(kind, cf):
    config = dataclasses.replace(CONFIG, capacity_factor=cf)
    gates = _gates(kind, (4, 16), config.n_experts)
    want_picks, want_pos = _jax_routing(jnp.asarray(gates.reshape(64, -1)), config, 64)
    r = mixtral.route(torch.from_numpy(gates), config)
    assert np.array_equal(r.picks.reshape(2, -1).numpy(), want_picks)
    assert np.array_equal(r.positions.reshape(2, -1).numpy(), want_pos)
    assert r.capacity == max(2, int(math.ceil(2 * 64 / 4 * cf)))
    assert r.load.tolist() == np.bincount(want_picks.ravel(), minlength=4).tolist()


@pytest.mark.parametrize("kind", ["random", "skewed"])
def test_no_slot_holds_two_tokens(kind):
    # test_model_zoo.py's collision check: every (expert, slot) below the
    # capacity holds at most one token over both rounds.
    r = mixtral.route(torch.from_numpy(_gates(kind, (2, 32), 4)), CONFIG)
    kept = r.positions < r.capacity
    slots = list(zip(r.picks[kept].tolist(), r.positions[kept].tolist()))
    assert len(slots) == len(set(slots)) and len(slots) > 0


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_ffn_matches_jax(jax_params, cf):
    jconfig = dataclasses.replace(JM.tiny(), capacity_factor=cf)
    config = dataclasses.replace(CONFIG, capacity_factor=cf)
    h = np.random.default_rng(2).standard_normal((2, 16, 64)).astype(np.float32)
    layer = jax.tree.map(jnp.asarray, _layer0(jax_params))
    want, want_aux = JM.moe_ffn(jnp.asarray(h), layer, jconfig)
    with torch.no_grad():
        got, aux = mixtral.moe_ffn(torch.from_numpy(h), _layer0(_port(jax_params)), config)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert abs(aux.item() - float(want_aux)) <= AUX_RTOL * abs(float(want_aux))
    if cf < 1:  # some tokens were dropped: both rounds full, their output 0
        dropped = np.all(np.asarray(want) == 0, axis=-1)
        assert dropped.any() and np.all(got.numpy()[dropped] == 0)


@pytest.mark.parametrize("batch,seq", [(4, 16), (2, 64)])
def test_forward_and_aux_match_jax(jax_params, batch, seq):
    tokens = np.random.default_rng(seq).integers(0, CONFIG.vocab_size, (batch, seq))
    want, want_aux = JM.forward(jax.tree.map(jnp.asarray, jax_params), jnp.asarray(tokens),
                                JM.tiny())
    with torch.no_grad():
        got, aux = mixtral.forward(_port(jax_params), torch.from_numpy(tokens), CONFIG)
    assert got.shape == (batch, seq, CONFIG.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert abs(aux.item() - float(want_aux)) <= AUX_RTOL * abs(float(want_aux))


@pytest.mark.parametrize("remat", [False, True])
def test_lm_loss_and_every_gradient_match_jax(jax_params, remat):
    tokens = np.random.default_rng(1).integers(0, CONFIG.vocab_size, (4, 16))
    loss, grads = jax.value_and_grad(JM.lm_loss)(jax.tree.map(jnp.asarray, jax_params),
                                                 jnp.asarray(tokens), JM.tiny())
    params = _port(jax_params)
    for t in transformer.leaves(params):
        t.requires_grad_(True)
    got = mixtral.lm_loss(params, torch.from_numpy(tokens),
                          dataclasses.replace(CONFIG, remat=remat))
    got.backward()
    assert abs(got.item() - float(loss)) <= TOL["atol"]
    port = _flat(params)
    for path, g in _flat(grads).items():
        np.testing.assert_allclose(port[path].grad.numpy(), np.asarray(g), err_msg=path, **TOL)


def test_six_adamw_steps_follow_optax_and_the_loss_falls(jax_params):
    tokens = np.random.default_rng(1).integers(0, CONFIG.vocab_size, (4, 16))
    opt = optax.adamw(1e-3)
    jp = jax.tree.map(jnp.asarray, jax_params)
    state = opt.init(jp)
    want = []
    for _ in range(6):
        loss, grads = jax.value_and_grad(JM.lm_loss)(jp, jnp.asarray(tokens), JM.tiny())
        updates, state = opt.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        want.append(float(loss))
    params = _port(jax_params)
    optimizer = train_mixtral.make_optimizer(params, 1e-3)
    got = [train_mixtral.train_step(params, optimizer, torch.from_numpy(tokens), CONFIG).item()
           for _ in range(6)]
    assert got[-1] < got[0]
    np.testing.assert_allclose(got, want, atol=1e-3)


def _jax_decode(jax_params, config, prompt, prefill_len):
    ffn = JM.decode_ffn(config)
    jp = jax.tree.map(jnp.asarray, jax_params)
    cache = JG.init_cache(config, prompt.shape[0], prompt.shape[1])
    logits, cache = JG.prefill(jp, jnp.asarray(prompt[:, :prefill_len]), cache, config, ffn=ffn)
    out = [np.asarray(logits)]
    for t in range(prefill_len, prompt.shape[1]):
        logits, cache = JG.decode_step(jp, jnp.asarray(prompt[:, t]), cache, config, ffn=ffn)
        out.append(np.asarray(logits))
    return np.stack(out, 1)


@pytest.mark.parametrize("cf", [16.0, 1.25])
def test_prefill_and_decode_through_the_ffn_hook_match_jax(jax_params, cf):
    # At the default capacity a step of B tokens has max(2, ceil(2B/E*1.25))
    # slots an expert, so decode drops tokens; both sides drop the same.
    config = dataclasses.replace(CONFIG, capacity_factor=cf)
    prompt = np.random.default_rng(4).integers(0, CONFIG.vocab_size, (2, 10))
    want = _jax_decode(jax_params, dataclasses.replace(JM.tiny(), capacity_factor=cf), prompt, 6)
    params, ffn = _port(jax_params), mixtral.decode_ffn(config)
    assert mixtral.decode_ffn(config) is ffn  # one hook object per config
    cache = generate.init_cache(config, 2, 10, "cpu")
    logits, cache = generate.prefill(params, torch.from_numpy(prompt[:, :6]), cache, config,
                                     ffn=ffn)
    got = [logits]
    for t in range(6, 10):
        logits, cache = generate.decode_step(params, torch.from_numpy(prompt[:, t]), cache,
                                             config, ffn=ffn)
        got.append(logits)
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), want, **TOL)
    if cf == 16.0:  # no drops: the uncached forward agrees position for position
        with torch.no_grad():
            full, _ = mixtral.forward(params, torch.from_numpy(prompt), config)
        np.testing.assert_allclose(torch.stack(got, 1).numpy(), full[:, 5:].numpy(), **TOL)


def test_dense_path_is_unchanged_without_the_hook():
    config = transformer.tiny()
    params = transformer.init(config, torch.Generator().manual_seed(0), "cpu")
    prompt = torch.randint(0, config.vocab_size, (2, 12), generator=torch.Generator().manual_seed(1))
    a = generate.generate(params, prompt, config, 4)
    assert torch.equal(a, generate.generate(params, prompt, config, 4, ffn=None))


def test_pp_is_refused_with_the_jax_message(jax_params):
    mesh = types.SimpleNamespace(mesh_dim_names=pmesh.MESH_AXES, shape=(1, 2, 1, 1, 1, 1),
                                 get_local_rank=lambda a: 0)
    with pytest.raises(NotImplementedError) as jerr:
        JM.forward(jax.tree.map(jnp.asarray, jax_params), jnp.zeros((1, 8), jnp.int32),
                   JM.tiny(), types.SimpleNamespace(shape={"pp": 2}))
    with pytest.raises(NotImplementedError) as terr:
        mixtral.forward(_port(jax_params), torch.zeros(1, 8, dtype=torch.long), CONFIG, mesh)
    assert str(terr.value) == str(jerr.value)


def test_configs_tree_and_conversion_match_jax(jax_params):
    for port_cfg, jax_cfg in ((mixtral.mixtral_8x7b(), JM.mixtral_8x7b()),
                              (mixtral.tiny(), JM.tiny())):
        fields = {f.name: getattr(port_cfg, f.name) for f in dataclasses.fields(port_cfg)}
        jfields = {k: v for k, v in jax_cfg.__dict__.items() if k != "dtype"}
        assert {k: v for k, v in fields.items() if k != "dtype"} == jfields
        assert mixtral.logical_axes(port_cfg) == JM.logical_axes(jax_cfg)
        assert model_of(port_cfg) is mixtral
    assert model_of(transformer.tiny()) is transformer
    ours = mixtral.init(CONFIG, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in _flat(ours).items()} == {
        k: v.shape for k, v in _flat(jax_params).items()}
    back = _flat(convert.params_to_numpy(_port(jax_params)))
    assert all(np.array_equal(back[k], v) for k, v in _flat(jax_params).items())


class _StandIn(types.SimpleNamespace):
    """A mesh's names, sizes and slicing, without processes."""

    def __getitem__(self, names):
        sizes = dict(zip(self.mesh_dim_names, self.shape))
        return _StandIn(mesh_dim_names=tuple(names), shape=tuple(sizes[n] for n in names))


def test_mixtral_8x7b_train_state_plan_on_fsdp8_ep8():
    """The port's counterpart of the JAX package's MOE_CHILD lowering check
    (tests/test_8b_lowering.py): Mixtral-8x7B's train-state placements on a
    stand-in fsdp 8 x ep 8 mesh, and each rank's share of the f32
    parameters and AdamW's two moments, from meta tensors only."""
    config = mixtral.mixtral_8x7b()
    mesh = _StandIn(mesh_dim_names=pmesh.MESH_AXES,
                    shape=tuple(dict(fsdp=8, ep=8).get(a, 1) for a in pmesh.MESH_AXES))
    param_pl, opt_pl = train.shardings_for(config, mesh, model=mixtral)
    assert opt_pl["exp_avg"] is param_pl and opt_pl["exp_avg_sq"] is param_pl
    shapes = _flat(mixtral.init(config, torch.Generator(), "meta", torch.float32))
    assert all(t.is_meta for t in shapes.values())
    assert sum(t.numel() for t in shapes.values()) == 46_702_792_704
    sub = dict(zip(("dp", "fsdp", "ep", "tp"), (1, 8, 8, 1)))
    local, experts, rest = 0, 0, 0
    for path, t in shapes.items():
        shape = list(t.shape)
        for axis, p in zip(("dp", "fsdp", "ep", "tp"), _flat(param_pl)[path]):
            if isinstance(p, Shard):
                shape[p.dim] //= sub[axis]
        local += math.prod(shape)
        if path.split("/")[-1] in ("w_gate", "w_up", "w_down"):
            experts += t.numel()
            assert math.prod(shape) * 64 == t.numel(), path  # 1/8 of the experts, 1/8 of embed
        else:
            rest += t.numel()
            embed_sharded = any(isinstance(p, Shard) for p in _flat(param_pl)[path])
            assert math.prod(shape) * (8 if embed_sharded else 1) == t.numel(), path
    # f32 masters and two moments: 12 bytes a parameter.
    assert experts == 45_097_156_608
    assert local * 12 == 12 * (experts // 64 + (rest - 2 * 32 * 4096 - 4096) // 8
                               + 2 * 32 * 4096 + 4096)
    assert local * 12 == 10_866_966_528  # 10.9 GB a rank of the 560 GB whole state


def test_serve_refuses_int8_for_mixtral_before_any_build(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)  # no build could run
    with pytest.raises(SystemExit, match="MoE expert weights"):
        serve.main(["--model", "mixtral_tiny", "--int8"])
    with pytest.raises(ValueError, match="MoE expert weights"):
        serve.build("mixtral_tiny", 0, "cpu", int8=True)


@pytest.mark.parametrize("n,want", [(1, dict()), (2, dict(ep=2)), (4, dict(ep=2, fsdp=2)),
                                    (8, dict(ep=8)), (16, dict(ep=8, fsdp=2)),
                                    (6, dict(ep=2, fsdp=3))])
def test_serving_gang_layout_is_serve_llamas(n, want):
    got = dataclasses.asdict(serve.mesh_layout("mixtral_8x7b", n))
    assert got == {"dp": 1, "pp": 1, "fsdp": 1, "ep": 1, "sp": 1, "tp": 1, **want}


@pytest.mark.parametrize("n,want", [(1, dict()), (4, dict(ep=4)), (8, dict(ep=8)),
                                    (16, dict(ep=8, tp=2)), (12, dict(ep=4, fsdp=3)),
                                    (2, dict(tp=2))])
def test_train_mixtral_mesh_is_the_jax_twins(n, want):
    got = dataclasses.asdict(train_mixtral.mesh_config(n))
    assert got == {"dp": 1, "pp": 1, "fsdp": 1, "ep": 1, "sp": 1, "tp": 1, **want}


def test_serve_main_serves_mixtral_tiny_on_cpu(capsys):
    results = serve.main(["--model", "mixtral_tiny", "--device", "cpu", "--prompt-len", "64",
                          "--new-tokens", "4", "--requests", "1", "--temperature", "0"])
    assert results[0]["tokens"].shape == (4, 4)
    assert "request 0" in capsys.readouterr().out


def test_train_mixtral_main_on_cpu(capsys):
    records = train_mixtral.main(["--model", "tiny", "--seq", "64", "--steps", "2",
                                  "--device", "cpu"])
    assert [r["step"] for r in records] == [0, 1]
    assert all(np.isfinite(r["loss"]) and abs(r["loss"] - np.log(512)) < 1.5 for r in records)
    assert "step 1 loss" in capsys.readouterr().out
