"""The port's training slice (hivedscheduler_tpu_torch.models.train, remat,
the flash backward through autograd, the train entry) against the JAX
package on the CPU in f32. Inputs are made with numpy from a seed, or by the
JAX package's ``init``, and handed to both sides. Where the JAX side should
reach its Pallas kernels, they run in interpret mode with the dispatcher
forced on, as tests/test_flash_attention.py does."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivedscheduler_tpu.models import perf as JP
from hivedscheduler_tpu.models import train as JTR
from hivedscheduler_tpu.models import transformer as JT
from hivedscheduler_tpu.ops import attention as JA
from hivedscheduler_tpu_torch import train as entry
from hivedscheduler_tpu_torch.models import convert, perf
from hivedscheduler_tpu_torch.models import train as TTR
from hivedscheduler_tpu_torch.models import transformer as TT
from hivedscheduler_tpu_torch.ops import attention as TA

# The JAX package's own tolerances: gradients max |delta| / max |ref| < 1e-4
# and the fused loss within 1e-5 (tests/test_train_infra.py:108-119); remat
# policies agree at rtol 2e-4 / atol 2e-5 (tests/test_flash_attention.py:171).
GRAD_TOL = 1e-4
LOSS_ATOL = 1e-5
RTOL, ATOL = 2e-4, 2e-5


def walk(tree, prefix=""):
    """(path, leaf) pairs of a nested dict, sorted by key on both sides."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from walk(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def assert_grads_close(ref_tree, got_tree, tol=GRAD_TOL):
    ref, got = dict(walk(ref_tree)), dict(walk(got_tree))
    assert sorted(ref) == sorted(got)
    for path in ref:
        a = np.asarray(ref[path], dtype=np.float32)
        b = np.asarray(got[path], dtype=np.float32)
        scale = float(np.abs(a).max()) + 1e-8
        assert float(np.abs(a - b).max()) / scale < tol, path


def grads_of(params):
    return {k: grads_of(v) if isinstance(v, dict) else v.grad.numpy().copy()
            for k, v in params.items()}


def port_params(jparams):
    return convert.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def trainable(params):
    for t in TT.leaves(params):
        t.requires_grad_(True)
    return params


def gqa_configs(remat_policy="flash", remat=True):
    """A small GQA model (4 query heads over 2 KV heads, head_dim 32) on
    both sides; S = 256 takes the flash kernels."""
    shape = dict(vocab_size=512, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
                 d_ff=256, max_seq_len=256, remat=remat, remat_policy=remat_policy)
    return (JT.TransformerConfig(dtype=jnp.float32, **shape),
            TT.TransformerConfig(dtype=torch.float32, **shape))


def tokens(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s))


@pytest.fixture
def jax_pallas(monkeypatch):
    monkeypatch.setattr(JA, "INTERPRET", True)
    monkeypatch.setattr(JA, "pallas_wanted", lambda: True)


# ------------------------------------------------------------------- loss


@pytest.mark.parametrize("chunk", [128, 135])  # even split; a remainder chunk
def test_chunked_ce_matches_jax(chunk):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((40, 32), dtype=np.float32)
    head = rng.standard_normal((32, 512), dtype=np.float32) / 4
    targets = rng.integers(0, 512, size=40)
    ref, (gx, gh) = jax.value_and_grad(
        lambda x, h: JTR._chunked_ce(x, h, jnp.asarray(targets, jnp.int32), chunk),
        argnums=(0, 1),
    )(jnp.asarray(x), jnp.asarray(head))
    tx, th = torch.tensor(x, requires_grad=True), torch.tensor(head, requires_grad=True)
    loss = TTR._chunked_ce(tx, th, torch.from_numpy(targets), chunk)
    loss.backward()
    assert abs(loss.item() - float(ref)) < LOSS_ATOL
    assert_grads_close({"x": gx, "head": gh}, {"x": tx.grad.numpy(), "head": th.grad.numpy()})


def test_chunked_ce_rounds_the_input_gradient_once_in_bf16():
    # ROADMAP F8: the fused loss sums x's gradient over its vocab chunks in
    # f32 and rounds it once, so the chunk count moves it only where an f32
    # reordering crosses a bf16 rounding boundary (summed in bf16 chunk by
    # chunk, 16 chunks parted from one in about half the elements).
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(64, 64, generator=gen).to(torch.bfloat16)
    head = (torch.randn(64, 2048, generator=gen) / 8).to(torch.bfloat16)
    targets = torch.randint(0, 2048, (64,), generator=gen)
    grads = {}
    for chunk in (128, 2048):
        tx = x.clone().requires_grad_()
        TTR._chunked_ce(tx, head, targets, chunk).backward()
        grads[chunk] = tx.grad
    assert grads[128].dtype == torch.bfloat16
    assert (grads[128] != grads[2048]).float().mean().item() <= 1e-3


@pytest.mark.parametrize("fused,chunk", [(True, 128), (True, 135), (False, 128)])
def test_next_token_loss_matches_jax(fused, chunk):
    jparams = JT.init(JT.tiny(), jax.random.PRNGKey(0))
    toks = tokens(1, 2, 32)
    ref, jgrads = jax.value_and_grad(
        lambda p: JTR.next_token_loss(p, jnp.asarray(toks, jnp.int32), JT.tiny(),
                                      fused=fused, chunk=chunk)
    )(jparams)
    tparams = trainable(port_params(jparams))
    loss = TTR.next_token_loss(tparams, torch.from_numpy(toks), TT.tiny(), fused=fused,
                               chunk=chunk)
    loss.backward()
    assert abs(loss.item() - float(ref)) < LOSS_ATOL
    assert_grads_close(jgrads, grads_of(tparams))


def test_fused_loss_is_the_default_for_large_vocab(monkeypatch):
    seen = []
    monkeypatch.setattr(TTR, "_chunked_ce", lambda *a: seen.append(a[3]) or torch.zeros(()))
    cfg = dataclasses.replace(TT.tiny(), vocab_size=TTR.FUSED_LOSS_MIN_VOCAB, n_layers=1)
    params = TT.init(cfg, torch.Generator().manual_seed(0), "cpu")
    TTR.next_token_loss(params, torch.zeros(1, 8, dtype=torch.long), cfg)
    assert seen == [TTR._LOSS_CHUNK]


# ------------------------------------------------------------------ remat


@functools.lru_cache(maxsize=None)
def _loss_and_grads(policy):
    jcfg, _ = gqa_configs()
    _, tcfg = gqa_configs(remat_policy=policy)
    tparams = trainable(port_params(JT.init(jcfg, jax.random.PRNGKey(0))))
    loss = TTR.next_token_loss(tparams, torch.from_numpy(tokens(3, 2, 256)), tcfg)
    loss.backward()
    return loss.item(), grads_of(tparams)


@pytest.mark.parametrize("policy", ["dots", "flash", "dots+flash"])
def test_remat_policies_agree(policy):
    base_loss, base = _loss_and_grads("full")
    loss, grads = _loss_and_grads(policy)
    assert abs(loss - base_loss) < LOSS_ATOL
    for (path, a), (_, b) in zip(walk(base), walk(grads)):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=path)


def test_unknown_remat_policy_rejected():
    with pytest.raises(ValueError, match="remat_policy"):
        TT._remat_policy("nonsense")
    _, tcfg = gqa_configs(remat_policy="nonsense")
    params = TT.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="remat_policy"):
        TT.forward_hidden(params, torch.zeros(1, 8, dtype=torch.long), tcfg)


@pytest.mark.parametrize(
    "policy,remat,forward_runs",
    [("full", True, 2), ("dots", True, 2), ("flash", True, 1), ("dots+flash", True, 1),
     ("full", False, 1)],
)
def test_flash_policy_keeps_the_forward_op(monkeypatch, policy, remat, forward_runs):
    # The port's counterpart of test_flash_remat_policy_saves_residuals: under
    # "flash" one forward and backward runs the forward op once a layer, under
    # "full" twice (the recompute relaunches it); the backward pair runs once.
    calls = {"flash_attention": 0, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
    for name in calls:
        real = getattr(TA, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(TA, name, counted)
    _, tcfg = gqa_configs(remat_policy=policy, remat=remat)
    params = trainable(TT.init(tcfg, torch.Generator().manual_seed(0), "cpu",
                               dtype=torch.float32))
    TTR.next_token_loss(params, torch.from_numpy(tokens(4, 1, 256)), tcfg).backward()
    L = tcfg.n_layers
    assert calls == {"flash_attention": forward_runs * L, "flash_bwd_dkdv": L, "flash_bwd_dq": L}


# -------------------------------------------------------------- optimizer


def test_adamw_matches_optax():
    rng = np.random.default_rng(5)
    tree = {"a": rng.standard_normal((3, 4), dtype=np.float32),
            "b": {"c": rng.standard_normal(5, dtype=np.float32)}}
    grads = [jax.tree.map(lambda x: rng.standard_normal(x.shape, dtype=np.float32), tree)
             for _ in range(3)]
    opt = JTR.make_optimizer()
    jparams = jax.tree.map(jnp.asarray, tree)
    state = opt.init(jparams)
    tparams = convert.params_from_jax(tree, device="cpu")
    topt = TTR.make_optimizer(tparams)
    for g in grads:
        updates, state = opt.update(jax.tree.map(jnp.asarray, g), state, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        for (_, t), (_, gg) in zip(walk(tparams), walk(g)):
            t.grad = torch.from_numpy(gg)
        topt.step()
    for (path, a), (_, b) in zip(walk(jparams), walk(tparams)):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), rtol=1e-5, atol=1e-7,
                                   err_msg=path)


# ------------------------------------------------------------- train step


def test_train_step_matches_jax(jax_pallas):
    # What is compared: the loss of each of three steps (rtol 2e-4) and the
    # step-1 gradients (the JAX package's 1e-4 of max), not the parameters
    # after several steps. Adam's update is about lr * sign(g) an element, so
    # a gradient near 0 that the two sides round to opposite signs moves its
    # parameter 2 lr apart, however close the gradients are.
    jcfg, tcfg = gqa_configs()
    toks = tokens(6, 2, 256)
    jparams = JT.init(jcfg, jax.random.PRNGKey(1))
    jtoks = jnp.asarray(toks, jnp.int32)
    jgrads = jax.grad(JTR.next_token_loss)(jparams, jtoks, jcfg)
    opt = JTR.make_optimizer()
    step = jax.jit(functools.partial(JTR.train_step, config=jcfg, optimizer=opt))
    tparams = port_params(jparams)
    state = opt.init(jparams)
    topt = TTR.make_optimizer(tparams)
    ref_losses, losses = [], []
    for i in range(3):
        jparams, state, loss = step(jparams, state, jtoks)
        ref_losses.append(float(loss))
        losses.append(float(TTR.train_step(tparams, topt, torch.from_numpy(toks), tcfg, "cpu")))
        if i == 0:
            assert_grads_close(jgrads, grads_of(tparams))
    np.testing.assert_allclose(losses, ref_losses, rtol=RTOL)
    assert losses[2] < losses[0]


def test_train_step_checks_the_device():
    _, tcfg = gqa_configs()
    params = TT.init(tcfg, torch.Generator().manual_seed(0), "cpu", dtype=torch.float32)
    opt = TTR.make_optimizer(params)
    with pytest.raises(ValueError, match="parameters on cpu"):
        TTR.train_step(params, opt, torch.zeros(1, 8, dtype=torch.long), tcfg, "meta")


# ------------------------------------------------------ entry and helpers


def test_params_to_numpy_roundtrip():
    params = TT.init(TT.tiny(), torch.Generator().manual_seed(2), "cpu")
    params["layers"]["q8"] = {"w": torch.ones(2, 3, dtype=torch.int8), "scale": torch.ones(3)}
    arrays = convert.params_to_numpy(params)
    assert arrays["layers"]["q8"]["w"].dtype == np.int8
    assert arrays["embed"].dtype == np.float32
    back = convert.params_from_jax(arrays, device="cpu")
    for (pa, a), (pb, b) in zip(walk(params), walk(back)):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b)


def test_flops_per_token_matches_jax():
    jparams = JT.init(JT.tiny(), jax.random.PRNGKey(0))
    tparams = port_params(jparams)
    assert perf.n_params(tparams) == JP.n_params(jparams)
    cfg, jcfg = dataclasses.replace(TT.llama3_8b(), n_layers=8), dataclasses.replace(
        JT.llama3_8b(), n_layers=8)
    assert perf.flops_per_token(cfg, 2_795_573_248, 8192) == JP.flops_per_token(
        jcfg, 2_795_573_248, 8192)
    # 6N + 6 L S d at the card's training shape: 1.84e10 FLOPs a token.
    assert abs(perf.flops_per_token(cfg, 2_795_573_248, 8192) - 1.8384e10) < 1e7


def test_build_cuts_only_the_depth():
    config, params = entry.build("tiny", 0, "cpu", layers=1, remat_policy="dots")
    assert config == dataclasses.replace(TT.tiny(), n_layers=1, remat=True, remat_policy="dots")
    assert params["layers"]["wq"].shape == (1, 128, 128)
    assert all(t.dtype == torch.float32 for t in TT.leaves(params))


def test_train_entry_on_cpu(capsys):
    entry.main(["--device", "cpu", "--model", "tiny", "--seq", "256", "--steps", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("tiny: 2 layers")
    assert [ln.split(":")[0] for ln in lines[1:]] == ["step 0", "step 1"]
    assert "bf16 peak share n/a" in lines[1]
