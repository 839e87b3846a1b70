"""The port's serving path (hivedscheduler_tpu_torch.models.generate,
quantize, serve) against the JAX package's on the CPU in f32, with the JAX
package's ``init`` making the parameters for both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivedscheduler_tpu.models import generate as JG
from hivedscheduler_tpu.models import quantize as JQ
from hivedscheduler_tpu.models import transformer as JT
from hivedscheduler_tpu.ops import attention as JA
from hivedscheduler_tpu_torch import serve
from hivedscheduler_tpu_torch.models import convert
from hivedscheduler_tpu_torch.models import generate as TG
from hivedscheduler_tpu_torch.models import quantize as TQ
from hivedscheduler_tpu_torch.models import transformer as TT
from hivedscheduler_tpu_torch.ops import attention as TA

LOGITS_ATOL = 1e-4
JCFG, TCFG = JT.tiny(), TT.tiny()


@pytest.fixture(scope="module")
def params():
    jparams = JT.init(JCFG, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jparams, tparams


def prompt(seed, b, t):
    toks = np.random.default_rng(seed).integers(0, JCFG.vocab_size, size=(b, t))
    return jnp.asarray(toks, dtype=jnp.int32), torch.from_numpy(toks)


def close(port, ref, atol=LOGITS_ATOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=atol)


def test_prefill_and_decode_match_jax(params):
    jparams, tparams = params
    jp, tp = prompt(1, 2, 20)
    jcache = JG.init_cache(JCFG, 2, 26)
    tcache = TG.init_cache(TCFG, 2, 26, device="cpu")
    jl, jcache = JG.prefill(jparams, jp[:, :16], jcache, JCFG)
    tl, tcache = TG.prefill(tparams, tp[:, :16], tcache, TCFG)
    close(tl, jl)
    assert tcache.length == int(jcache.length) == 16
    for pos in range(16, 20):
        jl, jcache = JG.decode_step(jparams, jp[:, pos], jcache, JCFG)
        tl, tcache = TG.decode_step(tparams, tp[:, pos], tcache, TCFG)
        close(tl, jl)
    close(tcache.k[:, :, :20], jcache.k[:, :, :20])
    close(tcache.v[:, :, :20], jcache.v[:, :, :20])


def test_chunked_prefill_matches_jax(params):
    # A second prompt chunk attends over the cached history ("cached" mode).
    jparams, tparams = params
    jp, tp = prompt(2, 1, 24)
    jcache = JG.init_cache(JCFG, 1, 24)
    tcache = TG.init_cache(TCFG, 1, 24, device="cpu")
    _, jcache = JG.prefill(jparams, jp[:, :12], jcache, JCFG)
    _, tcache = TG.prefill(tparams, tp[:, :12], tcache, TCFG)
    jl, _ = JG.prefill(jparams, jp[:, 12:], jcache, JCFG, chunked=True)
    tl, _ = TG.prefill(tparams, tp[:, 12:], tcache, TCFG)
    close(tl, jl)


def test_greedy_generate_tokens_equal_jax(params):
    jparams, tparams = params
    jp, tp = prompt(3, 2, 8)
    ref = JG.generate(jparams, jp, JCFG, max_new_tokens=6)
    out = TG.generate(tparams, tp, TCFG, max_new_tokens=6)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    scan = TG.generate_greedy_scan(tparams, tp, TCFG, 6)
    np.testing.assert_array_equal(scan.numpy(), np.asarray(ref))


def test_flash_prefill_matches_jax_kernel_path(params, monkeypatch):
    # The whole slice against the JAX kernel path: JAX prefill of a 256-token
    # prompt through its Pallas flash kernel (interpret mode) vs the port's
    # flash dispatch.
    jparams, tparams = params
    jcalls, tcalls = [], []
    real_j, real_t = JA.flash_attention_tpu, TA.flash_attention
    monkeypatch.setattr(JA, "pallas_wanted", lambda: True)
    monkeypatch.setattr(JA, "INTERPRET", True)
    monkeypatch.setattr(
        JA, "flash_attention_tpu", lambda *a: jcalls.append(1) or real_j(*a)
    )
    monkeypatch.setattr(
        TA, "flash_attention", lambda *a, **kw: tcalls.append(1) or real_t(*a, **kw)
    )
    jp, tp = prompt(4, 1, 256)
    # Eager (un-jitted) so the patched dispatch is traced now.
    jl, _ = JG._forward_cached(
        jparams, jp, JG.init_cache(JCFG, 1, 256), JCFG, None, "flash"
    )
    tl, _ = TG.prefill(tparams, tp, TG.init_cache(TCFG, 1, 256, device="cpu"), TCFG)
    assert jcalls and len(tcalls) == TCFG.n_layers
    close(tl, jl[:, -1])


def test_int8_quantize_params_match_jax(params):
    jparams, tparams = params
    jq = JQ.quantize_params(jparams)
    tq = TQ.quantize_params(tparams)
    for key in TQ.LAYER_LINEAR_KEYS:
        np.testing.assert_array_equal(
            tq["layers"][key]["w"].numpy(), np.asarray(jq["layers"][key]["w"])
        )
        np.testing.assert_allclose(
            tq["layers"][key]["scale"].numpy(), np.asarray(jq["layers"][key]["scale"]),
            rtol=1e-6,
        )
    assert tq["lm_head"]["w"].dtype == torch.int8
    np.testing.assert_array_equal(tq["lm_head"]["w"].numpy(), np.asarray(jq["lm_head"]["w"]))
    assert tq["layers"]["ln1"] is tparams["layers"]["ln1"]


def test_int8_quantized_matmul_and_decode_match_jax(params):
    jparams, tparams = params
    w = np.random.default_rng(5).standard_normal((64, 48)).astype(np.float32)
    x = np.random.default_rng(6).standard_normal((3, 64)).astype(np.float32)
    jw, tw = JQ.quantize_weight(jnp.asarray(w)), TQ.quantize_weight(torch.from_numpy(w))
    close(TQ.quantized_matmul(torch.from_numpy(x), tw),
          JQ.quantized_matmul(jnp.asarray(x), jw), atol=1e-5)
    with pytest.raises(ValueError):
        TQ.quantize_weight(torch.zeros(2, 3, 4))
    # The KV-cache machinery serves the quantized tree; JAX's int8 tree
    # converts with its int8 leaves kept.
    jq = JQ.quantize_params(jparams)
    tq = convert.params_from_jax(jax.tree.map(np.asarray, jq), device="cpu")
    assert tq["layers"]["wq"]["w"].dtype == torch.int8
    jp, tp = prompt(7, 2, 10)
    jl, jc = JG.prefill(jq, jp, JG.init_cache(JCFG, 2, 12), JCFG)
    tl, tc = TG.prefill(tq, tp, TG.init_cache(TCFG, 2, 12, device="cpu"), TCFG)
    close(tl, jl)
    jl, _ = JG.decode_step(jq, jnp.argmax(jl, -1).astype(jnp.int32), jc, JCFG)
    tl, _ = TG.decode_step(tq, tl.argmax(-1), tc, TCFG)
    close(tl, jl)


def sample_many(logits, n, seed, **kw):
    gen = torch.Generator().manual_seed(seed)
    rows = torch.as_tensor(logits, dtype=torch.float32).expand(n, -1)
    return TG.sample_logits(rows, gen, **kw)


def test_sample_logits_greedy_and_top_p_zero():
    logits = torch.tensor([[0.1, 2.0, -1.0, 1.9], [3.0, 0.0, 2.9, 1.0]])
    assert TG.sample_logits(logits, None, temperature=1.0).tolist() == [1, 0]
    assert TG.sample_logits(logits, torch.Generator(), temperature=0.0).tolist() == [1, 0]
    # top_p = 0 keeps only the best token: sampling is greedy.
    out = sample_many(logits[0], 500, 0, temperature=1.0, top_p=0.0)
    assert (out == 1).all()


def test_sample_logits_top_k_mask():
    logits = np.log(np.array([0.05, 0.3, 0.1, 0.25, 0.3], dtype=np.float32))
    out = sample_many(logits, 4000, 1, temperature=1.0, top_k=3)
    assert set(out.tolist()) == {1, 3, 4}
    freq = np.bincount(out.numpy(), minlength=5) / 4000
    np.testing.assert_allclose(freq[[1, 3, 4]], [0.3 / 0.85, 0.25 / 0.85, 0.3 / 0.85], atol=0.03)


def test_sample_logits_top_p_matches_jax_distribution():
    # Sorted probs 0.5, 0.3, 0.15, 0.05: exclusive mass 0, .5, .8, .95, so
    # top_p = 0.7 keeps the first two. The PRNG streams differ, so the two
    # packages are held to the same distribution, not the same draws.
    logits = np.log(np.array([0.15, 0.5, 0.05, 0.3], dtype=np.float32))
    n = 4000
    out = sample_many(logits, n, 2, temperature=1.0, top_p=0.7)
    ref = JG.sample_logits(
        jnp.broadcast_to(jnp.asarray(logits), (n, 4)), jax.random.PRNGKey(0),
        temperature=1.0, top_p=0.7,
    )
    f_port = np.bincount(out.numpy(), minlength=4) / n
    f_jax = np.bincount(np.asarray(ref), minlength=4) / n
    assert f_port[0] == f_port[2] == 0.0 and f_jax[0] == f_jax[2] == 0.0
    np.testing.assert_allclose(f_port, [0, 0.625, 0, 0.375], atol=0.03)
    np.testing.assert_allclose(f_port, f_jax, atol=0.04)


def test_sampled_generate_is_seeded(params):
    _, tparams = params
    _, tp = prompt(8, 2, 6)

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return TG.generate_scan(tparams, tp, TCFG, 5, gen, temperature=0.8, top_p=0.9)

    a, b = run(11), run(11)
    assert a.shape == (2, 11) and torch.equal(a, b)
    assert torch.equal(a[:, :6], tp)


def test_flash_prefill_on_a_cache_with_history_raises(params):
    # chunked=False is prompt-only attention: over a cache with history it
    # would ignore the history, so it is refused and the cache is untouched.
    _, tparams = params
    _, tp = prompt(2, 1, 24)
    cache = TG.init_cache(TCFG, 1, 24, device="cpu")
    _, cache = TG.prefill(tparams, tp[:, :12], cache, TCFG, chunked=False)  # fresh: allowed
    before = cache.k.clone()
    with pytest.raises(ValueError, match="needs a fresh cache; this one holds 12 positions"):
        TG.prefill(tparams, tp[:, 12:], cache, TCFG, chunked=False)
    assert cache.length == 12 and torch.equal(cache.k, before)


def test_default_prefill_on_a_cache_with_history_takes_the_cached_program(params, monkeypatch):
    _, tparams = params
    _, tp = prompt(2, 1, 24)
    cache = TG.init_cache(TCFG, 1, 24, device="cpu")
    _, cache = TG.prefill(tparams, tp[:, :12], cache, TCFG)
    modes = []
    block = TG._block_cached
    monkeypatch.setattr(TG, "_block_cached",
                        lambda *a, **k: modes.append(a[6]) or block(*a, **k))
    got, _ = TG.prefill(tparams, tp[:, 12:], cache, TCFG)
    assert modes == ["cached"] * TCFG.n_layers and got.shape == (1, TCFG.vocab_size)


def test_cache_overflow_raises(params):
    _, tparams = params
    _, tp = prompt(9, 1, 8)
    with pytest.raises(ValueError, match="cache"):
        TG.prefill(tparams, tp, TG.init_cache(TCFG, 1, 4, device="cpu"), TCFG)


def test_serve_main_on_cpu(capsys):
    serve.main(["--device", "cpu", "--prompt-len", "256", "--new-tokens", "3",
                "--requests", "2", "--batch", "2", "--temperature", "0"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and all("ttft" in l and "flash launches 0" in l for l in lines)


def test_serve_run_request_shapes():
    config, params = serve.build("tiny", seed=0, device="cpu")
    rng = np.random.default_rng(0)
    p = torch.from_numpy(serve.synthetic_tokens(rng, 2, 16, config.vocab_size))
    res = serve.run_request(params, p, config, 4)
    assert res["tokens"].shape == (2, 4)
    assert res["ttft_ms"] > 0 and res["decode_tok_s"] > 0
    ref = TG.generate(params, p, config, 4)
    assert torch.equal(res["tokens"], ref[:, 16:])
