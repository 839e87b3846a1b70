"""The decode step of hivedscheduler_tpu_torch.models.generate with its
fill on the device, against the JAX package's ``decode_step`` and
``generate_greedy_scan`` on the CPU in f32; and the owner of the captured
steps (``generate.decoder``), driven on the CPU with a stand-in for the
CUDA graph capture that re-runs the captured function at each replay."""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivedscheduler_tpu.models import generate as JG
from hivedscheduler_tpu.models import transformer as JT
from hivedscheduler_tpu_torch.models import convert, mixtral, quantize
from hivedscheduler_tpu_torch.models import generate as TG
from hivedscheduler_tpu_torch.models import transformer as TT

LOGITS_ATOL = 1e-4  # tests/test_torch_generate.py's
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


@pytest.mark.parametrize("fill", [5, 12, 19])
def test_device_fill_decode_step_matches_jax(params, fill):
    jparams, tparams = params
    jp, tp = prompt(10 + fill, 2, fill + 3)
    jcache = JG.init_cache(JCFG, 2, 24)
    tcache = TG.init_cache(TCFG, 2, 24, device="cpu")
    _, jcache = JG.prefill(jparams, jp[:, :fill], jcache, JCFG)
    _, tcache = TG.prefill(tparams, tp[:, :fill], tcache, TCFG)
    for pos in range(fill, fill + 3):
        jl, jcache = JG.decode_step(jparams, jp[:, pos], jcache, JCFG)
        tl, tcache = TG.decode_step(tparams, tp[:, pos], tcache, TCFG)
        close(tl, jl)
    # The fill is a device int32 scalar, as JAX's; the host count beside it
    # was never read back from it.
    assert tcache.length.shape == () and tcache.length.dtype == torch.int32
    assert int(tcache.length) == int(jcache.length) == tcache.issued == fill + 3


@pytest.mark.parametrize("chunk", [1, 5])
def test_slots_past_the_fill_add_nothing(params, chunk):
    # A cache that outlives a request holds the last one's K/V past the fill:
    # the mask must make them add exactly zero (a decode step, chunk 1, and a
    # chunked prefill, chunk 5).
    _, tparams = params
    _, tp = prompt(3, 2, 14)
    outs = []
    for stale in (None, 1e4):
        cache = TG.init_cache(TCFG, 2, 20, device="cpu")
        if stale is not None:
            cache.k.fill_(stale)
            cache.v.fill_(stale)
        _, cache = TG.prefill(tparams, tp[:, :9], cache, TCFG)
        logits, _ = TG.prefill(tparams, tp[:, 9:9 + chunk], cache, TCFG, chunked=True)
        outs.append(logits)
    assert torch.isfinite(outs[0]).all() and torch.equal(outs[0], outs[1])


def test_generate_scan_greedy_tokens_equal_jax_scan(params):
    jparams, tparams = params
    jp, tp = prompt(5, 2, 9)
    ref = JG.generate_greedy_scan(jparams, jp, JCFG, 7)
    out = TG.generate_scan(tparams, tp, TCFG, 7, None, temperature=0.0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_decode_past_the_cache_raises_and_keeps_the_fill(params):
    _, tparams = params
    _, tp = prompt(6, 1, 6)
    cache = TG.init_cache(TCFG, 1, 6, device="cpu")
    logits, cache = TG.prefill(tparams, tp, cache, TCFG)
    with pytest.raises(ValueError, match="cache of 6 positions cannot take 1 more after 6"):
        TG.decode_step(tparams, logits.argmax(-1), cache, TCFG)
    assert cache.issued == int(cache.length) == 6


# -- the owner of the captured steps, with the capture stood in for ------


def rerun_capture(fn, restore):
    """``generate._capture`` on the CPU: a warm-up run, then a replay that
    runs ``fn`` again and writes its output into the same tensor, as a
    graph's replay refills its output."""
    static = fn().clone()
    restore()

    def replay():
        static.copy_(fn())

    return replay, static


@pytest.fixture
def owner_on_cpu(monkeypatch):
    monkeypatch.setattr(TG, "_graphed", lambda x: True)
    monkeypatch.setattr(TG, "_capture", rerun_capture)


def _mixtral():
    config = mixtral.MixtralConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                                   n_kv_heads=2, d_ff=96, n_experts=4, max_seq_len=64,
                                   dtype=torch.float32)
    return config, mixtral.init(config, torch.Generator().manual_seed(0), "cpu")


def _tree(kind):
    if kind == "mixtral":
        config, tree = _mixtral()
        return config, tree, mixtral.decode_ffn(config)
    tree = TT.init(TCFG, torch.Generator().manual_seed(1), "cpu")
    return TCFG, (quantize.quantize_params(tree) if kind == "int8" else tree), None


@pytest.mark.parametrize("kind,sampled", [("dense", False), ("dense", True), ("int8", False),
                                          ("mixtral", True)])
def test_owner_tokens_equal_the_plain_loop(owner_on_cpu, kind, sampled):
    config, tree, ffn = _tree(kind)
    p = torch.from_numpy(np.random.default_rng(2).integers(0, config.vocab_size, (3, 10)))
    knobs = dict(temperature=0.8, top_k=40, top_p=0.9) if sampled else {}

    def run(plain):
        gen = torch.Generator().manual_seed(7) if sampled else None
        return TG.generate(tree, p, config, 6, generator=gen, ffn=ffn, plain=plain, **knobs)

    captures = TG.Decoder.captures
    assert torch.equal(run(False), run(True))
    assert TG.Decoder.captures == captures + 1


def test_a_second_request_replays_without_capture(owner_on_cpu, params):
    _, tparams = params
    _, tp = prompt(4, 2, 8)
    first = TG.generate_greedy_scan(tparams, tp, TCFG, 5)
    captures, replays = TG.Decoder.captures, TG.Decoder.replays
    _, other = prompt(5, 2, 8)
    second = TG.generate_greedy_scan(tparams, other, TCFG, 5)
    assert TG.Decoder.captures == captures and TG.Decoder.replays == replays + 4
    assert torch.equal(second, TG.generate(tparams, other, TCFG, 5, plain=True))
    assert not torch.equal(first, second)
    # A new sampling argument or shape is a new graph.
    TG.generate_greedy_scan(tparams, tp, TCFG, 6)
    assert TG.Decoder.captures == captures + 1


def test_yielded_tokens_are_not_overwritten(owner_on_cpu, params):
    _, tparams = params
    _, tp = prompt(8, 2, 8)
    kept = list(TG.generate_stream(tparams, tp, TCFG, 5))
    copies = [t.clone() for t in kept]
    _, other = prompt(9, 2, 8)
    list(TG.generate_stream(tparams, other, TCFG, 5))
    assert all(torch.equal(a, b) for a, b in zip(kept, copies))
    assert not all(torch.equal(kept[0], t) for t in kept[1:])


def test_the_owner_goes_with_the_weights(owner_on_cpu):
    tree = TT.init(TCFG, torch.Generator().manual_seed(3), "cpu")
    TG.generate(tree, torch.zeros(1, 4, dtype=torch.long), TCFG, 3)
    owner = weakref.ref(TG.decoder(tree, TCFG))
    assert TG.decoder(tree, TCFG) is owner()
    n = len(TG._DECODERS)
    del tree["layers"]["wq"]  # one leaf freed is enough
    gc.collect()
    assert owner() is None and len(TG._DECODERS) == n - 1


def test_decode_step_replays_its_owners_cache_only(owner_on_cpu, params):
    _, tparams = params
    _, tp = prompt(11, 2, 6)
    owner = TG.decoder(tparams, TCFG)
    cache = owner.init_cache(2, 9)
    logits, cache = TG.prefill(tparams, tp, cache, TCFG)
    plain = TG.init_cache(TCFG, 2, 9, device="cpu")
    ref, plain = TG.prefill(tparams, tp, plain, TCFG)
    token = logits.argmax(-1)
    for _ in range(3):
        logits, cache = TG.decode_step(tparams, token, cache, TCFG)
        with pytest.raises(ValueError, match="writes its owner's cache"):
            TG.decode_step(tparams, token, plain, TCFG)
        ref, plain = TG._forward_cached(tparams, token[:, None], plain, TCFG)
        assert torch.equal(logits, ref[:, 0])
        token = logits.argmax(-1)
    assert cache.issued == int(cache.length) == 9
    with pytest.raises(ValueError, match="cannot take 1 more"):
        TG.decode_step(tparams, token, cache, TCFG)


def test_one_stream_a_shape_at_a_time(owner_on_cpu, params):
    _, tparams = params
    _, tp = prompt(12, 1, 4)
    running = TG.generate_stream(tparams, tp, TCFG, 3)
    next(running)
    with pytest.raises(RuntimeError, match="still running"):
        next(TG.generate_stream(tparams, tp, TCFG, 3))
    running.close()  # its slot is free again
    assert TG.generate(tparams, tp, TCFG, 3).shape == (1, 7)
