"""The port's transformer (hivedscheduler_tpu_torch.models.transformer)
against the JAX package's on the CPU in f32: JAX's ``init`` makes the
parameters, handed over as numpy through ``convert.params_from_jax``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivedscheduler_tpu.models import transformer as JT
from hivedscheduler_tpu_torch.models import convert
from hivedscheduler_tpu_torch.models import transformer as TT

RTOL, ATOL = 2e-4, 2e-5
LOGITS_ATOL = 1e-4


def jax_and_port_params(seed=0, config=None):
    jcfg = config or JT.tiny()
    jparams = JT.init(jcfg, jax.random.PRNGKey(seed))
    tparams = convert.params_from_jax(
        jax.tree.map(np.asarray, jparams), device="cpu", dtype=torch.float32
    )
    return jparams, tparams


def tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s))


def test_configs_match_jax():
    for jc, tc in ((JT.llama3_8b(), TT.llama3_8b()), (JT.tiny(), TT.tiny())):
        for f in dataclasses.fields(tc):
            if f.name != "dtype":
                assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert tc.head_dim == jc.head_dim
    assert TT.llama3_8b().dtype == torch.bfloat16
    assert TT.tiny().dtype == torch.float32


def test_init_layout_matches_jax():
    jparams = JT.init(JT.tiny(), jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    tparams = TT.init(TT.tiny(), gen, device="cpu")
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jparams)
    tshapes = jax.tree.map(lambda t: tuple(t.shape), tparams)
    assert tshapes == jshapes
    # normal / sqrt(fan_in): w_down has fan_in d_ff = 256.
    std = float(tparams["layers"]["w_down"].std())
    assert abs(std - 1 / 16) < 0.005
    assert torch.equal(tparams["ln_f"], torch.ones(128))


def test_init_is_seeded_and_in_compute_dtype():
    cfg = dataclasses.replace(TT.tiny(), dtype=torch.bfloat16)
    a = TT.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = TT.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert a["layers"]["wq"].dtype == torch.bfloat16
    assert torch.equal(a["layers"]["wq"], b["layers"]["wq"])


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32)
    ref = JT.rms_norm(jnp.asarray(x), jnp.asarray(scale))
    out = TT.rms_norm(torch.from_numpy(x), torch.from_numpy(scale))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("offset,theta", [(0, 10000.0), (37, 500000.0)])
def test_rope_matches_jax(offset, theta):
    x = np.random.default_rng(1).standard_normal((2, 9, 4, 32)).astype(np.float32)
    pos = np.arange(9) + offset
    ref = JT.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    out = TT.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_rope_is_half_split():
    # Rotate-half pairs dim i with dim i + D/2 (not interleaved 2i, 2i+1).
    x = torch.zeros(1, 1, 1, 8)
    x[..., 0] = 1.0
    out = TT.rope(x, torch.tensor([1]), 10000.0)
    assert out[..., 4].item() == pytest.approx(np.sin(1.0), rel=1e-6)
    assert out[..., 1].item() == 0.0


@pytest.mark.parametrize("seq", [24, 256])
def test_forward_tiny_matches_jax(seq):
    # seq 256 takes the port's flash dispatch (its plain version on the CPU).
    jparams, tparams = jax_and_port_params(0)
    toks = tokens(1, 2, seq, JT.tiny().vocab_size)
    ref = JT.forward(jparams, jnp.asarray(toks, dtype=jnp.int32), JT.tiny())
    out = TT.forward(tparams, torch.from_numpy(toks), TT.tiny())
    assert out.dtype == torch.float32 and out.shape == (2, seq, 512)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=LOGITS_ATOL)


def test_forward_tied_embeddings_matches_jax():
    jcfg = dataclasses.replace(JT.tiny(), tied_embeddings=True)
    tcfg = dataclasses.replace(TT.tiny(), tied_embeddings=True)
    jparams, tparams = jax_and_port_params(2, jcfg)
    assert "lm_head" not in tparams
    toks = tokens(3, 1, 16, jcfg.vocab_size)
    ref = JT.forward(jparams, jnp.asarray(toks, dtype=jnp.int32), jcfg)
    out = TT.forward(tparams, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=LOGITS_ATOL)
