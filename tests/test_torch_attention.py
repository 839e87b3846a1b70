"""The port's attention ops (hivedscheduler_tpu_torch.ops.attention) against
the JAX package's, on the CPU in f32: the same numpy inputs go through both.
The flash kernels themselves need a CUDA card: see test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivedscheduler_tpu.ops import attention as JA
from hivedscheduler_tpu_torch.ops import _build
from hivedscheduler_tpu_torch.ops import attention as TA

# The JAX package's own tolerances for its f32 attention paths
# (tests/test_flash_attention.py): values rtol 2e-4 / atol 2e-5, gradients
# max |delta| / max |ref| < 1e-4.
RTOL, ATOL = 2e-4, 2e-5
GRAD_TOL = 1e-4


def rel_err(ref, got) -> float:
    ref, got = np.asarray(ref, dtype=np.float32), np.asarray(got, dtype=np.float32)
    return float(np.abs(ref - got).max()) / (float(np.abs(ref).max()) + 1e-6)


def make_qkv(seed, b=2, sq=48, sk=48, h=4, hkv=2, d=32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d), dtype=np.float32)
    k = rng.standard_normal((b, sk, hkv, d), dtype=np.float32)
    v = rng.standard_normal((b, sk, hkv, d), dtype=np.float32)
    return q, k, v


def both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


@pytest.fixture
def jax_interpret(monkeypatch):
    monkeypatch.setattr(JA, "INTERPRET", True)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2), (8, 2)])
def test_mha_reference_matches_jax(causal, h, hkv):
    (jq, jk, jv), (tq, tk, tv) = both(*make_qkv(0, h=h, hkv=hkv))
    ref = JA.mha_reference(jq, jk, jv, causal=causal)
    out = TA.mha_reference(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "sq,sk,q_offset,kv_offset",
    [(16, 32, 16, 0), (16, 16, 32, 16), (16, 16, 8, 24), (24, 40, 0, 0)],
)
def test_mha_reference_offsets_match_jax(sq, sk, q_offset, kv_offset):
    (jq, jk, jv), (tq, tk, tv) = both(*make_qkv(1, sq=sq, sk=sk))
    ref = JA.mha_reference(jq, jk, jv, True, None, q_offset, kv_offset)
    out = TA.mha_reference(tq, tk, tv, True, None, q_offset, kv_offset)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_mha_reference_sm_scale_matches_jax():
    (jq, jk, jv), (tq, tk, tv) = both(*make_qkv(2))
    ref = JA.mha_reference(jq, jk, jv, causal=True, sm_scale=0.3)
    out = TA.mha_reference(tq, tk, tv, causal=True, sm_scale=0.3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,hkv", [(2, 2), (4, 2)])
def test_flash_attention_matches_jax_kernel(jax_interpret, causal, h, hkv):
    # The JAX side runs its Pallas flash kernel in interpret mode, as its
    # own tests do (S=256, D=64, 128-blocks).
    (jq, jk, jv), (tq, tk, tv) = both(
        *make_qkv(3, b=1, sq=256, sk=256, h=h, hkv=hkv, d=64)
    )
    ref = JA.flash_attention_tpu(jq, jk, jv, causal, None, 128, 128)
    out, lse = TA.flash_attention(tq, tk, tv, causal)
    assert out.shape == tq.shape and lse.shape == (h, 256)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_lse_is_logsumexp_of_scores(jax_interpret, causal):
    q, k, v = make_qkv(4, b=2, sq=256, sk=256, h=4, hkv=2, d=64)
    (jq, jk, jv), (tq, tk, tv) = both(q, k, v)
    _, lse = TA.flash_attention(tq, tk, tv, causal)
    kr = tk.repeat_interleave(2, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", tq, kr) / 8.0
    if causal:
        pos = torch.arange(256)
        scores = torch.where(pos[:, None] >= pos[None, :], scores, TA.NEG_INF)
    expected = torch.logsumexp(scores, dim=-1).reshape(8, 256)
    np.testing.assert_allclose(lse.numpy(), expected.numpy(), rtol=RTOL, atol=ATOL)
    # ... and the JAX kernel's lane-broadcast LSE residual, lane 0.
    _, residuals = JA._flash_fwd(jq, jk, jv, causal, None, 128, 128)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(residuals[4])[:, :, 0], rtol=RTOL, atol=ATOL
    )


def test_flash_reference_matches_mha_reference():
    # The kernel's plain version normalises after the PV product; in f32
    # that is the same attention as mha_reference.
    _, (tq, tk, tv) = both(*make_qkv(5, sq=300, sk=300))
    out, _ = TA.flash_attention_reference(tq, tk, tv, True)
    ref = TA.mha_reference(tq, tk, tv, True)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "sq,sk,flash",
    [(256, 256, True), (300, 300, True), (1000, 1000, True),
     (255, 255, False), (16, 16, False), (256, 512, False), (300, 256, False)],
)
def test_mha_gate(monkeypatch, sq, sk, flash):
    calls = []
    real_flash, real_ref = TA.flash_attention, TA.mha_reference
    monkeypatch.setattr(
        TA, "flash_attention", lambda *a, **kw: calls.append("flash") or real_flash(*a, **kw)
    )
    monkeypatch.setattr(
        TA, "mha_reference", lambda *a, **kw: calls.append("ref") or real_ref(*a, **kw)
    )
    _, (tq, tk, tv) = both(*make_qkv(6, b=1, sq=sq, sk=sk, h=2, hkv=1, d=32))
    out = TA.mha(tq, tk, tv, causal=False)
    assert calls == ["flash" if flash else "ref"]
    np.testing.assert_allclose(
        out.numpy(), real_ref(tq, tk, tv, causal=False).numpy(), rtol=RTOL, atol=ATOL
    )


def test_flash_attention_refuses_other_devices():
    # No silent fallback: a tensor neither on the CPU nor on CUDA raises.
    q = torch.empty(1, 256, 2, 32, device="meta")
    before = TA.flash_attention.launches
    with pytest.raises(ValueError):
        TA.flash_attention(q, q, q)
    assert TA.flash_attention.launches == before


def test_cpu_path_counts_no_launch():
    _, (tq, tk, tv) = both(*make_qkv(7, b=1, sq=256, sk=256))
    before = TA.flash_attention.launches
    TA.flash_attention(tq, tk, tv)
    assert TA.flash_attention.launches == before


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


def test_build_target_tracks_source(tmp_path):
    a, b = tmp_path / "k.cu", tmp_path / "k2.cu"
    a.write_text("// one")
    b.write_text("// two")
    assert _build._target(a) != _build._target(b)
    assert _build._target(a).parent == _build.BUILD_DIR
    assert [s.name for s in _build.sources()] == ["flash_bwd.cu", "flash_fwd.cu"]


# ---------------------------------------------------------------- backward


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,hkv", [(2, 2), (4, 2)])
def test_flash_gradients_match_jax_kernels(jax_interpret, causal, h, hkv):
    # Through the autograd Function on the port's side, jax.grad through the
    # custom_vjp (Pallas backward kernels in interpret mode) on the JAX side.
    q, k, v = make_qkv(8, b=1, sq=256, sk=256, h=h, hkv=hkv, d=64)
    w = np.random.default_rng(9).standard_normal(q.shape, dtype=np.float32)
    ref = jax.grad(
        lambda q, k, v: jnp.sum(JA.flash_attention_tpu(q, k, v, causal, None, 128, 128) * w),
        argnums=(0, 1, 2),
    )(*both(q, k, v)[0])
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    (TA.flash_attention_autograd(tq, tk, tv, causal) * torch.from_numpy(w)).sum().backward()
    for r, t in zip(ref, (tq, tk, tv)):
        assert t.grad.shape == t.shape
        assert rel_err(r, t.grad.numpy()) < GRAD_TOL


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_reference_matches_jax_bwd(jax_interpret, causal):
    # The plain version of both backward kernels against the JAX backward
    # residual path (_flash_bwd: Pallas kernels, then the GQA group-sum).
    q, k, v = make_qkv(10, b=2, sq=256, sk=256, h=4, hkv=2, d=64)
    do = np.random.default_rng(11).standard_normal(q.shape, dtype=np.float32)
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = both(q, k, v, do)
    _, residuals = JA._flash_fwd(jq, jk, jv, causal, None, 128, 128)
    ref = JA._flash_bwd(causal, None, 128, 128, None, None, residuals, jdo)
    out, lse = TA.flash_attention(tq, tk, tv, causal)
    got = TA.flash_attention_bwd_reference(tq, tk, tv, out, lse, tdo, causal)
    for r, g in zip(ref, got):
        assert g.shape == r.shape
        assert rel_err(r, g.numpy()) < GRAD_TOL


def test_flash_bwd_delta_is_rowsum():
    _, (tq, _, _) = both(*make_qkv(12, b=2, sq=8, sk=8, h=4))
    do = torch.randn(tq.shape, generator=torch.Generator().manual_seed(0))
    delta = TA.flash_bwd_delta(tq, do)
    assert delta.shape == (8, 8) and delta.dtype == torch.float32
    expected = (tq * do).sum(-1).permute(0, 2, 1).reshape(8, 8)
    np.testing.assert_allclose(delta.numpy(), expected.numpy(), rtol=1e-6, atol=1e-6)


def test_flash_bwd_on_cpu_is_the_plain_version_and_counts_no_launch():
    _, (tq, tk, tv) = both(*make_qkv(13, b=1, sq=300, sk=300, h=4, hkv=2))
    do = torch.randn(tq.shape, generator=torch.Generator().manual_seed(1))
    out, lse = TA.flash_attention(tq, tk, tv)
    before = (TA.flash_bwd_dkdv.launches, TA.flash_bwd_dq.launches)
    got = TA.flash_attention_bwd(tq, tk, tv, out, lse, do)
    ref = TA.flash_attention_bwd_reference(tq, tk, tv, out, lse, do)
    assert (TA.flash_bwd_dkdv.launches, TA.flash_bwd_dq.launches) == before
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_mha_gradients_match_the_reference_path():
    # The kernels' path (S >= 256) against autograd through mha_reference.
    q, k, v = make_qkv(14, b=1, sq=300, sk=300, h=4, hkv=2)
    grads = []
    for fn in (TA.mha, TA.mha_reference):
        ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        (fn(*ts, causal=True) ** 2).sum().backward()
        grads.append([t.grad.numpy() for t in ts])
    for a, b in zip(*grads):
        assert rel_err(b, a) < GRAD_TOL


def test_bwd_kernels_refuse_other_devices():
    q = torch.empty(1, 256, 2, 32, device="meta")
    lse = torch.empty(2, 256, device="meta")
    before = (TA.flash_bwd_dkdv.launches, TA.flash_bwd_dq.launches)
    with pytest.raises(ValueError):
        TA.flash_bwd_dkdv(q, q, q, q, lse, lse)
    with pytest.raises(ValueError):
        TA.flash_bwd_dq(q, q, q, q, lse, lse)
    assert (TA.flash_bwd_dkdv.launches, TA.flash_bwd_dq.launches) == before


@pytest.mark.parametrize(
    "what", ["lse_shape", "lse_dtype", "do_dtype", "head_dim"],
)
def test_bwd_kernel_args_refused(what):
    b, s, h, hkv, d = 1, 256, 4, 2, 64
    q, do = torch.zeros(b, s, h, d), torch.zeros(b, s, h, d)
    k = v = torch.zeros(b, s, hkv, d)
    lse = delta = torch.zeros(b * h, s)
    if what == "lse_shape":
        lse = torch.zeros(b * h, s + 1)
    elif what == "lse_dtype":
        lse = lse.double()
    elif what == "do_dtype":
        do = do.double()
    else:
        q = do = torch.zeros(b, s, h, 48)
        k = v = torch.zeros(b, s, hkv, 48)
    with pytest.raises(ValueError):
        TA._bwd_kernel_args(q, k, v, do, lse, delta)


def test_forward_op_is_the_plain_version_on_cpu():
    _, (tq, tk, tv) = both(*make_qkv(15, b=1, sq=256, sk=256))
    out, lse = torch.ops.hived.flash_fwd(tq, tk, tv, True, 0.25)
    ref_out, ref_lse = TA.flash_attention_reference(tq, tk, tv, True, 0.25)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
