"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: each test skips without a CUDA card. The file imports no
JAX, so on a machine with a card and no JAX it runs as

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import pytest
import torch

from hivedscheduler_tpu_torch.ops import attention as TA


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "s,causal,dtype,tol",
    [(2048, True, torch.bfloat16, 2e-2), (1000, False, torch.bfloat16, 2e-2),
     (1000, True, torch.float32, 2e-5)],
)
def test_cuda_flash_kernel_matches_plain(cuda_device, s, causal, dtype, tol):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn(2, s, 32, 128, device=cuda_device, dtype=dtype, generator=gen)
    k = torch.randn(2, s, 8, 128, device=cuda_device, dtype=dtype, generator=gen)
    v = torch.randn(2, s, 8, 128, device=cuda_device, dtype=dtype, generator=gen)
    before = TA.flash_attention.launches
    out, lse = TA.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert TA.flash_attention.launches == before + 1
    ref, ref_lse = TA.flash_attention_reference(q, k, v, causal)
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_cuda_tiny_prefill_matches_cpu(cuda_device):
    # The serving path on the card (f32 flash kernel, head_dim 32) against
    # the same model on the CPU (the kernel's plain version).
    from hivedscheduler_tpu_torch.models import generate, transformer

    config = transformer.tiny()
    params = transformer.init(config, torch.Generator().manual_seed(0), device="cpu")
    prompt = torch.randint(0, config.vocab_size, (2, 256),
                           generator=torch.Generator().manual_seed(1))
    on_card = {k: (v.to(cuda_device) if torch.is_tensor(v) else
                   {kk: vv.to(cuda_device) for kk, vv in v.items()})
               for k, v in params.items()}
    before = TA.flash_attention.launches
    logits, _ = generate.prefill(
        on_card, prompt.to(cuda_device), generate.init_cache(config, 2, 256, cuda_device),
        config,
    )
    assert TA.flash_attention.launches == before + config.n_layers
    ref, _ = generate.prefill(params, prompt, generate.init_cache(config, 2, 256, "cpu"), config)
    # f32 throughout; sums in another order than the CPU's.
    torch.testing.assert_close(logits.cpu(), ref, rtol=0, atol=1e-4)
