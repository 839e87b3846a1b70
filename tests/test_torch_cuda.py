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
        pytest.skip("needs a CUDA card: the flash kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# bf16 at B 1 and 2 (a tile must not read across a batch), a whole number
# of tiles, a ragged length and one shorter than a tile, each head_dim.
_BF16_GRID = [(b, s, d) for b in (1, 2) for s in (2048, 1000, 100) for d in (32, 64, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,s,d,causal,dtype,tol",
    [(b, s, d, True, torch.bfloat16, 2e-2) for b, s, d in _BF16_GRID]
    + [(2, 1000, 128, False, torch.bfloat16, 2e-2), (2, 1000, 64, False, torch.bfloat16, 2e-2),
       (2, 1000, 128, True, torch.float32, 2e-5)],
)
def test_cuda_flash_kernel_matches_plain(cuda_device, b, s, d, causal, dtype, tol):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn(b, s, 32, d, device=cuda_device, dtype=dtype, generator=gen)
    k = torch.randn(b, s, 8, d, device=cuda_device, dtype=dtype, generator=gen)
    v = torch.randn(b, s, 8, d, device=cuda_device, dtype=dtype, generator=gen)
    before = TA.flash_attention.launches
    out, lse = TA.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert TA.flash_attention.launches == before + 1
    ref, ref_lse = TA.flash_attention_reference(q, k, v, causal)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_cuda_flash_kernel_is_deterministic(cuda_device):
    # Each block owns its output rows: two launches give the same bits.
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q = torch.randn(2, 1000, 32, 128, device=cuda_device, dtype=torch.bfloat16, generator=gen)
    k, v = (torch.randn(2, 1000, 8, 128, device=cuda_device, dtype=torch.bfloat16, generator=gen)
            for _ in range(2))
    runs = [TA.flash_attention(q, k, v, True) for _ in range(2)]
    torch.cuda.synchronize()
    for first, second in zip(*runs):
        assert torch.equal(first, second)


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


def _rel(got, ref) -> float:
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def _bwd_inputs(device, b, s, d, dtype, seed, causal=True):
    """q, k, v, dO (32 query heads, 8 KV heads), and the forward's LSE and
    the Delta pre-pass over them."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v, do = (
        torch.randn(b, s, heads, d, device=device, dtype=dtype, generator=gen)
        for heads in (32, 8, 8, 32)
    )
    out, lse = TA.flash_attention(q, k, v, causal)
    return q, k, v, do, lse, TA.flash_bwd_delta(out, do)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,s,d,causal,dtype,tol",
    # bf16: the kernels round P and dS to bf16 before three of their
    # products, where the plain version keeps f32 (reason in chip_smoke.py).
    [(b, s, d, True, torch.bfloat16, 2e-2) for b, s, d in _BF16_GRID]
    + [(1, 1000, 128, False, torch.bfloat16, 2e-2), (1, 1000, 128, True, torch.float32, 1e-4)],
)
def test_cuda_flash_bwd_kernels_match_plain(cuda_device, b, s, d, causal, dtype, tol):
    q, k, v, do, lse, delta = _bwd_inputs(cuda_device, b, s, d, dtype, seed=1, causal=causal)
    before = (TA.flash_bwd_dkdv.launches, TA.flash_bwd_dq.launches)
    dk, dv = TA.flash_bwd_dkdv(q, k, v, do, lse, delta, causal)
    dq = TA.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert (TA.flash_bwd_dkdv.launches, TA.flash_bwd_dq.launches) == (before[0] + 1, before[1] + 1)
    ref_dk, ref_dv = TA.flash_bwd_dkdv_reference(q, k, v, do, lse, delta, causal)
    ref_dq = TA.flash_bwd_dq_reference(q, k, v, do, lse, delta, causal)
    for got, ref in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert _rel(got, ref) <= tol


@pytest.mark.cuda
def test_cuda_flash_bwd_kernels_are_deterministic(cuda_device):
    # No atomics: two launches on the same inputs give the same bits.
    q, k, v, do, lse, delta = _bwd_inputs(cuda_device, 2, 1000, 128, torch.bfloat16, seed=2)
    runs = [
        (*TA.flash_bwd_dkdv(q, k, v, do, lse, delta, True),
         TA.flash_bwd_dq(q, k, v, do, lse, delta, True))
        for _ in range(2)
    ]
    torch.cuda.synchronize()
    for first, second in zip(*runs):
        assert torch.equal(first, second)


@pytest.mark.cuda
def test_cuda_fused_loss_rounds_the_input_gradient_once_in_bf16(cuda_device):
    # ROADMAP F8 on the card: ``_mm_f32`` is one bf16 cuBLAS call with an
    # f32 output (the f32 product of the same values), and the fused loss's
    # input gradient does not depend on its chunk count beyond f32 order.
    from hivedscheduler_tpu_torch.models import train

    gen = torch.Generator(device=cuda_device).manual_seed(4)
    a = torch.randn(1024, 4096, generator=gen, device=cuda_device).to(torch.bfloat16)
    w = torch.randn(4096, 1024, generator=gen, device=cuda_device).to(torch.bfloat16)
    got = train._mm_f32(a, w)
    want = a.double() @ w.double()
    assert got.dtype == torch.float32 and got.shape == (1024, 1024)
    # f32 accumulation error, far below the bf16 output's rounding.
    bf16_err = (want.to(torch.bfloat16).double() - want).abs().max().item()
    assert (got.double() - want).abs().max().item() <= 1e-2 * bf16_err
    x = torch.randn(256, 512, generator=gen, device=cuda_device).to(torch.bfloat16)
    head = (torch.randn(512, 32768, generator=gen, device=cuda_device) / 16).to(torch.bfloat16)
    targets = torch.randint(0, 32768, (256,), generator=gen, device=cuda_device)
    grads = []
    for chunk in (8192, 32768):
        tx = x.clone().requires_grad_()
        train._chunked_ce(tx, head, targets, chunk).backward()
        grads.append(tx.grad)
    assert (grads[0] != grads[1]).float().mean().item() <= 1e-3


@pytest.mark.cuda
def test_cuda_tiny_train_step_matches_cpu(cuda_device):
    # The training step on the card (f32 kernels, head_dim 32, remat
    # "flash") against the same step on the CPU (the plain versions).
    import dataclasses

    from hivedscheduler_tpu_torch.models import convert, train, transformer

    config = dataclasses.replace(transformer.tiny(), remat=True, remat_policy="flash")
    cpu = transformer.init(config, torch.Generator().manual_seed(0), "cpu")
    card = convert.params_from_jax(convert.params_to_numpy(cpu), device=cuda_device)
    toks = torch.randint(0, config.vocab_size, (2, 256), generator=torch.Generator().manual_seed(1))
    losses, grads = [], []
    for params, device in ((cpu, "cpu"), (card, cuda_device)):
        opt = train.make_optimizer(params)
        before = TA.flash_bwd_dq.launches
        losses.append([float(train.train_step(params, opt, toks, config, device))])
        grads.append([t.grad.detach().cpu().clone() for t in transformer.leaves(params)])
        losses[-1].append(float(train.train_step(params, opt, toks, config, device)))
    assert TA.flash_bwd_dq.launches == before + 2 * config.n_layers
    # f32 throughout, sums in another order. What is compared: the losses
    # and the step-1 gradients (the JAX package's 1e-4 of max), not the
    # parameters: Adam moves a near-zero gradient of opposite sign 2 lr apart.
    torch.testing.assert_close(torch.tensor(losses[1]), torch.tensor(losses[0]), rtol=0, atol=1e-4)
    for a, b in zip(*grads):
        assert _rel(b, a) < 1e-4


@pytest.mark.cuda
def test_cuda_prefetch_copies_on_a_side_stream(cuda_device):
    # Pinned copies on a side stream; the consumer's stream waits for each,
    # so a kernel queued right after a batch arrives reads its real values.
    import numpy as np

    from hivedscheduler_tpu_torch.utils.data import prefetch_to_device

    batches = [np.full((4, 8192), i, dtype=np.int32) for i in range(6)]
    sums = [(t.long() * 2).sum() for t in prefetch_to_device(iter(batches), cuda_device)]
    torch.cuda.synchronize()
    assert [s.item() for s in sums] == [2 * i * 4 * 8192 for i in range(6)]


# Llama-3-8B's attention as one rank of a tp gang holds it at training's
# B1 S8192: 32/8 heads split over tp = 2, 4 and 8.
_TP_HEADS = {2: (16, 4), 4: (8, 2), 8: (4, 1)}


@pytest.mark.cuda
@pytest.mark.parametrize("tp", sorted(_TP_HEADS))
def test_cuda_kernels_at_the_per_rank_tp_shapes(cuda_device, tp):
    _check_rank_shape(cuda_device, *_TP_HEADS[tp], 8192, tp)


# Ulysses' per-rank attention in the longctx twin's meshes (tp 4, the rest
# sp: 8, 16 and 32 cards), at a length whose plain version fits whole.
_SP_HEADS = {8: (4, 1), 16: (2, 2), 32: (1, 1)}


@pytest.mark.cuda
@pytest.mark.parametrize("cards", sorted(_SP_HEADS))
def test_cuda_kernels_at_the_ulysses_per_rank_shapes(cuda_device, cards):
    _check_rank_shape(cuda_device, *_SP_HEADS[cards], 16384, cards)


# BERT-large's attention (non-causal, 16 heads of 64, S512) as one batch
# shard of its twin holds it and as its tp 2 rank; one microbatch of the
# pipeline twin's stage on four cards (pp 2 x tp 2: B2 S4096 H16/Hkv4).
_MODEL_SHAPES = {"bert_h16": (8, 512, 16, 16, 64, False), "bert_tp2_h8": (8, 512, 8, 8, 64, False),
                 "pp_stage_mb": (2, 4096, 16, 4, 128, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_MODEL_SHAPES))
def test_cuda_kernels_at_bert_and_pipeline_stage_shapes(cuda_device, name):
    b, s, h, hkv, d, causal = _MODEL_SHAPES[name]
    _check_rank_shape(cuda_device, h, hkv, s, sorted(_MODEL_SHAPES).index(name), b, d, causal)


def _check_rank_shape(cuda_device, h, hkv, s, seed, b=1, d=128, causal=True):
    """All three kernels at B x S x H/Hkv x D (bf16) against their plain
    versions."""
    gen = torch.Generator(device=cuda_device).manual_seed(seed)
    q, do = (torch.randn(b, s, h, d, device=cuda_device, dtype=torch.bfloat16,
                         generator=gen) for _ in range(2))
    k, v = (torch.randn(b, s, hkv, d, device=cuda_device, dtype=torch.bfloat16,
                        generator=gen) for _ in range(2))
    out, lse = TA.flash_attention(q, k, v, causal)
    ref, ref_lse = TA.flash_attention_reference(q, k, v, causal)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    del ref, ref_lse
    delta = TA.flash_bwd_delta(out, do)
    dk, dv = TA.flash_bwd_dkdv(q, k, v, do, lse, delta, causal)
    dq = TA.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    ref_dk, ref_dv = TA.flash_bwd_dkdv_reference(q, k, v, do, lse, delta, causal)
    ref_dq = TA.flash_bwd_dq_reference(q, k, v, do, lse, delta, causal)
    for got, want in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        scale = want.float().abs().max().item()
        assert (got.float() - want.float()).abs().max().item() <= 2e-2 * scale


@pytest.mark.cuda
def test_cuda_kernels_at_mixtrals_training_batch(cuda_device):
    # The Mixtral twin's 4 rows x 4096 on one card (or one ep group):
    # Llama-3-8B's heads (32/8 of 128) at a new batch.
    _check_rank_shape(cuda_device, 32, 8, 4096, 9, b=4)


@pytest.mark.cuda
def test_cuda_small_mixtral_matches_cpu(cuda_device):
    # chip_smoke.py phase 11 (a): a small f32 Mixtral that reaches the
    # kernels (S256, head_dim 32), two twin steps under full remat on the
    # card and the CPU, then greedy tokens through the ffn hook.
    from hivedscheduler_tpu_torch.models import convert, generate, mixtral, transformer
    from hivedscheduler_tpu_torch.workloads import train_mixtral

    config = mixtral.MixtralConfig(vocab_size=512, d_model=128, n_layers=2, n_heads=4,
                                   n_kv_heads=2, d_ff=256, n_experts=4, max_seq_len=256,
                                   dtype=torch.float32)
    cpu = mixtral.init(config, torch.Generator().manual_seed(0), "cpu")
    card = convert.params_from_jax(convert.params_to_numpy(cpu), device=cuda_device)
    toks = torch.randint(0, config.vocab_size, (2, 256), generator=torch.Generator().manual_seed(1))
    losses, grads, new = [], [], []
    for params, device in ((cpu, "cpu"), (card, cuda_device)):
        opt = train_mixtral.make_optimizer(params)
        before = TA.kernel_launches()
        losses.append([float(train_mixtral.train_step(params, opt, toks.to(device), config))])
        grads.append([t.grad.detach().cpu().clone() for t in transformer.leaves(params)])
        losses[-1].append(float(train_mixtral.train_step(params, opt, toks.to(device), config)))
        after = TA.kernel_launches()
        new.append(generate.generate(params, toks.to(device), config, 8,
                                     ffn=mixtral.decode_ffn(config))[:, 256:].cpu())
    # Two steps of full remat: the forward twice a layer, each backward once.
    assert {k: after[k] - before[k] for k in after} == {
        "flash_fwd": 8, "flash_bwd_dkdv": 4, "flash_bwd_dq": 4}
    torch.testing.assert_close(torch.tensor(losses[1]), torch.tensor(losses[0]), rtol=0, atol=1e-4)
    for a, b in zip(*grads):
        assert _rel(b, a) < 1e-4
    assert torch.equal(new[0], new[1])


@pytest.mark.cuda
def test_cuda_int8_on_a_one_rank_nccl_mesh_gives_the_unsharded_tokens(cuda_device):
    # chip_smoke.py phase 8 (c) at test size: quantized on the mesh (the
    # max's collectives over one rank skipped), served through the sharded
    # path; a 256-token prompt reaches the flash kernel.
    import torch.distributed as dist

    from hivedscheduler_tpu_torch import serve
    from hivedscheduler_tpu_torch.parallel import mesh as pmesh
    from hivedscheduler_tpu_torch.parallel import sharding

    from ._torch_rendezvous import gang_store, join

    config, params = serve.build("tiny", 3, cuda_device, int8=True)
    prompt = torch.randint(0, config.vocab_size, (2, 256),
                           generator=torch.Generator().manual_seed(4)).to(cuda_device)
    want = serve.run_request(params, prompt, config, 8)
    with gang_store(1) as port:
        join(port, 1, 0, "nccl")
        try:
            mesh = pmesh.make_mesh(pmesh.MeshConfig(), "cuda")
            _, sharded = serve.build("tiny", 3, cuda_device, int8=True, mesh=mesh)
            got = serve.run_request(sharded, sharding.shard_batch(prompt, mesh), config, 8,
                                    mesh=mesh)
        finally:
            dist.destroy_process_group()
    assert want["flash_launches"] == got["flash_launches"] == config.n_layers
    assert torch.equal(got["tokens"], want["tokens"])


def _decode_tree(device, kind, vocab=512):
    """(config, parameters on ``device``, ffn) of a small model for the
    captured decode step: the dense tiny model in f32, its int8 tree, or a
    small Mixtral."""
    from hivedscheduler_tpu_torch.models import mixtral, quantize, transformer

    gen = torch.Generator(device=device).manual_seed(0)
    if kind == "mixtral":
        config = mixtral.MixtralConfig(vocab_size=vocab, d_model=128, n_layers=2, n_heads=4,
                                       n_kv_heads=2, d_ff=256, n_experts=4, max_seq_len=256,
                                       dtype=torch.float32)
        return config, mixtral.init(config, gen, device), mixtral.decode_ffn(config)
    config = transformer.tiny(vocab)
    params = transformer.init(config, gen, device)
    return config, (quantize.quantize_params(params) if kind == "int8" else params), None


@pytest.mark.cuda
@pytest.mark.parametrize("kind,sampled", [("dense", False), ("dense", True), ("int8", False),
                                          ("int8", True), ("mixtral", False),
                                          ("mixtral", True)])
def test_cuda_captured_decode_equals_the_eager_loop(cuda_device, kind, sampled):
    # The graph's tokens against the eager loop's (its plain version), from
    # one generator state when sampled; one capture for the request.
    from hivedscheduler_tpu_torch.models import generate

    config, params, ffn = _decode_tree(cuda_device, kind)
    prompt = torch.randint(0, config.vocab_size, (4, 256),
                           generator=torch.Generator().manual_seed(2)).to(cuda_device)
    knobs = dict(temperature=0.8, top_p=0.95) if sampled else {}

    def run(plain):
        gen = torch.Generator(device=cuda_device).manual_seed(3) if sampled else None
        return generate.generate(params, prompt, config, 12, generator=gen, ffn=ffn,
                                 plain=plain, **knobs)

    captures = generate.Decoder.captures
    graph, eager = run(False), run(True)
    assert generate.Decoder.captures == captures + 1
    assert torch.equal(graph, eager)


@pytest.mark.cuda
def test_cuda_a_second_request_captures_nothing_and_reads_nothing_back(cuda_device):
    from hivedscheduler_tpu_torch.models import generate

    config, params, _ = _decode_tree(cuda_device, "dense")
    prompts = [torch.randint(0, config.vocab_size, (2, 64), generator=torch.Generator()
                             .manual_seed(s)).to(cuda_device) for s in (4, 5)]
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    generate.generate_scan(params, prompts[0], config, 8, gen, temperature=0.8, top_p=0.95)
    captures, replays = generate.Decoder.captures, generate.Decoder.replays
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # any host read of a device value raises
    try:
        out = generate.generate_scan(params, prompts[1], config, 8, gen, temperature=0.8,
                                     top_p=0.95)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert generate.Decoder.captures == captures
    assert generate.Decoder.replays == replays + 7
    assert out.shape == (2, 72) and torch.equal(out[:, :64], prompts[1])


@pytest.mark.cuda
def test_cuda_yielded_tokens_are_not_overwritten(cuda_device):
    from hivedscheduler_tpu_torch.models import generate

    config, params, _ = _decode_tree(cuda_device, "dense")
    prompt = torch.randint(0, config.vocab_size, (2, 64),
                           generator=torch.Generator().manual_seed(7)).to(cuda_device)
    kept = list(generate.generate_stream(params, prompt, config, 8))
    copies = [t.clone() for t in kept]
    list(generate.generate_stream(params, prompt.flip(1), config, 8))
    assert all(torch.equal(a, b) for a, b in zip(kept, copies))
    assert torch.equal(torch.stack(kept, 1),
                       generate.generate(params, prompt, config, 8, plain=True)[:, 64:])


@pytest.mark.cuda
def test_cuda_dropping_the_weights_frees_the_owner(cuda_device):
    # The owner holds the weights weakly and goes with them: its caches,
    # buffers and graphs are freed, and so are the weights.
    import gc
    import weakref

    from hivedscheduler_tpu_torch.models import generate, transformer

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    config, params, _ = _decode_tree(cuda_device, "dense", vocab=2**20)
    weight_bytes = sum(t.numel() * t.element_size() for t in transformer.leaves(params))
    prompt = torch.randint(0, config.vocab_size, (8, 256),
                           generator=torch.Generator().manual_seed(8)).to(cuda_device)
    generate.generate(params, prompt, config, 16)
    owner = weakref.ref(generate.decoder(params, config))
    cache = owner()._slots[(8, 272)].cache
    cache_bytes = 2 * cache.k.numel() * cache.k.element_size()
    del cache
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    del params
    gc.collect()
    torch.cuda.synchronize()
    freed = held - torch.cuda.memory_allocated()
    assert owner() is None
    assert freed >= weight_bytes + cache_bytes
    # What stays: cuBLAS workspaces of the capture's streams, kept by torch.
    assert torch.cuda.memory_allocated() - base < weight_bytes / 2


@pytest.fixture
def nccl_mesh(cuda_device):
    """A one-rank NCCL group and the 6-axis mesh over it (``chip_smoke.py``
    phase 8's); the group is destroyed after the test."""
    import torch.distributed as dist

    from hivedscheduler_tpu_torch.parallel import mesh as pmesh

    from ._torch_rendezvous import gang_store, join

    with gang_store(1) as port:
        join(port, 1, 0, "nccl")
        try:
            yield pmesh.make_mesh(pmesh.MeshConfig(), "cuda")
        finally:
            dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_collectives_captured_over_one_rank_replay_new_inputs(nccl_mesh):
    # The model skips collectives over one rank, so only a direct call
    # captures NCCL on one card: each replay must return its new input.
    from hivedscheduler_tpu_torch.models import generate
    from hivedscheduler_tpu_torch.parallel import sharding

    x = torch.zeros(1000, device="cuda")

    def collectives():
        return torch.stack([sharding._all_gather(x, 0, nccl_mesh, "fsdp"),
                            sharding._reduce_scatter(x, 0, nccl_mesh, "fsdp"),
                            sharding._all_reduce(x, nccl_mesh, "tp"),
                            sharding._all_reduce(x, nccl_mesh, "tp", "max")])

    with torch.inference_mode():
        replay, out = generate._capture(collectives, lambda: None)
        gen = torch.Generator(device="cuda").manual_seed(9)
        for _ in range(3):
            x.copy_(torch.randn(x.shape, device="cuda", generator=gen))
            replay()
            assert torch.equal(out, x.expand(4, -1))


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_cuda_captured_decode_on_a_one_rank_nccl_mesh(nccl_mesh, int8):
    # The mesh's captured step against its eager loop and against one
    # process's captured step on the same weights (phase 8 at test size):
    # bf16, and int8 quantized on the mesh.
    import dataclasses

    from hivedscheduler_tpu_torch.models import generate, quantize, transformer
    from hivedscheduler_tpu_torch.parallel import sharding

    config = dataclasses.replace(transformer.tiny(), dtype=torch.bfloat16)
    axes = transformer.logical_axes(config)
    one = transformer.init(config, torch.Generator(device="cuda").manual_seed(5), "cuda")
    sharded = transformer.init_distributed(config, nccl_mesh,
                                           torch.Generator(device="cuda").manual_seed(5), "cuda")
    if int8:
        one, sharded = quantize.quantize_params(one), quantize.quantize_params(sharded, axes)
    prompt = torch.randint(0, config.vocab_size, (4, 256),
                           generator=torch.Generator().manual_seed(6)).to("cuda")
    want = generate.generate(one, prompt, config, 12)
    local = sharding.shard_batch(prompt, nccl_mesh)
    captures = generate.Decoder.captures
    graph = generate.generate(sharded, local, config, 12, mesh=nccl_mesh)
    assert generate.Decoder.captures == captures + 1
    eager = generate.generate(sharded, local, config, 12, mesh=nccl_mesh, plain=True)
    assert torch.equal(graph, eager) and torch.equal(graph, want)
    again = generate.generate(sharded, local.flip(1), config, 12, mesh=nccl_mesh)
    assert generate.Decoder.captures == captures + 1
    assert torch.equal(again, generate.generate(sharded, local.flip(1), config, 12,
                                                mesh=nccl_mesh, plain=True))


# -- the captured training steps (models/train.step_graphs) ----------------


def _train_case(name, device):
    """(make() -> (params, optimizer, state), batch(i) -> step i's batch on
    the card, step(captured, params, optimizer, state, batch) -> (loss,
    state)) of a small model, large enough to reach the kernels where it
    has attention (S 256; BERT at head_dim 64)."""
    import dataclasses

    import numpy as np

    from hivedscheduler_tpu_torch.models import bert, mixtral, resnet, train, transformer
    from hivedscheduler_tpu_torch.workloads import (train_bert, train_mixtral, train_mnist,
                                                    train_resnet)

    def on_card(*ts):
        return tuple(t.to(device) for t in ts)

    def rows(i, shape, high):
        return on_card(torch.from_numpy(np.random.default_rng(i).integers(0, high, shape)))

    if name == "llama":
        config = dataclasses.replace(transformer.tiny(), remat=True, remat_policy="flash")

        def make():
            params = transformer.init(config, torch.Generator(device=device).manual_seed(0),
                                      device, dtype=torch.float32)
            return params, train.make_optimizer(params), None

        def batch(i):
            return rows(i, (2, 256), config.vocab_size)

        def step(captured, p, o, s, b):
            fn = train.captured_step if captured else train.train_step
            return fn(p, o, *b, config, device), s
    elif name == "mixtral":
        config = mixtral.MixtralConfig(vocab_size=512, d_model=128, n_layers=2, n_heads=4,
                                       n_kv_heads=2, d_ff=256, n_experts=4, max_seq_len=256,
                                       dtype=torch.float32)

        def make():
            params = mixtral.init(config, torch.Generator(device=device).manual_seed(0), device)
            return params, train_mixtral.make_optimizer(params), None

        def batch(i):
            return rows(i, (2, 256), config.vocab_size)

        def step(captured, p, o, s, b):
            fn = train_mixtral.captured_step if captured else train_mixtral.train_step
            return fn(p, o, *b, config), s
    elif name == "bert":
        config = bert.BertConfig(vocab_size=512, d_model=256, n_layers=2, n_heads=4, d_ff=512,
                                 max_seq_len=256, dtype=torch.float32)

        def make():
            params = bert.init(config, torch.Generator(device=device).manual_seed(0), device)
            return params, train_bert.make_optimizer(params), None

        def batch(i):
            return on_card(*train_bert.masked_batch(np.random.default_rng(i), 2, 256,
                                                    config.vocab_size))

        def step(captured, p, o, s, b):
            fn = train_bert.captured_step if captured else train_bert.train_step
            return fn(p, o, *b, config), s
    elif name == "resnet":
        config = resnet.ResNetConfig(num_classes=10, width=16, dtype=torch.float32)

        def make():
            params, stats = resnet.init(config, torch.Generator(device=device).manual_seed(0),
                                        device)
            return params, train_resnet.make_optimizer(params), stats

        def batch(i):
            return on_card(*train_resnet.synthetic_batch(np.random.default_rng(i), 4, 32, 10))

        def step(captured, p, o, s, b):
            fn = train_resnet.captured_step if captured else train_resnet.train_step
            return fn(p, s, o, *b, config)
    else:
        def make():
            params = {k: torch.from_numpy(v).to(device)
                      for k, v in train_mnist.init(np.random.default_rng(0)).items()}
            return params, train_mnist.make_optimizer(params), None

        def batch(i):
            return on_card(*(torch.from_numpy(a) for a in
                             train_mnist.synthetic_data(np.random.default_rng(i), 64)))

        def step(captured, p, o, s, b):
            fn = train_mnist.captured_step if captured else train_mnist.train_step
            return fn(p, o, *b), s
    return make, batch, step


@pytest.fixture
def deterministic_cudnn():
    # cuDNN may pick a backward that adds with atomics, which no two runs
    # repeat bit for bit, captured or not.
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = was


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["llama", "bert", "mixtral", "resnet", "mnist"])
def test_cuda_captured_train_step_equals_the_eager_step(cuda_device, deterministic_cudnn, name):
    # Each on its own capturable optimizer from the same seed: the graph's
    # losses, parameters (and ResNet's stats) after four steps on four new
    # batches equal the eager steps' bit for bit, and each kernel's launches
    # a step, counted through the replays, equal the eager step's. The last
    # replay reads nothing back to the host.
    from hivedscheduler_tpu_torch.models import train, transformer

    make, batch, step = _train_case(name, cuda_device)
    runs = {}
    for captured in (False, True):
        params, opt, state = make()
        losses, launches = [], []
        captures, replays = train.StepGraphs.captures, train.StepGraphs.replays
        for i in range(4):
            b = batch(i)
            before = TA.kernel_launches()
            torch.cuda.synchronize()
            if captured and i == 3:
                torch.cuda.set_sync_debug_mode("error")  # any host read raises
            try:
                loss, state = step(captured, params, opt, state, b)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            losses.append(loss)
            after = TA.kernel_launches()
            launches.append({k: after[k] - before[k] for k in after})
        assert train.StepGraphs.captures == captures + captured
        assert train.StepGraphs.replays == replays + 3 * captured
        runs[captured] = (losses, transformer.leaves(params),
                          transformer.leaves(state) if state is not None else [], launches)
    (el, ep, es, eln), (cl, cp, cs, cln) = runs[False], runs[True]
    assert all(torch.equal(a, b) for a, b in zip(el, cl))
    assert len({float(x) for x in cl}) == 4  # each batch its own loss
    assert all(torch.equal(a, b) for a, b in zip(ep + es, cp + cs))
    assert eln == cln
    if name in ("llama", "bert", "mixtral"):
        assert all(n["flash_bwd_dq"] == 2 for n in cln)


@pytest.mark.cuda
def test_cuda_captured_train_step_on_a_one_rank_nccl_mesh(nccl_mesh):
    # chip_smoke.py phase 8's training step at test size: DTensor leaves,
    # their capturable AdamW and the DTensor gradient stash, through the
    # owner on the mesh, against the eager mesh step and the unsharded
    # captured step from the same seed, bit for bit.
    import dataclasses

    from hivedscheduler_tpu_torch.models import train, transformer
    from hivedscheduler_tpu_torch.parallel import sharding

    config = dataclasses.replace(transformer.tiny(), remat=True, remat_policy="flash")
    tokens = torch.randint(0, config.vocab_size, (2, 256),
                           generator=torch.Generator().manual_seed(7)).to("cuda")

    def run(mesh, captured):
        params, opt = train.init_sharded(config, mesh,
                                         torch.Generator(device="cuda").manual_seed(0), "cuda")
        assert opt.param_groups[0]["capturable"]
        local = tokens if mesh is None else sharding.shard_batch(tokens, mesh)
        step = train.captured_step if captured else train.train_step
        losses = [step(params, opt, local, config, "cuda", mesh) for _ in range(3)]
        return losses, train.tree_digest(params)

    captures = train.StepGraphs.captures
    graph = run(nccl_mesh, True)
    assert train.StepGraphs.captures == captures + 1
    eager = run(nccl_mesh, False)
    one = run(None, True)
    for other in (eager, one):
        assert all(torch.equal(a, b) for a, b in zip(graph[0], other[0]))
        assert graph[1] == other[1]


@pytest.mark.cuda
def test_cuda_captured_step_through_the_all_to_all_backward(nccl_mesh):
    # Ulysses' exchange inside a captured training step on a one-rank NCCL
    # group (the model skips collectives over one rank, so ``_AllToAll`` is
    # called directly): its forward, and its backward issued from autograd's
    # engine, through the owner's warm-up on a side stream and its capture;
    # the losses and the weights bitwise the eager step's.
    from hivedscheduler_tpu_torch.models import train
    from hivedscheduler_tpu_torch.parallel import sharding

    x = torch.randn(2, 8, 256, generator=torch.Generator().manual_seed(3)).to("cuda")

    def run(captured):
        params = {"w": torch.randn(8, 256, generator=torch.Generator().manual_seed(4)).cuda()}
        opt = train.make_optimizer(params)
        assert opt.param_groups[0]["capturable"]

        def step(batch):
            opt.zero_grad(set_to_none=True)
            y = sharding._AllToAll.apply(batch * params["w"], nccl_mesh, "sp")
            loss = sharding._AllToAll.apply(y.tanh(), nccl_mesh, "sp").square().mean()
            loss.backward()
            opt.step()
            return loss.detach()

        owner = train.step_graphs(params, opt)
        losses = [owner.step(("all_to_all", nccl_mesh), step, params, (x,))[0] if captured
                  else step(x) for _ in range(3)]
        return losses, train.tree_digest(params)

    captures = train.StepGraphs.captures
    graph = run(True)
    assert train.StepGraphs.captures == captures + 1
    eager = run(False)
    assert all(torch.equal(a, b) for a, b in zip(graph[0], eager[0]))
    assert graph[1] == eager[1]


@pytest.mark.cuda
def test_cuda_a_capture_that_fails_raises(cuda_device):
    # An AdamW whose step count lives on the host cannot be captured: the
    # owner raises (no quiet eager fallback on the card).
    import dataclasses

    from hivedscheduler_tpu_torch.models import train, transformer

    config = dataclasses.replace(transformer.tiny(), n_layers=1)
    params = transformer.init(config, torch.Generator(device=cuda_device).manual_seed(0),
                              cuda_device, dtype=torch.float32)
    opt = train.make_optimizer(params, capturable_step=False)
    with pytest.raises(RuntimeError, match="capturable"):
        train.captured_step(params, opt, torch.zeros(1, 256, dtype=torch.long), config)
