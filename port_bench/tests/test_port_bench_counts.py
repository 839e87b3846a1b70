"""The benchmark's operation and byte counts, pinned to values worked out
by hand at the cells' shapes."""

import json

import pytest

from port_bench import harness
from port_bench.counts import flash, model
from port_bench.counts import mixtral as counts_mixtral


def _config(name):
    return harness.find_cell(name).config


def test_flash_forward_at_mixtral_training_shape():
    # B4 S4096 H32 D128 causal: 2 products x 2 x 128 x (4096 * 4097 / 2) x 4 x 32.
    assert flash.flops("fwd", 4, 4096, 32, 128, True) == 2 * 2 * 128 * 8390656 * 128
    t, by = flash.bound_s("fwd", 4, 4096, 32, 8, 128, True)
    assert by == "operations"
    assert t == pytest.approx(549890031616 / 989e12, rel=1e-12)
    assert t * 1e3 == pytest.approx(0.556, abs=5e-4)  # the kernel table's bound


def test_flash_backward_at_mixtral_training_shape():
    assert flash.bound_s("dkdv", 4, 4096, 32, 8, 128, True)[0] * 1e3 == pytest.approx(
        1.112, abs=5e-4)
    assert flash.bound_s("dq", 4, 4096, 32, 8, 128, True)[0] * 1e3 == pytest.approx(
        0.834, abs=5e-4)


def test_flash_at_bert_shape_is_bytes_bound():
    # B8 S512 H16 D64 non-causal, bf16: q, k, v, o of 8 MiB... 4 x 2 x 64 x 8 x 512 x 16
    # bytes plus the f32 LSE of 4 x 8 x 16 x 512 bytes.
    q = 2 * 64 * 8 * 512 * 16
    assert flash.nbytes("fwd", 8, 512, 16, 16, 64) == 4 * q + 4 * 8 * 16 * 512
    t, by = flash.bound_s("fwd", 8, 512, 16, 16, 64, False)
    assert by == "bytes"
    assert t * 1e3 == pytest.approx(0.0101, abs=5e-5)  # the kernel table's bound
    # At the cell's batch of 64, eight times as much.
    assert flash.bound_s("fwd", 64, 512, 16, 16, 64, False)[0] == pytest.approx(8 * t)


def test_mixtral_training_flops_per_token():
    cfg = _config("mixtral-train-4x4k")
    # Per layer: q, o 4096 x 4096 each, k, v 4096 x 1024 each, 2 of 8 experts of
    # 3 x 4096 x 14336, the router 4096 x 8; the head 4096 x 32000.
    layer = 2 * 4096 * 4096 + 2 * 4096 * 1024 + 2 * 3 * 4096 * 14336 + 4096 * 8
    assert counts_mixtral.layer_matmul_params(cfg) == layer == 394297344
    attn = 2 * (2 * 2 * 4096 * 4097 / 2)  # two layers, QK and PV over 2048.5 keys
    want = 6 * (2 * layer + 4096 * 32000) + 3 * attn
    assert model.train_flops_per_token(cfg, 4096) == pytest.approx(want, rel=1e-12)
    assert model.train_flops_per_token(cfg, 4096) == pytest.approx(5.718e9, rel=1e-3)


def test_bert_training_flops_per_token():
    cfg = _config("bert-train-64x512")
    layer = 4 * 1024 * 1024 + 2 * 1024 * 4096
    want = 6 * (24 * layer + 1024 * 30522) + 3 * 24 * 2 * 2 * 1024 * 512
    assert model.train_flops_per_token(cfg, 512) == pytest.approx(want, rel=1e-12)
    assert model.train_flops_per_token(cfg, 512) == pytest.approx(2.152e9, rel=1e-3)


def test_causality_is_the_configurations():
    cfg = _config("bert-train-64x512")
    full = model.train_flops_per_token(cfg, 512)
    causal = model.train_flops_per_token({**cfg, "causal": True}, 512)
    assert causal == pytest.approx(full - 3 * 24 * 2 * 2 * 1024 * (512 - 513 / 2), rel=1e-12)
    assert model.attention_shape(cfg, 32, 512)[-1] is False
    assert model.attention_shape(_config("mixtral-train-4x4k"), 4, 4096)[-1] is True


def test_counts_refuse_an_unknown_family():
    with pytest.raises(ModuleNotFoundError):
        model.train_flops_per_token({**_config("mixtral-train-4x4k"), "family": "other"}, 8)


def test_benchmark_json_is_valid_json():
    with open(harness.ROOT / "BENCHMARK.json") as f:
        json.load(f)
