"""The port's perf harness (hivedscheduler_tpu_torch.models.perf) against the
JAX package's: its guards and artifact rules give the JAX functions' results
on the same inputs, its CPU miniature is the JAX one, and it never falls
back: a CPU run persists nothing and a failing kernel fails the run."""

import json
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from hivedscheduler_tpu.models import perf as JP
from hivedscheduler_tpu.models import transformer as JT
from hivedscheduler_tpu_torch.models import perf as TP
from hivedscheduler_tpu_torch.ops import attention as TA
from hivedscheduler_tpu_torch.tools import mfu_sweep

H100 = "NVIDIA H100 80GB HBM3"
PROV = {"git_commit": "abc123", "measured_at": "2026-07-30T00:00:00Z"}
OLD_PROV = {"git_commit": "def456", "measured_at": "2026-07-29T00:00:00Z"}


@pytest.fixture
def jax_peaks(monkeypatch):
    """The JAX functions, looking up the port's peak table: the same rule
    on the same card names."""
    monkeypatch.setattr(JP, "PEAK_BF16", TP.PEAK_BF16)


@pytest.mark.parametrize("flops,tps,name", [
    (2.2e9, 96452.2, H100),          # a plausible card run
    (2.2e9, 5e6, H100),              # MFU > 1: a timing that did not wait
    (2.2e9, 0.0, H100),              # MFU 0
    (2.2e9, 96452.2, "NVIDIA H100 PCIe"),
    (2.2e9, 96452.2, "NVIDIA A100-SXM4-80GB"),  # not in the table
    (2.2e9, 96452.2, "cpu"),
])
def test_mfu_fields_match_jax(jax_peaks, flops, tps, name):
    assert TP.mfu_fields(flops, tps, name) == JP.mfu_fields(flops, tps, name)


def test_peak_table():
    assert TP.peak_flops(H100) == TP.H100_BF16_FLOPS == 989e12
    assert TP.peak_flops("NVIDIA H100 PCIe") == 756e12
    assert TP.peak_flops("cpu") is None
    rejected = TP.mfu_fields(1e12, 1e3, H100)
    assert rejected["mfu"] is None and rejected["mfu_rejected"] > 1


STAGE_VALUES = [
    [{"batch": 8, "tokens_per_sec": 1.0}, {"batch": 64, "error": "OOM"}],
    [{"seq": 16384, "mfu_rejected": 1.7}],
    [{"error": "unparseable entry 'x'"}],
    {"error": "boom"},
    {"bert_large_step_ms": 5.0},
    [],
]


@pytest.mark.parametrize("val", STAGE_VALUES)
def test_stage_rows_clean_matches_jax(val):
    assert TP.stage_rows_clean(val) == JP.stage_rows_clean(val)


@pytest.mark.parametrize("record", [
    {"provenance": PROV, "carried_forward": {"zoo": OLD_PROV}},
    {"provenance": PROV, "carried_forward": ["zoo"]},
    {"provenance": PROV},
    {},
])
@pytest.mark.parametrize("stage", ["zoo", "long_context", "decode_sweep"])
def test_carried_provenance_matches_jax(record, stage):
    assert TP.carried_provenance(record, stage) == JP.carried_provenance(record, stage)


@pytest.mark.parametrize("dst", [
    {"tokens_per_sec_per_chip": 2.0},
    {"carried_forward": ["zoo"]},
    {"carried_forward": {"zoo": OLD_PROV}},
])
def test_attach_carried_matches_jax(dst):
    src = {"decode_sweep": [{"batch": 64}], "provenance": PROV,
           "carried_forward": {"long_context": OLD_PROV}, "long_context": [{"seq": 1}]}
    for stage in ("decode_sweep", "long_context"):
        got, ref = json.loads(json.dumps(dst)), json.loads(json.dumps(dst))
        TP.attach_carried(got, src, stage)
        JP.attach_carried(ref, src, stage)
        assert got == ref


def test_env_int_csv_matches_jax(monkeypatch):
    monkeypatch.setenv("HIVED_PERF_DECODE_BATCHES", "8, x,,32,1e3")
    assert list(TP._env_int_csv("HIVED_PERF_DECODE_BATCHES", "1")) == list(
        JP._env_int_csv("HIVED_PERF_DECODE_BATCHES", "1"))


PREVIOUS = {
    "tokens_per_sec_per_chip": 1.0,
    "zoo": {"bert_large_step_ms": 5.0},
    "long_context": [{"seq": 16384, "mfu": 0.5}],
    "decode_sweep": [{"batch": 64, "tokens_per_sec": 9000.0}],
    "carried_forward": ["zoo"],
    "provenance": PROV,
}
RESULTS = [
    {"tokens_per_sec_per_chip": 2.0, "mfu": 0.5},
    {"tokens_per_sec_per_chip": 2.0,
     "decode_sweep": [{"batch": 8, "tokens_per_sec": 100.0}, {"batch": 64, "error": "OOM"}],
     "long_context": [{"seq": 16384, "error": "OOM"}]},
    {"tokens_per_sec_per_chip": 2.0, "mfu": None, "mfu_rejected": 1.7},
    {"train_error": "RuntimeError: ..."},
]


@pytest.mark.parametrize("result", RESULTS)
@pytest.mark.parametrize("previous", [PREVIOUS, None])
@pytest.mark.parametrize("on_card", [True, False])
def test_persist_result_matches_jax(tmp_path, monkeypatch, result, previous, on_card):
    monkeypatch.setattr("hivedscheduler_tpu.ops.attention.pallas_wanted", lambda: True)
    # The same rules over the same stages.
    assert set(TP.CARRY_STAGES) == set(JP.CARRY_STAGES)
    monkeypatch.setattr(JP, "CARRY_STAGES", TP.CARRY_STAGES)
    records = []
    for name, persist in (("jax", JP.persist_result), ("torch", TP.persist_result)):
        path = tmp_path / f"{name}.json"
        if previous is not None:
            path.write_text(json.dumps(previous))
        monkeypatch.setenv("HIVED_PERF_ARTIFACT", str(path))
        persist(json.loads(json.dumps(result)), on_card)
        rec = json.loads(path.read_text()) if path.exists() else None
        if rec is not None and rec != previous:
            assert rec.pop("provenance")["measured_at"] != PROV["measured_at"]
        records.append(rec)
    assert records[1] == records[0]
    if previous is not None and records[1] not in (None, previous):
        # The zoo's rows are carried forward, as the other stages' are.
        assert records[1]["zoo"] == previous["zoo"]


def test_artifact_path_sits_beside_the_jax_ones(monkeypatch):
    monkeypatch.delenv("HIVED_PERF_ARTIFACT", raising=False)
    monkeypatch.delenv("HIVED_PERF_MODEL", raising=False)
    for model in (None, "268m", "800m"):
        got, ref = TP.artifact_path(model), JP.artifact_path(model)
        assert got != ref
        assert got.rsplit("/", 1)[0] == ref.rsplit("/", 1)[0]  # example/logs
    assert TP.artifact_path().endswith("example/logs/perf_last_measured_torch.json")
    assert TP.artifact_path("800m").endswith("perf_last_measured_torch_800m.json")
    monkeypatch.setenv("HIVED_PERF_ARTIFACT", "/elsewhere/a.json")
    assert TP.artifact_path() == "/elsewhere/a.json"
    assert TP.artifact_path("268m") == JP.artifact_path("268m").replace(
        "perf_last_measured.json", "perf_last_measured_torch.json")


FIELDS = ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads", "d_ff",
          "max_seq_len", "remat", "remat_policy")


def _fields(config):
    return {f: getattr(config, f) for f in FIELDS}


def test_bench_config_cpu_branch_matches_jax(monkeypatch):
    monkeypatch.setenv("HIVED_PERF_BATCH", "7")  # the miniature ignores overrides
    (tc, tb, ts), (jc, jb, js) = TP.bench_config(False), JP.bench_config(False)
    assert (_fields(tc), tb, ts) == (_fields(jc), jb, js)
    assert tc.dtype == torch.float32 and jc.dtype == jnp.float32


@pytest.mark.parametrize("env", [
    {},
    {"HIVED_PERF_MODEL": "800m", "HIVED_PERF_BATCH": "3", "HIVED_PERF_SEQ": "4096",
     "HIVED_PERF_REMAT": "dots+flash"},
])
def test_bench_config_card_branch_matches_jax(monkeypatch, env):
    for k in ("HIVED_PERF_MODEL", "HIVED_PERF_BATCH", "HIVED_PERF_SEQ", "HIVED_PERF_REMAT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    (tc, tb, ts), (jc, jb, js) = TP.bench_config(True), JP.bench_config(True)
    assert (_fields(tc), tb, ts) == (_fields(jc), jb, js)
    assert tc.dtype == torch.bfloat16 and jc.dtype == jnp.bfloat16
    assert TP.bench_config(True, batch=1, seq=16384)[1:] == JP.bench_config(True, 1, 16384)[1:]


def test_main_on_the_cpu_prints_json_and_persists_nothing(tmp_path, monkeypatch, capsys):
    artifact = tmp_path / "perf.json"
    monkeypatch.setenv("HIVED_PERF_ARTIFACT", str(artifact))
    monkeypatch.setenv("HIVED_PERF_DECODE", "1")
    monkeypatch.setenv("HIVED_PERF_DECODE_BATCHES", "2")
    monkeypatch.setenv("HIVED_PERF_LONGCTX", "1")
    monkeypatch.setenv("HIVED_PERF_LONGCTX_SEQS", "512,x")
    result = TP.main(["--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(result))
    assert result["backend"] == "cpu" and "mfu" not in result
    cfg, batch, seq = TP.bench_config(False)
    assert (result["batch"], result["seq"]) == (batch, seq)
    assert result["loss"] is not None and result["flash_fwd_bwd_ms"] > 0
    assert result["long_context"][1] == {"error": "unparseable entry 'x' in HIVED_PERF_LONGCTX_SEQS"}
    assert [r.get("batch") for r in result["decode_sweep"]] == [2, 2, 2]
    assert result["decode_sweep"][1]["int8"] is True
    # At the miniature's 2 and 6 tokens a loaded host can swamp the
    # difference: that, and only that, is reported as a row's error.
    for row in result["decode_sweep"][:2]:
        assert "decode_ms_per_token" in row or "host timing jitter" in row["error"]
    assert result["decode_sweep"][2]["prefill_len"] == 64 and "error" not in result["decode_sweep"][2]
    assert not artifact.exists()


def test_main_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TP.main([])


def test_a_failing_kernel_fails_main(tmp_path, monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("hived_flash_fwd kernel launch failed: CUDA error 700")

    monkeypatch.setattr(TA, "flash_attention", broken)
    monkeypatch.setenv("HIVED_PERF_ARTIFACT", str(tmp_path / "perf.json"))
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        TP.main(["--device", "cpu"])
    assert not (tmp_path / "perf.json").exists()


def test_bench_train_step_counts_params_flops_and_launches():
    row = TP.bench_train_step(False)
    assert row["launches"] == {"flash_fwd": 0, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}  # CPU
    cfg, batch, seq = TP.bench_config(False)
    jcfg, _, _ = JP.bench_config(False)
    n = JP.n_params(JT.init(jcfg, jax.random.PRNGKey(0)))
    assert row["model_params_m"] == round(n / 1e6, 1)
    assert row["flops_per_token"] == JP.flops_per_token(jcfg, n, seq)
    assert (row["batch"], row["seq"]) == (batch, seq)
    assert row["loss"] is not None and "loss_nonfinite" not in row


def test_mfu_sweep_rows_and_env(monkeypatch, capsys):
    monkeypatch.setenv("HIVED_PERF_BATCH", "5")
    monkeypatch.delenv("HIVED_PERF_REMAT", raising=False)
    seen = []

    def bench(on_gpu):
        seen.append((on_gpu, os.environ["HIVED_PERF_BATCH"], os.environ["HIVED_PERF_REMAT"]))
        return {"flops_per_token": 1e9, "tokens_per_sec_per_chip": 1e5}

    monkeypatch.setattr(TP, "bench_train_step", bench)
    rows = mfu_sweep.main(["--device", "cpu"])
    assert seen == [(False, c["HIVED_PERF_BATCH"], c["HIVED_PERF_REMAT"])
                    for c in mfu_sweep.CONFIGS]
    assert [r["config"] for r in rows] == mfu_sweep.CONFIGS
    assert all(r["flops_per_token"] == 1e9 and "mfu" not in r for r in rows)  # no CPU MFU
    assert len(capsys.readouterr().out.strip().splitlines()) == len(mfu_sweep.CONFIGS)
    # Each setting's env is undone.
    assert os.environ["HIVED_PERF_BATCH"] == "5" and "HIVED_PERF_REMAT" not in os.environ


def test_mfu_sweep_failing_setting_is_an_error_row(monkeypatch):
    def boom(on_gpu):
        raise RuntimeError("out of memory")

    monkeypatch.setattr(TP, "bench_train_step", boom)
    rows = mfu_sweep.main(["--device", "cpu"])
    assert all(r["error"] == "RuntimeError: out of memory" for r in rows)


def test_flops_per_token_matches_jax():
    cfg, _, seq = TP.bench_config(True)
    jcfg, _, _ = JP.bench_config(True)
    assert TP.flops_per_token(cfg, 268_468_224, seq) == JP.flops_per_token(jcfg, 268_468_224, seq)
