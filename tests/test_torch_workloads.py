"""The port's job entry points as the scheduler launches them: the env-block
bootstrap (hivedscheduler_tpu_torch.workloads.common) and the card grant,
``train.main`` on a token file, ``serve.main`` on a checkpoint, against the
JAX package, and both as two-process gloo gangs against one process."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivedscheduler_tpu import common as jcommon
from hivedscheduler_tpu.models import generate as JG
from hivedscheduler_tpu.models import quantize as JQ
from hivedscheduler_tpu.models import transformer as JT
from hivedscheduler_tpu.utils import data as JD
from hivedscheduler_tpu_torch import serve
from hivedscheduler_tpu_torch import train as entry
from hivedscheduler_tpu_torch.models import checkpoint, convert, train, transformer
from hivedscheduler_tpu_torch.models import generate as TG
from hivedscheduler_tpu_torch.models import quantize as TQ
from hivedscheduler_tpu_torch.parallel import mesh
from hivedscheduler_tpu_torch.workloads import common

from ._multiproc import run_workers
from ._torch_rendezvous import gang_store

BLOCK = {
    "TPU_VISIBLE_CHIPS": "0,1,2,3",
    "TPU_WORKER_ID": "1",
    "JAX_PROCESS_ID": "1",
    "TPU_WORKER_HOSTNAMES": "tpu-w0,tpu-w1",
    "JAX_COORDINATOR_ADDRESS": "tpu-w0:8476",
    "JAX_NUM_PROCESSES": "1",
}


def test_parse_env_block_reads_the_schedulers_emitter():
    text = jcommon.to_yaml_fast(BLOCK)
    assert common.parse_env_block(text) == BLOCK
    assert common.parse_env_block("") == {}
    assert common.parse_env_block("# comment\n\nA: b\n") == {"A": "b"}
    for bad in ("A:\n  B: c\n", "just text\n", "A:\n"):
        with pytest.raises(ValueError, match="KEY: value"):
            common.parse_env_block(bad)


def test_bootstrap_lifts_the_block_with_setdefault(monkeypatch):
    for key in [*BLOCK, "CUDA_VISIBLE_DEVICES"]:  # set, then unset: undone after the test
        monkeypatch.setenv(key, "")
        monkeypatch.delenv(key)
    monkeypatch.setenv("TPU_VISIBLE_CHIPS", "7")  # already set: wins over the block
    monkeypatch.setenv(common.ENV_BLOCK_VAR, jcommon.to_yaml_fast(BLOCK))
    seen = []
    monkeypatch.setattr(common, "initialize_from_env", lambda device=None: seen.append(device))
    assert common.bootstrap_distributed("cpu") == 1
    assert seen == ["cpu"]
    assert os.environ["TPU_VISIBLE_CHIPS"] == "7"
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "7"  # the grant that won
    for key in BLOCK.keys() - {"TPU_VISIBLE_CHIPS"}:
        assert os.environ[key] == BLOCK[key]


def test_bootstrap_without_a_block_is_rank_zero(monkeypatch):
    for key in (common.ENV_BLOCK_VAR, "JAX_PROCESS_ID", "JAX_NUM_PROCESSES"):
        monkeypatch.delenv(key, raising=False)
    assert common.bootstrap_distributed("cpu") == 0


def test_synthetic_tokens_reexported_by_serve():
    assert serve.synthetic_tokens is common.synthetic_tokens
    toks = common.synthetic_tokens(np.random.default_rng(0), 2, 5, 11)
    assert toks.shape == (2, 5) and toks.dtype == np.int64 and toks.max() < 11


@pytest.fixture
def token_file(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(4).integers(0, 512, size=16 * 64 + 1, dtype=np.uint16).tofile(path)
    return str(path)


def test_train_main_on_a_token_file_equals_run_on_the_same_batches(token_file, capsys):
    got = entry.main(["--device", "cpu", "--model", "tiny", "--data", token_file,
                      "--seq", "64", "--batch", "2", "--steps", "3", "--opportunistic"])
    assert capsys.readouterr().out.splitlines()[0] == (
        "tiny: 2 layers, 426,624 parameters, batch 2 x 64 on cpu")
    # The same batches, drawn by the JAX package's dataset (seed 1, as
    # train_llama.py draws them), through train.run from the same weights.
    ds = JD.TokenFileDataset(token_file, 63)
    batches = [torch.from_numpy(b) for _, b in zip(range(3), ds.batches(2, seed=1))]
    config, params = entry.build("tiny", 0, "cpu")
    ref = list(entry.run(params, config, batches, 3))
    assert [r["loss"] for r in got.records] == [r["loss"] for r in ref]
    for a, b in zip(transformer.leaves(got.params), transformer.leaves(params)):
        assert torch.equal(a, b)
    assert got.optimizer.state_dict()["state"][0]["step"].item() == 3


def test_train_main_without_data_keeps_the_fixed_batch(capsys):
    got = entry.main(["--device", "cpu", "--model", "tiny", "--seq", "256", "--steps", "2"])
    assert len(got.records) == 2 and got.records[1]["loss"] < got.records[0]["loss"]


def test_token_dtype_follows_the_vocab():
    assert entry.token_dtype(512) == np.uint16
    assert entry.token_dtype(65536) == np.uint16  # ids 0..65535
    assert entry.token_dtype(transformer.llama3_8b().vocab_size) == np.uint32
    assert entry.token_dtype(512, "uint32") == np.uint32
    with pytest.raises(ValueError, match="uint16 cannot hold"):
        entry.token_dtype(128256, "uint16")


ENTRY_WORKER = os.path.join(os.path.dirname(__file__), "_torch_entry_worker.py")


def gang(mode, world, argv):
    with gang_store(world) as port:
        return run_workers(ENTRY_WORKER, [[mode, str(r), str(world), str(port), *argv]
                                          for r in range(world)], timeout=240)


def test_two_process_train_main_matches_one_process_on_the_same_batches(token_file, capsys):
    # Two ranks of fsdp 2 (train_llama.py's layout for 2 processes), two rows
    # each: the global batches are the one-process run's four rows.
    argv = ["--model", "tiny", "--data", token_file, "--seq", "64", "--steps", "3"]
    outs = gang("train", 2, argv + ["--batch", "2"])
    ref = entry.main(argv + ["--batch", "4", "--device", "cpu"])
    want = [r["loss"] for r in ref.records]
    for o in outs:
        assert o["world"] == 2
        np.testing.assert_allclose(o["losses"], want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("source", ["seed", "ckpt", "seed-int8", "ckpt-int8"])
def test_two_process_serve_main_at_tp2_gives_the_one_process_tokens(source, tmp_path, capsys):
    argv = ["--model", "tiny", "--temperature", "0", "--requests", "2", "--batch", "2",
            "--prompt-len", "32", "--new-tokens", "6", "--seed", "4"]
    if source.endswith("int8"):  # each rank quantizes its own shards
        argv += ["--int8"]
    if source.startswith("ckpt"):  # written by one process, read as each rank's tp shards
        _, params = entry.build("tiny", 7, "cpu")
        checkpoint.TrainCheckpointer(str(tmp_path)).save(1, params, train.make_optimizer(params))
        argv += ["--ckpt", str(tmp_path)]
    outs = gang("serve", 2, argv)  # tp 2: each rank serves every row
    ref = serve.main(argv + ["--device", "cpu"])
    for o in outs:
        assert o["world"] == 2
        assert o["tokens"] == [r["tokens"].tolist() for r in ref]


def _clear(monkeypatch, *keys):
    for key in keys:  # set, then unset: the test's changes are undone after it
        monkeypatch.setenv(key, "")
        monkeypatch.delenv(key)


def test_chip_grant_becomes_the_visible_cards(monkeypatch):
    _clear(monkeypatch, "CUDA_VISIBLE_DEVICES", "TPU_VISIBLE_CHIPS", common.ENV_BLOCK_VAR)
    monkeypatch.setenv(common.ENV_BLOCK_VAR, 'TPU_VISIBLE_CHIPS: "2,3"\n')
    common.lift_env_block()
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "2,3"
    # One process a pod takes the pod's first granted card, not card `rank`.
    assert mesh.cuda_index(os.environ, rank=1, visible=2) == 0
    assert mesh.cuda_index({}, rank=5, visible=2) == 1


def test_cuda_visible_devices_already_set_wins(monkeypatch):
    _clear(monkeypatch, "TPU_VISIBLE_CHIPS", common.ENV_BLOCK_VAR)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "5")
    monkeypatch.setenv(common.ENV_BLOCK_VAR, 'TPU_VISIBLE_CHIPS: "2,3"\n')
    common.lift_env_block()
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "5"


@pytest.mark.parametrize("grant", ["", "a,b", "1,,2", "-1"])
def test_a_malformed_grant_raises(monkeypatch, grant):
    _clear(monkeypatch, "CUDA_VISIBLE_DEVICES", "TPU_VISIBLE_CHIPS")
    monkeypatch.setenv("TPU_VISIBLE_CHIPS", grant)
    with pytest.raises(ValueError, match="comma list of card indices"):
        mesh.apply_chip_grant()
    assert "CUDA_VISIBLE_DEVICES" not in os.environ


@pytest.mark.parametrize("module,argv", [
    (entry, ["--model", "tiny", "--steps", "1", "--seq", "16"]),
    (serve, ["--model", "tiny", "--requests", "1", "--prompt-len", "8", "--new-tokens", "1"]),
])
def test_entry_points_apply_the_grant_before_resolving_the_device(monkeypatch, module, argv):
    # CUDA reads CUDA_VISIBLE_DEVICES once, at its first initialisation, and
    # resolve_device asks CUDA whether it is available.
    _clear(monkeypatch, "CUDA_VISIBLE_DEVICES", "TPU_VISIBLE_CHIPS", "JAX_NUM_PROCESSES",
           common.ENV_BLOCK_VAR)
    monkeypatch.setenv(common.ENV_BLOCK_VAR, 'TPU_VISIBLE_CHIPS: "2,3"\n')
    seen = []

    def resolve(device=None):
        seen.append(os.environ.get("CUDA_VISIBLE_DEVICES"))
        return torch.device("cpu")

    monkeypatch.setattr(module, "resolve_device", resolve)
    module.main(argv)
    assert seen and seen[0] == "2,3"


def test_serve_main_on_a_checkpoint_gives_the_jax_greedy_tokens(tmp_path, capsys):
    jcfg = JT.tiny()
    jparams = JT.init(jcfg, jax.random.PRNGKey(3))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    ckpt = checkpoint.TrainCheckpointer(str(tmp_path))
    ckpt.save(11, params, train.make_optimizer(params))

    results = serve.main(["--device", "cpu", "--model", "tiny", "--ckpt", str(tmp_path),
                          "--temperature", "0", "--requests", "1", "--batch", "2",
                          "--prompt-len", "16", "--new-tokens", "5", "--seed", "9"])
    out = capsys.readouterr().out
    assert f"restored checkpoint step 11 from {tmp_path}" in out
    prompt = serve.synthetic_tokens(np.random.default_rng(10), 2, 16, jcfg.vocab_size)
    ref = JG.generate(jparams, jnp.asarray(prompt, jnp.int32), jcfg, max_new_tokens=5)
    np.testing.assert_array_equal(results[0]["tokens"].numpy(), np.asarray(ref)[:, 16:])


def test_serve_build_restores_a_depth_cut_checkpoint(tmp_path, capsys):
    _, params = entry.build("tiny", 0, "cpu", layers=1)
    checkpoint.TrainCheckpointer(str(tmp_path)).save(2, params, train.make_optimizer(params))
    config, served = serve.build("tiny", 5, "cpu", layers=1, ckpt=str(tmp_path))
    assert config.n_layers == 1 and served["layers"]["wq"].shape[0] == 1
    assert "restored checkpoint step 2" in capsys.readouterr().out
    for a, b in zip(transformer.leaves(params), transformer.leaves(served), strict=True):
        assert b.dtype == config.dtype and not b.requires_grad
        assert torch.equal(a.detach().to(config.dtype), b)


# A served token's logit under JAX's bf16 forward on the same int8 tree vs
# that position's best. Greedy tokens are not compared with JAX's generate:
# XLA and torch round the bf16 intermediates in different places, and even
# JAX's own decode steps and its one-pass forward pick different tokens at
# near-ties (the port's tokens equal JAX generate's in 6 of 10 seeds of this
# config, on identical trees). The logits lie below 8, where a bf16 ulp is
# at most 2^-5: two ulps; a random token lies some 2.5 below the best.
BF16_LOGIT_GAP = 2.0**-4


def test_serve_int8_from_a_checkpoint_quantizes_the_f32_masters_as_jax(
        tmp_path, monkeypatch, capsys):
    # In a bf16 config the masters' bf16 rounding changes the int8 values:
    # the linears are restored in f32 and quantized from those, as the JAX
    # serve job quantizes the f32 tree it restores.
    monkeypatch.setitem(serve.MODELS, "tiny",
                        lambda: dataclasses.replace(transformer.tiny(), dtype=torch.bfloat16))
    jcfg = dataclasses.replace(JT.tiny(), dtype=jnp.bfloat16)
    masters = jax.tree.map(np.asarray, JT.init(jcfg, jax.random.PRNGKey(5)))
    params = convert.params_from_jax(masters, device="cpu")
    checkpoint.TrainCheckpointer(str(tmp_path)).save(3, params, train.make_optimizer(params))
    config, served = serve.build("tiny", 0, "cpu", int8=True, ckpt=str(tmp_path))
    assert config.dtype == torch.bfloat16
    jq = jax.tree.map(np.asarray, JQ.quantize_params(masters))
    for name in [f"layers/{k}" for k in TQ.LAYER_LINEAR_KEYS] + ["lm_head"]:
        got, want = served, jq
        for key in name.split("/"):
            got, want = got[key], want[key]
        for part in ("w", "scale"):
            assert got[part].dtype == (torch.int8 if part == "w" else torch.float32)
            np.testing.assert_array_equal(got[part].numpy(), want[part], err_msg=name)
    assert served["embed"].dtype == served["layers"]["ln1"].dtype == torch.bfloat16

    b, t, n = 2, 16, 5
    prompt = np.random.default_rng(6).integers(0, jcfg.vocab_size, (b, t))
    tokens = serve.run_request(served, torch.from_numpy(prompt), config, n)["tokens"]
    # The same machinery on JAX's int8 tree gives the same tokens, bit for bit.
    ref = TG.generate(convert.params_from_jax(jq, device="cpu"), torch.from_numpy(prompt),
                      config, n)
    np.testing.assert_array_equal(tokens.numpy(), ref[:, t:].numpy())
    # JAX's bf16 forward on its int8 tree, teacher-forced over the served
    # tokens: each one is JAX's best at its position, up to bf16 near-ties.
    seq = jnp.asarray(np.concatenate([prompt, tokens.numpy()[:, :-1]], axis=1), jnp.int32)
    logits, _ = JG._forward_cached(JQ.quantize_params(masters), seq,
                                   JG.init_cache(jcfg, b, t + n), jcfg)
    logits = np.asarray(logits)[:, t - 1:]
    picked = np.take_along_axis(logits, tokens.numpy()[..., None], -1)[..., 0]
    assert (logits.max(-1) - picked).max() <= BF16_LOGIT_GAP
