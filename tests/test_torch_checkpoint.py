"""The port's checkpointer (hivedscheduler_tpu_torch.models.checkpoint, on
``torch.distributed.checkpoint``): bitwise round trips and resume, step
bookkeeping, and a params-only restore that reads no optimizer state."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed.checkpoint as dcp

from hivedscheduler_tpu_torch.models import checkpoint, train, transformer

CONFIG = dataclasses.replace(transformer.tiny(), n_layers=1)


def model(seed):
    params = transformer.init(CONFIG, torch.Generator().manual_seed(seed), "cpu",
                              dtype=torch.float32)
    return params, train.make_optimizer(params)


def batch(seed, b=2, s=32):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, CONFIG.vocab_size, (b, s)))


def steps(params, optimizer, n, seed=0):
    return [train.train_step(params, optimizer, batch(seed + i), CONFIG, "cpu") for i in range(n)]


def assert_trees_equal(a, b):
    for x, y in zip(transformer.leaves(a), transformer.leaves(b), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


def assert_optimizers_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sorted(sa["state"]) == sorted(sb["state"])
    for i, state in sa["state"].items():
        assert sorted(state) == sorted(sb["state"][i])
        for k, t in state.items():
            u = sb["state"][i][k]
            assert t.dtype == u.dtype and t.device == u.device and torch.equal(t, u), (i, k)


def test_round_trip_is_bitwise(tmp_path):
    params, opt = model(0)
    steps(params, opt, 2)
    ckpt = checkpoint.TrainCheckpointer(str(tmp_path / "new" / "dir"))  # created if missing
    ckpt.save(2, params, opt)
    ckpt.wait()
    fresh, fresh_opt = model(1)
    got, got_opt, step = ckpt.restore(fresh, fresh_opt)
    assert step == 2 and got is fresh and got_opt is fresh_opt
    assert_trees_equal(params, fresh)
    assert_optimizers_equal(opt, fresh_opt)
    assert all(t.requires_grad for t in transformer.leaves(fresh))
    ckpt.close()


def test_latest_step_and_pruning(tmp_path):
    params, opt = model(0)
    ckpt = checkpoint.TrainCheckpointer(str(tmp_path), max_to_keep=2)
    assert ckpt.latest_step() is None
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        ckpt.restore_params(model(1)[0])
    saved = {}
    for step in (1, 2, 3, 4, 5):
        steps(params, opt, 1, seed=step)
        ckpt.save(step, params, opt)
        saved[step] = [t.detach().clone() for t in transformer.leaves(params)]
    assert ckpt.steps() == [4, 5] and ckpt.latest_step() == 5
    assert sorted(p.name for p in tmp_path.iterdir()) == ["4", "5"]  # no temporary left
    for step in (4, 5):
        restored, got = ckpt.restore_params(model(9)[0], step=step)
        assert got == step
        for a, b in zip(saved[step], transformer.leaves(restored)):
            assert torch.equal(a, b)
    with pytest.raises(FileNotFoundError):
        ckpt.restore_params(model(9)[0], step=3)
    # A new checkpointer on the same directory sees the same steps.
    assert checkpoint.TrainCheckpointer(str(tmp_path), max_to_keep=2).latest_step() == 5


def test_restore_params_reads_no_optimizer_state_and_rounds_once(tmp_path, monkeypatch):
    params, opt = model(0)
    steps(params, opt, 2)
    ckpt = checkpoint.TrainCheckpointer(str(tmp_path))
    ckpt.save(7, params, opt)

    read = []
    real = dcp.FileSystemReader.read_data

    def spy(self, plan, planner):
        read.extend(item.storage_index.fqn for item in plan.items)
        return real(self, plan, planner)

    monkeypatch.setattr(dcp.FileSystemReader, "read_data", spy)
    like = transformer.cast(model(3)[0], torch.bfloat16)
    served, step = ckpt.restore_params(like)
    assert step == 7 and served is like
    assert read and all(fqn.startswith("params.") for fqn in read)
    for master, got in zip(transformer.leaves(params), transformer.leaves(served)):
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, master.detach().to(torch.bfloat16))  # one rounding
    # The full restore reads the optimizer state too.
    read.clear()
    ckpt.restore(*model(4))
    assert any(fqn.startswith("optimizer.state.") for fqn in read)


def test_resume_is_bitwise():
    # 4 AdamW steps straight equal 2 steps, save, restore into fresh
    # parameters and a fresh optimizer, then 2 steps.
    straight, straight_opt = model(0)
    straight_losses = steps(straight, straight_opt, 4)

    params, opt = model(0)
    losses = steps(params, opt, 2)
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        ckpt = checkpoint.TrainCheckpointer(d)
        ckpt.save(2, params, opt)
        fresh, fresh_opt = model(5)
        ckpt.restore(fresh, fresh_opt)
    losses += steps(fresh, fresh_opt, 2, seed=2)
    for a, b in zip(straight_losses, losses):
        assert torch.equal(a, b)
    assert_trees_equal(straight, fresh)
    assert_optimizers_equal(straight_opt, fresh_opt)
