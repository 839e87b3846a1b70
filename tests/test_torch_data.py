"""The port's input pipeline (hivedscheduler_tpu_torch.utils.data) against
the JAX package's: the same file and seed give the same sample order and
rows, and each rank's ``sharded_batches`` block is exactly the region of the
JAX global array that the JAX sharding gives that rank's device."""

import time

import jax
import numpy as np
import pytest
import torch

from hivedscheduler_tpu.parallel import mesh as JM
from hivedscheduler_tpu.parallel import sharding as JS
from hivedscheduler_tpu.utils import data as JD
from hivedscheduler_tpu_torch.parallel import mesh as TM
from hivedscheduler_tpu_torch.utils import data as TD


@pytest.fixture
def token_file(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 1000, size=4096, dtype=np.uint16).tofile(path)
    return str(path)


class RankMesh:
    """What ``sharded_batches`` reads of a ``DeviceMesh``, for one rank of a
    mesh that has no process group behind it."""

    def __init__(self, config, rank):
        self.mesh_dim_names = TM.MESH_AXES
        self.shape = config.axis_sizes
        self._coord = list(np.unravel_index(rank, config.axis_sizes))

    def get_coordinate(self):
        return self._coord


def test_dataset_order_and_rows_match_jax(token_file):
    ref = JD.TokenFileDataset(token_file, seq_len=31)
    got = TD.TokenFileDataset(token_file, seq_len=31)
    assert got.n_samples == ref.n_samples == (4096 - 1) // 31
    for a, b in zip(ref.sample_indices(8, seed=3, epochs=2),
                    got.sample_indices(8, seed=3, epochs=2), strict=True):
        np.testing.assert_array_equal(a, b)
    ref_rows, got_rows = list(ref.batches(8, seed=3, epochs=2)), list(got.batches(8, seed=3, epochs=2))
    assert len(got_rows) == len(ref_rows) == 2 * (ref.n_samples // 8)
    for a, b in zip(ref_rows, got_rows):
        assert b.dtype == a.dtype == np.int32 and b.shape == (8, 32)
        np.testing.assert_array_equal(a, b)


def test_dataset_errors_match_jax(tmp_path):
    short = tmp_path / "short.bin"
    np.arange(10, dtype=np.uint16).tofile(short)
    for mod in (JD, TD):
        with pytest.raises(ValueError, match="< one sample of 17"):
            mod.TokenFileDataset(str(short), seq_len=16)
        ds = mod.TokenFileDataset(str(short), seq_len=4)
        with pytest.raises(ValueError, match="batch_size=3 > 2 samples"):
            next(ds.sample_indices(3))


def test_uint32_ids_above_uint16_read_back_exact(tmp_path):
    path = tmp_path / "llama3.bin"
    ids = np.random.default_rng(1).integers(0, 128256, size=8 * 64 + 1, dtype=np.uint32)
    assert ids.max() > 65535
    ids.tofile(path)
    ds = TD.TokenFileDataset(str(path), seq_len=64, dtype=np.uint32)
    rows = ds.gather(np.arange(ds.n_samples))
    for i, row in enumerate(rows):
        np.testing.assert_array_equal(row, ids[i * 64:(i + 1) * 64 + 1].astype(np.int32))


@pytest.mark.parametrize("sizes", [
    dict(fsdp=8), dict(fsdp=4, sp=2), dict(dp=2, fsdp=2, sp=2), dict(dp=2, fsdp=4),
])
def test_rank_blocks_are_the_jax_global_arrays_regions(token_file, sizes):
    config = JM.MeshConfig(**sizes)
    seq_len = 15  # sample width 16 splits over sp = 2
    jmesh = JM.make_mesh(config, devices=jax.devices())
    ref = [np.asarray(b) for b in JD.sharded_batches(
        JD.TokenFileDataset(token_file, seq_len), 8, jmesh, seed=5, epochs=1)]
    region = JS.NamedSharding(jmesh, JS.spec_for(("batch", "seq"))).devices_indices_map(
        (8, seq_len + 1))
    ds = TD.TokenFileDataset(token_file, seq_len)
    assert len(ref) > 0
    for rank, device in enumerate(jax.devices()):
        mesh = RankMesh(TM.MeshConfig(**sizes), rank)
        blocks = list(TD.sharded_batches(ds, 8, mesh, seed=5, epochs=1))
        assert len(blocks) == len(ref)
        for block, whole in zip(blocks, ref):
            np.testing.assert_array_equal(block, whole[region[device]])


def test_sharded_batches_without_a_mesh_is_the_whole_batch(token_file):
    ds = TD.TokenFileDataset(token_file, seq_len=32)
    plain = list(ds.batches(4, seed=2, epochs=1))
    for mesh in (None, TM.single_device_mesh("cpu")):
        got = list(TD.sharded_batches(ds, 4, mesh, seed=2, epochs=1))
        assert len(got) == len(plain)
        for a, b in zip(plain, got):
            np.testing.assert_array_equal(a, b)


def test_sharded_batches_rejects_an_uneven_split(token_file):
    ds = TD.TokenFileDataset(token_file, seq_len=32)  # width 33
    with pytest.raises(ValueError, match="global batch 6"):
        next(TD.sharded_batches(ds, 6, RankMesh(TM.MeshConfig(fsdp=4), 0)))
    with pytest.raises(ValueError, match="sample width 33"):
        next(TD.sharded_batches(ds, 8, RankMesh(TM.MeshConfig(fsdp=4, sp=2), 0)))


def test_prefetch_yields_every_batch_on_the_device():
    batches = [np.full((2, 3), i, dtype=np.int32) for i in range(5)]
    got = list(TD.prefetch_to_device(iter(batches), "cpu"))
    assert len(got) == 5
    for i, t in enumerate(got):
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        assert torch.equal(t, torch.full((2, 3), i, dtype=torch.int32))


def test_prefetch_propagates_source_errors():
    def broken():
        yield np.zeros((8, 4), dtype=np.int32)
        raise OSError("storage went away")

    it = TD.prefetch_to_device(broken(), "cpu")
    next(it)
    with pytest.raises(OSError, match="storage went away"):
        for _ in it:
            pass


def test_prefetch_releases_the_thread_on_early_break():
    produced = []

    def source():
        for i in range(100):
            produced.append(i)
            yield np.zeros((8, 4), dtype=np.int32)

    it = TD.prefetch_to_device(source(), "cpu", buffer_size=2)
    next(it)
    it.close()  # the consumer stops early
    time.sleep(1.0)
    # With buffer_size=2 the thread is at most a few batches ahead; it
    # must not drain the source.
    assert len(produced) < 10, len(produced)


def test_prefetch_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        next(TD.prefetch_to_device(iter([np.zeros(2)])))
