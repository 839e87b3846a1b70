"""Input pipeline: token datasets, per-rank batch rows and a host-to-device
prefetch that overlaps the copy with the previous step.

Counterpart of ``hivedscheduler_tpu/utils/data.py``. ``TokenFileDataset``
is a copy of the JAX package's (memory-mapped token file, per-epoch
shuffle from the seed). ``sharded_batches`` yields this rank's block of
each global batch, as the JAX version materialises this process's box:
rows shard over ``("dp", "fsdp")``, the sample's columns over ``"sp"``.
``prefetch_to_device`` copies batches ahead on a side CUDA stream from
pinned memory.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from .. import Device, resolve_device

# The JAX package's sharding rules for a [batch, seq] token array
# (``parallel/sharding.py`` DEFAULT_RULES "batch" and "seq").
BATCH_AXES = ("dp", "fsdp")
SEQ_AXES = ("sp",)


class TokenFileDataset:
    """Fixed-length sample view over a flat token file (dtype uint16/32).

    ``path`` is a binary file of token ids; sample i is the half-open
    window [i*seq_len, (i+1)*seq_len + 1): the +1 is the shifted next-token
    target inside the same sample. A vocab past 65,535 ids needs
    ``dtype=np.uint32``.
    """

    def __init__(self, path: str, seq_len: int, dtype=np.uint16):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.seq_len = seq_len
        self.n_samples = (len(self.tokens) - 1) // seq_len
        if self.n_samples <= 0:
            raise ValueError(
                f"{path}: {len(self.tokens)} tokens < one sample of "
                f"{seq_len + 1}"
            )

    def sample_indices(
        self, batch_size: int, seed: int = 0, epochs: Optional[int] = None
    ) -> Iterator[np.ndarray]:
        """Yield per-batch sample-index arrays, shuffled per epoch.
        Deterministic in ``seed``: every rank of a gang derives the same
        order (the basis of ``sharded_batches``)."""
        if batch_size > self.n_samples:
            # Would otherwise yield nothing and, with epochs=None, spin
            # forever re-permuting.
            raise ValueError(
                f"batch_size={batch_size} > {self.n_samples} samples in "
                "the dataset"
            )
        rng = np.random.default_rng(seed)
        epoch = 0
        while epochs is None or epoch < epochs:
            order = rng.permutation(self.n_samples)
            for start in range(0, self.n_samples - batch_size + 1, batch_size):
                yield order[start:start + batch_size]
            epoch += 1

    def gather(self, idx: np.ndarray) -> np.ndarray:
        """Materialize the [len(idx), seq_len+1] int32 rows for ``idx``."""
        return np.stack(
            [
                self.tokens[i * self.seq_len:(i + 1) * self.seq_len + 1]
                for i in idx
            ]
        ).astype(np.int32)

    def batches(
        self, batch_size: int, seed: int = 0, epochs: Optional[int] = None
    ) -> Iterator[np.ndarray]:
        """Yield [batch, seq_len+1] int32 batches, shuffled per epoch."""
        for idx in self.sample_indices(batch_size, seed, epochs):
            yield self.gather(idx)


def _block(mesh: Any, axes: Tuple[str, ...], extent: int, what: str) -> Tuple[int, int]:
    """This rank's [lo, hi) of ``extent`` split evenly over the mesh
    ``axes`` (row-major in the order given; an axis the mesh lacks counts
    as size 1)."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    coord = dict(zip(mesh.mesh_dim_names, coord))
    n, i = 1, 0
    for a in axes:
        i = i * sizes.get(a, 1) + coord.get(a, 0)
        n *= sizes.get(a, 1)
    if extent % n:
        raise ValueError(f"{what} {extent} does not split evenly over {n} shards of {axes}")
    width = extent // n
    return i * width, (i + 1) * width


def sharded_batches(
    dataset: TokenFileDataset,
    global_batch: int,
    mesh: Any = None,
    seed: int = 0,
    epochs: Optional[int] = None,
) -> Iterator[np.ndarray]:
    """Yield this rank's block of each global [global_batch, seq_len+1]
    batch as int32 numpy: its rows (the batch splits over dp x fsdp) and
    its columns (the sample width splits over sp). Every rank draws the
    same order from the shared ``seed`` and reads only its own block from
    the file. ``mesh`` is a ``DeviceMesh`` (or anything with its
    ``mesh_dim_names``, ``shape`` and ``get_coordinate()``); with none, or
    a one-rank mesh, the whole batch comes back."""
    width = dataset.seq_len + 1
    if mesh is None:
        (r0, r1), (c0, c1) = (0, global_batch), (0, width)
    else:
        r0, r1 = _block(mesh, BATCH_AXES, global_batch, "global batch")
        c0, c1 = _block(mesh, SEQ_AXES, width, "sample width")
    for idx in dataset.sample_indices(global_batch, seed, epochs):
        # Slice the shared order first: only this rank's rows are read.
        yield np.ascontiguousarray(dataset.gather(idx[r0:r1])[:, c0:c1])


def prefetch_to_device(
    batches: Iterable[Any],
    device: Device = None,
    buffer_size: int = 2,
) -> Iterator[torch.Tensor]:
    """Yield each batch (an array or tensor) as a tensor on ``device``,
    up to ``buffer_size`` ahead: a background thread copies it there so
    the copy overlaps the previous step. On CUDA the thread pins the batch
    and copies it with ``non_blocking=True`` on a side stream; the consumer
    makes its current stream wait for the copy and marks the tensor as used
    on that stream, so the allocator cannot hand its memory back while the
    side stream's copy or the consumer's kernels still use it.

    A failing source raises in the consumer (never a clean end of data);
    a consumer that stops early releases the thread and drops the batches
    it buffered."""
    device = resolve_device(device)
    side = torch.cuda.Stream(device) if device.type == "cuda" else None
    q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
    END = object()
    stop = threading.Event()

    def put(batch) -> Tuple[torch.Tensor, Optional[torch.cuda.Event]]:
        t = torch.as_tensor(batch)
        if side is None:
            return t.to(device), None
        with torch.cuda.stream(side):
            out = t.pin_memory().to(device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(side)
        return out, ready

    def _enqueue(item) -> bool:
        # A bounded put that notices an abandoned consumer: a plain put
        # would leave the thread blocked for good, holding device batches.
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for batch in batches:
                if not _enqueue(put(batch)):
                    return
            _enqueue(END)
        except BaseException as e:  # noqa: BLE001
            # Handed to the consumer, which raises it.
            _enqueue(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is END:
                return
            if isinstance(item, BaseException):
                raise item
            out, ready = item
            if ready is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(ready)
                out.record_stream(current)
            yield out
    finally:
        # An early break (GeneratorExit) or an error: release the thread
        # and drop what it buffered.
        stop.set()
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break
