"""Checkpoint and resume for training jobs on ``torch.distributed.checkpoint``.

Counterpart of ``hivedscheduler_tpu/models/checkpoint.py`` (orbax there):
a preempted or rescheduled gang resumes from its last (params, optimizer,
step) instead of restarting. Each step is one directory, ``<dir>/<step>``,
written under a temporary name and renamed when complete, so a crash
mid-save never leaves a partial step behind; the oldest steps beyond
``max_to_keep`` are pruned. Under a process group every rank writes its own
part (DCP's collective save).

Tensors load in place into the tree they are given, in its dtypes and on
its devices: f32 training masters restored into a bf16 serving tree are
rounded once, and ``restore_params`` reads no byte of the optimizer state.
A tree of DTensors (a sharded job's, ``models/train.init_sharded``) loads
each rank's block, so a step written by one layout restores under another:
one process to a gang and back, bit for bit.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import warnings
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint.metadata import TensorStorageMetadata

_OPT = "optimizer"
_WRITE_THREADS = 4


@contextlib.contextmanager
def _single_process_quiet() -> Iterator[None]:
    """DCP warns on every call made without a process group; a one-process
    job is the expected case here."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        yield


def _is_main() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def _optimizer_state(optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """``optimizer.state_dict()`` with string keys (DCP names items by
    dotted paths); ``param_groups`` (hyperparameters, parameter indices)
    are saved as plain objects."""
    sd = optimizer.state_dict()
    return {"state": {str(i): s for i, s in sd["state"].items()},
            "param_groups": sd["param_groups"]}


class TrainCheckpointer:
    """Save and restore (params, optimizer, step). ``params`` is the port's
    parameter tree (nested dicts of tensors)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def steps(self) -> List[int]:
        """The complete steps on disk, oldest first."""
        return sorted(int(n) for n in os.listdir(self.directory) if n.isdigit())

    def save(self, step: int, params: Any, optimizer: torch.optim.Optimizer) -> None:
        """Write step ``step`` (synchronously: it is on disk on return)."""
        final, tmp = self._path(step), self._path(step) + ".tmp"
        if _is_main():
            shutil.rmtree(tmp, ignore_errors=True)
        _barrier()
        with _single_process_quiet():
            dcp.save(
                {"params": params, _OPT: _optimizer_state(optimizer)},
                storage_writer=dcp.FileSystemWriter(tmp, thread_count=_WRITE_THREADS),
            )
        _barrier()
        if _is_main():
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            for old in self.steps()[:-self.max_to_keep]:
                shutil.rmtree(self._path(old))
        _barrier()

    def wait(self) -> None:
        """Saves are synchronous; kept for the JAX package's interface."""

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _resolve(self, step: Optional[int]) -> Tuple[int, str]:
        step = self.latest_step() if step is None else step
        if step is None or not os.path.isdir(self._path(step)):
            raise FileNotFoundError(f"no checkpoint step {step} under {self.directory}")
        return step, self._path(step)

    def _load(self, state: Dict[str, Any], path: str) -> None:
        # no_grad: the load copies in place into leaves that need grad.
        with _single_process_quiet(), torch.no_grad():
            dcp.load(state, checkpoint_id=path)

    def restore(
        self,
        params_like: Any,
        optimizer: torch.optim.Optimizer,
        step: Optional[int] = None,
    ) -> Tuple[Any, torch.optim.Optimizer, int]:
        """Load step ``step`` (default: the latest) into ``params_like``
        (in place, in its dtypes) and ``optimizer`` (its state built anew
        from the checkpoint: each state tensor shaped and placed like its
        parameter, scalars such as AdamW's ``step`` read on the CPU, where
        torch keeps them, and moved to the parameter's card in f32 by
        ``load_state_dict`` for a capturable AdamW, whichever kind wrote
        the step). Returns (params, optimizer, step). A captured step's
        owner of ``optimizer`` is dropped by the load
        (``models/train.step_graphs``): the next step captures anew."""
        step, path = self._resolve(step)
        params = [p for g in optimizer.param_groups for p in g["params"]]
        metadata = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
        flat: Dict[str, Any] = {}
        for fqn, md in metadata.items():
            if not fqn.startswith(_OPT + "."):
                continue
            if isinstance(md, TensorStorageMetadata):
                parts = fqn.split(".")
                p = params[int(parts[2])] if parts[1] == "state" else None
                if p is not None and p.shape == md.size:
                    # A moment takes its parameter's device and, for a
                    # DTensor parameter, its placements: DCP then reads
                    # this rank's block, whatever layout wrote the step.
                    flat[fqn] = torch.empty_like(p, dtype=md.properties.dtype)
                else:
                    flat[fqn] = torch.empty(md.size, dtype=md.properties.dtype, device="cpu")
            else:
                flat[fqn] = None  # a plain object, replaced by the load
        loaded = {"params": params_like, **flat}
        self._load(loaded, path)
        state: Dict[int, Dict[str, Any]] = {}
        groups: Dict[int, Dict[str, Any]] = {}
        for fqn in flat:
            value = loaded[fqn]
            _, kind, index, name = fqn.split(".", 3)
            (state if kind == "state" else groups).setdefault(int(index), {})[name] = value
        optimizer.load_state_dict(
            {"state": state, "param_groups": [groups[i] for i in sorted(groups)]}
        )
        return params_like, optimizer, step

    def restore_params(self, params_like: Any, step: Optional[int] = None) -> Tuple[Any, int]:
        """Params-only restore (the serving path): loads into
        ``params_like`` in its dtypes, in place; the optimizer state (twice
        the parameters' bytes) is never read. Returns (params, step)."""
        step, path = self._resolve(step)
        self._load({"params": params_like}, path)
        return params_like, step

    def close(self) -> None:
        """Nothing stays open between calls; kept for the JAX package's
        interface."""
