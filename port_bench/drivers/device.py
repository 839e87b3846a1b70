"""Device helpers the drivers share: synchronising, the memory peak, and
freeing what a side held before the reference runs."""

from __future__ import annotations

import contextlib
import gc
from typing import Iterator

import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def release(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


class Fence:
    """Keeps the host at most one item ahead of the device: ``pass_()``
    after each item waits for the one before it (a recorded event), so a
    window's end waits for at most one item."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.pending = None

    def pass_(self) -> None:
        if not self.cuda:
            return
        event = torch.cuda.Event()
        event.record()
        if self.pending is not None:
            self.pending.synchronize()
        self.pending = event


@contextlib.contextmanager
def profiled(device: torch.device) -> Iterator[object]:
    """``torch.profiler`` over the CPU and the card around the block (the
    block's spans are the harness's ``bench.*``); yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        yield prof
