"""hivedscheduler_tpu_torch: the workload stack of hivedscheduler_tpu, in
PyTorch and CUDA for NVIDIA Hopper (H100).

Module names mirror the JAX package's (``ops/attention.py``,
``models/transformer.py``, ``models/generate.py``, ...), so each module's
counterpart is found by its path. The package imports ``torch`` and never
``jax`` or ``hivedscheduler_tpu``: what it needs of the JAX package it keeps
a copy of. Kernels the JAX package wrote in Pallas are written by hand for
``sm_90a`` under ``ops/csrc/`` and built on first use.

Ported so far: single-device Llama serving (flash prefill through the
hand-written flash-attention forward, KV-cache decode from a CUDA graph
captured once a shape, int8 linears;
``python -m hivedscheduler_tpu_torch.serve``), the single-device training
step (AdamW on f32 master weights, bf16 compute, remat, the hand-written
flash-attention backward; on one card every training step of every model
replays a CUDA graph captured once a batch shape, ``models/train.py``'s
``step_graphs``; ``python -m hivedscheduler_tpu_torch.train``),
and what a job placed by the scheduler needs around them: the boot from
the scheduler's env block and its card grant (``workloads/``,
``parallel/mesh.py``), token files with prefetch to the card
(``utils/data.py``), checkpoints (``models/checkpoint.py``) and the perf
harness (``python -m hivedscheduler_tpu_torch.models.perf``,
``tools/mfu_sweep.py``). Both jobs also run as multi-process gangs: the
sharded step and serving mesh (``parallel/sharding.py``: ZeRO-3 over dp x
fsdp, tensor parallelism over tp, placed by the JAX package's rule table),
checkpoints that move between layouts, and the gang dryrun
(``python -m hivedscheduler_tpu_torch.tools.dryrun 4``). A pod runs one
process per granted card (``gpu/env.py``, the pod launcher
``workloads/launch.py``; H100 cell types in ``gpu/topology.py``), and
long-context gangs shard the sequence (``parallel/ulysses.py`` onto the
flash kernels, ``parallel/ring.py``; the twin
``workloads/train_longctx.py``). Gangs also split the layer stack into
GPipe stages (``parallel/pipeline.py``, pp and pp x sp; the twin
``workloads/train_pp.py``), and BERT-large trains on one card or a dp x
fsdp x tp gang (``models/bert.py``, ``workloads/train_bert.py``). The
Mixtral MoE (``models/mixtral.py``: top-2 routing over the gang's tokens,
dispatch and combine by index) trains and serves on one card or a gang
with expert parallelism over ep (the twin ``workloads/train_mixtral.py``;
``python -m hivedscheduler_tpu_torch.serve --model mixtral_8x7b``, its
routed FFN in ``generate``'s ``ffn`` hook); on the CPU, ``--model tiny``
and ``--model mixtral_tiny`` with ``--device cpu`` run them at test size.
ResNet-50 (``models/resnet.py``: ``channels_last`` convs with XLA's SAME
padding, batch norm whose statistics are the global batch's on a dp x
fsdp gang) trains through the twin ``workloads/train_resnet.py``; the
perf harness's zoo stage (``models/perf.bench_zoo``, ``HIVED_PERF_ZOO=1``)
times BERT-large, ResNet-50 and the bench model's decode on one card, and
``workloads/train_mnist.py`` is the MNIST twin: every workload of
``example/workloads/`` has its twin.
"""

from __future__ import annotations

from typing import Union

import torch

__version__ = "0.1.0"

Device = Union[str, torch.device, None]


def resolve_device(device: Device = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. ``None`` means CUDA and raises when there is none, so a run
    never drifts onto the CPU; the CPU is taken only when asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} was asked for but CUDA is not available")
    return dev
