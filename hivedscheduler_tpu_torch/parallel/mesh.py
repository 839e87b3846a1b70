"""Device meshes and ``torch.distributed`` bootstrap from the scheduler's env.

Counterpart of ``hivedscheduler_tpu/parallel/mesh.py``: a HiveD-placed gang
boots its process group with :func:`initialize_from_env` from the env block
the scheduler writes at bind time, then lays computation out over a
:func:`make_mesh` mesh with the JAX package's axis names and order:

  - ``dp``:   pure data parallelism (batch), outermost.
  - ``pp``:   pipeline stages.
  - ``fsdp``: data parallelism with sharded params and optimizer state.
  - ``ep``:   expert parallelism for MoE models.
  - ``sp``:   sequence/context parallelism.
  - ``tp``:   tensor parallelism, innermost (nearest ranks).

Two env blocks boot a process. A per-card block (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``, ``LOCAL_RANK``), which the
pod's launcher (``workloads/launch.py``) gives each process it starts, one
per granted card (``gpu/env.pod_gpu_env``), comes first. Without one, the
scheduler's JAX block (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
``JAX_PROCESS_ID``) is read as it is, one process a pod, so one scheduler
serves both packages.
"""

from __future__ import annotations

import math
import os
import re
from dataclasses import dataclass
from typing import Mapping, MutableMapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .. import Device, resolve_device

MESH_AXES = ("dp", "pp", "fsdp", "ep", "sp", "tp")


def world_size() -> int:
    """Processes in the default group; 1 when there is none."""
    return dist.get_world_size() if dist.is_initialized() else 1


GRANT_VAR = "TPU_VISIBLE_CHIPS"
_GRANT = re.compile(r"\d+(,\d+)*")


def apply_chip_grant(env: Optional[MutableMapping[str, str]] = None) -> None:
    """Map the pod's granted cards into ``CUDA_VISIBLE_DEVICES``: the
    scheduler's grant ``TPU_VISIBLE_CHIPS`` (the pod's own chip indices, as
    HiveD's ``NVIDIA_VISIBLE_DEVICES`` is) becomes the set of cards CUDA
    shows, unless ``CUDA_VISIBLE_DEVICES`` is already set. A grant that is
    empty or not a comma list of integers raises. Touches no CUDA API: CUDA
    reads the variable once, when it first initialises, so call this
    before anything asks CUDA about its devices. A process that the pod's
    launcher started keeps the one card its per-card block names; a pod
    booted from the JAX block alone runs one process, on its first granted
    card (``cuda_index``)."""
    e = os.environ if env is None else env
    grant = e.get(GRANT_VAR)
    if grant is None:
        return
    if not _GRANT.fullmatch(grant.replace(" ", "")):
        raise ValueError(f"{GRANT_VAR}={grant!r} is not a comma list of card indices")
    e.setdefault("CUDA_VISIBLE_DEVICES", grant.replace(" ", ""))


def cuda_index(env: Mapping[str, str], rank: int, visible: int) -> int:
    """The card a process booted from the JAX block takes among the
    ``visible`` ones: the first when the scheduler granted the pod its
    cards (one process a pod), else the rank's modulo the count (processes
    sharing one node's cards)."""
    return 0 if GRANT_VAR in env else rank % visible


# The per-card block's keys (``gpu/env.pod_gpu_env``).
PER_CARD_VARS = ("RANK", "WORLD_SIZE")


def has_per_card_block(env: Mapping[str, str]) -> bool:
    """True when ``env`` holds a per-card block, which wins over the JAX
    block: the launcher's children also inherit the pod's JAX block, whose
    ``JAX_NUM_PROCESSES`` counts pods, not cards."""
    return all(k in env for k in PER_CARD_VARS)


def process_rank(env: Optional[Mapping[str, str]] = None) -> int:
    """This process's rank: the per-card block's ``RANK``, else the JAX
    block's ``JAX_PROCESS_ID``, else 0."""
    e = os.environ if env is None else env
    return int(e["RANK"] if has_per_card_block(e) else e.get("JAX_PROCESS_ID", "0"))


# NCCL's settings for a gang whose steps are captured. By default NCCL
# registers the user buffers of a collective made during a capture; on
# four H100s the pipeline twin at pp 2 x sp 2 (Llama-3-8B's widths, its
# all-to-alls and sends in each rank's graph) then stopped in a replay's
# launch, and with registration off it ran (PERF.md, section 6). Eager
# collectives never register, so off, a replay moves the data as the
# eager step does.
NCCL_ENV = {"NCCL_GRAPH_REGISTER": "0"}


def nccl_env() -> None:
    """Set :data:`NCCL_ENV` where the environment does not; call before
    the process's first NCCL communicator, whose creation reads it."""
    for key, value in NCCL_ENV.items():
        os.environ.setdefault(key, value)


def initialize_from_env(
    env: Optional[Mapping[str, str]] = None, device: Device = None
) -> None:
    """Boot ``torch.distributed`` from the environment. A per-card block
    comes first: ``MASTER_ADDR``:``MASTER_PORT`` is the TCP rendezvous,
    ``WORLD_SIZE`` the world size, ``RANK`` the rank, and the card the
    ``LOCAL_RANK``-th visible one (the only one, under the launcher).
    Otherwise the JAX block the scheduler injected at bind time:
    ``JAX_COORDINATOR_ADDRESS`` ("host:port"), ``JAX_NUM_PROCESSES`` and
    ``JAX_PROCESS_ID``, the card ``cuda_index`` among the visible ones
    (``apply_chip_grant`` must have run first). NCCL on CUDA, gloo on the
    CPU. A no-op for a world of at most one process, and when a default
    group already exists."""
    e = os.environ if env is None else env
    per_card = has_per_card_block(e)
    num = int(e["WORLD_SIZE"] if per_card else e.get("JAX_NUM_PROCESSES", "1"))
    if num <= 1 or dist.is_initialized():
        return
    dev = resolve_device(device)
    rank = process_rank(e)
    if dev.type == "cuda":
        nccl_env()
        visible = torch.cuda.device_count()
        card = int(e.get("LOCAL_RANK", "0")) % visible if per_card else cuda_index(e, rank, visible)
        torch.cuda.set_device(card)
    address = (f"{e['MASTER_ADDR']}:{e['MASTER_PORT']}" if per_card
               else e["JAX_COORDINATOR_ADDRESS"])
    dist.init_process_group(
        backend="nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{address}",
        world_size=num,
        rank=rank,
    )


@dataclass(frozen=True)
class MeshConfig:
    """Logical parallelism layout. Sizes must multiply to the process
    count; size-1 axes stay in the mesh so layouts share one set of axis
    names."""

    dp: int = 1
    pp: int = 1
    fsdp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    @property
    def axis_sizes(self) -> Tuple[int, ...]:
        return (self.dp, self.pp, self.fsdp, self.ep, self.sp, self.tp)

    def total(self) -> int:
        return math.prod(self.axis_sizes)


def make_mesh(config: MeshConfig, device: Device = None) -> DeviceMesh:
    """The named mesh over every process of the default group, one process
    per device, ranks laid out row-major over (dp, pp, fsdp, ep, sp, tp) as
    the JAX package lays out its devices: tp varies fastest.

    A one-process mesh is built without a process group (a plain
    ``init_device_mesh`` would start one from ``env://`` and need
    ``MASTER_ADDR``), through ``DeviceMesh``'s private ``_init_backend``
    and ``_rank`` arguments; ``tests/test_torch_mesh.py`` fails if torch
    changes them. Such a mesh carries shapes and coordinates only: the
    sharded model treats it as inactive (``sharding.is_active``)."""
    device_type = resolve_device(device).type
    n = world_size()
    if config.total() != n:
        raise ValueError(
            f"MeshConfig {config.axis_sizes} needs {config.total()} processes, got {n}"
        )
    if n == 1 and not dist.is_initialized():
        return DeviceMesh(
            device_type,
            torch.zeros(config.axis_sizes, dtype=torch.int),
            mesh_dim_names=MESH_AXES,
            _init_backend=False,
            _rank=0,
        )
    return init_device_mesh(device_type, config.axis_sizes, mesh_dim_names=MESH_AXES)


def single_device_mesh(device: Device = None) -> DeviceMesh:
    """A one-device mesh with the standard axes."""
    return make_mesh(MeshConfig(), device)


def infer_mesh_config(
    n_devices: int,
    tp: int = 1,
    sp: int = 1,
    ep: int = 1,
    pp: int = 1,
    fsdp: Optional[int] = None,
) -> MeshConfig:
    """Fill the leftover factor into fsdp (or dp when fsdp is pinned)."""
    inner = tp * sp * ep * pp
    if n_devices % inner != 0:
        raise ValueError(
            f"{n_devices} devices not divisible by tp*sp*ep*pp={inner}"
        )
    rest = n_devices // inner
    if fsdp is None:
        return MeshConfig(dp=1, pp=pp, fsdp=rest, ep=ep, sp=sp, tp=tp)
    if rest % fsdp != 0:
        raise ValueError(f"residual {rest} not divisible by fsdp={fsdp}")
    return MeshConfig(dp=rest // fsdp, pp=pp, fsdp=fsdp, ep=ep, sp=sp, tp=tp)
