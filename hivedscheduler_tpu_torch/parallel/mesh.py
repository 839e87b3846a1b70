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

The env block is the JAX one (``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``); it is read as it is, so one
scheduler serves both packages.
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
    before anything asks CUDA about its devices. One process drives the
    pod's first granted card; one process per granted card is ROADMAP
    queue 1 item 13."""
    e = os.environ if env is None else env
    grant = e.get(GRANT_VAR)
    if grant is None:
        return
    if not _GRANT.fullmatch(grant.replace(" ", "")):
        raise ValueError(f"{GRANT_VAR}={grant!r} is not a comma list of card indices")
    e.setdefault("CUDA_VISIBLE_DEVICES", grant.replace(" ", ""))


def cuda_index(env: Mapping[str, str], rank: int, visible: int) -> int:
    """The card a process takes among the ``visible`` ones: the first when
    the scheduler granted the pod its cards (one process a pod), else the
    rank's modulo the count (processes sharing one node's cards)."""
    return 0 if GRANT_VAR in env else rank % visible


def initialize_from_env(
    env: Optional[Mapping[str, str]] = None, device: Device = None
) -> None:
    """Boot ``torch.distributed`` from the env block the scheduler injected
    at bind time: ``JAX_COORDINATOR_ADDRESS`` ("host:port") is the TCP
    rendezvous, ``JAX_NUM_PROCESSES`` the world size, ``JAX_PROCESS_ID``
    the rank. NCCL on CUDA, gloo on the CPU; on CUDA the process takes card
    ``cuda_index`` among the visible ones (``apply_chip_grant`` must have
    run first). A no-op for a world of at most one process, and when a
    default group already exists."""
    e = os.environ if env is None else env
    num = int(e.get("JAX_NUM_PROCESSES", "1"))
    if num <= 1 or dist.is_initialized():
        return
    dev = resolve_device(device)
    rank = int(e["JAX_PROCESS_ID"])
    if dev.type == "cuda":
        torch.cuda.set_device(cuda_index(e, rank, torch.cuda.device_count()))
    dist.init_process_group(
        backend="nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{e['JAX_COORDINATOR_ADDRESS']}",
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
