"""One process per granted card: the env blocks of a pod, from its bind info.

Counterpart of ``hivedscheduler_tpu/tpu/env.py``. The JAX package runs one
process a pod, which drives every chip the pod was granted
(``pod_tpu_env``: ``JAX_NUM_PROCESSES`` counts pods). PyTorch drives one
card from one process, so :func:`pod_gpu_env` gives each card granted to
the pod its own block, in ``torch.distributed``'s terms: ``RANK``,
``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT`` and the
card as the process's only ``CUDA_VISIBLE_DEVICES``. The pod's launcher
(``workloads/launch.py``) starts one process per block.

Ranks follow the JAX worker order: pods sorted by (natural node name,
first card index), so pod ``w`` here is ``TPU_WORKER_ID`` ``w`` there, and
within a pod the cards in the order its placement lists them. Every pod of
a gang carries the whole gang's placements, so each derives the same ranks
with no coordination.

The bind info is read in its wire form, the ``pod-bind-info`` annotation's
JSON as a dict with camelCase keys (``node``, ``leafCellIsolation``,
``affinityGroupBindInfo[].podPlacements[].physicalNode`` and
``physicalLeafCellIndices``). Card indices are the node's own, as the
grant ``TPU_VISIBLE_CHIPS`` is (``parallel/mesh.apply_chip_grant``).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Tuple

# The port worker 0 serves the torch.distributed rendezvous on: torch's
# conventional default. Any free port works as long as the gang agrees.
MASTER_PORT = 29500

Placement = Tuple[str, Tuple[int, ...]]


def _natural_key(name: str) -> Tuple:
    """Sort key treating digit runs as numbers: w2 < w10."""
    return tuple(int(tok) if tok.isdigit() else tok for tok in re.split(r"(\d+)", name))


def _cards(indices: Any) -> Tuple[int, ...]:
    return tuple(int(i) for i in indices or ())


def _worker_order(bind_info: Mapping[str, Any]) -> List[Placement]:
    """Every pod placement of the gang as (node, card indices), sorted by
    (natural node name, first card index): ``pod_tpu_env``'s worker order."""
    placements = [
        (str(p.get("physicalNode", "") or ""), _cards(p.get("physicalLeafCellIndices")))
        for member in bind_info.get("affinityGroupBindInfo") or ()
        for p in member.get("podPlacements") or ()
    ]
    return sorted(placements, key=lambda p: (_natural_key(p[0]), p[1][0] if p[1] else -1))


def pod_gpu_env(
    bind_info: Mapping[str, Any], master_port: int = MASTER_PORT
) -> List[Dict[str, str]]:
    """One env block per card granted to the pod bound by ``bind_info``,
    in the order the pod's placement lists its cards.

    Keys of each block:
      - ``CUDA_VISIBLE_DEVICES``: the one card;
      - ``RANK``: the card's rank in the gang (pods in worker order, then
        their cards), 0 .. ``WORLD_SIZE`` - 1;
      - ``LOCAL_RANK``: the card's index among the pod's cards;
      - ``WORLD_SIZE``: all cards of the gang;
      - ``MASTER_ADDR`` / ``MASTER_PORT``: worker 0's node and
        ``master_port``.

    Raises ``ValueError`` when the pod's own placement is not in the
    gang's."""
    order = _worker_order(bind_info)
    me = (str(bind_info.get("node", "") or ""), _cards(bind_info.get("leafCellIsolation")))
    try:
        worker = order.index(me)
    except ValueError:
        raise ValueError(
            f"pod placement {me} not found in its own affinity group bind info; "
            f"cannot derive its ranks") from None
    first = sum(len(cards) for _, cards in order[:worker])
    world = sum(len(cards) for _, cards in order)
    return [
        {"CUDA_VISIBLE_DEVICES": str(card), "RANK": str(first + i), "LOCAL_RANK": str(i),
         "WORLD_SIZE": str(world), "MASTER_ADDR": order[0][0], "MASTER_PORT": str(master_port)}
        for i, card in enumerate(me[1])
    ]
