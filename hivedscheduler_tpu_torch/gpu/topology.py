"""GPU topology presets: cell-type chains for the scheduler's config.

Counterpart of ``hivedscheduler_tpu/tpu/topology.py``, over the config's
wire form (``cellTypes`` and ``physicalCells`` entries as camelCase dicts,
what ``api.config.Config.from_dict`` reads). HiveD encodes communication
domains as cell levels; on H100s they are

    card (1) -> 2 cards -> 4 cards -> node (8 cards on NVSwitch)
             -> a group of 4 nodes on one InfiniBand switch

where the sub-node levels are forged halves, so that a virtual cluster can
own 1, 2 or 4 cards of a node (:func:`h100_cell_types`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

CellTypes = Dict[str, Dict[str, Any]]


def chip_type(generation: str) -> str:
    return f"{generation}-chip"


def host_type(generation: str) -> str:
    return f"{generation}-host"


def slice_type(generation: str, num_chips: int) -> str:
    return f"{generation}-{num_chips}"


def _cell_type(child: str, number: int, node_level: bool) -> Dict[str, Any]:
    return {"childCellType": child, "childCellNumber": number, "isNodeLevel": node_level}


def make_cell_types(
    generation: str,
    chips_per_host: int = 8,
    slice_host_counts: Sequence[int] = (),
    forge_sub_host: bool = True,
) -> CellTypes:
    """The ``cellTypes`` map for one card generation: card -> forged
    halves -> node (``chips_per_host`` cards) -> multi-node groups of
    ``slice_host_counts`` nodes, each a multiple of the one before. A node
    whose card count is not a power of two is a flat node cell."""
    types: CellTypes = {}
    child = chip_type(generation)
    n = 1
    if forge_sub_host and chips_per_host & (chips_per_host - 1) != 0:
        forge_sub_host = False
    if forge_sub_host:
        while n * 2 < chips_per_host:
            n *= 2
            name = f"{generation}-{n}-chip"
            types[name] = _cell_type(child, 2, False)
            child = name
        types[host_type(generation)] = _cell_type(child, chips_per_host // max(n, 1), True)
    else:
        types[host_type(generation)] = _cell_type(child, chips_per_host, True)
    prev_type, prev_hosts = host_type(generation), 1
    for hosts in slice_host_counts:
        if hosts % prev_hosts != 0:
            raise ValueError(
                f"slice host counts must nest: {hosts} not a multiple of {prev_hosts}")
        name = slice_type(generation, hosts * chips_per_host)
        types[name] = _cell_type(prev_type, hosts // prev_hosts, False)
        prev_type, prev_hosts = name, hosts
    return types


def make_physical_cell(
    cell_type: str,
    node_names: Sequence[str],
    cell_types: CellTypes,
    pinned_cell_id: str = "",
) -> Dict[str, Any]:
    """A ``physicalCells`` entry: the node-level cells get ``node_names`` as
    their addresses, in order; the rest is left to the config's defaulting.
    The node count must match the one ``cell_types`` declares."""
    fan_outs: List[int] = []
    ct = cell_type
    while ct in cell_types and not cell_types[ct]["isNodeLevel"]:
        fan_outs.append(cell_types[ct]["childCellNumber"])
        ct = cell_types[ct]["childCellType"]
    expected = 1
    for f in fan_outs:
        expected *= f
    if expected != len(node_names):
        raise ValueError(
            f"{cell_type} contains {expected} hosts but {len(node_names)} node names were given")
    spec: Dict[str, Any] = {"cellType": cell_type,
                            "cellAddress": "" if fan_outs else node_names[0]}
    if pinned_cell_id:
        spec["pinnedCellId"] = pinned_cell_id
    if fan_outs:
        spec["cellChildren"] = _nest_hosts(list(node_names), fan_outs)
    return spec


def _nest_hosts(node_names: List[str], fan_outs: Sequence[int]) -> List[Dict[str, Any]]:
    fan = fan_outs[0]
    if len(fan_outs) == 1:
        return [{"cellType": "", "cellAddress": n} for n in node_names]
    group = len(node_names) // fan
    return [{"cellType": "", "cellAddress": "",
             "cellChildren": _nest_hosts(node_names[i * group:(i + 1) * group], fan_outs[1:])}
            for i in range(fan)]


def h100_cell_types() -> CellTypes:
    """H100 chains: card -> 2 -> 4 -> node (8 cards, NVSwitch) -> h100-32
    (4 nodes on one InfiniBand switch)."""
    return make_cell_types("h100", chips_per_host=8, slice_host_counts=(4,))
