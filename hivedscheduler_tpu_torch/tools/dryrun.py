"""Multi-process dryrun of the sharded training step: the port's twin of
``__graft_entry__.py``'s ``dryrun_multichip``.

    python -m hivedscheduler_tpu_torch.tools.dryrun 4 [--rows fsdp_tp,dp] [--device cpu] \\
        [--record DIR]

Spawns an n-process gang (NCCL on CUDA, one card a rank, unless
``--device cpu`` asks for gloo on the CPU; with no CUDA and no device it
raises before any process starts, as every entry point of the port does),
and each row of layouts takes one sharded train step of the ``tiny``
model from seed 0 on all-zero tokens, at least 4 rows of 256 rounded up
to a multiple of dp x fsdp (identical rows keep the mean loss comparable
across batch sizes), through the owner of the captured steps
(``models/train.make_train_step``), as the JAX dryrun jits its step: on
the card the row's one step is the warm-up, then the capture. Each row's
loss must lie within ``TOL`` of the one-process eager step on 4 rows; a
row that diverges raises. Rows:

- ``fsdp_sp_tp``: the JAX dryrun's main row, tp 2 and sp 2 where they
  fit, the rest fsdp; under sp_mode "auto" its attention over sp is ring
  attention on the CPU and Ulysses on the card;
- ``ulysses-sp``: the same mesh with sp_mode "ulysses" (only where sp > 1
  and ``ulysses.can_ulysses`` holds; tiny's 4/2 heads at tp 2 and sp 2
  take the branch that expands K/V to the query heads);
- ``fsdp_tp``: tp 2 when n is even, the rest fsdp (sp 1);
- ``fsdp``: fsdp n;
- ``dp``: dp 2, fsdp n / 2 (n even);
- ``pp``: pp 2, fsdp n / 4, tp 2 (n divisible by 4): the GPipe schedule,
  each stage one of tiny's two layers;
- ``pp-x-sp``: pp 2, sp 2, fsdp n / 4 (n divisible by 4): the pipeline
  with the sequence sharded inside each stage;
- ``ep-moe``: fsdp n / 2 x ep 2 (n even): one step of the Mixtral ``tiny``
  model (f32, AdamW with ``optax.adamw(1e-3)``'s settings) on all-zero
  tokens of 64 through its owner (``workloads/train_mixtral.captured_step``),
  held to the one-process Mixtral step on the same rows, not to the dense
  one. Its head_dim of 16 and length of 64 are below the
  kernels', so it launches none on the card.

Each rank reports its kernel launches per row; :func:`expected_launches`
is what each kernel must show on the card.

``--record DIR`` makes a hang leave a record in DIR. NCCL's flight
recorder keeps each rank's collectives (``TORCH_NCCL_TRACE_BUFFER_SIZE``);
the process group times out after ``RECORD_AFTER`` s and NCCL's watchdog
then dumps the recorder into ``nccl_trace_rank_<r>`` (communicator,
sequence number, state of each collective). ``faulthandler`` writes every
Python thread's stack (autograd's device thread runs the backward) into
``rank<r>.stacks`` after ``RECORD_AFTER`` s, which shows a rank stopped
outside any collective too (as in ``destroy_process_group``).
"""

from __future__ import annotations

import argparse
import datetime
import faulthandler
import json
import os
import subprocess
import sys
import types
from typing import Dict, List, Optional, Sequence

TOL = 5e-3
SEQ = 256
MOE_SEQ = 64
ROWS = ("fsdp_sp_tp", "ulysses-sp", "fsdp_tp", "fsdp", "dp", "pp", "pp-x-sp", "ep-moe")
# Rows of the JAX dryrun still to port -> their ROADMAP queue 1 item.
LATER_ROWS: Dict[str, int] = {}
# The rows that force a sequence-parallel backend.
SP_MODE = {"ulysses-sp": "ulysses"}
# Seconds before a recording rank (--record) dumps its stacks and its
# process group times out; the parent waits this long and a minute more.
RECORD_AFTER = 240


def layouts(n: int, rows: Sequence[str] = ROWS) -> Dict[str, Dict[str, int]]:
    """Each asked-for row's mesh sizes for an n-process gang; rows that do
    not fit n are left out."""
    from ..models import transformer
    from ..parallel.mesh import MESH_AXES
    from ..parallel.ulysses import can_ulysses

    for row in rows:
        if row in LATER_ROWS:
            raise NotImplementedError(
                f"dryrun row {row!r} needs ROADMAP queue 1 item {LATER_ROWS[row]}")
        if row not in ROWS:
            raise ValueError(f"unknown dryrun row {row!r}; one of {ROWS}")
    tp = 2 if n % 2 == 0 else 1
    sp = 2 if n % (tp * 2) == 0 else 1
    main = dict(fsdp=n // (tp * sp), sp=sp, tp=tp)
    table = {"fsdp_sp_tp": main, "fsdp_tp": dict(fsdp=n // tp, tp=tp), "fsdp": dict(fsdp=n)}
    config = transformer.tiny()
    sizes = types.SimpleNamespace(mesh_dim_names=MESH_AXES,  # all that can_ulysses reads
                                  shape=tuple(main.get(a, 1) for a in MESH_AXES))
    if sp > 1 and can_ulysses(sizes, config.n_heads, config.n_kv_heads, SEQ):
        table["ulysses-sp"] = main
    if n % 2 == 0:
        table["dp"] = dict(dp=2, fsdp=n // 2)
        table["ep-moe"] = dict(fsdp=n // 2, ep=2)
    if n % 4 == 0:
        table["pp"] = dict(pp=2, fsdp=n // 4, tp=2)
        table["pp-x-sp"] = dict(pp=2, sp=2, fsdp=n // 4)
    return {r: table[r] for r in rows if r in table}


def _rows(sizes: Dict[str, int]) -> int:
    """The global batch's rows on a layout: at least 4, a multiple of dp x fsdp."""
    dpf = sizes.get("dp", 1) * sizes.get("fsdp", 1)
    return -(-4 // dpf) * dpf


def expected_launches(sizes: Dict[str, int], row: str = "") -> int:
    """Each kernel's launches on every rank in one step of a row on the
    card: once a layer (tiny runs without remat), on a pipeline stage once
    a layer of the stage a microbatch, and none in ``ep-moe`` (Mixtral
    tiny's heads of 16 are below the kernels' head dims)."""
    from ..models import transformer
    from ..parallel import pipeline

    if row == "ep-moe":
        return 0
    layers, pp = transformer.tiny().n_layers, sizes.get("pp", 1)
    if pp == 1:
        return layers
    local_rows = _rows(sizes) // (sizes.get("dp", 1) * sizes.get("fsdp", 1))
    return layers // pp * pipeline.microbatches(local_rows, pp)


def _tokens(rows: int, seq: int = SEQ):
    import torch

    return torch.zeros((rows, seq), dtype=torch.long)


def _params(device: str, mesh=None, sp_mode: str = "auto"):
    import dataclasses

    import torch

    from ..models import train, transformer

    config = dataclasses.replace(transformer.tiny(), sp_mode=sp_mode)
    gen = torch.Generator(device=device).manual_seed(0)
    if mesh is None:
        params = transformer.init(config, gen, device, torch.float32)
        return config, params, train.make_optimizer(params)
    params, optimizer = train.init_sharded(config, mesh, gen, device)
    return config, params, optimizer


def _moe_step(device: str, rows: int, mesh=None) -> float:
    """One ``ep-moe`` step (Mixtral tiny, seed 0, zero tokens of
    ``MOE_SEQ``): on ``mesh`` through its owner, on one process the eager
    step; returns its loss."""
    import torch

    from ..models import mixtral, train
    from ..parallel import sharding
    from ..workloads import train_bert, train_mixtral

    config = mixtral.tiny()
    gen = torch.Generator(device=device).manual_seed(0)
    params = train.init_sharded(config, mesh, gen, device, model=mixtral)[0]
    optimizer = train_bert.make_optimizer(params, 1e-3)
    tokens = _tokens(rows, MOE_SEQ)
    step = train_mixtral.train_step
    if sharding.is_active(mesh):
        tokens = sharding.shard_batch(tokens, mesh)
        step = train_mixtral.captured_step
    return float(step(params, optimizer, tokens.to(device), config, mesh))


def _dense_step(device: str, row: str, sizes: Dict[str, int], mesh) -> float:
    """One step of a dense row through the owner (``make_train_step``) on
    ``mesh``; returns its loss. The row's weights, optimizer and (on the
    card) captured graph live in this call only, as ``_moe_step``'s do:
    with the last row's graph, its NCCL calls inside, still alive, every
    rank of a four-H100 gang stopped in ``destroy_process_group``."""
    from ..models import train
    from ..parallel import sharding

    config, params, optimizer = _params(device, mesh, SP_MODE.get(row, "auto"))
    tokens = sharding.shard_batch(_tokens(_rows(sizes)), mesh)
    return float(train.make_train_step(config, mesh, optimizer)(params, tokens.to(device)))


def reference_loss(device: Optional[str] = None, row: str = "", rows: int = 4) -> float:
    """The one-process step's loss on zero rows: the dense model's on 4,
    or for ``ep-moe`` Mixtral's on ``rows`` (routing capacity counts the
    batch's tokens, so the row is held at its own batch). On CUDA unless
    ``device`` names the CPU (the eager step, the plain version of the
    gang's)."""
    from .. import resolve_device
    from ..models import train

    device = resolve_device(device).type

    if row == "ep-moe":
        return _moe_step(device, rows)
    config, params, optimizer = _params(device)
    return float(train.train_step(params, optimizer, _tokens(4), config, device))


def _worker(rank: int, world: int, port: int, device: str, rows: Sequence[str],
            record: Optional[str] = None) -> None:
    import torch
    import torch.distributed as dist

    from ..models import train
    from ..ops.attention import kernel_launches
    from ..parallel import mesh as pmesh

    if device == "cuda":
        torch.cuda.set_device(rank)
        pmesh.nccl_env()
    else:  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    # The parent holds the rendezvous store; every rank is its client.
    store = dist.TCPStore("127.0.0.1", port, is_master=False,
                          timeout=datetime.timedelta(seconds=300))
    timeout = {}
    if record:
        stacks = open(os.path.join(record, f"rank{rank}.stacks"), "w")
        faulthandler.dump_traceback_later(RECORD_AFTER, file=stacks)
        timeout["timeout"] = datetime.timedelta(seconds=RECORD_AFTER)
    dist.init_process_group("nccl" if device == "cuda" else "gloo", store=store,
                            world_size=world, rank=rank, **timeout)
    losses, launches, captures = {}, {}, {}
    try:
        for row, sizes in layouts(world, rows).items():
            mesh = pmesh.make_mesh(pmesh.MeshConfig(**sizes), device)
            before, captured = kernel_launches(), train.StepGraphs.captures
            losses[row] = (_moe_step(device, _rows(sizes), mesh) if row == "ep-moe"
                           else _dense_step(device, row, sizes, mesh))
            launches[row] = {k: v - before[k] for k, v in kernel_launches().items()}
            captures[row] = train.StepGraphs.captures - captured
    finally:
        dist.destroy_process_group()
    if record:
        faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"rank": rank, "losses": losses, "launches": launches,
                      "captures": captures}), flush=True)


def dryrun(n: int, rows: Sequence[str] = ROWS, device: Optional[str] = None,
           timeout: float = 600, record: Optional[str] = None) -> Dict[str, object]:
    """Run the rows on an n-process gang (on CUDA unless ``device`` names
    the CPU; with no CUDA and no device it raises before starting any
    process) and hold each rank's loss to the one-process step's; returns
    {"reference": the dense one-process loss,
    "references": {row: the loss it is held to}, "rows": {row: loss},
    "launches": {row: each rank's kernel launches} (CUDA launches only),
    "captures": {row: each rank's captured graphs} (one on the card, none
    on the CPU), "expected": {row: each kernel's launches per rank on the
    card}}.
    Every process it starts is ended before it returns. The rendezvous
    store lives in this process, on a port the OS gives it: no rank races
    another program for a port picked beforehand. ``record``: the
    directory of a hang's record (see the module docstring)."""
    import torch.distributed as dist

    from .. import resolve_device

    device = resolve_device(device).type
    wanted = layouts(n, rows)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    argv = []
    if record:
        record = os.path.abspath(record)
        os.makedirs(record, exist_ok=True)
        trace = os.path.join(record, "nccl_trace_rank_")  # the watchdog appends the rank
        env.update(TORCH_NCCL_TRACE_BUFFER_SIZE="4096", TORCH_NCCL_DUMP_ON_TIMEOUT="1",
                   TORCH_NCCL_DEBUG_INFO_TEMP_FILE=trace)
        argv, timeout = ["--record", record], RECORD_AFTER + 60
    store = dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False)
    port = store.port
    procs = [subprocess.Popen(
        [sys.executable, "-m", "hivedscheduler_tpu_torch.tools.dryrun", str(n),
         "--worker", str(r), str(port), "--device", device, "--rows", ",".join(wanted), *argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=root, env=env)
        for r in range(n)]
    outs: List[dict] = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise RuntimeError(f"dryrun rank exited {p.returncode}: {err[-2000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ref = reference_loss(device)
    refs = {row: reference_loss(device, row, _rows(sizes)) if row == "ep-moe" else ref
            for row, sizes in wanted.items()}
    bad = [f"{row} rank {o['rank']}: loss={o['losses'][row]:.6f} vs {refs[row]:.6f}"
           for o in outs for row in wanted if abs(o["losses"][row] - refs[row]) > TOL]
    if bad:
        raise RuntimeError(f"dryrun: sharded loss diverged from the one-process step "
                           f"(tol {TOL}): " + "; ".join(bad))
    losses = {row: outs[0]["losses"][row] for row in wanted}
    print(f"dryrun: {n} processes on {device}, one-process loss={ref:.4f}, all rows within "
          f"{TOL}: " + ", ".join(f"{row} {wanted[row]} loss={v:.4f}" for row, v in losses.items()),
          flush=True)
    return {"reference": ref, "references": refs, "rows": losses,
            "launches": {row: [o["launches"][row] for o in outs] for row in wanted},
            "captures": {row: [o["captures"][row] for o in outs] for row in wanted},
            "expected": {row: expected_launches(sizes, row) for row, sizes in wanted.items()}}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("n", type=int, help="processes in the gang")
    parser.add_argument("--rows", default=",".join(ROWS),
                        help=f"comma list of {ROWS}")
    parser.add_argument("--device", default=None, choices=("cpu", "cuda"),
                        help="default cuda; 'cpu' runs the gang on gloo")
    parser.add_argument("--record", metavar="DIR",
                        help="leave a hang's record in DIR: NCCL's flight recorder dump and "
                             "each rank's Python stacks")
    parser.add_argument("--worker", nargs=2, type=int, metavar=("RANK", "PORT"),
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    rows = [r for r in args.rows.split(",") if r]
    if args.worker:
        rank, port = args.worker
        _worker(rank, args.n, port, args.device, rows, args.record)
        return {}
    return dryrun(args.n, rows, args.device, record=args.record)


if __name__ == "__main__":
    main()
