"""Multi-process initialisation, the slot gather and the process group.

PyTorch counterpart of ``bioem_tpu.parallel.distributed`` (the
reference's MPI bootstrap, main.cpp:64-68, and its final reduction to
rank 0, bioem.cpp:909-1044). :func:`initialize` joins the processes with
``torch.distributed``; every process builds the same inputs (the
analogue of the reference's configure-time MPI_Bcast), and a mesh engine
(parallel/mesh.py) computes only its own slots.

**Gloo, not NCCL.** The collectives run once per pass, on host tensors:
only the per-image state is merged (n_img × 8 fields), the per-angle
slabs are owned by one orientation shard each and only gathered, and
``results()`` copies the state to the host anyway. So a CPU group serves,
and gloo also works when several processes share one card, which NCCL
refuses (duplicate GPU). Every collective of this module runs on a gloo
group: the default group when :func:`initialize` made it, else a gloo
group made beside the caller's.

Typical multi-process script (``torchrun`` sets RANK/WORLD_SIZE/
MASTER_ADDR/MASTER_PORT/LOCAL_RANK):

    from bioem_tpu_torch.parallel.distributed import initialize
    initialize()                      # no-op in a single process
    eng = ShardedBioEMEngine(p, orients, model, images, cfg)
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

# A peer that hangs fails a collective after this many seconds instead of
# blocking for torch's default 30 minutes (initialize's timeout_s).
TIMEOUT_S = 300.0

_gloo = None


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def _gt1(env, var: str) -> bool:
    try:
        return int(env.get(var, "1")) > 1
    except ValueError:
        return False


def _cluster_env() -> Optional[tuple]:
    """(address, world size, rank) advertised by a launcher with more than
    one process: torchrun (RANK/WORLD_SIZE/MASTER_ADDR/MASTER_PORT), SLURM
    or Open MPI (their task counts and ranks, with MASTER_ADDR/
    MASTER_PORT for the rendezvous); else None."""
    env = os.environ
    if _gt1(env, "WORLD_SIZE") and "RANK" in env:
        n, r = int(env["WORLD_SIZE"]), int(env["RANK"])
    elif _gt1(env, "OMPI_COMM_WORLD_SIZE"):
        n, r = int(env["OMPI_COMM_WORLD_SIZE"]), int(env["OMPI_COMM_WORLD_RANK"])
    elif _gt1(env, "SLURM_NTASKS") or _gt1(env, "SLURM_NPROCS"):
        n = int(env.get("SLURM_NTASKS", env.get("SLURM_NPROCS")))
        r = int(env["SLURM_PROCID"])
    else:
        return None
    if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
        raise ValueError(
            f"a launcher advertises {n} processes but MASTER_ADDR/MASTER_PORT "
            "are not set: set them, or the BIOEM_TPU_COORDINATOR/_NUM_PROCESSES/"
            "_PROCESS_ID names"
        )
    return f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}", n, r


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    timeout_s: float = TIMEOUT_S,
) -> None:
    """Join a multi-process run (MPI_Init analogue); a no-op in a single
    process and when already joined.

    Resolution order, as the JAX package's:

    1. explicit arguments;
    2. ``BIOEM_TPU_COORDINATOR`` (``host:port``) /
       ``BIOEM_TPU_NUM_PROCESSES`` / ``BIOEM_TPU_PROCESS_ID``;
    3. a launcher with more than one process: torchrun's RANK/WORLD_SIZE
       with MASTER_ADDR/MASTER_PORT, SLURM, Open MPI;
    4. otherwise a single process: nothing is initialised.

    A partial configuration raises, and failures in 1–3 propagate: a
    misconfigured run must fail, not compute a fraction of the grid in one
    process and report it as the posterior. The group is gloo, joined over
    ``tcp://``; a collective that waits ``timeout_s`` seconds for a peer
    raises.
    """
    if is_initialized():
        return
    env = os.environ
    addr = coordinator_address or env.get("BIOEM_TPU_COORDINATOR")
    n_proc = num_processes
    if n_proc is None and "BIOEM_TPU_NUM_PROCESSES" in env:
        n_proc = int(env["BIOEM_TPU_NUM_PROCESSES"])
    pid = process_id
    if pid is None and "BIOEM_TPU_PROCESS_ID" in env:
        pid = int(env["BIOEM_TPU_PROCESS_ID"])
    if addr is not None or n_proc is not None or pid is not None:
        if addr is None or n_proc is None or pid is None:
            raise ValueError(
                "partial multi-process configuration: need all three of "
                "coordinator_address, num_processes, process_id (or the "
                "BIOEM_TPU_COORDINATOR/_NUM_PROCESSES/_PROCESS_ID env vars); "
                f"got addr={addr!r} n_proc={n_proc!r} pid={pid!r}"
            )
    else:
        found = _cluster_env()
        if found is None:
            return
        addr, n_proc, pid = found
    dist.init_process_group(
        backend="gloo", init_method=f"tcp://{addr}", world_size=int(n_proc),
        rank=int(pid), timeout=datetime.timedelta(seconds=timeout_s),
    )


def group():
    """The gloo group every collective here runs on (None = the default
    group, when it is gloo)."""
    global _gloo
    if dist.get_backend() == "gloo":
        return None
    if _gloo is None:
        _gloo = dist.new_group(backend="gloo")
    return _gloo


def all_gather_object(obj) -> list:
    """``obj`` of every process, in rank order (a single process: [obj])."""
    if not is_initialized():
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj, group=group())
    return out


def all_gather_rows(x: torch.Tensor) -> list:
    """Every process's CPU tensor of ``x``'s shape and dtype, in rank order,
    bit for bit (a single process: [x])."""
    if not is_initialized():
        return [x]
    out = [torch.empty_like(x) for _ in range(process_count())]
    dist.all_gather(out, x.contiguous(), group=group())
    return out


def shutdown() -> None:
    """Leave the group (the end of a worker)."""
    global _gloo
    if is_initialized():
        dist.destroy_process_group()
    _gloo = None
