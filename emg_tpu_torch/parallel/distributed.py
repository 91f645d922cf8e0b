"""The multi-process runtime: one process per mesh device.

Counterpart of ``emg_tpu/parallel/distributed.py``. JAX runs one
controller per host over all of its devices; here every device of the
(data, model) mesh is a process, a rank of ``torch.distributed``, with
its own card (NCCL) or on the CPU (gloo). A rank joins its process group
in one of three ways:

- ``parallel.coordinator_address`` (``initialize_distributed``): every
  process is started apart, on one host or many, with the address of rank
  0's rendezvous (host:port), the world size (``num_processes``) and its
  rank (``process_id``); -1 reads them from the environment ``torchrun``
  sets (``WORLD_SIZE``, ``RANK``);
- ``torchrun`` alone: its environment (``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR``, ``MASTER_PORT``) is the rendezvous;
- ``launch``: with neither, the CLI starts the mesh's ranks itself on one
  host, one worker process per device from ``torch.multiprocessing``, with
  a rendezvous on 127.0.0.1, so the JAX package's command line works
  unchanged.

The backend follows the device: NCCL for CUDA ranks, gloo for CPU ranks.
Two ranks may share one card only through ``launch(..., share_card=True)``
(for checking a mesh on a one-card machine); they then run gloo, as NCCL
refuses two ranks on one card.

JAX's ``make_global_batch`` has no counterpart: every rank builds the same
host batch and keeps its block (``mesh.shard_batch``), which is what
``jax.make_array_from_process_local_data`` assembles.
"""

from __future__ import annotations

import logging
import os
import random
import socket
from typing import Callable

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

# the card (or CPU) ``launch`` gave this process's rank
_RANK = {"device": None}


def backend_for(device, shared: bool = False) -> str:
    return "nccl" if torch.device(device).type == "cuda" and not shared else "gloo"


def initialize_distributed(pcfg, device="cuda") -> bool:
    """Join the process group of ``--parallel.coordinator_address`` (e.g.
    "10.0.0.1:8476"): ``init_process_group`` with ``tcp://`` that address,
    ``num_processes`` as the world size and ``process_id`` as the rank (-1:
    ``WORLD_SIZE`` / ``RANK`` from the environment). An empty address does
    nothing and returns False; True once joined. Call it before anything
    touches the device."""
    addr = getattr(pcfg, "coordinator_address", "")
    if not addr:
        return False

    def from_env(value: int, var: str) -> int:
        if value != -1:
            return int(value)
        if var not in os.environ:
            raise ValueError(f"parallel.coordinator_address needs {var} in the environment "
                             f"or its parallel flag")
        return int(os.environ[var])

    world = from_env(getattr(pcfg, "num_processes", -1), "WORLD_SIZE")
    rank = from_env(getattr(pcfg, "process_id", -1), "RANK")
    dist.init_process_group(backend=backend_for(device), init_method=f"tcp://{addr}",
                            world_size=world, rank=rank)
    log.info("distributed runtime up: rank %d of %d", rank, world)
    return True


def _started_by_torchrun() -> bool:
    return all(v in os.environ for v in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"))


def join_runtime(pcfg, device="cuda") -> bool:
    """Join a process group if this process is one of its ranks: already
    joined, through ``coordinator_address``, or started by ``torchrun``.
    Returns whether it is a rank."""
    if dist.is_initialized():
        return True
    if initialize_distributed(pcfg, device):
        return True
    if _started_by_torchrun():
        dist.init_process_group(backend=backend_for(device), init_method="env://")
        return True
    return False


def rank_device(device="cuda") -> torch.device:
    """This rank's device: the CPU, the card ``launch`` gave it, or card
    ``LOCAL_RANK`` (``torchrun``; else the rank modulo the host's cards)."""
    device = torch.device(device)
    if _RANK["device"] is not None:
        return _RANK["device"]
    if device.type != "cuda" or not dist.is_initialized():
        return device
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % max(torch.cuda.device_count(), 1)))
    return torch.device("cuda", local)


def is_primary() -> bool:
    """True on the process that owns host-side side effects (log file,
    metrics, checkpoints): rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def process_local_rows(n_rows: int, mesh=None) -> slice:
    """The slice of a leading (data-split) batch axis this process holds:
    its data index's contiguous block (all rows without a mesh). Raises
    unless the rows divide over the data axis."""
    if mesh is None:
        return slice(0, n_rows)
    return mesh.rows(n_rows)


def local_devices(pcfg, device="cuda") -> int:
    """The devices a mesh over this host would cover: its cards, or, for
    CPU ranks, as many as the mesh asks."""
    from emg_tpu_torch.parallel.mesh import requested_devices

    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return requested_devices(pcfg)


def _free_port() -> int:
    """A port for rank 0's rendezvous store, free on every interface and
    below the range (32768 up on Linux, 49152 up elsewhere) from which the
    OS gives client sockets their ports: the other ranks' retried connects
    while rank 0 starts cannot take it, as they can one probed from that
    range."""
    rng = random.Random()
    for _ in range(200):
        port = rng.randrange(20000, 32768)
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            try:
                s.bind(("", port))
            except OSError:
                continue
        return port
    raise RuntimeError("no free port in [20000, 32768) for the ranks' rendezvous")


def _worker(index: int, world: int, port: int, device: str, share_card: bool, threads: int,
            fn: Callable, args: tuple) -> None:
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", 0 if share_card else index)
        torch.cuda.set_device(device)
    else:
        # the launching process's threads shared out among the ranks
        torch.set_num_threads(max(1, threads // world))
    os.environ["LOCAL_RANK"] = str(index)
    # every rank is on this host: gloo's pairs over the loopback interface,
    # without resolving the host's name
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend=backend_for(device, share_card),
                            init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=index)
    _RANK["device"] = device
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, args: tuple, nprocs: int, device="cuda",
           share_card: bool = False) -> None:
    """Run ``fn(*args)`` in ``nprocs`` new processes, ranks 0..nprocs-1 of
    one process group on this host: rank i on card i (or all on card 0
    with ``share_card``, over gloo), or on the CPU over gloo. Returns when
    every rank has; raises if one raised. ``fn`` must be importable by
    name (a module-level function)."""
    device = torch.device(device)
    if device.type == "cuda" and not share_card and nprocs > torch.cuda.device_count():
        raise ValueError(f"{nprocs} ranks need {nprocs} cards; "
                         f"{torch.cuda.device_count()} are present")
    torch.multiprocessing.spawn(_worker, args=(nprocs, _free_port(), str(device), share_card,
                                               torch.get_num_threads(), fn, args),
                                nprocs=nprocs, join=True)
