"""Per-rank bootstrap for multi-process drivers.

The role mpiexec + MPI_Init play for the reference's pddrive
(EXAMPLE/pddrive.c:29).  Port of the JAX package's
``parallel/mhboot.py``: each rank calls :func:`boot` to join the
``torch.distributed`` process group the mesh tier's grid runs on
(parallel/grid.py) — the JAX version joins a ``jax.distributed`` world —
and :func:`attach_tree` to join the shared-memory tree domain of the
host-side collectives before its first one.
"""

from __future__ import annotations

import dataclasses
import datetime
import time

#: the process group's timeout when SLU_TPU_COMM_TIMEOUT_S is 0 (off):
#: torch's own default for gloo and NCCL
DEFAULT_TIMEOUT_S = 1800.0


@dataclasses.dataclass
class Booted:
    """What :func:`boot` set up: the backend, this rank's device and the
    rank→device map it chose the backend from."""

    backend: str
    device: object
    devices: list
    rank: int
    nproc: int


def rank_devices(nproc: int, device=None) -> list:
    """The rank→device map of a grid on one host: ``device`` None or
    "cuda" gives rank r the card ``r % device_count`` (ranks share a card
    when there are more ranks than cards; no card raises), "cpu" puts
    every rank on the CPU, another single device puts every rank on it,
    and a list or dict gives each rank its own."""
    import torch
    from superlu_dist_tpu_torch.utils.options import resolve_device
    if isinstance(device, dict):
        return [resolve_device(device[r]) for r in range(nproc)]
    if isinstance(device, (list, tuple)):
        if len(device) != nproc:
            raise ValueError(f"{len(device)} devices for {nproc} ranks")
        return [resolve_device(d) for d in device]
    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        return [torch.device("cuda", r % count) for r in range(nproc)]
    return [dev] * nproc


def choose_backend(devices) -> str:
    """NCCL when every rank has a card of its own, gloo when ranks share a
    card or run on the CPU (NCCL refuses two ranks on one device)."""
    cards = [d for d in devices if d.type == "cuda"]
    if len(cards) == len(devices) and len(set(cards)) == len(cards):
        return "nccl"
    return "gloo"


def boot(nproc: int, process_id: int, port: int | str,
         coordinator: str = "localhost", device=None,
         timeout_s: float | None = None) -> Booted:
    """Join this rank to an ``nproc``-rank ``torch.distributed`` process
    group at ``tcp://coordinator:port``, or at ``port`` itself when it is
    a ``file://`` rendezvous (a FileStore's file every rank of one host
    can open: ``testing/ranks.rendezvous`` makes one that no other group
    can take, where a TCP port chosen free may be taken before rank 0
    binds it).

    ``device`` is the rank→device map (``rank_devices``: None = the
    cards of this host); the backend follows from it (``choose_backend``)
    and the rank's card becomes its current device.  The process group's
    timeout is ``timeout_s``, else SLU_TPU_COMM_TIMEOUT_S when positive,
    else ``DEFAULT_TIMEOUT_S``: a rank still busy elsewhere must not fail
    a peer that waits for it in a collective.  Returns a :class:`Booted`;
    a failed join raises (no other backend is tried)."""
    import torch
    import torch.distributed as dist
    from superlu_dist_tpu_torch.utils.options import env_float
    nproc, rank = int(nproc), int(process_id)
    devices = rank_devices(nproc, device)
    backend = choose_backend(devices)
    mine = devices[rank]
    if mine.type == "cuda":
        torch.cuda.set_device(mine)
    if timeout_s is None:
        timeout_s = env_float("SLU_TPU_COMM_TIMEOUT_S") or DEFAULT_TIMEOUT_S
    if not dist.is_initialized():
        at = str(port)
        dist.init_process_group(
            backend, init_method=at if at.startswith("file://")
            else f"tcp://{coordinator}:{at}",
            world_size=nproc, rank=rank,
            timeout=datetime.timedelta(seconds=float(timeout_s)))
    elif (dist.get_world_size(), dist.get_rank()) != (nproc, rank):
        raise RuntimeError(
            f"a process group of {dist.get_world_size()} ranks (this one "
            f"{dist.get_rank()}) is already up, not {nproc} ({rank})")
    return Booted(backend=dist.get_backend(), device=mine, devices=devices,
                  rank=rank, nproc=nproc)


def shutdown() -> None:
    """Leave the process group (a no-op when none is up)."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def attach_tree(shm: str, nproc: int, rank: int, max_len: int = 4096,
                retries: int = 600, delay: float = 0.1):
    """Join the POSIX-shm tree domain; rank 0 creates, others retry
    until the creator has it up (the MPI_Comm_dup moment).  ``retries``
    × ``delay`` bounds the wait: a peer started before its root must
    cover the time until the root attaches."""
    from superlu_dist_tpu_torch.parallel.treecomm import TreeComm
    if rank == 0:
        return TreeComm(shm, nproc, 0, max_len=max_len, create=True)
    for _ in range(retries):
        try:
            return TreeComm(shm, nproc, rank, max_len=max_len,
                            create=False)
        except OSError:
            time.sleep(delay)
    raise TimeoutError(f"treecomm attach timeout for {shm!r}")
