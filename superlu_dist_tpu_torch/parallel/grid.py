"""The process grid of the mesh tier — the reference's 2-D process grid
over ``torch.distributed``.

The reference creates a Pr×Pc MPI grid with row/column sub-communicators
(superlu_gridinit, SRC/superlu_grid.c:31-189).  Port of the JAX
package's ``parallel/grid.py``, whose grid is a ``jax.sharding.Mesh``
over the chips of one controller (or of a ``jax.distributed`` world).
Torch's idiom is one process per device, so here a grid is the world of
a ``torch.distributed`` process group: every rank builds the same
:class:`ProcessGrid` and calls the tier's entry points collectively.
The grid wraps a ``DeviceMesh`` with the JAX package's axis names
``("snode", "panel")``; the mesh tier (parallel/spmd.py) flattens it and
deals the slots of every group block-cyclically over the flat rank order
(slot j on rank ``j % nproc``).  The "panel" axis — the split of one
front's columns over ranks — is not used by the port (ROADMAP.md).

The collectives the tier needs are methods of the grid:
:meth:`ProcessGrid.gather_rows` (every rank's rows, in rank order, one
broadcast per rank that has some), :meth:`ProcessGrid.all_gather`
(equal shapes), :meth:`ProcessGrid.all_reduce_sum` and, for numpy
vectors, :meth:`ProcessGrid.allreduce_sum_any` (the TreeComm call a
``utils.deadline.Deadline`` polls through).  Under gloo, card tensors are
staged through page-locked host memory (gloo takes no CUDA tensor in
``all_gather``, and the staging is explicit for all of them); under NCCL
they stay on the card.  ``comm`` counts each op's calls, bytes and
seconds.  ``SLU_TPU_VERIFY_COLLECTIVES=1`` checks each collective's
(op, shape, dtype, sequence) record across ranks first and raises
:class:`~superlu_dist_tpu_torch.utils.errors.CollectiveMismatchError` on
every rank instead of hanging.  A failed collective raises; nothing is
retried on another backend.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

#: the mesh's axis names (the JAX package's registry, utils/meshreg.py)
AXES = ("snode", "panel")
_OPCODES = {"all_gather": 1, "all_reduce": 2, "gather_rows": 3}
_DTYPES = {torch.float32: 1, torch.float64: 2, torch.complex64: 3,
           torch.complex128: 4, torch.int64: 5, torch.int32: 6}


@dataclasses.dataclass
class ProcessGrid:
    """gridinfo_t analog (superlu_defs.h:323-349): the shape, this rank,
    its device and the process group's backend (None for a one-rank grid
    without a process group)."""

    nprow: int
    npcol: int
    rank: int
    device: torch.device
    backend: str | None
    mesh: object = None          # torch.distributed DeviceMesh (None: one
                                 # rank, no process group)
    verify: bool = False         # SLU_TPU_VERIFY_COLLECTIVES
    comm: dict = dataclasses.field(default_factory=dict)
    seq: int = 0

    @property
    def nproc(self) -> int:
        return self.nprow * self.npcol

    @property
    def staged(self) -> bool:
        """Card tensors cross through host memory (gloo)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def _note(self, op, nbytes, seconds):
        rec = self.comm.setdefault(op, {"calls": 0, "bytes": 0,
                                        "seconds": 0.0})
        rec["calls"] += 1
        rec["bytes"] += int(nbytes)
        rec["seconds"] += seconds

    def _check(self, op, shape, dtype):
        """The lockstep record exchange of verify mode: (seq, op, ndim,
        shape, dtype) gathered from every rank, compared, raised on."""
        import torch.distributed as dist
        shape = tuple(int(s) for s in shape)[:4]
        rec = torch.zeros(8, dtype=torch.float64)
        rec[0], rec[1], rec[2] = self.seq, _OPCODES[op], len(shape)
        rec[3:3 + len(shape)] = torch.tensor(shape, dtype=torch.float64)
        rec[7] = _DTYPES.get(dtype, 0)
        if self.backend == "nccl":
            rec = rec.to(self.device)
        parts = [torch.empty_like(rec) for _ in range(self.nproc)]
        dist.all_gather(parts, rec)
        self.seq += 1
        mat = torch.stack(parts).cpu().numpy()
        if (mat == mat[0]).all():
            return
        from superlu_dist_tpu_torch.utils.errors import CollectiveMismatchError
        names = {v: k for k, v in _OPCODES.items()}
        raise CollectiveMismatchError(
            [{"rank": r, "seq": int(m[0]), "op": names.get(int(m[1]), "?"),
              "shape": tuple(int(s) for s in m[3:3 + int(m[2])]),
              "dtype": int(m[7]), "site": "grid"}
             for r, m in enumerate(mat)], rank=self.rank)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (one shape on every rank) concatenated in
        rank order along dim 0, on ``t``'s device."""
        if self.nproc == 1:
            return t
        import torch.distributed as dist
        t0 = time.perf_counter()
        if self.verify:
            self._check("all_gather", t.shape, t.dtype)
        src = t.contiguous()
        if self.staged:
            src = _pinned(src)
            out = torch.empty((self.nproc * t.shape[0],) + tuple(t.shape[1:]),
                              dtype=t.dtype, pin_memory=True)
            dist.all_gather(list(out.chunk(self.nproc)), src)
            out = out.to(t.device, non_blocking=True)
        else:
            parts = [torch.empty_like(src) for _ in range(self.nproc)]
            dist.all_gather(parts, src)
            out = torch.cat(parts)
        self._note("all_gather", out.numel() * out.element_size(),
                   time.perf_counter() - t0)
        return out

    def gather_rows(self, t: torch.Tensor, counts) -> torch.Tensor:
        """Every rank's rows in rank order along dim 0, rank r giving
        ``counts[r]`` of them (``counts`` the same on every rank; ``t``
        this rank's), on ``t``'s device: one broadcast from each rank that
        has rows, so nothing is padded and a rank without rows sends
        nothing."""
        counts = [int(c) for c in counts]
        if t.shape[0] != counts[self.rank]:
            raise ValueError(f"rank {self.rank} has {t.shape[0]} rows, the "
                             f"counts say {counts[self.rank]}")
        if self.nproc == 1:
            return t
        import torch.distributed as dist
        t0 = time.perf_counter()
        rest = tuple(t.shape[1:])
        if self.verify:
            self._check("gather_rows", (sum(counts),) + rest, t.dtype)
        out = torch.empty((sum(counts),) + rest, dtype=t.dtype,
                          device=t.device)
        at = 0
        for r, c in enumerate(counts):
            if not c:
                continue
            if r == self.rank:
                buf = t.contiguous()
                out[at:at + c] = buf
                if self.staged:
                    buf = _pinned(buf)
            elif self.staged:
                buf = torch.empty((c,) + rest, dtype=t.dtype, pin_memory=True)
            else:
                buf = torch.empty((c,) + rest, dtype=t.dtype, device=t.device)
            dist.broadcast(buf, src=r)
            if r != self.rank:
                out[at:at + c].copy_(buf, non_blocking=True)
            at += c
        self._note("gather_rows", out.numel() * out.element_size(),
                   time.perf_counter() - t0)
        return out

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t`` (a new tensor on t's device)."""
        if self.nproc == 1:
            return t.clone()
        import torch.distributed as dist
        t0 = time.perf_counter()
        if self.verify:
            self._check("all_reduce", t.shape, t.dtype)
        out = t.detach().clone()
        if self.staged:
            out = out.cpu()
        dist.all_reduce(out)
        if out.device != t.device:
            out = out.to(t.device)
        self._note("all_reduce", out.numel() * out.element_size(),
                   time.perf_counter() - t0)
        return out

    def allreduce_sum_any(self, arr, root: int = 0) -> np.ndarray:
        """numpy float64 vector summed over the ranks (the TreeComm call a
        collective Deadline polls through)."""
        t = torch.as_tensor(np.asarray(arr, dtype=np.float64))
        if self.backend == "nccl":
            t = t.to(self.device)
        return self.all_reduce_sum(t).cpu().numpy()

    def comm_summary(self) -> dict:
        return {op: dict(rec) for op, rec in self.comm.items()}


def _pinned(t: torch.Tensor) -> torch.Tensor:
    """A card tensor's copy in page-locked host memory (torch's caching
    host allocator keeps such blocks for reuse): the staging of a gloo
    collective."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def _backend_of_world():
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return None, 1, 0
    return dist.get_backend(), dist.get_world_size(), dist.get_rank()


def gridinit(nprow: int, npcol: int, device=None, tc=None) -> ProcessGrid:
    """superlu_gridinit analog (SRC/superlu_grid.c:31): the nprow×npcol
    grid over the initialized ``torch.distributed`` world, whose size must
    be nprow·npcol (``parallel/mhboot.boot`` joins it); a 1×1 grid needs
    no process group.  ``device`` is this rank's device (None: the card,
    ``cuda:<current>``; "cpu" on the CPU).  ``tc`` (a TreeComm of the same
    processes) is checked to order its ranks as the grid does: the host
    analysis travels on it and the device data on the process group."""
    from superlu_dist_tpu_torch.utils.options import env_flag, resolve_device
    need = int(nprow) * int(npcol)
    if need < 1:
        raise ValueError(f"grid {nprow}x{npcol} is empty")
    if device is None:
        device = "cuda"
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    backend, world, rank = _backend_of_world()
    if world != need:
        raise ValueError(
            f"grid {nprow}x{npcol} needs a torch.distributed world of {need} "
            f"ranks, have {world} (parallel/mhboot.boot joins one)")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("an NCCL grid runs on the card")
    mesh = None
    if world > 1:
        from torch.distributed.device_mesh import DeviceMesh
        mesh = DeviceMesh(device.type,
                          torch.arange(need).reshape(int(nprow), int(npcol)),
                          mesh_dim_names=AXES)
    grid = ProcessGrid(int(nprow), int(npcol), rank, device, backend,
                       mesh=mesh, verify=env_flag("SLU_TPU_VERIFY_COLLECTIVES"))
    if tc is not None and (tc.rank != grid.rank or tc.n_ranks != need):
        raise ValueError(
            f"TreeComm rank {tc.rank}/{tc.n_ranks} differs from grid rank "
            f"{grid.rank}/{need}: both must order the same processes alike")
    return grid


def gridmap(ranks, nprow: int, npcol: int, device=None) -> ProcessGrid:
    """superlu_gridmap analog (SRC/superlu_grid.c:63): the grid from an
    explicit rank list.  Under one process per device the list must be
    the world in order (a grid over a subset of the world would need a
    sub-group every rank creates); anything else raises."""
    ranks = [int(r) for r in ranks]
    if ranks != list(range(int(nprow) * int(npcol))):
        raise ValueError(f"gridmap takes the world's ranks in order, got "
                         f"{ranks}")
    return gridinit(nprow, npcol, device=device)


def gridinit_multihost(nprow: int, npcol: int,
                       coordinator_address: str | None = None,
                       num_processes: int | None = None,
                       process_id: int | None = None,
                       device=None) -> ProcessGrid:
    """Multi-process grid — what superlu_gridinit over a world
    communicator is to the reference: joins the process group
    (``mhboot.boot``, idempotent) when ``num_processes`` > 1, then lays
    the grid over it.  ``coordinator_address`` is "host:port"."""
    import torch.distributed as dist
    if num_processes is not None and int(num_processes) > 1 \
            and not dist.is_initialized():
        from superlu_dist_tpu_torch.parallel.mhboot import boot
        host, port = (coordinator_address or "localhost:29500").rsplit(":", 1)
        boot(int(num_processes), int(process_id), port, coordinator=host,
             device=device)
    return gridinit(nprow, npcol, device=device)
