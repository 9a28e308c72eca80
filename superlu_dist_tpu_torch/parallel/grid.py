"""The process grid of the mesh tier — the reference's 2-D process grid
over ``torch.distributed``.

The reference creates a Pr×Pc MPI grid with row/column sub-communicators
(superlu_gridinit, SRC/superlu_grid.c:31-189).  Port of the JAX
package's ``parallel/grid.py``, whose grid is a ``jax.sharding.Mesh``
over the chips of one controller (or of a ``jax.distributed`` world).
Torch's idiom is one process per device, so here a grid is a
``torch.distributed`` process group: the world (:func:`gridinit`) or a
sub-group of it (:func:`gridmap`, the reference's pddrive4 with two
sub-grids); every rank of it builds the same :class:`ProcessGrid` and
calls the tier's entry points collectively.  The grid keeps the JAX
package's axis names ``("snode", "panel")``, laid out row-major as the
JAX package lays out its devices (``reshape(nprow, npcol)``): grid rank r
sits at process row ``r // npcol`` and process column ``r % npcol``.  The
"panel" axis is a process row (its sub-group, the reference's row
communicator), the "snode" axis a process column.  A grid's ranks are its
own (0 .. nproc-1); its collectives run on its own groups and never touch
a rank outside it.  The
1-D tier (parallel/spmd.py) flattens the grid and deals the slots of
every group over the flat rank order; the 2-D tier
(parallel/mesh_stream.py) deals slots over the process rows and each
front's columns over the process columns.

The collectives the tier needs are methods of the grid:
:meth:`ProcessGrid.gather_rows` (every rank's rows, in rank order, one
broadcast per rank that has some), :meth:`ProcessGrid.all_gather`
(equal shapes; over the grid or one process column),
:meth:`ProcessGrid.all_reduce_sum` and, for numpy vectors,
:meth:`ProcessGrid.allreduce_sum_any` (the TreeComm call a
``utils.deadline.Deadline`` polls through); and for the 2-D tier
:meth:`ProcessGrid.bcast_row` (one process column's tensor to its row),
:meth:`ProcessGrid.all_reduce_row` (a sum over the row in process-column
order, the same bits on every rank of it) and :meth:`ProcessGrid.exchange`
(variable-size all-to-all over the grid).  Under gloo, card tensors are
staged through page-locked host memory (gloo takes no CUDA tensor in
``all_gather``, and the staging is explicit for all of them); under NCCL
they stay on the card.  ``comm`` counts each op's calls, bytes and
seconds.  ``SLU_TPU_VERIFY_COLLECTIVES=1`` checks each collective's
(op, shape, dtype, sequence) record across the ranks of its
communicator (the grid, a row or a column, each with its own sequence)
first — and an exchange's counts against its peers' — and raises
:class:`~superlu_dist_tpu_torch.utils.errors.CollectiveMismatchError` on
every rank instead of hanging.  A failed collective raises; nothing is
retried on another backend.

On an NCCL grid (each rank on a card of its own,
:attr:`ProcessGrid.capturable`) the collectives can run inside a CUDA
graph (parallel/mesh_graphs.py captures a group program with them).
Inside :meth:`ProcessGrid.recording` a collective does no host work — no
clock, no verify check, no host read — and leaves a record of its op,
shape, bytes and counts; :meth:`ProcessGrid.check_tape` runs verify
mode's checks over those records once, before the graph first runs, and
:meth:`ProcessGrid.replayed` counts the graph's calls and bytes in
``comm`` at each replay.  Each NCCL communicator of a grid makes its
first calls when the grid is made (``_warm_nccl``), never inside a
capture.  A gloo grid's collectives cannot be captured.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

#: the mesh's axis names (the JAX package's registry, utils/meshreg.py)
AXES = ("snode", "panel")
_OPCODES = {"all_gather": 1, "all_reduce": 2, "gather_rows": 3,
            "bcast_row": 4, "all_reduce_row": 5, "exchange": 6,
            "all_gather_col": 7}
_DTYPES = {torch.float32: 1, torch.float64: 2, torch.complex64: 3,
           torch.complex128: 4, torch.int64: 5, torch.int32: 6}


@dataclasses.dataclass
class ProcessGrid:
    """gridinfo_t analog (superlu_defs.h:323-349): the shape, this rank,
    its device and the process group's backend (None for a one-rank grid
    without a process group)."""

    nprow: int
    npcol: int
    rank: int                    # this rank in the grid (0 .. nproc-1)
    device: torch.device
    backend: str | None
    group: object = None         # the grid's process group (None: the
                                 # world's default group)
    axis_groups: dict = dataclasses.field(default_factory=dict)
                                 # "panel" / "snode": this rank's row /
                                 # column group (only where it has 2+ ranks)
    world_ranks: tuple = ()      # grid rank -> world rank
    verify: bool = False         # SLU_TPU_VERIFY_COLLECTIVES
    comm: dict = dataclasses.field(default_factory=dict)
    seq: dict = dataclasses.field(default_factory=dict)   # per communicator
    host_groups: dict = dataclasses.field(default_factory=dict)
                                 # an NCCL grid's gloo twins of its groups
                                 # (None: the grid's, "panel", "snode"),
                                 # for host tensors (:meth:`host`)
    tape: list = None            # the collectives of a capture in progress
                                 # (:meth:`recording`), one record each

    @property
    def nproc(self) -> int:
        return self.nprow * self.npcol

    @property
    def prow(self) -> int:
        """This rank's process row (the row-major layout)."""
        return self.rank // self.npcol

    @property
    def pcol(self) -> int:
        """This rank's process column."""
        return self.rank % self.npcol

    def _group(self, axis):
        """The process group of ``axis``: None (the whole grid), "panel"
        (this rank's process row) or "snode" (its process column)."""
        return self.group if axis is None else self.axis_groups[axis]

    def _world(self, grid_rank: int) -> int:
        """The world rank of grid rank ``grid_rank`` (torch's ``src=``
        is a world rank even with ``group=``)."""
        return self.world_ranks[grid_rank] if self.world_ranks else grid_rank

    def _members(self, axis) -> int:
        return {None: self.nproc, "panel": self.npcol,
                "snode": self.nprow}[axis]

    def host(self) -> "ProcessGrid":
        """This grid for host tensors: the same ranks on the CPU over
        gloo — the grid's own groups when they are gloo, else the gloo
        groups made beside them when the grid was (``_make_grid``).  The
        solver of factors offloaded to host memory runs on it
        (parallel/spmd.SpmdSolver); it shares the grid's ``comm`` and
        ``seq`` records."""
        if self.device.type == "cpu":
            return self
        group, axes = self.group, self.axis_groups
        if self.backend == "nccl":
            group = self.host_groups[None]
            axes = {k: v for k, v in self.host_groups.items()
                    if k is not None}
        return dataclasses.replace(
            self, device=torch.device("cpu"),
            backend="gloo" if self.backend == "nccl" else self.backend,
            group=group, axis_groups=axes, host_groups={})

    @property
    def staged(self) -> bool:
        """Card tensors cross through host memory (gloo)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can hold this grid's collectives: NCCL,
        each rank on a card of its own (gloo's run through host memory)."""
        return self.backend == "nccl" and self.device.type == "cuda"

    def _note(self, op, nbytes, seconds):
        rec = self.comm.setdefault(op, {"calls": 0, "bytes": 0,
                                        "seconds": 0.0})
        rec["calls"] += 1
        rec["bytes"] += int(nbytes)
        rec["seconds"] += seconds

    def _start(self, op, shape, dtype, axis=None, counts=None):
        """A collective's start: verify mode's checks, then the clock.
        While a capture records (:meth:`recording`) nothing of that runs
        on the host: the collective's record goes on the tape, for
        :meth:`check_tape` and :meth:`replayed`.  ``counts`` are an
        exchange's send then receive counts."""
        if self.tape is not None:
            self.tape.append({"op": op, "shape": tuple(int(s) for s in shape),
                              "dtype": dtype, "axis": axis, "bytes": 0,
                              "counts": counts})
            return None
        if self.verify:
            self._check(op, shape, dtype, axis)
            if counts is not None:
                self._check_counts(counts, dtype)
        return time.perf_counter()

    def _done(self, op, nbytes, t0):
        """A collective's end: its bytes and seconds in ``comm`` — or,
        captured, its bytes on its record (``comm`` counts them at each
        replay)."""
        if t0 is None:
            self.tape[-1]["bytes"] = int(nbytes)
        else:
            self._note(op, nbytes, time.perf_counter() - t0)

    @contextlib.contextmanager
    def recording(self):
        """The collectives issued in the block are being captured into a
        CUDA graph (parallel/mesh_graphs.py on a :attr:`capturable` grid):
        no clock, no verify check and no host read runs for them; each
        leaves a record on the list the block gets.  The graph's owner
        calls :meth:`check_tape` before the graph first runs and
        :meth:`replayed` after each replay."""
        if self.tape is not None:
            raise RuntimeError("a grid records one capture at a time")
        self.tape = []
        try:
            yield self.tape
        finally:
            self.tape = None

    def check_tape(self, tape) -> None:
        """Verify mode's checks of a captured graph's collectives, each
        against its communicator's peers in the order they were captured
        — (op, shape, dtype, sequence) records, an exchange's counts
        against its peers' — run once, outside the capture and before the
        graph's first replay, so a divergent program raises
        CollectiveMismatchError on every rank instead of hanging in its
        replay.  A no-op without verify mode."""
        if not self.verify:
            return
        for rec in tape:
            self._check(rec["op"], rec["shape"], rec["dtype"], rec["axis"])
            if rec["counts"] is not None:
                self._check_counts(rec["counts"], rec["dtype"])

    def replayed(self, tape) -> None:
        """A captured graph's collectives ran once more: their calls and
        bytes in ``comm``, from the sizes recorded at the capture (their
        seconds are the graph's: 0 here)."""
        for rec in tape:
            self._note(rec["op"], rec["bytes"], 0.0)

    def _check_counts(self, counts, dtype) -> None:
        """An exchange's send and receive counts against every rank's:
        what r sends to d is what d receives from r."""
        counts = self._gather_host(torch.tensor(counts, dtype=torch.float64))
        sent, got = counts[:, :self.nproc], counts[:, self.nproc:]
        if np.array_equal(sent, got.T):
            return
        from superlu_dist_tpu_torch.utils.errors import CollectiveMismatchError
        raise CollectiveMismatchError(
            [{"rank": r, "seq": self.seq.get(None, 0) - 1, "op": "exchange",
              "shape": tuple(int(c) for c in counts[r]),
              "dtype": _DTYPES.get(dtype, 0),
              "site": "grid:exchange counts"}
             for r in range(self.nproc)], rank=self.rank)

    def _check(self, op, shape, dtype, axis=None):
        """The lockstep record exchange of verify mode: (seq, op, ndim,
        shape, dtype) gathered from every rank of ``axis``'s communicator
        (its own sequence), compared, raised on."""
        shape = tuple(int(s) for s in shape)[:4]
        rec = torch.zeros(8, dtype=torch.float64)
        rec[0], rec[1], rec[2] = self.seq.get(axis, 0), _OPCODES[op], \
            len(shape)
        rec[3:3 + len(shape)] = torch.tensor(shape, dtype=torch.float64)
        rec[7] = _DTYPES.get(dtype, 0)
        self.seq[axis] = self.seq.get(axis, 0) + 1
        mat = self._gather_host(rec, axis)
        if (mat == mat[0]).all():
            return
        self._mismatch(mat, axis)

    def _gather_host(self, rec, axis=None) -> np.ndarray:
        """A small float64 host vector from every rank of ``axis``'s
        communicator, stacked in its rank order (verify mode's records)."""
        import torch.distributed as dist
        if self.backend == "nccl":
            rec = rec.to(self.device)
        parts = [torch.empty_like(rec) for _ in range(self._members(axis))]
        dist.all_gather(parts, rec, group=self._group(axis))
        return torch.stack(parts).cpu().numpy()

    def _mismatch(self, mat, axis):
        from superlu_dist_tpu_torch.utils.errors import CollectiveMismatchError
        names = {v: k for k, v in _OPCODES.items()}
        ranks = self._ranks(axis)
        raise CollectiveMismatchError(
            [{"rank": ranks[i], "seq": int(m[0]),
              "op": names.get(int(m[1]), "?"),
              "shape": tuple(int(s) for s in m[3:3 + int(m[2])]),
              "dtype": int(m[7]), "site": "grid" if axis is None
              else f"grid:{axis}"}
             for i, m in enumerate(mat)], rank=self.rank)

    def _ranks(self, axis) -> list:
        """The grid ranks of ``axis``'s communicator, in its order."""
        if axis is None:
            return list(range(self.nproc))
        if axis == "panel":
            return [self.prow * self.npcol + c for c in range(self.npcol)]
        return [r * self.npcol + self.pcol for r in range(self.nprow)]

    def all_gather(self, t: torch.Tensor, axis=None) -> torch.Tensor:
        """Every rank's ``t`` (one shape on every rank) concatenated in
        rank order along dim 0, on ``t``'s device: over the grid, or
        over this rank's process column (``axis="snode"``, in process-row
        order)."""
        k = self._members(axis)
        if k == 1:
            return t
        import torch.distributed as dist
        op = "all_gather" if axis is None else "all_gather_col"
        t0 = self._start(op, t.shape, t.dtype, axis)
        src = t.contiguous()
        group = self._group(axis)
        if self.staged:
            src = _pinned(src)
            out = torch.empty((k * t.shape[0],) + tuple(t.shape[1:]),
                              dtype=t.dtype, pin_memory=True)
            dist.all_gather(list(out.chunk(k)), src, group=group)
            out = out.to(t.device, non_blocking=True)
        elif self.backend == "nccl":
            # one output NCCL writes in place: no staging buffer, no copy
            # after (what a captured graph holds, parallel/spmd.py)
            out = torch.empty((k * t.shape[0],) + tuple(t.shape[1:]),
                              dtype=t.dtype, device=t.device)
            dist.all_gather_into_tensor(out, src, group=group)
        else:
            parts = [torch.empty_like(src) for _ in range(k)]
            dist.all_gather(parts, src, group=group)
            out = torch.cat(parts)
        self._done(op, out.numel() * out.element_size(), t0)
        return out

    def bcast_row(self, t, src_pcol: int, shape, dtype,
                  out=None) -> torch.Tensor:
        """Process column ``src_pcol``'s tensor ``t`` (of ``shape`` and
        ``dtype``; ignored elsewhere) on every rank of this process row,
        on this rank's device: the source gets ``t`` itself back, the
        others a new tensor — or ``out`` (of ``shape``, on this rank's
        device), written in place: the static buffer a captured CUDA
        graph reads (parallel/mesh_graphs.py).  A one-column grid returns
        ``t``."""
        if self.npcol == 1:
            return t
        import torch.distributed as dist
        shape = tuple(int(x) for x in shape)
        t0 = self._start("bcast_row", shape + (int(src_pcol),), dtype,
                         "panel")
        src = self.prow * self.npcol + int(src_pcol)
        group = self._group("panel")
        if self.rank == src:
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise ValueError(f"bcast_row: the source holds "
                                 f"{tuple(t.shape)} {t.dtype}, the row "
                                 f"expects {shape} {dtype}")
            buf = t.contiguous()
            if self.staged:
                buf = _pinned(buf)
            dist.broadcast(buf, src=self._world(src), group=group)
            out = t
        else:
            if self.staged:
                buf = torch.empty(shape, dtype=dtype, pin_memory=True)
            elif out is not None:
                buf = out
            else:
                buf = torch.empty(shape, dtype=dtype, device=self.device)
            dist.broadcast(buf, src=self._world(src), group=group)
            if out is None:
                out = buf.to(self.device, non_blocking=True)
            elif buf is not out:
                out.copy_(buf, non_blocking=True)
        self._done("bcast_row", buf.numel() * buf.element_size(), t0)
        return out

    def all_reduce_row(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` (one shape on every rank of the row) over this
        process row, added in process-column order — the same bits on
        every rank of the row, run to run.  A one-column grid returns
        ``t``."""
        if self.npcol == 1:
            return t
        import torch.distributed as dist
        t0 = self._start("all_reduce_row", t.shape, t.dtype, "panel")
        src = t.contiguous()
        group = self._group("panel")
        if self.staged:
            src = _pinned(src)
            parts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     for _ in range(self.npcol)]
            dist.all_gather(parts, src, group=group)
            parts = [p.to(t.device, non_blocking=True) for p in parts]
        elif self.backend == "nccl":
            # the row's parts in one output, as all_gather's
            parts = torch.empty((self.npcol,) + tuple(t.shape),
                                dtype=t.dtype, device=t.device)
            dist.all_gather_into_tensor(parts, src, group=group)
        else:
            parts = [torch.empty_like(src) for _ in range(self.npcol)]
            dist.all_gather(parts, src, group=group)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        self._done("all_reduce_row",
                   self.npcol * src.numel() * src.element_size(), t0)
        return out

    def exchange(self, send: torch.Tensor, send_counts,
                 recv_counts, out=None) -> torch.Tensor:
        """Variable-size all-to-all over the grid: ``send`` (1-D) holds
        this rank's elements for rank 0, 1, ... in order, ``send_counts[d]``
        of them for rank d; returns the ``sum(recv_counts)`` elements
        received, rank 0's first, on ``send``'s device — written into the
        front of ``out`` (1-D, on that device) when given.  Every rank
        enters, with empty legs where it has nothing to move."""
        send_counts = [int(c) for c in send_counts]
        recv_counts = [int(c) for c in recv_counts]
        if send.dim() != 1 or send.shape[0] != sum(send_counts):
            raise ValueError(f"exchange: send holds {tuple(send.shape)}, "
                             f"the counts say {sum(send_counts)}")
        if self.nproc == 1:
            return send
        import torch.distributed as dist
        total = sum(recv_counts)
        if out is not None and out.shape[0] < total:
            raise ValueError(f"exchange: out holds {out.shape[0]} elements, "
                             f"{total} arrive")
        t0 = self._start("exchange", (self.nproc,), send.dtype,
                         counts=send_counts + recv_counts)
        src = send.contiguous()
        if self.staged:
            src = _pinned(src)
            got = torch.empty(total, dtype=send.dtype, pin_memory=True)
        elif out is not None:
            got = out[:total]
        else:
            got = torch.empty(total, dtype=send.dtype, device=send.device)
        dist.all_to_all_single(got, src, output_split_sizes=recv_counts,
                               input_split_sizes=send_counts,
                               group=self.group)
        if self.staged:
            if out is None:
                got = got.to(send.device, non_blocking=True)
            else:
                out[:total].copy_(got, non_blocking=True)
                got = out[:total]
        self._done("exchange", (src.numel() + got.numel())
                   * src.element_size(), t0)
        return got

    def gather_rows(self, t: torch.Tensor, counts,
                    out=None) -> torch.Tensor:
        """Every rank's rows in rank order along dim 0, rank r giving
        ``counts[r]`` of them (``counts`` the same on every rank; ``t``
        this rank's), on ``t``'s device: one broadcast from each rank that
        has rows, so nothing is padded and a rank without rows sends
        nothing.  ``out`` (1-D, on that device, at least as many
        elements): written in its front, as the result's storage."""
        counts = [int(c) for c in counts]
        if t.shape[0] != counts[self.rank]:
            raise ValueError(f"rank {self.rank} has {t.shape[0]} rows, the "
                             f"counts say {counts[self.rank]}")
        if self.nproc == 1:
            return t
        import torch.distributed as dist
        rest = tuple(t.shape[1:])
        # the raise above is the caller's contract (its rows against the
        # counts every rank agreed on), checked before any rank sends, as
        # torch.distributed's own argument checks are
        t0 = self._start(  # slulint: disable=SLU101
            "gather_rows", (sum(counts),) + rest, t.dtype)
        if out is None:
            out = torch.empty((sum(counts),) + rest, dtype=t.dtype,
                              device=t.device)
        else:
            out = out[:sum(counts) * int(np.prod(rest, dtype=np.int64))] \
                .view((sum(counts),) + rest)
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
                # received in place: the rows' slice of the output
                buf = out[at:at + c]
            dist.broadcast(buf, src=self._world(r), group=self.group)
            if r != self.rank and self.staged:
                out[at:at + c].copy_(buf, non_blocking=True)
            at += c
        self._done("gather_rows", out.numel() * out.element_size(), t0)
        return out

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t`` (a new tensor on t's device)."""
        if self.nproc == 1:
            return t.clone()
        import torch.distributed as dist
        t0 = self._start("all_reduce", t.shape, t.dtype)
        out = t.detach().clone()
        if self.staged:
            out = out.cpu()
        dist.all_reduce(out, group=self.group)
        if out.device != t.device:
            out = out.to(t.device)
        self._done("all_reduce", out.numel() * out.element_size(), t0)
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


def _grid_device(device) -> torch.device:
    from superlu_dist_tpu_torch.utils.options import resolve_device
    device = resolve_device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _make_grid(ranks: list, nprow: int, npcol: int, device, world: int,
               rank: int, backend) -> ProcessGrid | None:
    """The nprow×npcol grid over world ranks ``ranks`` (row-major), or
    None on a rank outside it.  Every rank of the world calls this with
    the same arguments: ``torch.distributed.new_group`` is collective
    over the world even for a group that leaves the caller out.  The
    grid's group (unless it is the world), then each process row's and
    each process column's of two or more ranks, are made in one order on
    every rank."""
    import torch.distributed as dist
    from superlu_dist_tpu_torch.utils.options import env_flag
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("an NCCL grid runs on the card")
    need = nprow * npcol
    group, axis_groups, host_groups = None, {}, {}
    if world > 1:
        layout = np.asarray(ranks).reshape(nprow, npcol)

        def axes(out, **kw):
            for axis, members in (("panel", layout), ("snode", layout.T)):
                if members.shape[1] < 2:
                    continue
                for m in members:
                    g = dist.new_group([int(r) for r in m], **kw)
                    if rank in m:
                        out[axis] = g
        if need != world:
            group = dist.new_group(ranks)
        axes(axis_groups)
        if backend == "nccl":
            host_groups[None] = dist.new_group(ranks, backend="gloo")
            axes(host_groups, backend="gloo")
    if rank not in ranks:
        return None
    grid = ProcessGrid(nprow, npcol, ranks.index(rank), device, backend,
                       group=group, axis_groups=axis_groups,
                       world_ranks=tuple(ranks),
                       verify=env_flag("SLU_TPU_VERIFY_COLLECTIVES"),
                       host_groups=host_groups)
    if backend == "nccl" and world > 1:
        # the grid's communicators hold its ranks only: a rank outside
        # it returned above and takes no part
        _warm_nccl(grid)  # slulint: disable=SLU101
    return grid


def _warm_nccl(grid: ProcessGrid) -> None:
    """One eager call of each collective kind the grid issues on each of
    its NCCL communicators — the grid's (all-reduce, all-gather, the
    exchange's all-to-all, ``gather_rows``' broadcast from each rank),
    its process row's (all-reduce, broadcast, all-gather), its process
    column's (all-reduce, all-gather) — so that no communicator's first
    call, nor its first use of an operation's connections, falls inside
    a CUDA graph capture (parallel/mesh_graphs.py, parallel/spmd.py).
    Every rank of a communicator takes part, in this order on every
    rank: the grid, the row, the column."""
    import torch.distributed as dist
    dev = grid.device
    for axis in (None, "panel", "snode"):
        if grid._members(axis) < 2:
            continue
        group = grid._group(axis)
        k = grid._members(axis)
        one = torch.ones(k, device=dev)
        dist.all_reduce(one, group=group)
        dist.all_gather(list(torch.empty(k * k, device=dev).chunk(k)), one,
                        group=group)
        dist.all_gather_into_tensor(torch.empty(k * k, device=dev), one,
                                    group=group)
        if axis is None:
            dist.all_to_all_single(torch.empty(k, device=dev), one,
                                   group=group)
            for r in range(k):
                dist.broadcast(one, src=grid._world(r), group=group)
        elif axis == "panel":
            src = grid.prow * grid.npcol
            dist.broadcast(one, src=grid._world(src), group=group)
    torch.cuda.synchronize(dev)


def gridinit(nprow: int, npcol: int, device=None, tc=None) -> ProcessGrid:
    """superlu_gridinit analog (SRC/superlu_grid.c:31): the nprow×npcol
    grid over the initialized ``torch.distributed`` world, whose size must
    be nprow·npcol (``parallel/mhboot.boot`` joins it); a 1×1 grid needs
    no process group.  ``device`` is this rank's device (None: the card,
    ``cuda:<current>``; "cpu" on the CPU).  ``tc`` (a TreeComm of the same
    processes) is checked to order its ranks as the grid does: the host
    analysis travels on it and the device data on the process group."""
    need = int(nprow) * int(npcol)
    if need < 1:
        raise ValueError(f"grid {nprow}x{npcol} is empty")
    device = _grid_device(device)
    backend, world, rank = _backend_of_world()
    if world != need:
        raise ValueError(
            f"grid {nprow}x{npcol} needs a torch.distributed world of {need} "
            f"ranks, have {world} (parallel/mhboot.boot joins one)")
    grid = _make_grid(list(range(need)), int(nprow), int(npcol), device,
                      world, rank, backend)
    if tc is not None and (tc.rank != grid.rank or tc.n_ranks != need):
        raise ValueError(
            f"TreeComm rank {tc.rank}/{tc.n_ranks} differs from grid rank "
            f"{grid.rank}/{need}: both must order the same processes alike")
    return grid


def gridmap(ranks, nprow: int, npcol: int, device=None) -> ProcessGrid | None:
    """superlu_gridmap analog (SRC/superlu_grid.c:63): the nprow×npcol grid
    over the world ranks ``ranks`` (nprow·npcol of them, increasing: torch
    numbers a sub-group's members in world order), laid out row-major.
    COLLECTIVE over the world, as in the reference's pddrive4: every rank
    calls it for every sub-grid, in the same order, and gets the grid back
    where it is a member and None elsewhere (the reference marks a
    non-member with ``iam >= nprow*npcol``).  The grid's rank, ``nproc``,
    coordinates and collectives are the sub-grid's own."""
    ranks = [int(r) for r in ranks]
    need = int(nprow) * int(npcol)
    backend, world, rank = _backend_of_world()
    if (need < 1 or len(ranks) != need or ranks != sorted(set(ranks))
            or ranks[0] < 0 or ranks[-1] >= world):
        raise ValueError(f"gridmap {nprow}x{npcol} takes {need} distinct "
                         f"world ranks in increasing order below {world}, "
                         f"got {ranks}")
    return _make_grid(ranks, int(nprow), int(npcol), _grid_device(device),
                      world, rank, backend)


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
