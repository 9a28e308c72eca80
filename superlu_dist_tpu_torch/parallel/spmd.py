"""The mesh tier: the factorization and the triangular solves SPMD over
the ranks of a process grid, with the factors sharded over them.

Port of the JAX package's ``parallel/spmd.py``.  There the whole
factorization is one ``shard_map`` program over a single controller's
mesh, and every device ends up holding the whole factor.  Here each rank
is its own process (parallel/grid.py), runs the port's unchanged
``group_step`` over its own slots of every group, and keeps what it
factored: no rank holds another rank's off-diagonal panels — the
reference's NR_loc-in, distributed-factors-out property.

Slots are dealt BLOCK-CYCLICALLY over the flattened rank order — slot j
of a group lives on rank ``j % nd`` (``_cyclic_layout``, the reference's
2-D block-cyclic process-to-panel map, SURVEY.md §2.4).  Per group, each
rank assembles (``kernels.front_assemble_``, one launch when it owns a
slot) and factors its slots with ``write_back=False``; then every rank's
pivot blocks (B, w, w) and Schur blocks are all-gathered in one
collective, un-permuted to slot order (``g[j] = (j % nd)·B_loc + j//nd``)
and the pool write is replayed in full slot order on every rank — the
JAX package's "full-order replay".  The pool therefore stays equal on
every rank, and a rank with no slot in a group still enters the gather
with zero rows.  The tiny-pivot count is summed over the ranks at the
end; the deadline is polled collectively at every group boundary.

Bitwise contract (as in the JAX package): the batched partial LU and the
batched GEMMs compute slot s's result from slot s's data alone, so
dealing the slots over ranks changes no slot's bits — on the CPU the
SPMD fronts equal the single-process executors' bit for bit.  On the
card cuBLAS may choose another algorithm for a batch of B_loc slots than
for B slots; there the fronts are held to ``tols.TF32_DRIFT``.

The 2-D tier (parallel/mesh_stream.py) shares this module's
:class:`Shard` (with its column layout) and solver.

The solver (:class:`SpmdSolver`) runs the pivot TRSM on the full batch on
every rank (the gathered pivot stacks; the JAX package's reason: a
batched triangular solve need not be batch-size invariant) and the
contribution GEMMs — where the solve's flops are — on each rank's own
L21 / U12 panels, all-gathering the per-slot products and replaying the
lsum / x updates in full slot order on every rank.  Its sweeps run eager
between the collectives: a gloo collective cannot be captured in a CUDA
graph.
"""

from __future__ import annotations

import dataclasses
import time
import types

import numpy as np
import torch

from superlu_dist_tpu_torch.obs.kernelspans import KernelClock
from superlu_dist_tpu_torch.obs.trace import get_tracer


def _cyclic_layout(batch: int, nd: int):
    """Block-cyclic slot partition over ``nd`` ranks.

    Returns (B_loc, B_pad, src, valid, g): position p of the rank-major
    padded order (rank d = p // B_loc, local l = p % B_loc) holds slot
    ``src[p] = l·nd + d`` when ``valid[p]``; ``g[j]`` is the padded
    position of slot j, so ``gathered[g]`` restores slot order."""
    b_loc = max(1, -(-batch // nd))
    b_pad = b_loc * nd
    pos = np.arange(b_pad)
    src = (pos % b_loc) * nd + pos // b_loc
    valid = src < batch
    j = np.arange(batch)
    g = (j % nd) * b_loc + j // nd
    return b_loc, b_pad, src, valid, g


def _cyclic_counts(batch: int, nd: int):
    """The block-cyclic deal without padding: (counts, g) — rank r owns
    ``counts[r]`` slots r, r + nd, ..., and ``g[j]`` is slot j's row in
    the rank-major concatenation of every rank's slots
    (``ProcessGrid.gather_rows``), so ``gathered[g]`` restores slot
    order."""
    counts = np.array([len(range(r, batch, nd)) for r in range(nd)],
                      dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
    j = np.arange(batch)
    return counts, offs[j % nd] + j // nd


def _partition_rows(owner: np.ndarray, nd: int, pads: list, cols: list):
    """Stable partition of table rows by owning rank: row i goes to rank
    ``owner[i]``, original order preserved within a rank (the scatter-add
    sequence INTO one slot is the bitwise contract).  Each column array
    in ``cols`` is repacked to (nd·C_max, ...) rank-major with its
    ``pads`` sentinel filling the tail, so rank d's rows are the block
    [d·C_max, (d+1)·C_max)."""
    per_dev = [np.nonzero(owner == d)[0] for d in range(nd)]
    c_max = max((len(ix) for ix in per_dev), default=0)
    out = []
    for col, pad in zip(cols, pads):
        col = np.asarray(col)
        shaped = np.full((nd * c_max,) + col.shape[1:], pad,
                         dtype=col.dtype)
        for d, ix in enumerate(per_dev):
            shaped[d * c_max:d * c_max + len(ix)] = col[ix]
        out.append(shaped)
    return c_max, out


def local_plan(plan, nd: int, rank: int):
    """Rank ``rank``'s share of every group of ``plan`` as a plan-shaped
    record (``groups``, ``pool_size``) that ``factor.upload_maps`` takes:
    per group the owned slots ``rank, rank + nd, ...`` renumbered 0, 1,
    ... (the assembly triples and the child sets partitioned by
    ``_partition_rows``, their sentinels dropped by the kernel's map
    build), and every offset at the pool size (no write-back: the replay
    writes the pool).  Cached on the plan per (nd, rank)."""
    cache = plan.__dict__.setdefault("_spmd_local", {})
    key = (int(nd), int(rank))
    hit = cache.get(key)
    if hit is not None:
        return hit
    groups = []
    n_avals = len(plan.pattern_indices)
    for grp in plan.groups:
        b_loc = _cyclic_layout(grp.batch, nd)[0]
        owned = np.arange(rank, grp.batch, nd)

        def mine(owner, pads, cols):
            c_max, parts = _partition_rows(owner % nd, nd, pads, cols)
            return [p[rank * c_max:(rank + 1) * c_max] for p in parts]

        a_slot = np.asarray(grp.a_slot)
        as_s, af_s, asrc_s = mine(a_slot, [b_loc, 0, n_avals],
                                  [a_slot // nd, np.asarray(grp.a_flat),
                                   np.asarray(grp.a_src)])
        children = []
        for cs in grp.children:
            child_slot = np.asarray(cs.child_slot)
            co_s, cs_s, rel_s = mine(child_slot,
                                     [plan.pool_size, b_loc, grp.m],
                                     [np.asarray(cs.child_off),
                                      child_slot // nd, np.asarray(cs.rel)])
            children.append(types.SimpleNamespace(
                ub=cs.ub, child_off=co_s, child_slot=cs_s, rel=rel_s))
        groups.append(types.SimpleNamespace(
            level=grp.level, m=grp.m, w=grp.w, u=grp.u, batch=len(owned),
            sns=np.asarray(grp.sns)[owned], ws=np.asarray(grp.ws)[owned],
            off=np.full(len(owned), plan.pool_size, dtype=np.int64),
            a_slot=as_s, a_flat=af_s, a_src=asrc_s, children=children))
    hit = cache[key] = types.SimpleNamespace(groups=groups,
                                             pool_size=plan.pool_size)
    return hit


@dataclasses.dataclass
class Shard:
    """What one rank holds of a sharded factorization, beside its own
    panels (``NumericFactorization.fronts``).  On the 1-D tier: per group
    (lpanel (c, m, w), upanel (c, w, u)) of its c owned slots ``rank,
    rank + nd, ...``.  On the 2-D tier (parallel/mesh_stream.py, ``cols``
    set): per group its process row's slots ``prow, prow + nprow, ...``
    and only its own columns — (L columns (c, m, kw), U12 columns (c, w,
    ku)) at the global pivot columns ``cols[g][0]`` and Schur columns
    ``cols[g][1]`` (0-based from w)."""

    grid: object              # parallel.grid.ProcessGrid
    nd: int
    rank: int
    pivots: list              # per group: (B, w, w) packed L11\\U11 of
                              # every slot, slot order (the full-batch TRSM)
    nprow: int = None         # the 2-D tier's grid shape (None: 1-D)
    npcol: int = 1
    cols: list = None         # the 2-D tier's per-group own columns
    pool_bytes: int = 0       # the 2-D tier's Schur pool on this rank

    @property
    def pivot_bytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.pivots)

    def slots(self, batch: int, rank: int | None = None) -> np.ndarray:
        """The slots of a group of ``batch`` a rank (default this one)
        holds."""
        r = self.rank if rank is None else rank
        if self.cols is None:
            return np.arange(r, batch, self.nd)
        return np.arange(r // self.npcol, batch, self.nprow)


class SpmdFactorExecutor:
    """The factorization of ``plan`` on this rank of ``grid``: per group,
    its own slots through ``group_step(write_back=False)``, then one
    all-gather of every rank's pivot and Schur blocks and the pool write
    in full slot order (module docstring).

    ``ex(avals, thresh, timings=None)`` returns (this rank's fronts, the
    tiny count summed over the ranks, a :class:`Shard`).  ``deadline`` and
    ``chaos`` are per-call hooks (as on the stream executor); checkpoints
    and resume have no place here (the pool is the ranks' joint state).
    ``offload`` as on the 2-D executor (parallel/mesh_stream.py): "host"
    copies each group's own panels and its pivot stack to pinned host
    memory as the group completes."""

    name = "spmd"

    def __init__(self, plan, dtype, device, grid, gemm_prec=None,
                 scatter=None, offload="none", front_bytes_limit=6e9,
                 offload_lag=8, panel=None):
        from superlu_dist_tpu_torch.numeric import factor
        from superlu_dist_tpu_torch.numeric.stream import (auto_offload,
                                                           check_offload)
        from superlu_dist_tpu_torch.ops.dense import gemm_precision
        from superlu_dist_tpu_torch.symbolic.symbfact import _front_flops
        plan.check_index_width()
        if grid.device != device:
            raise ValueError(f"the grid's rank runs on {grid.device}, not "
                             f"{device}")
        self.plan, self.dtype, self.device, self.grid = (plan, dtype, device,
                                                         grid)
        self.nd, self.rank = grid.nproc, grid.rank
        self.gemm_prec = gemm_precision(gemm_prec)
        self.scatter = factor.KERNELS if scatter is None else scatter
        self.panel = factor.PANEL if panel is None else panel
        deals = [_cyclic_counts(g.batch, self.nd) for g in plan.groups]
        self._counts = [c for c, _ in deals]
        self._unperm = [torch.as_tensor(g, device=device) for _, g in deals]
        # the JAX tier's padded batch (B_pad) is what its program executes
        self.executed_flops = float(sum(
            _cyclic_layout(g.batch, self.nd)[1] * _front_flops(g.w, g.u)
            for g in plan.groups))
        self.local_flops = float(sum(
            len(range(self.rank, g.batch, self.nd)) * _front_flops(g.w, g.u)
            for g in plan.groups))
        if offload == "auto":
            offload = auto_offload(plan, dtype, device, front_bytes_limit,
                                   grid=True)
        self.offload = check_offload(offload)
        self.offload_lag = int(offload_lag)
        self.deadline = self.chaos = None
        self.checkpoint = self.resume = None
        self.host_levels = 0
        self.last_dispatch_seconds = 0.0
        self.last_offload_wait_seconds = 0.0
        self.host_bytes = 0
        self.last_gather = {"bytes": 0, "seconds": 0.0, "calls": 0}
        self._write = None

    def offload_sizes(self) -> list:
        """Elements this rank offloads per group: its own slots' panels
        and the group's pivot stack."""
        return [len(range(self.rank, g.batch, self.nd)) * (g.m * g.w
                                                           + g.w * g.u)
                + g.batch * g.w * g.w for g in self.plan.groups]

    def _write_maps(self):
        """Per group: (the slots with a Schur block, their pool offsets)
        on the device, or None for a group without one."""
        if self._write is None:
            out = []
            for g in self.plan.groups:
                off = np.asarray(g.off, dtype=np.int64)
                keep = np.flatnonzero(off < self.plan.pool_size)
                if g.u == 0 or not len(keep):
                    out.append(None)
                    continue
                out.append((torch.as_tensor(keep, device=self.device),
                            torch.as_tensor(off[keep], device=self.device)))
            self._write = out
        return self._write

    def __call__(self, avals, thresh, timings=None):
        from superlu_dist_tpu_torch.numeric import factor
        from superlu_dist_tpu_torch.numeric.stream import (_Offload,
                                                           progress_every,
                                                           progress_line)
        if self.checkpoint is not None or self.resume is not None:
            raise ValueError("the spmd executor takes no checkpoint or "
                             "resume: the pool is the ranks' joint state")
        plan, dev, grid = self.plan, self.device, self.grid
        nd, rank = self.nd, self.rank
        maps = factor.upload_maps(local_plan(plan, nd, rank), dev)
        writes = self._write_maps()
        avals = avals.to(device=dev, dtype=self.dtype)
        thresh = thresh.to(dev)
        pool = torch.zeros(plan.pool_size, dtype=self.dtype, device=dev)
        tiny = torch.zeros((), dtype=torch.int64, device=dev)
        fronts, pivots = [], []
        comm0 = dict(grid.comm.get("gather_rows", {"bytes": 0, "seconds": 0.0,
                                                   "calls": 0}))
        tracer = get_tracer()
        out = (_Offload(self.offload_sizes(), self.dtype, dev,
                        self.offload_lag)
               if self.offload == "host" else None)
        progress = progress_every()
        # a profiling tracer's one aggregate span, timed by CUDA events
        # read after the tiny count's all-reduce (obs/kernelspans.py)
        clock = KernelClock(dev) if tracer.profiling else None
        t_start = time.perf_counter()
        if clock is not None:
            whole = clock.start()
        for gi, grp in enumerate(plan.groups):
            if self.deadline is not None:
                self.deadline.poll(where="numeric factorization (spmd)")
            if progress and gi % progress == 0:
                progress_line(gi, len(plan.groups), t_start)
            w, u, m = grp.w, grp.u, grp.m
            count = maps[gi].ws.shape[0]
            if tracer.enabled:
                t0 = time.perf_counter()
            if count:
                (lp, up), schur, t = factor.group_step(
                    (count, m, w, u), avals, pool, thresh, maps[gi],
                    gemm_prec=self.gemm_prec, scatter=self.scatter,
                    timings=timings, write_back=False, panel=self.panel)
                tiny += t
                payload = lp[:, :w, :w].reshape(count, w * w)
                if u:
                    payload = torch.cat([payload, schur], dim=1)
            else:
                lp = torch.empty((0, m, w), dtype=self.dtype, device=dev)
                up = torch.empty((0, w, u), dtype=self.dtype, device=dev)
                payload = torch.empty((0, w * w + (u * u if u else 0)),
                                      dtype=self.dtype, device=dev)
            t1 = time.perf_counter()
            full = grid.gather_rows(payload, self._counts[gi])
            full = full[self._unperm[gi]]
            piv = full[:, :w * w].reshape(grp.batch, w, w).contiguous()
            if writes[gi] is not None:
                keep, off = writes[gi]
                pool[off[:, None] + torch.arange(u * u, device=dev)] = \
                    full[keep, w * w:]
            if timings is not None:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                timings["gather"] = (timings.get("gather", 0.0)
                                     + time.perf_counter() - t1)
            if out is not None:
                lp, up, piv = out.emit(gi, lp, up, piv)
            fronts.append((lp, up))
            pivots.append(piv)
            if tracer.enabled:
                tracer.complete(f"issue g{gi}", "dispatch", t0,
                                time.perf_counter() - t0, group=gi,
                                level=int(grp.level), owned=int(count))
            if self.chaos is not None:
                self.chaos.on_group(gi)
        if clock is not None:
            clock.stop(whole, None)
        if out is not None:
            out.drain()
            self.last_offload_wait_seconds = out.wait_s
            self.host_bytes = out.nbytes
        tiny_total = int(grid.all_reduce_sum(tiny))
        self.last_dispatch_seconds = time.perf_counter() - t_start
        comm1 = grid.comm.get("gather_rows", comm0)
        self.last_gather = {k: comm1[k] - comm0[k]
                            for k in ("bytes", "seconds", "calls")}
        if tracer.enabled:
            tracer.complete("issue spmd", "dispatch", t_start,
                            self.last_dispatch_seconds,
                            groups=len(plan.groups), n_devices=nd, rank=rank)
        if clock is not None:
            # after the all-reduce: the events have completed
            for t0, dt, _ in clock.read():
                tracer.complete("factor-spmd", "kernel", t0, dt,
                                n_groups=len(plan.groups), aggregate=True,
                                executed_flops=self.executed_flops,
                                local_flops=self.local_flops,
                                structural_flops=float(plan.flops))
        return fronts, tiny_total, Shard(grid=grid, nd=nd, rank=rank,
                                         pivots=pivots)

    def report(self) -> dict:
        return {"executor": self.name, "granularity": "group",
                "offload": self.offload,
                "offload_wait_s": self.last_offload_wait_seconds,
                "host_bytes": self.host_bytes,
                "host_levels": 0, "host_groups": 0,
                "nd": self.nd, "rank": self.rank,
                "backend": self.grid.backend,
                "owned_groups": sum(
                    1 for g in self.plan.groups if self.rank < g.batch),
                "local_flops": self.local_flops,
                "executed_flops": self.executed_flops,
                "dispatch_s": self.last_dispatch_seconds,
                "gather_bytes": self.last_gather["bytes"],
                "gather_s": self.last_gather["seconds"],
                "gathers": self.last_gather["calls"]}


def _padded(t: torch.Tensor, rows: int) -> torch.Tensor:
    if t.shape[0] == rows:
        return t
    return torch.cat([t, t.new_zeros((rows - t.shape[0],) + t.shape[1:])])


def gather_fronts(numeric) -> list:
    """Every group's (lpanel, upanel) of every slot, in slot order, on
    every rank of a sharded factorization — collective (the tests' and
    the card check's view, and the breakdown localization's).  An
    unsharded factorization returns its own fronts."""
    shard = numeric.shard
    if shard is None:
        return list(numeric.fronts)
    if shard.cols is not None:
        return _gather_fronts_2d(numeric)
    out = []
    for grp, (lp, up) in zip(numeric.plan.groups, numeric.fronts):
        counts, g = _cyclic_counts(grp.batch, shard.nd)
        g = torch.as_tensor(g, device=lp.device)
        out.append((shard.grid.gather_rows(lp, counts)[g],
                    shard.grid.gather_rows(up, counts)[g]))
    return out


def _gather_fronts_2d(numeric) -> list:
    """``gather_fronts`` of the 2-D tier: per group one gather of every
    rank's L and U12 columns (flattened, rank order), put back at their
    slots and global columns."""
    from superlu_dist_tpu_torch.parallel.layout2d import front_cols
    shard, grid = numeric.shard, numeric.shard.grid
    out = []
    for grp, (lp, up) in zip(numeric.plan.groups, numeric.fronts):
        m, w, u, b = grp.m, grp.w, grp.u, grp.batch
        dev = lp.device
        own = [front_cols(m, w, shard.npcol, r % shard.npcol)
               for r in range(shard.nd)]
        shapes = []
        for r in range(shard.nd):
            _, _, gcol, mc = own[r]
            kw = int(np.searchsorted(gcol, w))
            shapes.append((len(shard.slots(b, r)), kw, mc - kw))
        counts = [c * (m * kw + w * ku) for c, kw, ku in shapes]
        flat = torch.cat([lp.reshape(-1), up.reshape(-1)])
        full = grid.gather_rows(flat, counts)
        lfull = torch.zeros((b, m, w), dtype=lp.dtype, device=dev)
        ufull = torch.zeros((b, w, u), dtype=lp.dtype, device=dev)
        at = 0
        for r, (c, kw, ku) in enumerate(shapes):
            gcol = own[r][2]
            sl = torch.as_tensor(shard.slots(b, r), device=dev)
            piece = full[at:at + c * m * kw].view(c, m, kw)
            at += c * m * kw
            if c and kw:
                lfull[sl[:, None], :, torch.as_tensor(gcol[:kw], device=dev)
                      [None, :]] = piece.permute(0, 2, 1)
            piece = full[at:at + c * w * ku].view(c, w, ku)
            at += c * w * ku
            if c and ku:
                ucols = torch.as_tensor(gcol[kw:kw + ku] - w, device=dev)
                ufull[sl[:, None], :, ucols[None, :]] = piece.permute(0, 2, 1)
        out.append((lfull, ufull))
    return out


def sharded_finite(numeric) -> bool:
    """The isfinite sentinel over every rank's panels — collective: one
    flag all-reduce, the same answer on every rank."""
    from superlu_dist_tpu_torch.numeric.factor import fronts_finite
    bad = torch.zeros((), dtype=torch.int64)
    if not fronts_finite([f for f in numeric.fronts if f[0].shape[0]]):
        bad += 1
    grid = numeric.shard.grid
    if grid.backend == "nccl":
        bad = bad.to(grid.device)
    return int(grid.all_reduce_sum(bad)) == 0


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------

from superlu_dist_tpu_torch.solve.device import (DeviceSolver,  # noqa: E402
                                                 _scatter_add, _trsm,
                                                 sweep_maps)
from superlu_dist_tpu_torch.solve.plan import build_solve_plan  # noqa: E402


class SpmdSolver(DeviceSolver):
    """Solve (L·U)x = d over the sharded factors of a grid — collective:
    every rank calls ``solve`` / ``solve_trans`` with the same right-hand
    side and gets the same x.

    Subclasses :class:`DeviceSolver` for its solve plan, its bucketed
    scaffolding (``_run_sweeps``) and its sweep bodies' arithmetic; only
    ``_sweep`` differs (module docstring): per sweep batch the pivot TRSM
    on the full batch (pivot stacks gathered from the factor groups,
    promoted keys identity-padded as ``_pad_panels`` does), the
    contribution GEMM on this rank's members only — a member's owner is
    the owner of its factor slot — then one all-gather of the per-member
    products, un-permuted to sweep order, and the replayed scatter.
    DiagInv and CUDA graphs are off (the sweeps hold collectives).
    Factors offloaded to host memory (``fact.on_host``) are solved there,
    collectively, on the grid's host view (``ProcessGrid.host``: its gloo
    groups) — the JAX driver's rule that offloaded factors solve on the
    host (drivers/gssvx.py:180-187), without uploading them again.

    On the 2-D tier (``Shard.cols``: parallel/mesh_stream.py) a member
    belongs to its slot's process row, and a rank holds only its own
    columns of the member's L21 and U12: each product is this rank's
    column share of it, summed over the process row in process-column
    order (``ProcessGrid.all_reduce_row``) and gathered over the process
    rows — deterministic, but not the unsplit GEMM's bits."""

    def __init__(self, fact, schedule: str = "dataflow", window: int = 0,
                 align: float = 1.25, trsm_leaf: int = 64,
                 nrhs_max: int | None = None,
                 nrhs_growth: float | None = None,
                 gemm_prec: str | None = None):
        import threading
        from superlu_dist_tpu_torch.ops.dense import gemm_precision
        from superlu_dist_tpu_torch.utils.options import env_float, env_int
        shard = fact.shard
        if shard is None:
            raise ValueError("SpmdSolver needs a sharded factorization")
        if nrhs_max is None:
            nrhs_max = env_int("SLU_TPU_SOLVE_NRHS_MAX")
        if nrhs_growth is None:
            nrhs_growth = env_float("SLU_TPU_SOLVE_NRHS_GROWTH")
        # factors offloaded to host memory are solved where they lie:
        # the sweeps' row sums and gathers run on host tensors over the
        # grid's gloo groups (ProcessGrid.host), nothing is uploaded again
        self.fact = fact
        self.grid = shard.grid.host() if fact.on_host else shard.grid
        self.nd, self.rank = shard.nd, shard.rank
        self.diag_inv = False
        self.trsm_leaf = int(trsm_leaf)
        self.gemm_prec = gemm_precision(gemm_prec)
        plan = fact.plan
        self.splan = build_solve_plan(plan, schedule=schedule, window=window,
                                      align=align, nrhs_max=nrhs_max,
                                      nrhs_growth=nrhs_growth)
        self.n = plan.n
        self.device = dev = self.grid.device
        self.fused = False
        self.last_solve_stats = None
        self._groups = sweep_maps(self.splan, plan.sf, dev)
        nd, rank = self.nd, self.rank
        self.fronts = []          # per sweep batch: (pivots (B, W, W),
        self._spmd = []           # this rank's L21 (c, U, W), U12 (c, W, U))
        self.gathered_bytes = 0
        self.two_d = shard.cols is not None
        for sg in self.splan.groups:
            if self.two_d:
                self._add_batch_2d(sg, fact, shard)
                continue
            src_g = np.asarray(sg.src_group, dtype=np.int64)
            src_s = np.asarray(sg.src_slot, dtype=np.int64)
            owner = src_s % nd
            mine = np.flatnonzero(owner == rank)
            # the full pivot stack, in member order
            piv = _full_pivots(sg, src_g, src_s, plan, shard, dev)
            if sg.u and sg.batch > 1:
                piv = _panel_strided(piv)
            # this rank's members' panels, promoted like DeviceSolver's
            if len(mine):
                loc = types.SimpleNamespace(
                    batch=len(mine), src_group=src_g[mine],
                    src_slot=src_s[mine] // nd, w=sg.w, u=sg.u)
                lp, up = DeviceSolver._gather_panels(
                    loc, fact.fronts, types.SimpleNamespace(
                        groups=[types.SimpleNamespace(
                            batch=len(f[0]), w=g.w, u=g.u)
                            for f, g in zip(fact.fronts, plan.groups)]))
                l21, u12 = lp[:, sg.w:, :], up
            else:
                l21 = torch.empty((0, sg.u, sg.w), dtype=fact.dtype,
                                  device=dev)
                u12 = torch.empty((0, sg.w, sg.u), dtype=fact.dtype,
                                  device=dev)
            # the products are small: one all-gather padded to the
            # largest member count (latency, not volume, is their cost)
            c_max = int(np.bincount(owner, minlength=nd).max())
            rank_in_owner = np.empty(sg.batch, dtype=np.int64)
            for d in range(nd):
                ix = np.flatnonzero(owner == d)
                rank_in_owner[ix] = np.arange(len(ix))
            perm = owner * c_max + rank_in_owner
            self.fronts.append((piv, None))
            self._spmd.append(dict(
                l21=l21, u12=u12, c_max=c_max,
                sel=torch.as_tensor(mine, device=dev),
                perm=torch.as_tensor(perm, device=dev)))
            self.gathered_bytes += sum(
                t.numel() * t.element_size() for t in (piv, l21, u12)
                if t is not None)
        self.uploaded_bytes = 0
        self._invs_cached = [(None, None)] * len(self._groups)
        self._buffers, self._graphs, self._pool = {}, {}, None
        self.graph_pool_bytes = 0
        self._lock = threading.Lock()

    def _add_batch_2d(self, sg, fact, shard):
        """One sweep batch on the 2-D tier: the full pivot stack, and this
        rank's members (its process row's) with only its own columns —
        L21 (c, U, KW) at pivot columns ``lidx`` (c, KW) and U12 (c, W, KU)
        at Schur columns ``uidx`` (c, KU), zero-padded to the widest
        member, padding indices W and U (a zero row the products read,
        a dump row they write)."""
        plan, dev = fact.plan, self.device
        src_g = np.asarray(sg.src_group, dtype=np.int64)
        src_s = np.asarray(sg.src_slot, dtype=np.int64)
        owner = src_s % shard.nprow
        mine = np.flatnonzero(owner == self.grid.prow)
        piv = _full_pivots(sg, src_g, src_s, plan, shard, dev)
        W, U = sg.w, sg.u
        kw = [len(shard.cols[g][0]) for g in src_g[mine]]
        ku = [len(shard.cols[g][1]) for g in src_g[mine]]
        KW, KU = max(kw, default=0), max(ku, default=0)
        c = len(mine)
        l21 = torch.zeros((c, U, KW), dtype=fact.dtype, device=dev)
        u12 = torch.zeros((c, W, KU), dtype=fact.dtype, device=dev)
        lidx = np.full((c, KW), W, dtype=np.int64)
        uidx = np.full((c, KU), U, dtype=np.int64)
        i = 0
        while i < c:
            g = int(src_g[mine[i]])
            j = i
            while j < c and src_g[mine[j]] == g:
                j += 1
            fg = plan.groups[g]
            lp, up = fact.fronts[g]
            loc = torch.as_tensor(src_s[mine[i:j]] // shard.nprow,
                                  device=dev)
            pc, uc = shard.cols[g]
            l21[i:j, :fg.u, :len(pc)] = lp[loc][:, fg.w:, :]
            u12[i:j, :fg.w, :len(uc)] = up[loc]
            lidx[i:j, :len(pc)] = pc
            uidx[i:j, :len(uc)] = uc
            i = j
        counts = np.bincount(owner, minlength=shard.nprow)
        c_max = int(counts.max())
        rank_in = np.empty(sg.batch, dtype=np.int64)
        for d in range(shard.nprow):
            ix = np.flatnonzero(owner == d)
            rank_in[ix] = np.arange(len(ix))
        if sg.u and sg.batch > 1:
            piv = _panel_strided(piv)
        self.fronts.append((piv, None))
        self._spmd.append(dict(
            l21=l21, u12=u12, c_max=c_max,
            lidx=torch.as_tensor(lidx, device=dev),
            uidx=torch.as_tensor(uidx, device=dev),
            sel=torch.as_tensor(mine, device=dev),
            perm=torch.as_tensor(owner * c_max + rank_in, device=dev)))
        self.gathered_bytes += sum(t.numel() * t.element_size()
                                   for t in (piv, l21, u12))

    def _products_2d(self, i, kind, v, conj):
        """The 2-D tier's products of sweep batch i, in member order: this
        rank's share of its members' ``L21 @ v`` ("L"), ``U12 @ v`` ("U"),
        ``U12ᵀ @ v`` ("Ut") or ``L21ᵀ @ v`` ("Lt") over its own columns,
        summed over its process row in process-column order
        (``ProcessGrid.all_reduce_row``), then gathered over the process
        rows (``all_gather(axis="snode")``)."""
        sp = self._spmd[i]
        vs = v[sp["sel"]]
        c, _, k = vs.shape
        rows = torch.arange(c, device=vs.device)[:, None]
        if kind in ("L", "U"):
            mat = sp["l21"] if kind == "L" else sp["u12"]
            idx = sp["lidx"] if kind == "L" else sp["uidx"]
            ext = torch.cat([vs, vs.new_zeros((c, 1, k))], dim=1)
            prod = _matmul(mat.conj() if conj else mat, ext[rows, idx],
                           self._groups[i][0].batch)
        else:
            mat = (sp["u12"] if kind == "Ut" else sp["l21"]).mT
            idx = sp["uidx"] if kind == "Ut" else sp["lidx"]
            part = _matmul(mat.conj() if conj else mat, vs,
                           self._groups[i][0].batch)
            sg = self._groups[i][0]
            r_out = sg.u if kind == "Ut" else sg.w
            prod = vs.new_zeros((c, r_out + 1, k))
            prod[rows, idx] = part
            prod = prod[:, :r_out]
        prod = self.grid.all_reduce_row(prod)
        return self.grid.all_gather(_padded(prod, sp["c_max"]),
                                    axis="snode")[sp["perm"]]

    def _products(self, i, mat, v):
        """``mat @ v`` over this rank's c members of sweep batch i,
        gathered from every rank in member order (B, r, k).  A batch of
        one multiplies as two (the second a zero slot) when the sweep
        batch has more: torch's CPU matmul takes another kernel for a
        single matrix-vector product, and the slot's bits must not depend
        on how the batch was dealt."""
        sp = self._spmd[i]
        c = mat.shape[0]
        if c == 1 and self._groups[i][0].batch > 1:
            prod = torch.matmul(_padded(mat, 2), _padded(v, 2))[:1]
        else:
            prod = torch.matmul(mat, v)
        return self.grid.all_gather(_padded(prod, sp["c_max"]))[sp["perm"]]

    def _product(self, i, kind, v, conj):
        """Sweep batch i's contribution product over the grid, in member
        order: ``L21 @ v`` ("L"), ``U12 @ v`` ("U"), ``U12ᵀ @ v`` ("Ut")
        or ``L21ᵀ @ v`` ("Lt"), the panel conjugated under ``conj``; ``v``
        holds every member's operand."""
        if self.two_d:
            return self._products_2d(i, kind, v, conj)
        sp = self._spmd[i]
        mat = sp["l21"] if kind in ("L", "Lt") else sp["u12"]
        if conj:
            mat = mat.conj()
        if kind in ("Ut", "Lt"):
            mat = mat.mT
        return self._products(i, mat, v[sp["sel"]])

    def _sweep(self, direction, mode, x, lsum):
        leaf, prec = self.trsm_leaf, self.gemm_prec
        batches = list(zip(range(len(self._groups)), self._groups,
                           self.fronts))
        conj = mode == "C"
        if direction == "fwd":
            lsum.zero_()
            for i, (sg, cols, rows, lay), (piv, _) in batches:
                rhs = x[cols] - lsum[cols]
                if mode == "N":
                    y = _trsm(piv, rhs, True, True, False, leaf, prec)
                else:
                    y = _trsm(piv.conj() if conj else piv, rhs, False, False,
                              True, leaf, prec)
                x[cols] = y
                if sg.u:
                    _scatter_add(lsum, rows, self._product(
                        i, "L" if mode == "N" else "Ut", y, conj), lay)
            return
        for i, (sg, cols, rows, _), (piv, _) in reversed(batches):
            rhs = x[cols]
            if sg.u:
                rhs = rhs - self._product(
                    i, "U" if mode == "N" else "Lt", x[rows], conj)
            if mode == "N":
                y = _trsm(piv, rhs, False, False, False, leaf, prec)
            else:
                y = _trsm(piv.conj() if conj else piv, rhs, True, True, True,
                          leaf, prec)
            x[cols] = y

    def memory_stats(self) -> dict:
        rep = super().memory_stats()
        rep["sharded_panel_bytes"] = sum(
            sp["l21"].numel() * sp["l21"].element_size()
            + sp["u12"].numel() * sp["u12"].element_size()
            for sp in self._spmd)
        return rep


def _matmul(mat, v, batch):
    """``mat @ v`` over a rank's members; a batch of one multiplies as two
    (the second a zero slot) when the sweep batch has more (``_products``'
    reason)."""
    if mat.shape[0] == 1 and batch > 1:
        return torch.matmul(_padded(mat, 2), _padded(v, 2))[:1]
    return torch.matmul(mat, v)


def _full_pivots(sg, src_g, src_s, plan, shard, dev):
    """A sweep batch's full pivot stack (B, W, W) in member order, from the
    factor groups' gathered pivot stacks, promoted keys identity-padded."""
    parts, i = [], 0
    while i < sg.batch:
        j = i
        while j < sg.batch and src_g[j] == src_g[i]:
            j += 1
        fg = plan.groups[int(src_g[i])]
        piv = shard.pivots[int(src_g[i])]
        sl = src_s[i:j]
        if not (len(sl) == fg.batch
                and np.array_equal(sl, np.arange(fg.batch))):
            piv = piv[torch.as_tensor(sl, device=dev)]
        if fg.w != sg.w:
            piv = _pad_pivots(piv, fg.w, sg.w)
        parts.append(piv)
        i = j
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _panel_strided(piv):
    """The pivot stack (B, w, w) laid out as DeviceSolver's view
    ``lpanel[:, :w, :w]`` of a (B, m, w) panel stack is: rows contiguous,
    the batch stride past w·w (one spare element per slot, not the L21
    rows).  torch's CPU triangular solve takes another route for a
    contiguous batch than for a strided one, and its bits differ at one
    right-hand side; the layout keeps the SPMD sweep bit for bit the
    single-process one."""
    b, w, _ = piv.shape
    buf = piv.new_zeros(b * (w * w + 1))
    out = buf.as_strided((b, w, w), (w * w + 1, w, 1))
    out.copy_(piv)
    return out


def _pad_pivots(piv, w0, w):
    """A factor group's pivot stack promoted to a sweep key of width w:
    identity on the new diagonal (``_pad_panels``' pivot block)."""
    out = piv.new_zeros((piv.shape[0], w, w))
    out[:, :w0, :w0] = piv
    idx = torch.arange(w0, w, device=piv.device)
    out[:, idx, idx] = 1
    return out
