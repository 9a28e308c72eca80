"""The 2-D mesh executor: the JAX package's GSPMD stream sharding
(numeric/stream.py, fronts on ``P("snode", None, "panel")``, the pool on
``pool_spec(mesh, pool_partition)``) over the ranks of an nprow × npcol
process grid, each rank its own process (parallel/grid.py).

Per group, on every rank (the layout is parallel/layout2d.py's):

1. the rank assembles its column share of its process row's slots —
   (c, m, mc) fronts of the columns it owns, one ``front_assemble_``
   launch (``numeric/kernels.py``: the kernel reads its own pool with
   ``pool_partition``, the plan's replicated one without);
2. ``ops.dense.panel_partial_factor``: per panel of the blocked LU, the
   owning process column runs the column loop (the single-process
   path's own body), broadcasts the factored panel's rows over the row
   (``ProcessGrid.bcast_row``), and every rank of the row solves and
   updates its own columns right of the panel (``gemm``);
3. one ``ProcessGrid.exchange`` (a variable-size all-to-all over the
   world) carries every rank's pivot columns to every rank (the solver's
   full-batch TRSM reads every slot's (w, w) pivot block) and each Schur
   column to the rank(s) that extend-add it: only that rank with
   ``pool_partition`` — each rank's pool then holds only what it reads —
   every rank without.

Each rank keeps its own slots' own columns: L columns (c, m, kw) and U12
columns (c, w, ku) (``NumericFactorization.fronts``), the panel
broadcasts are dropped after each group.  The tiny count is summed over
the grid at the end; the deadline is polled collectively at every group
boundary.  With ``offload`` the rank's columns and the group's pivot
stack go to pinned host memory as each group completes (the JAX
stream's offload under a mesh, stream.py:165-226), and the solver runs
there (parallel/spmd.SpmdSolver).

Each group is a program (``MeshStreamExecutor._group``, a generator)
that yields at its collectives; this module runs it eagerly, and
parallel/mesh_graphs.py captures the launches between its yields as
CUDA graphs (the grid's fused and mega executors, and
``granularity="level"``: the schedule waves' programs on the card).

Under a file tracer each call records an ``issue g{gi}`` dispatch span a
group (``issue lvl{level}`` a wave) and an ``issue {name}`` span; under a
profiling one also a ``lu b{b} m{m} w{w} u{u}`` kernel span a group (an
aggregate one a wave) with the rank's ``owned`` slots, ``columns`` and
``local_flops``, and the aggregate ``factor-{name}`` span — all timed by
CUDA events read after the tiny count's all-reduce (obs/kernelspans.py),
as the JAX GSPMD stream records them, with ``last_profile``.

Bits: every front position receives the same adds in the same order
with either pool, so the partitioned and replicated pools give the same
fronts bit for bit.  With npcol = 1 each rank runs the single-process
partial LU's operations on its slots, and on the CPU the fronts equal
the stream executor's bit for bit; with npcol > 1 a rank's TRSM and GEMM
run over a narrower column block, which torch's CPU kernels compute
column for column alike (the tests hold the fronts bit for bit there
too), and cuBLAS may not: on the card fronts are held to
``tols.TF32_DRIFT``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from superlu_dist_tpu_torch.obs.kernelspans import (KernelClock, kernel_span,
                                                    wave_span)
from superlu_dist_tpu_torch.obs.trace import get_tracer
from superlu_dist_tpu_torch.ops.dense import panel_width
from superlu_dist_tpu_torch.parallel.layout2d import (expand, front_cols,
                                                      layout)


def share_maps(gl, device, batch=None) -> object:
    """The device maps of one group share (``layout2d.GroupLayout``): the
    plain version's (``kernels.GroupMaps`` with ``gcol``) and the
    kernel's (``kernels.FrontMaps`` of the column share).  ``batch``
    (default: the share's slots) pads the slots with identity fronts
    (``ws`` 0), as the grid's mega executor runs them."""
    from superlu_dist_tpu_torch.numeric import kernels
    sm = gl.maps
    batch = sm.batch if batch is None else int(batch)
    ws = np.zeros(batch, dtype=np.int64)
    ws[:sm.batch] = sm.ws

    def put(x):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.int64),
                               device=device)
    children = [(ub, put(off), put(slot), put(rel), put(crel), put(stride))
                for ub, off, slot, rel, crel, stride in sm.children]
    front = kernels.build_front_maps(
        batch, sm.m, sm.pool_len,
        a=(sm.a_slot, sm.a_flat_global, sm.a_src),
        children=[tuple(np.asarray(x) if i else x for i, x in enumerate(c))
                  for c in sm.children],
        device=device, cols=sm.own, share=sm.share)
    return kernels.GroupMaps(
        ws=put(ws), off=put(np.zeros(batch)), a_slot=put(sm.a_slot),
        a_flat=put(sm.a_flat), a_src=put(sm.a_src), children=children,
        front=front, gcol=put(sm.own))


def share_ops(w: int, m_ext: int, gcol, npcol: int, pcol: int) -> float:
    """The arithmetic operations of ``ops.dense.panel_partial_factor`` on
    one front for the rank of process column ``pcol`` owning the columns
    ``gcol`` of [0, m_ext), as it runs them: per panel it owns, each
    active pivot's divide of every row and multiply-subtract over the
    whole (M_ext, pb) panel; per panel, the unit-lower TRSM (pa·(pa − 1)
    a column) and the GEMM (2·(M_ext − j0 − pa)·pa a column) over its
    own columns right of the panel.  Over the process columns these sum
    to the single-process blocked LU's operations."""
    pb, nsteps = panel_width(w)
    gcol = np.asarray(gcol)
    ops = 0
    for p in range(nsteps):
        j0 = p * pb
        pa = min(pb, w - j0)
        if p % npcol == pcol:
            ops += pa * m_ext * (2 * pb + 1)
        right = len(gcol) - int(np.searchsorted(gcol, j0 + pb))
        ops += right * (pa * (pa - 1) + 2 * (m_ext - j0 - pa) * pa)
    return float(ops)


def _segments(seg, device) -> dict:
    out = {k: torch.as_tensor(getattr(seg, k), device=device)
           for k in ("start", "length", "stride", "buf")}
    out["first"] = torch.as_tensor(
        np.concatenate([[0], np.cumsum(seg.length)[:-1]]).astype(np.int64)
        if len(seg.length) else np.zeros(0, np.int64), device=device)
    out["total"] = seg.total
    return out


def _put(target, segs, buf, pairs, local, dev):
    """Writes what a group's exchange brought into ``target`` (1-D): the
    received segments ``segs`` from ``buf``, and this rank's own leg
    ``pairs`` (source, target segments) straight from ``local`` (its
    flattened local array)."""
    if segs["total"]:
        tgt, src = expand(segs, segs["total"], dev)
        target[tgt] = buf[src]
    frm, to = pairs
    if to["total"]:
        target[expand(to, to["total"], dev)[0]] = \
            local[expand(frm, frm["total"], dev)[0]]


class Exchange:
    """A group's exchange, as a group program (``MeshStreamExecutor.
    _group``) yields it: the send buffer (its first ``gl.send.total``
    elements go out) and the group's layout, whose counts it takes."""

    __slots__ = ("send", "gl")

    def __init__(self, send, gl):
        self.send, self.gl = send, gl


def drive(program, collective):
    """Run a group program to its end, each request it yields — a panel
    broadcast ``(t, owner, shape)`` or an :class:`Exchange` — answered
    by ``collective(request)``; returns what the program returns."""
    try:
        req = next(program)
        while True:
            req = program.send(collective(req))
    except StopIteration as done:
        return done.value


class MeshStreamExecutor:
    """The factorization of ``plan`` on this rank of an nprow × npcol
    ``grid`` (module docstring).

    ``ex(avals, thresh, timings=None)`` returns (this rank's fronts, the
    tiny count summed over the grid, a ``spmd.Shard`` carrying the column
    layout).  ``deadline`` and ``chaos`` are per-call hooks; checkpoints
    and resume have no place here (the pool is the ranks' joint state).

    ``offload`` (the JAX stream's, stream.py:165-226): "host" copies each
    group's own L and U12 columns and its pivot stack to pinned host
    memory as the group completes, on a side stream, at most
    ``offload_lag`` groups in flight (``numeric/stream._Offload``, sized
    from this rank's share); "auto" does so when the plan's padded front
    bytes exceed ``front_bytes_limit`` (``numeric/stream.auto_offload``,
    on any device on a grid); "none" keeps them on the device.

    Each group runs as a program (:meth:`_group`, a generator) that
    yields at its collectives — every panel broadcast of
    ``ops.dense.panel_steps`` and the exchange — and :func:`drive` runs
    them eagerly here; the graph executors (parallel/mesh_graphs.py)
    capture the rank-local launches between two yields as CUDA graphs.

    ``granularity`` (the JAX stream's, stream.py:213-215): "group" runs
    group by group; "level" runs each schedule wave (consecutive groups
    of one ``Group.level``) as one unit — on the card the wave's programs
    as segment graphs, the launches between two collectives one graph
    across the wave's group boundaries (``mesh_graphs.MeshLevelExecutor``,
    which this constructor returns for it), on the CPU the same eager
    programs as "group", bit for bit.  The deadline polls at every unit
    boundary."""

    name = "mesh-stream"

    def __new__(cls, *args, granularity="group", **kw):
        if cls is MeshStreamExecutor and granularity == "level":
            from superlu_dist_tpu_torch.parallel.mesh_graphs import (
                MeshLevelExecutor)
            cls = MeshLevelExecutor
        return super().__new__(cls)

    def __init__(self, plan, dtype, device, grid, gemm_prec=None,
                 scatter=None, pool_partition=False, offload="none",
                 front_bytes_limit=6e9, offload_lag=8, panel=None,
                 granularity="group"):
        from superlu_dist_tpu_torch.numeric import factor
        from superlu_dist_tpu_torch.numeric.stream import (auto_offload,
                                                           check_offload)
        from superlu_dist_tpu_torch.ops.dense import (gemm_precision,
                                                      resolve_gemm_tier)
        if granularity not in ("group", "level"):
            raise ValueError(f"granularity must be 'group' or 'level', "
                             f"got {granularity!r}")
        plan.check_index_width()
        if grid.device != device:
            raise ValueError(f"the grid's rank runs on {grid.device}, not "
                             f"{device}")
        if grid.nproc < 2:
            raise ValueError("the 2-D mesh executor runs on a grid of "
                             "several ranks")
        self.plan, self.dtype, self.device, self.grid = (plan, dtype, device,
                                                         grid)
        self.nd, self.rank = grid.nproc, grid.rank
        self.pool_partition = bool(pool_partition)
        self.granularity = granularity
        self.gemm_prec = gemm_precision(gemm_prec)
        self.gemm_prec_resolved = resolve_gemm_tier(self.gemm_prec, dtype)
        self.scatter = factor.KERNELS if scatter is None else scatter
        self.panel = factor.PANEL if panel is None else panel
        self.layout = layout(plan, grid.nprow, grid.npcol, grid.rank,
                             self.pool_partition)
        # the operations of panel_partial_factor, counted exactly: this
        # rank's (its slots, its panels, its columns; per group and in
        # all) and the grid's
        self.group_local_flops = [
            float(len(gl.slots) * share_ops(g.w, gl.m_ext, gl.gcol,
                                            grid.npcol, grid.pcol))
            for g, gl in zip(plan.groups, self.layout.groups)]
        self.local_flops = float(sum(self.group_local_flops))
        self.executed_flops = float(sum(
            g.batch * share_ops(g.w, *front_cols(g.m, g.w, grid.npcol,
                                                 pc)[1:3], grid.npcol, pc)
            for g in plan.groups for pc in range(grid.npcol)))
        if offload == "auto":
            offload = auto_offload(plan, dtype, device, front_bytes_limit,
                                   grid=True)
        self.offload = check_offload(offload)
        self.offload_lag = int(offload_lag)
        self.deadline = self.chaos = None
        self.checkpoint = self.resume = None
        self.host_levels = 0
        self.last_profile = None   # a profiling tracer's spans, per call
        self.last_dispatch_seconds = 0.0
        self.last_offload_wait_seconds = 0.0
        self.host_bytes = 0
        self.last_comm = {}
        self._timings = None
        self._dev = None

    def _device_state(self):
        """Per group on the device, built at the first call: the share's
        maps, its slots' real pivot widths and the exchange's segments
        (the state a group program reads: ``rows`` local slots, the pivot
        stack's ``piv_len`` elements)."""
        if self._dev is None:
            dev = self.device
            self._dev = [dict(maps=share_maps(gl, dev)
                              if len(gl.slots) and gl.mc else None,
                              ws=torch.as_tensor(gl.maps.ws, device=dev),
                              rows=len(gl.slots),
                              piv_len=grp.batch * grp.w * grp.w,
                              send=_segments(gl.send, dev),
                              piv=_segments(gl.recv_piv, dev),
                              pool=_segments(gl.recv_pool, dev),
                              self_piv=[_segments(x, dev)
                                        for x in gl.self_piv],
                              self_pool=[_segments(x, dev)
                                         for x in gl.self_pool])
                         for grp, gl in zip(self.plan.groups,
                                            self.layout.groups)]
        return self._dev

    @property
    def pool_bytes(self) -> int:
        return self.layout.pool_len * torch.empty(
            (), dtype=self.dtype).element_size()

    def offload_sizes(self) -> list:
        """Elements this rank offloads per group: its own L columns
        (c, m, kw), U12 columns (c, w, ku) and the group's pivot stack
        (B, w, w)."""
        return [len(gl.slots) * (grp.m * gl.kw + grp.w * (gl.mc - gl.kw))
                + grp.batch * grp.w * grp.w
                for grp, gl in zip(self.plan.groups, self.layout.groups)]

    # ---- one group --------------------------------------------------------

    def _lap(self, name, clock):
        if self._timings is None:
            return clock
        return _lap(self._timings, name, clock, self.device)

    def _group(self, gi, st, bufs):
        """Group ``gi``'s program on state ``st`` (``_device_state``'s
        record, or a mega bucket's) and the call's buffers ``bufs``
        (avals, the pool — ``kpool`` what the assembly reads, ``pool``
        what the exchange writes — thresh, tiny): the column-share
        assembly, the partial LU over the rank's columns (yielding each
        panel broadcast), the exchange (yielded), then the received
        pivot and Schur columns put in place.  Returns (L columns, U12
        columns, the flat pivot buffer) of the state's ``rows`` slots
        (``_finish`` cuts them to the group's own)."""
        from superlu_dist_tpu_torch.ops.dense import panel_steps
        grp, gl = self.plan.groups[gi], self.layout.groups[gi]
        grid, dev = self.grid, self.device
        w, m = grp.w, grp.m
        c = st["rows"]
        clock = time.perf_counter()
        if st["maps"] is not None:
            f = self.scatter(bufs.avals, bufs.kpool, m, w, st["maps"]).view(
                c, m, gl.mc)
        else:
            f = torch.zeros((c, m, gl.mc), dtype=self.dtype, device=dev)
        a = f
        if gl.m_ext > m or gl.mc_ext > gl.mc:
            a = torch.nn.functional.pad(
                f, (0, gl.mc_ext - gl.mc, 0, gl.m_ext - m))
        clock = self._lap("front_assemble", clock)
        if c:
            flags = yield from panel_steps(
                a, bufs.thresh, w, gl.gcol, grid.npcol, grid.pcol,
                self.gemm_prec, grid.npcol > 1, self.panel)
            # identity-padding columns are unit pivots (group_step)
            real = torch.arange(w, device=dev)[None, :] < st["ws"][:, None]
            bufs.tiny += torch.where(real, flags, 0).sum()
        clock = self._lap("partial_factor", clock)
        flat = a.reshape(-1)
        send = flat[expand(st["send"], st["send"]["total"], dev)[0]] \
            if st["send"]["total"] else a.new_empty(0)
        got = yield Exchange(send, gl)
        piv = torch.empty(st["piv_len"], dtype=self.dtype, device=dev)
        _put(piv, st["piv"], got, st["self_piv"], flat, dev)
        _put(bufs.pool, st["pool"], got, st["self_pool"], flat, dev)
        out = (a[:, :m, :gl.kw].contiguous(),
               a[:, :w, gl.kw:gl.mc].contiguous(), piv)
        self._lap("exchange", clock)
        return out

    def _collective(self, req, out=None):
        """One request of a group program, run now: a panel broadcast
        over the process row or the exchange (into ``out`` when given)."""
        if isinstance(req, Exchange):
            gl = req.gl
            return self.grid.exchange(req.send[:gl.send.total],
                                      gl.send_counts, gl.recv_counts,
                                      out=out)
        t, owner, shape = req
        return self.grid.bcast_row(t, owner, shape, self.dtype, out=out)

    def _pool_len(self) -> int:
        """The pool's elements (the mega executor's has a dump element
        past the rank's pool)."""
        return self.layout.pool_len

    def _buffers(self, avals, thresh):
        """The call's avals, pool, thresh and tiny count (new ones each
        call; the graph executors keep static ones)."""
        import types
        dev = self.device
        pool = torch.zeros(self._pool_len(), dtype=self.dtype, device=dev)
        return types.SimpleNamespace(
            avals=avals.to(device=dev, dtype=self.dtype), pool=pool,
            kpool=pool[:self.layout.pool_len], thresh=thresh.to(dev),
            tiny=torch.zeros((), dtype=torch.int64, device=dev))

    def _run_group(self, gi, bufs):
        """Group ``gi`` of this call: its program driven eagerly."""
        return self._finish(gi, *drive(
            self._group(gi, self._device_state()[gi], bufs),
            self._collective))

    def units(self) -> list:
        """The (lo, hi) group ranges a call runs one after another: each
        group at "group", each schedule wave at "level"."""
        groups = self.plan.groups
        if self.granularity == "group":
            return [(gi, gi + 1) for gi in range(len(groups))]
        out, lo = [], 0
        for gi in range(1, len(groups) + 1):
            if gi == len(groups) or groups[gi].level != groups[lo].level:
                out.append((lo, gi))
                lo = gi
        return out

    def _run_unit(self, lo, hi, bufs) -> list:
        """Groups lo..hi-1 of this call: their outputs (``_finish``'s),
        one after another."""
        return [self._run_group(gi, bufs) for gi in range(lo, hi)]

    def _padded_batch(self, gi) -> int:
        """The batch group ``gi``'s kernel span reports (the grid's mega
        pads it to its key's rung)."""
        return self.plan.groups[gi].batch

    def _finish(self, gi, lp, up, piv, clone=False):
        """A group program's outputs cut to group ``gi``'s own slots and
        pivot stack (B, w, w) — cloned out of a graph's static outputs
        with ``clone``."""
        grp = self.plan.groups[gi]
        c, n = len(self.layout.groups[gi].slots), grp.batch * grp.w * grp.w
        out = (lp[:c], up[:c], piv[:n].view(grp.batch, grp.w, grp.w))
        return tuple(t.clone() for t in out) if clone else out

    def _begin(self, timings):
        """The call's start: per-call checks of the executor."""
        self._timings = timings

    # ---- the call ---------------------------------------------------------

    def __call__(self, avals, thresh, timings=None):
        from superlu_dist_tpu_torch.numeric.stream import (_Offload,
                                                           progress_every,
                                                           progress_line,
                                                           progress_wave)
        from superlu_dist_tpu_torch.parallel.spmd import Shard
        if self.checkpoint is not None or self.resume is not None:
            raise ValueError(f"the {self.name} executor takes no checkpoint "
                             f"or resume: the pool is the ranks' joint state")
        plan, dev, grid = self.plan, self.device, self.grid
        self._begin(timings)
        bufs = self._buffers(avals, thresh)
        out = (_Offload(self.offload_sizes(), self.dtype, dev,
                        self.offload_lag)
               if self.offload == "host" else None)
        fronts, pivots = [], []
        comm0 = {op: dict(rec) for op, rec in grid.comm.items()}
        tracer = get_tracer()
        clock = KernelClock(dev) if tracer.profiling else None
        progress = progress_every()
        t_start = time.perf_counter()
        if clock is not None:
            whole = clock.start()
        try:
            for lo, hi in self.units():
                if self.deadline is not None:
                    self.deadline.poll(where="numeric factorization (mesh)")
                if progress and self.granularity == "level":
                    progress_wave(plan.groups[lo].level, hi - lo)
                elif progress and lo % progress == 0:
                    progress_line(lo, len(plan.groups), t_start)
                if tracer.enabled:
                    t0 = time.perf_counter()
                if clock is not None:
                    mark = clock.start()
                outs = self._run_unit(lo, hi, bufs)
                if clock is not None:
                    clock.stop(mark, (lo, hi))
                for gi, (lp, up, piv) in zip(range(lo, hi), outs):
                    if out is not None:
                        lp, up, piv = out.emit(gi, lp, up, piv)
                    fronts.append((lp, up))
                    pivots.append(piv)
                if tracer.enabled:
                    self._issue_span(tracer, t0, lo, hi)
                if self.chaos is not None:
                    self.chaos.on_group(hi - 1)
            if clock is not None:
                clock.stop(whole, None)
            if out is not None:
                out.drain()
        finally:
            self._timings = None
        if out is not None:
            self.last_offload_wait_seconds = out.wait_s
            self.host_bytes = out.nbytes
        tiny_total = int(grid.all_reduce_sum(bufs.tiny))
        self.last_dispatch_seconds = time.perf_counter() - t_start
        self.last_comm = {op: {k: rec[k] - comm0.get(op, {}).get(k, 0)
                               for k in ("calls", "bytes", "seconds")}
                          for op, rec in grid.comm.items()}
        if tracer.enabled:
            tracer.complete(f"issue {self.name}", "dispatch", t_start,
                            self.last_dispatch_seconds,
                            groups=len(plan.groups), n_devices=self.nd,
                            rank=self.rank)
        if clock is not None:
            # after the all-reduce: every event of the call has completed
            self.last_profile = self._kernel_spans(tracer, clock)
        cols = [(gl.gcol[:gl.kw], gl.gcol[gl.kw:gl.mc] - grp.w)
                for grp, gl in zip(plan.groups, self.layout.groups)]
        return fronts, tiny_total, Shard(
            grid=grid, nd=self.nd, rank=self.rank, pivots=pivots,
            nprow=grid.nprow, npcol=grid.npcol, cols=cols,
            pool_bytes=self.pool_bytes)

    def _issue_span(self, tracer, t0, lo, hi) -> None:
        """A unit's dispatch span: the host time its group (its wave)
        took, its collectives included."""
        grp, gl = self.plan.groups[lo], self.layout.groups[lo]
        if self.granularity == "group":
            tracer.complete(f"issue g{lo}", "dispatch", t0,
                            time.perf_counter() - t0, group=lo,
                            level=int(grp.level), owned=int(len(gl.slots)),
                            columns=int(gl.mc))
        else:
            tracer.complete(f"issue lvl{grp.level}", "dispatch", t0,
                            time.perf_counter() - t0, level=int(grp.level),
                            groups=hi - lo)

    def _kernel_spans(self, tracer, clock) -> list:
        """The call's kernel spans — one a group (a wave at "level") with
        this rank's ``owned`` slots, ``columns`` and ``local_flops``, then
        the aggregate ``factor-{name}`` — and their ``last_profile``
        entries."""
        plan, lay, prof = self.plan, self.layout.groups, []
        for t0, dt, unit in clock.read():
            if unit is None:
                tracer.complete(f"factor-{self.name}", "kernel", t0, dt,
                                n_groups=len(plan.groups), aggregate=True,
                                executed_flops=self.executed_flops,
                                local_flops=self.local_flops,
                                structural_flops=float(plan.flops))
                continue
            lo, hi = unit
            mine = dict(owned=sum(len(gl.slots) for gl in lay[lo:hi]),
                        columns=max(gl.mc for gl in lay[lo:hi]),
                        local_flops=sum(self.group_local_flops[lo:hi]))
            if self.granularity == "level":
                prof.append(wave_span(
                    tracer, t0, dt, plan.groups[lo:hi],
                    self.gemm_prec_resolved,
                    padded=[self._padded_batch(gi) for gi in range(lo, hi)],
                    **mine))
                continue
            g = plan.groups[lo]
            prof.append(kernel_span(
                tracer, t0, dt, level=g.level, b=self._padded_batch(lo),
                m=g.m, w=g.w, u=g.u, nreal=g.batch, host=False,
                gemm_prec=self.gemm_prec_resolved, **mine))
        return prof

    def report(self) -> dict:
        ex = self.last_comm.get("exchange", {})
        bc = self.last_comm.get("bcast_row", {})
        return {"executor": self.name, "granularity": self.granularity,
                "offload": self.offload,
                "offload_wait_s": self.last_offload_wait_seconds,
                "host_bytes": self.host_bytes,
                "host_levels": 0, "host_groups": 0,
                "nd": self.nd, "rank": self.rank,
                "nprow": self.grid.nprow, "npcol": self.grid.npcol,
                "backend": self.grid.backend,
                "pool_partition": self.pool_partition,
                "pool_bytes": self.pool_bytes,
                "pool_elems": self.layout.pool_elems,
                "owned_groups": sum(1 for gl in self.layout.groups
                                    if len(gl.slots) and gl.mc),
                "local_flops": self.local_flops,
                "executed_flops": self.executed_flops,
                "dispatch_s": self.last_dispatch_seconds,
                "exchange_bytes": ex.get("bytes", 0),
                "exchange_s": ex.get("seconds", 0.0),
                "exchanges": ex.get("calls", 0),
                "bcast_bytes": bc.get("bytes", 0),
                "bcast_s": bc.get("seconds", 0.0),
                "bcasts": bc.get("calls", 0)}


def _lap(timings, name, clock, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t = time.perf_counter()
    timings[name] = timings.get(name, 0.0) + t - clock
    return t
