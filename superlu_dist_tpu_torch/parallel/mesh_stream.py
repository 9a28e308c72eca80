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

import functools
import time

import numpy as np
import torch

from superlu_dist_tpu_torch.numeric.plan import PlanRef
from superlu_dist_tpu_torch.obs.kernelspans import (KernelClock, kernel_span,
                                                    wave_span)
from superlu_dist_tpu_torch.obs.trace import get_tracer
from superlu_dist_tpu_torch.ops.dense import panel_width
from superlu_dist_tpu_torch.parallel.layout2d import (expand, front_cols,
                                                      layout)
from superlu_dist_tpu_torch.utils.programaudit import maybe_audit


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
    elements go out) and the group's layout, whose counts it takes (or
    anything with ``send.total``, ``send_counts`` and ``recv_counts``:
    the grid's mega executor's padded counts)."""

    __slots__ = ("send", "gl")

    def __init__(self, send, gl):
        self.send, self.gl = send, gl


def _own(t: torch.Tensor) -> torch.Tensor:
    """Front columns ``t`` (a slice of the front) in a storage of their
    own size: ``contiguous()`` returns a slice that already is one — an
    empty one always, the leading rows of the front at one slot — as a
    view, which would keep the whole front on the card beside the
    factors (a rank with none of a group's pivot columns)."""
    t = t.contiguous()
    if t.untyped_storage().nbytes() > t.numel() * t.element_size():
        t = t.clone()
    return t


def run_request(grid, dtype, req, out=None):
    """One request of a group program, run on ``grid``: a panel broadcast
    over the process row or the exchange (into ``out`` when given)."""
    if isinstance(req, Exchange):
        gl = req.gl
        return grid.exchange(req.send[:gl.send.total], gl.send_counts,
                             gl.recv_counts, out=out)
    t, owner, shape = req
    return grid.bcast_row(t, owner, shape, dtype, out=out)


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
    from this rank's share); "auto" does so when
    ``numeric/stream.offload_rule`` says so — with ``front_bytes_limit``
    None when the ranks on any one card would hold more than it has room
    for (:meth:`device_estimate`, summed over the ranks that share it;
    decided by the grid together; where offloaded they would not fit
    either, every rank raises ``DeviceMemoryError``), with a number when
    the plan's padded front bytes exceed it, on any device on a grid;
    "none" keeps them on the device.

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

    plan = PlanRef()     # the plan owns its executors (plan.PlanRef)

    name = "mesh-stream"
    #: whether the shares can go to host memory (the grid's fused graphs'
    #: cannot: the card's rule refuses them where they do not fit)
    offloads = True

    def __new__(cls, *args, granularity="group", **kw):
        if cls is MeshStreamExecutor and granularity == "level":
            from superlu_dist_tpu_torch.parallel.mesh_graphs import (
                MeshLevelExecutor)
            cls = MeshLevelExecutor
        return super().__new__(cls)

    def __init__(self, plan, dtype, device, grid, gemm_prec=None,
                 scatter=None, pool_partition=False, offload="none",
                 front_bytes_limit=None, offload_lag=8, panel=None,
                 granularity="group"):
        from superlu_dist_tpu_torch.numeric import factor
        from superlu_dist_tpu_torch.numeric.stream import (check_offload,
                                                           offload_rule)
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
        self.offload_lag = int(offload_lag)
        self.offload_rule = {"rule": "given"}
        if offload == "auto":
            offload, self.offload_rule = offload_rule(
                plan, dtype, device, front_bytes_limit, grid=grid,
                estimate=self.device_estimate, executor=self.name,
                offloads=self.offloads)
        self.offload = check_offload(offload)
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
        self._submitted = set()    # group programs submitted to the audits
        # the retrace sentinel's state (numeric/stream.retrace_end): the
        # segment graphs captured (the graph executors), a call ended
        self.captures = 0
        self.sentinel_warm = False
        self.last_kernel_builds = self.last_retraces = 0

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
        total = st["send"]["total"]
        if total and flat.numel():
            send = flat[expand(st["send"], total, dev)[0]]
        else:
            # nothing to send, or (the grid's mega executor, a rank with
            # no slots) only a padded leg's filler
            send = a.new_zeros(total)
        # the exchange's counts: the group's own, or the padded ones its
        # state carries (the grid's mega executor: one per group shape)
        got = yield Exchange(send, st.get("xchg") or gl)
        piv = torch.empty(st["piv_len"], dtype=self.dtype, device=dev)
        _put(piv, st["piv"], got, st["self_piv"], flat, dev)
        _put(bufs.pool, st["pool"], got, st["self_pool"], flat, dev)
        out = (_own(a[:, :m, :gl.kw]), _own(a[:, :w, gl.kw:gl.mc]), piv)
        self._lap("exchange", clock)
        return out

    def _collective(self, req, out=None):
        """One request of a group program, run now (``run_request``)."""
        return run_request(self.grid, self.dtype, req, out)

    def _program(self, gi, st, bufs, grid):
        """Group ``gi``'s program driven to its end on ``grid`` — what the
        runtime audits walk (a recording stand-in for the grid there)."""
        return drive(self._group(gi, st, bufs),
                     functools.partial(run_request, grid, self.dtype))

    def _audit_group(self, gi, st, bufs) -> None:
        """Submit group ``gi``'s program on state ``st`` to the runtime
        audits (utils/programaudit.py) before it first runs — once per
        group, every rank in the same order (an audited grid program
        ends with one exchange over the grid)."""
        if gi in self._submitted:
            return
        self._submitted.add(gi)
        grp = self.plan.groups[gi]
        maybe_audit(f"{self.name}._group",
                    f"g{gi} lu b{st['rows']} m{grp.m} w{grp.w} u{grp.u} "
                    f"{str(self.dtype).replace('torch.', '')} "
                    f"{self.gemm_prec}",
                    functools.partial(self._program, gi),
                    (st, bufs, self.grid))

    def device_estimate(self) -> dict:
        """``numeric/stream.offload_estimate`` for this rank's share: its
        pool of :meth:`_pool_len` elements, and per group what it keeps
        and its program's working set (:meth:`share_parts`), its
        solver's copy (:meth:`solve_copy_bytes`) and the plan's maps,
        which bound its shares of them.  Ranks on cards of their own
        are each held to their own card's budget (``offload_rule``)."""
        from superlu_dist_tpu_torch.numeric.stream import offload_estimate
        return offload_estimate(self.plan, self.dtype,
                                pool_len=self._pool_len(),
                                lag=self.offload_lag,
                                share=self._share())

    def _share(self) -> tuple:
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        kept, work = self.share_parts(itemsize)
        return kept, work, self.solve_copy_bytes(itemsize)

    def share_parts(self, itemsize: int) -> tuple:
        """(per group the bytes this rank keeps — its own L and U12
        columns and the group's pivot stack —, per group its program's
        working set: the assembled column share and its padded copy,
        beside the larger of a trailing update's product with the panel
        broadcast, and the exchange's legs with the int64 indices that
        expand them — six an element at most at once — and the pivot
        stack)."""
        kept = [n * itemsize for n in self.offload_sizes()]
        work = []
        rows = self._rows()
        for gi, (g, gl, (snd, got)) in enumerate(zip(
                self.plan.groups, self.layout.groups,
                self.exchange_counts())):
            c = rows[gi]
            front = c * g.m * gl.mc
            ext = c * gl.m_ext * gl.mc_ext
            pad = ext if ext > front else 0
            bcast = c * gl.m_ext * panel_width(g.w)[0]
            moved = int(np.sum(snd)) + int(np.sum(got))
            work.append(itemsize * (front + pad) + max(
                itemsize * (ext + bcast),
                (itemsize + 48) * moved + itemsize * g.batch * g.w * g.w))
        return kept, work

    def solve_copy_bytes(self, itemsize: int) -> int:
        """Device bytes of the grid solver's copy on this rank
        (parallel/spmd.SpmdSolver on the 2-D tier): per sweep batch of
        the default solve plan the whole pivot stack and its process
        row's members' own L21 and U12 columns, padded to the widest;
        beside them the larger of the largest batch once more (its parts
        before their concatenation, while the copy is built) and a
        sweep's padded product: where this rank has one member of a
        batch of several, its panel is multiplied as two slots
        (``spmd._matmul``), a copy of two panels beside the zero slot it
        is made of."""
        from superlu_dist_tpu_torch.solve.plan import build_solve_plan
        lay, npr, prow = self.layout.groups, self.grid.nprow, self.grid.prow
        sizes, padded = [], 0
        for sg in build_solve_plan(self.plan).groups:
            src_g = np.asarray(sg.src_group, dtype=np.int64)
            mine = src_g[np.asarray(sg.src_slot) % npr == prow]
            kw = max((lay[g].kw for g in mine), default=0)
            ku = max((lay[g].mc - lay[g].kw for g in mine), default=0)
            sizes.append(itemsize * (sg.batch * (sg.w * sg.w + 1)
                                     + len(mine) * (sg.u * kw + sg.w * ku)))
            if len(mine) == 1 and sg.batch > 1:
                padded = max(padded,
                             3 * itemsize * max(sg.u * kw, sg.w * ku))
        return sum(sizes) + max(max(sizes, default=0), padded)

    def exchange_counts(self) -> list:
        """Per group, the (send, receive) counts by peer rank of the
        exchange this rank's programs issue: the group's own (the grid's
        mega executor pads them)."""
        return [(gl.send_counts, gl.recv_counts) for gl in self.layout.groups]

    def _rows(self) -> list:
        """Local slots per group in this executor's programs."""
        return [len(gl.slots) for gl in self.layout.groups]

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
        st = self._device_state()[gi]
        self._audit_group(gi, st, bufs)
        return self._finish(gi, *drive(self._group(gi, st, bufs),
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
                                                           progress_wave,
                                                           retrace_end)
        from superlu_dist_tpu_torch.parallel.spmd import Shard
        if self.checkpoint is not None or self.resume is not None:
            raise ValueError(f"the {self.name} executor takes no checkpoint "
                             f"or resume: the pool is the ranks' joint state")
        plan, dev, grid = self.plan, self.device, self.grid
        self._begin(timings)
        builds0 = self.captures
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
        retrace_end(self, builds0,
                    f"{type(self).__name__}[{self.granularity}]")
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
                "offload_rule": dict(self.offload_rule),
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
