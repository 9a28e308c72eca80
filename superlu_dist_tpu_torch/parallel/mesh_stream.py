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
boundary.

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

from superlu_dist_tpu_torch.obs.trace import get_tracer
from superlu_dist_tpu_torch.ops.dense import panel_width
from superlu_dist_tpu_torch.parallel.layout2d import (expand, front_cols,
                                                      layout)


def share_maps(gl, device) -> object:
    """The device maps of one group share (``layout2d.GroupLayout``): the
    plain version's (``kernels.GroupMaps`` with ``gcol``) and the
    kernel's (``kernels.FrontMaps`` of the column share)."""
    from superlu_dist_tpu_torch.numeric import kernels
    sm = gl.maps

    def put(x):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.int64),
                               device=device)
    children = [(ub, put(off), put(slot), put(rel), put(crel), put(stride))
                for ub, off, slot, rel, crel, stride in sm.children]
    front = kernels.build_front_maps(
        sm.batch, sm.m, sm.pool_len,
        a=(sm.a_slot, sm.a_flat_global, sm.a_src),
        children=[tuple(np.asarray(x) if i else x for i, x in enumerate(c))
                  for c in sm.children],
        device=device, cols=sm.own, share=sm.share)
    return kernels.GroupMaps(
        ws=put(sm.ws), off=put(np.zeros(sm.batch)), a_slot=put(sm.a_slot),
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


class MeshStreamExecutor:
    """The factorization of ``plan`` on this rank of an nprow × npcol
    ``grid`` (module docstring).

    ``ex(avals, thresh, timings=None)`` returns (this rank's fronts, the
    tiny count summed over the grid, a ``spmd.Shard`` carrying the column
    layout).  ``deadline`` and ``chaos`` are per-call hooks; checkpoints
    and resume have no place here (the pool is the ranks' joint
    state)."""

    name = "mesh-stream"

    def __init__(self, plan, dtype, device, grid, gemm_prec=None,
                 scatter=None, pool_partition=False):
        from superlu_dist_tpu_torch.numeric import factor
        from superlu_dist_tpu_torch.ops.dense import gemm_precision
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
        self.gemm_prec = gemm_precision(gemm_prec)
        self.scatter = factor.KERNELS if scatter is None else scatter
        self.layout = layout(plan, grid.nprow, grid.npcol, grid.rank,
                             self.pool_partition)
        # the operations of panel_partial_factor, counted exactly: this
        # rank's (its slots, its panels, its columns) and the grid's
        self.local_flops = float(sum(
            len(gl.slots) * share_ops(g.w, gl.m_ext, gl.gcol, grid.npcol,
                                      grid.pcol)
            for g, gl in zip(plan.groups, self.layout.groups)))
        self.executed_flops = float(sum(
            g.batch * share_ops(g.w, *front_cols(g.m, g.w, grid.npcol,
                                                 pc)[1:3], grid.npcol, pc)
            for g in plan.groups for pc in range(grid.npcol)))
        self.deadline = self.chaos = None
        self.checkpoint = self.resume = None
        self.offload, self.host_levels = "none", 0
        self.last_dispatch_seconds = 0.0
        self.last_comm = {}
        self._dev = None

    def _device_state(self):
        """Per group on the device, built at the first call: the share's
        maps, its slots' real pivot widths and the exchange's segments."""
        if self._dev is None:
            dev = self.device
            self._dev = [dict(maps=share_maps(gl, dev)
                              if len(gl.slots) and gl.mc else None,
                              ws=torch.as_tensor(gl.maps.ws, device=dev),
                              send=_segments(gl.send, dev),
                              piv=_segments(gl.recv_piv, dev),
                              pool=_segments(gl.recv_pool, dev),
                              self_piv=[_segments(x, dev)
                                        for x in gl.self_piv],
                              self_pool=[_segments(x, dev)
                                         for x in gl.self_pool])
                         for gl in self.layout.groups]
        return self._dev

    @property
    def pool_bytes(self) -> int:
        return self.layout.pool_len * torch.empty(
            (), dtype=self.dtype).element_size()

    def _exchange(self, gl, st, a, grp, pool):
        """Group ``grp``'s exchange (module docstring, step 3): writes the
        received Schur columns into ``pool`` and returns the (B, w, w)
        pivot stack.  This rank's own leg is copied on the device."""
        dev, w = self.device, grp.w
        flat = a.reshape(-1)
        send = flat[expand(st["send"], gl.send.total, dev)[0]] \
            if gl.send.total else a.new_empty(0)
        got = self.grid.exchange(send, gl.send_counts, gl.recv_counts)
        piv = torch.empty((grp.batch, w, w), dtype=self.dtype, device=dev)
        _put(piv.view(-1), st["piv"], got, st["self_piv"], flat, dev)
        _put(pool, st["pool"], got, st["self_pool"], flat, dev)
        return piv

    def __call__(self, avals, thresh, timings=None):
        from superlu_dist_tpu_torch.ops.dense import panel_partial_factor
        from superlu_dist_tpu_torch.parallel.spmd import Shard
        if self.checkpoint is not None or self.resume is not None:
            raise ValueError("the 2-D mesh executor takes no checkpoint or "
                             "resume: the pool is the ranks' joint state")
        plan, dev, grid = self.plan, self.device, self.grid
        states = self._device_state()
        avals = avals.to(device=dev, dtype=self.dtype)
        thresh = thresh.to(dev)
        pool = torch.zeros(self.layout.pool_len, dtype=self.dtype,
                           device=dev)
        tiny = torch.zeros((), dtype=torch.int64, device=dev)
        fronts, pivots = [], []
        comm0 = {op: dict(rec) for op, rec in grid.comm.items()}
        tracer = get_tracer()
        t_start = time.perf_counter()

        def bcast(t, owner, shape):
            return grid.bcast_row(t, owner, shape, self.dtype)

        for gi, (grp, gl, st) in enumerate(zip(plan.groups,
                                               self.layout.groups, states)):
            if self.deadline is not None:
                self.deadline.poll(where="numeric factorization (mesh)")
            w, m = grp.w, grp.m
            c = len(gl.slots)
            if tracer.enabled:
                t0 = time.perf_counter()
            clock = time.perf_counter()
            if c and gl.mc:
                f = self.scatter(avals, pool, m, w, st["maps"]).view(
                    c, m, gl.mc)
            else:
                f = torch.zeros((c, m, gl.mc), dtype=self.dtype, device=dev)
            a = f
            if gl.m_ext > m or gl.mc_ext > gl.mc:
                a = torch.nn.functional.pad(
                    f, (0, gl.mc_ext - gl.mc, 0, gl.m_ext - m))
            if timings is not None:
                clock = _lap(timings, "front_assemble", clock, dev)
            if c:
                flags = panel_partial_factor(
                    a, thresh, w, gl.gcol, grid.npcol, grid.pcol, bcast,
                    self.gemm_prec)
                # identity-padding columns are unit pivots (group_step)
                real = torch.arange(w, device=dev)[None, :] \
                    < st["ws"][:, None]
                tiny += torch.where(real, flags, 0).sum()
            if timings is not None:
                clock = _lap(timings, "partial_factor", clock, dev)
            pivots.append(self._exchange(gl, st, a, grp, pool))
            fronts.append((a[:, :m, :gl.kw].contiguous(),
                           a[:, :w, gl.kw:gl.mc].contiguous()))
            del a, f
            if timings is not None:
                clock = _lap(timings, "exchange", clock, dev)
            if tracer.enabled:
                tracer.complete(f"issue g{gi}", "dispatch", t0,
                                time.perf_counter() - t0, group=gi,
                                level=int(grp.level), owned=int(c),
                                columns=int(gl.mc))
            if self.chaos is not None:
                self.chaos.on_group(gi)
        tiny_total = int(grid.all_reduce_sum(tiny))
        self.last_dispatch_seconds = time.perf_counter() - t_start
        self.last_comm = {op: {k: rec[k] - comm0.get(op, {}).get(k, 0)
                               for k in ("calls", "bytes", "seconds")}
                          for op, rec in grid.comm.items()}
        if tracer.enabled:
            tracer.complete("issue mesh-stream", "dispatch", t_start,
                            self.last_dispatch_seconds,
                            groups=len(plan.groups), n_devices=self.nd,
                            rank=self.rank)
            if tracer.profiling:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                tracer.complete("factor-mesh-stream", "kernel", t_start,
                                time.perf_counter() - t_start,
                                n_groups=len(plan.groups), aggregate=True,
                                executed_flops=self.executed_flops,
                                local_flops=self.local_flops,
                                structural_flops=float(plan.flops))
        cols = [(gl.gcol[:gl.kw], gl.gcol[gl.kw:gl.mc] - grp.w)
                for grp, gl in zip(plan.groups, self.layout.groups)]
        return fronts, tiny_total, Shard(
            grid=grid, nd=self.nd, rank=self.rank, pivots=pivots,
            nprow=grid.nprow, npcol=grid.npcol, cols=cols,
            pool_bytes=self.pool_bytes)

    def report(self) -> dict:
        ex = self.last_comm.get("exchange", {})
        bc = self.last_comm.get("bcast_row", {})
        return {"executor": self.name, "granularity": "group",
                "offload": "none", "host_levels": 0, "host_groups": 0,
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
