"""Spawned ranks for the distributed drivers.

A process that holds a CUDA context must not fork a rank, so the peers of
a distributed run (parallel/pgssvx.py, parallel/recover.py) are started
with ``multiprocessing.get_context("spawn")``: each imports the package
afresh and runs :func:`peer_main` over its list of :class:`RankJob`\\ s,
one result record per job on a queue.  A peer of the host-collective
tier runs on the CPU (``device="cpu"``) and never touches ``torch.cuda``;
a rank of the mesh tier (``kind="mesh"``) joins a ``torch.distributed``
process group (``parallel/mhboot.boot``) and runs on its job's device —
the card when asked.  A peer's last record says whether a CUDA context
exists in it.  The caller runs rank 0 itself with :func:`run_job` (on the
card, or on the CPU), so the root's work and the peers' overlap as in a
real run.

Peers are daemons: if the caller dies or raises, they are terminated at
its exit instead of holding it in a join.  :func:`stop_peers` joins (or
terminates) them and reports what is left.
"""

from __future__ import annotations

import dataclasses
import os
import queue as queue_mod
import time

import numpy as np


@dataclasses.dataclass
class RankJob:
    """One distributed call a rank takes part in.

    ``kind`` is "pgssvx" (one call on a domain the rank joins with
    ``parallel/mhboot.attach_tree``), "mesh" (one ``pgssvx(grid=)`` call
    on an nprow × (n_ranks/nprow) grid on ``device``: the rank also joins
    the ``port``'s
    process group once — it stays up for the peer's later mesh jobs —
    with ``timeout_s``; ``gather`` all-gathers the fronts to slot order
    afterwards and holds the kernel against its plain version at the
    rank's shapes), "pgssvx_ft" (the
    recovery epoch loop, which forms its own domains), "mesh_trace" (the
    traced 2-D FACT and ``granularity="level"`` leg of a mesh rank,
    ``run_mesh_trace``, its trace at ``trace``) or "allreduce"
    (``ops`` allreduces of ``np.ones(4)`` on a joined domain: the failure
    detector's own scenarios).  ``a_source`` / ``b_source`` deal this
    rank's block rows (``parallel/recover.RowBlockSource`` /
    ``VectorBlockSource``).  ``env`` is set in the rank's environment
    before the job (a chaos spec for one rank); ``attach_s`` bounds the
    wait for the root's domain; ``reuse_lu`` hands the rank's handle from
    its previous job to this one (only the root has one); ``hold_s``
    keeps the rank alive that long after the job (a survivor that exited
    at once would be counted among the dead by a slower peer)."""

    kind: str
    name: str
    n_ranks: int
    options: object
    a_source: object
    b_source: object
    max_len: int = 4096
    env: dict = dataclasses.field(default_factory=dict)
    attach_s: float = 120.0
    reuse_lu: bool = False
    ops: int = 0
    hold_s: float = 0.0
    port: int = 0
    device: str = "cpu"
    gather: bool = False
    timeout_s: float = 600.0
    nprow: int = 1             # a mesh job's grid: nprow × n_ranks/nprow
    trace: str = ""            # a mesh_trace job's trace path ("%r": rank)


class GallerySystem:
    """A gallery matrix (its values times ``scale``) and a right-hand
    side B = A·X (X standard normal from ``seed``; ``nrhs`` None: one
    column) named, not held: each
    process builds them at first use, the same bits everywhere.  A
    rank's job then pickles to a few hundred bytes, so starting a peer
    does not wait on the pipe while the child imports the package to
    unpickle a matrix.  ``a_rows`` / ``b_rows`` are the block-row sources
    of ``parallel/recover`` (``RowBlockSource``' partition)."""

    def __init__(self, name: str, args=(), seed: int = 0, nrhs=None,
                 scale: float = 1.0):
        self.name, self.args = name, tuple(args)
        self.seed, self.nrhs, self.scale = int(seed), nrhs, float(scale)
        self._a = self._b = None

    def __getstate__(self):
        return {k: v for k, v in self.__dict__.items()
                if k not in ("_a", "_b")}

    def __setstate__(self, state):
        self.__dict__.update(state, _a=None, _b=None)

    def matrix(self):
        if self._a is None:
            from superlu_dist_tpu_torch.models import gallery
            a = getattr(gallery, self.name)(*self.args)
            if self.scale != 1.0:      # new values on the same pattern
                a = a.__class__(a.n_rows, a.n_cols, a.indptr, a.indices,
                                a.data * self.scale)
            self._a = a
        return self._a

    def rhs(self):
        if self._b is None:
            a = self.matrix()
            shape = (a.n_rows,) if self.nrhs is None else (a.n_rows,
                                                           self.nrhs)
            self._b = a.matvec(
                np.random.default_rng(self.seed).standard_normal(shape))
        return self._b

    def a_rows(self, n_ranks: int, rank: int):
        from superlu_dist_tpu_torch.parallel.recover import RowBlockSource
        return RowBlockSource(self.matrix())(n_ranks, rank)

    def b_rows(self, n_ranks: int, rank: int):
        from superlu_dist_tpu_torch.parallel.recover import VectorBlockSource
        return VectorBlockSource(self.rhs())(n_ranks, rank)


def run_job(job: RankJob, rank: int, device, lu=None) -> dict:
    """Run ``job`` as ``rank`` and return its record: x, info, the
    rank's lu_out, the wall seconds, the time (``time.time()``) the rank
    joined the domain and its longest heartbeat gap (with
    ``SLU_TPU_COMM_TIMEOUT_S`` armed), or ``error`` naming the exception
    a rank raised (a RankFailureError's dead ranks, op and call site under
    ``failure``)."""
    from superlu_dist_tpu_torch.parallel.mhboot import attach_tree
    from superlu_dist_tpu_torch.parallel.pgssvx import pgssvx
    from superlu_dist_tpu_torch.parallel.recover import pgssvx_ft
    from superlu_dist_tpu_torch.utils.errors import RankFailureError

    os.environ.update(job.env)
    rec = {"rank": rank, "name": job.name}
    lu_out = {}
    t0 = time.perf_counter()
    try:
        if job.kind == "allreduce":
            tc = attach_tree(job.name, job.n_ranks, rank,
                             max_len=job.max_len,
                             retries=max(int(job.attach_s / 0.05), 1),
                             delay=0.05)
            t0 = time.perf_counter()
            try:
                x = [tc.allreduce_sum_any(np.ones(4)) for _ in range(job.ops)]
                x, info = np.stack(x), 0
            finally:
                tc.close()
        elif job.kind == "pgssvx":
            tc = attach_tree(job.name, job.n_ranks, rank,
                             max_len=job.max_len,
                             retries=max(int(job.attach_s / 0.05), 1),
                             delay=0.05)
            rec["attached_at"] = time.time()
            t0 = time.perf_counter()
            try:
                x, info = pgssvx(tc, job.options,
                                 job.a_source(job.n_ranks, rank),
                                 job.b_source(job.n_ranks, rank),
                                 lu=lu if job.reuse_lu else None,
                                 lu_out=lu_out, device=device)
                det = tc._detector
                rec["beat_gap_s"] = (None if det is None
                                     else det.max_beat_gap_s)
            finally:
                tc.close()
        elif job.kind == "mesh":
            x, info = _run_mesh(job, rank, device, lu, rec, lu_out)
        elif job.kind == "mesh_trace":
            x, info = run_mesh_trace(job, rank, device, rec, lu_out)
        elif job.kind == "pgssvx_ft":
            x, info = pgssvx_ft(job.name, job.n_ranks, rank, job.options,
                                job.a_source, job.b_source,
                                max_len=job.max_len, lu_out=lu_out,
                                device=device)
        else:
            raise ValueError(f"unknown rank job kind {job.kind!r}")
        rec.update(x=x, info=info)
    except Exception as exc:
        rec["error"] = f"{type(exc).__name__}: {exc}"
        if isinstance(exc, RankFailureError):
            rec["failure"] = {"dead": exc.dead_ranks, "op": exc.op,
                              "site": exc.site}
    finally:
        for k in job.env:
            os.environ.pop(k, None)
    rec["seconds"] = time.perf_counter() - t0
    if job.hold_s:
        time.sleep(job.hold_s)
    rec["lu_out"] = lu_out
    return rec


#: the grids of this process's mesh jobs, per (port, nprow, ranks, device)
_GRIDS = {}


def _mesh_grid(job: RankJob, rank: int, device, rec: dict):
    """(TreeComm, ProcessGrid) of a mesh job's rank: the tree domain
    joined, the process group booted once per process (``backend`` and
    ``attached_at`` land on ``rec``), the grid of the job's shape."""
    import torch
    from superlu_dist_tpu_torch.parallel.grid import gridinit
    from superlu_dist_tpu_torch.parallel.mhboot import (attach_tree, boot,
                                                        rank_devices)
    mine = rank_devices(job.n_ranks, device)[rank]
    if mine.type == "cuda":           # the context, before any wait
        torch.cuda.set_device(mine)
        torch.empty(0, device=mine)
    # the tree domain first: a peer polls for it every 50 ms until rank 0
    # forms it, where a rendezvous client started early backs off for
    # seconds between its connection attempts
    tc = attach_tree(job.name, job.n_ranks, rank, max_len=job.max_len,
                     retries=max(int(job.attach_s / 0.05), 1), delay=0.05)
    try:
        booted = boot(job.n_ranks, rank, job.port, device=device,
                      timeout_s=job.timeout_s)
        rec["backend"] = booted.backend
        rec["attached_at"] = time.time()
        # one grid per shape for the process's mesh jobs: a later job on
        # the same grid finds the executors (and a graph executor's
        # captured segments) cached on a reused plan; its traffic records
        # start afresh each job
        key = (job.port, job.nprow, job.n_ranks, str(booted.device))
        grid = _GRIDS.get(key)
        if grid is None:
            grid = _GRIDS[key] = gridinit(job.nprow, job.n_ranks // job.nprow,
                                          device=booted.device, tc=tc)
        elif tc.rank != grid.rank or tc.n_ranks != grid.nproc:
            raise ValueError(f"TreeComm rank {tc.rank}/{tc.n_ranks} differs "
                             f"from grid rank {grid.rank}/{grid.nproc}")
        grid.comm.clear()
    except BaseException:
        tc.close()
        raise
    return tc, grid


def _run_mesh(job: RankJob, rank: int, device, lu, rec: dict,
              lu_out: dict):
    """One ``pgssvx(grid=)`` call as ``rank`` (run_job's "mesh" kind):
    the rank's share of the sharded factors (``shard``: groups, owned
    slots, front bytes, whether every group holds exactly the rank's own
    slots), its front_assemble, panel_lu and csr_spmv launches and, with
    ``job.gather``, its kernels against their plain versions at its own
    shapes land on ``rec``."""
    import torch
    from superlu_dist_tpu_torch.numeric import kernels
    from superlu_dist_tpu_torch.parallel.pgssvx import pgssvx
    from superlu_dist_tpu_torch.parallel.spmd import gather_fronts
    tc, grid = _mesh_grid(job, rank, device, rec)
    try:
        a_loc = job.a_source(job.n_ranks, rank)
        launches = dict(kernels.LAUNCHES)
        x, info = pgssvx(tc, job.options, a_loc,
                         job.b_source(job.n_ranks, rank),
                         lu=lu if job.reuse_lu else None, lu_out=lu_out,
                         grid=grid)
        if grid.device.type == "cuda":
            torch.cuda.synchronize(grid.device)
        rec["launches"] = (kernels.LAUNCHES["front_assemble"]
                           - launches["front_assemble"])
        rec["spmv_launches"] = (kernels.LAUNCHES["csr_spmv"]
                                - launches["csr_spmv"])
        rec["panel_launches"] = (kernels.LAUNCHES["panel_lu"]
                                 - launches["panel_lu"])
        num = lu_out["lu"].numeric
        rec["shard"] = shard_record(num, grid.nproc, grid.rank)
        if job.gather:
            rec["fronts"] = gather_fronts(num)
            rec["kernel_vs_plain"] = local_kernel_check(
                num.plan, grid, pool_partition=num.shard.cols is not None
                and num.executor.get("pool_partition", False),
                two_d=num.shard.cols is not None)
            rec["spmv_vs_plain"] = local_spmv_check(a_loc, grid)
        rec["comm"] = grid.comm_summary()
    finally:
        tc.close()
    return x, info


def _trace_summary(path: str) -> dict:
    """The kernel spans of a trace file: the per-step ``lu`` spans'
    count, device ms (each and summed), the fields every one carries,
    and the aggregates' names."""
    import json
    events = json.load(open(path))["traceEvents"]
    lu = [e for e in events
          if e["cat"] == "kernel" and e["name"].startswith("lu ")]
    keys = set.intersection(*[set(e.get("args", {})) for e in lu]) \
        if lu else set()
    return dict(spans=len(lu), ms=[e["dur"] / 1e3 for e in lu],
                sum_ms=sum(e["dur"] for e in lu) / 1e3,
                min_ms=min((e["dur"] for e in lu), default=0.0) / 1e3,
                fields=sorted(keys),
                aggregate=[e["args"]["aggregate"] for e in lu],
                owned=sum(e["args"].get("owned", 0) for e in lu),
                aggregates=[e["name"] for e in events
                            if e["cat"] == "kernel"
                            and not e["name"].startswith("lu ")])


def run_mesh_trace(job: RankJob, rank: int, device, rec: dict,
                   lu_out: dict):
    """One rank of a traced 2-D FACT and of ``granularity="level"`` on
    the grid (run_job's "mesh_trace" kind), on the job's system with
    ``job.options`` (the 2-D executor's): the analysis pgssvx runs
    (``root_analyze_bcast``), then

    1. ``numeric_factorize`` on the 2-D executor, untraced, then under a
       file ``Tracer`` at ``job.trace`` (``%r`` the rank): the walls, the
       kernel spans (``traced``), the launches;
    2. ``MeshStreamExecutor(granularity="level")`` called twice — its
       segments captured, then replayed under a tracer: its wave spans
       (``level_spans``), its fronts, pivot stacks and tiny count bit
       for bit the FACT's (``level_equal``), its report and launches;
    3. ``executor="fused"`` at the same size: its report (graphs);
    4. pgssvx FACTORED on the handle holding the level factors: x, info
       and the solve report (``lu_out``).

    Every trace file is removed once read."""
    import torch
    from superlu_dist_tpu_torch.numeric import kernels
    from superlu_dist_tpu_torch.numeric.factor import (NumericFactorization,
                                                       numeric_factorize)
    from superlu_dist_tpu_torch.obs import trace
    from superlu_dist_tpu_torch.parallel.mesh_stream import (
        MeshStreamExecutor)
    from superlu_dist_tpu_torch.parallel.pgssvx import (pgssvx,
                                                        root_analyze_bcast)
    from superlu_dist_tpu_torch.utils.options import (Fact, IterRefine,
                                                      resolve_factor_dtype)
    from superlu_dist_tpu_torch.utils.stats import Stats
    opts = job.options
    tc, grid = _mesh_grid(job, rank, device, rec)
    dev = grid.device
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def timed(fn, path=None):
        """fn() (under a file tracer at ``path``): its result, wall s,
        front_assemble launches and, traced, its kernel spans."""
        sync()
        before = kernels.LAUNCHES["front_assemble"]
        tracer = trace.Tracer(path) if path else None
        prev = trace.install(tracer) if tracer else None
        t0 = time.perf_counter()
        try:
            out = fn()
            sync()
        finally:
            wall = time.perf_counter() - t0
            if tracer:
                trace.install(prev)
                tracer.close()
        spans = None
        if tracer:
            spans = _trace_summary(path)
            for f in (tracer.path, tracer.jsonl_path):
                os.remove(f)
        return out, wall, kernels.LAUNCHES["front_assemble"] - before, spans

    path = job.trace.replace("%r", str(rank))
    try:
        a_loc = job.a_source(job.n_ranks, rank)
        lu, bvals = root_analyze_bcast(
            tc, dataclasses.replace(opts, iter_refine=IterRefine.NOREFINE),
            a_loc, Stats(), device=dev)
        lu.grid, lu.device = grid, dev
        dtype = resolve_factor_dtype(opts.factor_dtype, dev,
                                     np.iscomplexobj(bvals))
        kw = dict(dtype=dtype, grid=grid, gemm_prec=opts.gemm_prec,
                  pool_partition=opts.pool_partition)

        def fact(executor):
            return numeric_factorize(lu.plan, bvals, lu.anorm,
                                     executor=executor, **kw)
        _, rec["untraced_s"], rec["untraced_launches"], _ = timed(
            lambda: fact("stream"))
        ng, rec["traced_s"], rec["traced_launches"], rec["traced"] = timed(
            lambda: fact("stream"), path)
        rec["groups"] = len(lu.plan.groups)
        rec["owned_groups"] = ng.executor["owned_groups"]
        # the level leg: the capture, then the traced replay
        ex = MeshStreamExecutor(lu.plan, dtype, dev, grid,
                                gemm_prec=opts.gemm_prec,
                                pool_partition=opts.pool_partition,
                                granularity="level")
        real = torch.empty((), dtype=dtype).real.dtype
        thresh = torch.tensor(np.sqrt(torch.finfo(dtype).eps)
                              * max(lu.anorm, 1e-300), dtype=real)
        avals = torch.as_tensor(np.asarray(bvals)).to(dtype)
        _, rec["level_capture_s"], rec["level_capture_launches"], _ = timed(
            lambda: ex(avals, thresh))
        (fronts, tiny, shard), rec["level_s"], rec["level_launches"], \
            rec["level_spans"] = timed(lambda: ex(avals, thresh), path)
        rec["level_waves"] = len(ex.units())
        rec["level_equal"] = (
            len(fronts) == len(ng.fronts)
            and all(torch.equal(a, b) and torch.equal(c, d)
                    for (a, c), (b, d) in zip(fronts, ng.fronts))
            and all(torch.equal(p, q) for p, q in zip(shard.pivots,
                                                      ng.shard.pivots))
            and int(tiny) == ng.tiny_pivots)
        rec["level_report"] = ex.report()
        rec["level_profile"] = len(ex.last_profile or [])
        nf, rec["fused_s"], rec["fused_launches"], _ = timed(
            lambda: fact("fused"))
        rec["fused_report"] = nf.executor
        del nf, ng
        # the level factors solved and refined through pgssvx FACTORED
        lu.numeric = NumericFactorization(
            plan=lu.plan, fronts=fronts, tiny_pivots=int(tiny), dtype=dtype,
            gemm_prec=ex.gemm_prec, executor=ex.report(), shard=shard)
        lu.dev_solver = None
        x, info = pgssvx(tc, dataclasses.replace(opts, fact=Fact.FACTORED),
                         a_loc, job.b_source(job.n_ranks, rank), lu=lu,
                         lu_out=lu_out, grid=grid)
    finally:
        tc.close()
    return x, info


def local_kernel_check(plan, grid, groups: int = 2,
                       pool_partition: bool = False,
                       two_d: bool = False) -> list:
    """The front assembly on this rank's share of the ``groups`` groups
    with the most child pairs, on its device, against the plain version on
    the same seeded pool and values: one record per group (group, local
    batch, m, columns, pairs, bit for bit).  The share is the 1-D tier's
    (``spmd.local_plan``) or, with ``two_d``, the 2-D tier's column share
    (``layout2d.layout``, its own compacted pool with
    ``pool_partition``)."""
    import torch
    from superlu_dist_tpu_torch.numeric import factor, kernels
    gen = torch.Generator(device=grid.device).manual_seed(grid.rank)
    if two_d:
        from superlu_dist_tpu_torch.parallel.layout2d import layout
        from superlu_dist_tpu_torch.parallel.mesh_stream import share_maps
        lay = layout(plan, grid.nprow, grid.npcol, grid.rank,
                     pool_partition)
        shares = [gl.maps for gl in lay.groups]
        live = [i for i, gl in enumerate(lay.groups)
                if len(gl.slots) and gl.mc]
        maps = {i: share_maps(lay.groups[i], grid.device) for i in live}
        pool_len = lay.pool_len
    else:
        from superlu_dist_tpu_torch.parallel.spmd import local_plan
        share = local_plan(plan, grid.nproc, grid.rank)
        shares = share.groups
        maps = dict(enumerate(factor.upload_maps(share, grid.device)))
        live = [i for i in maps if shares[i].batch]
        pool_len = plan.pool_size
    order = sorted(live, key=lambda i: -maps[i].front.pairs)
    pool = torch.randn(pool_len, generator=gen, device=grid.device)
    avals = torch.randn(len(plan.pattern_indices), generator=gen,
                        device=grid.device)
    out = []
    for gi in order[:groups]:
        g = shares[gi]
        f1 = kernels.front_assemble_(avals, pool, g.m, g.w, maps[gi])
        f2 = kernels.front_assemble_plain(avals, pool, g.m, g.w, maps[gi])
        out.append({"group": gi, "batch": g.batch, "m": g.m,
                    "mc": maps[gi].front.mc, "pairs": maps[gi].front.pairs,
                    "equal": bool(torch.equal(f1, f2))})
    return out


def local_spmv_check(a_loc, grid) -> dict:
    """The residual SpMV on this rank's block rows at the refinement's
    shape (float64 or complex128, one column), on its device, against
    the plain version on the same seeded x: rows, nnz, bit for bit."""
    import torch
    from superlu_dist_tpu_torch.parallel.dist import csr_spmv, csr_spmv_plain

    def put(arr):
        return torch.as_tensor(np.ascontiguousarray(arr), device=grid.device)
    vals = np.asarray(a_loc.data)
    v = put(vals.astype(np.result_type(vals.dtype, np.float64)))
    gen = torch.Generator(device=grid.device).manual_seed(grid.rank)
    x = torch.randn((a_loc.n, 1), generator=gen, dtype=v.dtype,
                    device=grid.device)
    ip, ix = put(a_loc.indptr.astype(np.int64)), put(
        a_loc.indices.astype(np.int64))
    max_row = int(np.diff(a_loc.indptr).max(initial=0))
    y1 = csr_spmv(ip, ix, v, x, max_row)
    y2 = csr_spmv_plain(ip, ix, v, x, max_row)
    return {"rows": a_loc.m_loc, "nnz": a_loc.nnz_loc,
            "equal": bool(torch.equal(y1, y2))}


def shard_record(numeric, nd: int, rank: int) -> dict:
    """What a rank holds of a sharded factorization: per group exactly
    its own slots (``own_slots_only``: ``rank, rank + nd, ...`` on the
    1-D tier, its process row's on the 2-D tier, and there only its own
    columns — ``own_cols_only``), their panel bytes and flops, the pivot
    stacks' bytes, the groups where it assembles (a slot, and on the 2-D
    tier a column), on the 2-D tier its pool, and whether its factors
    were offloaded to host memory."""
    shard = numeric.shard
    groups = numeric.plan.groups
    two_d = shard is not None and shard.cols is not None
    if two_d:
        from superlu_dist_tpu_torch.parallel.layout2d import front_cols
        slots = [shard.slots(g.batch) for g in groups]
        own = [front_cols(g.m, g.w, shard.npcol, rank % shard.npcol)
               for g in groups]
        cols_ok = all(
            np.array_equal(pc, gcol[:int(np.searchsorted(gcol, g.w))])
            and np.array_equal(uc + g.w, gcol[len(pc):mc])
            and lp.shape[2] == len(pc) and up.shape[2] == len(uc)
            for g, (pc, uc), (_, _, gcol, mc), (lp, up)
            in zip(groups, shard.cols, own, numeric.fronts))
        assembled = sum(1 for s, o in zip(slots, own) if len(s) and o[3])
    else:
        slots = [np.arange(rank, g.batch, nd) for g in groups]
        cols_ok = True
        assembled = sum(1 for g in groups if rank < g.batch)
    held = all(lp.shape[0] == len(s) and up.shape[0] == lp.shape[0]
               for s, (lp, up) in zip(slots, numeric.fronts))
    fb = sum(lp.numel() * lp.element_size() + up.numel() * up.element_size()
             for lp, up in numeric.fronts)
    return {"groups": len(numeric.fronts),
            "owned_groups": assembled,
            "owned_slots": int(sum(len(s) for s in slots)),
            "front_bytes": fb,
            "local_flops": numeric.executor.get("local_flops"),
            "pivot_bytes": shard.pivot_bytes if shard is not None else 0,
            "pool_bytes": shard.pool_bytes if two_d else None,
            "own_slots_only": bool(held),
            "own_cols_only": bool(cols_ok),
            "on_host": bool(numeric.on_host)}


def _shippable(rec: dict) -> dict:
    """A peer's record without its handle and gathered fronts (factors
    never leave a rank): lu_out keeps the report, the summary, the
    timings and the recovery facts."""
    out = {k: v for k, v in rec.items() if k != "fronts"}
    lu_out = rec.get("lu_out", {})
    out["lu_out"] = {k: lu_out[k] for k in (
        "solve_report", "stats_summary", "timings", "ft_events",
        "recovered") if k in lu_out}
    return out


def peer_main(rank: int, jobs: list, results) -> None:
    """A spawned peer's entry point: run ``jobs`` in order as ``rank`` —
    on the CPU, a mesh job on its ``device`` — putting one record per job
    on ``results``, then a last record ``{"rank", "done": True,
    "cuda_initialized", "started_at"}``; a process group a mesh job
    joined is left at the end."""
    started = time.time()
    import torch
    from superlu_dist_tpu_torch.parallel.mhboot import shutdown
    lu = None
    try:
        for i, job in enumerate(jobs):
            rec = run_job(job, rank, job.device if job.kind in (
                "mesh", "mesh_trace") else "cpu", lu=lu)
            lu = rec["lu_out"].get("lu", lu)
            rec["job"] = i
            results.put(_shippable(rec))
    finally:
        shutdown()
    results.put({"rank": rank, "done": True, "started_at": started,
                 "cuda_initialized": bool(torch.cuda.is_initialized())})


def run_thread_ranks(name: str, n_ranks: int, fn, max_len: int = 64,
                     classes=None, timeout: float = 60.0) -> dict:
    """Run ``fn(tc)`` on ``n_ranks`` thread ranks of a fresh domain
    ``name`` (rank 0 creates it before the others attach; ctypes releases
    the GIL in every native leg, so the threads run the collectives
    concurrently); returns {rank: result, or the exception it raised}.
    ``classes`` picks a rank's communicator class ({rank: class}, default
    ``TreeComm``: a JAX-package TreeComm joins the same domain).  Raises
    TimeoutError when a rank is still running after ``timeout``."""
    import threading
    from superlu_dist_tpu_torch.parallel.treecomm import TreeComm
    classes = classes or {}
    comms = [classes.get(r, TreeComm)(name, n_ranks, r, max_len=max_len,
                                      create=r == 0)
             for r in range(n_ranks)]
    out = {}

    def go(r):
        try:
            out[r] = fn(comms[r])
        except Exception as exc:      # handed to the caller
            out[r] = exc

    threads = [threading.Thread(target=go, args=(r,), daemon=True)
               for r in range(n_ranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    hung = [r for r, t in enumerate(threads) if t.is_alive()]
    if hung:
        raise TimeoutError(f"thread ranks {hung} still running after "
                           f"{timeout} s")
    for tc in comms[::-1]:
        tc.close()
    return out


def spawn_peers(jobs_by_rank: dict):
    """Start one spawned daemon process per rank of ``jobs_by_rank``
    ({rank: [RankJob, ...]}); returns (processes, results queue, the
    ``time.time()`` of the spawn)."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    spawned_at = time.time()
    procs = {}
    for rank, jobs in sorted(jobs_by_rank.items()):
        p = ctx.Process(target=peer_main, args=(rank, jobs, results),
                        name=f"slu-peer-r{rank}", daemon=True)
        p.start()
        procs[rank] = p
    return procs, results, spawned_at


def collect(results, want: int, timeout: float, procs=None) -> list:
    """``want`` records from ``results`` within ``timeout`` seconds;
    raises TimeoutError (naming the peers that died) when they do not
    all arrive."""
    out = []
    deadline = time.monotonic() + timeout
    while len(out) < want:
        left = deadline - time.monotonic()
        try:
            out.append(results.get(timeout=max(min(left, 5.0), 0.01)))
        except queue_mod.Empty:
            dead = {r: p.exitcode for r, p in (procs or {}).items()
                    if not p.is_alive()}
            if left <= 0:
                raise TimeoutError(
                    f"{len(out)} of {want} rank records in {timeout} s; "
                    f"exited peers: {dead}") from None
    return out


def stop_peers(procs: dict, timeout: float = 30.0) -> dict:
    """Join every peer (terminating one that outlives ``timeout``);
    returns {rank: exit code}."""
    deadline = time.monotonic() + timeout
    for p in procs.values():
        p.join(max(deadline - time.monotonic(), 0.1))
    for p in procs.values():
        if p.is_alive():
            p.terminate()
            p.join(5.0)
    return {r: p.exitcode for r, p in procs.items()}


def mesh_main(rank: int, nd: int, port: int, shm: str, fn, args,
              device, results, max_len: int, timeout_s: float,
              env: dict, nprow: int = 1) -> None:
    """A spawned mesh rank's entry point (``run_mesh_ranks``): join the
    process group and the tree domain, build the nprow × (nd/nprow) grid
    on ``device``
    and put ``{"rank", "out": fn(tc, grid, *args)}`` — or ``"error"``,
    the traceback — on ``results``."""
    import traceback
    os.environ.update(env or {})
    rec = {"rank": rank}
    tc = None
    from superlu_dist_tpu_torch.parallel.mhboot import (attach_tree, boot,
                                                        shutdown)
    try:
        tc = attach_tree(shm, nd, rank, max_len=max_len, retries=2400,
                         delay=0.05)
        booted = boot(nd, rank, port, device=device, timeout_s=timeout_s)
        from superlu_dist_tpu_torch.parallel.grid import gridinit
        grid = gridinit(nprow, nd // nprow, device=booted.device, tc=tc)
        rec["backend"] = booted.backend
        rec["out"] = fn(tc, grid, *args)
    except Exception:
        rec["error"] = traceback.format_exc()
    finally:
        if tc is not None:
            tc.close()
        shutdown()
    results.put(rec)


def free_port() -> int:
    """A free TCP port on localhost for a process group's rendezvous."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_mesh_ranks(nd: int, fn, *args, device="cpu", timeout: float = 300.0,
                   max_len: int = 1 << 14, env: dict | None = None,
                   timeout_s: float = 120.0, nprow: int = 1) -> dict:
    """Run ``fn(tc, grid, *args)`` on ``nd`` spawned mesh ranks of an
    nprow × (nd/nprow) grid (a gloo process group on the CPU; ``device``
    as ``parallel/mhboot.boot`` takes it) and return {rank: fn's result}.
    ``fn`` must be importable by name in the children.  Raises
    RuntimeError naming every rank that raised, TimeoutError when a rank
    does not report in ``timeout``."""
    if nd % nprow:
        raise ValueError(f"{nd} ranks do not fill {nprow} process rows")
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    shm = f"/slt_mesh_{os.getpid()}_{port}"
    procs = {r: ctx.Process(target=mesh_main,
                            args=(r, nd, port, shm, fn, args, device,
                                  results, max_len, timeout_s, env, nprow),
                            name=f"slu-mesh-r{r}", daemon=True)
             for r in range(nd)}
    for p in procs.values():
        p.start()
    try:
        recs = collect(results, nd, timeout, procs)
    finally:
        stop_peers(procs)
    errors = {r["rank"]: r["error"] for r in recs if "error" in r}
    if errors:
        raise RuntimeError("mesh ranks failed:\n" + "\n".join(
            f"rank {r}:\n{e}" for r, e in sorted(errors.items())))
    return {r["rank"]: r["out"] for r in recs}
