"""Multifrontal numeric factorization on the device.

Port of the JAX package's ``numeric/factor.py``: the per-group step
(``group_step``: the front assembly — identity padding, A entries and the
extend-add of every child set, one kernel launch:
``kernels.front_assemble_`` — the batched blocked partial LU with GESP
tiny-pivot replacement, and the Schur write-back to the update pool), the
factorization record, and the executor choice (``get_executor``):

* ``stream`` (numeric/stream.py) — the group loop issued from the host,
  with host offload of the factors, the host-share split and level
  waves; the auto choice on the card;
* ``fused`` (numeric/fused.py) — the whole group loop as one CUDA graph,
  captured at the first call and replayed for each new set of values;
  the auto choice on the CPU, where it is the same loop run eagerly;
* ``mega`` (numeric/mega.py) — one CUDA graph per closed shape bucket,
  fed per group through static, rung-padded tables;
* on a grid of several ranks, ``spmd`` (parallel/spmd.py: each rank its
  own slots) or the 2-D mesh stream (parallel/mesh_stream.py: slots over
  the process rows, each front's columns over the process columns, the
  Schur pool partitioned with ``pool_partition``).

Where the JAX version returns new arrays, this one updates the pool in
place: each group's front batch is built once by the assembly, the
partial LU factors it in place, and the Schur block is copied into the
pool.  So a checkpoint (persist/checkpoint.py) copies the pool only at a
group boundary, from inside the loop.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from superlu_dist_tpu_torch.numeric import kernels
from superlu_dist_tpu_torch.numeric.kernels import GroupMaps
from superlu_dist_tpu_torch.numeric.plan import FactorPlan
from superlu_dist_tpu_torch.obs.trace import get_tracer
from superlu_dist_tpu_torch.ops.dense import (gemm_precision,
                                              group_partial_factor)
from superlu_dist_tpu_torch.testing.chaos import get_chaos
from superlu_dist_tpu_torch.utils.errors import NumericBreakdownError
from superlu_dist_tpu_torch.utils.options import EXECUTORS, resolve_device

#: the front assembly the main path runs; a caller may pass the plain
#: version instead to hold the kernel against it on the card
KERNELS = kernels.front_assemble_
PLAIN = kernels.front_assemble_plain
#: the executors whose callables hold captured CUDA graphs on the card
GRAPH_EXECUTORS = ("fused", "mega")
#: the executors of a grid of several ranks (one is kept per device)
MESH_EXECUTORS = ("spmd", "mesh-stream")


def upload_maps(plan: FactorPlan, device: torch.device) -> list:
    """The plan's index maps on the device — its own, int64, the
    front-assembly kernel's (``kernels.front_map_arrays``) and the slots
    written back to the pool — in one copy per dtype, cached on the plan
    per device (the SamePattern reuse tier keeps them across
    factorizations, and a captured CUDA graph holds their addresses)."""
    cache = plan.__dict__.setdefault("_device_maps", {})
    maps = cache.get(str(device))
    if maps is None:
        arrays, pairs = [], []
        for g in plan.groups:
            arrays += [np.asarray(x, dtype=np.int64) for x in (
                g.ws, g.off, g.a_slot, g.a_flat, g.a_src,
                *(x for cs in g.children
                  for x in (cs.child_off, cs.child_slot, cs.rel)))]
            front, n = kernels.front_map_arrays(
                g.batch, g.m, plan.pool_size, a=(g.a_slot, g.a_flat, g.a_src),
                children=[(cs.ub, cs.child_off, cs.child_slot, cs.rel)
                          for cs in g.children])
            arrays += front
            # the slots whose Schur block goes to the pool, found here so
            # the write-back needs no mask on the device (a mask is a
            # nonzero: a host sync, which a CUDA graph cannot hold)
            arrays.append(np.flatnonzero(np.asarray(g.off)
                                         < plan.pool_size).astype(np.int64))
            pairs.append(n)
        views = iter(kernels.upload(arrays, device))
        maps = []
        for g, n in zip(plan.groups, pairs):
            ws, off, a_slot, a_flat, a_src = (next(views) for _ in range(5))
            children = [(cs.ub, next(views), next(views), next(views))
                        for cs in g.children]
            front = kernels.FrontMaps("front_assemble", g.batch, g.m,
                                      plan.pool_size,
                                      *(next(views) for _ in range(6)),
                                      pairs=n)
            keep = next(views)
            maps.append(GroupMaps(ws=ws, off=off, a_slot=a_slot,
                                  a_flat=a_flat, a_src=a_src,
                                  children=children, front=front,
                                  keep=None if len(keep) == g.batch
                                  else keep))
        cache[str(device)] = maps
    return maps


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def group_step(dims, avals, pool, thresh, maps: GroupMaps,
               gemm_prec="default", scatter=KERNELS, timings=None,
               write_back=True):
    """One (level, bucket) group: assemble + factor + write back.

    dims = (batch, m, w, u).  ``scatter(avals, pool, m, w, maps)`` returns
    the group's assembled (batch, m²) front batch.  Writes the group's
    Schur blocks into ``pool`` in place (slots with off == pool size have
    none; ``maps.keep`` lists the others, None when every slot has one)
    and returns ((lpanel, upanel), tiny count as a 0-d device tensor).
    With ``write_back=False`` the pool is left as it is and the Schur
    blocks come back instead: ((lpanel, upanel), schur (batch, u²) or
    None when u == 0, tiny) — the mesh tier (parallel/spmd.py) gathers
    them from every rank and writes the pool in full slot order.
    Nothing here waits for the device, so a CUDA graph can hold the step.
    ``timings``, when a dict, accumulates seconds per stage, synchronizing
    the device at each stage boundary (refused while a graph captures)."""
    batch, m, w, u = dims
    dev = pool.device
    if timings is not None and dev.type == "cuda" \
            and torch.cuda.is_current_stream_capturing():
        raise ValueError("timings synchronize the device: a CUDA graph "
                         "capture cannot hold them")
    clock = [time.perf_counter()]

    def lap(name):
        if timings is not None:
            _sync(dev)
            t = time.perf_counter()
            timings[name] = timings.get(name, 0.0) + t - clock[0]
            clock[0] = t

    f = scatter(avals, pool, m, w, maps)
    lap("front_assemble")
    lpanel, upanel, schur, flags = group_partial_factor(
        f.view(batch, m, m), thresh, w, gemm_prec=gemm_prec)
    # identity-padding columns (col >= ws) are unit pivots — a thresh > 1
    # must not count them as tiny
    real = torch.arange(w, device=dev)[None, :] < maps.ws[:, None]
    tiny = torch.where(real, flags, 0).sum()
    lap("partial_factor")
    if not write_back:
        return ((lpanel.contiguous(), upanel.contiguous()),
                schur.reshape(batch, u * u) if u > 0 else None, tiny)
    if u > 0:
        vals = schur.reshape(batch, u * u)
        off = maps.off
        if maps.keep is not None:
            vals, off = vals[maps.keep], off[maps.keep]
        pool[off[:, None] + torch.arange(u * u, device=dev)] = vals
    packed = (lpanel.contiguous(), upanel.contiguous())
    lap("write_back")
    return packed, tiny


def run_groups(plan: FactorPlan, lo: int, hi: int, maps, avals, pool,
               thresh, gemm_prec="default", scatter=KERNELS, timings=None):
    """Groups ``lo..hi-1`` of the plan, in order, on ``pool`` in place:
    returns (their (lpanel, upanel) pairs, their tiny count as a 0-d
    tensor).  The body of the fused executor (its graph holds all the
    groups; on the CPU it runs eagerly) and of each level wave's graph;
    nothing in it waits for the device."""
    fronts = []
    tiny = torch.zeros((), dtype=torch.int64, device=pool.device)
    for gi in range(lo, hi):
        grp = plan.groups[gi]
        packed, t = group_step((grp.batch, grp.m, grp.w, grp.u), avals,
                               pool, thresh, maps[gi], gemm_prec=gemm_prec,
                               scatter=scatter, timings=timings)
        fronts.append(packed)
        tiny += t
    return fronts, tiny


@dataclasses.dataclass
class NumericFactorization:
    """LU factors as packed front batches (the dLUstruct_t analog,
    superlu_ddefs.h:186-191), on the device they were computed on — or in
    host memory: all of them after an offload (``on_host``), the leading
    levels' after a host-share split."""

    plan: FactorPlan
    fronts: list              # per group: (lpanel (B,M,w), upanel (B,w,u))
    tiny_pivots: int
    dtype: torch.dtype
    finite: bool = True       # False => an exact zero pivot propagated
                              # (only possible with replace_tiny=False)
    info_col: int = -1        # first zero-pivot column (0-based, final
                              # labeling) when not finite
    gemm_prec: str = "default"   # the GEMM tier the factors ran at
    resumed_groups: int = 0   # groups spliced from a checkpoint (resume_from)
    offload: str = "none"     # "host": the executor moved every front to
                              # host memory as it was produced
    host_levels: int = 0      # leading levels factored on the CPU (the
                              # host-share split)
    executor: dict = dataclasses.field(default_factory=dict)
                              # what ran: the executor's report
    host_fronts: list = None  # numpy copies for the host solve, pulled once
    shard: object = None      # parallel.spmd.Shard when the factors are
                              # sharded over a grid's ranks: ``fronts``
                              # then holds this rank's slots only

    @property
    def device(self) -> torch.device:
        """Where the factors' trailing (root) groups lie: the card for a
        host-share split, the CPU for offloaded factors."""
        return self.fronts[-1][0].device if self.fronts \
            else torch.device("cpu")

    @property
    def on_host(self) -> bool:
        """True when the executor moved every front to host memory
        (offload): such factors are solved on the host
        (solve/trisolve.py).  A host-share split leaves only the leading
        levels' fronts on the CPU — a device factorization."""
        return self.offload == "host" and bool(self.fronts)

    def pull_to_host(self) -> list:
        """The fronts as numpy arrays, pulled once (the dSolveInit analog,
        SRC/pdutil.c:690: solve-side setup cached across solves).  Sharded
        factors have no host copy: no rank holds them whole."""
        if self.shard is not None:
            raise ValueError("sharded factors are solved collectively on "
                             "the grid (parallel/spmd.SpmdSolver), not on "
                             "the host")
        if self.host_fronts is None:
            self.host_fronts = [(lp.detach().cpu().numpy(),
                                 up.detach().cpu().numpy())
                                for lp, up in self.fronts]
        return self.host_fronts


def resolve_executor(executor: str, device: torch.device, grid=None,
                     pool_partition: bool = False) -> str:
    """The executor ``executor`` stands for, after the JAX package's rule
    (numeric/factor.py:391-427).  Under a grid of several ranks:
    "stream", or any choice with ``pool_partition``, is the 2-D mesh
    stream ("mesh-stream", parallel/mesh_stream.py — the JAX package's
    GSPMD stream, which also takes a partitioned pool); "auto" and "spmd"
    without it are "spmd" (the JAX package's auto picks its stream on a
    multi-process mesh: the port keeps spmd, ROADMAP.md Queue 3); "fused"
    and "mega" raise.  Off such a grid ``pool_partition`` is ignored (the
    JAX ``pool_spec`` is None without a mesh), spmd resolves to stream,
    and auto is fused on the CPU and stream on the card."""
    if executor not in EXECUTORS:
        raise ValueError(f"executor must be one of {EXECUTORS}, got "
                         f"{executor!r}")
    if grid is not None and grid.nproc > 1:
        if executor in GRAPH_EXECUTORS:
            raise ValueError(f"a grid of {grid.nproc} ranks runs the spmd "
                             f"or the 2-D stream executor, not {executor!r}")
        if executor == "stream" or pool_partition:
            return "mesh-stream"
        return "spmd"
    if executor == "spmd":
        return "stream"
    if executor == "auto":
        return "fused" if device.type == "cpu" else "stream"
    return executor


def get_executor(plan: FactorPlan, dtype=torch.float64,
                 executor: str = "auto", gemm_prec: str | None = None,
                 device="cuda", *, host_flops: float = 0.0,
                 front_bytes_limit: float = 6e9, offload_lag: int = 8,
                 scatter=KERNELS, grid=None, pool_partition: bool = False):
    """The executor of a plan, cached on the plan: refactor's shadow
    handle and the SamePattern tiers share the plan, so they reuse the
    executor — and a fused executor's captured graph.

    ``executor``: "stream", "fused", "mega", "spmd" or "auto"
    (``resolve_executor``: spmd under a ``grid`` of several ranks, else
    fused on the CPU and stream on the card).  "spmd" runs this rank's
    share of every group on a ``grid`` of several ranks
    (parallel/spmd.py); off one it is the stream.  On such a grid
    "stream" or ``pool_partition`` runs the 2-D mesh stream
    (parallel/mesh_stream.py).  The key holds the dtype, the executor,
    the GEMM tier, the host-share threshold, the offload knobs, the
    device, the front assembly (the kernel or its plain version), the
    grid, its shape and the pool partition.  The cache keeps one fused
    or mega executor per device: a new one (another dtype, tier or front
    assembly) drops the one before it, whose captured graphs hold
    gigabytes — the fused graph of poisson3d(48) 2.94 GB of device memory
    — and would otherwise pile up, one for each ladder rung at a new
    tier.  Likewise one mesh executor (spmd or 2-D) per device: a call on
    a new grid (every ``pgssvx(grid=)`` job builds one) drops the one of
    the grid before it, with its device maps.  Factors the dropped executor
    returned are its clones and stay valid."""
    device = resolve_device(device)
    executor = resolve_executor(executor, device, grid, pool_partition)
    gemm_prec = gemm_precision(gemm_prec)
    stream_knobs = (float(host_flops), float(front_bytes_limit),
                    int(offload_lag))
    mesh = executor in MESH_EXECUTORS
    key = (str(dtype), executor, gemm_prec,
           stream_knobs if executor in ("stream", "mega") else None,
           str(device), scatter,
           (id(grid), grid.nprow, grid.npcol, bool(pool_partition))
           if mesh else None)
    cache = plan.__dict__.setdefault("_factor_fns", {})
    fn = cache.get(key)
    if fn is None:
        group = GRAPH_EXECUTORS if executor in GRAPH_EXECUTORS else (
            MESH_EXECUTORS if mesh else ())
        for k in [k for k in cache if k[1] in group
                  and k[4] == str(device)]:
            del cache[k]
        if executor == "mesh-stream":
            from superlu_dist_tpu_torch.parallel.mesh_stream import (
                MeshStreamExecutor)
            fn = MeshStreamExecutor(plan, dtype, device, grid,
                                    gemm_prec=gemm_prec, scatter=scatter,
                                    pool_partition=pool_partition)
        elif executor == "spmd":
            from superlu_dist_tpu_torch.parallel.spmd import (
                SpmdFactorExecutor)
            fn = SpmdFactorExecutor(plan, dtype, device, grid,
                                    gemm_prec=gemm_prec, scatter=scatter)
        elif executor == "stream":
            from superlu_dist_tpu_torch.numeric.stream import StreamExecutor
            fn = StreamExecutor(plan, dtype, device, gemm_prec=gemm_prec,
                                host_flops=host_flops,
                                front_bytes_limit=front_bytes_limit,
                                offload_lag=offload_lag, scatter=scatter)
        elif executor == "mega":
            from superlu_dist_tpu_torch.numeric.mega import MegaExecutor
            fn = MegaExecutor(plan, dtype, device, gemm_prec=gemm_prec,
                              front_bytes_limit=front_bytes_limit,
                              offload_lag=offload_lag, scatter=scatter)
        else:
            from superlu_dist_tpu_torch.numeric.fused import FusedExecutor
            fn = FusedExecutor(plan, dtype, device, gemm_prec=gemm_prec,
                               scatter=scatter)
        cache[key] = fn
    return fn


def numeric_factorize(plan: FactorPlan, pattern_values: np.ndarray,
                      anorm: float, dtype=torch.float64,
                      device="cuda", replace_tiny: bool = True,
                      check_finite: bool = True, gemm_prec: str | None = None,
                      ckpt_dir: str | None = None, ckpt_every: int = 0,
                      resume_from: str | None = None, deadline=None,
                      scatter=KERNELS, timings=None, executor: str = "auto",
                      host_flops: float = 0.0,
                      front_bytes_limit: float = 6e9,
                      offload_lag: int = 8,
                      grid=None,
                      pool_partition: bool = False) -> NumericFactorization:
    """Factor with values aligned to plan.pattern_indices, on ``device``
    (the card unless the caller asks for the CPU; CUDA without a card
    raises), in ``dtype``: float32, float64, complex64 or complex128.

    anorm: ‖A‖ for the GESP tiny-pivot threshold sqrt(eps)·‖A‖
    (reference pdgstrf2.c:218 uses eps·‖A‖; the sqrt variant keeps half
    the digits of f32 factors), as in the JAX package (factor.py:528).
    With replace_tiny=False an exact zero pivot propagates inf/nan and the
    result is flagged non-finite (the reference's info>0 singularity path,
    pdgstrf.c:234-241).  check_finite arms the isfinite sentinel: with
    ReplaceTinyPivot active a NaN/Inf in the factors means overflow or NaN
    input, and NumericBreakdownError names the first contaminated
    supernode.  ``gemm_prec`` is the Schur GEMMs' ladder tier
    (``ops/dense.gemm_precision``: None is "default", TF32 on the card).

    ``executor`` and the stream knobs (``host_flops``,
    ``front_bytes_limit``, ``offload_lag``) choose how the groups run
    (``get_executor``).  Crash consistency (persist/): ``ckpt_dir`` /
    ``ckpt_every`` arm a FactorCheckpointer that flushes the
    completed-group frontier every ``ckpt_every`` groups and on deadline,
    breakdown or SIGTERM; ``resume_from`` loads a checkpoint, verifies its
    plan fingerprint and value digest against this call's inputs, and
    restarts the group loop at its frontier — factors bit for bit equal to
    an uninterrupted run.  ``deadline`` (a utils.deadline.Deadline) is
    polled before every group.  These need group boundaries, so arming any
    of them turns "auto" and "fused" into "stream" (the JAX package's
    rule, numeric/factor.py:509-510, which there leaves a deadline to one
    poll before the fused program).  ``scatter`` is the front assembly of
    every group; ``timings`` (stream and spmd) accumulates per-stage
    seconds.

    ``grid`` (parallel/grid.ProcessGrid) of several ranks runs the spmd
    executor (parallel/spmd.py) or, for "stream" or ``pool_partition``,
    the 2-D mesh stream (parallel/mesh_stream.py): a COLLECTIVE every
    rank of the grid enters with the same plan and values, on its own
    device (``grid.device``); each rank keeps its own share of the panels
    (``NumericFactorization.shard``), the tiny count and the finite
    sentinel are the grid's.  Checkpoints and resume are refused there
    (the pool is the ranks' joint state); the deadline polls at every
    group boundary.  ``pool_partition`` is ignored off such a grid.
    """
    if grid is not None:
        device = grid.device
    device = resolve_device(device)
    plan.check_index_width()
    gemm_prec = gemm_precision(gemm_prec)
    # the threshold is compared with |pivot|: a tensor of the real
    # component type (torch.finfo of a complex type is its component's);
    # its float, rounded to that type, is what the value digest records
    real_dtype = torch.empty((), dtype=dtype).real.dtype
    eps = torch.finfo(dtype).eps
    thresh = torch.tensor(
        np.sqrt(eps) * max(anorm, 1e-300) if replace_tiny else 0.0,
        dtype=real_dtype)
    thresh_f = float(thresh)
    tracer = get_tracer()
    if tracer.enabled:
        # schedule telemetry: what the dispatch stream is shaped like (the
        # block Stats.report prints)
        tracer.complete("schedule", "phase", time.perf_counter(), 0.0,
                        **plan.schedule_stats(
                            itemsize=torch.empty((), dtype=dtype)
                            .element_size()))
    # failure-domain chaos injection (testing/chaos.py, SLU_TPU_CHAOS):
    # None unless armed, so the production path pays one ``is None``
    chaos = get_chaos()
    if chaos is not None:
        pattern_values = chaos.poke_nan(plan, pattern_values)
    want_ckpt = bool(ckpt_dir) or ckpt_every > 0
    spmd = resolve_executor(executor, device, grid,
                            pool_partition) in MESH_EXECUTORS
    if spmd and (want_ckpt or resume_from):
        raise ValueError("a mesh executor takes no checkpoint or resume: "
                         "its pool is the grid's joint state")
    if (want_ckpt or resume_from or deadline is not None) \
            and executor in ("auto", "fused") and not spmd:
        executor = "stream"
    ex = get_executor(plan, dtype, executor, gemm_prec, device,
                      host_flops=host_flops,
                      front_bytes_limit=front_bytes_limit,
                      offload_lag=offload_lag, scatter=scatter, grid=grid,
                      pool_partition=pool_partition)
    if spmd:
        return _spmd_factorize(ex, plan, pattern_values, dtype, thresh,
                               replace_tiny, check_finite, deadline, chaos,
                               gemm_prec, timings)
    resume = None
    if resume_from:
        from superlu_dist_tpu_torch.persist.checkpoint import load_checkpoint
        resume = load_checkpoint(resume_from, plan=plan,
                                 pattern_values=pattern_values,
                                 thresh=thresh_f, dtype=dtype,
                                 gemm_prec=gemm_prec)
    ckpt = None
    if want_ckpt:
        from superlu_dist_tpu_torch.persist.checkpoint import (
            FactorCheckpointer)
        ckpt = FactorCheckpointer(ckpt_dir or ".slu_ckpt", plan,
                                  pattern_values, thresh_f, dtype,
                                  every=int(ckpt_every), gemm_prec=gemm_prec)
        if resume is not None:
            ckpt.seed(resume)
    avals = torch.as_tensor(np.asarray(pattern_values)).to(dtype)
    try:
        if hasattr(ex, "checkpoint"):
            ex.checkpoint, ex.resume, ex.deadline = ckpt, resume, deadline
            ex.chaos = chaos
        try:
            fronts, tiny = ex(avals, thresh, timings=timings)
        finally:
            if hasattr(ex, "checkpoint"):
                # per-call hooks: a cached executor must not carry them
                # into the next factorization
                ex.checkpoint = ex.resume = ex.deadline = ex.chaos = None
        finite, info_col = True, -1
        if not replace_tiny:
            finite, info_col = localize_singularity(plan, fronts)
        elif check_finite and not fronts_finite(fronts):
            sn, col = localize_nonfinite(plan, fronts)
            err = NumericBreakdownError(supernode=sn, col=col,
                                        where="numeric factorization")
            # the loop's end is a boundary: the frontier may include the
            # contaminated group (crash consistency, not numerical
            # validity — a resume reproduces the breakdown)
            err.checkpoint_path = (ckpt.flush_latest("numeric-breakdown")
                                   if ckpt is not None else None)
            raise err
    except BaseException:
        if ckpt is not None:
            # keep the flushed frontier on disk, but deregister: a later
            # factorization's SIGTERM must not reach this one's refs
            ckpt.complete(cleanup=False)
        raise
    if ckpt is not None:
        ckpt.complete(cleanup=True)
    return NumericFactorization(plan=plan, fronts=fronts,
                                tiny_pivots=int(tiny), dtype=dtype,
                                finite=finite, info_col=info_col,
                                gemm_prec=gemm_prec,
                                resumed_groups=resume.k if resume else 0,
                                offload=getattr(ex, "offload", "none"),
                                host_levels=getattr(ex, "host_levels", 0),
                                executor=ex.report())


def _spmd_factorize(ex, plan, pattern_values, dtype, thresh, replace_tiny,
                    check_finite, deadline, chaos, gemm_prec, timings):
    """numeric_factorize's tail on a mesh executor (spmd or 2-D): the
    collective factorization, then the collective finite sentinel (a
    breakdown is localized on the gathered fronts, the same on every
    rank)."""
    from superlu_dist_tpu_torch.parallel.spmd import (gather_fronts,
                                                      sharded_finite)
    avals = torch.as_tensor(np.asarray(pattern_values)).to(dtype)
    ex.deadline, ex.chaos = deadline, chaos
    try:
        fronts, tiny, shard = ex(avals, thresh, timings=timings)
    finally:
        ex.deadline = ex.chaos = None
    numeric = NumericFactorization(plan=plan, fronts=fronts,
                                   tiny_pivots=int(tiny), dtype=dtype,
                                   gemm_prec=gemm_prec,
                                   executor=ex.report(), shard=shard)
    if not replace_tiny:
        full = gather_fronts(numeric)
        numeric.finite, numeric.info_col = localize_singularity(plan, full)
    elif check_finite and not sharded_finite(numeric):
        sn, col = localize_nonfinite(plan, gather_fronts(numeric))
        err = NumericBreakdownError(supernode=sn, col=col,
                                    where="numeric factorization")
        err.checkpoint_path = None
        raise err
    return numeric


def fronts_finite(fronts) -> bool:
    """Cheap isfinite sentinel over factored panels: reduced where the
    panels lie, one host transfer per device for all groups."""
    flags = {}
    for lp, up in fronts:
        flags.setdefault(lp.device, []).append(
            torch.isfinite(lp).all() & torch.isfinite(up).all())
    return all(bool(torch.stack(f).all()) for f in flags.values())


def _nonfinite_slots(lp, up) -> np.ndarray:
    b = lp.shape[0]
    nf = ~torch.isfinite(lp.reshape(b, -1)).all(dim=1)
    nf |= ~torch.isfinite(up.reshape(b, -1)).all(dim=1)
    return nf.cpu().numpy()


def localize_nonfinite(plan: FactorPlan, fronts):
    """Earliest contaminated supernode over all fronts: returns
    (supernode, first global column), or (-1, -1) if everything is finite.
    Attribution is per SLOT — an unrelated subtree batched in the same
    group must not be blamed."""
    sn_start = plan.sf.sn_start
    best_sn, best_col = -1, -1
    for grp, (lp, up) in zip(plan.groups, fronts):
        nf = _nonfinite_slots(lp, up)
        if nf.any():
            sns = np.asarray(grp.sns)[np.nonzero(nf)[0]]
            sn = int(sns[np.argmin(sn_start[sns])])
            col = int(sn_start[sn])
            if best_col < 0 or col < best_col:
                best_sn, best_col = sn, col
    return best_sn, best_col


def localize_singularity(plan: FactorPlan, fronts):
    """Zero-pivot detection + localization over factored fronts: a zero
    or non-finite U diagonal in a real (non-padding) column; the earliest
    such global column is the reference's info>0 first-zero-pivot index
    (pdgstrf.c:1920-1924).  Returns (finite, info_col)."""
    bad_cols = []
    sn_start = plan.sf.sn_start
    for grp, (lp, up) in zip(plan.groups, fronts):
        diag = torch.diagonal(lp[:, :grp.w, :grp.w], dim1=1,
                              dim2=2).cpu().numpy()
        bad = (diag == 0) | ~np.isfinite(diag)
        bad &= np.arange(grp.w)[None, :] < np.asarray(grp.ws)[:, None]
        if bad.any():
            slots, cols = np.nonzero(bad)
            bad_cols.append(int((sn_start[grp.sns[slots]] + cols).min()))
        else:
            nf = _nonfinite_slots(lp, up)
            if nf.any():
                bad_cols.append(int(sn_start[grp.sns[nf]].min()))
    if bad_cols:
        return False, min(bad_cols)
    return True, -1


def query_space(numeric: NumericFactorization) -> dict:
    """Memory held by the factorization — the dQuerySpace_dist analog
    (SRC/dmemory_dist.c:73): packed-front (L+U) bytes plus the transient
    Schur update pool."""
    itemsize = torch.empty((), dtype=numeric.dtype).element_size()
    front_b = sum(lp.numel() + up.numel() for lp, up in numeric.fronts) \
        * itemsize
    shard = numeric.shard
    pool_b = (shard.pool_bytes if shard is not None and shard.cols is not None
              else int(numeric.plan.pool_size) * itemsize)
    return {"for_lu_bytes": front_b, "pool_bytes": pool_b,
            "total_bytes": front_b + pool_b}
