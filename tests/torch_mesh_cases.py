"""What the spawned ranks of the port's mesh-tier tests run.

Each function here is ``fn(tc, grid, *args)`` for
``superlu_dist_tpu_torch.testing.ranks.run_mesh_ranks``: it runs on every
rank of a gloo CPU grid, in a child process that imports this module by
name (it imports nothing of JAX, so a child starts quickly), and returns
what the test in the parent compares.  Not a test module: pytest does
not collect it.
"""

import numpy as np
import torch

import superlu_dist_tpu_torch as slt
from superlu_dist_tpu_torch.models import gallery
from superlu_dist_tpu_torch.numeric.factor import numeric_factorize
from superlu_dist_tpu_torch.parallel.dist import ShardedSpMV, distribute_rows
from superlu_dist_tpu_torch.parallel.pgssvx import pgssvx
from superlu_dist_tpu_torch.parallel.spmd import SpmdSolver, gather_fronts
from superlu_dist_tpu_torch.solve.device import DeviceSolver
from superlu_dist_tpu_torch.testing.ranks import shard_record
from superlu_dist_tpu_torch.utils.errors import SuperLUError


def _rhs(n, k, cplx, seed):
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((n, k))
    if cplx:
        r = r + 1j * rng.standard_normal((n, k))
    return r


def spmd_vs_stream(tc, grid, cases):
    """Per case (name, plan, vals, anorm, dtype name): the spmd
    factorization on the grid against the stream executor on this rank
    alone — gathered fronts and tiny count — and SpmdSolver against
    DeviceSolver at NOTRANS (3 columns and 1), TRANS and, for complex
    factors, CONJ.  Rank 0 also returns its gathered fronts and X."""
    out = {}
    for name, plan, vals, anorm, dt in cases:
        dtype = getattr(torch, dt)
        fs = numeric_factorize(plan, vals, anorm, dtype=dtype, device="cpu",
                               executor="spmd", grid=grid)
        f0 = numeric_factorize(plan, vals, anorm, dtype=dtype, device="cpu",
                               executor="stream")
        full = gather_fronts(fs)
        equal = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                    for a, b in zip(full, f0.fronts))
        cplx = dtype.is_complex
        rhs = _rhs(plan.n, 3, cplx, 7)
        s0, s1 = DeviceSolver(f0), SpmdSolver(fs)
        x = s1.solve(rhs)
        solves = {"N": np.array_equal(s0.solve(rhs), x),
                  "N1": np.array_equal(s0.solve(rhs[:, 0]),
                                       s1.solve(rhs[:, 0])),
                  "T": np.array_equal(s0.solve_trans(rhs),
                                      s1.solve_trans(rhs))}
        if cplx:
            solves["C"] = np.array_equal(s0.solve_trans(rhs, conj=True),
                                         s1.solve_trans(rhs, conj=True))
        rec = dict(fronts_equal=equal, tiny=(fs.tiny_pivots, f0.tiny_pivots),
                   solves=solves,
                   shard=shard_record(fs, grid.nproc, grid.rank),
                   executor=fs.executor)
        if grid.rank == 0:
            rec["fronts"] = [(lp.numpy(), up.numpy()) for lp, up in full]
            rec["x"] = x
        out[name] = rec
    return out


def _system(spec):
    name, args, seed, nrhs = spec
    a = getattr(gallery, name)(*args)
    shape = (a.n_rows,) if nrhs is None else (a.n_rows, nrhs)
    x = np.random.default_rng(seed).standard_normal(shape)
    if np.iscomplexobj(a.data):
        x = x + 1j * np.random.default_rng(seed + 1).standard_normal(shape)
    return a, a.matvec(x)


def _mine(a, b, grid):
    part = distribute_rows(a, grid.nproc)[grid.rank]
    return part, b[part.fst_row:part.fst_row + part.m_loc]


def pgssvx_flow(tc, grid, spec, opts_kw, mode):
    """pgssvx(grid=) on this rank's block rows: DOFACT with the analysis
    ``mode`` ("root", "replicate", "psf"), then — on the root-analysis
    tiers — FACTORED at nrhs 2 and SamePattern_SameRowPerm on values ×
    1.5.  Returns x of each call, the report, the rank's shard record
    and its timings."""
    from superlu_dist_tpu_torch.utils.options import Fact
    a, b = _system(spec)
    part, b_loc = _mine(a, b, grid)
    opts = slt.Options(par_symb_fact=mode == "psf", **opts_kw)
    out = {}
    x, info = pgssvx(tc, opts, part, b_loc, grid=grid, lu_out=out,
                     replicate_analysis=mode == "replicate")
    lu = out["lu"]
    rec = dict(x=x, info=info, berr=out["solve_report"].berr,
               rungs=[r.name for r in out["solve_report"].rungs],
               route=out["solve_report"].residual_route,
               solve_route=out["solve_report"].solve_route,
               on_host=lu.numeric.on_host,
               tiny=lu.numeric.tiny_pivots, timings=out["timings"],
               shard=shard_record(lu.numeric, grid.nproc, grid.rank),
               sharded=lu.numeric.shard is not None,
               pool_size_bytes=lu.plan.pool_size * torch.empty(
                   (), dtype=lu.numeric.dtype).element_size(),
               executor=lu.numeric.executor)
    bb = _system((spec[0], spec[1], spec[2] + 10, 2))[1]
    pb = bb[part.fst_row:part.fst_row + part.m_loc]
    x2, _ = pgssvx(tc, dataclass_replace(opts, fact=Fact.FACTORED), part, pb,
                   grid=grid, lu=lu)
    rec["x_factored"], rec["b_factored"] = x2, bb
    if mode != "psf":
        vals2 = np.asarray(part.data) * 1.5
        part2 = dataclass_replace(part, data=vals2)
        a2 = a.__class__(a.n_rows, a.n_cols, a.indptr, a.indices,
                         a.data * 1.5)
        b3 = a2.matvec(np.ones(a.n_rows))
        out3 = {}
        x3, _ = pgssvx(tc, dataclass_replace(
            opts, fact=Fact.SamePattern_SameRowPerm), part2,
            b3[part.fst_row:part.fst_row + part.m_loc], grid=grid, lu=lu,
            lu_out=out3)
        rec["x_refactor"] = x3
        rec["refactor_reused"] = (out3["lu"].plan is lu.plan
                                  and out3["lu"].sf is lu.sf)
    return rec


def dataclass_replace(obj, **kw):
    import dataclasses
    return dataclasses.replace(obj, **kw)


def factored_without_handle(tc, grid, spec, opts_kw=None):
    """FACTORED where only rank 0 passes a handle: every rank raises."""
    from superlu_dist_tpu_torch.utils.options import Fact
    a, b = _system(spec)
    part, b_loc = _mine(a, b, grid)
    out = {}
    pgssvx(tc, slt.Options(**(opts_kw or {})), part, b_loc, grid=grid,
           lu_out=out)
    lu = out["lu"] if grid.rank == 0 else None
    try:
        pgssvx(tc, slt.Options(fact=Fact.FACTORED, **(opts_kw or {})), part,
               b_loc, grid=grid, lu=lu)
    except SuperLUError as e:
        return f"raised: {e}"
    return "no error"


def gssvx_grid(tc, grid, spec, opts_kw):
    """gssvx(grid=) with the whole matrix on every rank (collective), and
    FACTORED on its handle."""
    a, b = _system(spec)
    x, lu, st, info = slt.gssvx(slt.Options(**opts_kw), a, b, grid=grid)
    x2, _, _, _ = slt.gssvx(slt.Options(fact=slt.Fact.FACTORED), a, 2 * b,
                            lu=lu)
    import tempfile
    from superlu_dist_tpu_torch.utils.errors import CheckpointError
    try:
        with tempfile.TemporaryDirectory() as td:
            slt.save_lu(lu, td)
        saved = "saved"
    except CheckpointError as e:
        saved = f"refused: {e}"
    return dict(x=x, x2=x2, info=info, berr=st.solve_report.berr, saved=saved,
                executor=st.executor, on_host=lu.numeric.on_host,
                solve_route=st.solve_report.solve_route,
                shard=shard_record(lu.numeric, grid.nproc, grid.rank))


def sharded_spmv(tc, grid, spec, x):
    """ShardedSpMV of A on the grid at x (every rank the same x)."""
    a, _ = _system(spec)
    return ShardedSpMV(a, grid)(x)


def sharded_spmv_ops(tc, grid, specs, xs):
    """Per case: ShardedSpMV over this rank's block rows (``from_rows``),
    op(A)·x and |op(A)|·x at NOTRANS, TRANS and CONJ, and A·x of the
    whole-matrix constructor (the same row deal)."""
    from superlu_dist_tpu_torch.utils.options import Trans
    out = {}
    for spec, x in zip(specs, xs):
        a, _ = _system(spec)
        part, _ = _mine(a, np.zeros(a.n_rows), grid)
        op = ShardedSpMV.from_rows(part, grid)
        rec = out[spec[0]] = {"whole": ShardedSpMV(a, grid)(x)}
        for t in Trans:
            rec[t.name] = op.apply(x, t)
            rec[f"abs {t.name}"] = op.apply(np.abs(x), t, absolute=True)
    return out


def sharded_spmv_out_of_order(tc, grid, spec):
    """Each rank hands ``from_rows`` the block of the rank after it: every
    rank refuses."""
    a, _ = _system(spec)
    part = distribute_rows(a, grid.nproc)[(grid.rank + 1) % grid.nproc]
    try:
        ShardedSpMV.from_rows(part, grid)
    except ValueError as e:
        return f"refused: {e}"
    return "no error"


def mismatched_collectives(tc, grid):
    """Rank 0 gathers while the others all-reduce: under
    SLU_TPU_VERIFY_COLLECTIVES every rank raises
    CollectiveMismatchError instead of hanging."""
    from superlu_dist_tpu_torch.utils.errors import CollectiveMismatchError
    t = torch.ones(3, dtype=torch.float64)
    try:
        if grid.rank == 0:
            grid.all_gather(t)
        else:
            grid.all_reduce_sum(t)
    except CollectiveMismatchError as e:
        return f"mismatch: {type(e).__name__}"
    return "no error"


def deadline_expires(tc, grid, spec):
    """A factorization whose deadline is already spent on rank 0 only:
    the collective poll raises on every rank."""
    from superlu_dist_tpu_torch.utils.deadline import Deadline
    from superlu_dist_tpu_torch.utils.errors import DeadlineExceededError
    a, b = _system(spec)
    lu, bvals, _ = slt.analyze(slt.Options(), a, device="cpu")
    dl = Deadline(0.0 if grid.rank == 0 else 1e9, comm=grid)
    try:
        numeric_factorize(lu.plan, bvals, lu.anorm, dtype=torch.float64,
                          device="cpu", grid=grid, deadline=dl)
    except DeadlineExceededError as e:
        return f"expired on {e.expired_ranks} rank(s)"
    return "no error"


def spmd_drift_on_the_card(tc, grid, spec):
    """On the card (float32, the default TF32 tier): the spmd fronts of
    every rank, gathered to slot order, against the stream executor's on
    the same card — bit for bit, or the normwise drift — and the rank's
    front_assemble launches and groups with a slot."""
    from superlu_dist_tpu_torch.numeric import kernels
    a, _ = _system(spec)
    lu, bvals, _ = slt.analyze(slt.Options(), a, device=grid.device)
    kernels.reset_launches()
    fs = numeric_factorize(lu.plan, bvals, lu.anorm, dtype=torch.float32,
                           device=grid.device, grid=grid)
    torch.cuda.synchronize()
    launches = kernels.LAUNCHES["front_assemble"]
    full = gather_fronts(fs)
    f0 = numeric_factorize(lu.plan, bvals, lu.anorm, dtype=torch.float32,
                           device=grid.device, executor="stream")
    num = den = 0.0
    equal = True
    for (l1, u1), (l2, u2) in zip(full, f0.fronts):
        for x, y in ((l1, l2), (u1, u2)):
            equal &= bool(torch.equal(x, y))
            if x.numel():
                num = max(num, float((x.double() - y.double()).abs().max()))
                den = max(den, float(y.double().abs().max()))
    return dict(equal=equal, drift=num / max(den, 1e-300),
                launches=launches,
                owned_groups=sum(1 for g in lu.plan.groups
                                 if grid.rank < g.batch),
                tiny=(fs.tiny_pivots, f0.tiny_pivots),
                shard=shard_record(fs, grid.nproc, grid.rank))


# ---------------------------------------------------------------------------
# the 2-D mesh tier (parallel/mesh_stream.py)
# ---------------------------------------------------------------------------

def _equal_fronts(f1, f2):
    return all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
               for a, b in zip(f1, f2)) and len(f1) == len(f2)


def _max_rel(f1, f2):
    num = den = 0.0
    for a, b in zip(f1, f2):
        for x, y in zip(a, b):
            if x.numel():
                num = max(num, float((x - y).abs().max()))
                den = max(den, float(y.abs().max()))
    return num / max(den, 1e-300)


def mesh2d_vs_stream(tc, grid, cases):
    """Per case (name, plan, vals, anorm, dtype name): the 2-D mesh
    stream on the grid with the partitioned and with the replicated pool
    against each other and against the stream executor on this rank
    alone — gathered fronts (bit for bit, and the largest relative
    difference), tiny counts — each rank's pool against the plan's, and
    the 2-D SpmdSolver against DeviceSolver at NOTRANS (3 columns and 1),
    TRANS and, for complex factors, CONJ.  Rank 0 also returns the
    gathered fronts (partitioned pool)."""
    out = {}
    for name, plan, vals, anorm, dt in cases:
        dtype = getattr(torch, dt)
        fp = numeric_factorize(plan, vals, anorm, dtype=dtype, device="cpu",
                               executor="stream", grid=grid,
                               pool_partition=True)
        fr = numeric_factorize(plan, vals, anorm, dtype=dtype, device="cpu",
                               executor="stream", grid=grid)
        f0 = numeric_factorize(plan, vals, anorm, dtype=dtype, device="cpu",
                               executor="stream")
        gp, gr = gather_fronts(fp), gather_fronts(fr)
        cplx = dtype.is_complex
        rhs = _rhs(plan.n, 3, cplx, 7)
        s0, s1 = DeviceSolver(f0), SpmdSolver(fp)
        x0 = s0.solve(rhs)
        solves = {"N": (s1.solve(rhs), x0),
                  "N1": (s1.solve(rhs[:, 0]), s0.solve(rhs[:, 0])),
                  "T": (s1.solve_trans(rhs), s0.solve_trans(rhs))}
        if cplx:
            solves["C"] = (s1.solve_trans(rhs, conj=True),
                           s0.solve_trans(rhs, conj=True))
        rec = dict(partition_equals_replicated=_equal_fronts(gp, gr),
                   equal_to_stream=_equal_fronts(gp, f0.fronts),
                   rel_to_stream=_max_rel(gp, f0.fronts),
                   tiny=(fp.tiny_pivots, fr.tiny_pivots, f0.tiny_pivots),
                   solves=solves, executor=fp.executor,
                   executor_replicated=fr.executor,
                   shard=shard_record(fp, grid.nproc, grid.rank),
                   pool_size=plan.pool_size)
        if grid.rank == 0:
            rec["fronts"] = [(lp.numpy(), up.numpy()) for lp, up in gp]
        out[name] = rec
    return out


def mesh2d_drift_on_the_card(tc, grid, spec, partition):
    """On the card (float32, the default TF32 tier): the 2-D mesh stream's
    fronts of every rank, gathered to slot order, against the stream
    executor's on the same card — bit for bit, or the normwise drift —
    the rank's front_assemble launches and the groups where it assembles,
    and its shard record."""
    from superlu_dist_tpu_torch.numeric import kernels
    a, _ = _system(spec)
    lu, bvals, _ = slt.analyze(slt.Options(), a, device=grid.device)
    kernels.reset_launches()
    fs = numeric_factorize(lu.plan, bvals, lu.anorm, dtype=torch.float32,
                           device=grid.device, grid=grid, executor="stream",
                           pool_partition=partition)
    torch.cuda.synchronize()
    launches = kernels.LAUNCHES["front_assemble"]
    full = gather_fronts(fs)
    f0 = numeric_factorize(lu.plan, bvals, lu.anorm, dtype=torch.float32,
                           device=grid.device, executor="stream")
    num = den = 0.0
    for (l1, u1), (l2, u2) in zip(full, f0.fronts):
        for x, y in ((l1, l2), (u1, u2)):
            if x.numel():
                num = max(num, float((x.double() - y.double()).abs().max()))
                den = max(den, float(y.double().abs().max()))
    shard = shard_record(fs, grid.nproc, grid.rank)
    return dict(equal=_equal_fronts(full, f0.fronts),
                drift=num / max(den, 1e-300), launches=launches,
                owned_groups=shard["owned_groups"],
                tiny=(fs.tiny_pivots, f0.tiny_pivots), shard=shard,
                executor=fs.executor)


def row_collectives(tc, grid):
    """The 2-D tier's collectives on this rank: a broadcast from each
    process column over the row, the row sum in process-column order, a
    variable-size exchange (rank r sends r + d + 1 values to rank d), and
    a column gather."""
    r, dev = grid.rank, grid.device
    out = {}
    for src in range(grid.npcol):
        t = torch.full((2, 3), float(grid.prow * 10 + src),
                       dtype=torch.float64)
        got = grid.bcast_row(t if grid.pcol == src else None, src, (2, 3),
                             torch.float64)
        out[f"bcast{src}"] = got.numpy().copy()
    x = torch.tensor([0.1 * (grid.pcol + 1), 1e16, -1e16], dtype=torch.float64)
    out["row_sum"] = grid.all_reduce_row(x).numpy()
    send = torch.cat([torch.full((r + d + 1,), float(100 * r + d),
                                 dtype=torch.float64, device=dev)
                      for d in range(grid.nproc)])
    got = grid.exchange(send, [r + d + 1 for d in range(grid.nproc)],
                        [s + r + 1 for s in range(grid.nproc)])
    out["exchange"] = got.numpy()
    out["col"] = grid.all_gather(torch.tensor([float(r)]),
                                 axis="snode").numpy()
    out["comm"] = grid.comm_summary()
    return out


def mismatched_row_collectives(tc, grid, case):
    """A divergent 2-D collective under SLU_TPU_VERIFY_COLLECTIVES: in a
    row, process column 0 broadcasts while the others sum ("row"), or
    rank 0's exchange counts disagree with its peers' ("counts").  Every
    rank of the communicator raises CollectiveMismatchError."""
    from superlu_dist_tpu_torch.utils.errors import CollectiveMismatchError
    t = torch.ones(3, dtype=torch.float64)
    try:
        if case == "row":
            if grid.pcol == 0:
                grid.bcast_row(t, 0, (3,), torch.float64)
            else:
                grid.all_reduce_row(t)
        else:
            n = grid.nproc
            want = [1] * n
            if grid.rank == 0:
                want = [2] * n
            grid.exchange(torch.ones(n, dtype=torch.float64), [1] * n, want)
    except CollectiveMismatchError as e:
        return f"mismatch: {type(e).__name__}"
    return "no error"


def subgrids(tc, grid, specs):
    """Four world ranks split by ``gridmap`` into two 2×1 sub-grids, ranks
    [0, 1] and [2, 3] (every rank makes both calls, in one order). Each
    sub-grid solves its own system of ``specs`` with ``gssvx(grid=)`` at
    the same time as the other; then sub-grid [0, 1] solves the second
    system alone while [2, 3] waits. Returns this rank's grid rank, the
    sub-grid's x, its verify sequence numbers and collective calls, and
    on ranks 0 and 1 the second system's x solved alone."""
    from superlu_dist_tpu_torch.parallel.grid import gridmap
    grids = [gridmap([0, 1], 2, 1, device=grid.device),
             gridmap([2, 3], 2, 1, device=grid.device)]
    mine = [g for g in grids if g is not None]
    which = [g is not None for g in grids].index(True)
    sub = mine[0]
    a, b = _system(specs[which])
    x, lu, st, info = slt.gssvx(slt.Options(), a, b, grid=sub)
    rec = dict(members=[g is not None for g in grids], n_grids=len(mine),
               grid_rank=sub.rank, nproc=sub.nproc, info=info, x=x,
               seq=dict(sub.seq), comm=sub.comm_summary(),
               berr=st.solve_report.berr,
               shard=shard_record(lu.numeric, sub.nproc, sub.rank))
    tc.allreduce_sum_any(np.zeros(1))       # both sub-grids are done
    if which == 0:
        seq0 = dict(sub.seq)
        a1, b1 = _system(specs[1])
        x1, _, _, _ = slt.gssvx(slt.Options(), a1, b1, grid=sub)
        rec["x_alone"] = x1
        rec["seq_alone"] = {k: v - seq0.get(k, 0) for k, v in sub.seq.items()}
    return rec


#: the runs of ``runs_vs_stream``: label -> numeric_factorize's keywords
GRID_RUNS = {
    "offload": dict(executor="stream", pool_partition=True),
    "offload_replicated": dict(executor="stream"),
    "offload_spmd": dict(executor="spmd"),
    "fused": dict(executor="fused", pool_partition=True),
    "mega": dict(executor="mega", pool_partition=True),
    "mega_replicated": dict(executor="mega")}


def runs_vs_stream(tc, grid, cases, labels):
    """Per case (name, plan, vals, anorm, dtype name): on the grid, the
    runs ``labels`` of GRID_RUNS — the "offload*" ones with
    ``front_bytes_limit=0`` — each one's gathered fronts against the 2-D
    stream's with the partitioned pool (bit for bit), its tiny count,
    whether its factors are host-resident and its report; for an
    offloaded run also the SpmdSolver on its factors (built in host
    memory) against the one on the same executor's device factors, bit
    for bit.  Rank 0 also returns the "offload" run's gathered
    fronts."""
    out = {}
    for name, plan, vals, anorm, dt in cases:
        dtype = getattr(torch, dt)
        ref = numeric_factorize(plan, vals, anorm, dtype=dtype, device="cpu",
                                executor="stream", grid=grid,
                                pool_partition=True)
        gref = gather_fronts(ref)
        runs = {}
        for label in labels:
            kw = GRID_RUNS[label]
            limit = 0 if label.startswith("offload") else 6e9
            f = numeric_factorize(plan, vals, anorm, dtype=dtype,
                                  device="cpu", front_bytes_limit=limit,
                                  grid=grid, **kw)
            g = gather_fronts(f)
            rec = dict(equal=_equal_fronts(g, gref), rel=_max_rel(g, gref),
                       tiny=f.tiny_pivots, on_host=f.on_host,
                       offload=f.offload, executor=f.executor,
                       shard=shard_record(f, grid.nproc, grid.rank),
                       fronts_on=sorted({str(t.device) for pair in f.fronts
                                         for t in pair}),
                       pivots_on=sorted({str(p.device)
                                         for p in f.shard.pivots}))
            if label.startswith("offload"):
                rhs = _rhs(plan.n, 2, dtype.is_complex, 9)
                base = ref if kw["executor"] == "stream" else \
                    numeric_factorize(plan, vals, anorm, dtype=dtype,
                                      device="cpu", grid=grid, **kw)
                s_host = SpmdSolver(f)
                rec["solver_device"] = str(s_host.device)
                rec["x_equal"] = np.array_equal(s_host.solve(rhs),
                                                SpmdSolver(base).solve(rhs))
                if grid.rank == 0 and label == "offload":
                    rec["fronts"] = [(lp.numpy(), up.numpy())
                                     for lp, up in g]
            runs[label] = rec
        out[name] = dict(runs=runs, tiny=ref.tiny_pivots)
    return out


def grid_executor_fronts(tc, grid, plan, vals, anorm, executor, partition,
                         front_bytes_limit=6e9):
    """One float64 factorization on the grid with ``executor``: the
    gathered fronts (rank 0), the tiny count, what ran and whether its
    factors are host-resident."""
    f = numeric_factorize(plan, vals, anorm, dtype=torch.float64,
                          device="cpu", executor=executor, grid=grid,
                          pool_partition=partition,
                          front_bytes_limit=front_bytes_limit)
    full = gather_fronts(f)
    return dict(tiny=f.tiny_pivots, executor=f.executor["executor"],
                on_host=f.on_host,
                fronts=[(lp.numpy(), up.numpy()) for lp, up in full]
                if grid.rank == 0 else None)


def grid_fused_deadline(tc, grid):
    """executor="fused" on the grid with and without a deadline: what
    ran each time."""
    from superlu_dist_tpu_torch.utils.deadline import Deadline
    lu, bvals, _ = slt.analyze(slt.Options(), gallery.poisson2d(8),
                               device="cpu")
    ran = []
    for deadline in (Deadline(3600.0, comm=grid), None):
        f = numeric_factorize(lu.plan, bvals, lu.anorm, dtype=torch.float64,
                              device="cpu", executor="fused", grid=grid,
                              deadline=deadline)
        ran.append(f.executor["executor"])
    return tuple(ran)


def grid_graphs_on_the_card(tc, grid, spec, executor):
    """On the card (float32, the default tier): ``executor`` ("fused" or
    "mega") on the grid with the partitioned pool — the first call
    captures, two more on the same values replay — against the 2-D
    stream on the same card: the gathered fronts of the two replays bit
    for bit, the first call's against the stream's (bit for bit or the
    normwise drift), the tiny counts, the launches of each call and the
    executor's report."""
    from superlu_dist_tpu_torch.numeric import kernels
    a, _ = _system(spec)
    lu, bvals, _ = slt.analyze(slt.Options(), a, device=grid.device)
    ref = numeric_factorize(lu.plan, bvals, lu.anorm, dtype=torch.float32,
                            device=grid.device, grid=grid, executor="stream",
                            pool_partition=True)
    gref = gather_fronts(ref)
    runs, launches = [], []
    for _ in range(3):
        kernels.reset_launches()
        f = numeric_factorize(lu.plan, bvals, lu.anorm, dtype=torch.float32,
                              device=grid.device, grid=grid,
                              executor=executor, pool_partition=True)
        torch.cuda.synchronize()
        launches.append(kernels.LAUNCHES["front_assemble"])
        runs.append((gather_fronts(f), f.tiny_pivots))
        if len(runs) == 1:
            warm = f.executor["warm_up_launches"]
    num = den = 0.0
    for (l1, u1), (l2, u2) in zip(runs[0][0], gref):
        for x, y in ((l1, l2), (u1, u2)):
            if x.numel():
                num = max(num, float((x.double() - y.double()).abs().max()))
                den = max(den, float(y.double().abs().max()))
    return dict(replays_equal=_equal_fronts(runs[1][0], runs[2][0]),
                first_equals_replay=_equal_fronts(runs[0][0], runs[1][0]),
                equal=_equal_fronts(runs[0][0], gref),
                drift=num / max(den, 1e-300),
                tiny=[t for _, t in runs] + [ref.tiny_pivots],
                launches=launches, warm_up_launches=warm,
                owned_groups=shard_record(f, grid.nproc,
                                          grid.rank)["owned_groups"],
                executor=f.executor)


def grid_offload_on_the_card(tc, grid, spec):
    """On the card: the 2-D stream with the partitioned pool and
    ``front_bytes_limit=0`` — where each front and pivot stack lies
    (pinned host memory), the device peak during the factorization
    against the non-offloaded run's, and the collective solve in host
    memory against the device factors' solve."""
    a, b = _system(spec)
    lu, bvals, _ = slt.analyze(slt.Options(), a, device=grid.device)
    peaks, facts = [], []
    for limit in (6e9, 0):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        f = numeric_factorize(lu.plan, bvals, lu.anorm, dtype=torch.float32,
                              device=grid.device, grid=grid,
                              executor="stream", pool_partition=True,
                              front_bytes_limit=limit)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
        facts.append(f)
    dev_f, host_f = facts
    rhs = np.random.default_rng(5).standard_normal((lu.n, 2))
    s_host, s_dev = SpmdSolver(host_f), SpmdSolver(dev_f)
    x_host, x_dev = s_host.solve(rhs), s_dev.solve(rhs)
    return dict(on_host=host_f.on_host,
                pinned=all(t.device.type == "cpu" and t.is_pinned()
                           for pair in host_f.fronts for t in pair
                           if t.numel()),
                pivots_pinned=all(p.device.type == "cpu" and p.is_pinned()
                                  for p in host_f.shard.pivots if p.numel()),
                equal=_equal_fronts(gather_fronts(host_f),
                                    [(lp.cpu(), up.cpu())
                                     for lp, up in gather_fronts(dev_f)]),
                peaks=peaks, solver_device=str(s_host.device),
                x_rel=float(np.abs(x_host - x_dev).max()
                            / np.abs(x_dev).max()),
                executor=host_f.executor)


def _grid_numeric(ex, vals, thresh, dtype=torch.float64):
    """One call of a grid executor ``ex`` on pattern values ``vals`` at
    tiny-pivot threshold ``thresh``, as a NumericFactorization (what
    ``gather_fronts`` takes)."""
    from superlu_dist_tpu_torch.numeric.factor import NumericFactorization
    real = torch.empty((), dtype=dtype).real.dtype
    fronts, tiny, shard = ex(torch.as_tensor(np.asarray(vals)).to(dtype),
                             torch.tensor(thresh, dtype=real))
    return NumericFactorization(plan=ex.plan, fronts=fronts,
                                tiny_pivots=int(tiny), dtype=dtype,
                                gemm_prec=ex.gemm_prec,
                                offload=ex.offload, executor=ex.report(),
                                shard=shard)


def level_vs_group(tc, grid, plan, vals, thresh, partition, offload="none"):
    """``MeshStreamExecutor`` at "level" and at "group" on the grid (float64,
    ``offload``): this rank's fronts and pivot stacks bit for bit, the
    tiny counts, the reports' granularity and the level executor's units;
    rank 0 also returns the level run's fronts gathered to slot order."""
    from superlu_dist_tpu_torch.parallel.mesh_stream import (
        MeshStreamExecutor)
    runs = {}
    for gran in ("group", "level"):
        ex = MeshStreamExecutor(plan, torch.float64, grid.device, grid,
                                pool_partition=partition, offload=offload,
                                granularity=gran)
        runs[gran] = (ex, _grid_numeric(ex, vals, thresh))
    (eg, ng), (el, nl) = runs["group"], runs["level"]
    full = gather_fronts(nl)
    return dict(
        equal=_equal_fronts(nl.fronts, ng.fronts),
        pivots_equal=all(torch.equal(a, b) for a, b in
                         zip(nl.shard.pivots, ng.shard.pivots)),
        tiny=(nl.tiny_pivots, ng.tiny_pivots),
        granularity=(nl.executor["granularity"], ng.executor["granularity"]),
        executor=(nl.executor["executor"], type(el).__name__),
        units=len(el.units()), groups=len(plan.groups),
        on_host=sorted({str(t.device) for pair in nl.fronts for t in pair}),
        fronts=[(lp.cpu().numpy(), up.cpu().numpy()) for lp, up in full]
        if grid.rank == 0 else None)


#: the grid executors whose spans ``traced_grid_spans`` reads
TRACED = ("group", "level", "fused", "mega", "spmd")


def traced_grid_spans(tc, grid, plan, vals, thresh, path):
    """Per executor of TRACED, one untraced and one traced call on this
    rank under a file ``Tracer`` at ``path`` + the executor + rank: its
    kernel and dispatch spans (name, args), ``last_profile`` before and
    after, and whether the traced call's fronts equal the untraced one's
    bit for bit."""
    import json
    from superlu_dist_tpu_torch.obs import trace
    from superlu_dist_tpu_torch.parallel.mesh_graphs import (
        MeshFusedExecutor, MeshMegaExecutor)
    from superlu_dist_tpu_torch.parallel.mesh_stream import (
        MeshStreamExecutor)
    from superlu_dist_tpu_torch.parallel.spmd import SpmdFactorExecutor
    args = (plan, torch.float64, grid.device, grid)
    make = {"group": lambda: MeshStreamExecutor(*args, pool_partition=True),
            "level": lambda: MeshStreamExecutor(*args, pool_partition=True,
                                                granularity="level"),
            "fused": lambda: MeshFusedExecutor(*args, pool_partition=True),
            "mega": lambda: MeshMegaExecutor(*args, pool_partition=True),
            "spmd": lambda: SpmdFactorExecutor(*args)}
    out = {}
    for name in TRACED:
        ex = make[name]()
        plain = _grid_numeric(ex, vals, thresh)
        before = getattr(ex, "last_profile", None)
        file = f"{path}_{name}_r{grid.rank}.json"
        t = trace.Tracer(file)
        prev = trace.install(t)
        try:
            traced = _grid_numeric(ex, vals, thresh)
        finally:
            trace.install(prev)
            t.close()
        events = json.load(open(file))["traceEvents"]
        out[name] = dict(
            kernel=[(e["name"], e["dur"], e.get("args", {}))
                    for e in events if e["cat"] == "kernel"],
            dispatch=[e["name"] for e in events if e["cat"] == "dispatch"],
            profile_before=before,
            profile=getattr(ex, "last_profile", None),
            equal=_equal_fronts(traced.fronts, plain.fronts),
            units=len(ex.units()) if hasattr(ex, "units") else None)
    return out
