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


def mesh_entry_mismatch(tc, grid, spec):
    """pgssvx(grid=) where rank 1 asks for a device that is not its grid
    rank's (the card, on a CPU grid): the mesh tier's entry check is
    collective, so every rank raises instead of rank 0 waiting in the
    tier's first collective for a rank that left."""
    a, b = _system(spec)
    part, b_loc = _mine(a, b, grid)
    try:
        pgssvx(tc, slt.Options(), part, b_loc, grid=grid,
               device="cuda" if grid.rank == 1 else None)
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


def audit_divergence(tc, grid, diverge):
    """A program submitted to the program audit on every rank, its
    collectives rank-dependent with ``diverge`` (rank 0 all-gathers, the
    others sum), the same on every rank without: the audit's digest
    exchange raises ProgramAuditError on every rank, or passes on every
    rank."""
    from superlu_dist_tpu_torch.utils import programaudit
    from superlu_dist_tpu_torch.utils.errors import ProgramAuditError

    def prog(t, g):
        if diverge and g.rank == 0:
            return g.all_gather(t)
        return g.all_reduce_sum(t)
    programaudit._reset()
    try:
        stats = programaudit.maybe_audit("test.divergence", "prog", prog,
                                         (torch.ones(4), grid))
    except ProgramAuditError as e:
        return {"error": type(e).__name__, "rules": e.rules,
                "message": str(e)}
    return {"error": None, "stats": stats}


def audit_peer_finding(tc, grid):
    """A grid program under every audit whose narrowing copy (SLU115)
    only rank 0 makes, its collectives the same on every rank: the
    error each rank raises and its rules."""
    from superlu_dist_tpu_torch.testing.ranks import audit_knobs
    from superlu_dist_tpu_torch.utils.errors import PrecisionAuditError

    def prog(t, g):
        x = t.to(torch.float32) + 1 if g.rank == 0 else t + 1
        return g.all_reduce_sum(x)
    try:
        with audit_knobs() as programaudit:
            programaudit.maybe_audit("test.peer", "prog", prog,
                                     (torch.ones(4, dtype=torch.float64),
                                      grid))
    except PrecisionAuditError as e:
        return {"error": type(e).__name__, "rules": e.rules}
    return {"error": None}


def audited_grid_fact(tc, grid, nx):
    """The 2-D executor (MESH_2D: stream, pool_partition) on poisson2d(nx):
    a FACT with the audits off, then one with every audit on, on a fresh
    executor: its audit block, each program's collective digest, and
    whether its fronts, pivot stacks and tiny count equal the first's."""
    from superlu_dist_tpu_torch.testing.ranks import audit_knobs
    a = gallery.poisson2d(nx)
    lu, bvals, _ = slt.analyze(slt.Options(), a, device="cpu")
    kw = dict(device="cpu", executor="stream", grid=grid,
              pool_partition=True)
    f0 = numeric_factorize(lu.plan, bvals, lu.anorm, **kw)
    lu.plan.__dict__.pop("_factor_fns", None)
    with audit_knobs() as programaudit:
        f1 = numeric_factorize(lu.plan, bvals, lu.anorm, **kw)
        blk = programaudit.audit_block()
        digests = {lbl: st["digest"] for (_, lbl), st
                   in programaudit.get_auditor().audited.items()}
    equal = (all(torch.equal(p[0], q[0]) and torch.equal(p[1], q[1])
                 for p, q in zip(f0.fronts, f1.fronts))
             and all(torch.equal(p, q) for p, q in zip(f0.shard.pivots,
                                                       f1.shard.pivots))
             and f0.tiny_pivots == f1.tiny_pivots)
    return {"findings": blk["findings"], "sites": blk["sites"],
            "digests": digests, "equal": equal}


def spmd_sharding_verdict(tc, grid, nx):
    """The spmd factorization of poisson3d(nx) under the sharding audit:
    "clean", or the rules of the ShardingAuditError every rank raises
    (its gathers deliver each group's pivot and Schur blocks to every
    rank)."""
    from superlu_dist_tpu_torch.utils import programaudit
    from superlu_dist_tpu_torch.utils.errors import ShardingAuditError
    lu, bvals, _ = slt.analyze(slt.Options(), gallery.poisson3d(nx),
                               device="cpu")
    programaudit._reset()
    try:
        numeric_factorize(lu.plan, bvals, lu.anorm, device="cpu",
                          executor="spmd", grid=grid)
    except ShardingAuditError as e:
        return e.rules
    finally:
        programaudit._reset()
    return "clean"


def _budget(grid, plan, dtype, executor, partition, budget):
    """A rank's fake budget: ``budget`` itself, or for "offloaded" the
    executor's own offloaded estimate on this rank (read from a probe
    built with no budget, so with no exchange; every rank probes)."""
    from superlu_dist_tpu_torch.numeric import factor, stream
    if budget != "offloaded":
        return budget
    stream.device_budget = lambda device: None
    probe = factor.get_executor(plan, dtype, executor, None, "cpu",
                                grid=grid, pool_partition=partition)
    plan.__dict__.pop("_factor_fns", None)
    return probe.device_estimate()["offload_bytes"]


def offload_rule_ranks(tc, grid, plan, dt, budgets, cards):
    """The card's offload rule (``front_bytes_limit=None``) on a grid of
    CPU ranks, rank r reading the fake budget ``budgets[r]`` (a number,
    None, or "offloaded": the executor's own offloaded estimate) on the
    fake card ``cards[r]`` (``numeric/stream.device_budget`` and
    ``card_key`` replaced here): per executor the grid resolves through
    ``get_executor`` (spmd, the 2-D stream, mesh mega), its offload, its
    rule record, its own estimate and its pool's elements (spmd's is the
    plan's: every rank allocates the whole pool)."""
    from superlu_dist_tpu_torch.numeric import factor, stream
    dtype = getattr(torch, dt)
    stream.card_key = lambda device: cards[grid.rank]
    out = {}
    for executor, partition in (("auto", False), ("stream", True),
                                ("mega", False)):
        budget = _budget(grid, plan, dtype, executor, partition,
                         budgets[grid.rank])
        stream.device_budget = lambda device: budget
        ex = factor.get_executor(plan, dtype, executor, None, "cpu",
                                 grid=grid, pool_partition=partition)
        out[ex.name] = (ex.offload, ex.report()["offload_rule"],
                        ex.device_estimate(),
                        plan.pool_size if ex.name == "spmd"
                        else ex._pool_len())
    plan.__dict__.pop("_factor_fns", None)
    return out


def refused_rule_ranks(tc, grid, plan, dt, budgets, cards):
    """The card's rule on a grid of CPU ranks (as ``offload_rule_ranks``)
    for every grid executor — spmd, the 2-D stream, mesh mega and mesh
    fused, which cannot offload: per executor the choice, or the
    ``DeviceMemoryError`` this rank raised (its executor, budget, its
    card's ranks and the cards that do not fit offloaded)."""
    from superlu_dist_tpu_torch.numeric import factor, stream
    from superlu_dist_tpu_torch.utils.errors import DeviceMemoryError
    dtype = getattr(torch, dt)
    stream.card_key = lambda device: cards[grid.rank]
    out = {}
    for name, executor, partition in (("spmd", "auto", False),
                                      ("mesh-stream", "stream", True),
                                      ("mesh-mega", "mega", False),
                                      ("mesh-fused", "fused", True)):
        budget = _budget(grid, plan, dtype, executor, partition,
                         budgets[grid.rank])
        stream.device_budget = lambda device: budget
        try:
            ex = factor.get_executor(plan, dtype, executor, None, "cpu",
                                     grid=grid, pool_partition=partition)
            out[name] = ("built", ex.name, ex.offload)
        except DeviceMemoryError as e:
            out[name] = ("refused", e.executor, e.budget,
                         e.parts["card_ranks"], e.parts["cards_refused"],
                         e.offloads)
        plan.__dict__.pop("_factor_fns", None)
    return out


def shared_card_ranks(tc, grid, plan, dt, cards):
    """Per grid executor (spmd, the 2-D stream, mesh mega) built with
    offload="none": the card's rule over the grid when each rank's
    budget is the mean over the ranks of that executor's estimate plus
    its offloaded estimate (each rank's estimate is its own share's, so
    the ranks' differ), rank r on the fake card ``cards[r]``."""
    from superlu_dist_tpu_torch.numeric import stream
    from superlu_dist_tpu_torch.parallel.mesh_graphs import MeshMegaExecutor
    from superlu_dist_tpu_torch.parallel.mesh_stream import (
        MeshStreamExecutor)
    from superlu_dist_tpu_torch.parallel.spmd import SpmdFactorExecutor
    dtype = getattr(torch, dt)
    stream.card_key = lambda device: cards[grid.rank]
    out = {}
    for cls, kw in ((SpmdFactorExecutor, {}),
                    (MeshStreamExecutor, {"pool_partition": True}),
                    (MeshMegaExecutor, {})):
        ex = cls(plan, dtype, grid.device, grid, offload="none", **kw)
        est = ex.device_estimate()
        budget = int(grid.allreduce_sum_any(np.array(
            [est["bytes"] + est["offload_bytes"]]))[0]) // grid.nproc
        stream.device_budget = lambda device: budget
        out[ex.name] = stream.offload_rule(plan, dtype, grid.device, None,
                                           grid=grid,
                                           estimate=ex.device_estimate)
    return out


def rank_sum(tc, grid, k):
    """(the grid's size, the sum over its ranks of ``k + rank``): one
    all-reduce, which reaches only this grid's ranks."""
    vec = np.array([float(k + grid.rank)])
    return grid.nproc, int(grid.allreduce_sum_any(vec)[0])


#: the grid's graph executors, by the name the capture tests give them
GRAPH_EXECUTORS = ("fused", "level", "mega")


def _graph_executor(name, plan, dtype, grid, partition=True):
    """The grid's graph executor ``name`` of GRAPH_EXECUTORS on ``plan``,
    its offload "none" (mesh fused has none)."""
    from superlu_dist_tpu_torch.parallel.mesh_graphs import (
        MeshFusedExecutor, MeshMegaExecutor)
    from superlu_dist_tpu_torch.parallel.mesh_stream import (
        MeshStreamExecutor)
    if name == "fused":
        return MeshFusedExecutor(plan, dtype, grid.device, grid,
                                 pool_partition=partition)
    if name == "mega":
        return MeshMegaExecutor(plan, dtype, grid.device, grid,
                                pool_partition=partition, offload="none")
    return MeshStreamExecutor(plan, dtype, grid.device, grid,
                              pool_partition=partition, offload="none",
                              granularity="level")


def unit_groups(name, ex) -> list:
    """The groups of each unit graph executor ``ex`` (of GRAPH_EXECUTORS
    ``name``) captures on an NCCL grid, in call order: a group (fused), a
    schedule wave (level, ``units()``), a closed key (mega, ``key_of``)."""
    if name == "fused":
        return [(gi,) for gi in range(len(ex.plan.groups))]
    if name == "level":
        return [tuple(range(lo, hi)) for lo, hi in ex.units()]
    keys = {}
    for gi, key in enumerate(ex.key_of):
        keys.setdefault(key, []).append(gi)
    return [tuple(g) for g in keys.values()]


def _counts(pairs) -> list:
    return [(np.asarray(s).tolist(), np.asarray(r).tolist())
            for s, r in pairs]


def unit_plans(tc, grid, plan):
    """Per graph executor of GRAPH_EXECUTORS with the partitioned pool:
    the groups of each unit its graphs are captured for on NCCL, per
    group the exchange counts its programs issue here (gloo), (send,
    receive) by peer rank, and mega's padded to its group shapes (what
    it issues on NCCL); and the 2-D stream's estimate of this rank's
    device bytes (float32, the card's rule's)."""
    from superlu_dist_tpu_torch.parallel.mesh_stream import (
        MeshStreamExecutor)
    out = {"estimate": MeshStreamExecutor(
        plan, torch.float32, grid.device, grid,
        pool_partition=True).device_estimate()}
    for name in GRAPH_EXECUTORS:
        ex = _graph_executor(name, plan, torch.float64, grid)
        out[name] = dict(
            units=unit_groups(name, ex),
            levels=[g.level for g in plan.groups],
            keys=getattr(ex, "key_of", None),
            counts=_counts(ex.exchange_counts()),
            own=_counts((gl.send_counts, gl.recv_counts)
                        for gl in ex.layout.groups))
        if name == "mega":
            legs = ex._padded_legs()
            out[name]["padded"] = _counts(legs[(g.w, g.u)]
                                          for g in plan.groups)
    return out


def recorded_programs(tc, grid, plan, vals, thresh, diverge):
    """The grid fused executor's group programs driven the way a capture
    on an NCCL grid drives them — inside ``grid.recording()``, answered
    into the static buffers — here on gloo CPU ranks with verify mode on:
    whether any verify check ran while a program recorded, the checks
    ``grid.check_tape`` ran after each, the records, and the fronts and
    tiny count against the eager 2-D executor's.  ``diverge``: rank 1's
    record of group 0's exchange says another shape (a program that
    diverged), which ``check_tape`` must refuse on every rank."""
    from superlu_dist_tpu_torch.parallel import grid as grid_mod
    from superlu_dist_tpu_torch.parallel.mesh_stream import (
        MeshStreamExecutor, drive)
    from superlu_dist_tpu_torch.utils.errors import CollectiveMismatchError
    dtype = torch.float64
    ex = _graph_executor("fused", plan, dtype, grid)
    bufs = ex._buffers(torch.as_tensor(np.asarray(vals)).to(dtype),
                       torch.tensor(thresh, dtype=dtype))
    run, states = ex._static_collective(bufs), ex._device_state()
    checks = []
    real_check = grid_mod.ProcessGrid._check

    def counted(self, *a, **kw):
        checks.append(self.tape is not None)
        return real_check(self, *a, **kw)
    grid_mod.ProcessGrid._check = counted
    fronts, records, ops, nbytes = [], 0, set(), 0
    try:
        for gi in range(len(plan.groups)):
            with grid.recording() as tape:
                fronts.append(ex._finish(gi, *drive(
                    ex._group(gi, states[gi], bufs), run), clone=True))
            if diverge and grid.rank == 1 and gi == 0:
                tape[-1] = dict(tape[-1], shape=(grid.nproc + 1,))
            try:
                grid.check_tape(tape)
            except CollectiveMismatchError as e:
                return dict(raised=True, during=any(checks),
                            message=str(e)[:200])
            records += len(tape)
            ops |= {r["op"] for r in tape}
            nbytes += sum(r["bytes"] for r in tape)
    finally:
        grid_mod.ProcessGrid._check = real_check
    tiny = int(grid.all_reduce_sum(bufs.tiny))
    want = _grid_numeric(MeshStreamExecutor(plan, dtype, grid.device, grid,
                                            pool_partition=True),
                         vals, thresh)
    return dict(raised=False, during=any(checks), checked=len(checks),
                records=records, ops=sorted(ops), bytes=nbytes,
                same=_equal_fronts([f[:2] for f in fronts], want.fronts),
                tiny=(tiny, want.tiny_pivots))


def grid_units_on_distinct_cards(tc, grid, specs, names):
    """On a grid of distinct cards (NCCL), per (spec, graph executor of
    ``names``) in float32 at the default tier with the partitioned pool:
    the eager 2-D executor, then the graph executor's capturing call and
    a replay on the values × 1.5 (against the eager executor on those),
    with what crossed the host — the collectives issued from the host
    during the replay, pinned staging — the unit graphs against the
    census (records at the capture, none at the replay, no retrace) and,
    for fused and mega, gssvx(grid=) with the executor: its BERR."""
    import torch.distributed as dist
    from superlu_dist_tpu_torch.numeric.stream import RETRACE_SENTINEL
    from superlu_dist_tpu_torch.obs.compilestats import COMPILE_STATS
    from superlu_dist_tpu_torch.parallel import grid as grid_mod
    from superlu_dist_tpu_torch.parallel.mesh_graphs import UNIT_SITE
    from superlu_dist_tpu_torch.parallel.mesh_stream import (
        MeshStreamExecutor)
    calls = {"issued": 0, "pinned": 0}
    real = {k: getattr(dist, k) for k in ("broadcast", "all_to_all_single",
                                          "all_gather")}
    real_pinned = grid_mod._pinned

    def counting(fn):
        def run(*a, **kw):
            calls["issued"] += 1
            return fn(*a, **kw)
        return run

    def pinned(t):
        calls["pinned"] += 1
        return real_pinned(t)
    grid_mod._pinned = pinned
    for k, fn in real.items():
        setattr(dist, k, counting(fn))
    out = {}
    try:
        for spec in specs:
            a, b = _system(spec)
            lu, bvals, _ = slt.analyze(slt.Options(), a, device=grid.device)
            plan = lu.plan
            thresh = float(np.sqrt(np.finfo(np.float32).eps) * lu.anorm)
            ref = MeshStreamExecutor(plan, torch.float32, grid.device, grid,
                                     pool_partition=True)
            want = [_grid_numeric(ref, bvals * s, thresh, torch.float32)
                    for s in (1.0, 1.5)]
            for name in names:
                ex = _graph_executor(name, plan, torch.float32, grid)
                runs = []
                for s in (1.0, 1.5):
                    mark = (COMPILE_STATS.marker(), RETRACE_SENTINEL.total)
                    calls["issued"] = 0
                    num = _grid_numeric(ex, bvals * s, thresh, torch.float32)
                    torch.cuda.synchronize(grid.device)
                    recs = COMPILE_STATS.records[mark[0]:]
                    runs.append(dict(
                        units=sum(r.site == UNIT_SITE for r in recs),
                        retraces=RETRACE_SENTINEL.total - mark[1],
                        issued=calls["issued"], tiny=num.tiny_pivots,
                        equal=_equal_fronts(num.fronts, want[len(runs)].fronts),
                        drift=_max_rel(num.fronts, want[len(runs)].fronts),
                        comm=dict(ex.last_comm)))
                rec = dict(runs=runs, graph_units=len(unit_groups(name, ex)),
                           report=ex.report(), groups=len(plan.groups),
                           tiny_eager=[w.tiny_pivots for w in want])
                if name != "level":
                    x, lu2, st, info = slt.gssvx(
                        slt.Options(executor=name, pool_partition=True), a,
                        b, grid=grid)
                    rec.update(berr=st.solve_report.berr, info=info,
                               executor=st.executor["executor"])
                out[(spec[1][0], name)] = rec
                plan.__dict__.pop("_factor_fns", None)
                del ex
    finally:
        grid_mod._pinned = real_pinned
        for k, fn in real.items():
            setattr(dist, k, fn)
    return dict(backend=grid.backend, staged=grid.staged,
                capturable=grid.capturable, pinned=calls["pinned"],
                device=str(grid.device), runs=out)


def graph_executors_vs_2d(tc, grid, plan, vals, thresh):
    """Per graph executor of GRAPH_EXECUTORS (float64, the partitioned
    pool; on the CPU their programs run eagerly, mega's on its padded
    tables), and mega with its exchange legs padded as on NCCL ("mega
    padded", ``pad_legs``): this rank's fronts and pivot stacks against
    the eager 2-D executor's, bit for bit, the tiny counts, and on rank
    0 the fronts gathered to slot order."""
    from superlu_dist_tpu_torch.parallel.mesh_stream import (
        MeshStreamExecutor)
    want = _grid_numeric(MeshStreamExecutor(plan, torch.float64,
                                            grid.device, grid,
                                            pool_partition=True),
                         vals, thresh)
    out = {}
    for name in GRAPH_EXECUTORS + ("mega padded",):
        ex = _graph_executor(name.split()[0], plan, torch.float64, grid)
        if name == "mega padded":
            ex.pad_legs = True
        num = _grid_numeric(ex, vals, thresh)
        full = gather_fronts(num)
        out[name] = dict(
            equal=_equal_fronts(num.fronts, want.fronts),
            pivots=all(torch.equal(p, q) for p, q in
                       zip(num.shard.pivots, want.shard.pivots)),
            tiny=(num.tiny_pivots, want.tiny_pivots),
            executor=num.executor["executor"],
            fronts=[(lp.numpy(), up.numpy()) for lp, up in full]
            if grid.rank == 0 else None)
    return out


def traced_peak(tc, grid, nx):
    """The 2-D stream through pgssvx(grid=) over poisson3d(nx)'s closed
    plan with the partitioned pool, this CPU rank's device memory traced
    from FACT to the end of the call (``testing/livebytes.py``): the
    peak, the card's rule's estimate, and whether every kept front slice
    lies in a storage of its own size."""
    from superlu_dist_tpu_torch.testing.livebytes import trace_pgssvx
    a, b = _system(("poisson3d", (nx,), 0, None))
    _, lu, rec = trace_pgssvx(tc, grid, a, b, slt.Options(
        executor="stream", pool_partition=True, bucket_closed=True))
    own = all(t.untyped_storage().nbytes() == t.numel() * t.element_size()
              for front in lu.numeric.fronts for t in front)
    return dict(peak=rec["peak"], estimate=rec["estimate"]["bytes"],
                own=own, slices=2 * len(lu.numeric.fronts))


def rule_on_own_cards(tc, grid, plan, dt, budgets):
    """The card's rule on a grid of CPU ranks, each on a fake card of its
    own (``card_key`` the grid rank) with the fake budget
    ``budgets[rank]`` ("own": the executor's estimate on this rank;
    "offloaded": its offloaded one; "below": one byte below that): per
    executor — mesh mega, which can offload, and mesh fused, which cannot
    — the choice or the refusal, this rank's estimate and the rule's
    record of its card."""
    from superlu_dist_tpu_torch.numeric import factor, stream
    from superlu_dist_tpu_torch.utils.errors import DeviceMemoryError
    dtype = getattr(torch, dt)
    card_key, device_budget = stream.card_key, stream.device_budget
    try:
        return _rule_on_own_cards(grid, plan, dtype, budgets)
    finally:
        stream.card_key, stream.device_budget = card_key, device_budget


def _rule_on_own_cards(grid, plan, dtype, budgets):
    from superlu_dist_tpu_torch.numeric import factor, stream
    from superlu_dist_tpu_torch.utils.errors import DeviceMemoryError
    stream.card_key = lambda device: 100 + grid.rank
    out = {}
    for executor in ("mega", "fused"):
        stream.device_budget = lambda device: None
        probe = factor.get_executor(plan, dtype, executor, None, "cpu",
                                    grid=grid, pool_partition=True)
        est = probe.device_estimate()
        plan.__dict__.pop("_factor_fns", None)
        want = budgets[grid.rank]
        budget = {"own": est["bytes"], "offloaded": est["offload_bytes"],
                  "below": est["offload_bytes"] - 1}.get(want, want)
        stream.device_budget = lambda device: budget
        try:
            ex = factor.get_executor(plan, dtype, executor, None, "cpu",
                                     grid=grid, pool_partition=True)
            out[executor] = dict(kind="built", offload=ex.offload,
                                 rule=ex.report()["offload_rule"], est=est,
                                 budget=budget)
        except DeviceMemoryError as e:
            out[executor] = dict(kind="refused", executor=e.executor,
                                 budget=e.budget, parts=e.parts,
                                 remedies=e.remedies, est=est)
        plan.__dict__.pop("_factor_fns", None)
    return out


def suite(tc, grid, items):
    """Several cases on one spawned grid, in order: ``items`` is a list
    of (label, the name of a function of this module, its arguments
    after ``tc, grid``); returns {label: its result}."""
    return {label: globals()[fn](tc, grid, *args)
            for label, fn, args in items}


def row_suite(tc, grid, items):
    """``suite`` on this rank's process row of ``grid`` as a 1 × npcol
    grid of its own (``gridmap``, every rank making every row's in one
    order): the row grids' cases beside the whole grid's, on one
    spawned world."""
    from superlu_dist_tpu_torch.parallel.grid import gridmap
    rows = [gridmap([r * grid.npcol + c for c in range(grid.npcol)], 1,
                    grid.npcol, device=grid.device)
            for r in range(grid.nprow)]
    return suite(tc, rows[grid.prow], items)


# ---- the spmd tier captured (parallel/spmd.py on a capturable grid) -----

class _EagerGraph:
    """``numeric/fused.Graph`` on the CPU, for the spmd executor's capture
    path on a grid that claims to be capturable (:func:`eager_capture`):
    the function runs once at the "capture" (inside the executor's
    recording) — the capture and the replay right after it on the card —
    and each later replay runs it again inside a recording of its own (no
    host check runs for its collectives, as for a graph's) and writes its
    outputs into the first run's, as a graph rewrites its static
    outputs.  One census record a graph, as ``Graph``."""

    grid = None          # the capturable stand-in the replays record on

    def __init__(self, fn, device, stream, pool=None, *, site, key):
        import time
        from superlu_dist_tpu_torch.obs.compilestats import COMPILE_STATS
        self.fn, self.outputs, self.fresh = fn, fn(), True
        self.capture_s = self.instantiate_s = 0.0
        self.nodes, self.device_bytes, self.host_bytes = None, 0, 0
        self.replays, self.launches = 0, {}
        COMPILE_STATS.record(site, key, time.perf_counter(), 0.0)

    def replay(self):
        self.replays += 1
        if self.fresh:
            self.fresh = False
            return self.outputs
        with _EagerGraph.grid.recording():
            new = self.fn()
        for out, t in zip(self.outputs, new):
            out.copy_(t)
        return self.outputs


def _capturable(grid):
    """``grid`` as a grid whose collectives a CUDA graph could hold: the
    same groups, ``comm`` and ``seq`` records, ``capturable`` True."""
    import dataclasses
    from superlu_dist_tpu_torch.parallel.grid import ProcessGrid

    class CapturableGrid(ProcessGrid):
        capturable = True
    return CapturableGrid(**{f.name: getattr(grid, f.name)
                             for f in dataclasses.fields(grid)})


class eager_capture:
    """Within the block the spmd executor's capture path runs on CPU
    ranks: ``grid`` as a capturable grid (the block's value),
    ``fused.Graph`` → :class:`_EagerGraph`, the warm-up run in place, no
    capture stream and no graph pool."""

    def __init__(self, grid):
        self.grid = _capturable(grid)

    def __enter__(self):
        from superlu_dist_tpu_torch.numeric import fused
        from superlu_dist_tpu_torch.ops import dense

        def warm_up(step, keys, stream):
            seen = {}
            for i, key in keys:
                seen.setdefault(key, i)
            for i in seen.values():
                step(i)
            return 0.0
        self.saved = (fused.Graph, fused.warm_up, dense.capture_stream,
                      torch.cuda.graph_pool_handle)
        _EagerGraph.grid = self.grid
        fused.Graph, fused.warm_up = _EagerGraph, warm_up
        dense.capture_stream = lambda device: None
        torch.cuda.graph_pool_handle = lambda: None
        return self.grid

    def __exit__(self, *exc):
        from superlu_dist_tpu_torch.numeric import fused
        from superlu_dist_tpu_torch.ops import dense
        (fused.Graph, fused.warm_up, dense.capture_stream,
         torch.cuda.graph_pool_handle) = self.saved
        _EagerGraph.grid = None
        return False


class _counted_checks:
    """Within the block every verify check of a grid collective is noted:
    ``flags`` holds, per check, whether a capture was recording."""

    def __enter__(self):
        from superlu_dist_tpu_torch.parallel.grid import ProcessGrid
        self.real, self.flags = ProcessGrid._check, []
        flags, real = self.flags, self.real

        def counted(grid, *a, **kw):
            flags.append(grid.tape is not None)
            return real(grid, *a, **kw)
        ProcessGrid._check = counted
        return self

    def __exit__(self, *exc):
        from superlu_dist_tpu_torch.parallel.grid import ProcessGrid
        ProcessGrid._check = self.real
        return False


def _recorded_solve(s, rhs, mode):
    """``s``'s sweeps of ``mode`` on ``rhs`` (n, k) driven as a capture
    drives them: each inside the solver's own recording hook (which runs
    ``check_tape`` after it) on a bucket's (n+1, kb) buffers; x (n, k)."""
    from superlu_dist_tpu_torch.solve.plan import chunk_nrhs
    n, k = rhs.shape
    (_, _, kb), = chunk_nrhs(k, s.splan.nrhs_bucket_set)
    x = torch.zeros((n + 1, kb), dtype=s.fact.dtype)
    x[:n, :k] = torch.as_tensor(rhs, dtype=s.fact.dtype)
    lsum = torch.zeros_like(x)
    for direction in ("fwd", "bwd"):
        with s._recording((direction, mode, kb)):
            s._sweep(direction, mode, x, lsum)
    return x[:n, :k].numpy()


def _solves_recorded_vs_eager(fact, grid, rhs):
    """SpmdSolver on ``fact``: its sweeps recorded (``_recorded_solve``)
    against its eager solves at NOTRANS (nrhs 1 and all of ``rhs``'s
    columns) and TRANS, bit for bit; the verify checks during and after
    the recordings; the records' ops; x at NOTRANS."""
    s = SpmdSolver(fact, fused=False)
    out, xs = {}, {}
    with _counted_checks() as checks:
        for name, mode, r in (("N1", "N", rhs[:, :1]), ("N", "N", rhs),
                              ("T", "T", rhs)):
            xs[name] = _recorded_solve(s, r, mode)
    eager = {"N1": s.solve(rhs[:, :1]), "N": s.solve(rhs),
             "T": s.solve_trans(rhs)}
    for name, x in xs.items():
        out[name] = bool(np.array_equal(x, eager[name].reshape(x.shape)))
    tapes = list(s._tapes.values())
    return dict(equal=out, during=any(checks.flags),
                checked=len(checks.flags),
                records=sum(len(t) for t in tapes),
                ops=sorted({r["op"] for t in tapes for r in t}),
                x=xs["N"], label=s._label("N", 4), site=s.audit_site,
                fused=s.fused)


def spmd_captured(tc, grid, plan, vals, anorm, rhs):
    """The spmd executor (float64) captured as on an NCCL grid — its
    group programs recorded, one "graph" a group (``eager_capture``) —
    called twice with SLU_TPU_VERIFY_COLLECTIVES on, against the eager
    spmd executor on the same grid: fronts, pivot stacks and tiny count
    bit for bit at both calls; the census records, retraces and verify
    checks of each call; the gathers counted at the replay; the report;
    then the recorded solver sweeps against the eager ones on these
    shards and on the 2-D tier's (the eager 2-D executor's, partitioned
    pool).  Rank 0 also returns the captured fronts gathered to slot
    order and x."""
    from superlu_dist_tpu_torch.numeric.stream import RETRACE_SENTINEL
    from superlu_dist_tpu_torch.obs.compilestats import COMPILE_STATS
    from superlu_dist_tpu_torch.parallel import spmd
    from superlu_dist_tpu_torch.parallel.mesh_stream import (
        MeshStreamExecutor)
    from superlu_dist_tpu_torch.parallel.spmd import (UNIT_SITE,
                                                      SpmdFactorExecutor)
    dtype = torch.float64
    thresh = float(np.sqrt(np.finfo(np.float64).eps) * anorm)
    want = _grid_numeric(SpmdFactorExecutor(plan, dtype, grid.device, grid),
                         vals, thresh)
    calls = []
    with eager_capture(grid) as cgrid:
        # every Schur block written one slice copy a slot (the card's way
        # for large blocks), against the eager executor's indexed writes
        saved, spmd.SLOT_COPY_ELEMS = spmd.SLOT_COPY_ELEMS, 1
        try:
            ex = SpmdFactorExecutor(plan, dtype, cgrid.device, cgrid)
            ex._write_maps()
        finally:
            spmd.SLOT_COPY_ELEMS = saved
        for _ in range(2):
            mark = (COMPILE_STATS.marker(), RETRACE_SENTINEL.total,
                    dict(cgrid.comm.get("gather_rows", {"calls": 0})))
            with _counted_checks() as checks:
                num = _grid_numeric(ex, vals, thresh)
            recs = COMPILE_STATS.records[mark[0]:]
            calls.append(dict(
                graphs=sum(r.site == UNIT_SITE for r in recs),
                retraces=RETRACE_SENTINEL.total - mark[1],
                during=any(checks.flags), checked=len(checks.flags),
                gathers=cgrid.comm["gather_rows"]["calls"]
                - mark[2]["calls"],
                equal=_equal_fronts(num.fronts, want.fronts),
                pivots=all(torch.equal(p, q) for p, q in
                           zip(num.shard.pivots, want.shard.pivots)),
                tiny=(num.tiny_pivots, want.tiny_pivots)))
        rep = ex.report()
        records = [t for _, t in ex._graphs.values()]
        full = gather_fronts(num)
    two_d = _grid_numeric(MeshStreamExecutor(plan, dtype, grid.device, grid,
                                             pool_partition=True),
                          vals, thresh)
    out = dict(calls=calls, groups=len(plan.groups),
               graph_kind=rep.get("graph_kind"), graphs=rep.get("graphs"),
               capture=rep["capture"], estimate=ex.device_estimate(),
               slot_writes=sum(w is not None and not torch.is_tensor(w[0])
                               for w in ex._write_maps()),
               eager_capture=want.executor["capture"],
               ops=sorted({r["op"] for t in records for r in t}),
               gathered=sum(r["op"] == "gather_rows"
                            for t in records for r in t),
               solve_1d=_solves_recorded_vs_eager(want, grid, rhs),
               solve_2d=_solves_recorded_vs_eager(two_d, grid, rhs))
    if grid.rank == 0:
        out["fronts"] = [(lp.numpy(), up.numpy()) for lp, up in full]
    return out


def spmd_capture_diverged(tc, grid, plan, vals, anorm):
    """The captured spmd executor (``eager_capture``, verify mode on) with
    rank 1's record of group 0's first gather saying another shape (a
    program that diverged): ``check_tape`` must raise
    CollectiveMismatchError on every rank before the group's graph would
    first run, and no check ran while a program recorded."""
    from superlu_dist_tpu_torch.parallel.grid import ProcessGrid
    from superlu_dist_tpu_torch.parallel.spmd import SpmdFactorExecutor
    from superlu_dist_tpu_torch.utils.errors import CollectiveMismatchError
    real = ProcessGrid.check_tape

    def diverge(self, tape):
        if self.rank == 1 and tape:
            tape[0] = dict(tape[0], shape=(tape[0]["shape"][0] + 1,)
                           + tuple(tape[0]["shape"][1:]))
        return real(self, tape)
    thresh = float(np.sqrt(np.finfo(np.float64).eps) * anorm)
    ProcessGrid.check_tape = diverge
    try:
        with eager_capture(grid) as cgrid, _counted_checks() as checks:
            ex = SpmdFactorExecutor(plan, torch.float64, cgrid.device, cgrid)
            try:
                _grid_numeric(ex, vals, thresh)
            except CollectiveMismatchError as e:
                return dict(raised=True, during=any(checks.flags),
                            message=str(e)[:200], graphs=len(ex._graphs))
    finally:
        ProcessGrid.check_tape = real
    return dict(raised=False, during=any(checks.flags))


def spmd_graph_decision(tc, grid, plan, vals, anorm):
    """Which sweeps SpmdSolver captures, with FUSE_MAX_BATCHES at 0 (every
    plan over it): on a capturable grid (the stand-in) it captures, on
    this gloo grid it does not, and asking a gloo grid's solver for
    graphs raises; the capturing spmd executor asked of a gloo grid
    raises too."""
    import dataclasses
    from superlu_dist_tpu_torch.parallel.spmd import SpmdFactorExecutor
    from superlu_dist_tpu_torch.solve import device
    fact = numeric_factorize(plan, vals, anorm, dtype=torch.float64,
                             device="cpu", executor="spmd", grid=grid)
    saved, device.FUSE_MAX_BATCHES = device.FUSE_MAX_BATCHES, 0
    refused = []
    try:
        with eager_capture(grid) as cgrid:
            shard = dataclasses.replace(fact.shard, grid=cgrid)
            capturable = SpmdSolver(dataclasses.replace(fact, shard=shard))
        gloo = SpmdSolver(fact)
        for make in (lambda: SpmdSolver(fact, fused=True),
                     lambda: SpmdFactorExecutor(plan, torch.float64,
                                                grid.device, grid,
                                                capture=True)):
            try:
                make()
                refused.append(False)
            except ValueError:
                refused.append(True)
    finally:
        device.FUSE_MAX_BATCHES = saved
    return dict(batches=len(gloo.splan.groups), capturable=capturable.fused,
                gloo=gloo.fused, refused=refused)


def spmd_capture_peak(tc, grid, nx):
    """The captured spmd executor (``eager_capture``, float32, the scatter
    and the panel LU quiet as ``testing/livebytes.trace_pgssvx`` has them)
    on poisson3d(nx): this CPU rank's device memory traced over its
    capturing call, a replay, the grid solver's construction and a
    solve (``testing/livebytes.LiveBytes``), against its estimate with
    ``capture`` (the card's rule's bytes) and the eager executor's.  The
    graph path takes the scatter kernel only (``fused.check_graph_scatter``),
    which a quiet wrapper is not: that check is off here."""
    from superlu_dist_tpu_torch.numeric import fused
    from superlu_dist_tpu_torch.numeric.factor import NumericFactorization
    from superlu_dist_tpu_torch.parallel.spmd import SpmdFactorExecutor
    from superlu_dist_tpu_torch.testing.livebytes import LiveBytes
    lu, bvals, _ = slt.analyze(slt.Options(), gallery.poisson3d(nx),
                               device="cpu")
    plan, dtype = lu.plan, torch.float32
    thresh = torch.tensor(float(np.sqrt(np.finfo(np.float32).eps)
                                * lu.anorm), dtype=dtype)
    avals = torch.as_tensor(np.asarray(bvals)).to(dtype)
    rhs = np.random.default_rng(5).standard_normal((plan.n, 1))
    mode = LiveBytes()
    with eager_capture(grid) as cgrid:
        ex = SpmdFactorExecutor(plan, dtype, cgrid.device, cgrid)
        eager = SpmdFactorExecutor(plan, dtype, grid.device, grid)
        est = ex.device_estimate()
        ex.scatter, ex.panel = mode.quiet(ex.scatter), mode.quiet(ex.panel)
        check, fused.check_graph_scatter = (fused.check_graph_scatter,
                                            lambda scatter: None)
        try:
            with mode:
                for _ in range(2):
                    fronts, tiny, shard = ex(avals, thresh)
                fact = NumericFactorization(plan=plan, fronts=fronts,
                                            tiny_pivots=int(tiny),
                                            dtype=dtype, shard=shard)
                SpmdSolver(fact, fused=False).solve(rhs)
        finally:
            fused.check_graph_scatter = check
    return dict(peak=mode.peak, estimate=est["bytes"],
                eager=eager.device_estimate()["bytes"],
                graph_bytes=est["graph_bytes"])


def spmd_on_distinct_cards(tc, grid, specs):
    """On a grid of distinct cards (NCCL), per spec in float32 at the
    default tier: the eager spmd executor (``capture=False``) on the
    values and on the values × 1.5, then the captured one — its capturing
    call and a replay on the values × 1.5 — each call against the eager
    run on the same values: this rank's fronts and pivot stacks bit for
    bit, the tiny counts; the group graphs in the census (spmd.unit) at
    the capture and none at the replay, the retraces, the collectives the
    replay issued from the host; then the grid solver on the captured
    shards, its sweeps captured (``SpmdSolver`` on this grid) against its
    eager sweeps (``fused=False``) at nrhs 1 and 4: x bit for bit, the
    sweep graphs (solve.spmd) at a bucket's first solve, and at its
    second none and no collective issued from the host."""
    import torch.distributed as dist
    from superlu_dist_tpu_torch.numeric.stream import RETRACE_SENTINEL
    from superlu_dist_tpu_torch.obs.compilestats import COMPILE_STATS
    from superlu_dist_tpu_torch.parallel.spmd import (UNIT_SITE,
                                                      SpmdFactorExecutor)
    issued = [0]
    real = {k: getattr(dist, k) for k in ("broadcast", "all_to_all_single",
                                          "all_gather",
                                          "all_gather_into_tensor")}

    def counting(fn):
        def run(*a, **kw):
            issued[0] += 1
            return fn(*a, **kw)
        return run
    for k, fn in real.items():
        setattr(dist, k, counting(fn))
    out = {}
    try:
        for spec in specs:
            a, _ = _system(spec)
            lu, bvals, _ = slt.analyze(slt.Options(), a, device=grid.device)
            plan, dt = lu.plan, torch.float32
            thresh = float(np.sqrt(np.finfo(np.float32).eps) * lu.anorm)
            eager = SpmdFactorExecutor(plan, dt, grid.device, grid,
                                       capture=False)
            want = [_grid_numeric(eager, bvals * s, thresh, dt)
                    for s in (1.0, 1.5)]
            ex = SpmdFactorExecutor(plan, dt, grid.device, grid)
            runs = []
            for s, w in zip((1.0, 1.5), want):
                mark = (COMPILE_STATS.marker(), RETRACE_SENTINEL.total)
                issued[0] = 0
                num = _grid_numeric(ex, bvals * s, thresh, dt)
                torch.cuda.synchronize(grid.device)
                recs = COMPILE_STATS.records[mark[0]:]
                runs.append(dict(
                    graphs=sum(r.site == UNIT_SITE for r in recs),
                    retraces=RETRACE_SENTINEL.total - mark[1],
                    issued=issued[0], tiny=(num.tiny_pivots, w.tiny_pivots),
                    equal=_equal_fronts(num.fronts, w.fronts),
                    drift=_max_rel(num.fronts, w.fronts),
                    pivots=all(torch.equal(p, q) for p, q in
                               zip(num.shard.pivots, w.shard.pivots))))
            rhs = np.random.default_rng(9).standard_normal((plan.n, 4))
            s_eager, s_graphs = SpmdSolver(num, fused=False), SpmdSolver(num)
            solves = {}
            for k in (1, 4):
                x0 = s_eager.solve(rhs[:, :k])
                solves[k] = []
                for _ in range(2):
                    mark = COMPILE_STATS.marker()
                    issued[0] = 0
                    x = s_graphs.solve(rhs[:, :k])
                    solves[k].append(dict(
                        equal=bool(np.array_equal(x, x0)),
                        diff=float(np.abs(x - x0).max()), issued=issued[0],
                        graphs=sum(r.site == "solve.spmd" for r in
                                   COMPILE_STATS.records[mark:])))
            out[spec[1][0]] = dict(runs=runs, groups=len(plan.groups),
                                   report=ex.report(), fused=s_graphs.fused,
                                   solves=solves,
                                   retraces=RETRACE_SENTINEL.total)
            plan.__dict__.pop("_factor_fns", None)
            del ex, eager, s_eager, s_graphs
    finally:
        for k, fn in real.items():
            setattr(dist, k, fn)
    return dict(backend=grid.backend, capturable=grid.capturable,
                device=str(grid.device), runs=out)
