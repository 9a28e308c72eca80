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
                executor=st.executor,
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
