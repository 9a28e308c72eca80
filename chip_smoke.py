#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (superlu_dist_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one result line each:
  1. card     — the card's name and power limit (nvidia-smi);
  2. build    — compile the CUDA kernels from csrc/ with nvcc (sm_90a);
  3. kernels  — each kernel against its plain PyTorch version on the card
                (torch.equal) at the shapes of the n=110,592 plan's largest
                child set / assembly group and on a small case full of
                sentinels, with its time, bound, plain time and the time of
                one library call as a yardstick;
  4. gssvx    — the main path: gssvx on poisson3d(48) (n=110,592) with
                float32 factors on the card and float64 refinement, with
                the kernels' launch counts over exactly that call;
  5. check    — a small poisson3d factored through the kernels and through
                the plain versions (identical fronts required), and a small
                solve against scipy's sparse direct solver in float64.

Then a JSON line with one record per kernel, the card line again, and the
last line {"ok": true, "device": {...}}.  Any failure raises and exits
non-zero; without a CUDA device it exits non-zero before any result.
"""

import json
import subprocess
import sys
import time

import numpy as np

#: H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and
#: float32 rate outside the tensor cores (the kernels' adds)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
NX = 48                  # poisson3d grid edge of the main path: n = 110,592
SEED = 0


def say(phase, **fields):
    print(f"{phase}: " + json.dumps(fields), flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() on the card over reps calls (CUDA events,
    after two warm-up calls)."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def extend_add_targets(f, pool, m, ub, off, slot, rel):
    """Flat front targets and pool values of one child set (every pair
    the kernel adds), for the bound and the library yardstick."""
    import torch
    live = (slot >= 0) & (slot < f.shape[0]) & (off >= 0) & (off < pool.numel())
    off, slot, rel = off[live], slot[live], rel[live]
    ii = torch.arange(ub, device=f.device)
    src = off[:, None, None] + ii[None, :, None] * ub + ii[None, None, :]
    ri, rj = rel[:, :, None], rel[:, None, :]
    hit = (ri >= 0) & (ri < m) & (rj >= 0) & (rj < m) & (src < pool.numel())
    dst = slot[:, None, None] * (m * m) + ri * m + rj
    return dst[hit], pool[src[hit]]


def measure_extend_add(grp, cs, pool, torch, kernels, gen, i64):
    """K1 on one child set of the plan: kernel vs plain (torch.equal),
    kernel / plain / library times and the byte bound."""
    m, ub = grp.m, cs.ub
    f = torch.randn((grp.batch, m * m), generator=gen, device="cuda",
                    dtype=torch.float32)
    ea = (m, ub, i64(cs.child_off), i64(cs.child_slot), i64(cs.rel))
    out_k, out_p = f.clone(), f.clone()
    kernels.extend_add_(out_k, pool, *ea)
    kernels.extend_add_plain(out_p, pool, *ea)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    if not torch.equal(out_k, out_p):
        raise AssertionError(f"extend_add kernel != plain (max |d| {err})")
    dst, vals = extend_add_targets(f, pool, *ea)
    n_pairs = int(dst.numel())
    n_targets = int(torch.unique(dst).numel())
    nbytes = (n_pairs * 4 + 2 * n_targets * 4 + cs.rel.size * 8
              + 2 * len(cs.child_off) * 8)
    b_ms, b_by = bound_ms(nbytes, n_pairs)
    work = f.clone()
    flat = work.view(-1)
    return dict(
        name="extend_add", route="cuda",
        source="superlu_dist_tpu_torch/csrc/extend_add.cu",
        replaces="superlu_dist_tpu/numeric/pallas_kernels.py:144",
        shape=dict(batch=grp.batch, m=m, ub=ub, children=len(cs.child_off),
                   pairs=n_pairs, targets=n_targets),
        max_abs_err=err,
        ms=cuda_ms(lambda: kernels.extend_add_(work, pool, *ea), 20),
        plain_ms=cuda_ms(lambda: kernels.extend_add_plain(work, pool, *ea),
                         3),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: flat.index_put_((dst,), vals,
                                                   accumulate=True), 20))


def kernel_phase(plan, torch, kernels, gen):
    """Phase 3: both kernels against their plain versions on the card.
    K1 runs at the child set with the most work and, for the record only,
    at the one with the most children."""
    dev = torch.device("cuda")

    def i64(x):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.int64),
                               device=dev)

    sets = [(g, c) for g in plan.groups for c in g.children]
    largest = max(sets, key=lambda gc: len(gc[1].child_off) * gc[1].ub ** 2)
    most = max(sets, key=lambda gc: len(gc[1].child_off))
    agrp = max(plan.groups, key=lambda g: len(g.a_src))
    f32 = torch.float32
    pool = torch.randn(plan.pool_size, generator=gen, device=dev, dtype=f32)
    avals = torch.randn(len(plan.pattern_indices), generator=gen, device=dev,
                        dtype=f32)

    # --- K1 at the largest child set, plus the sentinel case -----------
    if not sentinel_extend_add(torch, kernels, gen):
        raise AssertionError("extend_add kernel != plain on the sentinel case")
    records = [measure_extend_add(*largest, pool, torch, kernels, gen, i64)]
    say("kernels_extra", most_children=measure_extend_add(
        *most, pool, torch, kernels, gen, i64))

    # --- K2 at the largest assembly group, plus the sentinel case ------
    m2 = agrp.m * agrp.m
    f = torch.randn((agrp.batch, m2), generator=gen, device=dev, dtype=f32)
    asm = (i64(agrp.a_slot), i64(agrp.a_flat), i64(agrp.a_src))
    out_k, out_p = f.clone(), f.clone()
    kernels.assemble_(out_k, avals, *asm)
    kernels.assemble_plain(out_p, avals, *asm)
    torch.cuda.synchronize()
    equal = torch.equal(out_k, out_p)
    err = float((out_k - out_p).abs().max())
    if not (equal and sentinel_assemble(torch, kernels, gen)):
        raise AssertionError(f"assemble kernel != plain (max |d| {err})")
    n = len(agrp.a_src)
    dst = asm[0] * m2 + asm[1]
    vals = avals[asm[2]]
    b_ms, b_by = bound_ms(n * 3 * 8 + n * 4 + 2 * n * 4, n)
    work = f.clone()
    flat = work.view(-1)
    records.append(dict(
        name="assemble", route="cuda",
        source="superlu_dist_tpu_torch/csrc/assemble.cu",
        replaces="superlu_dist_tpu/numeric/pallas_kernels.py:201",
        shape=dict(batch=agrp.batch, m=agrp.m, entries=n),
        max_abs_err=err,
        ms=cuda_ms(lambda: kernels.assemble_(work, avals, *asm), 50),
        plain_ms=cuda_ms(lambda: kernels.assemble_plain(work, avals, *asm),
                         20),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: flat.index_put_((dst,), vals,
                                                   accumulate=True), 50)))
    return records


def sentinel_extend_add(torch, kernels, gen):
    """Small child set with every sentinel (OOB offset, OOB slot, rel == m
    padding) and repeated parent slots sharing targets."""
    dev = torch.device("cuda")
    m, ub, batch, pool_len = 12, 5, 3, 200
    rng = np.random.default_rng(SEED)
    off = torch.tensor([0, 25, 50, 75, 100, pool_len, 150], device=dev)
    slot = torch.tensor([1, 0, 1, 1, 2, 1, batch], device=dev)
    rel = np.full((7, ub), m, dtype=np.int64)
    shared = rng.choice(m, size=4, replace=False)
    for c in range(7):
        rel[c, :4] = shared if c in (0, 2, 3, 5) else rng.choice(
            m, size=4, replace=False)
    rel = torch.as_tensor(rel, device=dev)
    ok = True
    for dt in (torch.float32, torch.float64):
        pool = torch.randn(pool_len, generator=gen, device=dev, dtype=dt)
        f = torch.randn((batch, m * m), generator=gen, device=dev, dtype=dt)
        a, b = f.clone(), f.clone()
        kernels.extend_add_(a, pool, m, ub, off, slot, rel)
        kernels.extend_add_plain(b, pool, m, ub, off, slot, rel)
        ok &= torch.equal(a, b) and not torch.equal(a, f)
    return bool(ok)


def sentinel_assemble(torch, kernels, gen):
    """Small assembly with dropped slots and out-of-range sources."""
    dev = torch.device("cuda")
    batch, m2, n_avals = 4, 81, 50
    rng = np.random.default_rng(SEED + 1)
    pairs = rng.choice(batch * m2, size=30, replace=False)
    slot = torch.as_tensor(np.concatenate([pairs // m2, np.full(7, batch)]),
                           device=dev)
    flat = torch.as_tensor(np.concatenate([pairs % m2, np.zeros(7, np.int64)]),
                           device=dev)
    src = torch.as_tensor(np.concatenate([rng.integers(0, n_avals + 3, 30),
                                          np.full(7, n_avals)]), device=dev)
    ok = True
    for dt in (torch.float32, torch.float64):
        avals = torch.randn(n_avals, generator=gen, device=dev, dtype=dt)
        f = torch.randn((batch, m2), generator=gen, device=dev, dtype=dt)
        a, b = f.clone(), f.clone()
        kernels.assemble_(a, avals, slot, flat, src)
        kernels.assemble_plain(b, avals, slot, flat, src)
        ok &= torch.equal(a, b) and not torch.equal(a, f)
    return bool(ok)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import superlu_dist_tpu_torch as slt
    from superlu_dist_tpu_torch.models.gallery import poisson3d
    from superlu_dist_tpu_torch.numeric import factor, kernels
    from superlu_dist_tpu_torch.utils import tols

    # 1. card
    card = card_line()
    say("card", nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda)

    # 2. build
    t0 = time.perf_counter()
    lib = kernels.build()
    kernels._library()
    say("build", seconds=time.perf_counter() - t0, library=str(lib))

    # 3. kernels, at the shapes of the main path's plan
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    a = poisson3d(NX)
    t0 = time.perf_counter()
    lu0, bvals0, _ = slt.analyze(slt.Options(), a, device="cuda")
    plan = lu0.plan
    say("plan", n=plan.n, groups=len(plan.groups),
        supernodes=plan.sf.n_supernodes, pool=plan.pool_size,
        flops=plan.flops, analysis_s=time.perf_counter() - t0)
    records = kernel_phase(plan, torch, kernels, gen)
    for rec in records:
        say("kernels", **rec)

    # 4. the main path: gssvx on poisson3d(48), f32 factors, f64 refine
    rng = np.random.default_rng(SEED)
    x_true = rng.standard_normal(a.n_rows)
    b = a.matvec(x_true)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    x, lu, stats, info = slt.gssvx(slt.Options(factor_dtype="float32"), a, b,
                                   device="cuda")
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if info != 0 or x is None or x.shape != b.shape:
        raise AssertionError(f"gssvx failed: info={info}")
    if not np.all(np.isfinite(x)):
        raise AssertionError("gssvx returned non-finite values")
    berr = lu.berrs[-1]
    relres = float(np.linalg.norm(b - a.matvec(x)) / np.linalg.norm(b))
    analysis = sum(stats.utime[p] for p in ("EQUIL", "ROWPERM", "COLPERM",
                                            "ETREE", "SYMBFACT", "DIST"))
    say("gssvx", n=a.n_rows, nnz=a.nnz, info=info, wall_s=wall,
        analysis_s=analysis, phase_s=stats.utime,
        factor_gflops=lu.plan.flops / stats.utime["FACT"] / 1e9,
        structural_flops=lu.plan.flops, groups=len(lu.plan.groups),
        tiny_pivots=stats.tiny_pivots, refine_steps=stats.refine_steps,
        berr=berr, berr_history=lu.berrs,
        berr_target=float(tols.berr_target(np.float64)), rel_residual=relres,
        rel_error=float(np.linalg.norm(x - x_true) / np.linalg.norm(x_true)),
        max_memory_allocated=peak, launches=launches)
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    if berr > tols.berr_target(np.float64):
        raise AssertionError(f"BERR {berr} above berr_target(float64)")
    for rec in records:
        rec["launches"] = launches[rec["name"]]

    # where the factor time goes: the same factorization (phase 3's
    # analysis is the same deterministic host work), synchronized at every
    # stage boundary of every group
    del lu, x
    timings = {}
    t0 = time.perf_counter()
    factor.numeric_factorize(plan, bvals0, lu0.anorm, dtype=torch.float32,
                             device="cuda", timings=timings)
    say("factor_stages", seconds=timings,
        total_s=time.perf_counter() - t0)
    del lu0, plan, bvals0

    # 5. kernels vs plain through the factorization, and a small solve
    small = poisson3d(16)
    lus, bvals, _ = slt.analyze(slt.Options(), small, device="cuda")
    fk = factor.numeric_factorize(lus.plan, bvals, lus.anorm,
                                  dtype=torch.float32, device="cuda")
    fp = factor.numeric_factorize(lus.plan, bvals, lus.anorm,
                                  dtype=torch.float32, device="cuda",
                                  scatter=factor.PLAIN)
    same = all(torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
               for k, p in zip(fk.fronts, fp.fronts))
    if not same:
        raise AssertionError("fronts through the kernels != plain versions")
    import scipy.sparse
    import scipy.sparse.linalg
    tiny = poisson3d(12)
    bt = rng.standard_normal(tiny.n_rows)
    xt, _, _, info = slt.gssvx(slt.Options(factor_dtype="float32"), tiny, bt,
                               device="cuda")
    sp = scipy.sparse.csr_matrix((tiny.data, tiny.indices, tiny.indptr),
                                 shape=tiny.shape)
    x_ref = scipy.sparse.linalg.spsolve(sp.tocsc(), bt)
    agree = bool(np.allclose(xt, x_ref, rtol=tols.DEVICE_VS_HOST_RTOL,
                             atol=tols.DEVICE_VS_HOST_ATOL))
    say("check", fronts_equal=same, groups=len(fk.fronts),
        scipy_agrees=agree,
        max_abs_diff=float(np.abs(xt - x_ref).max()))
    if info != 0 or not agree:
        raise AssertionError("small solve disagrees with scipy")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
