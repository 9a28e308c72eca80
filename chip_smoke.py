#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (superlu_dist_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one result line each (the launch counts of every phase that
drives the port are reset just before it and checked just after):
  1. card     — the card's name and power limit (nvidia-smi);
  2. build    — compile the CUDA kernels from csrc/ with nvcc (sm_90a);
     native   — compile the native host-analysis library (native/
                slu_host.cpp, g++) and hold each of its functions against
                its Python twin on poisson3d(16) and random_sparse(2000):
                etree, postorder, symbolic, mmd, colamd, the AᵀA pattern
                equal, and the MC64 matching's diagonal product;
  3. plan     — the default analysis of poisson3d(48) (n=110,592): its
                backend, phase seconds and native calls, and its plan,
                which must be the JAX package's default plan;
     maps     — the plan's index maps built and uploaded (host seconds;
                the main path does this inside FACT);
     kernels  — the front-assembly kernel against its plain PyTorch version
                on the card (torch.equal) at two groups of the n=110,592
                plan (the one with the most child pairs, the one holding
                the set with the most children) and on a small group full
                of sentinels, in float32, float64, complex64 and
                complex128, and on a group of full complex tiles; the
                standalone K1/K2 wrappers at the plan's largest child set /
                assembly group and on sentinel cases; each with its time
                (ms: device time, launches replayed in a CUDA graph;
                call_ms: call by call, host included), bound, plain time
                and the time of one library call as a yardstick; the
                residual SpMV kernel (csr_spmv) against its plain twin at
                the main path's operator in all four types (torch.equal),
                timed beside torch.sparse.mm;
  4. gssvx    — the main path: gssvx(Options()) on poisson3d(48)
                (n=110,592): float32 factors at the default GEMM tier
                (TF32) on the card, the dataflow solve schedule fused in
                CUDA graphs, float64 refinement with its residual through
                csr_spmv, the ladder when refinement misses;
     reuse    — on that handle: a FACTORED solve, a TRANS solve, refactor
                on perturbed values (equal to a fresh factorization),
                SamePattern_SameRowPerm, condest, the residual-precision
                rung;
     complex  — a complex Helmholtz-type operator on the same pattern,
                factored in complex64 on the same plan, and a CONJ solve;
     solve    — on the main path's factors: the dataflow / level / factor
                solve plans (the JAX package's 90 / 106 / 134 batches), and
                nrhs 1, 16 and 1,500 fused and eager, with and without
                DiagInv: SOLVE seconds, last_solve_stats, solver memory,
                BERR after refinement;
     gemm_tiers — gssvx on poisson3d(48) at the bf16 and f32 tiers beside
                the main path's default: FACT, refine steps, rungs, BERR;
  5. factor_stages — the main path's factorization synchronized at every
                stage boundary of every group;
  6. kernels_factor — one more factorization with CUDA events around every
                front-assembly launch (no stage synchronize), then every
                group, child set and assembly of the plan replayed alone
                for the kernel / plain / library / bound sums (the front
                assembly also in complex64 and complex128);
  7. complex_dofact — gssvx from scratch on helmholtz_2d(333) (n=110,889);
  8. ladder   — the escalation ladder (its gemm-precision rung live) on a
                near-singular arrowhead and on hilbert(8), float32 factors;
     orderings — DOFACT gssvx on random_sparse(2000) with ColPerm COLAMD,
                ColPerm MMD_ATA and RowPerm LargeDiag_AWPM;
  9. check    — a small poisson3d factored through the kernel and through
                the plain version (identical fronts required), and small
                NOTRANS / TRANS / CONJ solves against scipy's sparse direct
                solver in float64.

Every DOFACT analysis runs in the native library; its calls are counted
(native.CALLS, reset just before each such phase) and printed on the
phase's line.  Then a JSON line with one record per kernel, the card
line again, and the last line {"ok": true, "device": {...}}.  Any
failure raises and exits non-zero; without a CUDA device it exits
non-zero before any result.
"""

import json
import subprocess
import sys
import time

import numpy as np

#: H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth, and the
#: float32 / float64 rates outside the tensor cores (the kernels' adds),
#: by component type (a complex add is two adds of its component type)
HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"float32": 67e12, "float64": 34e12}
NX = 48                  # poisson3d grid edge of the main path: n = 110,592
SEED = 0
KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
SOURCE = "superlu_dist_tpu_torch/csrc/front_assemble.cu"
K1 = "superlu_dist_tpu/numeric/pallas_kernels.py:144"
K2 = "superlu_dist_tpu/numeric/pallas_kernels.py:201"
ANALYSIS = ("EQUIL", "ROWPERM", "COLPERM", "ETREE", "SYMBFACT", "DIST")
#: the JAX package's default plan of poisson3d(48), its native library on
#: (its drivers/gssvx.py ``analyze(Options(), poisson3d(48))`` on the CPU);
#: the port's default analysis must give the same
JAX_PLAN = {"supernodes": 3858, "groups": 134, "flops": 161000016540.0}


START = time.perf_counter()


def say(phase, **fields):
    """One result line; ``at_s`` is the script's elapsed seconds."""
    fields["at_s"] = round(time.perf_counter() - START, 3)
    print(f"{phase}: " + json.dumps(fields), flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warm=2):
    """Mean milliseconds of fn() on the card over reps calls (CUDA events,
    after warm-up calls)."""
    import torch
    for _ in range(warm):
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


def graph_ms(fn, n=10, reps=5):
    """Device milliseconds of one fn() call: n calls captured in one CUDA
    graph and replayed reps times, so the host's per-call overhead (the
    wrapper's Python, ctypes) drops out of the kernel's time."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / (reps * n)
    del graph
    return ms


def bound(nbytes, adds, dtype):
    """(ms, "bytes" | "operations"): the least time of the work — nbytes
    moved, and ``adds`` adds of ``dtype`` (2 flops of the component type
    for a complex add)."""
    import torch
    comp = torch.empty((), dtype=dtype).real.dtype
    flops = adds * (2 if dtype.is_complex else 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FLOPS_PER_S[str(comp).split(".")[-1]] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def set_targets(batch, pool, m, ub, off, slot, rel):
    """Flat front targets and pool values of one child set (every pair
    the kernel adds), for the bound and the library yardstick."""
    import torch
    live = (slot >= 0) & (slot < batch) & (off >= 0) & (off < pool.numel())
    off, slot, rel = off[live], slot[live], rel[live]
    ii = torch.arange(ub, device=pool.device)
    src = off[:, None, None] + ii[None, :, None] * ub + ii[None, None, :]
    ri, rj = rel[:, :, None], rel[:, None, :]
    hit = (ri >= 0) & (ri < m) & (rj >= 0) & (rj < m)
    dst = slot[:, None, None] * (m * m) + ri * m + rj
    src, dst = src[hit], dst[hit]
    vals = pool[src.clamp(max=pool.numel() - 1)]
    return dst, torch.where(src < pool.numel(), vals, 0), int(
        (src < pool.numel()).sum())


def assemble_targets(batch, m2, avals, a_slot, a_flat, a_src):
    import torch
    keep = (a_slot >= 0) & (a_slot < batch) & (a_flat >= 0) & (a_flat < m2)
    src = a_src[keep]
    ok = (src >= 0) & (src < avals.numel())
    vals = torch.where(ok, avals[src.clamp(0, avals.numel() - 1)], 0)
    return a_slot[keep] * m2 + a_flat[keep], vals, int(ok.sum())


def front_targets(avals, pool, m, w, gm):
    """Every (flat target, value) the front assembly adds into zeros —
    identity, A entries, child pairs — and the values it reads."""
    import torch
    batch = gm.ws.shape[0]
    k = torch.arange(m, device=pool.device)
    diag = (k[None, :] >= gm.ws[:, None]) & (k[None, :] < w)
    s, kk = torch.nonzero(diag, as_tuple=True)
    dsts = [s * (m * m) + kk * (m + 1)]
    vals = [torch.ones(s.numel(), dtype=pool.dtype, device=pool.device)]
    d, v, n_a = assemble_targets(batch, m * m, avals, gm.a_slot, gm.a_flat,
                                 gm.a_src)
    dsts.append(d)
    vals.append(v)
    n_pool = 0
    for ub, off, slot, rel in gm.children:
        d, v, n = set_targets(batch, pool, m, ub, off, slot, rel)
        dsts.append(d)
        vals.append(v)
        n_pool += n
    return torch.cat(dsts), torch.cat(vals), n_a, n_pool


def time_front(avals, pool, m, w, gm, kernels, reps=20, plain_reps=3,
               lib_reps=10):
    """front_assemble_ on one group: equality with the plain version and
    kernel / plain / library times and the bound."""
    import torch
    out_k = kernels.front_assemble_(avals, pool, m, w, gm)
    out_p = kernels.front_assemble_plain(avals, pool, m, w, gm)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max()) if out_k.numel() else 0.0
    if not torch.equal(out_k, out_p):
        raise AssertionError(f"front_assemble kernel != plain (max |d| {err})")
    dst, vals, n_a, n_pool = front_targets(avals, pool, m, w, gm)
    fm = gm.front
    isz = pool.element_size()
    batch = fm.batch
    nbytes = (batch * m * m * isz + (n_pool + n_a) * isz + fm.nbytes
              + gm.ws.numel() * 8)
    b_ms, b_by = bound(nbytes, dst.numel(), pool.dtype)
    del out_k, out_p

    def library():
        torch.zeros((batch, m * m), dtype=pool.dtype,
                    device=pool.device).view(-1).index_put_(
                        (dst,), vals, accumulate=True)
    def call():
        kernels.front_assemble_(avals, pool, m, w, gm)
    return dict(
        max_abs_err=err, ms=graph_ms(call, n=reps),
        call_ms=cuda_ms(call, reps),
        plain_ms=cuda_ms(lambda: kernels.front_assemble_plain(
            avals, pool, m, w, gm), plain_reps, warm=1),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(library, lib_reps, warm=1),
        shape=dict(batch=batch, m=m, w=w, sets=len(gm.children),
                   children=[len(c[1]) for c in gm.children],
                   max_children_at_a_slot=int(fm.ch_ptr.diff().max())
                   if batch else 0, a=fm.n_a, pairs=n_pool, bytes=nbytes))


def time_extend_add(f, pool, m, ub, off, slot, rel, kernels, reps=20,
                    plain_reps=3, lib_reps=20, wrapper=True):
    """K1 on one child set: the wrapper against the plain version, and the
    kernel's time on maps built once (the wrapper rebuilds them on the
    host at every call; with ``wrapper`` that is timed apart as
    wrapper_ms)."""
    import torch
    ea = (m, ub, off, slot, rel)
    out_k, out_p = f.clone(), f.clone()
    kernels.extend_add_(out_k, pool, *ea)
    kernels.extend_add_plain(out_p, pool, *ea)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    if not torch.equal(out_k, out_p):
        raise AssertionError(f"extend_add kernel != plain (max |d| {err})")
    dst, vals, n_pool = set_targets(f.shape[0], pool, *ea)
    n_targets = int(torch.unique(dst).numel())
    isz = f.element_size()
    nbytes = (n_pool * isz + 2 * n_targets * isz + rel.numel() * 8
              + 2 * off.numel() * 8)
    b_ms, b_by = bound(nbytes, dst.numel(), f.dtype)
    maps = kernels.build_front_maps(
        f.shape[0], m, pool.numel(), device=f.device, kind="extend_add",
        children=[(ub, off.cpu().numpy(), slot.cpu().numpy(),
                   rel.cpu().numpy())])
    work = f.clone()
    flat = work.view(-1)
    def call():
        kernels.launch_(work, maps, pool=pool)
    extra = dict(wrapper_ms=cuda_ms(
        lambda: kernels.extend_add_(work, pool, *ea), 3, warm=1)) if wrapper \
        else {}
    return dict(
        max_abs_err=err, ms=graph_ms(call, n=reps),
        call_ms=cuda_ms(call, reps), **extra,
        plain_ms=cuda_ms(lambda: kernels.extend_add_plain(work, pool, *ea),
                         plain_reps, warm=1),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: flat.index_put_((dst,), vals,
                                                   accumulate=True), lib_reps),
        shape=dict(batch=f.shape[0], m=m, ub=ub, children=off.numel(),
                   pairs=dst.numel(), targets=n_targets))


def time_assemble(f, avals, a_slot, a_flat, a_src, kernels, reps=20,
                  plain_reps=20, lib_reps=50, wrapper=True):
    """K2 on one group, as time_extend_add does K1."""
    import torch
    asm = (a_slot, a_flat, a_src)
    out_k, out_p = f.clone(), f.clone()
    kernels.assemble_(out_k, avals, *asm)
    kernels.assemble_plain(out_p, avals, *asm)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    if not torch.equal(out_k, out_p):
        raise AssertionError(f"assemble kernel != plain (max |d| {err})")
    batch, m2 = f.shape
    m = int(round(m2 ** 0.5))
    dst, vals, n_read = assemble_targets(batch, m2, avals, *asm)
    n = a_src.numel()
    isz = f.element_size()
    b_ms, b_by = bound(n * 3 * 8 + n_read * isz + 2 * dst.numel() * isz,
                       dst.numel(), f.dtype)
    maps = kernels.build_front_maps(
        batch, m, 0, device=f.device, kind="assemble",
        a=tuple(t.cpu().numpy() for t in asm))
    work = f.clone()
    flat = work.view(-1)
    def call():
        kernels.launch_(work, maps, avals=avals)
    extra = dict(wrapper_ms=cuda_ms(
        lambda: kernels.assemble_(work, avals, *asm), 3, warm=1)) if wrapper \
        else {}
    return dict(
        max_abs_err=err, ms=graph_ms(call, n=reps),
        call_ms=cuda_ms(call, reps), **extra,
        plain_ms=cuda_ms(lambda: kernels.assemble_plain(work, avals, *asm),
                         plain_reps, warm=1),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: flat.index_put_((dst,), vals,
                                                   accumulate=True), lib_reps),
        shape=dict(batch=batch, m=m, entries=n))


def sentinel_group(torch, kernels, gen, dtype, m=150, batch=3,
                   pool_len=6000, n_avals=400):
    """A group with every sentinel (A entries dropped by slot and target
    and reading past avals; children dropped by slot and offset, reading
    past the pool, unsorted rel with m padding, two sets sharing slots and
    positions), m not a multiple of 4 over several tiles.  Returns the
    front_assemble_ arguments."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 2)
    tgt = rng.choice(batch * m * m, size=300, replace=False)
    a_slot = np.concatenate([tgt // (m * m), [batch, 0]])
    a_flat = np.concatenate([tgt % (m * m), [0, m * m]])
    a_src = np.concatenate([rng.integers(0, n_avals + 20, 300), [0, 0]])
    children = []
    for ub, nc in ((20, 7), (7, 6)):
        off = rng.integers(0, pool_len - ub * ub, nc)
        off[0], off[1] = pool_len, pool_len - 30
        slot = rng.integers(0, batch, nc)
        slot[2] = batch
        rel = np.full((nc, ub), m, dtype=np.int64)
        for c in range(nc):
            k = rng.integers(1, ub + 1)
            rel[c, :k] = rng.choice(m, size=k, replace=False)
            rng.shuffle(rel[c])
        children.append((ub, off, slot, rel))

    def put(x):
        return torch.as_tensor(np.asarray(x, dtype=np.int64), device=dev)
    gm = kernels.GroupMaps(
        ws=put(([m // 3, 0, m - 5] * batch)[:batch]),
        off=put(np.zeros(batch)),
        a_slot=put(a_slot), a_flat=put(a_flat), a_src=put(a_src),
        children=[(ub, put(o), put(s), put(r)) for ub, o, s, r in children],
        front=kernels.build_front_maps(batch, m, pool_len,
                                       a=(a_slot, a_flat, a_src),
                                       children=children, device=dev))
    avals = torch.randn(n_avals, generator=gen, device=dev, dtype=dtype)
    pool = torch.randn(pool_len, generator=gen, device=dev, dtype=dtype)
    return avals, pool, m, m - 2, gm


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


def kernel_phase(plan, maps, torch, kernels, gen):
    """Phase 3: the kernel against its plain versions on the card.  Returns
    the records of the final JSON line (front_assemble at the group with
    the most child pairs, K1 at the largest child set, K2 at the largest
    assembly group, all float32 — the main path's dtype)."""
    dev = torch.device("cuda")

    def i64(x):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.int64),
                               device=dev)

    groups = list(zip(plan.groups, maps))
    big = max(groups, key=lambda gg: gg[1].front.pairs)
    most = max(groups, key=lambda gg: max(
        [len(c.child_off) for c in gg[0].children] + [0]))
    # --- the fused kernel in every type: sentinel case, both main-path
    # groups, and (complex) a group of full tiles -------------------------
    records = []
    for dt in (torch.float32, torch.float64, torch.complex64,
               torch.complex128):
        name = str(dt).split(".")[-1]
        data = (torch.randn(len(plan.pattern_indices), generator=gen,
                            device=dev, dtype=dt),
                torch.randn(plan.pool_size, generator=gen, device=dev,
                            dtype=dt))
        rec = time_front(*sentinel_group(torch, kernels, gen, dt), kernels,
                         reps=5)
        say("kernels_extra", case=f"front_assemble sentinel {name}", **rec)
        for which, (g, gm) in (("most_pairs", big), ("most_children", most)):
            rec = time_front(*data, g.m, g.w, gm, kernels)
            if which == "most_pairs" and dt == torch.float32:
                records.append(dict(
                    name="front_assemble", route="cuda", source=SOURCE,
                    replaces=f"{K1}, {K2}", **rec))
            else:
                say("kernels_extra", case=f"front_assemble {which} {name}",
                    **rec)
        if dt.is_complex:
            # m = 192: 3 x 3 full 64 x 64 tiles of complex128, full 64-row
            # tiles of complex64
            rec = time_front(*sentinel_group(torch, kernels, gen, dt, m=192,
                                             batch=8, pool_len=60000,
                                             n_avals=4000), kernels, reps=5)
            say("kernels_extra", case=f"front_assemble full_tile {name}",
                **rec)
        del data

    # --- the standalone wrappers at the largest child set and assembly
    # group, plus sentinels ----------------------------------------------
    if not (sentinel_extend_add(torch, kernels, gen)
            and sentinel_assemble(torch, kernels, gen)):
        raise AssertionError("extend_add/assemble kernel != plain on the "
                             "sentinel cases")
    avals = torch.randn(len(plan.pattern_indices), generator=gen, device=dev,
                        dtype=torch.float32)
    pool = torch.randn(plan.pool_size, generator=gen, device=dev,
                       dtype=torch.float32)
    sets = [(g, c) for g in plan.groups for c in g.children]
    for which, (g, cs) in (
            ("largest", max(sets, key=lambda gc: len(gc[1].child_off)
                            * gc[1].ub ** 2)),
            ("most_children", max(sets, key=lambda gc: len(gc[1].child_off)))):
        f = torch.randn((g.batch, g.m * g.m), generator=gen, device=dev,
                        dtype=torch.float32)
        rec = time_extend_add(f, pool, g.m, cs.ub, i64(cs.child_off),
                              i64(cs.child_slot), i64(cs.rel), kernels)
        if which == "largest":
            records.append(dict(name="extend_add", route="cuda", source=SOURCE,
                                replaces=K1, **rec))
        else:
            say("kernels_extra", case="extend_add most_children", **rec)
    agrp = max(plan.groups, key=lambda g: len(g.a_src))
    f = torch.randn((agrp.batch, agrp.m * agrp.m), generator=gen, device=dev,
                    dtype=torch.float32)
    rec = time_assemble(f, avals, i64(agrp.a_slot), i64(agrp.a_flat),
                        i64(agrp.a_src), kernels)
    records.append(dict(name="assemble", route="cuda", source=SOURCE,
                        replaces=K2, **rec))
    return records


def factor_sums(plan, maps, bvals, anorm, torch, factor, kernels, gen):
    """Phase 6: (a) one factorization with CUDA events around every
    front-assembly launch and no stage synchronize; (b) every group, child
    set and assembly of the plan replayed alone — the kernel in a CUDA
    graph (ms) and call by call (call_ms, the wrapper's host time
    included), the plain version and the library call with CUDA events —
    summed with the bounds (float32)."""
    dev = torch.device("cuda")
    events = []

    def timed(avals, pool, m, w, gm):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        f = kernels.front_assemble_(avals, pool, m, w, gm)
        e1.record()
        events.append((e0, e1))
        return f

    kernels.reset_launches()
    t0 = time.perf_counter()
    factor.numeric_factorize(plan, bvals, anorm, dtype=torch.float32,
                             device="cuda", scatter=timed)
    torch.cuda.synchronize()
    fact_s = time.perf_counter() - t0
    in_factor = dict(ms=sum(a.elapsed_time(b) for a, b in events),
                     launches=kernels.LAUNCHES["front_assemble"],
                     fact_s=fact_s)

    f32 = torch.float32
    avals = torch.randn(len(plan.pattern_indices), generator=gen, device=dev,
                        dtype=f32)
    pool = torch.randn(plan.pool_size, generator=gen, device=dev, dtype=f32)
    keys = ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms")
    sums = {k: dict.fromkeys(keys, 0.0) for k in
            ("front_assemble", "extend_add", "assemble")}
    counts = dict.fromkeys(sums, 0)

    def add(name, rec):
        for k in keys:
            sums[name][k] += rec[k]
        counts[name] += 1

    for g, gm in zip(plan.groups, maps):
        add("front_assemble", time_front(avals, pool, g.m, g.w, gm, kernels,
                                         reps=5, plain_reps=1, lib_reps=2))
        f = torch.randn((g.batch, g.m * g.m), generator=gen, device=dev,
                        dtype=f32)
        for ub, off, slot, rel in gm.children:
            add("extend_add", time_extend_add(f, pool, g.m, ub, off, slot,
                                              rel, kernels, reps=5,
                                              plain_reps=1, lib_reps=2,
                                              wrapper=False))
        if gm.a_src.numel():
            add("assemble", time_assemble(f, avals, gm.a_slot, gm.a_flat,
                                          gm.a_src, kernels, reps=5,
                                          plain_reps=1, lib_reps=2,
                                          wrapper=False))
        del f
    in_factor["bound_ms"] = sums["front_assemble"]["bound_ms"]
    # the complex path runs the same plan: the front assembly of every
    # group replayed alone in complex64 and complex128
    for dt in (torch.complex64, torch.complex128):
        name = f"front_assemble {str(dt).split('.')[-1]}"
        sums[name] = dict.fromkeys(keys, 0.0)
        counts[name] = 0
        avals = torch.randn(len(plan.pattern_indices), generator=gen,
                            device=dev, dtype=dt)
        pool = torch.randn(plan.pool_size, generator=gen, device=dev,
                           dtype=dt)
        for g, gm in zip(plan.groups, maps):
            add(name, time_front(avals, pool, g.m, g.w, gm, kernels, reps=3,
                                 plain_reps=1, lib_reps=1))
        del avals, pool
    return in_factor, {k: dict(units=counts[k], **v) for k, v in sums.items()}


def expect_native(phase, native, *names):
    """The native calls of the analysis just driven (counts reset just
    before it): the matching, etree, postorder, symbolic and front
    positions (the amalgamation runs only on more than one supernode), and
    ``names``, each at least once, or raise."""
    got = dict(native.CALLS)
    need = ("etree", "postorder", "symbolic", "positions", *names)
    missing = [k for k in need if not got[k]]
    if missing or not (got["mc64"] or got["awpm"]):
        raise AssertionError(f"{phase}: no native call of "
                             f"{missing or 'a matching'}: {got}")
    return {k: v for k, v in got.items() if v}


def diag_log_product(a, row_order):
    """Σ_j log|a[row_order[j], j]|: the objective of the maximum-product
    matching."""
    csc = a.tocsc()
    cols = np.repeat(np.arange(a.n_cols), np.diff(csc.indptr))
    hit = csc.indices == np.asarray(row_order)[cols]
    if hit.sum() != a.n_cols:
        raise AssertionError("the matching is not a perfect matching of A")
    return float(np.log(np.abs(csc.data[hit])).sum())


def native_phase():
    """Phase 2b: the native host library on the card's host — its build
    from the checkout's source (timed; a failure raises with the
    compiler's output), then each function against its Python twin on
    poisson3d(16) and random_sparse(2000): etree, postorder, the symbolic
    structure (with amalgamation), mmd, colamd and the AᵀA pattern equal,
    and the MC64 matching's log product equal to 1e-12 of Σ|log|a||."""
    from superlu_dist_tpu_torch import native
    from superlu_dist_tpu_torch.models.gallery import (poisson3d,
                                                       random_sparse)
    from superlu_dist_tpu_torch.ordering import colamd, etree
    from superlu_dist_tpu_torch.ordering.minimum_degree import minimum_degree
    from superlu_dist_tpu_torch.rowperm.matching import (
        maximum_product_matching)
    from superlu_dist_tpu_torch.sparse.formats import symmetrize_pattern
    from superlu_dist_tpu_torch.symbolic.symbfact import symbolic_factorize
    t0 = time.perf_counter()
    lib = native.build()
    native.load()
    build_s = time.perf_counter() - t0

    def sf_arrays(sf):
        return [sf.sn_start, sf.sn_parent, sf.sn_level, sf.perm,
                np.int64([sf.nnz_L]), *sf.sn_rows]

    cases = {}
    for name, a in (("poisson3d_16", poisson3d(16)),
                    ("random_2000", random_sparse(2000, density=0.003,
                                                  seed=SEED))):
        sym = symmetrize_pattern(a)
        n = sym.n_rows
        ip, ix = sym.indptr, sym.indices
        dense = colamd.dense_row_threshold(n)
        out = {}

        def pair(label, fn, same=None):
            t0 = time.perf_counter()
            got = fn(True)
            t1 = time.perf_counter()
            want = fn(False)
            t2 = time.perf_counter()
            if same is None:
                ok = len(got) == len(want) and all(
                    np.array_equal(g, w) for g, w in zip(got, want))
            else:
                ok = same(got, want)
            out[label] = dict(native_s=t1 - t0, python_s=t2 - t1)
            if not ok:
                raise AssertionError(f"native: {label} != its Python twin "
                                     f"on {name}")

        parent = etree.etree_symmetric(n, ip, ix)
        pair("etree", lambda nat: [(native.etree if nat else
                                    etree.etree_symmetric)(n, ip, ix)])
        pair("postorder", lambda nat: [(native.postorder if nat else
                                        etree.postorder)(parent)])
        pair("symbolic", lambda nat: sf_arrays(symbolic_factorize(
            sym, np.arange(n), native=nat)))
        pair("mmd", lambda nat: [minimum_degree(n, ip, ix, native=nat)])
        pair("colamd", lambda nat: [colamd.colamd_order(
            n, n, a.indptr, a.indices, native=nat)])
        pair("ata_pattern", lambda nat: list(colamd.ata_adjacency(
            n, n, a.indptr, a.indices, dense_row=dense, native=nat)))
        scale = float(np.abs(np.log(np.abs(a.data))).sum())
        pair("mc64_product", lambda nat: diag_log_product(
            a, maximum_product_matching(a, want_scalings=False,
                                        native=nat)[0]),
             same=lambda g, w: abs(g - w) <= 1e-12 * scale)
        cases[name] = dict(n=n, nnz=a.nnz, **out)
    say("native", library=str(lib), build_s=build_s, cases=cases)


def factorizations(report) -> int:
    """The factorizations a gssvx call ran on its plan: one, plus one per
    ladder rung that refactored the same skeleton (gemm-precision,
    hiprec-factors).  A refactor-rescale rung re-analyses: raise."""
    if any(r.name == "refactor-rescale" for r in report.rungs):
        raise AssertionError(f"the ladder re-analysed: {report.summary()}")
    return 1 + sum(r.name in ("gemm-precision", "hiprec-factors")
                   and "info=" not in r.detail for r in report.rungs)


def expect_launches(phase, kernels, front_assemble, spmv):
    """The launch counts of the phase just driven (reset just before it):
    ``front_assemble`` launches of the fused kernel, none of the standalone
    wrappers, and residual SpMV launches when ``spmv`` (refinement on the
    card: nnz >= 100,000), none otherwise; or raise."""
    got = dict(kernels.LAUNCHES)
    want = {"front_assemble": front_assemble, "extend_add": 0, "assemble": 0}
    if ({k: got[k] for k in want} != want
            or bool(got["csr_spmv"]) != bool(spmv)):
        raise AssertionError(f"launches in {phase}: {got}, expected {want} "
                             f"and {'some' if spmv else 'no'} csr_spmv")
    return got


def check_berr(phase, berr, target=None):
    """Raise when a delivered BERR is above its target (default
    berr_target(float64))."""
    from superlu_dist_tpu_torch.utils import tols
    target = float(tols.berr_target(np.float64)) if target is None else target
    if not berr <= target:
        raise AssertionError(f"{phase}: BERR {berr} above {target}")


def timed_gssvx(slt, kernels, options, a, b, **kw):
    """gssvx with the launch and native-call counts reset just before it:
    (x, lu, stats, seconds)."""
    import torch
    from superlu_dist_tpu_torch import native
    kernels.reset_launches()
    native.reset_calls()
    t0 = time.perf_counter()
    x, lu, stats, info = slt.gssvx(options, a, b, **kw)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    if info != 0 or x is None or not np.all(np.isfinite(x)):
        raise AssertionError(f"gssvx {options.fact.name} "
                             f"{options.trans.name} failed: info={info}")
    return x, lu, stats, sec


def reuse_phase(slt, a, lu, dofact_s, dofact_fact_s, kernels, tols, torch,
                factor):
    """Phase 4b, at full width on the main path's handle: a FACTORED solve,
    a TRANS solve, refactor (equal to a fresh factorization of the same
    values on the same plan, no SYMBFACT/COLPERM), SamePattern_SameRowPerm
    on the changed matrix, condest on the card, and the residual-precision
    rung of the ladder.  One line; every BERR at its target."""
    groups = len(lu.plan.groups)
    rng = np.random.default_rng(SEED + 10)
    out = {"dofact": dict(wall_s=dofact_s, fact_s=dofact_fact_s)}
    b2 = a.matvec(rng.standard_normal(a.n_rows))

    # 1. FACTORED: solve + refine only
    x, _, st, sec = timed_gssvx(slt, kernels,
                                slt.Options(fact=slt.Fact.FACTORED), a, b2,
                                lu=lu)
    if st.utime["FACT"] != 0:
        raise AssertionError("FACTORED ran a factorization")
    out["factored"] = dict(s=sec, berr=st.solve_report.berr,
                           refine_steps=st.refine_steps,
                           launches=expect_launches("factored", kernels, 0,
                                                    True))
    check_berr("reuse factored", st.solve_report.berr)

    # 2. TRANS through the same factors: the residual is taken against Aᵀ
    x, _, st, sec = timed_gssvx(
        slt, kernels, slt.Options(fact=slt.Fact.FACTORED,
                                  trans=slt.Trans.TRANS), a, b2, lu=lu)
    at = a.transpose()
    out["trans"] = dict(
        s=sec, berr=st.solve_report.berr, refine_steps=st.refine_steps,
        rel_residual_vs_At=float(np.linalg.norm(b2 - at.matvec(x))
                                 / np.linalg.norm(b2)),
        launches=expect_launches("trans", kernels, 0, True))
    check_berr("reuse trans", st.solve_report.berr)

    # 3. refactor on new values (a.data · (1 + 0.05·u), u ~ U[-1, 1], seed 0)
    u = np.random.default_rng(SEED).uniform(-1.0, 1.0, a.nnz)
    a_new = type(a)(a.n_rows, a.n_cols, a.indptr, a.indices,
                    a.data * (1.0 + 0.05 * u))
    kernels.reset_launches()
    t0 = time.perf_counter()
    st = slt.refactor(lu, a_new.data)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = expect_launches("refactor", kernels, groups, False)
    skipped = {p: st.utime[p] for p in ("ROWPERM", "COLPERM", "SYMBFACT")}
    if any(skipped.values()):
        raise AssertionError(f"refactor ran analysis phases: {skipped}")
    _, bvals, _ = slt.analyze(slt.Options(
        fact=slt.Fact.SamePattern_SameRowPerm), a_new, device="cuda", lu=lu)
    fresh = factor.numeric_factorize(lu.plan, bvals, lu.anorm,
                                     dtype=lu.numeric.dtype, device="cuda",
                                     gemm_prec=lu.numeric.gemm_prec)
    equal = all(torch.equal(l1, l2) and torch.equal(u1, u2)
                for (l1, u1), (l2, u2) in zip(lu.numeric.fronts,
                                              fresh.fronts))
    del fresh
    if not equal:
        raise AssertionError("refactor's factors != a fresh factorization")
    b3 = a_new.matvec(rng.standard_normal(a.n_rows))
    # the refactored handle's BERR: a FACTORED solve through its factors
    x, _, st2, sec2 = timed_gssvx(slt, kernels,
                                  slt.Options(fact=slt.Fact.FACTORED), a_new,
                                  b3, lu=lu)
    out["refactor"] = dict(s=sec, fact_s=st.utime["FACT"],
                           analysis_phases_s=skipped,
                           equals_fresh_factorization=equal,
                           launches=launches, solve_s=sec2,
                           berr=st2.solve_report.berr,
                           refine_steps=st2.refine_steps)
    check_berr("reuse refactor", st2.solve_report.berr)

    # 4. SamePattern_SameRowPerm on the changed matrix
    x, lu4, st, sec = timed_gssvx(
        slt, kernels, slt.Options(fact=slt.Fact.SamePattern_SameRowPerm,
                                  factor_dtype="float32"), a_new, b3, lu=lu)
    if lu4.plan is not lu.plan:
        raise AssertionError("SamePattern_SameRowPerm rebuilt the plan")
    out["same_row_perm"] = dict(
        s=sec, phase_s=st.utime, berr=st.solve_report.berr,
        refine_steps=st.refine_steps,
        launches=expect_launches("same_row_perm", kernels,
                                 groups * factorizations(st.solve_report),
                                 True))
    check_berr("reuse same_row_perm", st.solve_report.berr)
    del lu4

    # 5. rcond and ferr through the device solves
    x, _, st, sec = timed_gssvx(
        slt, kernels, slt.Options(fact=slt.Fact.FACTORED,
                                  recovery=slt.RecoveryPolicy(
                                      condest="always")), a_new, b3, lu=lu)
    rep = st.solve_report
    if not (rep.rcond and rep.rcond > 0 and rep.ferr):
        raise AssertionError(f"condest gave {rep.summary()}")
    out["condest"] = dict(s=sec, rcond=rep.rcond, ferr=rep.ferr,
                          berr=rep.berr,
                          launches=expect_launches("condest", kernels, 0,
                                                   True))
    check_berr("reuse condest", rep.berr)

    # 6. SLU_SINGLE against a float64-class target: the residual-precision
    # rung at full width
    x, _, st, sec = timed_gssvx(
        slt, kernels, slt.Options(fact=slt.Fact.FACTORED,
                                  iter_refine=slt.IterRefine.SLU_SINGLE,
                                  recovery=slt.RecoveryPolicy(
                                      berr_target=1e-14)), a_new, b3, lu=lu)
    rep = st.solve_report
    names = [r.name for r in rep.rungs]
    if "residual-precision" not in names:
        raise AssertionError(f"no residual-precision rung: {rep.summary()}")
    out["residual_precision"] = dict(
        s=sec, berr=rep.berr, rungs=names, berr_history=rep.berr_history,
        launches=expect_launches("residual_precision", kernels, 0, True))
    check_berr("reuse residual_precision", rep.berr, 1e-14)
    say("reuse", n=a.n_rows, groups=groups,
        berr_target=float(tols.berr_target(np.float64)), **out)


def helmholtz_3d(slt, a, k=5.0):
    """The complex Helmholtz-type operator on a 3-D Poisson pattern:
    helmholtz_2d's shift rule, diagonal −(k² − 0.5ik)h² with h = 1/(nx+1)."""
    nx = a.grid_shape[0]
    vals = a.data.astype(np.complex128)
    diag = a.indices == np.repeat(np.arange(a.n_rows), np.diff(a.indptr))
    vals[diag] -= (k * k - 0.5j * k) / (nx + 1) ** 2
    return slt.SparseCSR(a.n_rows, a.n_cols, a.indptr, a.indices, vals)


def complex_phase(slt, a, lu, kernels, tols, torch):
    """Phase 4c, at full width: the complex Helmholtz-type operator on the
    main path's pattern, factored in complex64 on the real handle's plan
    (SamePattern_SameRowPerm, no re-analysis), then a CONJ solve through
    the same factors."""
    groups = len(lu.plan.groups)
    ac = helmholtz_3d(slt, a)
    rng = np.random.default_rng(SEED + 20)
    bc = ac.matvec(rng.standard_normal(a.n_rows)
                   + 1j * rng.standard_normal(a.n_rows))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    x, luc, st, sec = timed_gssvx(
        slt, kernels, slt.Options(fact=slt.Fact.SamePattern_SameRowPerm,
                                  factor_dtype="float32"), ac, bc, lu=lu)
    peak = torch.cuda.max_memory_allocated()
    launches = expect_launches("complex", kernels,
                               groups * factorizations(st.solve_report), True)
    if luc.numeric.dtype != torch.complex64 or luc.plan is not lu.plan:
        raise AssertionError("the complex path did not factor complex64 on "
                             "the real handle's plan")
    fact_s = st.utime["FACT"]
    flops = 4.0 * luc.plan.flops
    first = dict(s=sec, phase_s=st.utime, berr=st.solve_report.berr,
                 refine_steps=st.refine_steps,
                 rel_residual=float(np.linalg.norm(bc - ac.matvec(x))
                                    / np.linalg.norm(bc)))
    check_berr("complex", st.solve_report.berr)
    b2 = rng.standard_normal(a.n_rows) + 1j * rng.standard_normal(a.n_rows)
    x, _, st, sec = timed_gssvx(
        slt, kernels, slt.Options(fact=slt.Fact.FACTORED,
                                  trans=slt.Trans.CONJ), ac, b2, lu=luc)
    conj = dict(s=sec, berr=st.solve_report.berr,
                refine_steps=st.refine_steps,
                launches=expect_launches("complex conj", kernels, 0, True))
    check_berr("complex conj", st.solve_report.berr)
    say("complex", n=a.n_rows, dtype="complex64", fact_s=fact_s,
        complex_flops=flops, factor_gflops=flops / fact_s / 1e9,
        max_memory_allocated=peak, launches=launches,
        berr_target=float(tols.berr_target(np.float64)), factor=first,
        conj=conj)


def complex_dofact_phase(slt, kernels, tols, torch):
    """Phase 7: gssvx from scratch on helmholtz_2d(333) (n = 110,889): the
    complex analysis, MC64 on complex values included, complex64 factors."""
    from superlu_dist_tpu_torch import native
    from superlu_dist_tpu_torch.models.gallery import helmholtz_2d
    a = helmholtz_2d(333)
    rng = np.random.default_rng(SEED + 30)
    b = a.matvec(rng.standard_normal(a.n_rows)
                 + 1j * rng.standard_normal(a.n_rows))
    x, lu, st, sec = timed_gssvx(slt, kernels, slt.Options(), a, b,
                                 device="cuda")
    launches = expect_launches(
        "complex_dofact", kernels,
        len(lu.plan.groups) * factorizations(st.solve_report), True)
    calls = expect_native("complex_dofact", native, "mlnd")
    if lu.numeric.dtype != torch.complex64:
        raise AssertionError(f"complex_dofact factored {lu.numeric.dtype}")
    say("complex_dofact", n=a.n_rows, nnz=a.nnz, wall_s=sec,
        phase_s=st.utime, native_calls=calls, groups=len(lu.plan.groups),
        rungs=[(r.name, r.detail) for r in st.solve_report.rungs],
        answer_tier=st.solve_report.gemm_precision,
        structural_flops=lu.plan.flops, berr=st.solve_report.berr,
        refine_steps=st.refine_steps, launches=launches,
        berr_target=float(tols.berr_target(np.float64)))
    check_berr("complex_dofact", st.solve_report.berr)


def ladder_phase(slt, kernels, tols, torch):
    """Phase 8: the escalation ladder on the card — float32 factors of the
    near-singular arrowhead must climb the GEMM tier (default → f32, the
    live gemm-precision rung) and then to float64 factors on the card and
    deliver BERR ≤ 10·eps64; float32 factors of hilbert(8) must take the
    gemm-precision rung and converge."""
    from superlu_dist_tpu_torch import native
    from superlu_dist_tpu_torch.models.gallery import (
        hilbert, rank_deficient_arrowhead)
    out = {}
    a = rank_deficient_arrowhead(60, delta=1e-6)
    b = a.matvec(np.random.default_rng(SEED + 40).standard_normal(a.n_rows))
    x, lu, st, sec = timed_gssvx(slt, kernels,
                                 slt.Options(factor_dtype="float32"), a, b,
                                 device="cuda")
    rep = st.solve_report
    names = [r.name for r in rep.rungs]
    if not {"hiprec-factors", "refactor-rescale"} & set(names) \
            or "gemm-precision" not in names \
            or lu.numeric.dtype != torch.float64 \
            or lu.numeric.device.type != "cuda":
        raise AssertionError(f"arrowhead ladder: {rep.summary()}, "
                             f"{lu.numeric.dtype} on {lu.numeric.device}")
    out["arrowhead"] = dict(s=sec, rungs=names, berr=rep.berr,
                            rcond=rep.rcond, summary=rep.summary(),
                            native_calls=expect_native("ladder arrowhead",
                                                       native))
    check_berr("ladder arrowhead", rep.berr,
               10 * float(np.finfo(np.float64).eps))
    a = hilbert(8)
    x, lu, st, sec = timed_gssvx(slt, kernels,
                                 slt.Options(factor_dtype="float32"), a,
                                 a.matvec(np.ones(8)), device="cuda")
    rep = st.solve_report
    if not rep.converged or "gemm-precision" not in [r.name
                                                     for r in rep.rungs]:
        raise AssertionError(f"hilbert(8): {rep.summary()}")
    out["hilbert8"] = dict(s=sec, rungs=[r.name for r in rep.rungs],
                           berr=rep.berr, target=rep.target,
                           summary=rep.summary(),
                           native_calls=expect_native("ladder hilbert8",
                                                      native))
    say("ladder", **out)


def orderings_phase(slt, kernels, tols):
    """Phase 8b: DOFACT gssvx on random_sparse(2000) on the card with the
    native orderings and matching the default path does not take —
    ColPerm COLAMD, ColPerm MMD_ATA, RowPerm LargeDiag_AWPM — each to
    BERR ≤ berr_target(float64)."""
    from superlu_dist_tpu_torch import native
    from superlu_dist_tpu_torch.models.gallery import random_sparse
    a = random_sparse(2000, density=0.003, seed=SEED)
    b = a.matvec(np.random.default_rng(SEED + 50).standard_normal(a.n_rows))
    out = {}
    for case, kw, fn in (
            ("COLAMD", dict(col_perm=slt.ColPerm.COLAMD), "colamd"),
            ("MMD_ATA", dict(col_perm=slt.ColPerm.MMD_ATA), "ata_pattern"),
            ("LargeDiag_AWPM", dict(row_perm=slt.RowPerm.LargeDiag_AWPM),
             "awpm")):
        x, lu, st, sec = timed_gssvx(slt, kernels, slt.Options(
            factor_dtype="float32", **kw), a, b, device="cuda")
        out[case] = dict(
            s=sec, phase_s={p: st.utime[p] for p in ANALYSIS + ("FACT",)},
            groups=len(lu.plan.groups), berr=st.solve_report.berr,
            rungs=[r.name for r in st.solve_report.rungs],
            native_calls=expect_native(f"orderings {case}", native, fn),
            launches=expect_launches(
                f"orderings {case}", kernels,
                len(lu.plan.groups) * factorizations(st.solve_report),
                False))
        check_berr(f"orderings {case}", st.solve_report.berr)
    say("orderings", n=a.n_rows, nnz=a.nnz,
        berr_target=float(tols.berr_target(np.float64)), **out)


def scipy_check(slt, a, trans, cplx, rng, tols):
    """A small solve of op(A)·x = b on the card (float32 factors, float64
    refinement) against scipy's sparse direct solver of op(A)."""
    import scipy.sparse
    import scipy.sparse.linalg
    from superlu_dist_tpu_torch import native
    b = rng.standard_normal(a.n_rows)
    if cplx:
        b = b + 1j * rng.standard_normal(a.n_rows)
    native.reset_calls()
    x, _, _, info = slt.gssvx(slt.Options(factor_dtype="float32",
                                          trans=getattr(slt.Trans, trans)),
                              a, b, device="cuda")
    calls = expect_native(f"check {trans}", native)
    sp = scipy.sparse.csr_matrix((a.data, a.indices, a.indptr), shape=a.shape)
    op = {"NOTRANS": sp, "TRANS": sp.T, "CONJ": sp.conj().T}[trans]
    x_ref = scipy.sparse.linalg.spsolve(op.tocsc(), b)
    return dict(info=info, agrees=bool(info == 0 and np.allclose(
        x, x_ref, rtol=tols.DEVICE_VS_HOST_RTOL,
        atol=tols.DEVICE_VS_HOST_ATOL)),
        max_abs_diff=float(np.abs(x - x_ref).max()), native_calls=calls)


SPMV_SOURCE = "superlu_dist_tpu_torch/csrc/csr_spmv.cu"
SPMV_REPLACES = ("superlu_dist_tpu/parallel/dist.py:181 (XLA scatter-add; "
                 "no Pallas kernel)")
#: the JAX package's solve plans of its default plan of poisson3d(48) (its
#: solve/plan.py build_solve_plan on the CPU): sweep batches per schedule
JAX_SOLVE_BATCHES = {"dataflow": 90, "level": 106, "factor": 134}
#: columns of the 1,500-column solve that the solve phase refines: 8 of
#: each of its two chunks (1,024 + 476)
SAMPLE_COLS = np.r_[0:8, 1492:1500]


def spmv_phase(a, torch, kernels, dist, gen):
    """The residual SpMV kernel against its plain twin on the card, at the
    main path's operator (poisson3d(48), nnz 760,320) in float64 — the
    refinement's type — and, on the complex Helmholtz-type values of the
    same pattern, float32, complex64 and complex128, and on a small matrix
    with empty rows and a row of length 1: torch.equal everywhere.  Returns
    the float64 record of the final JSON line (the yardstick library call
    is torch.sparse.mm on the same CSR tensor)."""
    dev = torch.device("cuda")
    ip = torch.as_tensor(a.indptr.astype(np.int64), device=dev)
    ix = torch.as_tensor(a.indices.astype(np.int64), device=dev)
    max_row = int(np.diff(a.indptr).max())
    rng = np.random.default_rng(SEED + 70)
    cvals = rng.standard_normal(a.nnz) + 1j * rng.standard_normal(a.nnz)
    record = None
    for dt in (torch.float64, torch.float32, torch.complex64,
               torch.complex128):
        v = torch.as_tensor(cvals if dt.is_complex else a.data,
                            device=dev).to(dt)
        for k in (1, 16):
            x = torch.randn((a.n_cols, k), generator=gen, device=dev,
                            dtype=dt)
            y = dist.csr_spmv(ip, ix, v, x)
            yp = dist.csr_spmv_plain(ip, ix, v, x, max_row)
            torch.cuda.synchronize()
            err = float((y - yp).abs().max())
            if not torch.equal(y, yp):
                raise AssertionError(f"csr_spmv {dt} k={k} != plain twin "
                                     f"(max |d| {err})")
            if dt != torch.float64 or k != 1:
                say("kernels_extra", case=f"csr_spmv {str(dt)[6:]} k={k}",
                    max_abs_err=err)
                continue
            isz = v.element_size()
            nbytes = ((a.n_rows + 1) * 8 + a.nnz * 8 + a.nnz * isz
                      + a.n_cols * k * isz + a.n_rows * k * isz)
            b_ms, b_by = bound(nbytes, 2 * a.nnz * k, dt)
            csr = torch.sparse_csr_tensor(ip, ix, v, size=(a.n_rows, a.n_cols))
            lib = torch.sparse.mm(csr, x)
            record = dict(
                name="csr_spmv", route="cuda", source=SPMV_SOURCE,
                replaces=SPMV_REPLACES, max_abs_err=err,
                ms=graph_ms(lambda: dist.csr_spmv(ip, ix, v, x), n=20),
                call_ms=cuda_ms(lambda: dist.csr_spmv(ip, ix, v, x), 20),
                plain_ms=cuda_ms(lambda: dist.csr_spmv_plain(ip, ix, v, x,
                                                             max_row), 5),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=cuda_ms(lambda: torch.sparse.mm(csr, x), 20),
                library_max_abs_diff=float((lib - y).abs().max()),
                shape=dict(n=a.n_rows, nnz=a.nnz, k=k, bytes=nbytes))
    # a small matrix: an empty first and last row, a row of length 1
    small_ip = torch.tensor([0, 0, 1, 5, 9, 9], device=dev)
    small_ix = torch.tensor([2, 0, 1, 2, 4, 4, 3, 2, 1], device=dev)
    for dt in (torch.float32, torch.float64, torch.complex64,
               torch.complex128):
        v = torch.randn(9, generator=gen, device=dev, dtype=dt)
        x = torch.randn((5, 3), generator=gen, device=dev, dtype=dt)
        y = dist.csr_spmv(small_ip, small_ix, v, x)
        if not (torch.equal(y, dist.csr_spmv_plain(small_ip, small_ix, v, x))
                and not y[0].any() and not y[4].any()):
            raise AssertionError(f"csr_spmv {dt} on the small matrix")
    say("kernels", **record)
    return record


def solve_phase(lu, torch):
    """The device solve on the main path's handle (refactored by the reuse
    phase: its factors are those of ``lu.a``): the three schedules' plans
    (the JAX package's batch counts), then nrhs 1, 16 and 1,500 (the last
    chunked past the 1,024 cap) through fused (CUDA graph) and eager
    sweeps, with and without DiagInv — SOLVE seconds (first call, with the
    graph captures, and the next), last_solve_stats, the solver's memory,
    the agreement with the main configuration (fused, no DiagInv), and the
    BERR after refinement through the device residual: of every column of
    the 1- and 16-column solves; of the 1,500-column solve, every column's
    BERR before refinement and the refinement of columns 0-7 and
    1,492-1,499 (8 of each chunk; all 1,500 columns take about 17 s a
    refinement step on the card's host, 1.3 GB host copies).  The refinement
    runs on the factored matrix M = P_σ·diag(R)·A·diag(C)·P_πᵀ itself,
    whose componentwise BERR is A's (it is invariant under the scalings and
    permutations), so the 1,500-column solves skip the host transforms."""
    from superlu_dist_tpu_torch.parallel.dist import DeviceSpMV
    from superlu_dist_tpu_torch.refine.ir import (componentwise_berr,
                                                  iterative_refinement)
    from superlu_dist_tpu_torch.solve.device import DeviceSolver
    from superlu_dist_tpu_torch.solve.plan import build_solve_plan
    plans = {s: build_solve_plan(lu.plan, schedule=s).schedule_stats(1)
             for s in JAX_SOLVE_BATCHES}
    say("solve_plans", **plans)
    got = {s: st["n_groups"] for s, st in plans.items()}
    if got != JAX_SOLVE_BATCHES:
        raise AssertionError(f"solve batches {got}, the JAX package's "
                             f"{JAX_SOLVE_BATCHES}")
    main = lu.dev_solver
    if (main.splan.schedule, len(main.splan.groups), main.fused) != (
            "dataflow", JAX_SOLVE_BATCHES["dataflow"], True):
        raise AssertionError("the main path's solver is not the fused "
                             "dataflow schedule")
    m_op = lu.a.row_scale(lu.R).col_scale(lu.C).permute(perm_r=lu.sigma,
                                                        perm_c=lu.sf.perm)
    spmv = DeviceSpMV(m_op, device="cuda")
    rng = np.random.default_rng(SEED + 60)
    n = m_op.n_rows
    rhs = {k: spmv.matvec(rng.standard_normal((n, k))) for k in (1, 16, 1500)}
    ref = {}
    out = {}
    for fused in (True, False):
        for diag in (False, True):
            name = ("fused" if fused else "eager") + ("+diaginv" if diag
                                                       else "")
            torch.cuda.synchronize()
            mem0 = torch.cuda.memory_allocated()
            solver = DeviceSolver(lu.numeric, diag_inv=diag, fused=fused,
                                  gemm_prec=lu.numeric.gemm_prec)
            cases = {}
            for k, d in rhs.items():
                t0 = time.perf_counter()
                solver.solve(d)
                first = time.perf_counter() - t0
                t0 = time.perf_counter()
                z = solver.solve(d)
                steady = time.perf_counter() - t0
                st = dict(solver.last_solve_stats)
                if not st["finite"]:
                    raise AssertionError(f"solve {name} k={k}: non-finite "
                                         f"columns {st['nonfinite_cols']}")
                case = dict(first_s=first, s=steady,
                            stats={key: st[key] for key in (
                                "nrhs", "padded_nrhs", "chunks",
                                "padding_factor", "fused",
                                "nonfinite_cols")})
                if name == "fused":
                    ref[k] = z
                else:
                    case["max_rel_diff_vs_fused"] = float(
                        np.abs(z - ref[k]).max() / np.abs(ref[k]).max())
                t0 = time.perf_counter()
                if k == 1500:
                    # every column's BERR before refinement, then the
                    # refinement of 8 columns of each chunk
                    r = d - spmv.matvec(z)
                    den = spmv.abs_matvec(np.abs(z)) + np.abs(d)
                    case["unrefined_berr_max"] = float(componentwise_berr(
                        r, den, spmv.nnz).max())
                    d, z = d[:, SAMPLE_COLS], z[:, SAMPLE_COLS]
                _, berrs = iterative_refinement(spmv, d, z, solver.solve)
                case.update(berr=berrs[-1], refine_steps=len(berrs),
                            refine_s=time.perf_counter() - t0)
                check_berr(f"solve {name} k={k}", berrs[-1])
                cases[k] = case
            torch.cuda.synchronize()
            out[name] = dict(cases=cases, memory=solver.memory_stats(),
                             allocated_bytes=torch.cuda.memory_allocated()
                             - mem0)
            del solver
    say("solve", n=n, schedule="dataflow", batches=len(main.splan.groups),
        gemm_prec=main.gemm_prec, main_solver_memory=main.memory_stats(),
        **out)


def gemm_tiers_phase(slt, a, lu, kernels, tols, default_run):
    """gssvx on poisson3d(48) at the bf16 and f32 GEMM tiers on the main
    path's analysis (SamePattern_SameRowPerm: same plan), beside the main
    path's own run at the default tier (TF32): FACT seconds, refine steps,
    rungs, the tier the answer rests on, BERR."""
    rng = np.random.default_rng(SEED + 80)
    b = a.matvec(rng.standard_normal(a.n_rows))
    out = {"default": default_run}
    for tier in ("bf16", "f32"):
        x, lut, st, sec = timed_gssvx(
            slt, kernels, slt.Options(fact=slt.Fact.SamePattern_SameRowPerm,
                                      gemm_prec=tier), a, b, lu=lu)
        rep = st.solve_report
        if lut.plan is not lu.plan:
            raise AssertionError("SamePattern_SameRowPerm rebuilt the plan")
        out[tier] = dict(s=sec, fact_s=st.utime["FACT"],
                         refine_s=st.utime["REFINE"],
                         refine_steps=st.refine_steps,
                         rungs=[(r.name, r.detail) for r in rep.rungs],
                         answer_tier=rep.gemm_precision, berr=rep.berr,
                         berr_history=rep.berr_history)
        check_berr(f"gemm_tiers {tier}", rep.berr)
        del lut
    from superlu_dist_tpu_torch.ops import dense
    say("gemm_tiers", n=a.n_rows, bf16_route=dense.BF16_ROUTE,
        berr_target=float(tols.berr_target(np.float64)), **out)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import superlu_dist_tpu_torch as slt
    from superlu_dist_tpu_torch import native
    from superlu_dist_tpu_torch.models.gallery import (convection_diffusion_2d,
                                                       poisson3d,
                                                       random_sparse)
    from superlu_dist_tpu_torch.numeric import factor, kernels
    from superlu_dist_tpu_torch.parallel import dist
    from superlu_dist_tpu_torch.utils import tols

    # 1. card
    card = card_line()
    say("card", nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda)

    # 2. build
    t0 = time.perf_counter()
    lib = kernels.build()
    kernels.library()
    say("build", seconds=time.perf_counter() - t0, library=str(lib))
    native_phase()

    # 3. kernels, at the shapes of the main path's plan
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    a = poisson3d(NX)
    native.reset_calls()
    t0 = time.perf_counter()
    lu0, bvals0, st0 = slt.analyze(slt.Options(), a, device="cuda")
    analysis_s = time.perf_counter() - t0
    plan = lu0.plan
    got = {"supernodes": plan.sf.n_supernodes, "groups": len(plan.groups),
           "flops": plan.flops}
    say("plan", n=plan.n, backend="native" if lu0.options.native
        else "python", phase_s={p: st0.utime[p] for p in ANALYSIS},
        analysis_s=analysis_s, native_calls=expect_native("plan", native,
                                                          "amalgamate",
                                                          "mlnd"),
        pool=plan.pool_size, jax_default_plan=JAX_PLAN, **got)
    if got != JAX_PLAN:
        raise AssertionError(f"the default plan {got} is not the JAX "
                             f"package's {JAX_PLAN}")
    # the plan's index maps, the kernel's included: host work once per
    # plan, inside FACT on the main path
    t0 = time.perf_counter()
    maps = factor.upload_maps(plan, torch.device("cuda"))
    torch.cuda.synchronize()
    maps_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for g in plan.groups:        # the kernel's part of that, host only
        kernels.front_map_arrays(
            g.batch, g.m, plan.pool_size, a=(g.a_slot, g.a_flat, g.a_src),
            children=[(c.ub, c.child_off, c.child_slot, c.rel)
                      for c in g.children])
    say("maps", seconds=maps_s, kernel_maps_host_s=time.perf_counter() - t0,
        kernel_map_bytes=sum(gm.front.nbytes for gm in maps),
        pairs=sum(gm.front.pairs for gm in maps),
        front_elements=sum(g.batch * g.m * g.m for g in plan.groups))
    records = kernel_phase(plan, maps, torch, kernels, gen)
    for rec in records:
        say("kernels", **rec)
    records.append(spmv_phase(a, torch, kernels, dist, gen))

    # 4. the main path: gssvx on poisson3d(48), f32 factors, f64 refine
    rng = np.random.default_rng(SEED)
    x_true = rng.standard_normal(a.n_rows)
    b = a.matvec(x_true)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    native.reset_calls()
    t0 = time.perf_counter()
    x, lu, stats, info = slt.gssvx(slt.Options(), a, b, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    groups = len(lu.plan.groups)
    # the main path runs the fused kernel once per group (and once more per
    # group for each gemm-precision refactor of the ladder), neither
    # standalone wrapper, and the residual kernel in every refinement
    # step; its analysis runs in the native library
    rep = stats.solve_report
    rungs = rep.rungs
    launches = expect_launches("gssvx", kernels, groups * factorizations(rep),
                               True)
    calls = expect_native("gssvx", native, "amalgamate", "mlnd")
    peak = torch.cuda.max_memory_allocated()
    if info != 0 or x is None or x.shape != b.shape:
        raise AssertionError(f"gssvx failed: info={info}")
    if not np.all(np.isfinite(x)):
        raise AssertionError("gssvx returned non-finite values")
    berr = rep.berr
    relres = float(np.linalg.norm(b - a.matvec(x)) / np.linalg.norm(b))
    analysis = sum(stats.utime[p] for p in ANALYSIS)
    say("gssvx", n=a.n_rows, nnz=a.nnz, info=info, wall_s=wall,
        analysis_backend="native" if lu.options.native else "python",
        analysis_s=analysis, phase_s=stats.utime, native_calls=calls,
        supernodes=lu.sf.n_supernodes,
        factor_gflops=lu.plan.flops / stats.utime["FACT"] / 1e9,
        structural_flops=lu.plan.flops, groups=groups,
        tiny_pivots=stats.tiny_pivots, refine_steps=stats.refine_steps,
        berr=berr, berr_history=rep.berr_history,
        berr_target=float(tols.berr_target(np.float64)), rel_residual=relres,
        rel_error=float(np.linalg.norm(x - x_true) / np.linalg.norm(x_true)),
        max_memory_allocated=peak, launches=launches,
        gemm_prec=lu.numeric.gemm_prec,
        answer_tier=rep.gemm_precision,
        rungs=[(r.name, r.detail, r.seconds) for r in rungs],
        solve_schedule=lu.dev_solver.splan.schedule,
        solve_batches=len(lu.dev_solver.splan.groups),
        solve_fused=lu.dev_solver.fused,
        solver_memory=lu.dev_solver.memory_stats(),
        spmv_route="csr_spmv (card)" if launches["csr_spmv"] else "host",
        solve_report=rep.summary())
    check_berr("gssvx", berr)
    if lu.dev_solver.splan.schedule != "dataflow":
        raise AssertionError("the main path did not solve on the dataflow "
                             "schedule")
    default_run = dict(s=wall, fact_s=stats.utime["FACT"],
                       refine_s=stats.utime["REFINE"],
                       refine_steps=stats.refine_steps,
                       rungs=[(r.name, r.detail) for r in rungs],
                       answer_tier=rep.gemm_precision,
                       berr=berr, berr_history=rep.berr_history)
    for rec in records:
        rec["launches"] = launches[rec["name"]]

    # 4b. the reuse tiers and refactor on the main path's handle, 4c. the
    # complex path on its plan
    reuse_phase(slt, a, lu, wall, stats.utime["FACT"], kernels, tols, torch,
                factor)
    complex_phase(slt, a, lu, kernels, tols, torch)
    # 4d. the device solve's schedules, buckets, graphs and DiagInv; 4e. the
    # GEMM tiers on the main path's analysis
    solve_phase(lu, torch)
    gemm_tiers_phase(slt, a, lu, kernels, tols, default_run)

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

    # 6. the scatter work of one whole factorization
    in_factor, sums = factor_sums(plan, maps, bvals0, lu0.anorm, torch,
                                  factor, kernels, gen)
    say("kernels_factor", in_factorization=in_factor, replayed=sums,
        groups=len(plan.groups))
    if in_factor["launches"] != len(plan.groups):
        raise AssertionError(f"{in_factor['launches']} front_assemble "
                             f"launches for {len(plan.groups)} groups")
    del lu0, plan, bvals0, maps

    # 7. complex analysis from scratch, 8. the escalation ladder, 8b. the
    # other native orderings and the approximate matching
    complex_dofact_phase(slt, kernels, tols, torch)
    ladder_phase(slt, kernels, tols, torch)
    orderings_phase(slt, kernels, tols)

    # 9. kernels vs plain through the factorization, and small solves
    # against scipy in every direction
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
        raise AssertionError("fronts through the kernel != plain version")
    scipy_checks = {}
    for case, mat, trans, cplx in (
            ("poisson3d_12", poisson3d(12), "NOTRANS", False),
            ("convdiff_40 TRANS", convection_diffusion_2d(40), "TRANS", False),
            ("random_400c CONJ", random_sparse(400, density=0.02, seed=3,
                                               dtype=np.complex128),
             "CONJ", True)):
        scipy_checks[case] = scipy_check(slt, mat, trans, cplx, rng, tols)
    say("check", fronts_equal=same, groups=len(fk.fronts), scipy=scipy_checks)
    if not all(c["agrees"] for c in scipy_checks.values()):
        raise AssertionError(f"a small solve disagrees with scipy: "
                             f"{scipy_checks}")

    print(json.dumps({"kernels": [{k: r[k] for k in KEYS} for r in records]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
