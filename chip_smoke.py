#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (superlu_dist_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one result line each (the launch counts of every phase that
drives the port are reset just before it and checked just after):
  1. card     — the card's name and power limit (nvidia-smi);
  2. build    — compile the CUDA kernels from csrc/ with nvcc (sm_90a);
     native   — compile the native host-analysis library (native/
                slu_host.cpp, g++) and hold each of its functions against
                its Python twin on poisson3d(12) and random_sparse(1000):
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
     persist  — on that handle: save_lu, load_lu onto the card (fronts
                torch.equal) and a FACTORED solve from the loaded handle;
                the same skeleton factored under Options(deadline_s about
                half the main FACT, ckpt_dir), stopped at a group boundary
                0 < k < groups with its frontier on disk, and
                gssvx(resume_from=) from it, whose fronts must be
                torch.equal to the main handle's: bundle bytes, save / load
                / flush seconds, k, the resumed FACT;
     cli      — the main path's matrix written as a .mtx file and solved by
                ``python -m superlu_dist_tpu_torch -f <file> --stats``
                (``__main__.main`` in-process): rc 0, the reader's seconds,
                the report's FACT / SOLVE / REFINE seconds and BERR;
     reuse    — on that handle: a FACTORED solve, a TRANS solve, refactor
                on perturbed values (equal to a fresh factorization),
                SamePattern_SameRowPerm, condest, the residual-precision
                rung;
     complex  — a complex Helmholtz-type operator on the same pattern,
                factored in complex64 on the same plan, and a CONJ solve;
     solve    — on the main path's factors: the dataflow / level / factor
                solve plans (the JAX package's 90 / 106 / 134 batches), and
                nrhs 1 and 16 fused and eager, with and without DiagInv:
                SOLVE seconds, last_solve_stats, solver
                memory, BERR after refinement; every solve repeated bit for
                bit, the eager ones equal to the fused ones;
     gemm_tiers — gssvx on poisson3d(48) at the bf16 and f32 tiers beside
                the main path's default: FACT, refine steps, rungs, BERR;
     executors — Options.executor on the main path's plan: the stream; the
                fused CUDA graph (warm-up, capture, instantiation, node
                count, graph memory; replays bit for bit the stream, an
                earlier handle untouched; refactor through the replay);
                the host offload through gssvx (FACT, offload wait, peak
                device memory beside the stream's, the host solve, BERR);
     executors_small — on poisson3d(32): mega on a closed plan (one graph
                per closed key), the host-share split and level waves
                (bit for bit the stream), with their graphs' costs;
                ``python3 chip_smoke.py executors [NX]`` runs the build,
                gssvx and these two phases alone;
  5. factor_stages — the main path's factorization synchronized at every
                stage boundary of every group;
  6. kernels_factor — one more factorization with CUDA events around every
                front-assembly launch (no stage synchronize), then every
                group of the plan replayed alone for the kernel / plain /
                library / bound sums;
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
import os
import shutil
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
                    plain_reps=3, lib_reps=20):
    """K1 on one child set: the wrapper against the plain version, and the
    kernel's time on maps built once (the wrapper rebuilds them on the
    host at every call: timed apart as wrapper_ms)."""
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
    return dict(
        max_abs_err=err, ms=graph_ms(call, n=reps),
        call_ms=cuda_ms(call, reps),
        wrapper_ms=cuda_ms(lambda: kernels.extend_add_(work, pool, *ea), 3,
                           warm=1),
        plain_ms=cuda_ms(lambda: kernels.extend_add_plain(work, pool, *ea),
                         plain_reps, warm=1),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: flat.index_put_((dst,), vals,
                                                   accumulate=True), lib_reps),
        shape=dict(batch=f.shape[0], m=m, ub=ub, children=off.numel(),
                   pairs=dst.numel(), targets=n_targets))


def time_assemble(f, avals, a_slot, a_flat, a_src, kernels, reps=20,
                  plain_reps=20, lib_reps=50):
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
    return dict(
        max_abs_err=err, ms=graph_ms(call, n=reps),
        call_ms=cuda_ms(call, reps),
        wrapper_ms=cuda_ms(lambda: kernels.assemble_(work, avals, *asm), 3,
                           warm=1),
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
    front-assembly launch and no stage synchronize; (b) every group of the
    plan replayed alone — the kernel in a CUDA graph (ms) and call by call
    (call_ms, the wrapper's host time included), the plain version and the
    library call with CUDA events — summed with the bounds (float32).  (The
    sums of the standalone K1 / K2 wrappers over every child set and
    assembly, and of the front assembly in complex64, are timing only and
    left the script in PR 7, for the benchmark; those wrappers and types
    are still held against their plain versions in the kernels phase.)"""
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
    sums = dict.fromkeys(keys, 0.0)
    for g, gm in zip(plan.groups, maps):
        rec = time_front(avals, pool, g.m, g.w, gm, kernels, reps=5,
                         plain_reps=1, lib_reps=2)
        for k in keys:
            sums[k] += rec[k]
    in_factor["bound_ms"] = sums["bound_ms"]
    return in_factor, {"front_assemble": dict(units=len(plan.groups),
                                              **sums)}


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
    poisson3d(12) and random_sparse(1000): etree, postorder, the symbolic
    structure (with amalgamation), mmd, colamd and the AᵀA pattern equal,
    and the MC64 matching's log product equal to 1e-12 of Σ|log|a||.
    (PRs 4-6 used poisson3d(16) and random_sparse(2000); the twins' 19 s
    there bought no more than the CPU tests' comparison, and the script
    needed the room in PR 7.)"""
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
    for name, a in (("poisson3d_12", poisson3d(12)),
                    ("random_1000", random_sparse(1000, density=0.006,
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
#: the column-chunked solve: CHUNK_COLS columns under an nrhs cap of
#: CHUNK_CAP run as chunk_nrhs's 16 + 16 + 1 (buckets 16 and 1)
CHUNK_COLS, CHUNK_CAP, CHUNK_CHUNKS = 33, 16, 3


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
    (the JAX package's batch counts), then nrhs 1 and 16 through fused
    (CUDA graph) and eager sweeps, with and without DiagInv — SOLVE
    seconds (first call, with the graph captures, and the next, which must
    be bit for bit the first), last_solve_stats, the solver's memory, the
    agreement with the main configuration (fused, no DiagInv: the eager
    sweeps must equal it bit for bit), and the BERR of every column after
    refinement through the device residual.  The refinement runs on the
    factored matrix M = P_σ·diag(R)·A·diag(C)·P_πᵀ itself, whose
    componentwise BERR is A's (it is invariant under the scalings and
    permutations).  The column-chunked solve: CHUNK_COLS columns on a
    solver capped at CHUNK_CAP split into chunks of two nrhs buckets
    (``chunk_nrhs``), fused and eager, bit for bit, every column's BERR
    before refinement and every column refined (the nrhs-1,500 solve of
    PRs 5-6 drove the same chunking at the 1,024 cap in about 17 s a
    refinement step)."""
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
    rhs = {k: spmv.matvec(rng.standard_normal((n, k))) for k in (1, 16)}
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
                z1 = solver.solve(d)
                first = time.perf_counter() - t0
                t0 = time.perf_counter()
                z = solver.solve(d)
                steady = time.perf_counter() - t0
                # the lsum scatter sums in a fixed order: a solve repeats
                # bit for bit, and an eager one equals the fused one
                if not np.array_equal(z1, z):
                    raise AssertionError(f"solve {name} k={k}: two solves "
                                         "on one handle differ")
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
                    case["equal_to_fused"] = bool(np.array_equal(z, ref[k]))
                    if name == "eager" and not case["equal_to_fused"]:
                        raise AssertionError(f"solve eager k={k} differs "
                                             "from the fused solve")
                t0 = time.perf_counter()
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
    d = spmv.matvec(rng.standard_normal((n, CHUNK_COLS)))
    chunked, zs = {}, {}
    for fused in (True, False):
        name = "fused" if fused else "eager"
        solver = DeviceSolver(lu.numeric, fused=fused, nrhs_max=CHUNK_CAP,
                              gemm_prec=lu.numeric.gemm_prec)
        t0 = time.perf_counter()
        z = solver.solve(d)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        zs[name] = solver.solve(d)
        steady = time.perf_counter() - t0
        st = dict(solver.last_solve_stats)
        if (not np.array_equal(z, zs[name]) or not st["finite"]
                or st["chunks"] != CHUNK_CHUNKS):
            raise AssertionError(f"chunked solve {name}: {st}, two solves "
                                 f"equal {np.array_equal(z, zs[name])}")
        chunked[name] = dict(first_s=first, s=steady, stats={
            key: st[key] for key in ("nrhs", "padded_nrhs", "chunks",
                                     "fused")})
        if fused:
            r = d - spmv.matvec(z)
            den = spmv.abs_matvec(np.abs(z)) + np.abs(d)
            t0 = time.perf_counter()
            _, berrs = iterative_refinement(spmv, d, z, solver.solve)
            chunked[name].update(
                unrefined_berr_max=float(componentwise_berr(
                    r, den, spmv.nnz).max()),
                berr=berrs[-1], refine_steps=len(berrs),
                refine_s=time.perf_counter() - t0)
            check_berr("solve chunked", berrs[-1])
        del solver
    chunked["eager_equal_to_fused"] = bool(np.array_equal(zs["eager"],
                                                          zs["fused"]))
    out["chunked"] = chunked
    if not chunked["eager_equal_to_fused"]:
        raise AssertionError("the chunked eager solve differs from the "
                             "fused one")
    # the lsum scatter's launches per forward sweep — one index_add_ per
    # layer (scatter_layers), plus one gather where a row repeats — and the
    # device time of the two replayed sweeps (nrhs 1, with and without
    # DiagInv) beside the same graphs captured with the one-launch scatter
    # of PR 5, whose float atomics race on repeated rows (timing only)
    from superlu_dist_tpu_torch.solve import device as sdev
    layered = [lay for *_, lay in main._groups if lay is not None]
    scatter = dict(batches_with_repeats=len(layered),
                   launches_per_sweep=len(main._groups) + sum(
                       len(parts) for _, parts in layered))
    layered_scatter = sdev._scatter_add

    def atomic_scatter(lsum, rows, contrib, layers):
        lsum.index_add_(0, rows.reshape(-1),
                        contrib.reshape(-1, contrib.shape[-1]))

    for label, fn in (("layered", layered_scatter),
                      ("atomic_pr5", atomic_scatter),
                      ("layered_again", layered_scatter)):
        sdev._scatter_add = fn
        try:
            for diag in (False, True):
                solver = DeviceSolver(lu.numeric, diag_inv=diag, fused=True,
                                      gemm_prec=lu.numeric.gemm_prec)
                solver.solve(rhs[1])

                graphs = list(solver._graphs.values())   # fwd, bwd

                def replay():
                    for graph in graphs:
                        graph.replay()

                scatter[f"{label}{'+diaginv' if diag else ''}_ms"] = \
                    cuda_ms(replay, 20)
                del solver
        finally:
            sdev._scatter_add = layered_scatter
    say("solve", n=n, schedule="dataflow", batches=len(main.splan.groups),
        gemm_prec=main.gemm_prec, main_solver_memory=main.memory_stats(),
        scatter=scatter, **out)


def persist_phase(slt, a, b, lu, lu0, bvals0, fact_s, kernels, tols, torch,
                  workdir):
    """Phase 4a, on the main path's handle before anything refactors it:
    save_lu, then load_lu onto the card (every front torch.equal) and a
    FACTORED solve from the loaded handle; then the factorization of the
    same skeleton under Options(deadline_s ≈ half the main FACT,
    ckpt_dir), which must stop at a group boundary 0 < k < groups with
    its frontier on disk (one retry with the deadline moved if k lands at
    an end), and gssvx(resume_from=) from that frontier, whose every
    front must be torch.equal to the main handle's (same plan, values and
    tier) with stats.resume["groups"] == k.  Bundle bytes, save / load /
    flush seconds and the launch counts of each step."""
    import dataclasses
    import shutil
    from superlu_dist_tpu_torch.persist import checkpoint, serial
    groups = len(lu.plan.groups)
    out = {}

    def equal_fronts(f1, f2):
        return all(torch.equal(p[0], q[0]) and torch.equal(p[1], q[1])
                   for p, q in zip(f1, f2)) and len(f1) == len(f2)

    bundle = os.path.join(workdir, "handle")
    kernels.reset_launches()
    t0 = time.perf_counter()
    slt.save_lu(lu, bundle)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lu2 = slt.load_lu(bundle)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if lu2.device.type != "cuda" or not equal_fronts(lu.numeric.fronts,
                                                     lu2.numeric.fronts):
        raise AssertionError("load_lu(save_lu(lu)) fronts != the saved ones")
    out["bundle"] = dict(bytes=serial.lu_meta(bundle)["nbytes"], save_s=save_s,
                         load_s=load_s, fronts_equal=True,
                         launches=expect_launches("persist save/load",
                                                  kernels, 0, False))
    x, _, st, sec = timed_gssvx(slt, kernels,
                                slt.Options(fact=slt.Fact.FACTORED), a, b,
                                lu=lu2)
    if st.utime["FACT"] != 0:
        raise AssertionError("the loaded handle's FACTORED solve factored")
    out["factored_from_bundle"] = dict(
        s=sec, berr=st.solve_report.berr, refine_steps=st.refine_steps,
        launches=expect_launches("persist factored", kernels, 0, True))
    check_berr("persist factored", st.solve_report.berr)
    del lu2
    shutil.rmtree(bundle)

    # the deadline: the flush is timed around the checkpointer's own call
    flushes = []
    flush = checkpoint.FactorCheckpointer.flush

    def timed_flush(self, *args, **kw):
        t = time.perf_counter()
        try:
            return flush(self, *args, **kw)
        finally:
            flushes.append(time.perf_counter() - t)

    ck = os.path.join(workdir, "ck")
    deadline_s, attempts = 0.5 * fact_s, []
    checkpoint.FactorCheckpointer.flush = timed_flush
    try:
        for _ in range(2):
            shutil.rmtree(ck, ignore_errors=True)
            flushes.clear()
            opts = slt.Options(deadline_s=deadline_s, ckpt_dir=ck)
            kernels.reset_launches()
            t0 = time.perf_counter()
            try:
                slt.factorize_numeric(dataclasses.replace(lu0, options=opts),
                                      bvals0)
                k, err = groups, None
            except slt.DeadlineExceededError as e:
                err = e
                k = (checkpoint.peek(ck)["k"] if e.checkpoint_path else 0)
            torch.cuda.synchronize()
            attempts.append(dict(
                deadline_s=deadline_s, k=k, s=time.perf_counter() - t0,
                elapsed_s=err.elapsed_s if err else None,
                flush_s=list(flushes),
                launches=dict(kernels.LAUNCHES)))
            if 0 < k < groups:
                break
            deadline_s *= 0.5 if k == groups else 2.0
    finally:
        checkpoint.FactorCheckpointer.flush = flush
    if not 0 < k < groups or attempts[-1]["launches"]["front_assemble"] != k:
        raise AssertionError(f"the deadline left no inner frontier: "
                             f"{attempts}")
    ck_bytes = sum(os.path.getsize(os.path.join(ck, f))
                   for f in os.listdir(ck))
    x, lur, st, sec = timed_gssvx(slt, kernels, slt.Options(), a, b,
                                  device="cuda", resume_from=ck)
    resumed = dict(s=sec, fact_s=st.utime["FACT"], resume=st.resume,
                   rungs=[(r.name, r.detail) for r in st.solve_report.rungs],
                   berr=st.solve_report.berr,
                   launches=expect_launches(
                       "persist resume", kernels,
                       groups - k + groups * (factorizations(
                           st.solve_report) - 1), True))
    if st.resume.get("groups") != k or not equal_fronts(lur.numeric.fronts,
                                                        lu.numeric.fronts):
        raise AssertionError(f"the resume from frontier {k} is not bitwise "
                             f"the uninterrupted factorization: {st.resume}")
    check_berr("persist resume", st.solve_report.berr)
    shutil.rmtree(ck)
    say("persist", n=a.n_rows, groups=groups, k=k, checkpoint_bytes=ck_bytes,
        deadline=attempts, resumed=resumed, fronts_equal=True, **out,
        berr_target=float(tols.berr_target(np.float64)))


def cli_phase(slt, a, kernels, tols, workdir):
    """Phase 4b: the main path's matrix written as a Matrix Market file,
    then ``python -m superlu_dist_tpu_torch -f <file> --stats`` in-process
    (``__main__.main``): rc 0, the report's FACT / SOLVE / REFINE seconds
    and the backward error, read from its output, at the float64 gate."""
    import contextlib
    import io
    import re
    from superlu_dist_tpu_torch.__main__ import main as cli_main
    from superlu_dist_tpu_torch.io import write_matrix_market
    path = os.path.join(workdir, f"poisson3d_{NX}.mtx")
    t0 = time.perf_counter()
    write_matrix_market(path, a)
    write_s = time.perf_counter() - t0
    buf = io.StringIO()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["-f", path, "--stats"])
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    launches = dict(kernels.LAUNCHES)

    def num(pattern):
        m = re.search(pattern, text, re.M)
        if not m:
            raise AssertionError(f"cli: no {pattern!r} in {text}")
        return float(m.group(1))

    got = dict(rc=rc, wall_s=wall, write_s=write_s, file_bytes=os.path.getsize(
        path), read_s=num(r"read in ([0-9.]+) s"),
        phase_s={p: num(rf"^\s*{p}\s+time\s+([0-9.]+)")
                 for p in ("FACT", "SOLVE", "REFINE")},
        berr=num(r"backward error \(IR\)\s+([-+0-9.eE]+)"),
        residual=num(r"residual \|\|b-Ax\|\|/\|\|b\|\|\s+([-+0-9.eE]+)"),
        launches=launches, report=text.splitlines())
    os.remove(path)
    say("cli", n=a.n_rows, nnz=a.nnz, **got,
        berr_target=float(tols.berr_target(np.float64)))
    if rc != 0 or not launches["front_assemble"] or not launches["csr_spmv"]:
        raise AssertionError(f"cli: rc {rc}, launches {launches}")
    check_berr("cli", got["berr"])


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


def _fronts_equal(torch, f1, f2) -> bool:
    return len(f1) == len(f2) and all(
        torch.equal(l1.cpu(), l2.cpu()) and torch.equal(u1.cpu(), u2.cpu())
        for (l1, u1), (l2, u2) in zip(f1, f2))


def _drift(torch, tols, f1, f2) -> dict:
    """f1 against f2: bit for bit, max |f1 - f2| / max |f2|, and every
    element within SCHEDULE_DRIFT_RTOL / ATOL (float64 on the host)."""
    num = den = 0.0
    within = True
    for (l1, u1), (l2, u2) in zip(f1, f2):
        for x, y in ((l1, l2), (u1, u2)):
            x, y = x.cpu().double(), y.cpu().double()
            if x.numel():
                num = max(num, float((x - y).abs().max()))
                den = max(den, float(y.abs().max()))
                within &= bool(torch.allclose(
                    x, y, rtol=tols.SCHEDULE_DRIFT_RTOL,
                    atol=tols.SCHEDULE_DRIFT_ATOL))
    return dict(equal_to_stream=_fronts_equal(torch, f1, f2),
                max_rel_diff_vs_stream=num / max(den, 1e-300),
                within_schedule_drift=within)


def _drift_ok(tols, rec, dtype) -> bool:
    """A ``_drift`` record within its gate: every element within
    SCHEDULE_DRIFT in float64; in float32 (TF32 tier) the normwise drift
    at most TF32_DRIFT, which the record then carries."""
    import torch
    if dtype == torch.float64:
        return rec["within_schedule_drift"]
    rec["float32_gate"] = float(tols.TF32_DRIFT)
    return rec["max_rel_diff_vs_stream"] <= tols.TF32_DRIFT


def _timed_factor(torch, kernels, factor, plan, vals, anorm, dtype=None,
                  **kw):
    """numeric_factorize on the card (float32 unless ``dtype``) at the
    default tier, with the launch counts reset just before it: (factors,
    seconds to a synchronized end, peak device bytes above what was
    allocated before, launches)."""
    kernels.reset_launches()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    num = factor.numeric_factorize(plan, vals, anorm,
                                   dtype=dtype or torch.float32,
                                   device="cuda", **kw)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    return (num, sec, torch.cuda.max_memory_allocated() - base,
            dict(kernels.LAUNCHES))


def _expect_front_launches(phase, launches, want):
    if launches["front_assemble"] != want or any(
            launches[k] for k in ("extend_add", "assemble", "csr_spmv")):
        raise AssertionError(f"launches in {phase}: {launches}, expected "
                             f"{want} front_assemble and nothing else")
    return launches["front_assemble"]


def executors_phase(slt, a, lu, kernels, tols, torch, factor):
    """Options.executor on the card.  At the main path's width (its handle
    and plan, float32, default tier): the streamed executor; ``fused`` —
    its first call (warm-up, capture, instantiation, replay), two replays
    of the same values and one of new values, each bit for bit the stream
    on the same values, the first call's fronts untouched by the later
    replays, and refactor through the replay; the host offload
    (``front_bytes_limit=0``) through gssvx: FACT, the offload wait, the
    peak device memory above the resident handle beside the stream's, the
    host solve and refinement and BERR.  Then on poisson3d(32): ``mega``
    on a closed plan (one graph per closed key) and the host-share split,
    each in float64 and float32 against the stream (``_drift_ok``), and
    level waves (bit for bit the stream).  Launch counts: the warm-up's launches and one per
    group for each replay."""
    import dataclasses

    from superlu_dist_tpu_torch.models.gallery import poisson3d
    from superlu_dist_tpu_torch.numeric.stream import (StreamExecutor,
                                                       host_share_levels)
    from superlu_dist_tpu_torch.symbolic.symbfact import _front_flops
    from superlu_dist_tpu_torch.numeric.plan import bucket_rung
    same_rows = slt.Options(fact=slt.Fact.SamePattern_SameRowPerm)
    plan = lu.plan
    groups = len(plan.groups)
    keys = len({(g.batch, g.m, g.w, g.u) for g in plan.groups})
    rng = np.random.default_rng(SEED + 90)
    mats, vals = [], []
    for scale in (0.0, 0.05, 0.05):
        u = rng.uniform(-1.0, 1.0, a.nnz)
        m = type(a)(a.n_rows, a.n_cols, a.indptr, a.indices,
                    lu.a.data * (1.0 + scale * u))
        skel, bv, _ = slt.analyze(same_rows, m, device="cuda", lu=lu)
        mats.append(m)
        vals.append((bv, skel.anorm))
    out = {}

    # the streamed executor on the first two sets of values
    ref = []
    for i in (0, 1):
        num, sec, peak, launches = _timed_factor(
            torch, kernels, factor, plan, *vals[i], executor="stream")
        ref.append(num.fronts)
        if i == 0:
            out["stream"] = dict(fact_s=sec, peak_above_resident=peak,
                                 launches=_expect_front_launches(
                                     "stream", launches, groups))
    # fused: capture at the first call, then replays
    calls, fused_eq = [], []
    for i in (0, 0, 1):
        num, sec, peak, launches = _timed_factor(
            torch, kernels, factor, plan, *vals[i], executor="fused")
        calls.append(num)
        fused_eq.append(_fronts_equal(torch, num.fronts, ref[i]))
        rep = num.executor
        first = len(calls) == 1
        want = groups + (keys if first else 0)
        rec = dict(s=sec, replay_s=rep["replay_s"],
                   peak_above_resident=peak, equal_to_stream=fused_eq[-1],
                   launches=_expect_front_launches("fused", launches, want))
        if first:
            rec.update({k: rep[k] for k in (
                "warm_up_s", "capture_s", "instantiate_s", "nodes",
                "graph_device_bytes", "graph_host_bytes", "clone_bytes")})
        out[f"fused_call{len(calls)}"] = rec
    replays_equal = _fronts_equal(torch, calls[0].fronts, calls[1].fronts)
    old_untouched = _fronts_equal(torch, calls[0].fronts, ref[0])
    out["fused_checks"] = dict(equal_to_stream=fused_eq,
                               two_replays_equal=replays_equal,
                               first_handle_untouched=old_untouched)
    del calls, ref
    # refactor through the replay: the handle's options ask for fused, the
    # plan's cached executor (captured above) replays
    hf = dataclasses.replace(lu, options=dataclasses.replace(
        lu.options, executor="fused"), dev_solver=None, dev_spmv=None)
    kernels.reset_launches()
    t0 = time.perf_counter()
    st = slt.refactor(hf, mats[2].data)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    rlaunch = _expect_front_launches("fused refactor", kernels.LAUNCHES,
                                     groups)
    b3 = mats[2].matvec(rng.standard_normal(a.n_rows))
    _, _, st2, sec2 = timed_gssvx(slt, kernels,
                                  slt.Options(fact=slt.Fact.FACTORED),
                                  mats[2], b3, lu=hf)
    out["fused_refactor"] = dict(s=sec, fact_s=st.utime["FACT"],
                                 executor=hf.numeric.executor["executor"],
                                 launches=rlaunch, solve_s=sec2,
                                 berr=st2.solve_report.berr)
    check_berr("fused refactor", st2.solve_report.berr)
    del hf
    if not (all(fused_eq) and replays_equal and old_untouched):
        say("executors", **out)
        raise AssertionError("fused replays differ from the stream or "
                             "touched an earlier handle")

    # the host offload through gssvx: factors to host memory, host solve
    b1 = mats[0].matvec(rng.standard_normal(a.n_rows))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    x, luo, st, sec = timed_gssvx(
        slt, kernels, dataclasses.replace(same_rows, front_bytes_limit=0),
        mats[0], b1, lu=lu)
    rep, ex = st.solve_report, st.executor
    launches = dict(kernels.LAUNCHES)
    if (not luo.numeric.on_host or rep.solve_route != "host"
            or rep.residual_route != "host" or launches["csr_spmv"]
            or launches["front_assemble"] != groups):
        raise AssertionError(f"offload: on_host={luo.numeric.on_host} "
                             f"routes {rep.solve_route}/{rep.residual_route}"
                             f" launches {launches}")
    out["offload"] = dict(
        s=sec, fact_s=st.utime["FACT"], offload_wait_s=ex["offload_wait_s"],
        peak_above_resident=st.peak_memory_bytes - base,
        stream_peak_above_resident=out["stream"]["peak_above_resident"],
        host_solve_s=st.utime["SOLVE"], refine_s=st.utime["REFINE"],
        refine_steps=st.refine_steps, berr=rep.berr,
        solve_route=rep.solve_route, residual_route=rep.residual_route,
        launches=launches["front_assemble"])
    check_berr("offload", rep.berr)
    del luo, x
    say("executors", n=a.n_rows, groups=groups, shape_keys=keys, **out)

    # poisson3d(32): mega on a closed plan, the host-share split, level
    # waves; mega and the split in float64 held at the SCHEDULE_DRIFT gate
    # (another cuBLAS algorithm for a padded batch, or the CPU's BLAS,
    # reassociates the sums), in float32 at the TF32 tier normwise at
    # TF32_DRIFT
    a32 = poisson3d(32)
    b32 = a32.matvec(rng.standard_normal(a32.n_rows))
    small = {}
    lu_c, bv_c, _ = slt.analyze(slt.Options(bucket_closed=True), a32,
                                device="cuda")
    pc = lu_c.plan
    nkeys = len(pc.bucket_set)
    small["mega"] = dict(closed=pc.closed, closed_keys=nkeys,
                         groups=len(pc.groups))
    for dt in (torch.float64, torch.float32):
        s_num, s_sec, _, _ = _timed_factor(torch, kernels, factor, pc, bv_c,
                                           lu_c.anorm, executor="stream",
                                           dtype=dt)
        megas = []
        for i in (0, 1):
            num, sec, _, launches = _timed_factor(
                torch, kernels, factor, pc, bv_c, lu_c.anorm,
                executor="mega", dtype=dt)
            megas.append(dict(s=sec, launches=launches["front_assemble"],
                              **_drift(torch, tols, num.fronts,
                                       s_num.fronts)))
        rep = num.executor
        small["mega"][str(dt)[6:]] = dict(
            stream_fact_s=s_sec, first=megas[0], replayed=megas[1],
            **{k: rep[k] for k in ("graphs", "capture_s", "instantiate_s",
                                   "nodes", "graph_device_bytes")})
        if rep["graphs"] != nkeys or megas[1]["launches"] != len(pc.groups):
            raise AssertionError(f"mega: {rep['graphs']} graphs for {nkeys}"
                                 f" closed keys, launches {megas}")
        if not all(_drift_ok(tols, c, dt)
                   for c in megas):
            raise AssertionError(f"mega drifts from the stream: {megas}")
        del s_num, num
    del lu_c, bv_c, pc

    lu_d, bv_d, _ = slt.analyze(slt.Options(), a32, device="cuda")
    pd = lu_d.plan
    # the host share: the least threshold that puts the first level on
    # the CPU
    lv0 = max(bucket_rung(g.batch, lo=1, growth=2.0) * _front_flops(g.w, g.u)
              for g in pd.groups if g.level == pd.groups[0].level)
    cut = float(lv0) * 1.0001
    small["host_share"] = dict(host_flops=cut,
                               levels=len(host_share_levels(pd, cut)),
                               host_tier="IEEE products on the CPU's BLAS")
    for dt in (torch.float64, torch.float32):
        s_num, s_sec, _, _ = _timed_factor(torch, kernels, factor, pd, bv_d,
                                           lu_d.anorm, executor="stream",
                                           dtype=dt)
        x, luh, st, sec = timed_gssvx(
            slt, kernels, dataclasses.replace(
                same_rows, host_flops=cut, factor_dtype=str(dt)[6:]),
            a32, b32, lu=lu_d)
        hnum = luh.numeric
        rec = dict(host_levels=hnum.host_levels,
                   host_groups=st.executor["host_groups"],
                   fact_s=st.utime["FACT"], stream_fact_s=s_sec,
                   uploaded_front_bytes=luh.dev_solver.memory_stats()[
                       "uploaded_front_bytes"], berr=st.solve_report.berr,
                   launches=kernels.LAUNCHES["front_assemble"],
                   device_groups=len(pd.groups) - st.executor["host_groups"],
                   **_drift(torch, tols, hnum.fronts, s_num.fronts))
        small["host_share"][str(dt)[6:]] = rec
        check_berr("host share", st.solve_report.berr)
        if hnum.host_levels < 1 or rec["launches"] != rec["device_groups"] \
                or not _drift_ok(tols, rec, dt):
            raise AssertionError(f"host share: {small['host_share']}")
        del luh, x, hnum

    real = torch.float32
    s_num, s_sec, _, _ = _timed_factor(torch, kernels, factor, pd, bv_d,
                                       lu_d.anorm, executor="stream")
    thresh = torch.tensor(np.sqrt(torch.finfo(real).eps)
                          * max(lu_d.anorm, 1e-300), dtype=real)
    ex = StreamExecutor(pd, real, "cuda", granularity="level")
    lev = []
    for i in (0, 1):
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fr, tiny = ex(torch.as_tensor(bv_d), thresh)
        torch.cuda.synchronize()
        lev.append(dict(s=time.perf_counter() - t0,
                        launches=kernels.LAUNCHES["front_assemble"],
                        equal_to_stream=_fronts_equal(torch, fr,
                                                      s_num.fronts)))
    rep = ex.report()
    small["level"] = dict(waves=len(ex.waves()), graphs=rep["graphs"],
                          stream_fact_s=s_sec, first=lev[0], replayed=lev[1],
                          **{k: rep[k] for k in ("warm_up_s", "capture_s",
                                                 "instantiate_s", "nodes",
                                                 "graph_device_bytes")})
    say("executors_small", n=a32.n_rows, **small)
    if not all(c["equal_to_stream"] for c in lev) or \
            lev[1]["launches"] != len(pd.groups):
        raise AssertionError(f"level waves: {lev}")


def executors_only(nx: int) -> int:
    """``python3 chip_smoke.py executors [NX]``: the build, gssvx on
    poisson3d(NX) and the executors phases only (a quicker check of the
    executors; the full script runs every phase)."""
    import torch
    import superlu_dist_tpu_torch as slt
    from superlu_dist_tpu_torch.models.gallery import poisson3d
    from superlu_dist_tpu_torch.numeric import factor, kernels
    from superlu_dist_tpu_torch.utils import tols
    card = card_line()
    say("card", nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda)
    kernels.library()
    a = poisson3d(nx)
    b = a.matvec(np.random.default_rng(SEED).standard_normal(a.n_rows))
    x, lu, stats, info = slt.gssvx(slt.Options(), a, b, device="cuda")
    say("gssvx", n=a.n_rows, fact_s=stats.utime["FACT"],
        berr=stats.solve_report.berr)
    executors_phase(slt, a, lu, kernels, tols, torch, factor)
    print(card)
    return 0


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["executors"]:
        return executors_only(int(sys.argv[2]) if len(sys.argv) > 2 else NX)
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

    # 4a. the handle saved, loaded and solved; a deadline-stopped
    # factorization resumed; 4b. the file-driven CLI on the same matrix —
    # under build/ in the checkout (bundles of 0.6-1.6 GB)
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    try:
        persist_phase(slt, a, b, lu, lu0, bvals0, stats.utime["FACT"],
                      kernels, tols, torch, workdir)
        cli_phase(slt, a, kernels, tols, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # 4c. the reuse tiers and refactor on the main path's handle, 4d. the
    # complex path on its plan
    reuse_phase(slt, a, lu, wall, stats.utime["FACT"], kernels, tols, torch,
                factor)
    complex_phase(slt, a, lu, kernels, tols, torch)
    # 4e. the device solve's schedules, buckets, graphs and DiagInv; 4f. the
    # GEMM tiers on the main path's analysis
    solve_phase(lu, torch)
    gemm_tiers_phase(slt, a, lu, kernels, tols, default_run)
    # 4g. Options.executor: fused and mega CUDA graphs, host offload, the
    # host-share split, level waves
    executors_phase(slt, a, lu, kernels, tols, torch, factor)

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
