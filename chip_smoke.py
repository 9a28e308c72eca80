#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (superlu_dist_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one result line each (the launch counts of every phase that
drives the port are reset just before it and checked just after):
  1. card     — the card's name and power limit (nvidia-smi);
     lint     — the port's static analyser over its default scope
                (``python -m superlu_dist_tpu_torch.analysis --no-cache``
                in a subprocess, on a host without jax): files, findings,
                rules and seconds; any finding fails the script;
  2. build    — compile the CUDA kernels from csrc/ with nvcc (sm_90a);
     native   — compile the native host-analysis library (native/
                slu_host.cpp, g++) and hold each of its functions against
                its Python twin on poisson3d(12) and random_sparse(1000):
                etree, postorder, symbolic, mmd, colamd, the AᵀA pattern
                equal, and the MC64 matching's diagonal product;
     config4  — the main path at the reference's own size, in a child
                process on an empty card (``config4_only``; alone:
                ``python3 chip_smoke.py config4``): gssvx(Options()) on
                poisson3d(100) (n = 1,000,000), float32 factors kept on
                the card by the offload rule (its estimate, budget and
                choice), solves on the card, BERR at the float64 target,
                every kernel launched, the peak device memory above what
                was resident within the rule's estimate, a FACTORED gssvx
                at nrhs 16; then front_assemble bit for bit its plain
                version at two groups reading pool offsets above 2**31
                and panel_lu at the widest front's panel (m = 16,176),
                with ms and bounds; then the other executors on the same
                analysis under the rule (``config4_executors``): level
                waves in float32 (offloaded, fronts within TF32_DRIFT of
                the stream's, peak within the estimate, BERR), fused and
                mega in float32 refused by name with nothing allocated,
                and the stream in float64 (offloaded: FACT, host SOLVE,
                REFINE, BERR; or refused); and the graph executors'
                device memory (mega, level waves: poisson3d(32), closed
                plan, float64) at or below the estimate the rule reads;
     grid4    — the grid on distinct cards, in a child process where four
                cards are visible (``grid4_only``; alone: ``python3
                chip_smoke.py grid4``, which exits 2 naming the count on
                fewer; with fewer the full run prints a grid4 line saying
                it did not run): one spawned rank a card over NCCL; fused,
                level and mega as one graph a unit with their collectives
                inside at poisson3d(16) and (25) on 1x2 and 2x2 against
                the eager 2-D executor; then poisson3d(100) on 2x2 with
                pool_partition: the one-card stream, the 2-D stream and
                the captured fused in float32 with a x1.5 replay, float64,
                and the closed plan with the stream and mega — each rank's
                estimate, budget, choice and peak, FACT, SOLVE, REFINE,
                graphs, collectives and BERR on a grid4_leg line a leg;
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
                timed beside torch.sparse.mm; the panel LU kernel
                (panel_lu) against its plain column loop bit for bit at the
                plan's largest group's first panel in all four types,
                timed beside lu_factor_ex(pivot=False) + solve_triangular,
                and on a sentinel panel (tiny and zero pivots, zeros of
                both signs, inf and NaN);
  4. gssvx    — the main path: gssvx(Options()) on poisson3d(48)
                (n=110,592): float32 factors at the default GEMM tier
                (TF32) on the card, the dataflow solve schedule fused in
                CUDA graphs, float64 refinement with its residual through
                csr_spmv, the ladder when refinement misses;
     audit    — the runtime program audits (utils/programaudit.py) on the
                main path's handle: gssvx SamePattern_SameRowPerm with
                every audit off, then with SLU_TPU_VERIFY_PROGRAMS /
                _DTYPES / _SHARDING on and SLU_TPU_MEM_BUDGET_BYTES at the
                card's 80e9 on a fresh executor: every group and solve
                program walked on fake tensors before it runs, 0 findings,
                programs per site, in-place coverage, baked bytes, the
                audits' host seconds, the launches, sync calls and BERR
                the un-audited run's; the largest program's peak estimate
                beside the run's measured peak above what was resident;
                then a budget of half the largest estimate:
                MemoryBudgetError naming the first program above it, no
                launch and no memory allocated; its
                grid leg (audit_mesh, at the end of the mesh phase on its
                two processes): a 2-D FACT of poisson3d(16) audited on both
                ranks, every group program clean, the ranks' collective
                digests equal, fronts bit for bit the un-audited FACT's
                (``python3 chip_smoke.py audit``: the build, gssvx and
                this phase with a mesh peer of its own);
     persist  — on that handle: save_lu, load_lu onto the card (fronts
                torch.equal) and a FACTORED solve from the loaded handle;
                then a gssvx handle of poisson3d(25) and its skeleton
                factored under Options(deadline_s, ckpt_dir), the
                deadline aimed at the middle group boundary's poll of the
                run before, stopped at a group boundary 0 < k < groups
                with its frontier on disk, and gssvx(resume_from=) from
                it, whose fronts must be torch.equal to that handle's:
                bundle bytes, save / load / flush seconds, k, the resumed
                FACT (``python3 chip_smoke.py persist``: the build, gssvx
                and this phase alone);
     cli      — poisson3d(25) written as a .mtx file and solved by
                ``python -m superlu_dist_tpu_torch -f <file> --stats``
                (``__main__.main`` in-process): rc 0, the reader's seconds,
                the report's FACT / SOLVE / REFINE seconds and BERR;
     serve    — the serving tier on that handle and the persist bundle: a
                SolveServer under 8 client threads and 64 seeded requests
                (nrhs 1 / 4 / 16 / 40), cold and with its buckets warmed
                (requests/s, p50/p99 latency, batches, batch fill, graph
                captures; a seeded sample of batches against
                lu.solve_factored, timed in stages); 16 requests
                through the BERR gate (residuals through csr_spmv);
                from_bundle bit for bit the live server, a poisoned column
                isolated and a corrupted panel scrubbed (chaos);
                SolveServer.refactor (one front_assemble launch per
                group); a FleetRouter of two process replicas over the
                poisson3d(48) and (25) bundles with one replica killed;
     pgssvx   — the distributed driver (parallel/pgssvx.py): block rows
                of poisson3d(25) on 4 ranks, rank 0 this process on the
                card, ranks 1-3 spawned CPU processes (started after the
                native phase, so their imports overlap the phases
                between): info, BERR, every peer's x bit for bit rank
                0's, x within DEVICE_VS_HOST of gssvx's, front_assemble
                launches = groups and no csr_spmv launch, the root's
                analysis native; wall, gather, analysis, FACT, root SOLVE
                and distributed refinement seconds, CommStats per op, the
                StatsSummary balance, the peers' spawn-to-attach seconds,
                the longest heartbeat gap; FACTORED with rank 0's handle
                at nrhs 4 (no front_assemble launch); pgssvx_ft with
                Options(ft="shrink") on poisson3d(16) and 3 ranks, rank 2
                killed before its 6th collective: one FtEvent, x bit for
                bit the undisturbed run's; no peer with a CUDA context,
                no child process or shared-memory segment left
                (``python3 chip_smoke.py pgssvx``: the build, gssvx and
                this phase);
     mesh     — the mesh tier (parallel/spmd.py, pgssvx(grid=)): block
                rows of poisson3d(48) on a 1x2 grid, rank 0 this process
                and rank 1 a process spawned after the native phase, both
                on the card over gloo: backend, x within DEVICE_VS_HOST of
                gssvx's, BERR, the tiny count gssvx's, each rank holding
                only its own slots, the fronts gathered to slot order
                within TF32_DRIFT of the stream's (or bit for bit),
                front_assemble launches per rank = the groups where it
                owns a slot, csr_spmv launches per rank = two a
                refinement step (the residual and its denominator over
                the rank's block rows, parallel/dist.ShardedSpMV), both
                kernels bit for bit their plain versions at each rank's
                shapes; per rank the analysis broadcast, FACT,
                gather bytes and seconds, SOLVE, REFINE, peak memory; then
                FACTORED at nrhs 1 on the sharded handles,
                SamePattern_SameRowPerm on the values times 1.5 and
                par_symb_fact=True on poisson3d(16); then the 2-D mesh
                executor (parallel/mesh_stream.py) on the same two
                processes: pgssvx(grid=gridinit(1, 2)) on poisson3d(48)
                with Options(executor="stream", pool_partition=True),
                the same checks, each rank holding only its own columns,
                front_assemble on each rank's column share bit for bit
                its plain version, and per rank the pool, exchange and
                row-broadcast bytes, seconds and counts; FACTORED at
                nrhs 1 and the SamePattern refactor on the 2-D handles;
                then three grid legs on the same processes: host offload
                over the partitioned pool (factors host-resident, the
                device peak below the 2-D run's, the solves in host
                memory; FACTORED at nrhs 4), and fused and mega as
                segment graphs (captured at DOFACT, replayed by the
                SamePattern refactor; fronts within TF32_DRIFT of the 2-D
                run's; per rank segments, capture seconds, graph bytes,
                launches) (``python3 chip_smoke.py mesh``: the build,
                gssvx and this phase);
     entry    — the reference's user entry points on the card: the C
                client (bindings/test_capi.c over libslu_tpu_torch.so,
                built with gcc into build/ and started after the native
                phase, waiting in slu_tpu_init(NULL) for this phase)
                factors poisson3d(48) through slu_tpu_factor_opts, solves
                FACTORED at nrhs 1 and 4 (ldb > n), reads its statistics,
                refactors poisson3d(25) at tier 2 and finalizes: exit 0,
                x within DEVICE_VS_HOST of the main handle's solve of the
                same b, A·x against b, BERR at the float64 target, and from
                its metrics export (SLU_TPU_METRICS) 134 front_assemble
                launches for its DOFACT and csr_spmv in its refinement;
                its start, DOFACT, solve, refactor and finalize seconds;
                then the 14 example drivers in this process (exit 0, the
                residual line, front_assemble launches) and pdtest's 24
                --quick runs at 1x1 (``python3 chip_smoke.py entry``: the
                build, gssvx and this phase);
     reuse    — on that handle: a FACTORED solve, a TRANS solve, refactor
                on perturbed values (equal to a fresh factorization and
                to the serve phase's SolveServer.refactor),
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
     gemm_tiers — gssvx on poisson3d(16) at the default, bf16 and f32
                tiers: FACT, refine steps, rungs, BERR;
     executors — Options.executor on the main path's plan: the stream;
     executors_small — on poisson3d(25) (the persist phase's handle): the
                host offload through gssvx
                (FACT, offload wait, peak device memory beside the
                stream's, the host solve, BERR), the fused CUDA graph (warm-up,
                capture, instantiation, node count, graph memory; replays
                bit for bit the stream, an earlier handle untouched;
                refactor through the replay); on poisson3d(16) mega on
                a closed plan (one graph per closed key), the host-share
                split and level waves (bit for bit the stream), with their
                graphs' costs;
                ``python3 chip_smoke.py executors [NX]`` runs the build,
                gssvx and these two phases alone (``python3 chip_smoke.py
                serve``: the build, gssvx, its bundle and the serve
                phase);
     trace    — the factor executors' kernel spans (obs/kernelspans.py):
                on the main path's plan one untraced FACT and one under a
                file Tracer, their torch.cuda.synchronize calls counted
                (the traced one may make no more) and their walls; a span
                a group, each with a positive device time and the JAX
                args, their sum within the traced wall, the five largest,
                last_profile and last_dispatch_seconds; then traced level
                waves and fused at poisson3d(25), mega at (16); its grid
                leg (trace_mesh, run at the end of the mesh phase on its
                two processes): a traced 2-D FACT of poisson3d(16) with a
                span a group on both ranks, and granularity="level" — its
                fronts bit for bit the FACT's, a span a wave, fewer
                segment graphs than the grid's fused executor, x from
                pgssvx FACTORED on its factors within DEVICE_VS_HOST of
                gssvx's, BERR at the target (``python3 chip_smoke.py
                trace``: the build, the analysis, gssvx at 25 and this
                phase with a mesh peer of its own);
  5. factor_stages — the main path's factorization synchronized at every
                stage boundary of every group;
     factor_profile — one more under torch.profiler: device ms and
                launches per kind of kernel, busy time and idle share, the
                FACT's pivot steps (Σ pa over its panels) and the panel
                LU's launch 1 µs a step;
  6. kernels_factor — one more factorization with CUDA events around every
                front-assembly launch and panel LU call (no stage
                synchronize), then every group (float32) and every panel
                of the plan (in all four types) replayed alone for the
                kernel / plain / library / bound sums (each panel bit for
                bit its plain loop);
  7. complex_dofact — gssvx from scratch on helmholtz_2d(250) (n=62,500);
  8. ladder   — the escalation ladder (its gemm-precision rung live) on a
                near-singular arrowhead and on hilbert(8), float32 factors;
     orderings — DOFACT gssvx on random_sparse(2000) with ColPerm COLAMD,
                ColPerm MMD_ATA and RowPerm LargeDiag_AWPM;
  9. check    — a small poisson3d factored through both kernels and
                through both plain versions (identical fronts required),
                and small
                NOTRANS / TRANS / CONJ solves against scipy's sparse direct
                solver in float64.

Every DOFACT analysis runs in the native library; its calls are counted
(native.CALLS, reset just before each such phase) and printed on the
phase's line.  The build census (obs/compilestats.py) and the retrace
sentinel are read on the existing lines, windows taken just before and
after what they count: gssvx — its FACT's ``stats.compile`` (no build,
no retrace) and the process's census so far (the kernel and host-library
builds, the first solve's captures); solve — each case's captures at the
first solve (two a new bucket when fused) and at the replay (none);
executors_small — every fused, mega and level call's captures (the
capturing call's census seconds within 10 % of its graph_totals capture
+ instantiate: one record a graph, the same seconds; none and no
retrace at a replay, mega's announced keys
all captured), and one forced recapture (``drop_graphs`` on the plan's
fused executor, then a refactor): exactly one retrace, in
``Stats.retraces`` too; serve — the cold and warm rounds' captures;
mesh_grid_leg — each rank's segment captures at the DOFACT (the
segments reported) and at the replay (none).  Then a JSON line with one record per kernel, the card
line again, and the last line {"ok": true, "device": {...}}.  Any
failure raises and exits non-zero; without a CUDA device it exits
non-zero before any result.  ``python3 chip_smoke.py first_solve
[LABEL]`` times the main path's gssvx and its first solve alone
(``first_solve_only``); ``python3 chip_smoke.py panel`` runs the build,
the main path's analysis and the panel LU kernel's checks and times alone
(``panel_only``).
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

#: H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth, and the
#: float32 / float64 rates outside the tensor cores (the kernels' adds),
#: by component type (a complex add is two adds of its component type)
HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"float32": 67e12, "float64": 34e12}
NX = 48                  # poisson3d grid edge of the main path: n = 110,592
#: the depth-cut paths (PERF.md §4): the persist deadline and resume, cli,
#: the fleet's second bundle, fused and the host offload run at NX_SMALL
#: (48, then 32 before the serve and pgssvx phases needed the time; 25
#: keeps nnz = 105,625 above the 100,000 from which refinement's residual
#: runs through csr_spmv); mega, the host share, level waves, gemm_tiers
#: and the mesh phase's ParSymbFact at NX_TINY (32, then 24 before)
NX_SMALL = 25
NX_TINY = 16
#: kernels_factor holds every panel against the plain loop in float32 (the
#: main path's type) and every PANEL_PLAIN_STRIDE-th panel in the three
#: other types (every panel in all four until the script needed the time;
#: the kernel is timed on every panel in each; PERF.md §4)
PANEL_PLAIN_STRIDE = 4
SEED = 0
#: the trace phase's trace files (removed once read)
TRACE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "chip_smoke_trace")
SERVE_RESOLVE = 8        # cold serve batches re-solved and timed in stages
SERVE_REQUESTS = 64      # requests of each serve round (PERF.md §4)
FIRST_SOLVE_REPS = 6     # first solves (new solver, two captures) timed
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


def census_mark() -> tuple:
    """A window start of the build census (obs/compilestats.py) and the
    retrace sentinel (numeric/stream.py)."""
    from superlu_dist_tpu_torch.numeric.stream import RETRACE_SENTINEL
    from superlu_dist_tpu_torch.obs.compilestats import COMPILE_STATS
    return COMPILE_STATS.marker(), RETRACE_SENTINEL.total


def census_since(mark, site=None) -> dict:
    """The builds since ``mark`` (of ``site`` alone when given): count,
    seconds, fresh seconds, the sentinel's retraces, the top three
    keys."""
    from superlu_dist_tpu_torch.numeric.stream import RETRACE_SENTINEL
    from superlu_dist_tpu_torch.obs.compilestats import COMPILE_STATS
    recs = [r for r in COMPILE_STATS.records[mark[0]:]
            if site is None or r.site == site]
    rows = [r for r in COMPILE_STATS.census(since=mark[0])
            if site is None or r["site"] == site]
    return dict(builds=sum(r.builds for r in recs),
                seconds=sum(r.seconds for r in recs),
                fresh_seconds=sum(r.seconds for r in recs
                                  if not r.persistent_hit),
                retraces=RETRACE_SENTINEL.total - mark[1],
                top=[[r["site"], r["key"], r["n"], r["seconds"]]
                     for r in rows[:3]])


def within_census(phase, census_s, rep) -> float:
    """A capturing call's census seconds against its executor's
    graph_totals capture + instantiate sum: their ratio, or raise when
    it is off by more than 10 %.  A census record's seconds are its
    graph's ``capture_s + instantiate_s``, so this checks that the call
    recorded each of its graphs exactly once (a graph missed or recorded
    twice moves the ratio), not the timing itself."""
    graphs_s = rep["capture_s"] + rep["instantiate_s"]
    ratio = census_s / graphs_s if graphs_s else float("inf")
    if abs(ratio - 1.0) > 0.1:
        raise AssertionError(f"{phase}: census {census_s} s against the "
                             f"graphs' {graphs_s} s")
    return ratio


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
               lib_reps=10, targets=True):
    """front_assemble_ on one group: equality with the plain version and
    kernel / plain / library times and the bound.  ``targets=False``
    takes the bound's counts from the maps (the pairs and A entries the
    kernel adds: at most what it reads) and times no library call, whose
    target list at poisson3d(100)'s largest group would take tens of
    GB beside the pool (library_ms None)."""
    import torch
    out_k = kernels.front_assemble_(avals, pool, m, w, gm)
    out_p = kernels.front_assemble_plain(avals, pool, m, w, gm)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max()) if out_k.numel() else 0.0
    if not torch.equal(out_k, out_p):
        raise AssertionError(f"front_assemble kernel != plain (max |d| {err})")
    del out_k, out_p
    fm = gm.front
    isz = pool.element_size()
    batch = fm.batch
    if targets:
        dst, vals, n_a, n_pool = front_targets(avals, pool, m, w, gm)
        adds = dst.numel()
    else:
        n_a, n_pool = fm.n_a, fm.pairs
        adds = n_a + n_pool
    nbytes = (batch * m * m * isz + (n_pool + n_a) * isz + fm.nbytes
              + gm.ws.numel() * 8)
    b_ms, b_by = bound(nbytes, adds, pool.dtype)

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
        library_ms=cuda_ms(library, lib_reps, warm=1) if targets else None,
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
    front-assembly launch and every panel LU call and no stage
    synchronize; (b) every group of the plan replayed alone — the kernel
    in a CUDA graph (ms) and call by call (call_ms, the wrapper's host
    time included), the plain version and the library call with CUDA
    events — summed with the bounds (float32), and every panel of the
    plan likewise in all four types (``panel_sums``), held bit for bit
    against the plain loop on the way (every panel in float32, every
    PANEL_PLAIN_STRIDE-th in the others).  (The sums of the standalone
    K1 / K2 wrappers over every child set and assembly, and of the front
    assembly in complex64, are timing only and left the script in PR 7,
    for the benchmark; those wrappers and types are still held against
    their plain versions in the kernels phase.)"""
    dev = torch.device("cuda")
    events = {"front_assemble": [], "panel_lu": []}

    def timed(name, fn, *args):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn(*args)
        e1.record()
        events[name].append((e0, e1))
        return out

    kernels.reset_launches()
    t0 = time.perf_counter()
    factor.numeric_factorize(
        plan, bvals, anorm, dtype=torch.float32, device="cuda",
        scatter=lambda *a: timed("front_assemble", kernels.front_assemble_,
                                 *a),
        panel=lambda *a: timed("panel_lu", kernels.panel_lu_, *a))
    torch.cuda.synchronize()
    fact_s = time.perf_counter() - t0
    in_factor = {k: dict(ms=sum(a.elapsed_time(b) for a, b in ev),
                         launches=kernels.LAUNCHES[k])
                 for k, ev in events.items()}
    in_factor["fact_s"] = fact_s

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
    in_factor["front_assemble"]["bound_ms"] = sums["bound_ms"]
    del avals, pool
    psums = {str(dt).split(".")[-1]: panel_sums(plan, torch, kernels, gen,
                                                 dt)
             for dt in (f32, torch.float64, torch.complex64,
                        torch.complex128)}
    in_factor["panel_lu"]["bound_ms"] = psums["float32"]["bound_ms"]
    return in_factor, {"front_assemble": dict(units=len(plan.groups),
                                              **sums),
                       "panel_lu": psums}


def panel_sums(plan, torch, kernels, gen, dtype) -> dict:
    """Every panel of one factorization of ``plan`` replayed alone in
    ``dtype`` on seeded fronts of its group's shape (``time_panel``): the
    kernel / library / bound times summed over every panel, the plain
    loop's over the panels held bit for bit against it (``plain_units``:
    every panel in float32, every PANEL_PLAIN_STRIDE-th in the other
    types)."""
    keys = ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms")
    out = dict.fromkeys(keys, 0.0)
    real = torch.empty((), dtype=dtype).real.dtype
    thresh = torch.tensor(1e-3, dtype=real, device="cuda")
    stride = 1 if dtype == torch.float32 else PANEL_PLAIN_STRIDE
    panels = plan_panels(plan)
    a, at = None, None
    for i, (gi, g, m_ext, pb, j0, pa) in enumerate(panels):
        if at != gi:
            a, at = None, gi
            a = panel_fronts(torch, gen, g.batch, m_ext, 0, g.w, dtype)
        rec = time_panel(torch, kernels, a, j0, pa, pb, thresh, reps=3,
                         lib_reps=2, plain=i % stride == 0)
        for k in keys:
            out[k] += rec[k] or 0.0
    return dict(units=len(panels), plain_units=len(range(0, len(panels),
                                                         stride)), **out)


#: device-kernel name fragments -> the work they do, in match order
KERNEL_KINDS = (("pivot_chunk", "panel_lu launch 1 (pivot rows)"),
                ("replay_chunk", "panel_lu launch 2 (other rows)"),
                ("front_assemble", "front_assemble"),
                ("trsm", "TRSM (cuBLAS)"),
                ("gemm", "GEMM (cuBLAS)"), ("sm90_", "GEMM (cuBLAS)"),
                ("xmma", "GEMM (cuBLAS)"), ("cutlass", "GEMM (cuBLAS)"))


def factor_profile(plan, bvals, anorm, torch, factor) -> dict:
    """One more factorization of the main path (stream, float32, default
    tier) under torch.profiler: device time per kind of kernel
    (``KERNEL_KINDS``, the rest "other"), the device's busy time (the
    union of kernel spans) and its idle share of the wall between the
    first and the last kernel, and the wall with the profiler on.  A
    profiler that records no kernel gives {"error": ...}; the script goes
    on (the measurement is unavailable, the path unchanged)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            factor.numeric_factorize(plan, bvals, anorm, dtype=torch.float32,
                                     device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels_ = [e for e in prof.events()
                    if e.device_type == DeviceType.CUDA]
    except RuntimeError as e:
        return {"error": f"torch.profiler: {e}"}
    if not kernels_:
        return {"error": "torch.profiler recorded no device kernel"}
    kinds, counts, spans = {}, {}, []
    for e in kernels_:
        kind = next((k for frag, k in KERNEL_KINDS if frag in e.name),
                    "other")
        rng = e.time_range
        kinds[kind] = kinds.get(kind, 0.0) + rng.elapsed_us() / 1e3
        counts[kind] = counts.get(kind, 0) + 1
        spans.append((rng.start, rng.end))
    spans.sort()
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    window = max(b for _, b in spans) - spans[0][0]
    # launch 1 runs the pivot steps one after another: its time a step
    steps = sum(r[5] for r in plan_panels(plan))
    launch1 = kinds.get(KERNEL_KINDS[0][1], 0.0)
    return dict(wall_s=wall, kernels=len(kernels_), busy_ms=busy / 1e3,
                window_ms=window / 1e3,
                idle_share=1.0 - busy / window if window else None,
                ms_by_kind=dict(sorted(kinds.items(), key=lambda kv: -kv[1])),
                launches_by_kind=counts, panel_steps=steps,
                launch1_us_per_step=launch1 * 1e3 / steps)


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


def lint_phase():
    """slulint for the port over its default scope, as a user runs it: a
    subprocess of its own (the analysis imports no jax, and this host has
    none), no cache.  Raises on any finding."""
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run(
        [sys.executable, "-m", "superlu_dist_tpu_torch.analysis",
         "--no-cache", "--format", "json"],
        capture_output=True, text=True, cwd=root, timeout=300)
    seconds = time.perf_counter() - t0
    if out.returncode not in (0, 1):
        raise AssertionError(f"slulint exited {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    doc = json.loads(out.stdout)
    say("lint", files=doc["files"], findings=len(doc["findings"]),
        rules=doc["rules"], s=seconds, baselined=doc["baselined"])
    if doc["findings"] or out.returncode:
        raise AssertionError("slulint findings: " + "; ".join(
            f"{f['path']}:{f['line']} {f['rule']} {f['message']}"
            for f in doc["findings"]))


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
             # a float64 sum of n logs, native against Python
             same=lambda g, w:
             abs(g - w) <= 1e-12 * scale)  # slulint: disable=SLU118
        cases[name] = dict(n=n, nnz=a.nnz, **out)
    say("native", library=str(lib), build_s=build_s, cases=cases)


def factorizations(report) -> int:
    """The factorizations a gssvx call ran on its plan: one, plus one per
    ladder rung that refactored the same skeleton (gemm-precision,
    hiprec-factors; not one the card's rule refused).  A refactor-rescale
    rung re-analyses: raise."""
    if any(r.name == "refactor-rescale" for r in report.rungs):
        raise AssertionError(f"the ladder re-analysed: {report.summary()}")
    return 1 + sum(r.name in ("gemm-precision", "hiprec-factors")
                   and "info=" not in r.detail
                   and "DeviceMemoryError" not in r.detail
                   for r in report.rungs)


def expect_launches(phase, kernels, front_assemble, spmv, panels=None):
    """The launch counts of the phase just driven (reset just before it):
    ``front_assemble`` launches of the fused kernel (None: at least one),
    ``panels`` panel_lu launches (None: at least one where the phase
    assembled a front, none otherwise), none of the standalone wrappers,
    and residual SpMV launches when ``spmv`` (refinement on the card: nnz
    >= 100,000), none otherwise; or raise."""
    got = dict(kernels.LAUNCHES)
    want = {"front_assemble": front_assemble, "extend_add": 0, "assemble": 0}
    if front_assemble is None:
        want["front_assemble"] = max(got["front_assemble"], 1)
    if panels is None:
        panels = max(got["panel_lu"], 1) if want["front_assemble"] else 0
    want["panel_lu"] = panels
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
                factor, served):
    """Phase 4d, at full width on the main path's handle: a FACTORED solve,
    a TRANS solve, refactor (no SYMBFACT/COLPERM; equal to a fresh
    factorization of the same values on the same plan, and bit for bit the
    serve phase's ``SolveServer.refactor`` of those values, ``served``),
    SamePattern_SameRowPerm on the changed matrix, condest on the card, and
    the residual-precision rung of the ladder.  One line; every BERR at its
    target."""
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
    equal = _fronts_equal(torch, lu.numeric.fronts, fresh.fronts)
    del fresh
    if not equal:
        raise AssertionError("refactor's factors != a fresh factorization")
    equal_served = _fronts_equal(torch, lu.numeric.fronts, served.fronts)
    if not equal_served:
        raise AssertionError("SolveServer.refactor's factors != "
                             "slt.refactor's")
    b3 = a_new.matvec(rng.standard_normal(a.n_rows))
    # the refactored handle's BERR: a FACTORED solve through its factors
    x, _, st2, sec2 = timed_gssvx(slt, kernels,
                                  slt.Options(fact=slt.Fact.FACTORED), a_new,
                                  b3, lu=lu)
    out["refactor"] = dict(s=sec, fact_s=st.utime["FACT"],
                           analysis_phases_s=skipped,
                           equals_fresh_factorization=equal,
                           equals_server_refactor=equal_served,
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


#: the distributed phase: 4 ranks at poisson3d(NX_SMALL) (the mesh phase
#: carries the 48-wide distributed run), the recovery on 3 ranks at
#: poisson3d(NX_TINY); the comm timeout the failure detector runs with, and
#: the tree domain's slot length (doubles)
PG_RANKS, PG_FT_RANKS, PG_FT_NX = 4, 3, NX_TINY
PG_NX = NX_SMALL
PG_TIMEOUT_S = 2.0
PG_MAX_LEN = 1 << 16


def _pg_workdir():
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke", "pgssvx")


def start_peers(slt):
    """The pgssvx phase's peer ranks, spawned early so that their
    ``import torch`` overlaps the phases before it: ranks 1-3 of the
    main run and its FACTORED call on poisson3d(PG_NX), ranks 1-2 of the
    two recovery runs on poisson3d(PG_FT_NX) (rank 2 killed in the
    second).
    Each builds its rows from a seeded recipe (``GallerySystem``: the
    spawn ships a few bytes, not the matrix) and waits in
    ``attach_tree`` until rank 0 (this process, on the card) forms the
    domain.  Returns the phase's state."""
    from superlu_dist_tpu_torch.testing.ranks import (GallerySystem, RankJob,
                                                      spawn_peers)
    # a dead peer surfaces as RankFailureError within about this timeout
    os.environ["SLU_TPU_COMM_TIMEOUT_S"] = str(PG_TIMEOUT_S)
    main_sys = GallerySystem("poisson3d", (PG_NX,), seed=SEED)
    fact_sys = GallerySystem("poisson3d", (PG_NX,), seed=SEED + 30, nrhs=4)
    ft_sys = GallerySystem("poisson3d", (PG_FT_NX,), seed=SEED + 40)
    tag = f"/slt_smoke_{os.getpid()}"
    wd = _pg_workdir()
    # the peers join when rank 0 forms the domain, minutes from now
    main = RankJob("pgssvx", f"{tag}_main", PG_RANKS, slt.Options(),
                   main_sys.a_rows, main_sys.b_rows, max_len=PG_MAX_LEN,
                   attach_s=1200.0)
    fact = RankJob("pgssvx", f"{tag}_fact", PG_RANKS,
                   slt.Options(fact=slt.Fact.FACTORED), fact_sys.a_rows,
                   fact_sys.b_rows, max_len=PG_MAX_LEN, reuse_lu=True)

    def ft(name):
        return RankJob("pgssvx_ft", f"{tag}_{name}", PG_FT_RANKS,
                       slt.Options(ft="shrink", ckpt_every=8,
                                   ckpt_dir=os.path.join(wd, name)),
                       ft_sys.a_rows, ft_sys.b_rows, max_len=PG_MAX_LEN)
    ref, chaos = ft("ref"), ft("chaos")
    # rank 2 dies right before its 6th public collective: the broadcast
    # of the root's result, while the root factors
    victim = dataclasses.replace(
        chaos, env={"SLU_TPU_CHAOS": "kill_rank=2,kill_op=6"})
    jobs = {1: [main, fact, ref, chaos], 2: [main, fact, ref, victim],
            3: [main, fact]}
    t0 = time.perf_counter()
    procs, results, spawned_at = spawn_peers(jobs)
    return dict(procs=procs, results=results, spawned_at=spawned_at,
                spawn_s=time.perf_counter() - t0, tag=tag, main=main,
                fact=fact, ref=ref, chaos=chaos, nrhs_fact=4,
                n_ft=PG_FT_NX ** 3, main_sys=main_sys)


def _await(peers, ranks, name=None, timeout=600):
    """The records of job ``name`` (or the last records, ``name=None``)
    from ``ranks``, {rank: record}; others that arrive meanwhile wait in
    the phase's stash for their own call."""
    from superlu_dist_tpu_torch.testing.ranks import collect
    stash = peers.setdefault("stash", [])

    def mine(r):
        return r.get("done") if name is None else r.get("name") == name
    got = {r["rank"]: r for r in stash if mine(r)}
    stash[:] = [r for r in stash if not mine(r)]
    while set(got) != set(ranks):
        (r,) = collect(peers["results"], 1, timeout, peers["procs"])
        if mine(r):
            got[r["rank"]] = r
        else:
            stash.append(r)
    return got


def pgssvx_phase(slt, peers, kernels, tols, torch):
    """Phase 4d, the distributed driver: ``pgssvx`` over block rows of
    poisson3d(PG_NX) on 4 ranks, rank 0 this process with device="cuda",
    ranks 1-3 spawned CPU processes (``start_peers``), Options() (DOFACT,
    float32 factors at the default tier, refinement distributed): info 0,
    BERR <= berr_target(float64), every peer's x equal to rank 0's bit
    for bit, x within DEVICE_VS_HOST of gssvx's x on the same system in
    this run (whose residual ran through csr_spmv, this one on each
    rank's host rows),
    front_assemble launches = groups × factorizations and no csr_spmv
    launch, the root's analysis in the native library; then FACTORED
    with rank 0's handle at nrhs 4 (no front_assemble launch, the same X
    on every rank); then ``pgssvx_ft`` with Options(ft="shrink") on
    poisson3d(PG_FT_NX) and 3 ranks, undisturbed and with rank 2 killed
    (SLU_TPU_CHAOS): the survivors finish with one FtEvent and x bit for
    bit the undisturbed run's.  No peer may hold a CUDA context, and no
    child process or shared-memory segment of the phase may be left."""
    import multiprocessing as mp
    from superlu_dist_tpu_torch import native
    from superlu_dist_tpu_torch.testing.ranks import run_job, stop_peers
    procs = peers["procs"]
    target = float(tols.berr_target(np.float64))
    out = {}
    a = peers["main_sys"].matrix()
    x_main, _, _, info = slt.gssvx(slt.Options(), a, peers["main_sys"].rhs(),
                                   device="cuda")
    if info != 0:
        raise AssertionError(f"gssvx at the pgssvx phase's width: {info}")
    try:
        # --- the main run ----------------------------------------------
        kernels.reset_launches()
        native.reset_calls()
        t0 = time.perf_counter()
        rec0 = run_job(peers["main"], 0, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if "error" in rec0:
            raise AssertionError(f"pgssvx rank 0: {rec0['error']}")
        lo = rec0["lu_out"]
        lu, stats, rep = lo["lu"], lo["stats"], lo["solve_report"]
        groups = len(lu.plan.groups)
        hiprec = sum(r.name == "distributed-hiprec" for r in rep.rungs)
        launches = expect_launches("pgssvx", kernels, groups * (1 + hiprec),
                                   False)
        calls = expect_native("pgssvx", native, "amalgamate", "mlnd")
        peer_main = _await(peers, (1, 2, 3), peers["main"].name)
        x = rec0["x"]
        if rec0["info"] != 0 or x.shape != x_main.shape:
            raise AssertionError(f"pgssvx: info {rec0['info']}")
        check_berr("pgssvx", rep.berr, target)
        for r, pr in sorted(peer_main.items()):
            if "error" in pr or not np.array_equal(pr["x"], x):
                raise AssertionError(f"pgssvx rank {r}: "
                                     f"{pr.get('error', 'x != rank 0 x')}")
        err = np.abs(x - x_main)
        if not np.all(err <= tols.DEVICE_VS_HOST_ATOL
                      + tols.DEVICE_VS_HOST_RTOL * np.abs(x_main)):
            raise AssertionError(f"pgssvx x vs the main path's: max "
                                 f"{err.max()}")
        summary = lo["stats_summary"]
        out["main"] = dict(
            ranks=PG_RANKS, info=rec0["info"], wall_s=wall,
            gather_s=lo["timings"]["gather_s"],
            analysis_s=sum(stats.utime[p] for p in ANALYSIS),
            fact_s=stats.utime["FACT"], root_solve_s=stats.utime["SOLVE"],
            refine_s=lo["timings"]["refine_s"],
            refine_steps=rep.refine_steps, berr=rep.berr,
            berr_history=rep.berr_history, rungs=[r.name for r in rep.rungs],
            max_abs_vs_main=float(err.max()), launches=launches,
            native_calls=calls, groups=groups,
            peers_bitwise_root=sorted(peer_main),
            comm_root=stats.comm,
            comm_all={op: dict(calls=d["calls"], bytes=d["bytes"],
                               seconds_max=d["seconds"].max,
                               balance=d["seconds"].balance)
                      for op, d in summary.comm.items()},
            balance={p: summary.balance(p) for p in ("FACT", "SOLVE")},
            spawn_call_s=peers["spawn_s"],
            spawn_to_attach_s={r: pr["attached_at"] - peers["spawned_at"]
                               for r, pr in sorted(peer_main.items())},
            peer_seconds={r: pr["seconds"]
                          for r, pr in sorted(peer_main.items())},
            beat_gap_s={0: rec0["beat_gap_s"],
                        **{r: pr["beat_gap_s"]
                           for r, pr in sorted(peer_main.items())}},
            timeout_s=PG_TIMEOUT_S)

        # --- FACTORED with rank 0's handle at nrhs 4 -------------------
        kernels.reset_launches()
        t0 = time.perf_counter()
        recf = run_job(peers["fact"], 0, "cuda", lu=lu)
        torch.cuda.synchronize()
        fact_wall = time.perf_counter() - t0
        if "error" in recf:
            raise AssertionError(f"pgssvx FACTORED rank 0: {recf['error']}")
        fl = expect_launches("pgssvx FACTORED", kernels, 0, False)
        peer_fact = _await(peers, (1, 2, 3), peers["fact"].name)
        xf, repf = recf["x"], recf["lu_out"]["solve_report"]
        if recf["lu_out"]["lu"] is not lu or xf.shape != (
                a.n_rows, peers["nrhs_fact"]):
            raise AssertionError("pgssvx FACTORED did not reuse the handle")
        check_berr("pgssvx FACTORED", repf.berr, target)
        for r, pr in sorted(peer_fact.items()):
            if "error" in pr or not np.array_equal(pr["x"], xf):
                raise AssertionError(f"pgssvx FACTORED rank {r}: "
                                     f"{pr.get('error', 'X != rank 0 X')}")
        out["factored"] = dict(nrhs=4, wall_s=fact_wall, berr=repf.berr,
                               refine_steps=repf.refine_steps,
                               root_solve_s=recf["lu_out"]["stats"].utime[
                                   "SOLVE"],
                               refine_s=recf["lu_out"]["timings"][
                                   "refine_s"],
                               launches=fl)
        del lu, stats, lo, rec0, recf

        # --- recovery: undisturbed, then rank 2 killed ------------------
        t0 = time.perf_counter()
        ref0 = run_job(peers["ref"], 0, "cuda")
        ref_s = time.perf_counter() - t0
        peer_ref = _await(peers, (1, 2), peers["ref"].name)
        t0 = time.perf_counter()
        ch0 = run_job(peers["chaos"], 0, "cuda")
        chaos_s = time.perf_counter() - t0
        # rank 1 survives; rank 2 is killed and sends nothing more
        peer_ch = _await(peers, (1,), peers["chaos"].name)
        for name, rec in (("undisturbed", ref0), ("shrink", ch0)):
            if "error" in rec or rec["info"] != 0:
                raise AssertionError(f"pgssvx_ft {name} rank 0: "
                                     f"{rec.get('error', rec.get('info'))}")
        events = ch0["lu_out"].get("ft_events", [])
        if len(events) != 1 or events[0].dead != [2]:
            raise AssertionError(f"pgssvx_ft recorded {events}")
        if not np.array_equal(ch0["x"], ref0["x"]):
            raise AssertionError("the shrink recovery's x != the "
                                 "undisturbed run's")
        for r, pr in list(peer_ref.items()) + list(peer_ch.items()):
            if "error" in pr or not np.array_equal(pr["x"], ref0["x"]):
                raise AssertionError(f"pgssvx_ft rank {r}: "
                                     f"{pr.get('error', 'x differs')}")
        ev = events[0]
        out["recovery"] = dict(
            n=peers["n_ft"], ranks=PG_FT_RANKS,
            undisturbed_s=ref_s, shrink_s=chaos_s, dead=ev.dead, op=ev.op,
            failure_to_next_epoch_s=ev.seconds, resumed=ev.resumed,
            berr=ch0["lu_out"]["solve_report"].berr,
            rungs=[r.name for r in ch0["lu_out"]["solve_report"].rungs])
        done = list(_await(peers, (1, 3)).values())
    finally:
        codes = stop_peers(procs, timeout=60)
        shutil.rmtree(_pg_workdir(), ignore_errors=True)
    # --- clean-up checks --------------------------------------------------
    if codes != {1: 0, 2: -9, 3: 0}:
        raise AssertionError(f"peer exit codes {codes}")
    if any(r["cuda_initialized"] for r in done) or len(done) != 2:
        raise AssertionError(f"a peer holds a CUDA context: {done}")
    # the mesh phase's peer, started with these, runs on
    left = [p.name for p in mp.active_children()
            if p.pid not in peers.get("others", ())]
    segs = [f for f in os.listdir("/dev/shm") if peers["tag"][1:] in f]
    if left or segs:
        raise AssertionError(f"left behind: processes {left}, "
                             f"segments {segs}")
    say("pgssvx", n=a.n_rows, peer_exit_codes=codes,
        peers_cuda_initialized=False, children_left=0, segments_left=0,
        **out)

#: the mesh phase: a 1x2 grid, both ranks on the one card over gloo;
#: its process group's timeout covers the peer's wait for rank 0 to
#: reach the phase
MESH_RANKS, MESH_TIMEOUT_S, MESH_SCALE = 2, 900.0, 1.5
#: the mesh phase's 2-D run: the panel axis and the partitioned pool
MESH_2D = dict(executor="stream", pool_partition=True)
#: the grid legs: host offload over the partitioned pool (the
#: JAX config-4 recipe), fused and mega as segment graphs
MESH_OFFLOAD = dict(pool_partition=True, front_bytes_limit=0)
MESH_FUSED = dict(executor="fused", pool_partition=True)
MESH_MEGA = dict(executor="mega")


def start_mesh_peer(slt, only=None):
    """The mesh phase's rank 1, spawned early (its ``import torch`` and
    its CUDA context overlap the phases before it): a process of its own
    on the same card, running thirteen ``pgssvx(grid=)`` jobs of a 1x2 grid
    in order — on the spmd executor DOFACT on poisson3d(NX) (the main
    path's system, the fronts gathered to slot order after it), FACTORED
    at nrhs 1 on its sharded handle, SamePattern_SameRowPerm on the
    values times MESH_SCALE and Options(par_symb_fact=True) on
    poisson3d(NX_TINY); then on the 2-D mesh executor (MESH_2D) the
    same DOFACT, FACTORED and SamePattern_SameRowPerm; then the grid legs:
    MESH_OFFLOAD DOFACT and FACTORED at nrhs 4, MESH_FUSED and MESH_MEGA
    each DOFACT and SamePattern_SameRowPerm; then the trace phase's grid
    leg (a "mesh_trace" job, ``trace_mesh_leg``) and the audit phase's
    (a "mesh_audit" job, ``audit_mesh_leg``) on poisson3d(NX_TINY) — the
    one named by ``only`` ("trace" or "audit") alone with it.  It joins
    the process group at its first job and waits there for rank 0 (this
    process).  Returns the phase's state."""
    from superlu_dist_tpu_torch.testing.ranks import (GallerySystem, RankJob,
                                                      rendezvous, spawn_peers)
    tag = f"/slt_mesh_{os.getpid()}"
    trace_sys = GallerySystem("poisson3d", (NX_TINY,), seed=SEED + 90)
    trace2d = RankJob("mesh_trace", f"{tag}_trace", MESH_RANKS,
                      slt.Options(**MESH_2D), trace_sys.a_rows,
                      trace_sys.b_rows, max_len=PG_MAX_LEN, attach_s=1200.0,
                      port=rendezvous(), device="cuda",
                      timeout_s=MESH_TIMEOUT_S,
                      trace=os.path.join(TRACE_DIR, "mesh_r%r.json"))
    audit2d = dataclasses.replace(trace2d, kind="mesh_audit",
                                  name=f"{tag}_audit", trace="")
    if only is not None:
        job = {"trace": trace2d, "audit": audit2d}[only]
        t0 = time.perf_counter()
        procs, results, spawned_at = spawn_peers({1: [job]})
        return {"procs": procs, "results": results, "spawned_at": spawned_at,
                "spawn_s": time.perf_counter() - t0, "tag": tag,
                f"{only}2d": job, "systems": {f"{only}2d": trace_sys}}
    main_sys = GallerySystem("poisson3d", (NX,), seed=SEED)   # gssvx's b
    fact_sys = GallerySystem("poisson3d", (NX,), seed=SEED + 60)
    fact4_sys = GallerySystem("poisson3d", (NX,), seed=SEED + 60, nrhs=4)
    ref_sys = GallerySystem("poisson3d", (NX,), seed=SEED + 70,
                            scale=MESH_SCALE)
    psf_sys = GallerySystem("poisson3d", (NX_TINY,), seed=SEED + 80)
    main = RankJob("mesh", f"{tag}_main", MESH_RANKS, slt.Options(),
                   main_sys.a_rows, main_sys.b_rows, max_len=PG_MAX_LEN,
                   attach_s=1200.0, port=rendezvous(), device="cuda",
                   gather=True, timeout_s=MESH_TIMEOUT_S)
    fact = dataclasses.replace(
        main, name=f"{tag}_fact", options=slt.Options(
            fact=slt.Fact.FACTORED), a_source=fact_sys.a_rows,
        b_source=fact_sys.b_rows, reuse_lu=True, gather=False)
    ref = dataclasses.replace(
        fact, name=f"{tag}_ref", options=slt.Options(
            fact=slt.Fact.SamePattern_SameRowPerm), a_source=ref_sys.a_rows,
        b_source=ref_sys.b_rows)
    psf = dataclasses.replace(
        fact, name=f"{tag}_psf", options=slt.Options(par_symb_fact=True),
        a_source=psf_sys.a_rows, b_source=psf_sys.b_rows, reuse_lu=False)
    # the 2-D mesh executor on the same processes and process group
    main2 = dataclasses.replace(main, name=f"{tag}_main2d",
                                options=slt.Options(**MESH_2D))
    fact2 = dataclasses.replace(fact, name=f"{tag}_fact2d",
                                options=slt.Options(fact=slt.Fact.FACTORED,
                                                    **MESH_2D))
    ref2 = dataclasses.replace(ref, name=f"{tag}_ref2d", options=slt.Options(
        fact=slt.Fact.SamePattern_SameRowPerm, **MESH_2D))
    # the grid legs: offload (DOFACT, FACTORED at nrhs 4), fused and mega
    # (DOFACT captures, SamePattern_SameRowPerm replays)
    legs = {}
    for leg, kw in (("off", MESH_OFFLOAD), ("fused", MESH_FUSED),
                    ("mega", MESH_MEGA)):
        legs[f"{leg}2d"] = dataclasses.replace(
            main, name=f"{tag}_{leg}2d", options=slt.Options(**kw),
            gather=leg != "off")
        second = dataclasses.replace(
            fact, a_source=fact4_sys.a_rows,
            b_source=fact4_sys.b_rows) if leg == "off" else ref
        legs[f"{leg}2d_{'fact' if leg == 'off' else 'ref'}"] = \
            dataclasses.replace(second, name=f"{tag}_{leg}2d_2",
                                options=slt.Options(fact=second.options.fact,
                                                    **kw))
    t0 = time.perf_counter()
    # the trace and audit legs join the process group booted by the first
    # job
    trace2d = dataclasses.replace(trace2d, port=main.port)
    audit2d = dataclasses.replace(audit2d, port=main.port)
    procs, results, spawned_at = spawn_peers(
        {1: [main, fact, ref, psf, main2, fact2, ref2, *legs.values(),
             trace2d, audit2d]})
    return dict(procs=procs, results=results, spawned_at=spawned_at,
                spawn_s=time.perf_counter() - t0, tag=tag, main=main,
                fact=fact, ref=ref, psf=psf, main2d=main2, fact2d=fact2,
                ref2d=ref2, **legs, trace2d=trace2d, audit2d=audit2d,
                systems=dict(
                    fact=fact_sys, ref=ref_sys, psf=psf_sys,
                    fact2d=fact_sys, ref2d=ref_sys, off2d_fact=fact4_sys,
                    trace2d=trace_sys, audit2d=trace_sys))


def _mesh_rank(rec) -> dict:
    """One rank's numbers of a mesh job: its seconds (analysis and its
    broadcast, FACT, the grid's gathers, SOLVE, REFINE), gather bytes,
    device memory, its share of the factors and its launches."""
    t = rec["lu_out"].get("timings", {})
    sh = rec.get("shard", {})
    two_d = {k: t[k] for k in ("pool_bytes", "exchange_bytes", "exchange_s",
                               "exchanges", "bcasts", "bcast_bytes",
                               "bcast_s", "offload", "offload_wait_s",
                               "host_bytes", "segments", "capture_s",
                               "graph_device_bytes", "closed_keys",
                               "warm_up_launches")
             if k in t}
    return dict(seconds=rec["seconds"], analysis_s=t.get("analysis_s"),
                **two_d, own_cols_only=sh.get("own_cols_only"),
                backend=rec.get("backend"),
                fact_s=t.get("fact_s"), gather_bytes=t.get("gather_bytes"),
                gather_s=t.get("gather_s"), solve_s=t.get("solve_s"),
                refine_s=t.get("refine_s"), base_bytes=t.get("base_bytes"),
                peak_bytes=t.get("peak_bytes"),
                route=rec["lu_out"]["solve_report"].residual_route,
                front_bytes=sh.get("front_bytes"),
                pivot_bytes=sh.get("pivot_bytes"),
                owned_slots=sh.get("owned_slots"),
                owned_groups=sh.get("owned_groups"),
                local_flops=sh.get("local_flops"),
                own_slots_only=sh.get("own_slots_only"),
                front_assemble=rec.get("launches"),
                panel_lu=rec.get("panel_launches"),
                csr_spmv=rec.get("spmv_launches"),
                census=rec.get("census"))


def _mesh_check(name, rec0, peer, target, tols, x_ref=None):
    """The checks every mesh job shares: no error on either rank, info 0,
    the same x on both ranks bit for bit, BERR at the target, each rank
    holding only its own slots (and on the 2-D executor only its own
    columns), front_assemble launches = the groups where the rank
    assembles (times the factorizations; plus, at a graph executor's
    capture, its warm-up's), the residuals
    on the card with two csr_spmv launches a refinement step (at least,
    after the hiprec rung), and x within DEVICE_VS_HOST of ``x_ref``."""
    for r, rec in ((0, rec0), (1, peer)):
        if "error" in rec or rec["info"] != 0:
            raise AssertionError(f"mesh {name} rank {r}: "
                                 f"{rec.get('error', rec.get('info'))}")
        if not (rec["shard"]["own_slots_only"]
                and rec["shard"]["own_cols_only"]):
            raise AssertionError(f"mesh {name}: rank {r} holds slots or "
                                 "columns not its own")
    if not np.array_equal(rec0["x"], peer["x"]):
        raise AssertionError(f"mesh {name}: rank 1's x != rank 0's")
    rep = rec0["lu_out"]["solve_report"]
    check_berr(f"mesh {name}", rep.berr, target)
    if rep.residual_route != "device":
        raise AssertionError(f"mesh {name}: residuals on the "
                             f"{rep.residual_route}")
    hiprec = sum(r.name == "distributed-hiprec" for r in rep.rungs)
    spmv = 2 * rep.refine_steps
    for r, rec in ((0, rec0), (1, peer)):
        # a graph executor's capturing call also launches in its warm-up
        warm = rec["lu_out"].get("timings", {}).get("warm_up_launches", 0)
        want = (rec["shard"]["owned_groups"] * (1 + hiprec) + warm
                if not name.endswith("factored") else 0)
        if rec["launches"] != want:
            raise AssertionError(f"mesh {name} rank {r}: {rec['launches']} "
                                 f"front_assemble launches, expected {want}")
        # a rank that assembles factors its panels (all of a group's on
        # the spmd tier, its process column's on the 2-D tier)
        if bool(rec["panel_launches"]) != bool(want):
            raise AssertionError(f"mesh {name} rank {r}: "
                                 f"{rec['panel_launches']} panel_lu launches "
                                 f"beside {want} front_assemble")
        got = rec["spmv_launches"]
        if got < spmv if hiprec else got != spmv:
            raise AssertionError(f"mesh {name} rank {r}: {got} csr_spmv "
                                 f"launches, expected {spmv} for "
                                 f"{rep.refine_steps} refinement steps")
    if x_ref is not None:
        err = np.abs(rec0["x"] - x_ref)
        if not np.all(err <= tols.DEVICE_VS_HOST_ATOL
                      + tols.DEVICE_VS_HOST_RTOL * np.abs(x_ref)):
            raise AssertionError(f"mesh {name}: x vs the single-card "
                                 f"gssvx's: max {err.max()}")
        return float(err.max())
    return None


def _drift_card(torch, f1, f2) -> dict:
    """f1 against f2 on the card: bit for bit, and max |f1 - f2| / max
    |f2| (in float64)."""
    num = den = 0.0
    equal = True
    for (l1, u1), (l2, u2) in zip(f1, f2):
        for x, y in ((l1, l2), (u1, u2)):
            equal &= bool(torch.equal(x, y))
            if x.numel():
                num = max(num, float((x.double() - y.double()).abs().max()))
                den = max(den, float(y.abs().max()))
    return dict(equal_to_stream=equal and len(f1) == len(f2),
                max_rel_diff_vs_stream=num / max(den, 1e-300))


def mesh_phase(slt, a_main, lu_main, x_main, tiny_main, peer, kernels, tols,
               torch):
    """Phase 4e, the mesh tier: ``pgssvx(grid=gridinit(1, 2))`` on block
    rows of poisson3d(NX) in 2 rows blocks, rank 0 this process and rank
    1 a spawned process (``start_mesh_peer``), both on the card over gloo,
    Options() (float32 factors at the default TF32 tier).  Checks: x
    within DEVICE_VS_HOST of the main path's gssvx x, BERR <=
    berr_target(float64), the tiny-pivot count gssvx's, each rank
    holding only its own slots (front bytes per rank printed), the
    fronts gathered to slot order bit for bit the main path's stream
    fronts or within TF32_DRIFT, front_assemble launches per rank = the
    groups where it owns a slot, two csr_spmv launches per rank a
    refinement step, and on each rank both kernels bit for bit their
    plain versions at its local shapes.  Then FACTORED at nrhs 1 on
    the sharded handles (no launch), SamePattern_SameRowPerm on the
    values times MESH_SCALE (both against gssvx FACTORED on the main
    path's handle) and par_symb_fact=True at NX_TINY (against gssvx on
    its system).  Prints per rank: the analysis broadcast, FACT, gather
    bytes and seconds, SOLVE, REFINE and peak device memory; and the
    backend.  Then the 2-D run
    (``_mesh2d_legs``), with FACTORED at nrhs 1 and the SamePattern
    refactor on its handles."""
    from superlu_dist_tpu_torch.parallel import mhboot
    from superlu_dist_tpu_torch.testing.ranks import run_job, stop_peers
    target = float(tols.berr_target(np.float64))
    procs = peer["procs"]
    out = {}
    try:
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec0 = run_job(peer["main"], 0, "cuda")
        wall = time.perf_counter() - t0
        if "error" in rec0:
            raise AssertionError(f"mesh rank 0: {rec0['error']}")
        p1 = _await(peer, (1,), peer["main"].name, timeout=900)[1]
        err = _mesh_check("main", rec0, p1, target, tols, x_main)
        lu = rec0["lu_out"]["lu"]
        rep = rec0["lu_out"]["solve_report"]
        if lu.numeric.tiny_pivots != tiny_main:
            raise AssertionError(f"mesh tiny pivots {lu.numeric.tiny_pivots}"
                                 f" != gssvx's {tiny_main}")
        drift = _drift_card(torch, rec0.pop("fronts"),
                            lu_main.numeric.fronts)
        if not (drift["equal_to_stream"]
                or drift["max_rel_diff_vs_stream"] <= tols.TF32_DRIFT):
            raise AssertionError(f"mesh fronts vs the stream's: {drift}")
        drift["gate"] = float(tols.TF32_DRIFT)
        checks = {r: rec["kernel_vs_plain"] + [rec["spmv_vs_plain"]]
                  for r, rec in ((0, rec0), (1, p1))}
        if not all(c["equal"] for cs in checks.values() for c in cs):
            raise AssertionError(f"mesh: a rank's kernel != plain: {checks}")
        out["main"] = dict(
            n=lu.n, groups=len(lu.plan.groups), wall_s=wall,
            backend={0: rec0["backend"], 1: p1["backend"]},
            berr=rep.berr, berr_history=rep.berr_history,
            refine_steps=rep.refine_steps,
            rungs=[r.name for r in rep.rungs],
            tiny_pivots=lu.numeric.tiny_pivots,
            max_abs_vs_main=err, fronts=drift,
            kernel_vs_plain=checks,
            ranks={0: _mesh_rank(rec0), 1: _mesh_rank(p1)},
            comm={0: rec0["comm"], 1: p1["comm"]},
            peer_spawn_to_attach_s=p1["attached_at"] - peer["spawned_at"],
            executor=lu.numeric.executor)
        del rec0

        # --- FACTORED at nrhs 1, SamePattern_SameRowPerm, ParSymbFact ---
        for name in ("fact", "ref", "psf"):
            sysm = peer["systems"][name]
            kernels.reset_launches()
            t0 = time.perf_counter()
            rec = run_job(peer[name], 0, "cuda",
                          lu=lu if name != "psf" else None)
            sec = time.perf_counter() - t0
            if name == "ref":
                del lu
            if "error" in rec:
                raise AssertionError(f"mesh {name} rank 0: {rec['error']}")
            pr = _await(peer, (1,), peer[name].name, timeout=600)[1]
            if name == "psf":
                x_ref, _, _, _ = slt.gssvx(slt.Options(), sysm.matrix(),
                                           sysm.rhs(), device="cuda")
            else:
                # on the main path's handle: A·x = B, and (s·A)·x = B as
                # A·x = B / s
                scale = MESH_SCALE if name == "ref" else 1.0
                x_ref, _, _, _ = slt.gssvx(
                    slt.Options(fact=slt.Fact.FACTORED), a_main,
                    sysm.rhs() / scale, lu=lu_main)
            label = "factored" if name == "fact" else name
            e = _mesh_check(label, rec, pr, target, tols, x_ref)
            rp = rec["lu_out"]["solve_report"]
            out[label] = dict(wall_s=sec, berr=rp.berr,
                              refine_steps=rp.refine_steps,
                              max_abs_vs_gssvx=e,
                              ranks={0: _mesh_rank(rec), 1: _mesh_rank(pr)})
            if name == "psf":
                out[label]["n"] = sysm.matrix().n_rows
            del rec
        out["mesh2d"] = _mesh2d_legs(slt, a_main, lu_main, x_main,
                                     tiny_main, peer, kernels, tols, torch,
                                     target)
        out["trace"] = trace_mesh_leg(slt, peer, kernels, tols, torch)
        out["audit"] = audit_mesh_leg(peer)
        done = _await(peer, (1,))[1]
    finally:
        codes = stop_peers(procs, timeout=60)
        mhboot.shutdown()
    if codes != {1: 0}:
        raise AssertionError(f"mesh peer exit code {codes}")
    import multiprocessing as mp
    left = [p.name for p in mp.active_children()]
    segs = [f for f in os.listdir("/dev/shm") if peer["tag"][1:] in f]
    if left or segs:
        raise AssertionError(f"mesh left behind: processes {left}, "
                             f"segments {segs}")
    say("mesh", ranks=MESH_RANKS, peer_cuda=done["cuda_initialized"],
        children_left=0, segments_left=0, **out)
    return out


def _mesh2d_legs(slt, a_main, lu_main, x_main, tiny_main, peer, kernels,
                 tols, torch, target):
    """The mesh phase's 2-D run (MESH_2D: the panel axis and the
    partitioned pool): DOFACT on poisson3d(NX) with the checks of the
    1-D run — x within DEVICE_VS_HOST of gssvx's, BERR, the tiny count,
    the fronts gathered to slot order bit for bit the stream's or within
    TF32_DRIFT, launches per rank, each rank's kernel bit for bit its
    plain version on its column share — plus each rank holding only its
    own columns, the executor the 2-D one, each rank's pool against the
    plan's; then FACTORED at nrhs 1 and SamePattern_SameRowPerm on the 2-D
    handles against gssvx FACTORED on the main path's handle."""
    from superlu_dist_tpu_torch.testing.ranks import run_job
    out = {}
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec0 = run_job(peer["main2d"], 0, "cuda")
    wall = time.perf_counter() - t0
    if "error" in rec0:
        raise AssertionError(f"mesh 2d rank 0: {rec0['error']}")
    p1 = _await(peer, (1,), peer["main2d"].name, timeout=900)[1]
    err = _mesh_check("2d", rec0, p1, target, tols, x_main)
    lu = rec0["lu_out"]["lu"]
    rep = rec0["lu_out"]["solve_report"]
    ex = lu.numeric.executor
    if ex["executor"] != "mesh-stream" or not ex["pool_partition"] \
            or (ex["nprow"], ex["npcol"]) != (1, MESH_RANKS):
        raise AssertionError(f"mesh 2d ran {ex}")
    if lu.numeric.tiny_pivots != tiny_main:
        raise AssertionError(f"mesh 2d tiny pivots {lu.numeric.tiny_pivots}"
                             f" != gssvx's {tiny_main}")
    fronts2d = rec0.pop("fronts")
    drift = _drift_card(torch, fronts2d, lu_main.numeric.fronts)
    if not (drift["equal_to_stream"]
            or drift["max_rel_diff_vs_stream"] <= tols.TF32_DRIFT):
        raise AssertionError(f"mesh 2d fronts vs the stream's: {drift}")
    drift["gate"] = float(tols.TF32_DRIFT)
    checks = {r: rec["kernel_vs_plain"] + [rec["spmv_vs_plain"]]
              for r, rec in ((0, rec0), (1, p1))}
    if not all(c["equal"] for cs in checks.values() for c in cs):
        raise AssertionError(f"mesh 2d: a rank's kernel != plain: {checks}")
    # device memory above what each rank held before its FACT
    peaks2d = {r: _mesh_rank(rec)["peak_bytes"] - _mesh_rank(rec)["base_bytes"]
               for r, rec in ((0, rec0), (1, p1))}
    item = torch.empty((), dtype=lu.numeric.dtype).element_size()
    pools = {r: rec["lu_out"]["timings"]["pool_bytes"]
             for r, rec in ((0, rec0), (1, p1))}
    # each rank's pool holds only the Schur elements it extend-adds:
    # together less than the one pool the stream and spmd keep per rank
    if sum(pools.values()) >= lu.plan.pool_size * item:
        raise AssertionError(f"mesh 2d pools {pools} not below the plan's "
                             f"{lu.plan.pool_size * item} bytes")
    out["main"] = dict(
        n=lu.n, wall_s=wall, backend={0: rec0["backend"], 1: p1["backend"]},
        berr=rep.berr, refine_steps=rep.refine_steps,
        rungs=[r.name for r in rep.rungs],
        tiny_pivots=lu.numeric.tiny_pivots, max_abs_vs_main=err,
        fronts=drift, kernel_vs_plain=checks,
        pool_bytes=pools, pool_bytes_sum=sum(pools.values()),
        plan_pool_bytes=lu.plan.pool_size * item,
        ranks={0: _mesh_rank(rec0), 1: _mesh_rank(p1)},
        comm={0: rec0["comm"], 1: p1["comm"]}, executor=ex)
    del rec0
    for name in ("fact2d", "ref2d"):
        sysm = peer["systems"][name]
        kernels.reset_launches()
        t0 = time.perf_counter()
        rec = run_job(peer[name], 0, "cuda", lu=lu)
        sec = time.perf_counter() - t0
        if name == "ref2d":
            del lu
        if "error" in rec:
            raise AssertionError(f"mesh {name} rank 0: {rec['error']}")
        pr = _await(peer, (1,), peer[name].name, timeout=600)[1]
        scale = MESH_SCALE if name == "ref2d" else 1.0
        x_ref, _, _, _ = slt.gssvx(slt.Options(fact=slt.Fact.FACTORED),
                                   a_main, sysm.rhs() / scale, lu=lu_main)
        label = "2d factored" if name == "fact2d" else "2d ref"
        e = _mesh_check(label, rec, pr, target, tols, x_ref)
        rp = rec["lu_out"]["solve_report"]
        out[name] = dict(wall_s=sec, berr=rp.berr,
                         refine_steps=rp.refine_steps, max_abs_vs_gssvx=e,
                         ranks={0: _mesh_rank(rec), 1: _mesh_rank(pr)})
        del rec
    out["legs"] = _grid_legs(slt, a_main, lu_main, x_main, tiny_main, peer,
                             kernels, tols, torch, target, fronts2d, peaks2d)
    return out


def _leg_run(peer, name, lu=None):
    """One grid leg's job on rank 0 (this process) and its record from
    rank 1, with rank 0's wall seconds."""
    from superlu_dist_tpu_torch.testing.ranks import run_job
    t0 = time.perf_counter()
    rec = run_job(peer[name], 0, "cuda", lu=lu)
    sec = time.perf_counter() - t0
    if "error" in rec:
        raise AssertionError(f"mesh {name} rank 0: {rec['error']}")
    return rec, _await(peer, (1,), peer[name].name, timeout=900)[1], sec


def _grid_legs(slt, a_main, lu_main, x_main, tiny_main, peer, kernels, tols,
               torch, target, fronts2d, peaks2d):
    """The grid legs after the 2-D run, on the same two processes, at
    poisson3d(NX): (1) MESH_OFFLOAD — DOFACT with both ranks' factors
    host-resident, each rank's device peak above what it held before its
    FACT below the 2-D run's, x within
    DEVICE_VS_HOST of gssvx's and BERR at the target, the solves in host
    memory; then FACTORED at nrhs 4 on the offloaded handles; (2)
    MESH_FUSED and (3) MESH_MEGA — DOFACT (the segment graphs captured)
    with the fronts gathered to slot order within TF32_DRIFT of (or equal
    to) the 2-D stream's of this run, the kernel bit for bit its plain
    version on each rank's column share, then SamePattern_SameRowPerm on
    the values times MESH_SCALE (the graphs replayed) against gssvx
    FACTORED on the main path's handle.  Every job holds the mesh checks
    (``_mesh_check``: launches per rank = the groups where it assembles,
    inside the graphs on the graph legs).  Prints per rank the offload's
    host bytes and wait, the graphs' segments, capture seconds, device
    bytes, the replay's FACT seconds and the launches."""
    out, launches = {}, {}
    # (1) host offload over the partitioned pool
    kernels.reset_launches()
    rec0, p1, wall = _leg_run(peer, "off2d")
    err = _mesh_check("2d offload", rec0, p1, target, tols, x_main)
    lu = rec0["lu_out"]["lu"]
    rep = rec0["lu_out"]["solve_report"]
    ranks = {0: _mesh_rank(rec0), 1: _mesh_rank(p1)}
    peaks = {r: ranks[r]["peak_bytes"] - ranks[r]["base_bytes"]
             for r in (0, 1)}
    out["offload"] = dict(wall_s=wall, berr=rep.berr,
                          refine_steps=rep.refine_steps,
                          solve_route=rep.solve_route, max_abs_vs_main=err,
                          peak_above_base=peaks, peak_above_base_2d=peaks2d,
                          ranks=ranks, executor=lu.numeric.executor)
    say("mesh_grid_leg", leg="offload", **out["offload"])
    for r, rec in ((0, rec0), (1, p1)):
        if not rec["shard"]["on_host"] or ranks[r]["offload"] != "host" \
                or not ranks[r]["host_bytes"]:
            raise AssertionError(f"mesh 2d offload rank {r}: factors not "
                                 f"host-resident ({ranks[r]})")
        if peaks[r] >= peaks2d[r]:
            raise AssertionError(f"mesh 2d offload rank {r}: device peak "
                                 f"above base {peaks[r]} not below the 2-D "
                                 f"run's {peaks2d[r]}")
    if rep.solve_route != "host" or lu.numeric.tiny_pivots != tiny_main:
        raise AssertionError(f"mesh 2d offload: solve on {rep.solve_route}, "
                             f"tiny {lu.numeric.tiny_pivots} vs {tiny_main}")
    del rec0
    kernels.reset_launches()
    rec, pr, wall = _leg_run(peer, "off2d_fact", lu=lu)
    del lu
    sysm = peer["systems"]["off2d_fact"]
    x_ref, _, _, _ = slt.gssvx(slt.Options(fact=slt.Fact.FACTORED), a_main,
                               sysm.rhs(), lu=lu_main)
    e = _mesh_check("2d offload factored", rec, pr, target, tols, x_ref)
    rp = rec["lu_out"]["solve_report"]
    if rp.solve_route != "host":
        raise AssertionError(f"mesh 2d offload factored: solve on "
                             f"{rp.solve_route}")
    out["offload_factored"] = dict(wall_s=wall, berr=rp.berr,
                                   refine_steps=rp.refine_steps,
                                   solve_route=rp.solve_route,
                                   max_abs_vs_gssvx=e,
                                   ranks={0: _mesh_rank(rec),
                                          1: _mesh_rank(pr)})
    say("mesh_grid_leg", leg="offload_factored", **out["offload_factored"])
    del rec
    # (2), (3): the segment graphs; both refactors solve (s·A)·x = B
    sysm = peer["systems"]["ref2d"]
    x_ref_ref, _, _, _ = slt.gssvx(slt.Options(fact=slt.Fact.FACTORED),
                                   a_main, sysm.rhs() / MESH_SCALE,
                                   lu=lu_main)
    for leg, want in (("fused", "mesh-fused"), ("mega", "mesh-mega")):
        kernels.reset_launches()
        rec0, p1, wall = _leg_run(peer, f"{leg}2d")
        err = _mesh_check(f"2d {leg}", rec0, p1, target, tols, x_main)
        lu = rec0["lu_out"]["lu"]
        rep = rec0["lu_out"]["solve_report"]
        ex = lu.numeric.executor
        if ex["executor"] != want or not ex.get("segments"):
            raise AssertionError(f"mesh 2d {leg} ran {ex}")
        if lu.numeric.tiny_pivots != tiny_main:
            raise AssertionError(f"mesh 2d {leg} tiny pivots "
                                 f"{lu.numeric.tiny_pivots} != {tiny_main}")
        drift = _drift_card(torch, rec0.pop("fronts"), fronts2d)
        if not (drift["equal_to_stream"]
                or drift["max_rel_diff_vs_stream"] <= tols.TF32_DRIFT):
            raise AssertionError(f"mesh 2d {leg} fronts vs the 2-D "
                                 f"stream's: {drift}")
        drift = {("equal_to_2d" if k.startswith("equal") else
                  "max_rel_diff_vs_2d"): v for k, v in drift.items()}
        drift["gate"] = float(tols.TF32_DRIFT)
        checks = {r: rec["kernel_vs_plain"]
                  for r, rec in ((0, rec0), (1, p1))}
        if not all(c["equal"] for cs in checks.values() for c in cs):
            raise AssertionError(f"mesh 2d {leg}: a rank's kernel != "
                                 f"plain: {checks}")
        first = {0: _mesh_rank(rec0), 1: _mesh_rank(p1)}
        del rec0
        kernels.reset_launches()
        rec, pr, wall2 = _leg_run(peer, f"{leg}2d_ref", lu=lu)
        del lu
        e = _mesh_check(f"2d {leg} ref", rec, pr, target, tols, x_ref_ref)
        second = {0: _mesh_rank(rec), 1: _mesh_rank(pr)}
        for r in (0, 1):
            # every segment captured in the census on each rank at the
            # DOFACT, none at the replay; no retrace; the spmd solver runs
            # its sweeps eagerly (their collectives), so no solve capture
            c1, c2 = first[r]["census"], second[r]["census"]
            if (c1["segments"], c2["segments"], c1["retraces"],
                    c2["retraces"], c1["solve"], c2["solve"]) != (
                    first[r].get("segments"), 0, 0, 0, 0, 0):
                raise AssertionError(f"mesh 2d {leg} rank {r}: census "
                                     f"{c1} then {c2}")
        ex2 = rec["lu_out"]["lu"].numeric.executor
        if ex2.get("replays", 0) < 2 * ex2.get("segments", 1) \
                or ex2.get("capture_s") != ex.get("capture_s"):
            raise AssertionError(f"mesh 2d {leg} ref did not replay the "
                                 f"DOFACT's graphs: {ex2}")
        out[leg] = dict(
            wall_s=wall, berr=rep.berr, refine_steps=rep.refine_steps,
            max_abs_vs_main=err, fronts=drift, kernel_vs_plain=checks,
            ranks={r: dict(segments=first[r].get("segments"),
                           census_capture=first[r]["census"],
                           census_replay=second[r]["census"],
                           closed_keys=first[r].get("closed_keys"),
                           capture_s=first[r].get("capture_s"),
                           graph_device_bytes=first[r].get(
                               "graph_device_bytes"),
                           capture_fact_s=first[r]["fact_s"],
                           replay_fact_s=second[r]["fact_s"],
                           launches_capture=first[r]["front_assemble"],
                           warm_up_launches=first[r].get(
                               "warm_up_launches"),
                           launches_replay=second[r]["front_assemble"],
                           peak_bytes=first[r]["peak_bytes"])
                   for r in (0, 1)},
            ref=dict(wall_s=wall2, berr=rec["lu_out"]["solve_report"].berr,
                     max_abs_vs_gssvx=e), executor=ex)
        say("mesh_grid_leg", leg=leg, **out[leg])
        launches[leg] = {r: [first[r]["front_assemble"],
                             second[r]["front_assemble"]] for r in (0, 1)}
        del rec
    out["graph_launches"] = launches
    return out


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
    """Phase 7: gssvx from scratch on helmholtz_2d(250) (n = 62,500): the
    complex analysis, MC64 on complex values included, complex64 factors
    (at 333, n = 110,889, until the grid legs needed the time; PERF.md
    §4)."""
    from superlu_dist_tpu_torch import native
    from superlu_dist_tpu_torch.models.gallery import helmholtz_2d
    a = helmholtz_2d(250)
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
            # the yardstick library call of the kernels line (library_ms)
            lib = torch.sparse.mm(csr, x)  # slulint: disable=SLU116
            record = dict(
                name="csr_spmv", route="cuda", source=SPMV_SOURCE,
                replaces=SPMV_REPLACES, max_abs_err=err,
                ms=graph_ms(lambda: dist.csr_spmv(ip, ix, v, x), n=20),
                call_ms=cuda_ms(lambda: dist.csr_spmv(ip, ix, v, x), 20),
                plain_ms=cuda_ms(lambda: dist.csr_spmv_plain(ip, ix, v, x,
                                                             max_row), 5),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=cuda_ms(
                    lambda: torch.sparse.mm(  # slulint: disable=SLU116
                        csr, x), 20),
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
        # the check reads its answer on the host, as it must
        if not (torch.equal(  # slulint: disable=SLU113
                y, dist.csr_spmv_plain(small_ip, small_ix, v, x))
                and not y[0].any() and not y[4].any()):
            raise AssertionError(f"csr_spmv {dt} on the small matrix")
    say("kernels", **record)
    return record


PANEL_SOURCE = "superlu_dist_tpu_torch/csrc/panel_lu.cu"
PANEL_REPLACES = ("superlu_dist_tpu/ops/dense.py:299 (the column step of "
                  "_blocked_partial_factor :253, an XLA fori_loop; no "
                  "Pallas kernel)")


def plan_panels(plan) -> list:
    """Every panel of one factorization of ``plan``, in order: (group
    index, group, m_ext, pb, j0, pa) — one panel_lu launch each."""
    from superlu_dist_tpu_torch.ops.dense import panel_width
    out = []
    for gi, g in enumerate(plan.groups):
        pb, nsteps = panel_width(g.w)
        m_ext = max(g.m, nsteps * pb)
        out += [(gi, g, m_ext, pb, p * pb, min(pb, g.w - p * pb))
                for p in range(nsteps)]
    return out


def panel_bound(batch, m_ext, pb, j0, pa, dtype):
    """(ms, "bytes" | "operations") of one panel's column loop: the panel
    read and written once and the snapshot (pa rows of pb + 2 values)
    written and read once; Σ_jj 2·(rows below j)·(pb − jj − 1) flops a
    front (a complex multiply-subtract is 8 real flops: × 4)."""
    import torch
    isz = torch.empty((), dtype=dtype).element_size()
    nbytes = batch * (2 * m_ext * pb + 2 * pa * (pb + 2)) * isz
    jj = np.arange(pa)
    flops = batch * float(np.sum(2.0 * (m_ext - (j0 + jj) - 1)
                                 * (pb - jj - 1)))
    if dtype.is_complex:
        flops *= 4
    comp = str(torch.empty((), dtype=dtype).real.dtype).split(".")[-1]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FLOPS_PER_S[comp] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def same_bits(torch, x, y) -> bool:
    """Equal bit for bit (signed zeros and infinities), NaNs as NaNs."""
    xs, ys = (torch.view_as_real(t) if t.is_complex() else t
              for t in (x, y))
    nx, ny = torch.isnan(xs), torch.isnan(ys)
    if xs.shape != ys.shape or not torch.equal(nx, ny):
        return False
    ib = {torch.float32: torch.int32, torch.float64: torch.int64}[xs.dtype]
    return torch.equal(torch.where(nx, 0, xs).contiguous().view(ib),
                       torch.where(ny, 0, ys).contiguous().view(ib))


def panel_fronts(torch, gen, batch, m_ext, j0, pa, dtype, ncols=None):
    """A seeded (batch, m_ext, ncols or m_ext) front batch on the card with
    dominant pivots on the panel's pa pivot rows: a panel of it is what
    the main path hands the kernel (row stride m_ext)."""
    a = torch.randn((batch, m_ext, ncols or m_ext), generator=gen,
                    device="cuda", dtype=dtype)
    r = torch.arange(j0, j0 + pa, device="cuda")
    a[:, r, r] += 2.0 * float(np.sqrt(m_ext))
    return a


def time_panel(torch, kernels, a, j0, pa, pb, thresh, reps=10,
               lib_reps=10, plain=True):
    """panel_lu_ on the panel a[:, :, j0:j0+pb] of the front batch ``a``:
    bit for bit the plain loop on a copy (tiny flags too), then the
    kernel's time in a CUDA graph (ms; in place, again and again) and call
    by call (call_ms), the plain loop's (the comparison's call, CUDA
    events), the library yardstick's and the bound.  ``plain=False``
    leaves the plain loop out (max_abs_err and plain_ms None)."""
    batch, m_ext = a.shape[0], a.shape[1]
    dev = a.device

    def flags():
        return torch.zeros((batch, j0 + pa), dtype=torch.int32, device=dev)
    k, fk = a.clone(), flags()
    kernels.panel_lu_(k[:, :, j0:j0 + pb], j0, pa, thresh, fk)
    err = plain_ms = None
    if plain:
        p, fp = a.clone(), flags()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        kernels.panel_lu_plain(p[:, :, j0:j0 + pb], j0, pa, thresh, fp)
        e1.record()
        torch.cuda.synchronize()
        plain_ms = e0.elapsed_time(e1)
        fin = torch.isfinite(p)
        err = float((k - p)[fin].abs().max()) if bool(fin.any()) else 0.0
        if not (same_bits(torch, k, p) and torch.equal(fk, fp)):
            raise AssertionError(
                f"panel_lu kernel != plain at batch {batch}, m_ext {m_ext}, "
                f"pb {pb}, j0 {j0}, pa {pa}, {a.dtype} (max |d| {err})")
        del p
    b_ms, b_by = panel_bound(batch, m_ext, pb, j0, pa, a.dtype)
    work = flags()

    def call():
        kernels.panel_lu_(k[:, :, j0:j0 + pb], j0, pa, thresh, work)
    # the yardstick: LU of the pa x pa pivot blocks without pivoting (and
    # without GESP's tiny-pivot replacement), then L21 = A21 U11^-1
    blk = a[:, j0:j0 + pa, j0:j0 + pa].clone()
    low = a[:, j0 + pa:, j0:j0 + pa].clone()

    def library():
        lu, _, _ = torch.linalg.lu_factor_ex(blk, pivot=False)
        torch.linalg.solve_triangular(lu, low, upper=True, left=False)
    return dict(
        max_abs_err=err, tiny=int(fk.sum()), ms=graph_ms(call, n=reps),
        call_ms=cuda_ms(call, reps), plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(library, lib_reps, warm=1),
        shape=dict(batch=batch, m_ext=m_ext, pb=pb, j0=j0, pa=pa))


def panel_phase(plan, torch, kernels, gen):
    """The panel LU kernel against its plain loop on the card at the main
    path's largest group (most front elements), its first (widest)
    panel, in float32, float64, complex64 and complex128 (timed as
    ``time_panel``), and on a sentinel panel in every type — tiny pivots
    replaced, one a zero row, a zero pivot without replacement (inf and
    NaN), zeros of both signs: bit for bit, NaNs as NaNs.  Returns the
    float32 record of the final JSON line."""
    big = max(plan_panels(plan), key=lambda r: r[1].batch * r[2] * r[2])
    _, g, m_ext, pb, j0, pa = big
    record = None
    for dt in (torch.float32, torch.float64, torch.complex64,
               torch.complex128):
        real = torch.empty((), dtype=dt).real.dtype
        thresh = torch.tensor(1e-3, dtype=real, device="cuda")
        a = panel_fronts(torch, gen, g.batch, m_ext, j0, pa, dt,
                         ncols=j0 + pb)
        rec = time_panel(torch, kernels, a, j0, pa, pb, thresh)
        del a
        name = str(dt).split(".")[-1]
        if dt == torch.float32:
            record = dict(name="panel_lu", route="cuda", source=PANEL_SOURCE,
                          replaces=PANEL_REPLACES, **rec)
        else:
            say("kernels_extra", case=f"panel_lu largest {name}", **rec)
        # sentinels: a zero row and column at pivot 1 (replaced), a tiny
        # pivot 5, zeros of both signs, then without replacement a zero
        # first pivot (inf, then NaN below it)
        s = panel_fronts(torch, gen, 3, 300, 0, 128, dt, ncols=160)
        s[torch.rand(s.shape, generator=gen, device="cuda") < 0.5] = 0.0
        s[(s == 0) & (torch.rand(s.shape, generator=gen, device="cuda")
                      < 0.5)] = -0.0
        s[0, 1, :] = 0.0
        s[0, :, 1] = 0.0
        s[1, 5, 5] = -1e-6
        ok = []
        for th in (1e-3, 0.0):
            if th == 0.0:
                s[2, 0, 0] = 0.0
            k, p = s.clone(), s.clone()
            fk = torch.zeros((3, 128), dtype=torch.int32, device="cuda")
            fp = fk.clone()
            t = torch.tensor(th, dtype=real, device="cuda")
            kernels.panel_lu_(k[:, :, :128], 0, 128, t, fk)
            kernels.panel_lu_plain(p[:, :, :128], 0, 128, t, fp)
            torch.cuda.synchronize()
            ok.append(same_bits(torch, k, p) and torch.equal(fk, fp))
            if th == 0.0:
                ok.append(not bool(torch.isfinite(p).all()))
        if not all(ok):
            raise AssertionError(f"panel_lu {name} != plain on the sentinel "
                                 f"panel: {ok}")
        say("kernels_extra", case=f"panel_lu sentinel {name}", equal=True)
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
                mark = census_mark()
                t0 = time.perf_counter()
                z1 = solver.solve(d)
                first = time.perf_counter() - t0
                c1 = census_since(mark, "solve.device")
                mark = census_mark()
                t0 = time.perf_counter()
                z = solver.solve(d)
                steady = time.perf_counter() - t0
                c2 = census_since(mark, "solve.device")
                # a new bucket's first solve captures its two sweeps, the
                # replay none; the eager solver never captures
                want = 2 if fused else 0
                if (c1["builds"], c2["builds"], c1["retraces"],
                        c2["retraces"]) != (want, 0, 0, 0):
                    raise AssertionError(f"solve {name} k={k}: census "
                                         f"{c1} then {c2}")
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
                            captures=[c1["builds"], c2["builds"]],
                            capture_s=c1["seconds"],
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


def persist_phase(slt, a, b, lu, kernels, tols, torch, workdir):
    """Phase 4a, on the main path's handle before anything refactors it:
    save_lu, then load_lu onto the card (every front torch.equal) and a
    FACTORED solve from the loaded handle; the bundle stays for the serve
    phase.  Then, on poisson3d(NX_SMALL) (the main path's 48 until the
    serve phase needed the time, 32 until the pgssvx phase did), a gssvx
    handle and the factorization of its
    skeleton under Options(deadline_s, ckpt_dir), which must stop at a
    group boundary 0 < k < groups with its frontier on disk (a first run
    the deadline cannot stop, then up to eight attempts, each aimed at
    the middle group boundary's poll as the run before saw it), and
    gssvx(resume_from=) from that frontier, whose every front must be
    torch.equal to the handle's (same plan, values and tier) with
    stats.resume["groups"] == k.  Bundle bytes, save / load / flush
    seconds and the launch counts of each step.  Returns the bundle and
    the poisson3d(NX_SMALL) matrix and handle."""
    import dataclasses
    import shutil
    from superlu_dist_tpu_torch.persist import checkpoint, serial
    from superlu_dist_tpu_torch.utils import deadline as deadline_mod
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

    # the deadline and the resume, on poisson3d(NX_SMALL)
    from superlu_dist_tpu_torch.models.gallery import poisson3d
    a = poisson3d(NX_SMALL)
    b = a.matvec(np.random.default_rng(SEED + 30).standard_normal(a.n_rows))
    _, lu, st, _ = timed_gssvx(slt, kernels, slt.Options(), a, b,
                               device="cuda")
    fact_s = st.utime["FACT"]
    lu0, bvals0, _ = slt.analyze(slt.Options(), a, device="cuda")
    groups = len(lu.plan.groups)
    # the flush is timed around the checkpointer's own call
    flushes = []
    flush = checkpoint.FactorCheckpointer.flush

    def timed_flush(self, *args, **kw):
        t = time.perf_counter()
        try:
            return flush(self, *args, **kw)
        finally:
            flushes.append(time.perf_counter() - t)

    ck = os.path.join(workdir, "ck")
    # each group boundary's poll is recorded on the deadline's own clock.
    # The host issues a FACT's groups within some milliseconds, a window
    # narrower than the set-up before the first poll varies from run to
    # run, so each attempt aims at the middle poll of the run before it:
    # a first run under a deadline it cannot reach, then after a run that
    # beat its deadline that run's middle poll, after one stopped at the
    # first poll (k = 0) that poll plus the last whole run's span from
    # its first poll to its middle one
    polls = []
    poll = deadline_mod.Deadline.poll

    def timed_poll(self, *args, **kw):
        polls.append(self.elapsed())
        return poll(self, *args, **kw)

    deadline_s, attempts, span = 1e6, [], 0.0
    checkpoint.FactorCheckpointer.flush = timed_flush
    deadline_mod.Deadline.poll = timed_poll
    try:
        for _ in range(9):
            shutil.rmtree(ck, ignore_errors=True)
            flushes.clear()
            polls.clear()
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
                polls=len(polls), first_poll_s=polls[0] if polls else None,
                last_poll_s=polls[-1] if polls else None,
                flush_s=list(flushes),
                launches=dict(kernels.LAUNCHES)))
            if 0 < k < groups or not polls:
                break
            if k == groups:
                mid = polls[len(polls) // 2]
                span, deadline_s = mid - polls[0], mid
            else:
                deadline_s = polls[0] + span
    finally:
        checkpoint.FactorCheckpointer.flush = flush
        deadline_mod.Deadline.poll = poll
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
    say("persist", n=a.n_rows, groups=groups, fact_s=fact_s, k=k,
        checkpoint_bytes=ck_bytes, bundle_path=bundle,
        deadline=attempts, resumed=resumed, fronts_equal=True, **out,
        berr_target=float(tols.berr_target(np.float64)))
    return bundle, a, lu


def _pct(vals, q):
    return float(np.percentile(np.asarray(vals), q)) if len(vals) else None


def _serve_round(srv, reqs, clients=8):
    """Closed-loop traffic: ``clients`` threads each submit their share of
    ``reqs`` one request at a time and wait for it.  Returns (X per
    request, latency seconds per request, wall seconds)."""
    import threading
    xs, lat, errs = [None] * len(reqs), [None] * len(reqs), []

    def client(idx):
        try:
            for i in idx:
                t0 = time.perf_counter()
                xs[i] = srv.solve(reqs[i], timeout=300)
                lat[i] = time.perf_counter() - t0
        except Exception as e:          # noqa: BLE001 — reported below
            errs.append(e)

    th = [threading.Thread(target=client, args=(range(c, len(reqs),
                                                      clients),))
          for c in range(clients)]
    t0 = time.perf_counter()
    for t in th:
        t.start()
    for t in th:
        t.join(600)
    wall = time.perf_counter() - t0
    if errs or any(x is None for x in xs):
        raise AssertionError(f"serve traffic failed: {errs[:3]}")
    return xs, lat, wall


def serve_phase(slt, a, lu, bundle, a_sm, lu_sm, kernels, tols, torch,
                workdir):
    """Phase 4c, the serving tier on the main path's handle (before the
    reuse phase refactors it) and on the bundle the persist phase wrote:
      * traffic — a SolveServer (batch cap 32, so the 40-column requests
        split across batches) on a fresh solver of the handle; 8 client
        threads, SERVE_REQUESTS seeded requests (nrhs 1 at 70 %, 4, 16
        and 40 at 10 % each), first with the buckets cold (their graphs
        captured by the traffic), then again after a warm-up of every
        bucket up to the cap: requests/s, p50/p99 latency, batches, mean
        batch fill, graph captures; every ticket's X its columns of the
        batch that served it; SERVE_RESOLVE seeded cold batches re-solved
        through lu.solve_factored at the same width, each within
        DEVICE_VS_HOST (bit for bit in every run so far) and timed in
        stages (host staging, device-solve, solve-d2h; the sweep replays
        alone);
      * the BERR gate — 16 requests at berr_target(float64) through the
        per-ticket IR rung, its residuals through csr_spmv: each
        delivered at or under the gate;
      * from_bundle — the bundle served bit for bit as the live handle on
        a fixed backlog; under chaos (poison_rhs, corrupt_panel) a
        poisoned column in a 16-column batch, its neighbours bit for bit
        the clean batch, and one scrub (timed) catching the corrupted
        panel;
      * refactor — SolveServer.refactor on the reuse phase's values: one
        front_assemble launch per group (its fronts are held against
        slt.refactor's in the reuse phase);
      * fleet — a FleetRouter of two process replicas over the
        poisson3d(48) bundle and one of ``lu_sm`` (the persist phase's
        poisson3d(NX_SMALL) handle ``a_sm``), one replica killed mid-stream:
        every ticket delivered, bit for bit the parent's solve of the
        same columns.
    Returns the refactored numeric factorization."""
    import dataclasses
    from superlu_dist_tpu_torch.refine.ir import request_berrs
    from superlu_dist_tpu_torch.serve import FleetRouter, SolveServer
    from superlu_dist_tpu_torch.utils.errors import (FactorCorruptError,
                                                     ServePoisonedError)
    groups = len(lu.plan.groups)
    n = a.n_rows
    rng = np.random.default_rng(SEED + 20)
    out = {}
    parts, t_part = {}, [time.perf_counter()]

    def part(name):
        # seconds of each part of the phase, in order
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now

    def fresh(handle):
        # the handle's factors with a solver (and graphs) of its own
        num = dataclasses.replace(handle.numeric,
                                  fronts=list(handle.numeric.fronts))
        return dataclasses.replace(handle, numeric=num, dev_solver=None,
                                   dev_spmv=None)

    # --- traffic, cold then warm ---------------------------------------
    widths = rng.choice([1, 4, 16, 40], size=SERVE_REQUESTS,
                        p=[0.7, 0.1, 0.1, 0.1])
    # uniform float32 values in [-1, 1) widened to float64 (a fraction of
    # the normal generator's time for the columns of 110,592)
    reqs = [(2 * rng.random((n, int(k)), dtype=np.float32) - 1)
            .astype(np.float64) for k in widths]
    part("requests")
    h = fresh(lu)
    srv = SolveServer(h, max_batch=32, max_wait_s=0.002)
    # every batch the dispatcher solves, kept for the checks below
    solved = {"cold": [], "warm": []}
    serve_solve = srv._solve

    def recorded(mat):
        x = serve_solve(mat)
        solved[round_name].append((mat, x))
        return x

    srv._solve = recorded
    kernels.reset_launches()
    rounds, served_x = {}, {}
    for round_name in ("cold", "warm"):
        name = round_name
        if name == "warm":
            t0 = time.perf_counter()
            for kb in srv._bucket_set:
                h.solve_factored(np.zeros((n, kb)))
            warm_s = time.perf_counter() - t0
        st0, g0 = srv.stats(), len(h._solver()._graphs)
        mark = census_mark()
        xs, lat, wall = _serve_round(srv, reqs)
        census = census_since(mark, "solve.device")
        served_x[name] = xs
        st1 = srv.stats()
        batches = st1["batches"] - st0["batches"]
        cols = st1["columns"] - st0["columns"]
        rounds[name] = dict(
            requests=len(reqs), columns=cols, wall_s=wall,
            requests_per_s=len(reqs) / wall, columns_per_s=cols / wall,
            p50_ms=1e3 * _pct(lat, 50), p99_ms=1e3 * _pct(lat, 99),
            max_ms=1e3 * max(lat), batches=batches,
            mean_batch_columns=cols / batches,
            graph_captures=len(h._solver()._graphs) - g0,
            census_captures=census["builds"],
            census_capture_s=census["seconds"])
        if census["builds"] != rounds[name]["graph_captures"] \
                or census["retraces"] or (name == "warm"
                                          and census["builds"]):
            raise AssertionError(f"serve {name}: census {census}, "
                                 f"{rounds[name]['graph_captures']} new "
                                 "graphs")
        if name == "warm":
            rounds[name]["warm_up_s"] = warm_s
    rounds["launches"] = expect_launches("serve traffic", kernels, 0, False)
    part("traffic")
    srv._solve = serve_solve
    # a seeded sample of the cold round's batches re-solved through
    # solve_factored on the handle's factors at the same width (float32
    # factors: another width is another rounding), each timed in stages
    # under a tracer: the host staging (scaling and permuting in and out)
    # around the device-solve span, and its solve-d2h span; then the two
    # sweep graphs of each sampled bucket replayed alone under CUDA
    # events.  Every ticket's X of both rounds is held against its columns
    # of the batches that served it.
    from superlu_dist_tpu_torch.obs import trace
    cold = solved["cold"]
    pick = sorted(np.random.default_rng(SEED + 21).choice(
        len(cold), size=min(SERVE_RESOLVE, len(cold)), replace=False))
    tracer = trace.Tracer(os.path.join(workdir, "serve_trace.json"))
    prev = trace.install(tracer)
    err, bitwise, stages = 0.0, True, []
    try:
        for i in pick:
            mat, x = cold[i]
            e0 = len(tracer._events)
            t0 = time.perf_counter()
            ref = h.solve_factored(mat)
            total = time.perf_counter() - t0
            spans = {ev["name"]: ev for ev in tracer._events[e0:]}
            dev = spans["device-solve"]
            stages.append(dict(
                columns=mat.shape[1], bucket=dev["args"]["padded_nrhs"],
                total_ms=1e3 * total, device_solve_ms=dev["dur"] / 1e3,
                d2h_ms=spans["solve-d2h"]["dur"] / 1e3,
                staging_ms=1e3 * total - dev["dur"] / 1e3))
            if not np.array_equal(x, ref):
                bitwise = False
                np.testing.assert_allclose(
                    x, ref, rtol=tols.DEVICE_VS_HOST_RTOL,
                    atol=tols.DEVICE_VS_HOST_ATOL)
                err = max(err, float(np.abs(x - ref).max()))
    finally:
        trace.install(prev)
        tracer.close()
    solver = h._solver()
    replay_ms = {}
    for kb in sorted({st["bucket"] for st in stages}):
        fwd, bwd = (solver._graphs[(d, "N", kb)] for d in ("fwd", "bwd"))
        replay_ms[kb] = cuda_ms(lambda: (fwd.replay(), bwd.replay()), 5)
    for name in ("cold", "warm"):
        # each request column's (batch, column), then each run of a
        # request's columns that one batch served compared as one block
        col_at = {}
        for bi, (mat, _) in enumerate(solved[name]):
            for j in range(mat.shape[1]):
                col_at[mat[:4, j].tobytes()] = (bi, j)
        for b_req, x_req in zip(reqs, served_x[name]):
            where = [col_at[b_req[:4, j].tobytes()]
                     for j in range(b_req.shape[1])]
            j = 0
            while j < len(where):
                bi, c0 = where[j]
                k = j + 1
                while k < len(where) and where[k] == (bi, c0 + k - j):
                    k += 1
                if not np.array_equal(x_req[:, j:k],
                                      solved[name][bi][1][:, c0:c0 + k - j]):
                    raise AssertionError(f"serve {name}: a ticket got "
                                         "another column's X")
                j = k
    rounds["resolved_batches"] = len(pick)
    rounds["max_abs_vs_solve_factored"] = err
    rounds["resolved_bitwise_vs_solve_factored"] = bitwise
    rounds["batch_stages"] = stages
    rounds["sweep_replays_ms"] = replay_ms
    rounds["buckets"] = list(srv._bucket_set)
    out["traffic"] = rounds
    part("verify")

    # --- the fleet's replicas start now (spawned interpreters import torch
    # meanwhile; a replica loads a bundle at its first ticket) -----------
    b_sm = os.path.join(workdir, "handle_sm")
    slt.save_lu(lu_sm, b_sm)
    os.environ["SLU_TPU_CHAOS"] = "kill_replica=0@batch=2"
    t_fleet = time.perf_counter()
    try:
        fleet = FleetRouter({"p48": bundle, "psm": b_sm}, n_replicas=2,
                            kind="process")
    finally:
        del os.environ["SLU_TPU_CHAOS"]
    router_init_s = time.perf_counter() - t_fleet
    part("bundle32_and_spawn")

    # --- the BERR gate through csr_spmv ---------------------------------
    gate = float(tols.berr_target(np.float64))
    gsrv = SolveServer(h, berr_max=gate, a=a, max_wait_s=0.0, start=False)
    bs = rng.standard_normal((n, 16))
    kernels.reset_launches()
    t0 = time.perf_counter()
    tickets = [gsrv.submit(bs[:, j]) for j in range(16)]
    gsrv.start()
    gx = [t.result(300) for t in tickets]
    gate_s = time.perf_counter() - t0
    berrs = [float(request_berrs(a, bs[:, j], x)[0])
             for j, x in enumerate(gx)]
    out["berr_gate"] = dict(
        requests=16, seconds=gate_s, gate=gate, max_berr=max(berrs),
        refined=gsrv.stats()["refined"],
        berr_before_max=max(t.rungs[0]["berr_before"] for t in tickets
                            if t.rungs) if gsrv.stats()["refined"] else None,
        operator=type(gsrv._berr_op).__name__,
        launches=expect_launches("serve berr gate", kernels, 0, True))
    gsrv.close()
    part("berr_gate")
    if max(berrs) > gate:
        raise AssertionError(f"serve BERR gate delivered {max(berrs)} > "
                             f"{gate}")

    # --- from_bundle, poison and scrub under chaos ----------------------
    backlog = [bs[:, :1], bs[:, 1:4], bs[:, 4:8]]
    live = SolveServer(fresh(lu), start=False, max_batch=16,
                       max_wait_s=0.05)
    lt = [live.submit(b) for b in backlog]
    live.start()
    live_x = [t.result(120) for t in lt]
    live.close()
    os.environ["SLU_TPU_CHAOS"] = "poison_rhs=13,corrupt_panel=0"
    try:
        t0 = time.perf_counter()
        bsrv = SolveServer.from_bundle(bundle, start=False, max_batch=16,
                                       max_wait_s=0.05)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        lt = [bsrv.submit(b) for b in backlog]
        bsrv.start()
        loaded_x = [t.result(120) for t in lt]
        same = all(np.array_equal(p, q) for p, q in zip(live_x, loaded_x))
        if not same:
            raise AssertionError("from_bundle served X != the live server")
        clean16 = bsrv.lu.solve_factored(bs)
        b16 = [bsrv.submit(bs[:, j]) for j in range(16)]
        verdict = []
        for j, t in enumerate(b16):
            try:
                x = t.result(120)
                verdict.append(bool(np.array_equal(x, clean16[:, j])))
            except ServePoisonedError as e:
                verdict.append(("poisoned", e.columns, e.batch_columns))
        pst = bsrv.stats()
        if (verdict[5] != ("poisoned", [0], 16) or
                not all(v is True for j, v in enumerate(verdict) if j != 5)
                or pst["batches"] != 2):
            raise AssertionError(f"poison isolation: {verdict} {pst}")
        t0 = time.perf_counter()
        try:
            bsrv.scrub_now()
            caught = None
        except FactorCorruptError as e:
            caught = e.groups
        scrub_s = time.perf_counter() - t0
        if caught != [0]:
            raise AssertionError(f"the scrub did not catch the corrupted "
                                 f"panel: {caught}")
        bsrv.close()
    finally:
        del os.environ["SLU_TPU_CHAOS"]
    out["bundle"] = dict(load_s=load_s, bitwise_live=same,
                         poison=dict(batch_columns=16, poisoned=[5],
                                     neighbours_bitwise=True),
                         scrub_s=scrub_s, scrub_caught=caught,
                         front_bytes=sum(
                             lp.numel() * lp.element_size()
                             + up.numel() * up.element_size()
                             for lp, up in lu.numeric.fronts))
    part("bundle_poison_scrub")

    # --- refactor through the server ------------------------------------
    u = np.random.default_rng(SEED).uniform(-1.0, 1.0, a.nnz)
    vals = a.data * (1.0 + 0.05 * u)
    kernels.reset_launches()
    t0 = time.perf_counter()
    srv.refactor(vals)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    out["refactor"] = dict(s=ref_s, launches=expect_launches(
        "serve refactor", kernels, groups, False))
    served = srv.lu.numeric
    xr = srv.solve(bs[:, :1], timeout=120)
    if not np.all(np.isfinite(xr)):
        raise AssertionError("the refactored server served non-finite X")
    out["serve_stats"] = srv.stats()
    srv.close()
    part("refactor")

    # --- the fleet of two process replicas, one killed mid-stream -------
    mats = {"p48": (a, lu), "psm": (a_sm, lu_sm)}
    fleet_reqs = []
    for j in range(12):
        key = ("p48", "psm")[j % 2]
        fleet_reqs.append((key, rng.standard_normal(mats[key][0].n_rows)))
    try:
        t0 = time.perf_counter()
        since_spawn = t0 - t_fleet
        tickets = [fleet.submit(k, b) for k, b in fleet_reqs]
        first = {}
        fx = []
        for (k, _), t in zip(fleet_reqs, tickets):
            fx.append(t.result(300))
            first.setdefault(k, time.perf_counter() - t0)
        fleet_s = time.perf_counter() - t0
        fst = fleet.stats()
    finally:
        fleet.close(timeout=30)
    alive = [r._proc.is_alive() for r in fleet._replicas]
    bit = [bool(np.array_equal(x, mats[k][1].solve_factored(b)))
           for (k, b), x in zip(fleet_reqs, fx)]
    if (fst["delivered"] != 12 or fst["errors"] or fst["failovers"] < 1
            or not all(bit) or any(alive)):
        raise AssertionError(f"fleet failover: {fst} bitwise={bit} "
                             f"alive={alive}")
    out["fleet"] = dict(
        replicas=2, kind="process", tickets=12,
        router_init_s=router_init_s, spawned_s_before_first_ticket=since_spawn,
        first_x_s=first, seconds=fleet_s, delivered=fst["delivered"],
        failovers=fst["failovers"], reroutes=fst["reroutes"],
        replicas_failed=fst["replicas_failed"], bitwise=all(bit),
        children_reaped=not any(alive))
    part("fleet")
    say("serve", n=n, groups=groups, seconds=parts, **out)
    return served


def cli_phase(slt, a, kernels, tols, workdir):
    """Phase 4b: a matrix (poisson3d(NX_SMALL); the main path's 48 until the
    serve phase needed the time, 32 until the pgssvx phase did) written as
    a Matrix Market file,
    then ``python -m superlu_dist_tpu_torch -f <file> --stats`` in-process
    (``__main__.main``): rc 0, the report's FACT / SOLVE / REFINE seconds
    and the backward error, read from its output, at the float64 gate."""
    import contextlib
    import io
    import re
    from superlu_dist_tpu_torch.__main__ import main as cli_main
    from superlu_dist_tpu_torch.io import write_matrix_market
    path = os.path.join(workdir, f"matrix_n{a.n_rows}.mtx")
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


def gemm_tiers_phase(slt, kernels, tols):
    """gssvx on poisson3d(NX_TINY) (the main path's 48 until the serve
    phase needed the time, 32 until the pgssvx phase did, 25 until the
    grid legs did) at the default GEMM tier (TF32), then at
    the bf16 and f32 tiers on its analysis (SamePattern_SameRowPerm: same
    plan): FACT seconds, refine steps, rungs, the tier the answer rests
    on, BERR."""
    from superlu_dist_tpu_torch.models.gallery import poisson3d
    rng = np.random.default_rng(SEED + 80)
    a = poisson3d(NX_TINY)
    b = a.matvec(rng.standard_normal(a.n_rows))
    x, lu, st, sec = timed_gssvx(slt, kernels, slt.Options(), a, b,
                                 device="cuda")
    rep = st.solve_report
    out = {"default": dict(s=sec, fact_s=st.utime["FACT"],
                           refine_s=st.utime["REFINE"],
                           refine_steps=st.refine_steps,
                           rungs=[(r.name, r.detail) for r in rep.rungs],
                           answer_tier=rep.gemm_precision, berr=rep.berr,
                           berr_history=rep.berr_history)}
    check_berr("gemm_tiers default", rep.berr)
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


def _expect_front_launches(phase, launches, want, panels=None):
    """``want`` front_assemble launches, ``panels`` panel_lu launches
    (None: some where ``want`` is not 0) and nothing else, or raise."""
    if panels is None:
        panels = max(launches["panel_lu"], 1) if want else 0
    if launches["front_assemble"] != want or any(
            launches[k] for k in ("extend_add", "assemble", "csr_spmv")) \
            or launches["panel_lu"] != panels:
        raise AssertionError(f"launches in {phase}: {launches}, expected "
                             f"{want} front_assemble, {panels} panel_lu "
                             "and nothing else")
    return launches["front_assemble"]


def fused_block(slt, a, lu, kernels, torch, factor, rng):
    """The fused executor on ``lu``'s plan (float32, default tier): its
    first call (warm-up, capture, instantiation, replay), two replays of
    the same values and one of new values, each bit for bit the stream on
    the same values, the first call's fronts untouched by the later
    replays, and refactor through the replay.  Returns the record."""
    import dataclasses
    same_rows = slt.Options(fact=slt.Fact.SamePattern_SameRowPerm)
    plan = lu.plan
    groups = len(plan.groups)
    keys = len({(g.batch, g.m, g.w, g.u) for g in plan.groups})
    mats, vals = [], []
    for scale in (0.0, 0.05, 0.05):
        u = rng.uniform(-1.0, 1.0, a.nnz)
        m = type(a)(a.n_rows, a.n_cols, a.indptr, a.indices,
                    lu.a.data * (1.0 + scale * u))
        skel, bv, _ = slt.analyze(same_rows, m, device="cuda", lu=lu)
        mats.append(m)
        vals.append((bv, skel.anorm))
    out = dict(n=a.n_rows, groups=groups, shape_keys=keys)
    ref = []
    for i in (0, 1):
        num, sec, peak, launches = _timed_factor(
            torch, kernels, factor, plan, *vals[i], executor="stream")
        ref.append(num.fronts)
        if i == 0:
            out["stream_fact_s"] = sec
            out["stream_peak_above_resident"] = peak
    # fused: capture at the first call, then replays
    calls, fused_eq = [], []
    for i in (0, 0, 1):
        mark = census_mark()
        num, sec, peak, launches = _timed_factor(
            torch, kernels, factor, plan, *vals[i], executor="fused")
        census = census_since(mark, "make_factor_fn")
        calls.append(num)
        fused_eq.append(_fronts_equal(torch, num.fronts, ref[i]))
        rep = num.executor
        first = len(calls) == 1
        want = groups + (keys if first else 0)
        rec = dict(s=sec, replay_s=rep["replay_s"],
                   peak_above_resident=peak, equal_to_stream=fused_eq[-1],
                   launches=_expect_front_launches("fused", launches, want),
                   census=census)
        if first:
            rec.update({k: rep[k] for k in (
                "warm_up_s", "capture_s", "instantiate_s", "nodes",
                "graph_device_bytes", "graph_host_bytes", "clone_bytes")})
            rec["census_vs_graphs"] = within_census(
                "fused capture", census["seconds"], rep)
        if (census["builds"], census["retraces"]) != (int(first), 0):
            raise AssertionError(f"fused call {len(calls)}: census {census}")
        out[f"call{len(calls)}"] = rec
    replays_equal = _fronts_equal(torch, calls[0].fronts, calls[1].fronts)
    old_untouched = _fronts_equal(torch, calls[0].fronts, ref[0])
    out["checks"] = dict(equal_to_stream=fused_eq,
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
    out["refactor"] = dict(s=sec, fact_s=st.utime["FACT"],
                           executor=hf.numeric.executor["executor"],
                           launches=rlaunch, solve_s=sec2,
                           berr=st2.solve_report.berr,
                           retraces=st.retraces)
    check_berr("fused refactor", st2.solve_report.berr)
    # one forced recapture through the executor's own graph cache: the
    # sentinel must count exactly it, in Stats.retraces too
    ex = next(e for e in factor.cached_executors(plan) if e.name == "fused")
    ex.drop_graphs()
    mark = census_mark()
    st3 = slt.refactor(hf, mats[1].data)
    torch.cuda.synchronize()
    forced = census_since(mark, "make_factor_fn")
    out["forced_recapture"] = dict(stats_retraces=st3.retraces,
                                   last_retraces=ex.last_retraces, **forced)
    if (st.retraces, st3.retraces, forced["retraces"], forced["builds"],
            ex.last_retraces) != (0, 1, 1, 1, 1):
        raise AssertionError(f"forced recapture: {out['forced_recapture']}"
                             f", the refactor before it {st.retraces}")
    del hf, ex
    if not (all(fused_eq) and replays_equal and old_untouched):
        raise AssertionError(f"fused replays differ from the stream or "
                             f"touched an earlier handle: {out}")
    return out


def offload_block(slt, a, lu, kernels, torch, rng, stream_peak):
    """The host offload (``front_bytes_limit=0``) through gssvx on ``lu``'s
    analysis: FACT, the offload wait, the peak device memory above the
    resident handle beside the stream's (``stream_peak``), the host solve
    and refinement, BERR.  Returns the record."""
    import dataclasses
    same_rows = slt.Options(fact=slt.Fact.SamePattern_SameRowPerm)
    groups = len(lu.plan.groups)
    b1 = lu.a.matvec(rng.standard_normal(a.n_rows))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    x, luo, st, sec = timed_gssvx(
        slt, kernels, dataclasses.replace(same_rows, front_bytes_limit=0),
        lu.a, b1, lu=lu)
    rep, ex = st.solve_report, st.executor
    launches = dict(kernels.LAUNCHES)
    if (not luo.numeric.on_host or rep.solve_route != "host"
            or rep.residual_route != "host" or launches["csr_spmv"]
            or launches["front_assemble"] != groups):
        raise AssertionError(f"offload: on_host={luo.numeric.on_host} "
                             f"routes {rep.solve_route}/{rep.residual_route}"
                             f" launches {launches}")
    out = dict(
        s=sec, fact_s=st.utime["FACT"], offload_wait_s=ex["offload_wait_s"],
        peak_above_resident=st.peak_memory_bytes - base,
        stream_peak_above_resident=stream_peak,
        host_solve_s=st.utime["SOLVE"], refine_s=st.utime["REFINE"],
        refine_steps=st.refine_steps, berr=rep.berr,
        solve_route=rep.solve_route, residual_route=rep.residual_route,
        launches=launches["front_assemble"])
    check_berr("offload", rep.berr)
    del luo, x
    return out


def executors_phase(slt, a, lu, kernels, tols, torch, factor, a_sm, lu_sm):
    """Options.executor on the card.  At the main path's width (its handle
    and plan, float32, default tier): the streamed executor.  Then on
    poisson3d(NX_SMALL), ``a_sm`` and its gssvx handle ``lu_sm`` (the fused
    graph's first call takes 18-21 s at 48; the offload ran at 48 too
    until the serve phase needed the time, both at 32 until the pgssvx
    phase did): ``fused`` (``fused_block``), the host offload
    (``offload_block``).  Then on poisson3d(NX_TINY) (32 until the serve
    phase needed the time, 24 until the pgssvx phase did): ``mega`` on a
    closed plan (one graph per closed key) and the host-share split, each in float64
    and float32 against the stream (``_drift_ok``), and level waves (bit
    for bit the stream).  Launch counts: the warm-up's launches and one
    per group for each replay."""
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
    skel, bv, _ = slt.analyze(same_rows, lu.a, device="cuda", lu=lu)
    out = {}

    # the streamed executor
    num, sec, peak, launches = _timed_factor(
        torch, kernels, factor, plan, bv, skel.anorm, executor="stream")
    out["stream"] = dict(fact_s=sec, peak_above_resident=peak,
                         launches=_expect_front_launches(
                             "stream", launches, groups,
                             len(plan_panels(plan))))
    del num

    say("executors", n=a.n_rows, groups=groups, shape_keys=keys, **out)

    # poisson3d(NX_SMALL): the fused graph and the host offload
    small = {}
    small["fused"] = fused_block(slt, a_sm, lu_sm, kernels, torch, factor,
                                 rng)
    small["offload"] = offload_block(
        slt, a_sm, lu_sm, kernels, torch, rng,
        small["fused"]["stream_peak_above_resident"])

    # poisson3d(NX_TINY): mega on a closed plan, the host-share split, level
    # waves; mega and the split in float64 held at the SCHEDULE_DRIFT gate
    # (another cuBLAS algorithm for a padded batch, or the CPU's BLAS,
    # reassociates the sums), in float32 at the TF32 tier normwise at
    # TF32_DRIFT
    a_tiny = poisson3d(NX_TINY)
    b_tiny = a_tiny.matvec(rng.standard_normal(a_tiny.n_rows))
    small["n_mega_host_share_level"] = a_tiny.n_rows
    lu_c, bv_c, _ = slt.analyze(slt.Options(bucket_closed=True), a_tiny,
                                device="cuda")
    pc = lu_c.plan
    nkeys = len(pc.bucket_set)
    small["mega"] = dict(closed=pc.closed, closed_keys=nkeys,
                         groups=len(pc.groups))
    for dt in (torch.float64, torch.float32):
        s_num, s_sec, _, _ = _timed_factor(torch, kernels, factor, pc, bv_c,
                                           lu_c.anorm, executor="stream",
                                           dtype=dt)
        from superlu_dist_tpu_torch.obs.compilestats import COMPILE_STATS
        megas = []
        for i in (0, 1):
            mark = census_mark()
            num, sec, _, launches = _timed_factor(
                torch, kernels, factor, pc, bv_c, lu_c.anorm,
                executor="mega", dtype=dt)
            census = census_since(mark, "mega._kernel")
            pending = [p for p in COMPILE_STATS.pending()
                       if p["site"] == "mega._kernel"]
            megas.append(dict(s=sec, launches=launches["front_assemble"],
                              census=census, pending=len(pending),
                              **_drift(torch, tols, num.fronts,
                                       s_num.fronts)))
            if (census["builds"], census["retraces"], len(pending)) != (
                    nkeys if i == 0 else 0, 0, 0):
                raise AssertionError(f"mega call {i}: census {census}, "
                                     f"pending {pending}")
        rep = num.executor
        megas[0]["census_vs_graphs"] = within_census(
            "mega capture", megas[0]["census"]["seconds"], rep)
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

    lu_d, bv_d, _ = slt.analyze(slt.Options(), a_tiny, device="cuda")
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
            a_tiny, b_tiny, lu=lu_d)
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
        mark = census_mark()
        t0 = time.perf_counter()
        fr, tiny = ex(torch.as_tensor(bv_d), thresh)
        torch.cuda.synchronize()
        lev.append(dict(s=time.perf_counter() - t0,
                        launches=kernels.LAUNCHES["front_assemble"],
                        census=census_since(mark, "stream._level_fn"),
                        equal_to_stream=_fronts_equal(torch, fr,
                                                      s_num.fronts)))
    if (lev[0]["census"]["builds"], lev[1]["census"]["builds"],
            lev[1]["census"]["retraces"]) != (len(ex.waves()), 0, 0):
        raise AssertionError(f"level waves' census: {lev}")
    rep = ex.report()
    small["level"] = dict(waves=len(ex.waves()), graphs=rep["graphs"],
                          stream_fact_s=s_sec, first=lev[0], replayed=lev[1],
                          **{k: rep[k] for k in ("warm_up_s", "capture_s",
                                                 "instantiate_s", "nodes",
                                                 "graph_device_bytes")})
    say("executors_small", n=a_sm.n_rows, **small)
    if not all(c["equal_to_stream"] for c in lev) or \
            lev[1]["launches"] != len(pd.groups):
        raise AssertionError(f"level waves: {lev}")


#: the args of every per-group kernel span (the JAX stream's
#: ``_trace_kernel``, superlu_dist_tpu/numeric/stream.py:670-690)
SPAN_ARGS = ("level", "batch", "padded_batch", "m", "w", "u", "gemm_prec",
             "host", "aggregate", "executed_flops", "structural_flops",
             "padding")


class SyncCount:
    """Counts, inside its block, the calls of ``torch.cuda.synchronize``
    and of the ``synchronize`` methods of ``torch.cuda.Stream`` and
    ``torch.cuda.Event`` (each wrapped, then restored)."""

    def __init__(self, torch):
        self.torch = torch
        self.calls = {"torch.cuda.synchronize": 0, "Stream.synchronize": 0,
                      "Event.synchronize": 0}

    def _counted(self, key, fn):
        def call(*a, **k):
            self.calls[key] += 1
            return fn(*a, **k)
        return call

    def __enter__(self):
        cuda = self.torch.cuda
        self._saved = (cuda.synchronize, cuda.Stream.synchronize,
                       cuda.Event.synchronize)
        cuda.synchronize = self._counted("torch.cuda.synchronize",
                                         self._saved[0])
        cuda.Stream.synchronize = self._counted("Stream.synchronize",
                                                self._saved[1])
        cuda.Event.synchronize = self._counted("Event.synchronize",
                                               self._saved[2])
        return self

    def __exit__(self, *exc):
        cuda = self.torch.cuda
        (cuda.synchronize, cuda.Stream.synchronize,
         cuda.Event.synchronize) = self._saved
        return False


def _traced_call(torch, kernels, fn, path=None):
    """``fn()`` on the card with the launch counts reset just before it
    and the synchronize calls counted inside it, under a file ``Tracer``
    at ``path`` (None: untraced): (its result, the wall to a synchronized
    end, the launches, the sync calls, the trace's events — the file
    removed once read)."""
    from superlu_dist_tpu_torch.obs import trace
    tracer = trace.Tracer(path) if path else None
    torch.cuda.synchronize()
    kernels.reset_launches()
    prev = trace.install(tracer) if tracer else None
    t0 = time.perf_counter()
    try:
        with SyncCount(torch) as sc:
            out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        if tracer:
            trace.install(prev)
            tracer.close()
    events = None
    if tracer:
        events = json.load(open(path))["traceEvents"]
        for f in (tracer.path, tracer.jsonl_path):
            os.remove(f)
    return out, wall, dict(kernels.LAUNCHES), sc.calls, events


def _check_spans(phase, events, want, aggregate, name=None):
    """The kernel spans of a traced call: ``want`` of them, named ``lu
    b.. m.. w.. u..`` (``name``: that one name), each with a positive
    device time and the JAX args (``aggregate`` each); returns (their
    ms, in order, and their args)."""
    spans = [e for e in events if e["cat"] == "kernel"
             and (e["name"] == name if name else e["name"].startswith("lu "))]
    bad = [e for e in spans if not e["dur"] > 0 or not name and (
        set(SPAN_ARGS) - set(e["args"])
        or e["args"]["aggregate"] is not aggregate
        or e["args"]["padded_batch"] < e["args"]["batch"])]
    if len(spans) != want or bad:
        raise AssertionError(f"trace {phase}: {len(spans)} kernel spans, "
                             f"expected {want}; wrong: {bad[:3]}")
    return [e["dur"] / 1e3 for e in spans], [e.get("args", {}) for e in spans]


def trace_costs(torch, kernels, n=1000) -> dict:
    """The host µs of what a traced group adds, each timed ``n`` times
    on an idle card: a KernelClock mark (two timing events created and
    recorded) and one span record to a file tracer (the JSONL line
    written as the span closes), dispatch-sized and kernel-sized; and
    after the sync, reading one mark's device time."""
    from superlu_dist_tpu_torch.obs import trace
    from superlu_dist_tpu_torch.obs.kernelspans import KernelClock
    torch.cuda.synchronize()
    clock = KernelClock("cuda")
    t0 = time.perf_counter()
    for i in range(n):
        clock.stop(clock.start(), i)
    mark = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in clock.read():
        pass
    read = (time.perf_counter() - t0) / n * 1e6
    path = os.path.join(TRACE_DIR, "costs.json")
    tracer = trace.Tracer(path)
    t0 = time.perf_counter()
    for i in range(n):
        tracer.complete(f"issue g{i}", "dispatch", t0, 1e-4, group=i,
                        level=3)
    issue = (time.perf_counter() - t0) / n * 1e6
    t0 = time.perf_counter()
    for i in range(n):
        tracer.complete("lu b4 m3848 w256 u3592", "kernel", t0, 1e-4,
                        level=9, batch=4, padded_batch=4, m=3848, w=256,
                        u=3592, gemm_prec="default", host=False,
                        aggregate=False, executed_flops=1.0,
                        structural_flops=1.0, padding=1.0)
    span = (time.perf_counter() - t0) / n * 1e6
    tracer.close()
    for f in (tracer.path, tracer.jsonl_path):
        os.remove(f)
    return dict(mark=mark, read=read, issue_span=issue, kernel_span=span)


def trace_phase(slt, kernels, torch, factor, plan, bvals, anorm, lu_sm):
    """The factor executors' kernel spans on the card (obs/kernelspans.py).
    On the main path (``plan``: poisson3d(NX), float32, the default TF32
    tier, the stream at group granularity), after a first FACT that
    uploads the plan's maps: untraced and traced FACTs in turns
    (untraced, traced, traced, untraced; traced under a file ``Tracer``),
    each with its ``torch.cuda.synchronize`` calls (and ``Stream`` /
    ``Event.synchronize``) counted — no traced one may make more than an
    untraced one — and its launches (the same in all): a span a group,
    each with a positive device time and the JAX args, their sum no
    greater than the traced FACT's wall, ``last_profile`` a group,
    ``last_dispatch_seconds`` set.  Then at the depth cuts, each traced
    after an untraced call (the capture): level waves and fused on
    ``lu_sm``'s plan (poisson3d(NX_SMALL)) — a span a wave, one
    ``factor-fused`` — and mega on a closed plan of poisson3d(NX_TINY), a
    span a group at its rung; every traced call's launches those of a
    replay.  Prints the walls, the summed span ms, the five spans with
    the most ms, ``last_dispatch_seconds`` and ``trace_costs``."""
    from superlu_dist_tpu_torch.models.gallery import poisson3d
    from superlu_dist_tpu_torch.numeric.stream import StreamExecutor
    os.makedirs(TRACE_DIR, exist_ok=True)
    path = os.path.join(TRACE_DIR, "fact.json")
    groups, panels = len(plan.groups), len(plan_panels(plan))

    def fact():
        return factor.numeric_factorize(plan, bvals, anorm,
                                        dtype=torch.float32, device="cuda",
                                        executor="stream")
    # a first FACT uploads the plan's maps; then untraced and traced in
    # turns (the FACT is paced by the host, whose speed drifts)
    _, warm_s, _, _, _ = _traced_call(torch, kernels, fact)
    walls, syncs = {False: [], True: []}, {False: [], True: []}
    sums = []
    for traced in (False, True, True, False):
        num, wall, launched, synced, events = _traced_call(
            torch, kernels, fact, path if traced else None)
        del num
        _expect_front_launches(f"trace {'traced' if traced else 'untraced'}"
                               f" FACT", launched, groups, panels)
        walls[traced].append(wall)
        syncs[traced].append(synced)
        if traced:
            ms, args = _check_spans("main", events, groups, False)
            sums.append(sum(ms))
            issued = [e for e in events if e["cat"] == "dispatch"]
            if sum(ms) > wall * 1e3 or len(issued) != groups:
                raise AssertionError(f"trace main: span sum {sum(ms)} ms "
                                     f"against a {wall} s wall, "
                                     f"{len(issued)} dispatch spans")
            names = [e["name"] for e in events if e["cat"] == "kernel"
                     and e["name"].startswith("lu ")]
    most = max(sum(c.values()) for c in syncs[True])
    if most > min(sum(c.values()) for c in syncs[False]):
        raise AssertionError(f"trace: a traced FACT synchronized more "
                             f"({syncs[True]}) than an untraced one "
                             f"({syncs[False]})")
    ex = factor.get_executor(plan, torch.float32, "stream", None, "cuda")
    if len(ex.last_profile or []) != groups \
            or not ex.last_dispatch_seconds \
            or {a["gemm_prec"] for a in args} != {"default"} \
            or any(a["host"] or a["padding"] != 1.0 for a in args):
        raise AssertionError(
            f"trace main: {len(ex.last_profile or [])} profile entries, "
            f"dispatch {ex.last_dispatch_seconds} s, args {args[:2]}")
    top = sorted(zip(ms, names), reverse=True)[:5]
    cost = trace_costs(torch, kernels)
    out = dict(n=plan.n, groups=groups, warm_fact_s=warm_s,
               untraced_fact_s=walls[False], traced_fact_s=walls[True],
               untraced_syncs=syncs[False][0], traced_syncs=syncs[True][0],
               spans=len(ms), span_sum_ms=sums, span_min_ms=min(ms),
               top5_ms=[(n, t) for t, n in top],
               dispatch_s=ex.last_dispatch_seconds, launches=launched,
               host_us=cost)

    # the depth cuts: level waves and fused at NX_SMALL, mega at NX_TINY
    same_rows = slt.Options(fact=slt.Fact.SamePattern_SameRowPerm)
    skel, bv, _ = slt.analyze(same_rows, lu_sm.a, device="cuda", lu=lu_sm)
    p25 = lu_sm.plan
    real = torch.float32
    thresh = torch.tensor(np.sqrt(torch.finfo(real).eps)
                          * max(skel.anorm, 1e-300), dtype=real)
    level = StreamExecutor(p25, real, "cuda", granularity="level")
    a25 = torch.as_tensor(bv)
    _, cap_s, _, _, _ = _traced_call(torch, kernels,
                                     lambda: level(a25, thresh))
    _, lev_s, lev_l, lev_sync, events = _traced_call(
        torch, kernels, lambda: level(a25, thresh), path)
    _expect_front_launches("trace level", lev_l, len(p25.groups))
    lev_ms, _ = _check_spans("level", events, len(level.waves()), True)
    out["level"] = dict(n=lu_sm.n, groups=len(p25.groups),
                        waves=len(level.waves()), capture_call_s=cap_s,
                        traced_s=lev_s, span_sum_ms=sum(lev_ms),
                        syncs=lev_sync,
                        graphs=level.report().get("graphs"))
    del level

    def fused():
        return factor.numeric_factorize(p25, bv, skel.anorm, dtype=real,
                                        device="cuda", executor="fused")
    _, first_s, _, _, _ = _traced_call(torch, kernels, fused)
    _, fus_s, fus_l, fus_sync, events = _traced_call(torch, kernels, fused,
                                                     path)
    _expect_front_launches("trace fused", fus_l, len(p25.groups))
    fus_ms, fus_args = _check_spans("fused", events, 1, True, "factor-fused")
    if fus_args[0]["structural_flops"] != p25.flops or not any(
            e["name"] == "issue fused" for e in events):
        raise AssertionError(f"trace fused: {fus_args}")
    out["fused"] = dict(first_call_s=first_s, traced_s=fus_s,
                        span_ms=fus_ms[0], syncs=fus_sync)

    lu_c, bv_c, _ = slt.analyze(slt.Options(bucket_closed=True),
                                poisson3d(NX_TINY), device="cuda")
    pc = lu_c.plan

    def mega():
        return factor.numeric_factorize(pc, bv_c, lu_c.anorm, dtype=real,
                                        device="cuda", executor="mega")
    _, first_s, _, _, _ = _traced_call(torch, kernels, mega)
    _, meg_s, meg_l, meg_sync, events = _traced_call(torch, kernels, mega,
                                                     path)
    _expect_front_launches("trace mega", meg_l, len(pc.groups))
    meg_ms, meg_args = _check_spans("mega", events, len(pc.groups), False)
    out["mega"] = dict(n=lu_c.n, groups=len(pc.groups), first_call_s=first_s,
                       traced_s=meg_s, span_sum_ms=sum(meg_ms),
                       padded_slots=sum(a["padded_batch"] - a["batch"]
                                        for a in meg_args), syncs=meg_sync)
    del lu_c, bv_c, pc
    say("trace", **out)
    return out


def trace_mesh_leg(slt, peer, kernels, tols, torch):
    """The trace phase's grid leg on the mesh phase's 1x2 grid (the
    peer's "mesh_trace" job, ``testing.ranks.run_mesh_trace``) on
    poisson3d(NX_TINY), MESH_2D: on both ranks a traced 2-D FACT — a span
    a group and the aggregate ``factor-mesh-stream``, each with a
    positive device time — with the untraced FACT's launches (the groups
    where the rank assembles); then ``granularity="level"``: its replay's
    fronts, pivot stacks and tiny count bit for bit the FACT's, a span a
    wave, its launches the FACT's, fewer segment graphs than the grid's
    fused executor at the same size; then pgssvx FACTORED on its factors:
    info 0, x the same on both ranks, within DEVICE_VS_HOST of gssvx's on
    the card, BERR at the target."""
    from superlu_dist_tpu_torch.testing.ranks import run_job
    os.makedirs(TRACE_DIR, exist_ok=True)
    target = float(tols.berr_target(np.float64))
    job = peer["trace2d"]
    t0 = time.perf_counter()
    rec0 = run_job(job, 0, "cuda")
    wall = time.perf_counter() - t0
    if "error" in rec0:
        raise AssertionError(f"trace mesh rank 0: {rec0['error']}")
    p1 = _await(peer, (1,), job.name, timeout=600)[1]
    ranks = {}
    for r, rec in ((0, rec0), (1, p1)):
        if "error" in rec or rec["info"] != 0:
            raise AssertionError(f"trace mesh rank {r}: "
                                 f"{rec.get('error', rec.get('info'))}")
        tr, lv = rec["traced"], rec["level_spans"]
        graphs = (rec["level_report"].get("graphs"),
                  rec["fused_report"].get("graphs"))
        owned = rec["owned_groups"]
        ok = (tr["spans"] == rec["groups"] and tr["min_ms"] > 0
              and set(SPAN_ARGS) | {"owned", "columns", "local_flops"}
              <= set(tr["fields"]) and not any(tr["aggregate"])
              and tr["aggregates"] == ["factor-mesh-stream"]
              and lv["spans"] == rec["level_waves"] and lv["min_ms"] > 0
              and all(lv["aggregate"]) and rec["level_equal"]
              and rec["untraced_launches"] == rec["traced_launches"] == owned
              and rec["level_launches"] == owned
              and graphs[0] is not None and graphs[1] is not None
              and graphs[0] < graphs[1]
              and rec["level_report"]["granularity"] == "level")
        ranks[r] = dict(
            untraced_fact_s=rec["untraced_s"], traced_fact_s=rec["traced_s"],
            spans=tr["spans"], span_sum_ms=tr["sum_ms"],
            level_capture_s=rec["level_capture_s"],
            level_replay_s=rec["level_s"], level_waves=rec["level_waves"],
            level_span_sum_ms=lv["sum_ms"], level_graphs=graphs[0],
            fused_graphs=graphs[1], fused_capture_s=rec["fused_s"],
            owned_groups=owned, launches=(rec["untraced_launches"],
                                          rec["traced_launches"],
                                          rec["level_launches"]),
            level_equal=rec["level_equal"])
        if not ok:
            raise AssertionError(f"trace mesh rank {r}: {ranks[r]}, "
                                 f"traced {tr}, level {lv}")
    if not np.array_equal(rec0["x"], p1["x"]):
        raise AssertionError("trace mesh: rank 1's x != rank 0's")
    sysm = peer["systems"]["trace2d"]
    x_ref, _, _, _ = slt.gssvx(slt.Options(), sysm.matrix(), sysm.rhs(),
                               device="cuda")
    err = np.abs(rec0["x"] - x_ref)
    rep = rec0["lu_out"]["solve_report"]
    check_berr("trace mesh level", rep.berr, target)
    if not np.all(err <= tols.DEVICE_VS_HOST_ATOL
                  + tols.DEVICE_VS_HOST_RTOL * np.abs(x_ref)):
        raise AssertionError(f"trace mesh level: x vs gssvx's: max "
                             f"{err.max()}")
    out = dict(n=sysm.matrix().n_rows, groups=rec0["groups"], wall_s=wall,
               berr=rep.berr, refine_steps=rep.refine_steps,
               max_abs_vs_gssvx=float(err.max()), ranks=ranks)
    say("trace_mesh", **out)
    return out


#: the audit phase's budget: the card's memory
CARD_BUDGET = int(80e9)


def audit_phase(slt, a, b, lu, berr_main, kernels, torch, factor, plan,
                bvals, anorm):
    """The runtime program audits on the card (module docstring): on
    ``lu`` (the main path's handle) gssvx SamePattern_SameRowPerm, un-
    audited, then audited on a fresh executor (its cached executors
    dropped, so every program is cold) under every audit with the budget
    ``CARD_BUDGET``; then the half-estimate budget on a fresh executor
    of ``plan`` (the phase-3 analysis, ``bvals`` / ``anorm``; the main
    handle stays as the audited run left it)."""
    from superlu_dist_tpu_torch.testing.ranks import audit_knobs
    from superlu_dist_tpu_torch.utils.errors import MemoryBudgetError
    hplan = lu.plan
    groups, panels = len(hplan.groups), len(plan_panels(hplan))
    same = slt.Options(fact=slt.Fact.SamePattern_SameRowPerm)

    def run(label):
        torch.cuda.synchronize()
        kernels.reset_launches()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with SyncCount(torch) as sc:
            _, _, st, info = slt.gssvx(same, a, b, lu=lu)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = expect_launches(label, kernels, groups, True, panels)
        rep = st.solve_report
        return dict(wall_s=wall, fact_s=st.utime["FACT"],
                    solve_s=st.utime["SOLVE"], info=info, berr=rep.berr,
                    refine_steps=rep.refine_steps, launches=launched,
                    syncs=sc.calls,
                    peak_above_resident=torch.cuda.max_memory_allocated()
                    - base)

    plain = run("audit un-audited")
    hplan.__dict__.pop("_factor_fns", None)
    with audit_knobs(SLU_TPU_MEM_BUDGET_BYTES=str(CARD_BUDGET)) as pa:
        audited = run("audit audited")
        blk = pa.audit_block()
        peaks = {lbl: st["peak_bytes_est"] for (site, lbl), st
                 in pa.get_sharding_auditor().audited.items()
                 if site == "stream.group_step"}
    if not (plain["info"] == audited["info"] == 0
            and plain["berr"] == audited["berr"] == berr_main
            and plain["launches"] == audited["launches"]
            and plain["syncs"] == audited["syncs"]
            and blk["findings"] == 0 and blk["inplace_coverage_pct"] == 100.0
            and blk["baked_const_bytes"] == 0
            and blk["sites"].get("stream.group_step") == len(
                {(g.batch, g.m, g.w, g.u) for g in hplan.groups})
            and blk["sites"].get("device._sweep", 0) >= 2):
        raise AssertionError(f"audit: un-audited {plain}, audited "
                             f"{audited}, block {blk}, main BERR "
                             f"{berr_main}")
    est = blk["peak_bytes_est"]

    # a budget of half the largest estimate: the first program above it
    # raises before anything of the call runs
    budget = est // 2
    first = next(f"lu b{g.batch} m{g.m} w{g.w} u{g.u} float32 default"
                 for g in hplan.groups
                 if peaks[f"lu b{g.batch} m{g.m} w{g.w} u{g.u} float32 "
                          "default"] > budget)
    plan.__dict__.pop("_factor_fns", None)
    # the plan's maps resident before, as on the main path (cached on the
    # plan): the raised call may add nothing
    factor.upload_maps(plan, torch.device("cuda"))
    torch.cuda.synchronize()
    kernels.reset_launches()
    before = torch.cuda.memory_allocated()
    err = None
    with audit_knobs(SLU_TPU_MEM_BUDGET_BYTES=str(budget)):
        t0 = time.perf_counter()
        try:
            factor.numeric_factorize(plan, bvals, anorm, dtype=torch.float32,
                                     device="cuda", executor="stream")
        except MemoryBudgetError as e:
            err = dict(site=e.site, program=e.program, peak=e.peak_bytes,
                       budget=e.budget_bytes, rules=e.rules)
        raised_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    launched = dict(kernels.LAUNCHES)
    if (err is None or err["site"] != "stream.group_step"
            or err["program"] != first or err["rules"] != ["SLU121"]
            or any(launched.values()) or after != before):
        raise AssertionError(f"audit budget {budget}: error {err} (the "
                             f"first program above it: {first}), "
                             f"launches {launched}, memory {before} -> "
                             f"{after}")
    out = dict(groups=groups, programs=blk["programs"], sites=blk["sites"],
               findings=blk["findings"],
               inplace_coverage_pct=blk["inplace_coverage_pct"],
               dead_bytes=blk["dead_bytes"],
               baked_const_bytes=blk["baked_const_bytes"],
               audit_host_s=blk["seconds"],
               peak_bytes_est=est, peak_program=blk["peak_program"],
               measured_peak_above_resident=audited["peak_above_resident"],
               est_over_measured=est / max(audited["peak_above_resident"], 1),
               un_audited=plain, audited=audited,
               budget=dict(budget_bytes=budget, error=err, seconds=raised_s,
                           launches=launched, memory_before=before,
                           memory_after=after))
    say("audit", **out)
    return out


def audit_mesh_leg(peer):
    """The audit phase's grid leg on the mesh phase's 1x2 grid (the
    peer's "mesh_audit" job, ``testing.ranks.run_mesh_audit``) on
    poisson3d(NX_TINY), MESH_2D: on both ranks an un-audited 2-D FACT,
    then one under every audit on a fresh executor — every group program
    walked and clean, the same digests on both ranks (the audits' own
    exchange compared them), fronts, pivot stacks and tiny count bit for
    bit the un-audited FACT's, the same launches."""
    from superlu_dist_tpu_torch.testing.ranks import run_job
    job = peer["audit2d"]
    t0 = time.perf_counter()
    rec0 = run_job(job, 0, "cuda")
    wall = time.perf_counter() - t0
    if "error" in rec0:
        raise AssertionError(f"audit mesh rank 0: {rec0['error']}")
    p1 = _await(peer, (1,), job.name, timeout=600)[1]
    ranks = {}
    for r, rec in ((0, rec0), (1, p1)):
        if "error" in rec:
            raise AssertionError(f"audit mesh rank {r}: {rec['error']}")
        blk = rec["audit"]
        ranks[r] = dict(programs=blk["programs"], sites=blk["sites"],
                        findings=blk["findings"], audit_host_s=blk["seconds"],
                        audited_fact_s=rec["audited_s"],
                        peak_bytes_est=blk["peak_bytes_est"],
                        launches=rec["launches"],
                        audited_launches=rec["audited_launches"],
                        audit_equal=rec["audit_equal"])
        if not (blk["findings"] == 0 and blk["programs"] == rec["groups"]
                and rec["audit_equal"]
                and rec["launches"] == rec["audited_launches"]):
            raise AssertionError(f"audit mesh rank {r}: {ranks[r]}")
    if rec0["digests"] != p1["digests"]:
        raise AssertionError("audit mesh: the ranks' collective digests "
                             "differ")
    out = dict(n=peer["systems"]["audit2d"].matrix().n_rows,
               groups=rec0["groups"], wall_s=wall, digests_equal=True,
               programs_compared=len(rec0["digests"]), ranks=ranks)
    say("audit_mesh", **out)
    return out


def audit_only() -> int:
    """``python3 chip_smoke.py audit``: the build, the main path's
    analysis and gssvx, the audit phase and its grid leg with a mesh peer
    of its own."""
    import torch
    import superlu_dist_tpu_torch as slt
    from superlu_dist_tpu_torch.models.gallery import poisson3d
    from superlu_dist_tpu_torch.numeric import factor, kernels
    from superlu_dist_tpu_torch.parallel import mhboot
    from superlu_dist_tpu_torch.testing.ranks import stop_peers
    card = card_line()
    say("card", nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda)
    t0 = time.perf_counter()
    kernels.library()
    say("build", seconds=time.perf_counter() - t0)
    peer = start_mesh_peer(slt, only="audit")
    try:
        a = poisson3d(NX)
        lu0, bvals0, _ = slt.analyze(slt.Options(), a, device="cuda")
        rng = np.random.default_rng(SEED)
        b = a.matvec(rng.standard_normal(a.n_rows))
        kernels.reset_launches()
        _, lu, st, info = slt.gssvx(slt.Options(), a, b, device="cuda")
        torch.cuda.synchronize()
        expect_launches("gssvx", kernels, len(lu.plan.groups), True,
                        len(plan_panels(lu.plan)))
        say("gssvx", info=info, berr=st.solve_report.berr,
            fact_s=st.utime["FACT"])
        check_berr("gssvx", st.solve_report.berr)
        audit_phase(slt, a, b, lu, st.solve_report.berr, kernels, torch,
                    factor, lu0.plan, bvals0, lu0.anorm)
        audit_mesh_leg(peer)
        _await(peer, (1,))
    finally:
        codes = stop_peers(peer["procs"], timeout=60)
        mhboot.shutdown()
    if codes != {1: 0}:
        raise AssertionError(f"audit mesh peer exit code {codes}")
    print(card)
    return 0


def trace_only() -> int:
    """``python3 chip_smoke.py trace``: the build, the main path's
    analysis, gssvx on poisson3d(NX_SMALL) and the trace phase — the
    single-card part and the grid leg, with a mesh peer of its own."""
    import torch
    import superlu_dist_tpu_torch as slt
    from superlu_dist_tpu_torch.models.gallery import poisson3d
    from superlu_dist_tpu_torch.numeric import factor, kernels
    from superlu_dist_tpu_torch.parallel import mhboot
    from superlu_dist_tpu_torch.testing.ranks import stop_peers
    from superlu_dist_tpu_torch.utils import tols
    card = card_line()
    say("card", nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda)
    kernels.library()
    peer = start_mesh_peer(slt, only="trace")
    try:
        lu0, bvals0, _ = slt.analyze(slt.Options(), poisson3d(NX),
                                     device="cuda")
        a_sm = poisson3d(NX_SMALL)
        _, lu_sm, _, _ = slt.gssvx(slt.Options(), a_sm,
                                   np.ones(a_sm.n_rows), device="cuda")
        trace_phase(slt, kernels, torch, factor, lu0.plan, bvals0,
                    lu0.anorm, lu_sm)
        trace_mesh_leg(slt, peer, kernels, tols, torch)
        _await(peer, (1,))
    finally:
        codes = stop_peers(peer["procs"], timeout=60)
        mhboot.shutdown()
        shutil.rmtree(TRACE_DIR, ignore_errors=True)
    if codes != {1: 0}:
        raise AssertionError(f"trace mesh peer exit code {codes}")
    print(card)
    return 0



#: the examples the entry phase runs in-process on the card, and the
#: residual line each prints (pddrive4 / pzdrive4 as one process)
EXAMPLES = {
    "pddrive": "[pddrive] residual",
    "pddrive1": "[pddrive1 (FACTORED reuse)] residual",
    "pddrive2": "[pddrive2 (SamePattern)] residual",
    "pddrive3": "[pddrive3 (SamePattern_SameRowPerm)] residual",
    "pddrive4": "[pddrive4 grid=None seed=1] residual",
    "pzdrive": "[pzdrive] residual",
    "pzdrive1": "[pzdrive1 (FACTORED)] residual",
    "pzdrive2": "[pzdrive2 (SamePattern)] residual",
    "pzdrive3": "[pzdrive3 (SamePattern_SameRowPerm)] residual",
    "pzdrive4": "[pzdrive4 grid=None seed=1] residual",
    "pddrive_ABglobal": "[pddrive_ABglobal] residual",
    "pddrive_dist": "[pddrive_dist (NR_loc input)] residual",
    "pddrive_df64": "[pddrive_df64] df64     raw-factor residual",
    "pddrive_refactor": "[hilbert(24) step 3 (refactor)] residual",
}


def _entry_workdir():
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_entry")


def start_capi_client():
    """The entry phase's C client (superlu_dist_tpu_torch/bindings/
    test_capi.c), built with gcc against libslu_tpu_torch.so and started
    early, so that its interpreter start, ``import torch`` and CUDA
    context overlap the phases before the entry phase: it runs
    ``slu_tpu_init(NULL)`` (the card), then waits for the phase's go file
    before it factors poisson3d(NX) and refactors poisson3d(NX_SMALL).
    Its metrics export (SLU_TPU_METRICS) counts each API call's kernel
    launches.  Returns the phase's state."""
    import atexit
    from superlu_dist_tpu_torch.bindings import build
    t0 = time.perf_counter()
    lib, exe = build.build()
    build_s = time.perf_counter() - t0
    wd = _entry_workdir()
    shutil.rmtree(wd, ignore_errors=True)
    os.makedirs(wd)
    st = dict(lib=str(lib), exe=str(exe), build_s=build_s,
              go=os.path.join(wd, "go"), out=os.path.join(wd, "x.bin"),
              log=os.path.join(wd, "client.log"),
              metrics=os.path.join(wd, "metrics.json"))
    root = os.path.dirname(os.path.abspath(__file__))
    # the interpreter's search path, handed on to the client: not a knob
    paths = os.environ.get("PYTHONPATH", "")  # slulint: disable=SLU104
    env = dict(os.environ, SLU_TPU_METRICS=st["metrics"],
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in paths.split(os.pathsep) if p]))
    st["log_fh"] = open(st["log"], "w")
    st["started"] = time.perf_counter()
    st["proc"] = subprocess.Popen(
        [str(exe), "default", str(NX), st["out"], str(NX_SMALL), st["go"]],
        stdout=st["log_fh"], stderr=subprocess.STDOUT,
        stdin=subprocess.DEVNULL, env=env)
    atexit.register(lambda p=st["proc"]: p.poll() is None and p.kill())
    return st


def _capi_fields(text, tag):
    import re
    m = re.search(tag + r" (.*)", text)
    if m is None:
        raise AssertionError(f"the C client printed no {tag} line:\n{text}")
    return {k: float(v) for k, v in (kv.split("=") for kv in
                                     m.group(1).split())}


def entry_phase(slt, a, lu, client, kernels, tols, torch):
    """The reference's user entry points on the card.  The C client
    (``start_capi_client``, waiting since the native phase): DOFACT of
    poisson3d(NX) through slu_tpu_factor_opts, FACTORED at nrhs 1 and 4
    (ldb > n), statistics, a tier-2 refactor of poisson3d(NX_SMALL) and a
    solve, finalize; its x held against the main handle's solve of the
    same b (DEVICE_VS_HOST), A·x against b, its BERR at the float64
    target, exit 0, and its kernel launches read from its metrics export:
    one front_assemble launch per group of the plan for the DOFACT, none
    of the standalone wrappers, csr_spmv in the refinement.  Then the 14
    example drivers in this process on the card (exit 0, the residual
    line, front_assemble launches and no others at n = 400), and pdtest's
    --quick configurations at 1x1 on the card (every run passing)."""
    import contextlib
    import importlib
    import io
    from superlu_dist_tpu_torch.examples import pdtest
    t_phase = time.perf_counter()
    ready_s = time.perf_counter() - client["started"]
    with open(client["go"], "w"):
        pass
    proc = client["proc"]
    rc = proc.wait(timeout=600)
    client["log_fh"].close()
    wall = time.perf_counter() - t_phase
    with open(client["log"]) as fh:
        text = fh.read()
    if rc != 0 or f"C API poisson3d({NX}) PASS" not in text:
        raise AssertionError(f"the C client exited {rc}:\n{text[-4000:]}")
    times = _capi_fields(text, "CAPI_TIMES")
    stats = _capi_fields(text, "CAPI_STATS")
    with open(client["out"], "rb") as fh:
        raw = fh.read()
    n = int(np.frombuffer(raw[:8], dtype=np.int64)[0])
    b = np.frombuffer(raw[8:8 + 8 * n], dtype=np.float64)
    x = np.frombuffer(raw[8 + 8 * n:8 + 16 * n], dtype=np.float64)
    if n != a.n_rows or not np.all(np.isfinite(x)):
        raise AssertionError(f"the C client's x: n={n}, finite "
                             f"{bool(np.all(np.isfinite(x)))}")
    relres = float(np.linalg.norm(b - a.matvec(x)) / np.linalg.norm(b))
    x_ref, _, _, info = slt.gssvx(slt.Options(fact=slt.Fact.FACTORED), a, b,
                                  lu=lu)
    diff = float(np.max(np.abs(x - x_ref)))
    close = np.allclose(x, x_ref, rtol=tols.DEVICE_VS_HOST_RTOL,
                        atol=tols.DEVICE_VS_HOST_ATOL)
    with open(client["metrics"]) as fh:
        counters = json.load(fh)["counters"]

    def launched(call, nn, kernel):
        return int(counters.get(
            f'slu_capi_kernel_launches_total{{call="{call}",'
            f'kernel="{kernel}",n="{nn}"}}', 0))
    groups = len(lu.plan.groups)
    capi_launches = {
        "dofact_front_assemble": launched("factor_opts", n, "front_assemble"),
        "solve_csr_spmv": launched("solve_factored_opts", n, "csr_spmv"),
        "refactor_front_assemble": launched("refactor", NX_SMALL ** 3,
                                            "front_assemble"),
        "standalone": sum(v for k, v in counters.items()
                          if 'kernel="extend_add"' in k
                          or 'kernel="assemble"' in k)}
    say("entry_capi", client_build_s=client["build_s"], exit=rc,
        waited_from_start_s=ready_s, wall_s=wall, seconds=times,
        stats=stats, rel_residual=relres, max_abs_diff_vs_in_process=diff,
        launches=capi_launches, groups=groups)
    if info != 0 or not close or relres > tols.RESID_GATE:
        raise AssertionError(f"the C client's x: in-process info {info}, "
                             f"max |x - x_ref| {diff}, residual {relres}")
    check_berr("entry_capi", stats["berr"])
    if (capi_launches["dofact_front_assemble"] != groups
            or not capi_launches["solve_csr_spmv"]
            or not capi_launches["refactor_front_assemble"]
            or capi_launches["standalone"]):
        raise AssertionError(f"the C client's launches {capi_launches}, "
                             f"expected {groups} for its DOFACT")

    examples = {}
    for name, line in EXAMPLES.items():
        mod = importlib.import_module(f"superlu_dist_tpu_torch.examples.{name}")
        kernels.reset_launches()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = mod.main(["--device", "cuda"])
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        out = buf.getvalue()
        if rc != 0 or line not in out:
            raise AssertionError(f"example {name}: rc {rc}\n{out[-3000:]}")
        got = expect_launches(f"example {name}", kernels, None, False)
        examples[name] = {"s": sec, "front_assemble": got["front_assemble"]}
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = pdtest.configs(pdtest.load_fixture("g20.rua")[0], None, [1, 3], 8,
                         20, device="cuda")
    pd_s = time.perf_counter() - t0
    nrun = sum(r[3] for r in res)
    nfail = sum(r[4] for r in res)
    pd_launches = expect_launches("pdtest", kernels, None, False)
    say("entry", examples=examples, pdtest={
        "grid": "1x1", "nrun": nrun, "nfail": nfail, "s": pd_s,
        "front_assemble": pd_launches["front_assemble"]},
        phase_s=time.perf_counter() - t_phase)
    if nrun != 24 or nfail:
        raise AssertionError(f"pdtest --quick 1x1: {nfail} of {nrun} failed")
    shutil.rmtree(_entry_workdir(), ignore_errors=True)


def entry_only() -> int:
    """``python3 chip_smoke.py entry``: the build, gssvx on poisson3d(48)
    and the entry phase only (a quicker check of the C API, the examples
    and pdtest; the full script runs every phase)."""
    import torch
    import superlu_dist_tpu_torch as slt
    from superlu_dist_tpu_torch.models.gallery import poisson3d
    from superlu_dist_tpu_torch.numeric import kernels
    from superlu_dist_tpu_torch.utils import tols
    card = card_line()
    say("card", nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda)
    kernels.library()
    from superlu_dist_tpu_torch import native
    native.load()
    client = start_capi_client()
    a = poisson3d(NX)
    b = a.matvec(np.random.default_rng(SEED).standard_normal(a.n_rows))
    x, lu, stats, info = slt.gssvx(slt.Options(), a, b, device="cuda")
    say("gssvx", n=a.n_rows, fact_s=stats.utime["FACT"],
        berr=stats.solve_report.berr, tiny_pivots=stats.tiny_pivots)
    entry_phase(slt, a, lu, client, kernels, tols, torch)
    print(card)
    return 0


CONFIG4_NX = 100          # the reference's headline configuration
                          # (BASELINE.json configs[3]): n = 1,000,000
CONFIG4_TIMEOUT_S = 900   # the child's limit inside the full run
CONFIG4_NRHS = 16         # the FACTORED solve's columns


def group_reach(plan, g) -> int:
    """The highest pool offset group ``g``'s child records read (one past
    its last live child block), 0 without one."""
    top = 0
    for c in g.children:
        off = np.asarray(c.child_off, dtype=np.int64)
        live = off[off < plan.pool_size]
        if len(live):
            top = max(top, int(live.max()) + c.ub * c.ub)
    return top


def config4_kernels(plan, torch, kernels, factor, gen) -> dict:
    """The kernels at poisson3d(100)'s shapes, on a seeded float32 pool of
    the plan's size (more than 2**31 values): front_assemble bit for bit
    its plain version at the group that reads the highest pool offsets
    and at the group with the most front elements, panel_lu bit for bit
    its plain loop at the widest front's first panel; each with its ms
    and bound (``time_front`` without the library's target list,
    ``time_panel``)."""
    dev = torch.device("cuda")
    maps = factor.upload_maps(plan, dev)
    reach = [group_reach(plan, g) for g in plan.groups]
    high = int(np.argmax(reach))
    big = max(range(len(plan.groups)), key=lambda i: plan.groups[i].batch
              * plan.groups[i].m ** 2)
    avals = torch.randn(len(plan.pattern_indices), generator=gen,
                        device=dev, dtype=torch.float32)
    pool = torch.randn(plan.pool_size, generator=gen, device=dev,
                       dtype=torch.float32)
    out = {}
    for which, gi in (("highest_offsets", high), ("most_elements", big)):
        g = plan.groups[gi]
        rec = time_front(avals, pool, g.m, g.w, maps[gi], kernels, reps=3,
                         plain_reps=1, targets=False)
        rec.update(group=gi, reach=reach[gi],
                   max_child_offset=int(maps[gi].front.ch_rec[:, 0].max()))
        if rec["max_child_offset"] <= 2 ** 31:
            raise AssertionError(f"config4: group {gi} reads no pool offset "
                                 f"above 2**31")
        out[f"front_assemble {which}"] = rec
        torch.cuda.empty_cache()
    del pool, avals
    torch.cuda.empty_cache()
    gi, g, m_ext, pb, j0, pa = max(plan_panels(plan),
                                   key=lambda r: (r[1].m, r[1].batch))
    a = panel_fronts(torch, gen, g.batch, m_ext, j0, pa, torch.float32,
                     ncols=j0 + pb)
    rec = time_panel(torch, kernels, a, j0, pa, pb,
                     torch.tensor(1e-3, device="cuda"))
    rec["group"] = gi
    out["panel_lu widest"] = rec
    return out


def config4_only() -> int:
    """``python3 chip_smoke.py config4``: the main path at the reference's
    own size — gssvx(Options()) on poisson3d(100), n = 1,000,000, float32
    factors at the default (TF32) tier, b = A·x_true from the seed — in
    its own process (the full run starts it as a child right after the
    native phase, on an empty card, and fails with it).  The offload
    rule must keep the factors on the card (``stats.executor``'s
    ``offload_rule``: the estimate against the budget) and the solves
    must run there; BERR at the float64 target, ‖x − x_true‖∞ / ‖x_true‖∞
    within DEVICE_VS_HOST_RTOL, every kernel launched (front_assemble a
    group, panel_lu a panel, csr_spmv two a refinement step), the peak
    device memory above what was resident at or below the estimate; one
    FACTORED gssvx at nrhs 16 on the handle (its sweeps replayed in
    refinement, no front_assemble launch).  Then, the handle gone, the
    kernels against their plain versions at the plan's shapes
    (``config4_kernels``), the other executors on the same analysis
    under the card's rule (``config4_executors``), and the graph
    executors' memory against their estimates (``graph_estimates``).  A
    config4 line, a config4_kernels line, a config4_executors line, a
    config4_graph_estimates line, then the card line."""
    import gc
    import torch
    import superlu_dist_tpu_torch as slt
    from superlu_dist_tpu_torch import native
    from superlu_dist_tpu_torch.models.gallery import poisson3d
    from superlu_dist_tpu_torch.numeric import factor, kernels
    from superlu_dist_tpu_torch.numeric.stream import (device_budget,
                                                       offload_estimate,
                                                       padded_front_bytes)
    from superlu_dist_tpu_torch.utils import tols
    from superlu_dist_tpu_torch.utils.peaks import mfu_pct
    card = card_line()
    t0 = time.perf_counter()
    kernels.build()
    kernels.library()
    build_s = time.perf_counter() - t0
    a = poisson3d(CONFIG4_NX)
    rng = np.random.default_rng(SEED)
    x_true = rng.standard_normal(a.n_rows)
    b = a.matvec(x_true)
    dev = torch.device("cuda")
    torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    native.reset_calls()
    t0 = time.perf_counter()
    x, lu, stats, info = slt.gssvx(slt.Options(), a, b, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if info != 0 or x is None or x.shape != b.shape \
            or not np.all(np.isfinite(x)):
        raise AssertionError(f"config4: gssvx failed: info={info}")
    plan = lu.plan
    rep = stats.solve_report
    groups, panels = len(plan.groups), len(plan_panels(plan))
    launches = expect_launches("config4", kernels,
                               groups * factorizations(rep), True,
                               panels * factorizations(rep))
    if launches["csr_spmv"] != 2 * stats.refine_steps:
        raise AssertionError(f"config4: {launches['csr_spmv']} csr_spmv "
                             f"launches in {stats.refine_steps} refinement "
                             f"steps, expected two a step")
    peak = torch.cuda.max_memory_allocated() - resident
    fact_peak = stats.current_memory_bytes - resident
    held = torch.cuda.memory_allocated() - resident
    rule = stats.executor.get("offload_rule", {})
    est = offload_estimate(plan, lu.numeric.dtype)
    factor_bytes = sum(t.numel() * t.element_size()
                       for pair in lu.numeric.fronts for t in pair)
    solver_bytes = lu.dev_solver.memory_stats()
    solve_batches = len(lu.dev_solver.splan.groups)
    solve_fused = lu.dev_solver.fused
    rel_err = float(np.abs(x - x_true).max() / np.abs(x_true).max())
    if stats.executor["offload"] != "none" or lu.numeric.on_host:
        raise AssertionError(f"config4: the factors were offloaded: {rule}")
    if rep.solve_route != "device" or lu.solve_route != "device":
        raise AssertionError(f"config4: solve route {rep.solve_route}")
    check_berr("config4", rep.berr)
    if not rel_err <= float(tols.DEVICE_VS_HOST_RTOL):
        raise AssertionError(f"config4: |x - x_true| / |x_true| = {rel_err}")
    if not peak <= rule["bytes"]:
        raise AssertionError(f"config4: peak {peak} B above the rule's "
                             f"estimate {rule['bytes']} B")
    fact_s = stats.utime["FACT"]
    gflops = plan.flops / fact_s / 1e9
    mfu, peak_gflops, mfu_source = mfu_pct(gflops, lu.numeric.gemm_prec)
    # one FACTORED solve at nrhs 16: the bucket's sweeps at its first
    # solve, replayed by every refinement step after it
    b16 = rng.standard_normal((a.n_rows, CONFIG4_NRHS))
    kernels.reset_launches()
    t0 = time.perf_counter()
    x16, lu16, st16, info16 = slt.gssvx(
        slt.Options(fact=slt.Fact.FACTORED), a, b16, lu=lu)
    torch.cuda.synchronize()
    wall16 = time.perf_counter() - t0
    launches16 = expect_launches("config4 FACTORED", kernels, 0, True)
    if launches16["csr_spmv"] != 2 * st16.refine_steps:
        raise AssertionError(f"config4 FACTORED: {launches16['csr_spmv']} "
                             f"csr_spmv launches in {st16.refine_steps} "
                             f"refinement steps")
    if info16 != 0 or not np.all(np.isfinite(x16)):
        raise AssertionError(f"config4: FACTORED nrhs {CONFIG4_NRHS} "
                             f"failed: info={info16}")
    check_berr("config4 FACTORED", st16.solve_report.berr)
    peak_reserved = torch.cuda.max_memory_reserved()
    # the other executors' legs reuse this analysis: the stream's fronts
    # on the host (the level waves' drift) and the skeleton
    stream_fronts = [(lp.cpu(), up.cpu()) for lp, up in lu.numeric.fronts]
    skeleton = dataclasses.replace(lu, numeric=None, dev_solver=None,
                                   dev_spmv=None, berrs=None)
    del x, x16, lu, lu16
    gc.collect()
    torch.cuda.empty_cache()
    say("config4", n=a.n_rows, nnz=a.nnz, groups=groups, panels=panels,
        flops=plan.flops, pool_bytes=est["pool_bytes"],
        padded_front_bytes=padded_front_bytes(plan, torch.float32),
        estimate=est, budget=rule["limit"], offload=stats.executor["offload"],
        offload_rule=rule,
        float64_estimate=offload_estimate(plan, torch.float64),
        budget_now=device_budget(dev), build_s=build_s,
        analysis_s=sum(stats.utime[p] for p in ANALYSIS),
        phase_s=stats.utime, wall_s=wall,
        refine_steps=stats.refine_steps, berr=rep.berr,
        berr_history=rep.berr_history, rel_error_inf=rel_err,
        tiny_pivots=stats.tiny_pivots, rungs=[(r.name, r.detail, r.seconds)
                                              for r in rep.rungs],
        solve_route=rep.solve_route, solve_batches=solve_batches,
        solve_fused=solve_fused,
        resident_bytes=resident, peak_above_resident=peak,
        fact_peak_above_resident=fact_peak, held_after=held,
        factor_bytes=factor_bytes, solver_memory=solver_bytes,
        max_memory_reserved=peak_reserved,
        factor_gflops=gflops, mfu_pct=mfu, peak_gflops=peak_gflops,
        mfu_source=mfu_source, launches=launches,
        factored=dict(nrhs=CONFIG4_NRHS, wall_s=wall16,
                      phase_s=st16.utime, refine_steps=st16.refine_steps,
                      berr=st16.solve_report.berr, launches=launches16),
        held_at_end=torch.cuda.memory_allocated() - resident,
        nvidia_smi=card)
    say("config4_kernels", **config4_kernels(
        plan, torch, kernels, factor,
        torch.Generator(device="cuda").manual_seed(SEED)))
    say("config4_executors", **config4_executors(
        slt, torch, kernels, a, b, skeleton, stream_fronts))
    del skeleton, stream_fronts
    say("config4_graph_estimates", **graph_estimates(slt, torch))
    print(card)
    return 0


def _drift_moved(torch, f1, f2) -> dict:
    """``_drift_card`` of two front lists wherever they lie, each pair
    moved to the card for its comparison (two n = 1M front sets do not
    fit the card beside each other)."""
    diff, big, same = [], [], []
    for (l1, u1), (l2, u2) in zip(f1, f2):
        for x, y in ((l1, l2), (u1, u2)):
            if x.shape != y.shape:
                same.append(torch.zeros((), dtype=torch.bool, device="cuda"))
            elif x.numel():
                dx, dy = x.to("cuda"), y.to("cuda")
                same.append((dx == dy).all())
                diff.append((dx.double() - dy.double()).abs().max())
                big.append(dy.abs().max().double())
    # read once, after the loop
    num = float(torch.stack(diff).max()) if diff else 0.0
    den = float(torch.stack(big).max()) if big else 0.0
    equal = len(f1) == len(f2) and bool(torch.stack(same).all()) \
        if same else len(f1) == len(f2)
    return dict(equal_to_stream=equal,
                max_rel_diff_vs_stream=num / max(den, 1e-300))


def _settled(torch) -> int:
    """The card's allocated bytes with nothing of the process's garbage
    and no unused cached block left."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def config4_executors(slt, torch, kernels, a, b, skeleton,
                      stream_fronts) -> dict:
    """The other executors at n = 1,000,000 on the main path's analysis
    (each refactor reuses its skeleton through SamePattern_SameRowPerm:
    no second analysis), each under the card's offload rule:

    * level waves in float32 (``StreamExecutor(granularity="level")``):
      the rule's choice ("host" where the waves' graph pool and the
      factors do not fit together), the fronts within TF32_DRIFT of the
      stream's, the peak at or below the estimate of the chosen mode,
      front_assemble a group plus one a warm-up shape, and BERR at the
      float64 target from their factors solved on the card;
    * fused and mega in float32 through gssvx: refused by name
      (``DeviceMemoryError``) before anything runs — no launch, no census
      record, ``memory_allocated`` the same to the byte;
    * the stream in float64 through gssvx(factor_dtype="float64"):
      offloaded, with its FACT, host SOLVE and REFINE seconds, BERR at the
      float64 target and the peak at or below its offloaded estimate — or
      refused with its parts."""
    import dataclasses
    from superlu_dist_tpu_torch.numeric.factor import NumericFactorization
    from superlu_dist_tpu_torch.numeric.stream import StreamExecutor
    from superlu_dist_tpu_torch.obs.compilestats import COMPILE_STATS
    from superlu_dist_tpu_torch.utils import tols
    from superlu_dist_tpu_torch.utils.errors import DeviceMemoryError
    plan = skeleton.plan
    groups, panels = len(plan.groups), len(plan_panels(plan))
    reuse = slt.Fact.SamePattern_SameRowPerm
    out = {}
    # level waves, float32, on the values the main path factored
    lu2, bvals, _ = slt.analyze(slt.Options(fact=reuse), a, device="cuda",
                                lu=skeleton)
    dt = torch.float32
    avals = torch.as_tensor(bvals)
    thresh = torch.tensor(np.sqrt(torch.finfo(dt).eps)
                          * max(lu2.anorm, 1e-300), dtype=dt)
    base = _settled(torch)
    base_r = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    ex = StreamExecutor(plan, dt, "cuda", granularity="level")
    fronts, tiny = ex(avals, thresh)
    torch.cuda.synchronize()
    level_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    peak_r = torch.cuda.max_memory_reserved() - base_r
    warm = len({(g.batch, g.m, g.w, g.u) for g in plan.groups})
    launches = expect_launches("config4 level", kernels, groups + warm,
                               False)
    rep, est = ex.report(), ex.device_estimate()
    mode = "offload_bytes" if ex.offload == "host" else "bytes"
    gemm_prec = ex.gemm_prec
    del ex
    _settled(torch)
    drift = _drift_moved(torch, fronts, stream_fronts)
    stream_fronts.clear()            # 12.5 GB of host memory
    level = dict(offload=rep["offload"], rule=rep["offload_rule"],
                 estimate=est, peak_allocated=peak, peak_reserved=peak_r,
                 limit_of_mode=est[mode], seconds=level_s,
                 graphs=rep["graphs"], capture_s=rep["capture_s"],
                 warm_up_s=rep["warm_up_s"], replay_s=rep["replay_s"],
                 offload_wait_s=rep["offload_wait_s"], tiny_pivots=tiny,
                 launches=launches, drift=drift,
                 drift_gate=float(tols.TF32_DRIFT))
    if rep["offload_rule"]["bytes"] != est["bytes"]:
        raise AssertionError(f"config4 level: the rule did not read the "
                             f"executor's estimate: {level}")
    if not peak <= est[mode]:
        raise AssertionError(f"config4 level: peak {peak} B above its "
                             f"{mode} {est[mode]} B")
    if not (drift["equal_to_stream"]
            or drift["max_rel_diff_vs_stream"] <= tols.TF32_DRIFT):
        raise AssertionError(f"config4 level: fronts vs the stream's: "
                             f"{drift}")
    # their factors solved on the card: the BERR of the level waves' run
    numeric = NumericFactorization(
        plan=plan, fronts=[(lp.to("cuda"), up.to("cuda"))
                           for lp, up in fronts],
        tiny_pivots=tiny, dtype=dt, gemm_prec=gemm_prec, executor=rep)
    del fronts
    kernels.reset_launches()
    xl, lul, stl, infol = slt.gssvx(slt.Options(fact=slt.Fact.FACTORED), a,
                                    b, lu=dataclasses.replace(lu2,
                                                              numeric=numeric))
    torch.cuda.synchronize()
    if infol != 0 or not np.all(np.isfinite(xl)):
        raise AssertionError(f"config4 level: solve failed: info={infol}")
    check_berr("config4 level", stl.solve_report.berr)
    level.update(berr=stl.solve_report.berr, refine_steps=stl.refine_steps,
                 solve_phase_s=stl.utime,
                 solve_launches=expect_launches("config4 level solve",
                                                kernels, 0, True))
    out["level_float32"] = level
    del numeric, xl, lul, lu2
    # fused and mega, float32: refused by name before anything runs
    for name in ("fused", "mega"):
        before = _settled(torch)
        mark = COMPILE_STATS.marker()
        kernels.reset_launches()
        t0 = time.perf_counter()
        try:
            slt.gssvx(slt.Options(fact=reuse, executor=name), a, b,
                      lu=skeleton)
        except DeviceMemoryError as e:
            err = e
        else:
            raise AssertionError(f"config4: {name} ran at n = 1,000,000")
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        census = COMPILE_STATS.records[mark:]
        rec = dict(error=type(err).__name__, executor=err.executor,
                   dtype=err.dtype, budget=err.budget, parts=err.parts,
                   offloads=err.offloads, remedies=err.remedies,
                   allocated_before=before, allocated_after=after,
                   census_records=len(census),
                   seconds=time.perf_counter() - t0,
                   launches=expect_launches(f"config4 {name}", kernels, 0,
                                            False))
        out[f"{name}_float32"] = rec
        if after != before or census:
            raise AssertionError(f"config4 {name}: the refusal allocated or "
                                 f"captured: {rec}")
    # the stream, float64: offloaded by the rule, or refused with its parts
    base = _settled(torch)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        x64, lu64, st64, info64 = slt.gssvx(
            slt.Options(fact=reuse, factor_dtype="float64"), a, b,
            lu=skeleton)
    except DeviceMemoryError as err:
        out["stream_float64"] = dict(
            outcome="refused", executor=err.executor, budget=err.budget,
            parts=err.parts, remedies=err.remedies,
            seconds=time.perf_counter() - t0)
        return out
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    rule = st64.executor["offload_rule"]
    rep = st64.solve_report
    route = lu64.solve_route
    if info64 != 0 or not np.all(np.isfinite(x64)):
        raise AssertionError(f"config4 float64: gssvx failed: info={info64}")
    check_berr("config4 float64", rep.berr)
    mode = "offload_bytes" if st64.executor["offload"] == "host" else "bytes"
    f64 = dict(outcome=st64.executor["offload"], rule=rule,
               solve_route=route, residual_route=rep.residual_route,
               peak_allocated=peak, limit_of_mode=rule[mode], wall_s=wall,
               fact_s=st64.utime["FACT"], solve_s=st64.utime["SOLVE"],
               refine_s=st64.utime["REFINE"], phase_s=st64.utime,
               offload_wait_s=st64.executor.get("offload_wait_s"),
               refine_steps=st64.refine_steps, berr=rep.berr,
               berr_history=rep.berr_history,
               rungs=[(r.name, r.detail) for r in rep.rungs],
               launches=expect_launches("config4 float64", kernels, groups,
                                        route == "device", panels))
    out["stream_float64"] = f64
    if not peak <= rule[mode]:
        raise AssertionError(f"config4 float64: peak {peak} B above its "
                             f"{mode} {rule[mode]} B")
    return out


ESTIMATE_NX = 32          # the graph executors' memory check: estimates of
                          # gigabytes in float64 on the closed plan, far
                          # above the process's fixed costs


def graph_estimates(slt, torch) -> dict:
    """The graph executors' device memory against the estimate the card's
    rule reads for each (``device_estimate``): mega and level waves on
    poisson3d(ESTIMATE_NX)'s closed plan in float64 (whose device solve
    aliases the factors, copying nothing), each called once on a card
    with nothing of the other left.  The peak allocated bytes, and the
    reserved bytes held after the call (the static pool, the graphs'
    private pools and the factors; the cache emptied), at or below the
    estimate; the graphs' pool growth at or below its graph part; the
    most reserved at any time beside them."""
    import gc
    from superlu_dist_tpu_torch.models.gallery import poisson3d
    from superlu_dist_tpu_torch.numeric.mega import MegaExecutor
    from superlu_dist_tpu_torch.numeric.stream import StreamExecutor
    lu, bvals, _ = slt.analyze(slt.Options(bucket_closed=True),
                               poisson3d(ESTIMATE_NX), device="cuda")
    plan, dt = lu.plan, torch.float64
    avals = torch.as_tensor(bvals)
    thresh = torch.tensor(np.sqrt(torch.finfo(dt).eps)
                          * max(lu.anorm, 1e-300), dtype=dt)
    out = {"n": plan.n, "groups": len(plan.groups), "dtype": "float64"}
    for name in ("mega", "level"):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base_a = torch.cuda.memory_allocated()
        base_r = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        ex = (MegaExecutor(plan, dt, "cuda") if name == "mega" else
              StreamExecutor(plan, dt, "cuda", granularity="level"))
        fronts, _ = ex(avals, thresh)
        torch.cuda.synchronize()
        peak_a = torch.cuda.max_memory_allocated() - base_a
        peak_r = torch.cuda.max_memory_reserved() - base_r
        torch.cuda.empty_cache()
        held_r = torch.cuda.memory_reserved() - base_r
        rep, est = ex.report(), ex.device_estimate()
        rec = dict(offload=ex.offload, rule=rep["offload_rule"],
                   estimate=est, peak_allocated=peak_a,
                   held_reserved=held_r, peak_reserved=peak_r,
                   graphs=rep["graphs"],
                   graph_device_bytes=rep["graph_device_bytes"])
        out[name] = rec
        if ex.offload != "none" or rep["offload_rule"]["bytes"] \
                != est["bytes"]:
            raise AssertionError(f"{name}: the rule did not read the "
                                 f"executor's estimate: {rec}")
        if not max(peak_a, held_r) <= est["bytes"] \
                or not rep["graph_device_bytes"] <= est["graph_bytes"]:
            raise AssertionError(f"{name}: device memory above the rule's "
                                 f"estimate: {rec}")
        del ex, fronts
    return out


#: the grid4 phase: a 2×2 grid of distinct cards (NCCL), one rank a card
GRID4_CARDS = 4
GRID4_TIMEOUT_S = 500    # the phase's limit inside the full run
GRID4_SMALL = (16, 25)   # the small captured legs' poisson3d edges
GRID4_GRAPHS = ("fused", "level", "mega")
GRID4_STALL_S = 150      # a rank still in one n = 1M leg after this long
                         # prints its threads' stacks (faulthandler)


def _grid4_executor(name, plan, dtype, grid):
    """Graph executor ``name`` of GRID4_GRAPHS on ``plan`` over ``grid``
    with the partitioned pool (level: ``MeshStreamExecutor(granularity=
    "level")``)."""
    from superlu_dist_tpu_torch.parallel.mesh_graphs import (
        MeshFusedExecutor, MeshMegaExecutor)
    from superlu_dist_tpu_torch.parallel.mesh_stream import (
        MeshStreamExecutor)
    if name == "fused":
        return MeshFusedExecutor(plan, dtype, grid.device, grid,
                                 pool_partition=True)
    if name == "mega":
        return MeshMegaExecutor(plan, dtype, grid.device, grid,
                                pool_partition=True, offload="none")
    return MeshStreamExecutor(plan, dtype, grid.device, grid,
                              pool_partition=True, offload="none",
                              granularity=name if name == "level"
                              else "group")


def _grid4_units(name, ex) -> int:
    """The unit graphs graph executor ``ex`` (of GRID4_GRAPHS ``name``)
    captures on NCCL: a group each (fused), a schedule wave (level), a
    closed key (mega)."""
    if name == "fused":
        return len(ex.plan.groups)
    if name == "level":
        return len(ex.units())
    return ex.closed_keys


def _grid4_call(ex, vals, thresh, dtype):
    """One call of grid executor ``ex``: (fronts, tiny count, seconds to
    the card's end, the shard)."""
    import torch
    real = torch.empty((), dtype=dtype).real.dtype
    torch.cuda.synchronize(ex.device)
    t0 = time.perf_counter()
    fronts, tiny, shard = ex(torch.as_tensor(np.asarray(vals)).to(dtype),
                             torch.tensor(thresh, dtype=real))
    torch.cuda.synchronize(ex.device)
    return fronts, int(tiny), time.perf_counter() - t0, shard


#: the census sites of the grid's group graphs (mesh_graphs.UNIT_SITE,
#: spmd.UNIT_SITE) and of the grid solver's sweep graphs
GRID4_UNIT_SITES = ("mesh_graphs.unit", "spmd.unit")
GRID4_SOLVE_SITE = "solve.spmd"


def _grid4_solves(fact, issued):
    """The grid solver on sharded factors ``fact`` (this rank's): its
    captured sweeps (``SpmdSolver`` on a capturable grid) against its
    eager ones (``fused=False``) at nrhs 1 and 4 — each twice, the first
    solve of a bucket capturing its two sweep graphs (census site
    solve.spmd) — x bit for bit, with the graphs, the retraces, the
    collectives each solve issued from the host and the seconds."""
    from superlu_dist_tpu_torch.numeric.stream import RETRACE_SENTINEL
    from superlu_dist_tpu_torch.obs.compilestats import COMPILE_STATS
    from superlu_dist_tpu_torch.parallel.spmd import SpmdSolver
    rhs = np.random.default_rng(SEED).standard_normal((fact.plan.n, 4))
    eager, graphs = SpmdSolver(fact, fused=False), SpmdSolver(fact)
    out = {}
    for k in (1, 4):
        want = eager.solve(rhs[:, :k])
        runs = []
        for _ in range(2):
            mark = (COMPILE_STATS.marker(), RETRACE_SENTINEL.total)
            issued[0] = 0
            t0 = time.perf_counter()
            x = graphs.solve(rhs[:, :k])
            runs.append(dict(
                s=time.perf_counter() - t0, issued=issued[0],
                graphs=sum(r.site == GRID4_SOLVE_SITE
                           for r in COMPILE_STATS.records[mark[0]:]),
                retraces=RETRACE_SENTINEL.total - mark[1],
                equal=bool(np.array_equal(x, want)),
                max_abs_diff=float(np.abs(x - want).max())))
        out[k] = runs
    return dict(fused=graphs.fused, graphs=len(graphs._graphs),
                graph_pool_bytes=graphs.graph_pool_bytes, nrhs=out)


def _grid4_spmd(grid, plan, vals, thresh, dtype, issued, two_d):
    """A small grid4 case's spmd legs on this rank: the eager spmd
    executor (``capture=False``), then the captured one's capturing call
    and a replay against it bit for bit — fronts, pivot stacks, tiny
    count — with the group graphs (census site spmd.unit), the retraces,
    the collectives each call issued from the host, the gathers, the
    launches; then the grid solver (``_grid4_solves``) on those shards and
    on the 2-D tier's (``two_d``, the eager 2-D executor's factors)."""
    import torch
    from superlu_dist_tpu_torch.numeric import kernels
    from superlu_dist_tpu_torch.numeric.factor import NumericFactorization
    from superlu_dist_tpu_torch.numeric.stream import RETRACE_SENTINEL
    from superlu_dist_tpu_torch.obs.compilestats import COMPILE_STATS
    from superlu_dist_tpu_torch.parallel.spmd import (UNIT_SITE,
                                                      SpmdFactorExecutor)

    def numeric(out):
        fronts, tiny, _, shard = out
        return NumericFactorization(plan=plan, fronts=fronts,
                                    tiny_pivots=tiny, dtype=dtype,
                                    shard=shard)
    eager = SpmdFactorExecutor(plan, dtype, grid.device, grid, capture=False)
    first = _grid4_call(eager, vals, thresh, dtype)
    want = numeric(first)
    ex = SpmdFactorExecutor(plan, dtype, grid.device, grid)
    calls = []
    for _ in range(2):
        mark = (COMPILE_STATS.marker(), RETRACE_SENTINEL.total,
                dict(kernels.LAUNCHES))
        issued[0] = 0
        call = _grid4_call(ex, vals, thresh, dtype)
        got = numeric(call)
        census = [r for r in COMPILE_STATS.records[mark[0]:]
                  if r.site == UNIT_SITE]
        calls.append(dict(
            s=call[2], tiny=got.tiny_pivots, issued=issued[0],
            equal=all(torch.equal(a, c) and torch.equal(b, d)
                      for (a, b), (c, d) in zip(got.fronts, want.fronts)),
            pivots=all(torch.equal(p, q) for p, q in
                       zip(got.shard.pivots, want.shard.pivots)),
            graphs=len(census), census_s=sum(r.seconds for r in census),
            retraces=RETRACE_SENTINEL.total - mark[1],
            gathers=ex.report()["gathers"],
            launches={k: v - mark[2][k] for k, v in kernels.LAUNCHES.items()}))
    rep = ex.report()
    return dict(eager_s=first[2], eager_tiny=first[1], calls=calls,
                capture=rep["capture"], graph_kind=rep.get("graph_kind"),
                graphs=rep.get("graphs"), warm_up_s=rep.get("warm_up_s"),
                capture_s=rep.get("capture_s"),
                instantiate_s=rep.get("instantiate_s"),
                gather_bytes=rep["gather_bytes"],
                solves={"spmd": _grid4_solves(got, issued),
                        "2d": _grid4_solves(two_d, issued)})


def grid4_small(tc, grid, nxs):
    """A rank of the grid4 phase's small legs (spawned, one card each):
    per poisson3d(nx) of ``nxs`` the eager 2-D executor (float32, the
    default tier, the partitioned pool), then each graph executor of
    GRID4_GRAPHS — its capturing call and a replay — against it bit for
    bit, with the graphs (census site mesh_graphs.unit) captured and
    replayed, the collectives the replay issued from the host, the
    retraces, the launches and the seconds; then the spmd tier
    (``_grid4_spmd``: the group graphs against the eager spmd executor,
    the grid solver's sweep graphs against its eager sweeps on the spmd
    and the 2-D shards)."""
    import torch
    import torch.distributed as dist
    import superlu_dist_tpu_torch as slt
    from superlu_dist_tpu_torch.models.gallery import poisson3d
    from superlu_dist_tpu_torch.numeric import kernels
    from superlu_dist_tpu_torch.numeric.stream import RETRACE_SENTINEL
    from superlu_dist_tpu_torch.obs.compilestats import COMPILE_STATS
    from superlu_dist_tpu_torch.numeric.factor import NumericFactorization
    from superlu_dist_tpu_torch.parallel.mesh_graphs import UNIT_SITE
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
        for nx in nxs:
            lu, bvals, _ = slt.analyze(slt.Options(), poisson3d(nx),
                                       device=grid.device)
            plan, dt = lu.plan, torch.float32
            thresh = float(np.sqrt(np.finfo(np.float32).eps) * lu.anorm)
            eager = _grid4_executor("stream", plan, dt, grid)
            want, tiny, eager_s, shard = _grid4_call(eager, bvals, thresh,
                                                     dt)
            recs = {"eager": dict(s=eager_s, tiny=tiny,
                                  comm=eager.report())}
            two_d = NumericFactorization(plan=plan, fronts=want,
                                         tiny_pivots=tiny, dtype=dt,
                                         shard=shard)
            for name in GRID4_GRAPHS:
                ex = _grid4_executor(name, plan, dt, grid)
                calls = []
                for _ in range(2):
                    mark = (COMPILE_STATS.marker(), RETRACE_SENTINEL.total,
                            dict(kernels.LAUNCHES))
                    issued[0] = 0
                    fronts, t, s, _ = _grid4_call(ex, bvals, thresh, dt)
                    census = COMPILE_STATS.records[mark[0]:]
                    drift = _drift_moved(torch, fronts, want)
                    calls.append(dict(
                        s=s, tiny=t, issued=issued[0],
                        equal=drift["equal_to_stream"],
                        drift=drift["max_rel_diff_vs_stream"],
                        graphs=sum(r.site == UNIT_SITE for r in census),
                        census_s=sum(r.seconds for r in census
                                     if r.site == UNIT_SITE),
                        retraces=RETRACE_SENTINEL.total - mark[1],
                        launches={k: v - mark[2][k]
                                  for k, v in kernels.LAUNCHES.items()}))
                rep = ex.report()
                recs[name] = dict(
                    calls=calls, units=_grid4_units(name, ex),
                    graph_kind=rep["graph_kind"], graphs=rep.get("graphs"),
                    warm_up_s=rep.get("warm_up_s"),
                    capture_s=rep.get("capture_s"),
                    instantiate_s=rep.get("instantiate_s"),
                    exchange_bytes=rep["exchange_bytes"],
                    bcast_bytes=rep["bcast_bytes"])
                del ex
                plan.__dict__.pop("_factor_fns", None)
            recs["spmd"] = _grid4_spmd(grid, plan, bvals, thresh, dt, issued,
                                       two_d)
            del two_d
            out[nx] = dict(groups=len(plan.groups), runs=recs)
    finally:
        for k, fn in real.items():
            setattr(dist, k, fn)
    return dict(backend=grid.backend, device=str(grid.device),
                capturable=grid.capturable, legs=out)


def _grid4_comm(grid, before) -> dict:
    """The grid's collectives since ``before`` (a ``comm_summary``), per
    op: calls, bytes, seconds."""
    now = grid.comm_summary()
    return {op: {k: rec[k] - before.get(op, {}).get(k, 0)
                 for k in ("calls", "bytes", "seconds")}
            for op, rec in now.items()}


def grid4_big(tc, grid, nx, legs, small=()):
    """A rank of the grid4 phase at the reference's own size (spawned,
    one card each; rank 0 the root): poisson3d(nx) and b = A·x_true from
    the seed, this rank's block rows.  With "one_card" in ``legs`` rank 0
    first runs gssvx(Options()) on its card alone — the one-card stream,
    whose x every leg is held against (else x_true is), and the analysis
    every leg shares (SamePattern_SameRowPerm on its skeleton: the root
    reuses it and broadcasts it, as ``_pgssvx_mesh`` does; else the
    first leg of each plan analyzes).  Then the legs of ``legs``, each one
    ``pgssvx(grid=)`` call: "spmd" (Options(), the grid's default path:
    the spmd tier, its groups and sweeps captured), "spmd_replay" (values
    × 1.5) and "spmd_factored" (a FACTORED solve at nrhs 16 on that
    handle, its first column b); then with Options(pool_partition=True):
    "stream" (the 2-D stream, float32), "fused" (the capturing call) and
    "replay"
    (values × 1.5) — the fused fronts held bit for bit against the
    stream's on this rank —, "float64" (the stream), "closed" (the
    stream on the closed plan, built on the root from the same symbolic
    factorization) and "closed_mega".  A leg the card's rule refuses
    records its DeviceMemoryError and the bytes allocated before and
    after.  Per leg and rank: FACT, SOLVE, REFINE, the graphs, capture
    and replay seconds, the gathers, the solve's sweep graphs and their
    capture seconds, the collectives per op, the rule's numbers
    (estimate, offloaded estimate, budget, choice), the peak, BERR, the
    launches; rank 0 also x's error against the one-card x.  With
    "small" in ``legs``, first the small legs of ``small`` on this grid
    (``grid4_small``), in ``out``'s "small"."""
    import dataclasses
    import faulthandler
    import gc
    import traceback
    import torch
    import superlu_dist_tpu_torch as slt
    from superlu_dist_tpu_torch.models.gallery import poisson3d
    from superlu_dist_tpu_torch.numeric import kernels
    from superlu_dist_tpu_torch.numeric.plan import build_plan
    from superlu_dist_tpu_torch.numeric.stream import RETRACE_SENTINEL
    from superlu_dist_tpu_torch.obs.compilestats import COMPILE_STATS
    from superlu_dist_tpu_torch.parallel.dist import distribute_rows
    from superlu_dist_tpu_torch.parallel.pgssvx import pgssvx
    from superlu_dist_tpu_torch.utils import tols
    from superlu_dist_tpu_torch.utils.errors import DeviceMemoryError
    dev, root = grid.device, grid.rank == 0
    t_start = time.perf_counter()
    first_small = grid4_small(tc, grid, small) if "small" in legs \
        else None
    a = poisson3d(nx)
    rng = np.random.default_rng(SEED)
    x_true = rng.standard_normal(a.n_rows)
    b = a.matvec(x_true)
    part = distribute_rows(a, grid.nproc)[grid.rank]
    b_loc = b[part.fst_row:part.fst_row + part.m_loc]
    out = {"legs": [], "setup_s": time.perf_counter() - t_start,
           "small": first_small}
    skeleton = None
    x_ref = x_true       # without the one-card run, x against x_true
    if root and "one_card" in legs:
        t0 = time.perf_counter()
        x_ref, lu0, st0, info0 = slt.gssvx(slt.Options(), a, b, device=dev)
        torch.cuda.synchronize(dev)
        out["one_card"] = dict(
            wall_s=time.perf_counter() - t0, info=info0,
            analysis_s=sum(st0.utime[p] for p in ANALYSIS),
            fact_s=st0.utime["FACT"], solve_s=st0.utime.get("SOLVE"),
            refine_s=st0.utime.get("REFINE"),
            berr=st0.solve_report.berr, offload=st0.executor["offload"],
            rule=st0.executor.get("offload_rule"),
            rel_error_inf=float(np.abs(x_ref - x_true).max()
                                / np.abs(x_true).max()))
        skeleton = dataclasses.replace(lu0, numeric=None, dev_solver=None,
                                       dev_spmv=None, berrs=None)
        del lu0
        gc.collect()
        torch.cuda.empty_cache()
    same = slt.Fact.SamePattern_SameRowPerm

    def settle():
        gc.collect()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        return torch.cuda.memory_allocated(dev)

    def leg(name, opts, a_loc, lu, scale=1.0, may_refuse=False, rhs=None):
        """One pgssvx(grid=) call and its record; ``rhs`` (this rank's
        block rows of b, the x it is held against) in place of the one
        right-hand side and x_ref."""
        b_leg, x_want = (b_loc, x_ref) if rhs is None else rhs[:2]
        held = settle()
        torch.cuda.reset_peak_memory_stats(dev)
        mark = (COMPILE_STATS.marker(), RETRACE_SENTINEL.total,
                dict(kernels.LAUNCHES), grid.comm_summary())
        lu_out = {}
        rec = {"leg": name, "held_bytes": held}
        t0 = time.perf_counter()
        # a rank that stalls in a leg prints where every thread of it is
        faulthandler.dump_traceback_later(GRID4_STALL_S)
        try:
            x, info = pgssvx(tc, opts, a_loc, b_leg, grid=grid, lu=lu,
                             lu_out=lu_out)
        except DeviceMemoryError as e:
            faulthandler.cancel_dump_traceback_later()
            rec.update(refused=dict(
                executor=e.executor, dtype=e.dtype, budget=e.budget,
                parts=e.parts, remedies=e.remedies, offloads=e.offloads),
                after_bytes=settle(), seconds=time.perf_counter() - t0,
                launches={k: v - mark[2][k]
                          for k, v in kernels.LAUNCHES.items()})
            out["legs"].append(rec)
            if not may_refuse:
                raise AssertionError(f"grid4 {name}: refused: {e}")
            return None
        except BaseException:
            # the peers may wait for this rank in a collective: say why now
            traceback.print_exc()
            sys.stderr.flush()
            raise
        torch.cuda.synchronize(dev)
        faulthandler.cancel_dump_traceback_later()
        lu2, st = lu_out["lu"], lu_out["stats"]
        t, rep = lu_out["timings"], lu_out["solve_report"]
        ex = lu2.numeric.executor
        census = COMPILE_STATS.records[mark[0]:]
        sweeps = [r for r in census if r.site == GRID4_SOLVE_SITE]
        rec.update(
            wall_s=time.perf_counter() - t0, info=info,
            executor=ex["executor"], dtype=str(lu2.numeric.dtype)[6:],
            offload=ex["offload"], rule=ex.get("offload_rule"),
            on_host=lu2.numeric.on_host, solve_route=rep.solve_route,
            residual_route=rep.residual_route,
            analysis_s=t.get("analysis_s"), fact_s=t.get("fact_s"),
            solve_s=t.get("solve_s"), refine_s=t.get("refine_s"),
            refine_steps=rep.refine_steps, berr=rep.berr,
            rungs=[(r.name, r.detail) for r in rep.rungs],
            peak_bytes=t.get("peak_bytes"), base_bytes=t.get("base_bytes"),
            fact_peak_bytes=t.get("fact_peak_bytes"),
            pool_bytes=ex.get("pool_bytes"), graphs=ex.get("graphs"),
            graph_kind=ex.get("graph_kind"),
            warm_up_s=ex.get("warm_up_s"), capture_s=ex.get("capture_s"),
            instantiate_s=ex.get("instantiate_s"),
            graph_device_bytes=ex.get("graph_device_bytes"),
            closed_keys=ex.get("closed_keys"),
            units=sum(r.site in GRID4_UNIT_SITES for r in census),
            gather_bytes=ex.get("gather_bytes"), gathers=ex.get("gathers"),
            solve_graphs=len(sweeps),
            solve_capture_s=sum(r.seconds for r in sweeps),
            solve_graphs_held=(lu2.dev_solver.memory_stats()["graphs"]
                               if lu2.dev_solver is not None else None),
            nrhs=int(np.shape(b_leg)[1]) if np.ndim(b_leg) > 1 else 1,
            retraces=RETRACE_SENTINEL.total - mark[1],
            launches={k: v - mark[2][k] for k, v in kernels.LAUNCHES.items()},
            comm=_grid4_comm(grid, mark[3]),
            groups=len(lu2.plan.groups), closed=bool(lu2.plan.closed))
        rule = rec["rule"] or {}
        if rule.get("bytes") and rec["peak_bytes"] is not None:
            # what the leg took beyond what it found, against the rule
            rec["peak_vs_estimate"] = ((rec["peak_bytes"] - rec["base_bytes"])
                                       / rule["bytes"])
        if root:
            err = np.abs(np.reshape(x, np.shape(x_want)) * scale - x_want)
            rec["x_against"] = ("one card" if skeleton is not None
                                else "x_true") if rhs is None else rhs[2]
            rec.update(max_abs_err_vs_one_card=float(err.max()),
                       within_device_vs_host=bool(np.all(
                           err <= tols.DEVICE_VS_HOST_ATOL
                           + tols.DEVICE_VS_HOST_RTOL * np.abs(x_want))))
        out["legs"].append(rec)
        if root:
            say("grid4_rank0", **{k: v for k, v in rec.items()
                                  if k != "comm"})
        return lu2

    opts = dict(executor="stream", pool_partition=True)
    # without the one-card run the first leg of each plan analyzes
    first = same if "one_card" in legs else slt.Fact.DOFACT

    def skeleton_of(lu):
        """A leg's handle without its factors, solver and the plan's
        executors (the grid's graphs and pools): what the next leg
        reuses, all else off the card."""
        lu.plan.__dict__.pop("_factor_fns", None)
        return dataclasses.replace(lu, numeric=None, dev_solver=None,
                                   dev_spmv=None, berrs=None)

    lu, base = skeleton, None
    if "spmd" in legs:
        # the grid's default path: Options() is the spmd tier, each
        # group's program and each solve sweep one graph with its
        # collectives inside
        done = leg("spmd float32 capture", slt.Options(fact=first), part,
                   lu)
        scale, a_spmd = 1.0, part
        if "spmd_replay" in legs:
            # the same plan: its cached spmd executor replays
            a_spmd = dataclasses.replace(part, data=part.data * 1.5)
            done = leg("spmd float32 replay x1.5", slt.Options(fact=same),
                       a_spmd, done, scale=1.5)
            scale = 1.5
        if "spmd_factored" in legs:
            # FACTORED at nrhs 16 on that handle: its first column is b
            # (held against the one-card x), the others A·x_true's
            import scipy.sparse
            x16 = np.random.default_rng(SEED + 1).standard_normal(
                (a.n_rows, 16))
            # this rank's block rows of A·x16
            b16 = scipy.sparse.csr_matrix(
                (part.data, part.indices, part.indptr),
                shape=(part.m_loc, a.n_rows)) @ x16
            x16[:, 0] = x_ref
            b16[:, 0] = b_loc
            against = ("one card (column 0), x_true (columns 1-15)"
                       if skeleton is not None else "x_true")
            done = leg("spmd FACTORED nrhs 16", slt.Options(
                fact=slt.Fact.FACTORED), a_spmd, done, scale=scale,
                rhs=(b16, x16, against))
            del x16, b16
        lu = skeleton_of(done)
        del done
    if "stream" in legs:
        done = leg("stream float32", slt.Options(
            fact=same if lu is not None else first, **opts), part, lu)
        # its fronts wait in host memory for the fused ones
        base = [(lp.cpu(), up.cpu()) for lp, up in done.numeric.fronts]
        lu = skeleton_of(done)
        del done
    if "fused" in legs:
        done = leg("fused float32 capture", slt.Options(
            fact=same if lu is not None else first, executor="fused",
            pool_partition=True), part, lu)
        if base is not None:
            drift = _drift_moved(torch, done.numeric.fronts, base)
            out["legs"][-1].update(
                fronts_equal_stream=drift["equal_to_stream"],
                drift_vs_stream=drift["max_rel_diff_vs_stream"])
        if "replay" in legs:
            # the same plan: its cached fused executor replays
            p15 = dataclasses.replace(part, data=part.data * 1.5)
            done = leg("fused float32 replay x1.5", slt.Options(
                fact=same, executor="fused", pool_partition=True), p15,
                done, scale=1.5)
        lu = skeleton_of(done)
        del done
    del base
    if "float64" in legs:
        done = leg("stream float64", slt.Options(
            fact=same if lu is not None else first, factor_dtype="float64",
            **opts), part, lu)
        lu = skeleton_of(done)
        del done
    closed, fact = None, first
    if root and lu is not None and ("closed" in legs
                                    or "closed_mega" in legs):
        # the closed plan from the same symbolic factorization
        o = dataclasses.replace(lu.options, bucket_closed=True)
        t0 = time.perf_counter()
        plan = build_plan(lu.sf, min_bucket=o.min_bucket,
                          growth=o.bucket_growth, schedule=o.schedule,
                          window=o.sched_window, align=o.sched_align,
                          closed=True, max_keys=o.bucket_keys,
                          native=o.native)
        out["closed_plan_s"] = time.perf_counter() - t0
        closed = dataclasses.replace(lu, plan=plan, options=o)
    if lu is not None:
        fact = same
    del lu
    if "closed" in legs:
        done = leg("closed stream float32", slt.Options(
            fact=fact, bucket_closed=True, **opts), part, closed)
        closed, fact = skeleton_of(done), same
        del done
    if "closed_mega" in legs:
        done = leg("closed mega float32", slt.Options(
            fact=fact, bucket_closed=True, executor="mega",
            pool_partition=True), part, closed, may_refuse=True)
        del done
    out["seconds"] = time.perf_counter() - t_start
    return out


def _grid4_check_small(shape, out, drift) -> None:
    """The small legs' checks on every rank: NCCL, one graph a unit —
    fused a group, level a wave, mega a closed key — recorded once at the
    capture and never at the replay, no retrace, no collective issued
    from the host at the replay, fronts and tiny counts bit for bit the
    eager 2-D executor's (mega's within ``drift``, TF32_DRIFT: it runs a
    group at its key's padded rows, where cuBLAS takes another kernel)."""
    for r, rank in out.items():
        if rank["backend"] != "nccl" or not rank["capturable"]:
            raise AssertionError(f"grid4 {shape} rank {r}: backend "
                                 f"{rank['backend']}")
        for nx, legs in rank["legs"].items():
            tiny = legs["runs"]["eager"]["tiny"]
            for name in GRID4_GRAPHS:
                rec = legs["runs"][name]
                cap, rep = rec["calls"]
                where = f"grid4 {shape} poisson3d({nx}) {name} rank {r}"
                if rec["graph_kind"] != "unit" or rec["graphs"] != rec["units"]:
                    raise AssertionError(f"{where}: {rec['graphs']} graphs "
                                         f"of kind {rec['graph_kind']} for "
                                         f"{rec['units']} units")
                if name == "fused" and rec["units"] != legs["groups"]:
                    raise AssertionError(f"{where}: {rec['units']} units "
                                         f"for {legs['groups']} groups")
                if (cap["graphs"], rep["graphs"]) != (rec["units"], 0) \
                        or cap["retraces"] or rep["retraces"]:
                    raise AssertionError(f"{where}: census {cap} / {rep}")
                if rep["issued"]:
                    raise AssertionError(f"{where}: the replay issued "
                                         f"{rep['issued']} collectives")
                near = all(c["equal"] or (name == "mega"
                                          and c["drift"] <= drift)
                           for c in (cap, rep))
                if not near or (cap["tiny"], rep["tiny"]) != (tiny, tiny):
                    raise AssertionError(f"{where}: fronts or tiny count "
                                         f"differ from the eager 2-D run")
            _grid4_check_spmd(f"grid4 {shape} poisson3d({nx}) spmd rank {r}",
                              legs["runs"]["spmd"], legs["groups"])


def _grid4_check_spmd(where, rec, groups) -> None:
    """A small leg's spmd checks on one rank: one graph a group, recorded
    at the capture and never at the replay, no retrace, no collective
    issued from the host at the replay; fronts, pivot stacks and tiny
    count bit for bit the eager spmd executor's at both calls; the grid
    solver's sweeps captured on the spmd and the 2-D shards, two graphs
    at a bucket's first solve and none at its second, which issues no
    collective from the host, x bit for bit the eager sweeps'."""
    cap, rep = rec["calls"]
    if not rec["capture"] or rec["graph_kind"] != "unit" \
            or rec["graphs"] != groups:
        raise AssertionError(f"{where}: {rec['graphs']} graphs of kind "
                             f"{rec['graph_kind']} for {groups} groups")
    if (cap["graphs"], rep["graphs"]) != (groups, 0) or cap["retraces"] \
            or rep["retraces"] or rep["issued"]:
        raise AssertionError(f"{where}: census, retraces or host "
                             f"collectives {cap} / {rep}")
    for c in (cap, rep):
        if not (c["equal"] and c["pivots"]) or c["tiny"] != rec["eager_tiny"]:
            raise AssertionError(f"{where}: fronts, pivots or tiny count "
                                 f"differ from the eager spmd run: {c}")
    for tier, sol in rec["solves"].items():
        for k, (first, second) in sol["nrhs"].items():
            if not sol["fused"] or first["graphs"] != 2 or second["graphs"] \
                    or second["issued"] or first["retraces"] \
                    or second["retraces"]:
                raise AssertionError(f"{where} {tier} solve nrhs {k}: "
                                     f"{first} / {second}")
            if not (first["equal"] and second["equal"]):
                raise AssertionError(f"{where} {tier} solve nrhs {k}: x "
                                     f"differs from the eager sweeps' by "
                                     f"{first['max_abs_diff']} / "
                                     f"{second['max_abs_diff']}")


def _grid4_check_big(out, target) -> None:
    """The n = 1M legs' checks: every leg ran or was refused by name
    before it allocated anything; a leg that ran has info 0 on every
    rank, the same x, BERR at the target, x within DEVICE_VS_HOST of the
    one-card x, the factors and solves on the cards (no offload), its
    solves through the grid solver's sweep graphs, its residuals through
    csr_spmv, and on every rank the bytes it took at its peak at or
    below the card's rule's estimate; the captured fused fronts are the
    stream's bit for bit; the spmd capture holds one graph a group and
    its first solve two sweep graphs; a replay or a FACTORED solve
    captures no group."""
    ranks = sorted(out)
    for i, rec0 in enumerate(out[0]["legs"]):
        name = rec0["leg"]
        recs = [out[r]["legs"][i] for r in ranks]
        refused = [("refused" in rec) for rec in recs]
        if any(refused):
            if not all(refused) or name != "closed mega float32":
                raise AssertionError(f"grid4 {name}: refused on ranks "
                                     f"{[r for r, f in zip(ranks, refused) if f]}")
            for rec in recs:
                if rec["after_bytes"] != rec["held_bytes"] \
                        or any(rec["launches"].values()):
                    raise AssertionError(f"grid4 {name}: the refusal "
                                         f"allocated or launched: {rec}")
            continue
        for r, rec in zip(ranks, recs):
            if rec["info"] != 0:
                raise AssertionError(f"grid4 {name} rank {r}: info "
                                     f"{rec['info']}")
            if rec["offload"] != "none" or rec["on_host"] \
                    or rec["solve_route"] != "device" \
                    or rec["residual_route"] != "device":
                raise AssertionError(f"grid4 {name} rank {r}: offload "
                                     f"{rec['offload']}, solve "
                                     f"{rec['solve_route']}, residual "
                                     f"{rec['residual_route']}")
            if rec["retraces"]:
                raise AssertionError(f"grid4 {name} rank {r}: "
                                     f"{rec['retraces']} retraces")
            if rec.get("peak_vs_estimate", 0.0) > 1.0:
                raise AssertionError(f"grid4 {name} rank {r}: peak "
                                     f"{rec['peak_bytes']:,} B from "
                                     f"{rec['base_bytes']:,} B over the "
                                     f"estimate {rec['rule']['bytes']:,} B")
            if rec["launches"]["csr_spmv"] < 2 * rec["refine_steps"]:
                raise AssertionError(f"grid4 {name} rank {r}: "
                                     f"{rec['launches']['csr_spmv']} "
                                     f"csr_spmv launches")
            if not rec["solve_graphs_held"]:
                raise AssertionError(f"grid4 {name} rank {r}: the grid "
                                     f"solve ran without its sweep graphs")
        check_berr(f"grid4 {name}", rec0["berr"], target)
        if not rec0["within_device_vs_host"]:
            raise AssertionError(f"grid4 {name}: x vs the one-card x: max "
                                 f"{rec0['max_abs_err_vs_one_card']}")
        if name.startswith("fused") and name.endswith("capture"):
            for r, rec in zip(ranks, recs):
                if rec["graph_kind"] != "unit" or not rec["units"]:
                    raise AssertionError(f"grid4 {name} rank {r}: "
                                         f"{rec['units']} unit graphs")
                if not rec.get("fronts_equal_stream", False):
                    raise AssertionError(f"grid4 {name} rank {r}: fronts "
                                         f"differ from the stream's: "
                                         f"{rec.get('drift_vs_stream')}")
        if name.startswith("spmd") and name.endswith("capture"):
            for r, rec in zip(ranks, recs):
                if rec["graph_kind"] != "unit" \
                        or rec["units"] != rec["groups"] \
                        or rec["solve_graphs"] != 2:
                    raise AssertionError(
                        f"grid4 {name} rank {r}: {rec['units']} group "
                        f"graphs of kind {rec['graph_kind']} for "
                        f"{rec['groups']} groups, {rec['solve_graphs']} "
                        f"sweep graphs")
        if "replay" in name or "FACTORED" in name:
            for r, rec in zip(ranks, recs):
                if rec["units"]:
                    raise AssertionError(f"grid4 {name} rank {r}: "
                                         f"{rec['units']} captures")


def grid4_only() -> int:
    """``python3 chip_smoke.py grid4``: the grid on distinct cards, one
    spawned rank a card over NCCL (the full run starts it as a child
    right after config4 where four cards are visible).  Fewer than four
    cards: exits 2 naming the count, nothing run.  First the small legs
    (``grid4_small``: poisson3d(16) and (25) on a 1×2 and a 2×2 grid,
    fused, level and mega with their collectives captured, one graph a
    unit, against the eager 2-D executor; the spmd executor, one graph a
    group, against the eager spmd executor, and the grid solver's sweep
    graphs against its eager sweeps), then the reference's own size
    (``grid4_big``: poisson3d(100), n = 1,000,000, on the 2×2 grid: the
    one-card stream; the grid's default path, Options() — the spmd tier
    captured — with a SamePattern × 1.5 replay and a FACTORED solve at
    nrhs 16 on its handle; with the partitioned pool the 2-D stream and
    the captured fused in float32 with a SamePattern × 1.5 replay,
    float64, the closed plan with the stream and mega); a grid4_leg line
    a leg, a grid4 line, the card line.  ``python3 chip_smoke.py grid4
    LEGS SECONDS`` runs the legs named (of "small", "one_card", "spmd",
    "spmd_replay", "spmd_factored", "stream", "fused", "replay",
    "float64", "closed", "closed_mega") within SECONDS."""
    import torch
    from superlu_dist_tpu_torch import native
    from superlu_dist_tpu_torch.numeric import kernels
    from superlu_dist_tpu_torch.testing.ranks import run_mesh_ranks
    from superlu_dist_tpu_torch.utils import tols
    count = torch.cuda.device_count()
    if count < GRID4_CARDS:
        print(f"chip_smoke grid4: needs {GRID4_CARDS} cards, {count} "
              f"visible", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = card_line()
    kernels.build()
    native.build()
    legs = sys.argv[2].split(",") if len(sys.argv) > 2 else [
        "small", "one_card", "spmd", "spmd_replay", "spmd_factored",
        "stream", "fused", "replay", "float64", "closed", "closed_mega"]
    limit = float(sys.argv[3]) if len(sys.argv) > 3 else GRID4_TIMEOUT_S
    target = float(tols.berr_target(np.float64))

    def small_lines(shape, out, seconds):
        _grid4_check_small(shape, out, tols.TF32_DRIFT)
        for nx in GRID4_SMALL:
            say("grid4_leg", leg=f"{shape[0]}x{shape[1]} poisson3d({nx})",
                seconds=seconds, ranks={
                    r: dict(device=rank["device"],
                            **rank["legs"][nx]["runs"])
                    for r, rank in out.items()})
    if "small" in legs:
        t0 = time.perf_counter()
        small_lines((1, 2), run_mesh_ranks(2, grid4_small, GRID4_SMALL,
                                           device="cuda", timeout=300),
                    time.perf_counter() - t0)
    # the 2×2 small legs run first on the n = 1M legs' grid
    t0 = time.perf_counter()
    out = run_mesh_ranks(GRID4_CARDS, grid4_big, CONFIG4_NX, legs,
                         GRID4_SMALL, device="cuda", nprow=2, timeout=limit,
                         max_len=1 << 20, timeout_s=limit)
    if "small" in legs:
        small_lines((2, 2), {r: rec["small"] for r, rec in out.items()},
                    out[0]["setup_s"])
    if "one_card" in out[0]:
        say("grid4_leg", leg="one card (rank 0)", **out[0]["one_card"])
    for i, rec0 in enumerate(out[0]["legs"]):
        say("grid4_leg", leg=rec0["leg"], ranks={
            r: {k: v for k, v in out[r]["legs"][i].items() if k != "leg"}
            for r in sorted(out)})
    _grid4_check_big(out, target)
    say("grid4", seconds=time.perf_counter() - t_start, cards=count,
        big_s=time.perf_counter() - t0,
        rank_seconds={r: rec["seconds"] for r, rec in out.items()},
        closed_plan_s=out[0].get("closed_plan_s"), nvidia_smi=card)
    print(card)
    return 0


def first_solve_only(label: str) -> int:
    """``python3 chip_smoke.py first_solve [LABEL]``: the build, then gssvx
    on poisson3d(48) twice (phase seconds and wall; the first in the
    process is the main path's), then the handle's first solve — a new
    DeviceSolver (panels gathered, DiagInv, two graph captures, the
    replays) — FIRST_SOLVE_REPS times.  Each solve's DeviceSolver
    construction and each capture are timed (synchronized) apart.  Where
    the tree has ``ops.dense.MATH_LOCK``, the same first solve again with
    captures in torch's global error mode, and with that lock taken away;
    a LABEL ending in ``-global`` puts every capture of the process in the
    global mode from the start.  It needs no more of the package than
    gssvx, solve_factored and DeviceSolver, so a copy of this script
    beside an older checkout times that checkout's path: run parent and
    change alternately in one call to compare them."""
    import contextlib
    import torch
    import superlu_dist_tpu_torch as slt
    from superlu_dist_tpu_torch.models.gallery import poisson3d
    from superlu_dist_tpu_torch.numeric import kernels
    from superlu_dist_tpu_torch.ops import dense
    from superlu_dist_tpu_torch.solve import device as solve_device
    card = card_line()
    kernels.library()
    marks = []

    def timed(name, fn):
        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.synchronize()
                marks.append((name, time.perf_counter() - t0))
        return wrapper

    def split():
        # the construction and capture seconds marked since the last call
        rec = dict(construct_s=sum(t for n, t in marks if n == "construct"),
                   captures_s=[t for n, t in marks if n == "capture"])
        marks.clear()
        return rec

    solver_cls = solve_device.DeviceSolver
    solver_cls.__init__ = timed("construct", solver_cls.__init__)
    solver_cls._capture = timed("capture", solver_cls._capture)
    begin = torch.cuda.CUDAGraph.capture_begin

    def global_mode(self, pool=None, capture_error_mode="global"):
        return begin(self, pool=pool, capture_error_mode="global")

    if label.endswith("-global"):
        torch.cuda.CUDAGraph.capture_begin = global_mode
    a = poisson3d(NX)
    b = a.matvec(np.random.default_rng(SEED).standard_normal(a.n_rows))
    out = {"label": label, "gssvx": []}
    for _ in range(2):
        _, lu, st, sec = timed_gssvx(slt, kernels, slt.Options(), a, b,
                                     device="cuda")
        out["gssvx"].append(dict(wall_s=sec, **st.utime, **split()))
        del lu
    _, lu, _, _ = timed_gssvx(slt, kernels, slt.Options(), a, b,
                              device="cuda")
    split()

    def first_solves():
        recs = []
        for _ in range(FIRST_SOLVE_REPS):
            lu.dev_solver = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lu.solve_factored(b)
            torch.cuda.synchronize()
            recs.append(dict(s=time.perf_counter() - t0, **split()))
        return recs

    out["first_solve"] = first_solves()
    if hasattr(dense, "MATH_LOCK") and not label.endswith("-global"):
        torch.cuda.CUDAGraph.capture_begin = global_mode
        try:
            out["first_solve_global_capture"] = first_solves()
        finally:
            torch.cuda.CUDAGraph.capture_begin = begin
        lock, dense.MATH_LOCK = dense.MATH_LOCK, contextlib.nullcontext()
        try:
            out["first_solve_no_math_lock"] = first_solves()
        finally:
            dense.MATH_LOCK = lock
    say("first_solve", n=a.n_rows, **out)
    print(card)
    return 0


def serve_only() -> int:
    """``python3 chip_smoke.py serve``: the build, gssvx on poisson3d(48),
    its bundle and the serve phase only (a quicker check of the serving
    tier; the full script runs every phase)."""
    import torch
    import superlu_dist_tpu_torch as slt
    from superlu_dist_tpu_torch.models.gallery import poisson3d
    from superlu_dist_tpu_torch.numeric import kernels
    from superlu_dist_tpu_torch.utils import tols
    card = card_line()
    say("card", nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda)
    kernels.library()
    a = poisson3d(NX)
    b = a.matvec(np.random.default_rng(SEED).standard_normal(a.n_rows))
    x, lu, stats, info = slt.gssvx(slt.Options(), a, b, device="cuda")
    say("gssvx", n=a.n_rows, fact_s=stats.utime["FACT"],
        berr=stats.solve_report.berr)
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    try:
        bundle = os.path.join(workdir, "handle")
        slt.save_lu(lu, bundle)
        a_sm = poisson3d(NX_SMALL)
        _, lu_sm, _, _ = slt.gssvx(slt.Options(), a_sm, np.ones(a_sm.n_rows),
                                  device="cuda")
        serve_phase(slt, a, lu, bundle, a_sm, lu_sm, kernels, tols, torch,
                    workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(card)
    return 0


def panel_only() -> int:
    """``python3 chip_smoke.py panel``: the build, the main path's analysis
    (poisson3d(48)) and the panel LU kernel alone: against the plain loop
    at the largest panel in every type and on the sentinel panels
    (``panel_phase``), the FACT's device profile (``factor_profile``,
    after one FACT to warm up) and every panel of one FACT replayed in
    float32 (``panel_sums``).  A quicker check of csrc/panel_lu.cu than
    the whole script."""
    import torch
    import superlu_dist_tpu_torch as slt
    from superlu_dist_tpu_torch.models.gallery import poisson3d
    from superlu_dist_tpu_torch.numeric import factor, kernels
    card = card_line()
    say("card", nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda)
    t0 = time.perf_counter()
    lib = kernels.build()
    kernels.library()
    say("build", seconds=time.perf_counter() - t0, library=str(lib))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    lu0, bvals0, _ = slt.analyze(slt.Options(), poisson3d(NX), device="cuda")
    plan = lu0.plan
    panel_phase(plan, torch, kernels, gen)
    kernels.reset_launches()
    factor.numeric_factorize(plan, bvals0, lu0.anorm, dtype=torch.float32,
                             device="cuda")
    torch.cuda.synchronize()
    if kernels.LAUNCHES["panel_lu"] != len(plan_panels(plan)):
        raise AssertionError(f"{kernels.LAUNCHES['panel_lu']} panel_lu "
                             f"launches in one factorization, expected "
                             f"{len(plan_panels(plan))}")
    say("factor_profile", **factor_profile(plan, bvals0, lu0.anorm, torch,
                                           factor))
    say("panel_sums", float32=panel_sums(plan, torch, kernels, gen,
                                         torch.float32))
    print(card)
    return 0


def persist_only() -> int:
    """``python3 chip_smoke.py persist``: the build, gssvx on poisson3d(48)
    and the persist phase only (a quicker check of save / load and of
    the deadline and resume; the full script runs every phase)."""
    import torch
    import superlu_dist_tpu_torch as slt
    from superlu_dist_tpu_torch.models.gallery import poisson3d
    from superlu_dist_tpu_torch.numeric import kernels
    from superlu_dist_tpu_torch.utils import tols
    card = card_line()
    say("card", nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda)
    kernels.library()
    a = poisson3d(NX)
    b = a.matvec(np.random.default_rng(SEED).standard_normal(a.n_rows))
    x, lu, stats, info = slt.gssvx(slt.Options(), a, b, device="cuda")
    say("gssvx", n=a.n_rows, fact_s=stats.utime["FACT"],
        berr=stats.solve_report.berr)
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    try:
        persist_phase(slt, a, b, lu, kernels, tols, torch, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(card)
    return 0


def pgssvx_only() -> int:
    """``python3 chip_smoke.py pgssvx``: the build, gssvx on poisson3d(48)
    and the pgssvx phase only (a quicker check of the distributed
    driver; the full script runs every phase)."""
    import torch
    import superlu_dist_tpu_torch as slt
    from superlu_dist_tpu_torch.models.gallery import poisson3d
    from superlu_dist_tpu_torch.numeric import kernels
    from superlu_dist_tpu_torch.utils import tols
    card = card_line()
    say("card", nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda)
    a = poisson3d(NX)
    peers = start_peers(slt)
    kernels.library()
    b = a.matvec(np.random.default_rng(SEED).standard_normal(a.n_rows))
    x, lu, stats, info = slt.gssvx(slt.Options(), a, b, device="cuda")
    say("gssvx", n=a.n_rows, fact_s=stats.utime["FACT"],
        berr=stats.solve_report.berr)
    del lu
    pgssvx_phase(slt, peers, kernels, tols, torch)
    print(card)
    return 0


def mesh_only() -> int:
    """``python3 chip_smoke.py mesh``: the build, gssvx on poisson3d(48)
    and the mesh phase only (a quicker check of the mesh tier; the full
    script runs every phase)."""
    import torch
    import superlu_dist_tpu_torch as slt
    from superlu_dist_tpu_torch.models.gallery import poisson3d
    from superlu_dist_tpu_torch.numeric import kernels
    from superlu_dist_tpu_torch.utils import tols
    card = card_line()
    say("card", nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda)
    kernels.library()
    mesh_peer = start_mesh_peer(slt)
    a = poisson3d(NX)
    b = a.matvec(np.random.default_rng(SEED).standard_normal(a.n_rows))
    x, lu, stats, info = slt.gssvx(slt.Options(), a, b, device="cuda")
    say("gssvx", n=a.n_rows, fact_s=stats.utime["FACT"],
        berr=stats.solve_report.berr, tiny_pivots=stats.tiny_pivots)
    mesh_phase(slt, a, lu, x, stats.tiny_pivots, mesh_peer, kernels, tols,
               torch)
    print(card)
    return 0


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
    a_sm = poisson3d(NX_SMALL)
    _, lu_sm, _, _ = slt.gssvx(slt.Options(), a_sm, np.ones(a_sm.n_rows),
                              device="cuda")
    executors_phase(slt, a, lu, kernels, tols, torch, factor, a_sm, lu_sm)
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
    if sys.argv[1:2] == ["serve"]:
        return serve_only()
    if sys.argv[1:2] == ["pgssvx"]:
        return pgssvx_only()
    if sys.argv[1:2] == ["mesh"]:
        return mesh_only()
    if sys.argv[1:2] == ["entry"]:
        return entry_only()
    if sys.argv[1:2] == ["persist"]:
        return persist_only()
    if sys.argv[1:2] == ["panel"]:
        return panel_only()
    if sys.argv[1:2] == ["first_solve"]:
        return first_solve_only(sys.argv[2] if len(sys.argv) > 2 else "")
    if sys.argv[1:2] == ["trace"]:
        return trace_only()
    if sys.argv[1:2] == ["audit"]:
        return audit_only()
    if sys.argv[1:2] == ["config4"]:
        return config4_only()
    if sys.argv[1:2] == ["grid4"]:
        return grid4_only()
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
    lint_phase()

    # 2. build: the host library's g++ beside the kernels' nvcc
    t0 = time.perf_counter()
    host_build = {}

    def build_host():
        t = time.perf_counter()
        try:
            native.build()
        except BaseException as e:      # re-raised by native_phase's build
            host_build["error"] = e
        host_build["s"] = time.perf_counter() - t
    builder = threading.Thread(target=build_host)
    builder.start()
    lib = kernels.build()
    kernels.library()
    builder.join()
    say("build", seconds=time.perf_counter() - t0, library=str(lib),
        host_library_s=host_build["s"])
    native_phase()
    # the main path at the reference's own size, in a process of its own
    # on an empty card (this one has touched no tensor on it yet)
    t0 = time.perf_counter()
    rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                         "config4"], timeout=CONFIG4_TIMEOUT_S).returncode
    if rc != 0:
        raise AssertionError(f"the config4 phase exited {rc}")
    say("config4_child", seconds=time.perf_counter() - t0)
    # the grid on distinct cards, in a process of its own, where there
    # are four cards; with fewer, it does not run (nothing is checked)
    count = torch.cuda.device_count()
    if count >= GRID4_CARDS:
        t0 = time.perf_counter()
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "grid4"], timeout=GRID4_TIMEOUT_S + 60).returncode
        if rc != 0:
            raise AssertionError(f"the grid4 phase exited {rc}")
        say("grid4_child", seconds=time.perf_counter() - t0)
    else:
        say("grid4", ran=False, cards=count,
            reason=f"needs {GRID4_CARDS} cards, {count} visible: not run")

    # 3. kernels, at the shapes of the main path's plan
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    a = poisson3d(NX)
    # the distributed and mesh phases' peer ranks start now: their imports
    # (and the mesh peer's CUDA context) overlap the phases before them
    peers = start_peers(slt)
    mesh_peer = start_mesh_peer(slt)
    peers["others"] = {p.pid for p in mesh_peer["procs"].values()}
    # the entry phase's C client starts now too (its interpreter, torch
    # and CUDA context), and waits for that phase
    capi_client = start_capi_client()
    peers["others"].add(capi_client["proc"].pid)
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
    records.append(panel_phase(plan, torch, kernels, gen))

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
    panels = len(plan_panels(lu.plan))
    launches = expect_launches("gssvx", kernels, groups * factorizations(rep),
                               True, panels * factorizations(rep))
    calls = expect_native("gssvx", native, "amalgamate", "mlnd")
    peak = torch.cuda.max_memory_allocated()
    if info != 0 or x is None or x.shape != b.shape:
        raise AssertionError(f"gssvx failed: info={info}")
    if not np.all(np.isfinite(x)):
        raise AssertionError("gssvx returned non-finite values")
    berr = rep.berr
    relres = float(np.linalg.norm(b - a.matvec(x)) / np.linalg.norm(b))
    analysis = sum(stats.utime[p] for p in ANALYSIS)
    # the build census: the FACT's own block (the card's default stream
    # executor builds nothing per key), and the process's so far — the
    # kernel and host-library builds and the first solve's captures
    comp = stats.compile
    if stats.retraces or comp["builds"]:
        raise AssertionError(f"gssvx FACT: {comp['builds']} builds, "
                             f"{stats.retraces} retraces")
    say("gssvx", n=a.n_rows, nnz=a.nnz, info=info, wall_s=wall,
        compile={k: comp[k] for k in ("builds", "seconds", "fresh_seconds",
                                      "persistent_hits")},
        compile_top=[[r["site"], r["key"], r["n"], r["seconds"]]
                     for r in comp["census"][:3]],
        retraces=stats.retraces, census_process=census_since((0, 0)),
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
        panels=panels,
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
    for rec in records:
        rec["launches"] = launches[rec["name"]]
    # the runtime program audits on the main path's handle, before any
    # later phase refactors it (their grid leg runs in the mesh phase)
    audit_phase(slt, a, b, lu, berr, kernels, torch, factor, plan, bvals0,
                lu0.anorm)

    # 4a. the handle saved, loaded and solved; a deadline-stopped
    # factorization resumed; 4b. the file-driven CLI on the same matrix —
    # under build/ in the checkout (bundles of 0.6-1.6 GB)
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    try:
        bundle, a_sm, lu_sm = persist_phase(slt, a, b, lu, kernels, tols,
                                          torch, workdir)
        cli_phase(slt, a_sm, kernels, tols, workdir)
        # 4c. the serving tier on the handle and its bundle
        served = serve_phase(slt, a, lu, bundle, a_sm, lu_sm, kernels, tols,
                             torch, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    # 4d. the distributed driver: pgssvx on 4 ranks, rank 0 on the card
    pgssvx_phase(slt, peers, kernels, tols, torch)
    del peers
    # 4e. the mesh tier: pgssvx(grid=) on a 1x2 grid, both ranks on the card
    meshed = mesh_phase(slt, a, lu, x, stats.tiny_pivots, mesh_peer, kernels,
                        tols, torch)
    # the front assembly's launches inside the grid's segment graphs (per
    # leg, per rank: the capturing DOFACT, the replaying refactor)
    records[0]["grid_graph_launches"] = meshed["mesh2d"]["legs"][
        "graph_launches"]
    del mesh_peer
    # 4f. the reference's user entry points: the C client on the card, the
    # example drivers and pdtest's 1x1 sweep (before the reuse phase
    # refactors the main handle on new values)
    entry_phase(slt, a, lu, capi_client, kernels, tols, torch)
    del capi_client

    # 4e. the reuse tiers and refactor on the main path's handle, 4f. the
    # complex path on its plan
    reuse_phase(slt, a, lu, wall, stats.utime["FACT"], kernels, tols, torch,
                factor, served)
    del served
    complex_phase(slt, a, lu, kernels, tols, torch)
    # 4f. the device solve's schedules, buckets, graphs and DiagInv; 4g. the
    # GEMM tiers on the main path's analysis
    solve_phase(lu, torch)
    gemm_tiers_phase(slt, kernels, tols)
    # 4h. Options.executor: fused and mega CUDA graphs, host offload, the
    # host-share split, level waves
    executors_phase(slt, a, lu, kernels, tols, torch, factor, a_sm, lu_sm)
    # 4i. the executors' kernel spans under a file tracer (its grid leg
    # ran in the mesh phase)
    try:
        trace_phase(slt, kernels, torch, factor, plan, bvals0, lu0.anorm,
                    lu_sm)
    finally:
        shutil.rmtree(TRACE_DIR, ignore_errors=True)
    del lu_sm

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
    say("factor_profile", **factor_profile(plan, bvals0, lu0.anorm, torch,
                                           factor))

    # 6. the scatter work of one whole factorization
    in_factor, sums = factor_sums(plan, maps, bvals0, lu0.anorm, torch,
                                  factor, kernels, gen)
    say("kernels_factor", in_factorization=in_factor, replayed=sums,
        groups=len(plan.groups))
    for name, want in (("front_assemble", len(plan.groups)),
                       ("panel_lu", len(plan_panels(plan)))):
        if in_factor[name]["launches"] != want:
            raise AssertionError(f"{in_factor[name]['launches']} {name} "
                                 f"launches in one factorization, expected "
                                 f"{want}")
    # the panel LU's time summed over one FACT, beside the largest panel's
    next(r for r in records if r["name"] == "panel_lu")["summed"] = {
        k: sums["panel_lu"]["float32"][k] for k in ("ms", "plain_ms",
                                                    "bound_ms", "library_ms")}
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
                                  scatter=factor.PLAIN,
                                  panel=factor.PANEL_PLAIN)
    same = all(torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
               for k, p in zip(fk.fronts, fp.fronts))
    if not same:
        raise AssertionError("fronts through the kernels != through the "
                             "plain versions")
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

    print(json.dumps({"kernels": [
        {k: r[k] for k in KEYS + ("grid_graph_launches", "summed") if k in r}
        for r in records]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
