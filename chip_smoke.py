#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (superlu_dist_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one result line each:
  1. card     — the card's name and power limit (nvidia-smi);
  2. build    — compile the CUDA kernel from csrc/ with nvcc (sm_90a);
  3. maps     — the n=110,592 plan's index maps built and uploaded (host
                seconds; the main path does this inside FACT);
     kernels  — the front-assembly kernel against its plain PyTorch version
                on the card (torch.equal) at two groups of the n=110,592
                plan (the one with the most child pairs, the one holding
                the set with the most children) and on a small group full
                of sentinels, in float32 and float64; the standalone K1/K2
                wrappers at the plan's largest child set / assembly group
                and on sentinel cases; each with its time (ms: device time,
                launches replayed in a CUDA graph; call_ms: call by call,
                host included), bound, plain time and the time of one
                library call as a yardstick;
  4. gssvx    — the main path: gssvx on poisson3d(48) (n=110,592) with
                float32 factors on the card and float64 refinement, with
                the kernels' launch counts over exactly that call;
  5. factor_stages — the same factorization synchronized at every stage
                boundary of every group;
  6. kernels_factor — one more factorization with CUDA events around every
                front-assembly launch (no stage synchronize), then every
                group, child set and assembly of the plan replayed alone
                for the kernel / plain / library / bound sums;
  7. check    — a small poisson3d factored through the kernel and through
                the plain version (identical fronts required), and a small
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

#: H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth, and the
#: float32 / float64 rates outside the tensor cores (the kernels' adds),
#: by element size
HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {4: 67e12, 8: 34e12}
NX = 48                  # poisson3d grid edge of the main path: n = 110,592
SEED = 0
KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
SOURCE = "superlu_dist_tpu_torch/csrc/front_assemble.cu"
K1 = "superlu_dist_tpu/numeric/pallas_kernels.py:144"
K2 = "superlu_dist_tpu/numeric/pallas_kernels.py:201"


def say(phase, **fields):
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


def bound(nbytes, nops, itemsize):
    """(ms, "bytes" | "operations"): the least time of the work."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FLOPS_PER_S[itemsize] * 1e3
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
    b_ms, b_by = bound(nbytes, dst.numel(), isz)
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
    host at every call; that is timed apart as wrapper_ms)."""
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
    b_ms, b_by = bound(nbytes, dst.numel(), isz)
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
                       dst.numel(), isz)
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
        ws=put([m // 3, 0, m - 5]), off=put(np.zeros(batch)),
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
    data = {}
    for dt in (torch.float32, torch.float64):
        data[dt] = (
            torch.randn(len(plan.pattern_indices), generator=gen, device=dev,
                        dtype=dt),
            torch.randn(plan.pool_size, generator=gen, device=dev, dtype=dt))

    # --- the fused kernel: sentinel case, then both main-path groups ----
    records = []
    for dt in (torch.float32, torch.float64):
        name = str(dt).split(".")[-1]
        rec = time_front(*sentinel_group(torch, kernels, gen, dt), kernels,
                         reps=5)
        say("kernels_extra", case=f"front_assemble sentinel {name}", **rec)
        for which, (g, gm) in (("most_pairs", big), ("most_children", most)):
            rec = time_front(*data[dt], g.m, g.w, gm, kernels)
            if which == "most_pairs" and dt == torch.float32:
                records.append(dict(
                    name="front_assemble", route="cuda", source=SOURCE,
                    replaces=f"{K1}, {K2}", **rec))
            else:
                say("kernels_extra", case=f"front_assemble {which} {name}",
                    **rec)

    # --- the standalone wrappers at the largest child set and assembly
    # group, plus sentinels ----------------------------------------------
    if not (sentinel_extend_add(torch, kernels, gen)
            and sentinel_assemble(torch, kernels, gen)):
        raise AssertionError("extend_add/assemble kernel != plain on the "
                             "sentinel cases")
    avals, pool = data[torch.float32]
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
                                              plain_reps=1, lib_reps=2))
        if gm.a_src.numel():
            add("assemble", time_assemble(f, avals, gm.a_slot, gm.a_flat,
                                          gm.a_src, kernels, reps=5,
                                          plain_reps=1, lib_reps=2))
        del f
    in_factor["bound_ms"] = sums["front_assemble"]["bound_ms"]
    return in_factor, {k: dict(units=counts[k], **v) for k, v in sums.items()}


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
    # the main path runs the fused kernel once per group, and neither
    # standalone wrapper
    if launches != {"front_assemble": len(lu.plan.groups), "extend_add": 0,
                    "assemble": 0}:
        raise AssertionError(f"launches on the main path: {launches}")
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

    # 6. the scatter work of one whole factorization
    in_factor, sums = factor_sums(plan, maps, bvals0, lu0.anorm, torch,
                                  factor, kernels, gen)
    say("kernels_factor", in_factorization=in_factor, replayed=sums,
        groups=len(plan.groups))
    if in_factor["launches"] != len(plan.groups):
        raise AssertionError(f"{in_factor['launches']} front_assemble "
                             f"launches for {len(plan.groups)} groups")
    del lu0, plan, bvals0, maps

    # 7. kernels vs plain through the factorization, and a small solve
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

    print(json.dumps({"kernels": [{k: r[k] for k in KEYS} for r in records]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
