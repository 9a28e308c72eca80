"""The streamed factorization executor: the group loop issued from the host.

Port of the JAX package's ``numeric/stream.py``.  The groups run in
dispatch order on a pool that stays on the device; every kernel is queued
on the current stream, so the host runs ahead of the card (the role of
the reference's pipelined look-ahead, SRC/pdgstrf.c:1100-1348).  Beyond
the plain loop it has the JAX executor's three options:

* ``offload`` — each group's factored panels go to host memory as soon as
  they exist (the reference's GPU path keeps the factors in host memory,
  dSchCompUdt-cuda.c:194-241): a copy on a side stream into one pinned
  arena sized from the plan, at most ``offload_lag`` groups of device
  panels in flight.  "auto" offloads when the main path would not fit
  on the card (``offload_rule``: its estimate against the card's free
  memory), or with an explicit ``front_bytes_limit`` when the padded
  front bytes exceed it (the JAX rule, stream.py:218-226).
* ``host_flops`` — the host-share split (the reference's
  gemm_division_cpu_gpu, SRC/util.c:1271-1360): leading levels whose
  every group runs fewer flops than the threshold are factored on the CPU
  through the plain front assembly, then the pool moves to the card once.
* ``granularity="level"`` — one CUDA graph per schedule wave on the card,
  captured at the first call and replayed by the later ones; "group"
  issues every group eagerly.  The fused executor (numeric/fused.py) is
  this one at level granularity with a single wave of every group.

Checkpoints, resume, the deadline and the finite sentinel work as the
loop of numeric/factor.py always had them: a frontier is noted at every
group boundary (every wave boundary under "level").

Under a file tracer each call records the JAX stream's spans: an
``issue g{gi}`` (``issue lvl{level}``) dispatch span a group (wave), and
under a profiling one a ``lu b{b} m{m} w{w} u{u}`` kernel span a group
(an aggregate one a wave) timed by CUDA events (obs/kernelspans.py),
with ``last_profile``; ``last_dispatch_seconds`` is the host's issue
time of every call's group loop.
"""

from __future__ import annotations

import functools
import socket
import sys
import time
import zlib

import numpy as np
import torch

from superlu_dist_tpu_torch.numeric import factor
from superlu_dist_tpu_torch.numeric.factor import KERNELS, PANEL, run_groups
from superlu_dist_tpu_torch.numeric.plan import (FactorPlan, PlanRef,
                                                 bucket_rung)
from superlu_dist_tpu_torch.obs.kernelspans import (KernelClock, kernel_span,
                                                    wave_span)
from superlu_dist_tpu_torch.obs.metrics import get_metrics
from superlu_dist_tpu_torch.obs.trace import get_tracer
from superlu_dist_tpu_torch.ops.dense import (capture_stream, gemm_precision,
                                              panel_width, resolve_gemm_tier)
from superlu_dist_tpu_torch.symbolic.symbfact import _front_flops
from superlu_dist_tpu_torch.utils.errors import (CheckpointMismatchError,
                                                 DeviceMemoryError,
                                                 SuperLUError)
from superlu_dist_tpu_torch.utils.lockwatch import make_lock
from superlu_dist_tpu_torch.utils.options import env_int, resolve_device
from superlu_dist_tpu_torch.utils.programaudit import maybe_audit

CPU = torch.device("cpu")


class RetraceSentinel:
    """The runtime recapture watchdog — the dynamic counterpart of
    slulint's SLU105 graph-cache-key rule (part of the SLU106 runtime
    tier), port of the JAX package's (stream.py:56-95).

    An executor captures its graphs at its first call; a warmed executor
    that runs the same plan again must capture none.  A capture after
    the warm-up means the executor's graph cache lost a graph or a
    cache-key input changed under it.  Such captures are counted
    process-wide, reported to stderr, emitted as a ``verify`` trace span
    and the ``slu_retraces_total`` counter, and summed into
    ``Stats.retraces`` by drivers/gssvx.factorize_numeric."""

    def __init__(self):
        self.total = 0            # unexpected captures, process-wide
        self.events = []          # (factory, builds), the last 32
        # bumped from whichever thread ran the executor (a serving
        # dispatcher, a user thread): the totals must not tear
        self._lock = make_lock("stream.RetraceSentinel._lock")

    def record(self, factory: str, builds: int, tracer=None) -> None:
        with self._lock:
            self.total += builds
            self.events = (self.events + [(factory, int(builds))])[-32:]
        print(f"[SLU106] retrace sentinel: {builds} unexpected CUDA graph "
              f"capture(s) in {factory} after warmup — a cache-key input "
              "(env knob, grid identity, dtype) changed mid-run or the "
              "graph cache lost a graph; a warmed executor expects 0 "
              "captures", file=sys.stderr, flush=True)
        if tracer is not None and tracer.enabled:
            tracer.complete("retrace-sentinel", "verify",
                            time.perf_counter(), 0.0,
                            factory=factory, builds=int(builds))
        m = get_metrics()
        if m.enabled:
            m.inc("slu_retraces_total", float(builds), factory=factory)


RETRACE_SENTINEL = RetraceSentinel()


def retrace_end(ex, before: int, factory: str) -> None:
    """The end of an executor's call (JAX stream.py:652-666): the graphs
    it captured since ``before`` (a value of ``ex.captures``) are its
    ``last_kernel_builds``; on a warmed executor they are retraces, and
    the sentinel records them.  The first call that ends warms it."""
    built = ex.captures - before
    ex.last_kernel_builds = built
    ex.last_retraces = 0
    if ex.sentinel_warm and built:
        ex.last_retraces = built
        RETRACE_SENTINEL.record(factory, built, get_tracer())
    ex.sentinel_warm = True


def progress_every() -> int:
    """``SLU_TPU_PROGRESS``: K > 0 prints a line to stderr every K groups
    issued (0: silent), as the JAX stream does (stream.py:515-519)."""
    return max(env_int("SLU_TPU_PROGRESS"), 0)


def progress_line(gi: int, n: int, t0: float) -> None:
    """The JAX stream's progress line (stream.py:571-574)."""
    print(f"[stream] issuing group {gi}/{n} "
          f"(+{time.perf_counter() - t0:.1f}s)", file=sys.stderr, flush=True)


def progress_wave(level: int, n: int) -> None:
    """The JAX stream's progress line of a wave at level granularity."""
    print(f"[stream] issuing level {level} ({n} groups)", file=sys.stderr,
          flush=True)


def padded_front_bytes(plan: FactorPlan, dtype) -> int:
    """The JAX executor's measure of the factors' size (stream.py:218-226):
    (lpanel + upanel) elements at pow-2 padded batches, in bytes."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return sum(bucket_rung(g.batch, lo=1, growth=2.0)
               * (g.m * g.w + g.w * g.u) for g in plan.groups) * itemsize


def offload_sizes(plan: FactorPlan) -> list:
    """Elements of each group's (lpanel, upanel) pair: the single-card
    executors' offload arena."""
    return [g.batch * g.m * g.w + g.batch * g.w * g.u for g in plan.groups]


#: device bytes the card's offload rule keeps out of its budget: what its
#: estimate does not count — the caching allocator's split blocks, the
#: solve's graph pool and buffers, the refinement's operator, the CUDA
#: runtime's own — as a share of the card's memory (PERF.md §5 gives the
#: measured peaks it was chosen from)
OFFLOAD_RESERVE_SHARE = 0.08


def _rung(batch: int) -> int:
    return bucket_rung(batch, lo=1, growth=2.0)


def group_work_bytes(g, itemsize: int, batch: int | None = None) -> int:
    """Device bytes one group step (``factor.group_step``) holds beyond
    the pool and the factors kept, at ``batch`` slots (by default its
    pow-2 padded batch): the assembled front batch, its zero-padded copy
    when the panels overrun it, and the larger of the first trailing
    update's GEMM product and the write-back's temporaries (the Schur
    blocks copied out, once more for a subset of slots, their int64 pool
    indices and the index ramp)."""
    b = _rung(g.batch) if batch is None else batch
    pb, nsteps = panel_width(g.w)
    m_ext = max(g.m, nsteps * pb)
    front = b * g.m * g.m * itemsize
    pad = b * m_ext * m_ext * itemsize if m_ext > g.m else 0
    write_back = b * g.u * g.u * (2 * itemsize + 8) + 8 * g.u * g.u
    return front + pad + max(front, write_back)


def factor_parts(plan: FactorPlan, itemsize: int) -> tuple:
    """(the factors kept, at pow-2 padded batches; the most the streamed
    FACT holds beside its pool — the factors kept so far and one group's
    working set; the largest working set), in bytes."""
    kept = fact = work = 0
    for g in plan.groups:
        kept += _rung(g.batch) * (g.m * g.w + g.w * g.u) * itemsize
        step = group_work_bytes(g, itemsize)
        fact, work = max(fact, kept + step), max(work, step)
    return kept, fact, work


def map_bytes(plan: FactorPlan) -> int:
    """A bound of the device index maps ``factor.upload_maps`` holds: the
    plan's own int64 maps, and the kernel's (``kernels.front_map_arrays``)
    counted as twice as many bytes plus each child's bucket rows."""
    own = kern = 0
    for g in plan.groups:
        own += 8 * sum(np.size(x) for x in (g.ws, g.off, g.a_slot, g.a_flat,
                                            g.a_src))
        nb = -(-g.m // 64) + 1
        for c in g.children:
            own += 8 * (np.size(c.child_off) + np.size(c.child_slot)
                        + np.size(c.rel))
            kern += 4 * len(c.child_off) * nb
    return 3 * own + kern


def _inflight(sizes, lag: int, units) -> list:
    """Per unit of ``units`` ((lo, hi) group ranges, each cloned out or
    produced at once): the factor bytes on the card while it is emitted
    to the host — its own panels beside those of the ``lag`` groups
    before it whose copies may still run (``_Offload``), each group's
    ``sizes[gi]`` bytes (at the real batches the copies move)."""
    panels = np.zeros(len(sizes) + 1, dtype=np.int64)
    panels[1:] = np.cumsum(sizes)
    return [int(panels[hi] - panels[max(lo - lag, 0)]) for lo, hi in units]


def offload_estimate(plan: FactorPlan, dtype, *, pool_len: int | None = None,
                     graphs: int | None = None, warm: int = 0,
                     maps: int | None = None, lag: int = 8,
                     units=None, share=None) -> dict:
    """Device bytes an executor and the device solve after it hold at
    their peak when the factors stay on the card (``bytes``), and when
    they go to host memory (``offload_bytes``), with the parts: the pool
    (``pool_len`` entries, the plan's by default), the factors at pow-2
    padded batches and the working sets (:func:`factor_parts`), the
    device solve's copy of the factors (``solve/device.solve_copy_bytes``)
    and the index maps (``maps`` bytes, by default :func:`map_bytes`).

    The streamed loop (``graphs`` None) holds during FACT its pool, the
    factors kept so far and one group's working set; after it — the pool
    is the call's own and is gone — the factors beside the solve's copy.
    A graph executor owns its pool for its life, and beside it
    ``graphs`` bytes of its graphs' private pools (the captured steps'
    working sets and outputs), the factors and the solve's copy; before
    its captures its warm-up holds ``warm`` bytes beside the pool.  The
    executors pass their own parts (``device_estimate``).

    Offloaded, the factors and the solve's copy stay off the card (the
    solve runs on the host); what stays is the pool, the maps and the
    panels whose copies are in flight (``inflight_bytes``: a unit of
    ``units`` — a group each by default — beside the ``lag`` groups
    before it).  The streamed loop runs each group at its real batch, so
    its working set is counted there (``offload_work_bytes``) beside the
    copies in flight before it; a graph executor keeps its graph pools
    and its warm-up as counted above.

    ``share`` (a grid rank's: parallel/mesh_stream.py) replaces the
    plan's parts by one rank's: (per group the bytes it keeps — its own
    columns and the pivot stack —, per group its program's working set,
    its solver's copy); the rank keeps and works on its share only."""
    from superlu_dist_tpu_torch.solve.device import solve_copy_bytes
    itemsize = torch.empty((), dtype=dtype).element_size()
    pool = (plan.pool_size if pool_len is None else pool_len) * itemsize
    if share is None:
        kept, fact, work = factor_parts(plan, itemsize)
        solve = solve_copy_bytes(plan, itemsize)
        sizes = [g.batch * (g.m * g.w + g.w * g.u) * itemsize
                 for g in plan.groups]
        steps = [group_work_bytes(g, itemsize, g.batch) for g in plan.groups]
    else:
        sizes, steps, solve = share
        held = np.cumsum(sizes, dtype=np.int64)
        kept = int(held[-1]) if len(sizes) else 0
        fact = max([int(h) + s for h, s in zip(held, steps)], default=0)
        work = max(steps, default=0)
    maps = map_bytes(plan) if maps is None else maps
    groups = [(gi, gi + 1) for gi in range(len(plan.groups))]
    flight = _inflight(sizes, lag, groups if units is None else units)
    if graphs is None:
        peak = max(pool + fact, kept + solve)
        offloaded = pool + max([f + s for f, s in zip(flight, steps)],
                               default=0)
        real_work = max(steps, default=0)
    else:
        peak = pool + max(warm, graphs + kept + solve)
        offloaded = pool + max(warm, graphs + max(flight, default=0))
        real_work = work
    return {"bytes": maps + peak, "offload_bytes": maps + offloaded,
            "pool_bytes": pool, "factor_bytes": kept,
            "work_bytes": work, "graph_bytes": graphs or 0,
            "warm_bytes": warm, "solve_copy_bytes": solve,
            "map_bytes": maps, "inflight_bytes": max(flight, default=0),
            "offload_work_bytes": real_work}


def device_budget(device) -> int | None:
    """The bytes the offload rule lets the main path take on ``device``
    (None off the card): free device memory, plus the blocks torch's
    caching allocator holds unused (``mem_get_info`` counts them as used,
    but torch hands them out again), less :data:`OFFLOAD_RESERVE_SHARE`
    of the card."""
    if device.type != "cuda":
        return None
    free, total = torch.cuda.mem_get_info(device)
    cached = (torch.cuda.memory_reserved(device)
              - torch.cuda.memory_allocated(device))
    return int(free + cached - OFFLOAD_RESERVE_SHARE * total)


def card_key(device) -> int:
    """Which physical card ``device`` is, as a number a grid can
    all-reduce: a hash of the host's name and the card's UUID (off the
    card the device's name: the CPU ranks of one host share it)."""
    ident = str(device)
    if device.type == "cuda":
        ident = str(getattr(torch.cuda.get_device_properties(device), "uuid",
                            ident))
    return zlib.crc32(f"{socket.gethostname()} {ident}".encode())


def _cards_over(grid, used: int, offloaded: int, limit: int, card: int,
                rec: dict) -> tuple:
    """The grid's choice under the card's rule: every rank's (bytes,
    offloaded bytes, budget, card) in one all-reduce.  Returns (whether
    the ranks on any one card hold more than the least budget among them
    — then every rank offloads —, whether offloaded they fit on every
    card), the same on every rank.  ``rec`` gets this rank's card: its
    ranks, their bytes, their offloaded bytes and that budget, and the
    number of cards that do not fit even offloaded."""
    vec = np.zeros(4 * grid.nproc)
    vec[4 * grid.rank:4 * grid.rank + 4] = used, offloaded, limit, card
    rows = grid.allreduce_sum_any(vec).reshape(grid.nproc, 4)
    over, refused = False, 0
    for key in np.unique(rows[:, 3]):
        on = rows[rows[:, 3] == key]
        held, held_off, least = on[:, 0].sum(), on[:, 1].sum(), on[:, 2].min()
        over = over or bool(held > least)
        refused += bool(held_off > least)
        if key == card:
            rec.update(card_ranks=len(on), card_bytes=int(held),
                       card_offload_bytes=int(held_off),
                       card_limit=int(least))
    rec["cards_refused"] = refused
    return over, not refused


def _remedies(plan: FactorPlan, dtype, executor: str) -> list:
    """What would fit where ``executor`` does not: the streamed loop (no
    graph pools; its own offloaded estimate named), the unclosed plan (a
    closed one pads every group to its key's rung), a grid whose pool is
    partitioned over several cards."""
    out = []
    if executor not in ("stream", "spmd", "mesh-stream"):
        off = offload_estimate(plan, dtype)["offload_bytes"]
        out.append(f"Options(executor='stream'), which needs {off:,} B "
                   "offloaded")
    if plan.closed:
        out.append("the unclosed plan, Options(bucket_closed=False)")
    out.append("a grid over several cards with Options(pool_partition="
               "True), each card holding its share of the pool")
    return out


def offload_rule(plan: FactorPlan, dtype, device, front_bytes_limit,
                 grid=None, estimate=None, *, executor: str = "stream",
                 offloads: bool = True) -> tuple:
    """What ``offload="auto"`` resolves to, and why: ("host" | "none", a
    record for the executor's report: the rule, the bytes it compared
    with its limit, whether they exceed it, and under the card's rule the
    bytes offloaded).  Every executor resolves "auto" here, once, when it
    is built, before it allocates anything.

    A number is the JAX package's rule (stream.py:218-226): the plan's
    :func:`padded_front_bytes` against it.  None is the card's rule: the
    executor's estimate (``estimate()``, by default
    :func:`offload_estimate`'s dict) against :func:`device_budget`, the
    estimate made only where there is a budget.  "host" when the bytes
    exceed the limit — on the card, and on a ``grid`` on any device (one
    Options offloads alike on the card and on the CPU ranks its tests
    run); off the card the card's rule has no budget and no offload.
    Under the card's rule an executor over its budget whose estimate
    with the factors in host memory (``offload_bytes``) is over it too,
    or that cannot offload (``offloads`` False: the fused graph), raises
    :class:`~superlu_dist_tpu_torch.utils.errors.DeviceMemoryError`
    naming ``executor``, the parts and what would fit.

    On a grid of several ranks the card's rule decides for the grid
    (:func:`_cards_over`): ranks that share a card each hold their own
    pool and factors there, so their estimates are summed against the
    least budget any of them read, every rank offloads when any card is
    over, and every rank raises when any card does not fit offloaded.  A
    number needs no exchange: it gives every rank the same choice."""
    if front_bytes_limit is not None:
        rule, limit = "front_bytes_limit", front_bytes_limit
    else:
        rule, limit = "card", device_budget(device)
    applies = limit is not None and (grid is not None
                                     or device.type == "cuda")
    used = offloaded = None
    if rule == "front_bytes_limit":
        used = padded_front_bytes(plan, dtype)
    elif applies:
        est = (estimate() if estimate is not None
               else offload_estimate(plan, dtype))
        used, offloaded = est["bytes"], est["offload_bytes"]
    over = bool(applies and used > limit)
    rec = {"rule": rule, "bytes": used, "limit": limit, "over": over}
    if rule == "card":
        rec["offload_bytes"] = offloaded
    fits = offloaded is not None and offloaded <= limit
    if rule == "card" and applies and grid is not None and grid.nproc > 1:
        over, fits = _cards_over(grid, used, offloaded, limit,
                                 card_key(device), rec)
    if rule == "card" and over and not (offloads and fits):
        parts = {k: v for k, v in est.items() if isinstance(v, int)}
        parts.update({k: rec[k] for k in ("card_ranks", "card_bytes",
                                          "card_offload_bytes",
                                          "cards_refused") if k in rec})
        raise DeviceMemoryError(
            executor, str(dtype).replace("torch.", ""),
            rec.get("card_limit", limit), parts,
            _remedies(plan, dtype, executor), offloads=offloads)
    return ("host" if over else "none"), rec


def check_offload(offload: str) -> str:
    if offload not in ("none", "host"):
        raise ValueError(f"offload must be 'auto', 'none' or 'host', "
                         f"got {offload!r}")
    return offload


def host_share_levels(plan: FactorPlan, host_flops: float) -> set:
    """The leading levels whose every group runs fewer than ``host_flops``
    flops at its pow-2 padded batch (JAX stream.py:275-290)."""
    levels = set()
    if host_flops <= 0:
        return levels
    lv_max = {}
    for g in plan.groups:
        fl = bucket_rung(g.batch, lo=1, growth=2.0) * _front_flops(g.w, g.u)
        lv_max[g.level] = max(lv_max.get(g.level, 0.0), float(fl))
    for lv in sorted(lv_max):
        if lv_max[lv] >= host_flops:
            break
        levels.add(lv)
    return levels


class _Offload:
    """Copies of one call's factored panels into host memory: one arena
    (pinned on the card) holding ``sizes[i]`` elements for item i (a
    group's panels), each item's copy on a side stream after an event on
    the compute stream, at most ``lag`` items in flight; ``wait_s`` is the
    host time spent waiting for them.  The single-card executors size it
    from the plan (:func:`offload_sizes`), the grid's from a rank's share
    (parallel/mesh_stream.py)."""

    def __init__(self, sizes, dtype, device, lag: int):
        self.device, self.lag = device, int(lag)
        self.offsets = np.concatenate([[0], np.cumsum(sizes, dtype=np.int64)])
        cuda = device.type == "cuda"
        self.arena = torch.empty(int(self.offsets[-1]), dtype=dtype,
                                 pin_memory=cuda)
        self.stream = torch.cuda.Stream(device) if cuda else None
        self.pending = []          # events of copies in flight
        self.wait_s = 0.0

    @property
    def nbytes(self) -> int:
        return self.arena.numel() * self.arena.element_size()

    def emit(self, i: int, *tensors):
        """Item ``i``'s tensors in host memory (views of the arena; on the
        card still being copied until the call ends or the lag forces the
        wait)."""
        at = int(self.offsets[i])
        host = []
        for t in tensors:
            host.append(self.arena[at:at + t.numel()].view(t.shape))
            at += t.numel()
        if at > int(self.offsets[i + 1]):
            raise ValueError(f"offload item {i}: {at - int(self.offsets[i])} "
                             f"elements, the arena holds "
                             f"{int(self.offsets[i + 1] - self.offsets[i])}")
        if self.stream is None:
            for h, t in zip(host, tensors):
                h.copy_(t)
            return tuple(host)
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            for h, t in zip(host, tensors):
                h.copy_(t, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        # the device tensors must outlive the copy that reads them
        for t in tensors:
            t.record_stream(self.stream)
        self.pending.append(ev)
        while len(self.pending) > self.lag:
            self._wait(self.pending.pop(0))
        return tuple(host)

    def _wait(self, ev) -> None:
        t0 = time.perf_counter()
        ev.synchronize()
        self.wait_s += time.perf_counter() - t0

    def drain(self) -> None:
        while self.pending:
            self._wait(self.pending.pop(0))


class StreamExecutor:
    """Callable factorization: ``ex(avals, thresh) -> (fronts, tiny)``,
    reusable across refactorizations of the same plan (the SamePattern
    tier).  ``checkpoint``, ``resume`` and ``deadline`` are per-call hooks
    set by numeric_factorize.

    ``offload``: "none" keeps every factored panel on the device; "host"
    moves each group's panels to host memory as they are produced, so the
    device holds the pool and the panels in flight only; "auto" is
    :func:`offload_rule`'s choice (``front_bytes_limit`` None: the
    card's own rule; a number: the JAX package's).  ``host_flops`` > 0
    runs the cheap leading levels on the CPU (:func:`host_share_levels`).
    ``granularity`` "level" replays one CUDA graph per schedule wave on
    the card (eager on the CPU, where it equals "group" bit for bit)."""

    plan = PlanRef()     # the plan owns its executors (plan.PlanRef)

    name = "stream"
    #: level waves print a progress line each (the fused executor's one
    #: wave does not: the JAX fused program prints none)
    progress_waves = True
    #: whether the factors can go to host memory (the fused graph's
    #: cannot: the card's rule refuses it where they do not fit)
    offloads = True

    def __init__(self, plan: FactorPlan, dtype=torch.float64, device="cuda",
                 gemm_prec: str | None = None, offload: str = "auto",
                 granularity: str = "group", host_flops: float = 0.0,
                 front_bytes_limit: float | None = None,
                 offload_lag: int = 8, scatter=KERNELS, panel=PANEL):
        plan.check_index_width()
        self.plan, self.dtype = plan, dtype
        self.device = resolve_device(device)
        self.gemm_prec = gemm_precision(gemm_prec)
        # the tier the arithmetic runs for this dtype: the kernel spans'
        self.gemm_prec_resolved = resolve_gemm_tier(self.gemm_prec, dtype)
        self.scatter, self.panel = scatter, panel
        if granularity not in ("group", "level"):
            raise ValueError(f"granularity must be 'group' or 'level', "
                             f"got {granularity!r}")
        self.granularity = granularity
        self.offload_lag = int(offload_lag)
        levels = host_share_levels(plan, host_flops)
        # the host share is the leading run of groups on those levels
        n = 0
        while n < len(plan.groups) and plan.groups[n].level in levels:
            n += 1
        self._n_host_groups = n
        self.host_levels = len({g.level for g in plan.groups[:n]})
        self.offload_rule = {"rule": "given"}
        if offload == "auto":
            # before anything is allocated: a refusal leaves the card as
            # it was
            offload, self.offload_rule = offload_rule(
                plan, dtype, self.device, front_bytes_limit,
                estimate=self.device_estimate, executor=self.label,
                offloads=self.offloads)
        self.offload = check_offload(offload)
        self.checkpoint = self.resume = self.deadline = None
        # the chaos harness's injector (testing/chaos.py), per call
        self.chaos = None
        self.last_offload_wait_seconds = 0.0
        self.last_profile = None   # a profiling tracer's spans, per call
        self.last_dispatch_seconds = None   # host issue time, per call
        self._waves = None         # level graphs: a Graph (None for a host
                                   # wave) per entry of waves()
        self._static = None        # their static avals, thresh and pool
        self.graph_stats = {}
        self._submitted = set()    # programs submitted to the audits
        self._all_submitted = False
        # the retrace sentinel's state: graphs captured (ever), whether a
        # call has ended, and the last call's captures and retraces
        self.captures = 0
        self.sentinel_warm = False
        self.last_kernel_builds = self.last_retraces = 0

    @property
    def label(self) -> str:
        """The executor as the card's rule names it: ``stream[level]``
        for level waves."""
        if self.name == "stream" and self.granularity == "level":
            return "stream[level]"
        return self.name

    def device_estimate(self) -> dict:
        """This executor's :func:`offload_estimate`: the streamed loop's;
        at level granularity the waves' static pool, and their one
        private pool, which keeps every wave's packed factors (a replay
        rewrites them, the call clones them out, a wave at once) and the
        largest step's working set (its warm-up runs on the static
        pool)."""
        if self.granularity != "level":
            return offload_estimate(self.plan, self.dtype,
                                    lag=self.offload_lag)
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        kept, _, work = factor_parts(self.plan, itemsize)
        return offload_estimate(self.plan, self.dtype, graphs=kept + work,
                                lag=self.offload_lag, units=self.waves())

    # ---- what the call loop reads (the mega executor overrides) --------

    def _maps(self):
        return factor.upload_maps(self.plan, self.device)

    def _pool_len(self) -> int:
        return self.plan.pool_size

    def _new_pool(self, device):
        return torch.zeros(self._pool_len(), dtype=self.dtype, device=device)

    def _prep_avals(self, avals: torch.Tensor, device) -> torch.Tensor:
        return avals.to(device=device, dtype=self.dtype)

    def _padded_batch(self, gi) -> int:
        """The batch group ``gi`` runs at (the real one; mega pads it)."""
        return self.plan.groups[gi].batch

    def _ckpt_pool(self, pool):
        """The pool a checkpoint stores (mega strips its padding, so a
        frontier is portable between executors)."""
        return pool

    def _step(self, gi, avals, pool, thresh, maps, timings):
        grp = self.plan.groups[gi]
        return factor.group_step((grp.batch, grp.m, grp.w, grp.u), avals,
                                 pool, thresh, maps[gi],
                                 gemm_prec=self.gemm_prec,
                                 scatter=self.scatter, timings=timings,
                                 panel=self.panel)

    # ---- the runtime program audits (utils/programaudit.py) ---------------

    def _tag(self) -> str:
        """The dtype and GEMM tier a program label ends with."""
        return f"{str(self.dtype).replace('torch.', '')} {self.gemm_prec}"

    def _step_label(self, dims, rung="") -> str:
        """A group program's label: ``lu b{b} m{m} w{w} u{u}``, the rung
        (mega's pool rung), the dtype and GEMM tier."""
        return "lu b{} m{} w{} u{}".format(*dims) + rung + f" {self._tag()}"

    def _submit_step(self, dims, avals, pool, thresh, maps, rung="",
                     device=None, build=None) -> None:
        """Submit ``group_step`` at ``dims`` to the runtime audits, once
        per shape key, with the pool declared dead (it is updated in
        place); with every knob off a few env reads a key.  ``device``:
        walk on fakes of that device (``trace_spec``); ``build``: the
        census (site, key) of the graph the program is captured into."""
        if dims in self._submitted:
            return
        self._submitted.add(dims)
        maybe_audit(f"{self.name}.group_step", self._step_label(dims, rung),
                    functools.partial(factor.group_step, dims,
                                      gemm_prec=self.gemm_prec,
                                      scatter=self.scatter,
                                      panel=self.panel),
                    (avals, pool, thresh, maps), dead=(1,), device=device,
                    build=build)

    def _audit_step(self, gi, avals, pool, thresh, maps, device=None) -> None:
        """Group ``gi``'s program, before the call runs any group."""
        grp = self.plan.groups[gi]
        self._submit_step((grp.batch, grp.m, grp.w, grp.u), avals, pool,
                          thresh, maps[gi], device=device)

    def _wave_build(self, lo, hi) -> tuple:
        """(census site, census key, audit label) of wave lo..hi's
        program; the census's are the JAX package's: the fused
        program's (factor.py:369-372), a level wave's
        (stream.py:833-835)."""
        n = len(self.plan.groups)
        if (lo, hi) == (0, n) and self.name == "fused":
            label = f"fused g{n} {self._tag()}"
            return "make_factor_fn", label, label
        label = f"level{self.plan.groups[lo].level} g{hi - lo}"
        return "stream._level_fn", label, f"{label} {self._tag()}"

    def _audit_wave(self, lo, hi, maps, avals, pool, thresh) -> None:
        """Wave lo..hi's program (``run_groups``), before its warm-up or
        first eager run, the pool declared dead (on the card its audit
        notes land on the census key of the wave's graph)."""
        if (lo, hi) in self._submitted:
            return
        self._submitted.add((lo, hi))
        site, key, label = self._wave_build(lo, hi)
        graph = self.device.type == "cuda" and lo >= self._n_host_groups
        maybe_audit(f"{self.name}.run_groups", label,
                    functools.partial(run_groups, self.plan, lo, hi,
                                      gemm_prec=self.gemm_prec,
                                      scatter=self.scatter,
                                      panel=self.panel),
                    (maps, avals, pool, thresh), dead=(2,),
                    build=(site, key) if graph else None)

    # ---- the call ---------------------------------------------------------

    def __call__(self, avals, thresh, timings=None):
        plan, dev = self.plan, self.device
        resume, self.resume = self.resume, None
        n_host = self._n_host_groups
        if resume is not None and (n_host or self.granularity == "level"):
            raise SuperLUError(
                "checkpoint resume needs granularity='group' and no "
                "host-share split — refactor from scratch")
        out = (_Offload(offload_sizes(plan), self.dtype, dev,
                        self.offload_lag)
               if self.offload == "host" else None)
        # the host share starts on the CPU; the pool moves to the card once
        here = CPU if n_host else dev
        avals_dev = self._prep_avals(avals, dev)
        av = self._prep_avals(avals, here)
        th = thresh.to(here)
        maps = self._maps()
        hmaps = factor.upload_maps(plan, CPU) if n_host else None
        start = 0
        if resume is None:
            # level graphs on the card run on the executor's own pool
            pool = (None if self.granularity == "level"
                    and here.type == "cuda" else self._new_pool(here))
            fronts = []
            tiny = torch.zeros((), dtype=torch.int64, device=here)
        else:
            fronts, pool = self._apply_resume(resume)
            start = resume.k
            tiny = torch.zeros((), dtype=torch.int64, device=dev)
        progress = progress_every()
        tracer = get_tracer()
        clock = KernelClock(dev) if tracer.profiling else None
        if self.granularity == "group" and not self._all_submitted:
            # every group's program audited before any of the call runs
            # (a card group after a host share: on fakes of the card)
            for gi in range(start, len(plan.groups)):
                host = gi < n_host
                self._audit_step(gi, av if host else avals_dev, pool, th,
                                 hmaps if host else maps,
                                 None if host or not n_host else dev)
            self._all_submitted = start == 0
        builds0 = self.captures
        t_issue0 = time.perf_counter()
        if self.granularity == "level":
            tiny = self._call_waves(av, avals_dev, th, thresh, pool, maps,
                                    hmaps, fronts, tiny, out, timings,
                                    progress, tracer, clock, t_issue0)
        else:
            for gi in range(start, len(plan.groups)):
                self._poll()
                if progress and gi % progress == 0:
                    progress_line(gi, len(plan.groups), t_issue0)
                if gi == n_host and n_host:
                    # the end of the host share: the one move to the card
                    # (once a call: the linter's device taint comes from
                    # the loop's next pass, when they already lie there)
                    pool = pool.to(dev)  # slulint: disable=SLU122
                    tiny = tiny.to(dev)  # slulint: disable=SLU122
                    av, th = avals_dev, thresh.to(dev)
                if tracer.enabled:
                    t0 = time.perf_counter()
                if clock is not None:
                    mark = clock.start(host=gi < n_host)
                (lp, up), t = self._step(gi, av, pool, th,
                                         hmaps if gi < n_host else maps,
                                         timings)
                if clock is not None:
                    clock.stop(mark, (gi, gi + 1))
                if tracer.enabled:
                    # how long the group's launches took to issue (host
                    # time; the launches run on asynchronously)
                    tracer.complete(f"issue g{gi}", "dispatch", t0,
                                    time.perf_counter() - t0, group=gi,
                                    level=int(plan.groups[gi].level))
                if out is not None:
                    lp, up = out.emit(gi, lp, up)
                fronts.append((lp, up))
                tiny += t
                self._note(gi, fronts, pool, tiny)
                if self.chaos is not None:
                    self.chaos.on_group(gi)
            self.last_dispatch_seconds = time.perf_counter() - t_issue0
        if out is not None:
            out.drain()
            self.last_offload_wait_seconds = out.wait_s
        tiny_total = int(tiny) + (resume.tiny if resume is not None else 0)
        if clock is not None:
            # after the int(): every event of the call has completed
            self.last_profile = self._kernel_spans(tracer, clock)
        retrace_end(self, builds0,
                    f"{type(self).__name__}[{self.granularity}]")
        return fronts, tiny_total

    def _kernel_spans(self, tracer, clock) -> list:
        """The call's kernel spans, one a group (a wave at "level"), and
        their ``last_profile`` entries."""
        plan, prof = self.plan, []
        for t0, dt, (lo, hi) in clock.read():
            host = lo < self._n_host_groups
            if self.granularity == "level":
                prof.append(wave_span(
                    tracer, t0, dt, plan.groups[lo:hi],
                    self.gemm_prec_resolved,
                    padded=[self._padded_batch(gi) for gi in range(lo, hi)],
                    host=host))
                continue
            g = plan.groups[lo]
            prof.append(kernel_span(
                tracer, t0, dt, level=g.level, b=self._padded_batch(lo),
                m=g.m, w=g.w, u=g.u, nreal=g.batch, host=host,
                gemm_prec=self.gemm_prec_resolved))
        return prof

    def _issue_span(self, tracer, t0, lo, hi) -> None:
        """A wave's dispatch span: how long its replay (or its eager
        groups) took to issue."""
        tracer.complete(f"issue lvl{self.plan.groups[lo].level}", "dispatch",
                        t0, time.perf_counter() - t0,
                        level=int(self.plan.groups[lo].level),
                        groups=hi - lo)

    def _poll(self) -> None:
        """A group (or wave) boundary: the deadline, whose expiry first
        flushes the latest noted frontier."""
        if self.deadline is not None:
            ck = self.checkpoint
            self.deadline.poll(
                where="numeric factorization",
                on_expire=None if ck is None
                else (lambda: ck.flush_latest("deadline")))

    def _note(self, gi, fronts, pool, tiny) -> None:
        if self.checkpoint is not None:
            self.checkpoint.note(gi, fronts, self._ckpt_pool(pool), tiny)

    def _apply_resume(self, resume):
        """A verified ResumeState: (fronts of the first k groups — on the
        host under offload, else on the device — and the pool at boundary
        k, on the device).  The pool must come back in the factor dtype it
        was written in (the value digest covers the dtype; this guards the
        array itself)."""
        plan = self.plan
        want = np.dtype(str(self.dtype).replace("torch.", ""))
        if resume.pool.dtype != want or resume.pool.shape != (plan.pool_size,):
            raise CheckpointMismatchError(
                f"checkpoint pool at {resume.path!r} is {resume.pool.dtype} "
                f"{resume.pool.shape}, this run needs {want} "
                f"({plan.pool_size},)")
        where = CPU if self.offload == "host" else self.device
        fronts = [tuple(torch.tensor(x, device=where) for x in pair)
                  for pair in resume.fronts]
        pool = self._new_pool(self.device)
        pool[:plan.pool_size] = torch.as_tensor(resume.pool).to(self.device)
        return fronts, pool

    # ---- level waves ------------------------------------------------------

    def waves(self) -> list:
        """The schedule waves as (lo, hi) group ranges: consecutive groups
        of one ``Group.level`` (the dataflow scheduler's dispatch wave);
        a wave never straddles the host share's end."""
        out, lo = [], 0
        groups = self.plan.groups
        for gi in range(1, len(groups) + 1):
            if (gi == len(groups) or groups[gi].level != groups[lo].level
                    or gi == self._n_host_groups):
                out.append((lo, gi))
                lo = gi
        return out

    def _call_waves(self, av, avals_dev, th, thresh, pool, maps, hmaps,
                    fronts, tiny, out, timings, progress, tracer, clock,
                    t_issue0):
        """Level granularity: the host share's waves eagerly on the CPU,
        then every device wave — on the card, its CUDA graph replayed on
        the executor's static inputs and pool.  ``graph_stats`` gets the
        synchronized seconds of the call's wave loop (``replay_s``) and
        the bytes of the fronts cloned out of the graphs
        (``clone_bytes``); ``clock`` (a profiling tracer's) marks each
        wave's replay or eager groups."""
        plan, dev = self.plan, self.device
        n_host = self._n_host_groups
        graphs = dev.type == "cuda"
        if graphs:
            if timings is not None:
                raise ValueError("timings synchronize the device: a CUDA "
                                 "graph cannot hold them")
            if self._waves is None:
                self._capture_waves(maps, avals_dev, thresh)
            s_avals, s_thresh, s_pool = self._static
            s_avals.copy_(avals_dev)
            s_thresh.copy_(thresh)
            if not n_host:
                s_pool.zero_()
                pool = s_pool
        t0, clone_bytes = time.perf_counter(), 0
        for (lo, hi), graph in zip(self.waves(), self._waves
                                   or [None] * len(self.waves())):
            self._poll()
            if progress and self.progress_waves:
                progress_wave(plan.groups[lo].level, hi - lo)
            if lo == n_host and n_host:
                if graphs:
                    s_pool.copy_(pool)
                    pool = s_pool
                else:
                    pool = pool.to(dev)
                # the end of the host share, once a call (as in __call__)
                tiny = tiny.to(dev)  # slulint: disable=SLU122
                av, th = avals_dev, thresh.to(dev)
            if tracer.enabled:
                t_wave = time.perf_counter()
            if clock is not None:
                mark = clock.start(host=lo < n_host)
            if graph is None:
                wmaps = hmaps if lo < n_host else maps
                self._audit_wave(lo, hi, wmaps, av, pool, th)
                packed, t = run_groups(plan, lo, hi, wmaps, av, pool, th,
                                       self.gemm_prec, self.scatter, timings,
                                       self.panel)
            else:
                packed, t = graph.replay()
            if clock is not None:
                clock.stop(mark, (lo, hi))
            if tracer.enabled:
                self._issue_span(tracer, t_wave, lo, hi)
            if graph is not None:
                # the next call's replay rewrites the graph's fronts
                packed = [(lp.clone(), up.clone()) for lp, up in packed]
                clone_bytes += sum(lp.numel() * lp.element_size()
                                   + up.numel() * up.element_size()
                                   for lp, up in packed)
            for gi, (lp, up) in zip(range(lo, hi), packed):
                if out is not None:
                    lp, up = out.emit(gi, lp, up)
                fronts.append((lp, up))
            tiny += t
            self._note(hi - 1, fronts, pool, tiny)
        self.last_dispatch_seconds = time.perf_counter() - t_issue0
        if graphs:
            torch.cuda.current_stream(dev).synchronize()
            self.graph_stats.update(replay_s=time.perf_counter() - t0,
                                    clone_bytes=clone_bytes)
        return tiny

    def _capture_waves(self, maps, avals_dev, thresh):
        """One CUDA graph per device wave, all on one private pool and
        replayed in capture order, on static inputs and a static pool the
        executor owns."""
        from superlu_dist_tpu_torch.numeric.fused import (
            Graph, check_graph_scatter, warm_up)
        check_graph_scatter(self.scatter)
        plan, dev = self.plan, self.device
        s_avals = torch.zeros(avals_dev.shape[0], dtype=self.dtype,
                              device=dev)
        s_thresh = torch.ones((), dtype=thresh.dtype, device=dev)
        s_pool = torch.zeros(plan.pool_size, dtype=self.dtype, device=dev)
        self._static = (s_avals, s_thresh, s_pool)
        stream = capture_stream(dev)

        def step(gi):
            run_groups(plan, gi, gi + 1, maps, s_avals, s_pool, s_thresh,
                       self.gemm_prec, self.scatter, panel=self.panel)

        n_host = self._n_host_groups
        # the waves' programs, audited before anything of them runs
        for lo, hi in self.waves():
            if lo >= n_host:
                self._audit_wave(lo, hi, maps, s_avals, s_pool, s_thresh)
        self.graph_stats["warm_up_s"] = warm_up(
            step, ((gi, (g.batch, g.m, g.w, g.u))
                   for gi, g in enumerate(plan.groups) if gi >= n_host),
            stream)
        pool_handle = torch.cuda.graph_pool_handle()
        waves = []
        for lo, hi in self.waves():
            if lo < n_host:
                waves.append(None)
                continue
            site, key, _ = self._wave_build(lo, hi)
            waves.append(Graph(
                lambda lo=lo, hi=hi: run_groups(
                    plan, lo, hi, maps, s_avals, s_pool, s_thresh,
                    self.gemm_prec, self.scatter, panel=self.panel),
                dev, stream, pool=pool_handle, site=site, key=key))
            self.captures += 1
        self._waves = waves

    def drop_graphs(self) -> None:
        """Release the captured graphs: the next call captures them
        again — on a warmed executor, retraces the sentinel counts."""
        self._waves = None

    def report(self) -> dict:
        """What ran: executor, granularity, offload and its wait, host
        levels, and the graphs' capture stats when there are any."""
        from superlu_dist_tpu_torch.numeric.fused import graph_totals
        rep = {"executor": self.name, "granularity": self.granularity,
               "offload": self.offload,
               "offload_wait_s": self.last_offload_wait_seconds,
               "offload_rule": dict(self.offload_rule),
               "host_levels": self.host_levels,
               "host_groups": self._n_host_groups}
        graphs = [g for g in self._waves or [] if g is not None]
        if graphs:
            rep.update(graph_totals(graphs), **self.graph_stats)
        return rep
