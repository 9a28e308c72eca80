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
  panels in flight.  "auto" offloads on the card when the padded front
  bytes exceed ``front_bytes_limit`` (JAX stream.py:218-226).
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

import sys
import time

import numpy as np
import torch

from superlu_dist_tpu_torch.numeric import factor
from superlu_dist_tpu_torch.numeric.factor import KERNELS, PANEL, run_groups
from superlu_dist_tpu_torch.numeric.plan import FactorPlan, bucket_rung
from superlu_dist_tpu_torch.obs.kernelspans import (KernelClock, kernel_span,
                                                    wave_span)
from superlu_dist_tpu_torch.obs.trace import get_tracer
from superlu_dist_tpu_torch.ops.dense import gemm_precision, resolve_gemm_tier
from superlu_dist_tpu_torch.symbolic.symbfact import _front_flops
from superlu_dist_tpu_torch.utils.errors import (CheckpointMismatchError,
                                                 SuperLUError)
from superlu_dist_tpu_torch.utils.options import env_int, resolve_device

CPU = torch.device("cpu")


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


def auto_offload(plan: FactorPlan, dtype, device, front_bytes_limit: float,
                 grid: bool = False) -> str:
    """What ``offload="auto"`` resolves to: "host" when the plan's
    :func:`padded_front_bytes` exceed ``front_bytes_limit`` — on the card
    (the JAX rule, stream.py:218-226), and on a grid of several ranks on
    any device (the grid's rule: one Options offloads alike on the card
    and on the CPU ranks its tests run), else "none"."""
    big = padded_front_bytes(plan, dtype) > front_bytes_limit
    return "host" if big and (grid or device.type == "cuda") else "none"


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
    device holds the pool and the panels in flight only; "auto" is "host"
    on the card when :func:`padded_front_bytes` exceeds
    ``front_bytes_limit``.  ``host_flops`` > 0 runs the cheap leading
    levels on the CPU (:func:`host_share_levels`).  ``granularity``
    "level" replays one CUDA graph per schedule wave on the card (eager
    on the CPU, where it equals "group" bit for bit)."""

    name = "stream"
    #: level waves print a progress line each (the fused executor's one
    #: wave does not: the JAX fused program prints none)
    progress_waves = True

    def __init__(self, plan: FactorPlan, dtype=torch.float64, device="cuda",
                 gemm_prec: str | None = None, offload: str = "auto",
                 granularity: str = "group", host_flops: float = 0.0,
                 front_bytes_limit: float = 6e9, offload_lag: int = 8,
                 scatter=KERNELS, panel=PANEL):
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
        if offload == "auto":
            offload = auto_offload(plan, dtype, self.device,
                                   front_bytes_limit)
        self.offload = check_offload(offload)
        self.offload_lag = int(offload_lag)
        levels = host_share_levels(plan, host_flops)
        # the host share is the leading run of groups on those levels
        n = 0
        while n < len(plan.groups) and plan.groups[n].level in levels:
            n += 1
        self._n_host_groups = n
        self.host_levels = len({g.level for g in plan.groups[:n]})
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
                    pool, tiny = pool.to(dev), tiny.to(dev)
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
                tiny = tiny.to(dev)
                av, th = avals_dev, thresh.to(dev)
            if tracer.enabled:
                t_wave = time.perf_counter()
            if clock is not None:
                mark = clock.start(host=lo < n_host)
            if graph is None:
                packed, t = run_groups(plan, lo, hi,
                                       hmaps if lo < n_host else maps, av,
                                       pool, th, self.gemm_prec, self.scatter,
                                       timings, self.panel)
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
        stream = torch.cuda.Stream(dev)

        def step(gi):
            run_groups(plan, gi, gi + 1, maps, s_avals, s_pool, s_thresh,
                       self.gemm_prec, self.scatter, panel=self.panel)

        n_host = self._n_host_groups
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
            waves.append(Graph(
                lambda lo=lo, hi=hi: run_groups(
                    plan, lo, hi, maps, s_avals, s_pool, s_thresh,
                    self.gemm_prec, self.scatter, panel=self.panel),
                dev, stream, pool=pool_handle))
        self._waves = waves

    def report(self) -> dict:
        """What ran: executor, granularity, offload and its wait, host
        levels, and the graphs' capture stats when there are any."""
        from superlu_dist_tpu_torch.numeric.fused import graph_totals
        rep = {"executor": self.name, "granularity": self.granularity,
               "offload": self.offload,
               "offload_wait_s": self.last_offload_wait_seconds,
               "host_levels": self.host_levels,
               "host_groups": self._n_host_groups}
        graphs = [g for g in self._waves or [] if g is not None]
        if graphs:
            rep.update(graph_totals(graphs), **self.graph_stats)
        return rep
