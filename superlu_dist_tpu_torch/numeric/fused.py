"""The fused executor: the whole factorization as one CUDA graph.

The counterpart of the JAX package's ``make_factor_fn``
(numeric/factor.py:240-388), which traces the whole group loop into one
XLA program.  On the card the same loop is captured once into one
``torch.cuda.CUDAGraph`` per (plan, dtype, GEMM tier) and replayed for
each new set of values, so refactor and the SamePattern_SameRowPerm tier
pay one graph launch instead of the host-issued group loop.  It is the
streamed executor at level granularity with a single wave of every
group, so it shares the level waves' capture (numeric/stream.py):

* the inputs are static buffers (the pattern values, the threshold and
  the pool); the outputs are the graph's fronts and tiny count, cloned
  out after every replay — the next replay overwrites them, and refactor
  and the escalation ladder keep earlier handles;
* the loop is warmed up once on the capture stream before the capture,
  one group of every distinct shape, so cuBLAS handles and workspaces
  exist;
* the capture uses ``capture_begin``/``capture_end`` on a private pool
  (``torch.cuda.graph`` empties the allocator's cache first), and the
  plan owns the device maps whose addresses the graph holds.

A failed capture or replay raises; nothing falls back to the eager loop.
On the CPU, ``fused`` is the same loop run eagerly, bit for bit the
streamed executor's.  Under a file tracer a call records the JAX fused
program's spans (numeric/factor.py:373-385): one ``issue fused``
dispatch span and, under a profiling tracer, one ``factor-fused``
aggregate kernel span timed by CUDA events around the replay.  :class:`Graph` and :func:`warm_up` serve the level
waves and the mega executor's buckets too.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import resource
import time

import torch

from superlu_dist_tpu_torch.numeric import kernels
from superlu_dist_tpu_torch.symbolic.symbfact import _front_flops
from superlu_dist_tpu_torch.numeric.factor import KERNELS, PANEL
from superlu_dist_tpu_torch.numeric.plan import FactorPlan
from superlu_dist_tpu_torch.numeric.stream import StreamExecutor
from superlu_dist_tpu_torch.obs.compilestats import COMPILE_STATS
from superlu_dist_tpu_torch.ops.dense import MATH_LOCK


def _rss_bytes() -> int:
    """This process's resident host memory (Linux /proc), 0 elsewhere."""
    try:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * resource.getpagesize()
    except OSError:
        return 0


@contextlib.contextmanager
def gc_paused():
    """No cyclic garbage collection inside the block: a collection during
    a capture may destroy an unreachable CUDA graph, whose reset is not
    permitted while a stream captures and so invalidates the capture
    (``torch.cuda.graph`` collects before every capture instead, which
    costs a full collection a graph).  The port's executors hold their
    plan weakly (numeric/plan.PlanRef), so no cycle of the port's keeps a
    graph; this guards the capture against a caller's cycles."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def _node_count(graph) -> int | None:
    """Nodes of a captured graph (the driver API's cuGraphGetNodes on
    ``raw_cuda_graph()``), or None where the installed torch keeps no
    graph after capture."""
    try:
        raw = graph.raw_cuda_graph()
    except (AttributeError, RuntimeError):
        return None
    lib = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    rc = lib.cuGraphGetNodes(ctypes.c_void_p(raw), None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {rc}")
    return int(n.value)


class Graph:
    """One captured CUDA graph and what its capture cost: ``capture_s``,
    ``instantiate_s`` (separate where torch keeps the graph after capture,
    else inside the capture), ``nodes``, ``device_bytes`` (the private
    pool's growth of reserved memory) and ``host_bytes`` (resident host
    memory's growth).  ``outputs`` is what the captured function
    returned; a replay rewrites it in place.  The kernel launches the
    capture recorded (``launches``) count in ``kernels.LAUNCHES`` at each
    replay, where the card runs them, and not at the capture.

    ``site`` and ``key`` name the graph in the build census
    (obs/compilestats.py): its capture plus instantiation is recorded
    once, as one build with no disk cache; a replay records nothing."""

    def __init__(self, fn, device, stream, pool=None, *, site, key):
        dev = torch.device(device)
        self.pool = pool if pool is not None else torch.cuda.graph_pool_handle()
        try:
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            kept = True
        except TypeError:
            graph = torch.cuda.CUDAGraph()
            kept = False
        reserved, rss = torch.cuda.memory_reserved(dev), _rss_bytes()
        counted = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        # serialized with every other capture and math-switch block, and
        # the only user of the card's capture stream meanwhile
        # (ops/dense.MATH_LOCK, capture_stream); thread-local mode leaves
        # other threads free to use the card
        with MATH_LOCK:
            stream.wait_stream(torch.cuda.current_stream(dev))
            with gc_paused(), torch.cuda.stream(stream):
                graph.capture_begin(pool=self.pool,
                                    capture_error_mode="thread_local")
                try:
                    self.outputs = fn()
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass    # the capture is invalid: keep fn's error
                    raise
                graph.capture_end()
            torch.cuda.current_stream(dev).wait_stream(stream)
        t1 = time.perf_counter()
        # a kernel captured is launched by each replay, not by the capture
        self.launches = {k: v - counted[k] for k, v in kernels.LAUNCHES.items()
                         if v != counted[k]}
        for k, v in self.launches.items():
            kernels.LAUNCHES[k] -= v
        self.nodes = _node_count(graph) if kept else None
        if kept:
            graph.instantiate()
        t2 = time.perf_counter()
        self.graph = graph
        self.capture_s, self.instantiate_s = t1 - t0, t2 - t1
        self.device_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.host_bytes = _rss_bytes() - rss
        self.replays = 0
        self.site, self.key = site, key
        COMPILE_STATS.record(site, key, t0,
                             self.capture_s + self.instantiate_s)

    def replay(self):
        self.graph.replay()
        self.replays += 1
        for k, v in self.launches.items():
            kernels.LAUNCHES[k] += v
        return self.outputs


def graph_totals(graphs) -> dict:
    """Summed capture stats of several graphs (the report's keys)."""
    graphs = list(graphs)
    nodes = [g.nodes for g in graphs]
    return {"graphs": len(graphs),
            "capture_s": sum(g.capture_s for g in graphs),
            "instantiate_s": sum(g.instantiate_s for g in graphs),
            "nodes": None if None in nodes else sum(nodes),
            "graph_device_bytes": sum(g.device_bytes for g in graphs),
            "graph_host_bytes": sum(g.host_bytes for g in graphs),
            "replays": sum(g.replays for g in graphs)}


def warm_up(step, keys, stream) -> float:
    """Run ``step(i)`` for one index of every distinct shape key on
    ``stream`` (the card's capture stream) before a capture, holding
    ``MATH_LOCK`` (cuBLAS handles, workspaces and the kernel's launch
    attributes come into being outside the graph); waits for it and
    returns the seconds taken.  ``keys`` maps an index to its shape
    key."""
    t0 = time.perf_counter()
    seen = {}
    for i, key in keys:
        seen.setdefault(key, i)
    with MATH_LOCK:
        stream.wait_stream(torch.cuda.current_stream(stream.device))
        with torch.cuda.stream(stream):
            for i in seen.values():
                step(i)
        stream.synchronize()
    return time.perf_counter() - t0


def check_graph_scatter(scatter) -> None:
    """A graph holds the kernel only: the plain front assembly finds its
    child rounds with host syncs, which a capture cannot hold."""
    if scatter is not KERNELS:
        raise ValueError("graph executors run the front-assembly kernel "
                         "only (scatter=KERNELS)")


class FusedExecutor(StreamExecutor):
    """Callable factorization ``ex(avals, thresh) -> (fronts, tiny)``: the
    level-granularity streamed executor with one wave of every group — one
    CUDA graph on the card, captured at the first call and replayed by
    the later ones; the eager group loop on the CPU.  No offload and no
    host share: the JAX package's fused program has neither, so on the
    card the card's rule refuses it where it does not fit
    (``stream.offload_rule``)."""

    name = "fused"
    progress_waves = False
    offloads = False

    def __init__(self, plan: FactorPlan, dtype=torch.float64, device="cuda",
                 gemm_prec: str | None = None, scatter=KERNELS,
                 panel=PANEL):
        # "auto" under the card's rule: "none", or refused where the graph
        # does not fit
        super().__init__(plan, dtype, device, gemm_prec=gemm_prec,
                         offload="auto", granularity="level",
                         scatter=scatter, panel=panel)

    def waves(self) -> list:
        n = len(self.plan.groups)
        return [(0, n)] if n else []

    def _issue_span(self, tracer, t0, lo, hi) -> None:
        tracer.complete("issue fused", "dispatch", t0,
                        time.perf_counter() - t0, groups=hi - lo)

    def _kernel_spans(self, tracer, clock) -> list:
        """The JAX ``factor-fused`` span: the whole factorization as one
        aggregate (its ``last_profile`` entry has level -1, batch the
        fronts, m, w and u the maxima)."""
        groups = self.plan.groups
        executed = float(sum(g.batch * _front_flops(g.w, g.u)
                             for g in groups))
        structural = float(self.plan.flops)
        prof = []
        for t0, dt, _ in clock.read():
            tracer.complete("factor-fused", "kernel", t0, dt,
                            n_groups=len(groups), aggregate=True,
                            executed_flops=executed,
                            structural_flops=structural,
                            padding=round(executed / max(structural, 1.0),
                                          4))
            prof.append({"level": -1, "aggregate": True, "host": False,
                         "batch": sum(g.batch for g in groups),
                         "m": max(g.m for g in groups),
                         "w": max(g.w for g in groups),
                         "u": max(g.u for g in groups),
                         "seconds": dt, "gflop": structural / 1e9})
        return prof
