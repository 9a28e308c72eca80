"""Kernel spans of the factor executors: the JAX stream's ``_trace_kernel``
(numeric/stream.py:670-690) and its profile record, timed on the card by
CUDA events.

Under a profiling tracer (``tracer.profiling``: the file tracer of
``SLU_TPU_TRACE``; the flight recorder alone is not one) an executor
opens one :class:`KernelClock` a call.  Around each group's launches (a
wave's or a segment's replay) it records a pair of
``torch.cuda.Event(enable_timing=True)`` on the current stream, and it
reads them once, after the synchronization its call makes anyway at its
end (the tiny count's transfer, or the grid's all-reduce of it).  So a
traced call adds no device sync and keeps the pace of an untraced one,
where the JAX stream blocks on every group.  A span's ``ts`` is the
host's issue time of its step, its ``dur`` the device time between the
step's two events.  On the CPU, where every op runs eagerly and
synchronously, a step is timed by ``perf_counter`` around it, as is a
host-share group on the card.

With no profiling tracer an executor makes no clock, creates no event
and leaves its ``last_profile`` as it was (None until a profiled call).
"""

from __future__ import annotations

import time

import torch

from superlu_dist_tpu_torch.symbolic.symbfact import _front_flops


class KernelClock:
    """The device time of a call's steps: :meth:`start` and :meth:`stop`
    bracket one step's launches, :meth:`read` gives (host issue time,
    seconds, the step's record) per step once the call has synchronized."""

    def __init__(self, device):
        device = torch.device(device)
        self.stream = (torch.cuda.current_stream(device)
                       if device.type == "cuda" else None)
        self.marks = []

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        return ev

    def start(self, host: bool = False):
        """A step's start: its host time and, for launches on the card,
        an event on the current stream (``host``: the step runs on the
        CPU, as a host-share group does)."""
        t0 = time.perf_counter()
        return t0, (self._event() if self.stream is not None and not host
                    else None)

    def stop(self, mark, record) -> None:
        t0, ev = mark
        end = time.perf_counter() if ev is None else self._event()
        self.marks.append((t0, ev, end, record))

    def read(self):
        """(host issue time, seconds, record) of every step, in order —
        only after the call's synchronization: the events must have
        completed."""
        for t0, ev, end, record in self.marks:
            dt = end - t0 if ev is None else ev.elapsed_time(end) / 1e3
            yield t0, dt, record


def kernel_span(tracer, t0: float, dt: float, *, level, b, m, w, u, nreal,
                host, gemm_prec: str, aggregate: bool = False,
                executed=None, structural=None, **extra) -> dict:
    """Record one ``lu b{b} m{m} w{w} u{u}`` span of category "kernel"
    with the JAX args — ``level``, ``batch`` (real: ``nreal``),
    ``padded_batch`` (``b``), ``m``, ``w``, ``u``, ``gemm_prec`` (the tier
    the arithmetic ran), ``host``, ``aggregate``, executed and structural
    flops (by default ``b`` and ``nreal`` fronts of ``_front_flops``) and
    their ratio ``padding`` — plus ``extra``; returns the step's
    ``last_profile`` entry (the JAX keys: a group's ``batch`` is its
    padded batch, an aggregate's the real one)."""
    fl = float(_front_flops(w, u))
    executed = float(b) * fl if executed is None else float(executed)
    structural = float(nreal) * fl if structural is None else float(structural)
    tracer.complete(f"lu b{b} m{m} w{w} u{u}", "kernel", t0, dt,
                    level=int(level), batch=int(nreal), padded_batch=int(b),
                    m=int(m), w=int(w), u=int(u), gemm_prec=gemm_prec,
                    host=bool(host), aggregate=bool(aggregate),
                    executed_flops=executed, structural_flops=structural,
                    padding=round(executed / max(structural, 1.0), 4),
                    **extra)
    prof = {"level": int(level), "batch": int(nreal if aggregate else b),
            "m": int(m), "w": int(w), "u": int(u), "host": bool(host),
            "seconds": dt, "gflop": structural / 1e9}
    if aggregate:
        prof["aggregate"] = True
    return prof


def wave_span(tracer, t0: float, dt: float, groups, gemm_prec: str,
              padded=None, host: bool = False, **extra) -> dict:
    """The aggregate span of a schedule wave (``groups``, consecutive
    ``Group`` records; ``padded`` their padded batches, default the real
    ones), as JAX ``_call_levels`` records it (stream.py:840-866): the
    batches summed, m, w and u the maxima, executed and structural flops
    summed over the groups."""
    padded = [g.batch for g in groups] if padded is None else list(padded)
    return kernel_span(
        tracer, t0, dt, level=groups[0].level, b=sum(padded),
        m=max(g.m for g in groups), w=max(g.w for g in groups),
        u=max(g.u for g in groups), nreal=sum(g.batch for g in groups),
        host=host, gemm_prec=gemm_prec, aggregate=True,
        executed=sum(float(p) * _front_flops(g.w, g.u)
                     for p, g in zip(padded, groups)),
        structural=sum(float(g.batch) * _front_flops(g.w, g.u)
                       for g in groups), **extra)
