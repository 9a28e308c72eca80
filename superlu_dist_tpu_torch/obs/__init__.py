"""Observability subsystem (port of the JAX package's ``obs/``).

* ``obs.trace``     — structured span tracer (``SLU_TPU_TRACE=<path>``):
  nested spans with categories (phase / dispatch / kernel / comm /
  verify / request), emitted as Chrome trace-event JSON
  (Perfetto-loadable) plus a crash-safe JSONL sidecar, with a
  wall-clock anchor event;
* ``obs.flightrec`` — the flight recorder (``SLU_TPU_FLIGHTREC``): a
  bounded ring of recent spans dumped as a postmortem JSON artifact on
  structured errors and SIGTERM;
* ``obs.metrics``   — serving-grade labeled counters/gauges/histograms
  (``SLU_TPU_METRICS``) with JSON + Prometheus exports;
* ``obs.slo``       — per-ticket request tracing (``TicketContext``), the
  always-on latency accounter and the SLO evaluator;
* ``obs.kernelspans`` — the factor executors' kernel spans and profile
  record, timed by CUDA events.

Every span is a host timestamp around a call that already synchronizes,
or (a kernel span) the device time between two CUDA events read after
it: with tracing and metrics off nothing is recorded, and with them on
the factorization and the solve issue no extra device work and no extra
sync.  The JAX package's compile census (``obs/compilestats.py``) is not
ported: it measures JAX compile caches.
"""

from superlu_dist_tpu_torch.obs.trace import (      # noqa: F401
    CATEGORIES, NULL_SPAN, NULL_TRACER, NullTracer, TeeTracer, Tracer,
    complete, enabled, get_tracer, install, span)
