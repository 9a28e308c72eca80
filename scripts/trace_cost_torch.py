#!/usr/bin/env python
"""What tracing costs a FACT of the port on the card.

    python scripts/trace_cost_torch.py [NX] [REPS]

Factors poisson3d(NX) (default 48; float32 at the default tier, the
stream executor) on the card, after one warm FACT, REPS times (default
3) in each of five modes, in turns: untraced; under a profiling tracer
whose records go nowhere (the kernel clock's CUDA events and the span
arguments, no file); under one whose JSONL lines go to memory (the
records' encoding, no write); under a file tracer (``obs.trace.Tracer``,
what ``SLU_TPU_TRACE`` installs); and under a file tracer with Python's
garbage collector off.  Prints one JSON line: the walls per mode (a
synchronized end each), and the host functions that took most of one
traced FACT's time under ``cProfile`` (cumulative and own seconds).
Needs a CUDA device; exits 2 without one.
"""

import cProfile
import gc
import json
import os
import pstats
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("trace_cost_torch: needs a CUDA device", file=sys.stderr)
        return 2
    import superlu_dist_tpu_torch as slt
    from superlu_dist_tpu_torch.models.gallery import poisson3d
    from superlu_dist_tpu_torch.numeric import factor
    from superlu_dist_tpu_torch.obs import trace

    nx = int(sys.argv[1]) if len(sys.argv) > 1 else 48
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    lu, bvals, _ = slt.analyze(slt.Options(), poisson3d(nx), device="cuda")
    tmp = tempfile.mkdtemp(prefix="slt_trace_cost_")

    class Sink(trace.Tracer):
        """A profiling tracer whose records are dropped."""

        def _record(self, *args, **kw):
            pass

    class Memory(trace.Tracer):
        """A file tracer whose JSONL lines go to memory."""

        def __init__(self, path):
            import io
            super().__init__(path)
            self._jsonl.close()        # the clock anchor's file
            self._jsonl = io.StringIO()

    def fact():
        factor.numeric_factorize(lu.plan, bvals, lu.anorm,
                                 dtype=torch.float32, device="cuda",
                                 executor="stream")

    def run(mode):
        make = {"untraced": lambda path: None, "sink": Sink,
                "memory": Memory, "file": trace.Tracer,
                "file_nogc": trace.Tracer}[mode]
        tracer = make(os.path.join(tmp, f"{mode}.json"))
        prev = trace.install(tracer) if tracer else None
        torch.cuda.synchronize()
        if mode == "file_nogc":
            gc.disable()
        t0 = time.perf_counter()
        try:
            fact()
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        finally:
            gc.enable()
            if tracer:
                trace.install(prev)
                tracer.close()

    fact()
    torch.cuda.synchronize()
    walls = {m: [] for m in ("untraced", "sink", "memory", "file",
                             "file_nogc")}
    for _ in range(reps):
        for m in walls:
            walls[m].append(run(m))
    tracer = trace.Tracer(os.path.join(tmp, "p.json"))
    prev = trace.install(tracer)
    prof = cProfile.Profile()
    try:
        prof.enable()
        fact()
        torch.cuda.synchronize()
        prof.disable()
    finally:
        trace.install(prev)
        tracer.close()
    stats = pstats.Stats(prof)
    rows = sorted(((v[3], v[2], f"{k[0].rsplit('/', 2)[-1]}:{k[1]}:{k[2]}")
                   for k, v in stats.stats.items()), reverse=True)
    print(json.dumps({
        "n": lu.n, "groups": len(lu.plan.groups),
        "device": torch.cuda.get_device_name(0), "walls_s": walls,
        "median_s": {m: sorted(w)[len(w) // 2] for m, w in walls.items()},
        "traced_cumulative_s": [(f, round(c, 6), round(t, 6))
                                for c, t, f in rows[:25]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
