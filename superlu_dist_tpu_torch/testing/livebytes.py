"""Device memory on the CPU: the distinct storages torch ops create and
keep alive, and their peak (:class:`LiveBytes`) — on the card
``torch.cuda.max_memory_allocated`` reads it; the grid's CPU ranks hold
the card's rule's estimates (``device_estimate``) against this.

    python -m superlu_dist_tpu_torch.testing.livebytes NX [closed] [DTYPE]

runs the 2-D stream through ``pgssvx(grid=)`` with the partitioned pool
on a 2×2 gloo grid of CPU ranks over poisson3d(NX) (the closed plan with
``closed``; float32 by default) and prints each rank's peak from the
start of FACT to the end of the call beside its estimate, with the
sites that held the most at the peak.
"""

from __future__ import annotations

import sys
import traceback
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

#: storages at least this large note where they were made
_SITE_BYTES = 1 << 14


class LiveBytes(TorchDispatchMode):
    """Inside the mode, every CPU storage an op returns counts from its
    first tensor until its last one is gone: ``bytes`` now, ``peak`` the
    most at once, ``at_peak`` {site: bytes} then (a site: the op and the
    last three package frames that called it).  ``quiet(fn)`` runs
    ``fn`` uncounted but its outputs: the plain versions of the card's
    kernels, whose temporaries the kernels do not make."""

    def __init__(self):
        super().__init__()
        self.live = {}             # data_ptr -> [nbytes, {tensor id}, site]
        self.bytes = self.peak = 0
        self.at_peak = {}
        self._quiet = 0

    def note(self, t, site="") -> None:
        if not isinstance(t, torch.Tensor) or t.device.type != "cpu":
            return
        st = t.untyped_storage()
        key, nb = st.data_ptr(), st.nbytes()
        if nb == 0:
            return
        ent = self.live.get(key)
        if ent is None or ent[0] != nb:
            if ent is not None and ent[1]:
                self.bytes -= ent[0]
            ent = self.live[key] = [nb, set(), site]
            self.bytes += nb
        if id(t) in ent[1]:
            return
        ent[1].add(id(t))
        weakref.finalize(t, self._gone, key, id(t), ent)
        if self.bytes > self.peak:
            self.peak = self.bytes
            sites = {}
            for nb_, ids, where in self.live.values():
                if ids:
                    sites[where] = sites.get(where, 0) + nb_
            self.at_peak = sites

    def _gone(self, key, tid, ent) -> None:
        ent[1].discard(tid)
        if not ent[1] and self.live.get(key) is ent:
            self.bytes -= ent[0]
            del self.live[key]

    def quiet(self, fn):
        def run(*args, **kw):
            self._quiet += 1
            try:
                out = fn(*args, **kw)
            finally:
                self._quiet -= 1
            for t in out if isinstance(out, (tuple, list)) else (out,):
                self.note(t, getattr(fn, "__name__", "kernel"))
            return out
        return run

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self._quiet:
            return out
        site = None
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if site is None and isinstance(t, torch.Tensor) \
                    and t.untyped_storage().nbytes() >= _SITE_BYTES:
                frames = [f for f in traceback.extract_stack()
                          if "superlu_dist_tpu_torch" in f.filename][-4:-1]
                site = " < ".join(
                    [str(func)] + [f"{f.filename.rsplit('/', 1)[-1]}:"
                                   f"{f.lineno}" for f in reversed(frames)])
            self.note(t, site or str(func))
        return out


def trace_pgssvx(tc, grid, a, b, options):
    """``pgssvx(tc, options, ...)`` on this rank's block rows of ``a``
    and ``b`` with the 2-D stream's device memory traced from the start
    of FACT (the analysis before it runs untraced, as on the card the
    peak is reset after it) to the end of the call, the scatter and the
    panel LU quiet: (x, lu, {peak, estimate — the executor's
    ``device_estimate()`` —, at_peak})."""
    from superlu_dist_tpu_torch.drivers import gssvx as drivers
    from superlu_dist_tpu_torch.parallel import mesh_stream
    from superlu_dist_tpu_torch.parallel.dist import distribute_rows
    from superlu_dist_tpu_torch.parallel.pgssvx import pgssvx
    mode, rec = LiveBytes(), {}
    init = mesh_stream.MeshStreamExecutor.__init__
    factorize = drivers.factorize_numeric

    def traced_init(self, *args, **kw):
        init(self, *args, **kw)
        rec["estimate"] = self.device_estimate()
        self.scatter = mode.quiet(self.scatter)
        self.panel = mode.quiet(self.panel)

    def traced_factorize(*args, **kw):
        mode.__enter__()
        return factorize(*args, **kw)
    part = distribute_rows(a, grid.nproc)[grid.rank]
    b_loc = b[part.fst_row:part.fst_row + part.m_loc]
    lu_out = {}
    mesh_stream.MeshStreamExecutor.__init__ = traced_init
    drivers.factorize_numeric = traced_factorize
    try:
        x, info = pgssvx(tc, options, part, b_loc, grid=grid, lu_out=lu_out)
    finally:
        mesh_stream.MeshStreamExecutor.__init__ = init
        drivers.factorize_numeric = factorize
        if mode in _get_current_dispatch_mode_stack():
            mode.__exit__(None, None, None)
    if info != 0:
        raise RuntimeError(f"pgssvx info {info}")
    rec.update(peak=mode.peak, at_peak=mode.at_peak)
    return x, lu_out["lu"], rec


def _rank(tc, grid, nx, closed, dtype):
    import superlu_dist_tpu_torch as slt
    from superlu_dist_tpu_torch.models.gallery import poisson3d
    a = poisson3d(nx)
    b = a.matvec(np.random.default_rng(0).standard_normal(a.n_rows))
    _, _, rec = trace_pgssvx(tc, grid, a, b, slt.Options(
        executor="stream", pool_partition=True, bucket_closed=closed,
        factor_dtype=dtype))
    return rec


def main(argv) -> int:
    from superlu_dist_tpu_torch.testing.ranks import run_mesh_ranks
    nx = int(argv[0])
    closed = "closed" in argv[1:]
    dtype = next((x for x in argv[1:] if x.startswith("float")), "float32")
    out = run_mesh_ranks(4, _rank, nx, closed, dtype, nprow=2,
                         timeout=1800)
    for r in sorted(out):
        rec = out[r]
        est = rec["estimate"]["bytes"]
        print(f"rank {r}: peak {rec['peak']:,} B, estimate {est:,} B, "
              f"{rec['peak'] / est:.3f} of it")
        for site, nb in sorted(rec["at_peak"].items(),
                               key=lambda kv: -kv[1])[:8]:
            print(f"    {nb:>14,}  {site}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
