"""The mega executor: one CUDA graph per closed shape bucket.

Port of the JAX package's ``numeric/mega.py``.  There, one jitted program
per closed (W, U) bucket takes every per-group variable — which fronts,
which A entries, which children — as data at canonical, rung-padded
shapes, so the compiled-program count is the closed key count whatever
the matrix size.  Here the program is a CUDA graph: per bucket one graph
of ``group_step`` on static buffers, captured at the first call:

* the batch is padded to the bucket's rung; padded slots are identity
  fronts (ws = 0) whose Schur block goes to a dump region past the pool;
* the front-assembly kernel's maps (built per group at the padded batch,
  ``kernels.front_map_arrays``) are copied into the bucket's static map
  buffers before each replay — the A-entry and child tables at the
  bucket's largest sizes, which the kernel reads only as far as the maps'
  own ranges say (the index sentinels of the JAX tables are dropped while
  the maps are built);
* the pool and the pattern values are padded to their store rungs
  (growth 1.25), as in the JAX package.

So the number of graphs is the number of closed keys.  Checkpoints store
the pool without its padding, so a mega checkpoint resumes under
``stream`` and the other way round (JAX mega.py:36-39).  On the CPU the
same padded steps run eagerly, bit for bit the streamed executor's.
"""

from __future__ import annotations

import numpy as np
import torch

from superlu_dist_tpu_torch.numeric import factor, kernels
from superlu_dist_tpu_torch.numeric.factor import KERNELS, PANEL
from superlu_dist_tpu_torch.numeric.plan import FactorPlan, bucket_rung
from superlu_dist_tpu_torch.numeric.stream import StreamExecutor

#: ladder growth of the pool and pattern-value stores (JAX mega.py:70)
_STORE_GROWTH = 1.25


def _pad_to(arr, length: int, fill) -> np.ndarray:
    out = np.full(length, fill, dtype=np.int64)
    out[:len(arr)] = arr
    return out


class MegaExecutor(StreamExecutor):
    """Callable factorization with a closed graph set: the streamed
    executor's loop (offload, checkpoints, resume and the deadline work
    the same), each group run by its bucket's graph on the card.  The
    host-share split is off, as in the JAX package (mega.py:145)."""

    name = "mega"

    def __init__(self, plan: FactorPlan, dtype=torch.float64, device="cuda",
                 gemm_prec: str | None = None, offload: str = "auto",
                 front_bytes_limit: float = 6e9, offload_lag: int = 8,
                 scatter=KERNELS, panel=PANEL):
        super().__init__(plan, dtype, device, gemm_prec=gemm_prec,
                         offload=offload, granularity="group",
                         host_flops=0.0, front_bytes_limit=front_bytes_limit,
                         offload_lag=offload_lag, scatter=scatter,
                         panel=panel)
        n_avals = len(plan.pattern_indices)
        self._P = bucket_rung(max(plan.pool_size, 1), lo=8,
                              growth=_STORE_GROWTH)
        self._AV = bucket_rung(max(n_avals, 1), lo=8, growth=_STORE_GROWTH)
        # the dump region takes the Schur blocks of padded and root slots
        self._dump = max([g.u * g.u for g in plan.groups] + [1])
        self.spec = {}
        for g in plan.groups:
            b = self.spec.get((g.w, g.u), 0)
            self.spec[(g.w, g.u)] = max(b, g.batch)
        self.spec = {k: bucket_rung(b, lo=1, growth=2.0)
                     for k, b in self.spec.items()}
        self._host_maps = None     # per group: padded numpy maps
        self._dev = None           # per group: padded maps on the card
        self._buckets = None       # per bucket: (static GroupMaps, Graph)
        self._static = None        # (avals, thresh, pool) on the card

    def _padded_batch(self, gi) -> int:
        """A group runs at its bucket's rung: its kernel span's
        ``padded_batch``."""
        g = self.plan.groups[gi]
        return self.spec[(g.w, g.u)]

    @property
    def n_graphs(self) -> int:
        """Graphs this executor captures on the card: one per bucket."""
        return len(self.spec)

    # ---- the padded per-group tables --------------------------------------

    def _group_arrays(self):
        """Per group: (batch rung, ws, off, the kernel's six maps, pairs)
        as numpy arrays at the bucket's padded batch."""
        if self._host_maps is None:
            plan, P = self.plan, self._P
            out = []
            for g in plan.groups:
                b = self.spec[(g.w, g.u)]
                off = np.where(np.asarray(g.off) >= plan.pool_size, P, g.off)
                front, pairs = kernels.front_map_arrays(
                    b, g.m, self._pool_len(),
                    a=(g.a_slot, g.a_flat, g.a_src),
                    children=[(cs.ub, cs.child_off, cs.child_slot, cs.rel)
                              for cs in g.children])
                out.append((b, _pad_to(g.ws, b, 0), _pad_to(off, b, P),
                            front, pairs))
            self._host_maps = out
        return self._host_maps

    def _pool_len(self) -> int:
        return self._P + self._dump

    def _maps(self):
        """The padded GroupMaps of every group on the CPU (the plain front
        assembly reads the plan's own tables), or their device tables on
        the card (copied into the bucket buffers before each replay)."""
        arrays = self._group_arrays()
        if self.device.type == "cuda":
            if self._dev is None:
                flat = [x for _, ws, off, front, _ in arrays
                        for x in (ws, off, *front)]
                views = iter(kernels.upload(flat, self.device))
                self._dev = [[next(views) for _ in range(8)] for _ in arrays]
            return self._dev
        maps = []
        for g, (b, ws, off, front, pairs) in zip(self.plan.groups, arrays):
            t = torch.as_tensor
            fm = kernels.FrontMaps("front_assemble", b, g.m,
                                   self._pool_len(), *map(t, front),
                                   pairs=pairs)
            maps.append(kernels.GroupMaps(
                ws=t(ws), off=t(off), a_slot=t(np.asarray(g.a_slot)),
                a_flat=t(np.asarray(g.a_flat)),
                a_src=t(np.asarray(g.a_src)),
                children=[(cs.ub, t(np.asarray(cs.child_off)),
                           t(np.asarray(cs.child_slot)), t(np.asarray(cs.rel)))
                          for cs in g.children], front=fm))
        return maps

    # ---- padded stores ----------------------------------------------------

    def _prep_avals(self, avals, device):
        av = avals.to(dtype=self.dtype)
        if device.type == "cuda":
            s_avals = self._statics(av)[0]
            s_avals[:av.shape[0]].copy_(av)
            return s_avals
        out = torch.zeros(self._AV, dtype=self.dtype, device=device)
        out[:av.shape[0]] = av
        return out

    def _new_pool(self, device):
        if device.type == "cuda":
            pool = self._statics()[2]
            pool.zero_()
            return pool
        return super()._new_pool(device)

    def _ckpt_pool(self, pool):
        # frontiers stay executor-portable: the pool without its padding
        return pool[:self.plan.pool_size]

    def _statics(self, avals=None):
        if self._static is None:
            dev = self.device
            real = torch.empty((), dtype=self.dtype).real.dtype
            self._static = (
                torch.zeros(self._AV, dtype=self.dtype, device=dev),
                torch.ones((), dtype=real, device=dev),
                torch.zeros(self._pool_len(), dtype=self.dtype, device=dev))
        return self._static

    # ---- one group ----------------------------------------------------------

    def _step(self, gi, avals, pool, thresh, maps, timings):
        grp = self.plan.groups[gi]
        b = self.spec[(grp.w, grp.u)]
        if self.device.type != "cuda":
            (lp, up), t = factor.group_step(
                (b, grp.m, grp.w, grp.u), avals, pool, thresh, maps[gi],
                gemm_prec=self.gemm_prec, scatter=self.scatter,
                timings=timings, panel=self.panel)
            return (lp[:grp.batch], up[:grp.batch]), t
        if timings is not None:
            raise ValueError("timings synchronize the device: the mega "
                             "graphs cannot hold them")
        s_avals, s_thresh, s_pool = self._statics()
        if avals is not s_avals or pool is not s_pool:
            raise ValueError("the mega graphs read the executor's own "
                             "avals and pool buffers")
        s_thresh.copy_(thresh)
        if self._buckets is None:
            self._capture(maps)
        smaps, graph = self._buckets[(grp.w, grp.u)]
        self._load(smaps, maps[gi])
        (lp, up), t = graph.replay()
        # the bucket's next replay rewrites the graph's fronts
        return (lp[:grp.batch].clone(), up[:grp.batch].clone()), t

    @staticmethod
    def _load(smaps, tables) -> None:
        """Copy one group's device tables into its bucket's static
        buffers (each table into the front of its buffer)."""
        fm = smaps.front
        for dst, src in zip((smaps.ws, smaps.off, *fm.tensors()), tables):
            dst.view(-1)[:src.numel()].copy_(src.view(-1))

    def _capture(self, maps) -> None:
        """Static buffers and one graph per bucket, after a warm-up of
        every bucket on a scratch pool (the static pool holds the
        factorization in progress)."""
        from superlu_dist_tpu_torch.numeric.fused import (
            Graph, check_graph_scatter)
        check_graph_scatter(self.scatter)
        plan, dev = self.plan, self.device
        s_avals, s_thresh, s_pool = self._statics()
        arrays = self._group_arrays()
        first = {}
        for gi, g in enumerate(plan.groups):
            first.setdefault((g.w, g.u), gi)
        buckets = {}
        for key, b in self.spec.items():
            gis = [gi for gi, g in enumerate(plan.groups)
                   if (g.w, g.u) == key]
            m = plan.groups[gis[0]].m
            size = [max(arrays[gi][3][k].shape[0] for gi in gis)
                    for k in range(6)]
            i64 = dict(dtype=torch.int64, device=dev)
            i32 = dict(dtype=torch.int32, device=dev)
            nb1 = arrays[gis[0]][3][0].shape[1]
            fm = kernels.FrontMaps(
                "front_assemble", b, m, self._pool_len(),
                torch.zeros((b, nb1), **i64),
                torch.zeros((max(size[1], 1), 2), **i64),
                torch.zeros(b + 1, **i64),
                torch.zeros((max(size[3], 1),
                             arrays[gis[0]][3][3].shape[1]), **i64),
                torch.zeros((max(size[4], 1), 2), **i32),
                torch.zeros(max(size[5], 1), **i32),
                pairs=max(arrays[gi][4] for gi in gis))
            smaps = kernels.GroupMaps(
                ws=torch.zeros(b, **i64), off=torch.zeros(b, **i64),
                a_slot=torch.zeros(0, **i64), a_flat=torch.zeros(0, **i64),
                a_src=torch.zeros(0, **i64), children=[], front=fm)
            buckets[key] = (smaps, m)
        stream = torch.cuda.Stream(dev)
        scratch = torch.zeros_like(s_pool)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            for key, (smaps, m) in buckets.items():
                self._load(smaps, maps[first[key]])
                factor.group_step((smaps.ws.shape[0], m, *key), s_avals,
                                  scratch, s_thresh, smaps,
                                  gemm_prec=self.gemm_prec,
                                  scatter=self.scatter, panel=self.panel)
        stream.synchronize()
        del scratch
        self._buckets = {}
        for key, (smaps, m) in buckets.items():
            dims = (smaps.ws.shape[0], m, *key)
            # a graph per private pool: the buckets replay interleaved
            self._buckets[key] = (smaps, Graph(
                lambda smaps=smaps, dims=dims: factor.group_step(
                    dims, s_avals, s_pool, s_thresh, smaps,
                    gemm_prec=self.gemm_prec, scatter=self.scatter,
                    panel=self.panel),
                dev, stream))

    def report(self) -> dict:
        from superlu_dist_tpu_torch.numeric.fused import graph_totals
        rep = super().report()
        rep["buckets"] = len(self.spec)
        if self._buckets:
            rep.update(graph_totals(g for _, g in self._buckets.values()))
        return rep
