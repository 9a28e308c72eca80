"""The fused and mega executors on a grid: the 2-D mesh executor's group
programs captured as segment graphs.

The JAX package builds both over a mesh — ``make_factor_fn(plan, mesh=,
pool_partition=)`` traces the whole group loop into one GSPMD program
(numeric/factor.py:240-388), ``MegaExecutor(mesh=, pool_partition=)``
one program per closed bucket (numeric/mega.py:75-147).  Here a grid is
one process per rank, and its collectives — each panel's broadcast over
the process row (``ProcessGrid.bcast_row``) and each group's exchange
(``ProcessGrid.exchange``) — run on gloo through host memory, which no
CUDA graph can hold.  So each rank captures the rank-local launches
between two collectives as one graph (a *segment*):

* a group program (``MeshStreamExecutor._group``, a generator) yields at
  every collective; the launches before the first yield, between two
  yields and after the last are the group's segments — per group one
  more than it has broadcasts, plus the one after its exchange;
* at the first call each segment is captured (``numeric/fused.Graph``,
  after a warm-up of every group shape on the capture stream with the
  collectives answered locally — ``warm_up``), replayed at once, and the
  collective after it runs eagerly and writes its result into a static
  buffer the next segment's graph reads (``bcast_row(out=)``,
  ``exchange(out=)``); a later call (refactor, SamePattern, the ladder)
  replays the segments with the collectives eagerly between them;
* the pattern values, the threshold, the pool and the tiny count are
  static buffers; the fronts and pivot stacks are the graphs' outputs,
  cloned out after each replay; the tiny count's all-reduce stays eager
  at the end.

:class:`MeshFusedExecutor` keeps one graph per (group, segment).
:class:`MeshLevelExecutor` (``MeshStreamExecutor(granularity="level")``)
keeps one per (schedule wave, segment): a wave's group programs run as
one program, so the launches after a group's exchange and those of the
next group up to its first collective are one graph, and a wave of k
groups has k − 1 graphs fewer than the fused executor has for them.
:class:`MeshMegaExecutor` keeps one per (closed key, segment position):
a closed key is a group shape (w, u) and whether this rank's process row
has slots in it; the row's slots are padded to the key's rung (identity
fronts, ``ws`` 0), the exchange's segment tables to the key's largest
(a dump segment into a dump element of the pivot stack and of the pool),
and the group's tables are copied into the key's static buffers before
its replays, as ``numeric/mega.py`` does on one card.  Both keep their
graphs in one private pool: a group's segments replay in their capture
order and its outputs are cloned out before the next group's, so no
graph's data is live while another's replay reuses its memory.

On the CPU both run the same programs eagerly — the fused one bit for
bit the 2-D executor's, the mega one on its padded tables, also bit for
bit.  A failed capture or replay raises; nothing falls back.  NCCL
capture of the collectives inside the graphs is ROADMAP work: the
segments do not depend on it.
"""

from __future__ import annotations

import types
import warnings

import numpy as np
import torch

from superlu_dist_tpu_torch.numeric.plan import bucket_rung
from superlu_dist_tpu_torch.parallel.layout2d import Segments
from superlu_dist_tpu_torch.parallel.mesh_stream import (Exchange,
                                                         MeshStreamExecutor,
                                                         _segments, drive,
                                                         share_maps)


class _Done:
    """A group program's end, captured as the last segment's output."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


def _advance(program, reply):
    """The program's next request (or :class:`_Done`) after ``reply``."""
    try:
        return program.send(reply)
    except StopIteration as done:
        return _Done(done.value)


class _GridGraphs(MeshStreamExecutor):
    """The 2-D mesh executor whose group programs run as segment graphs
    on the card (module docstring); the subclasses say which program
    state a group runs on and how its graphs are kept."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._static = None        # the call's static buffers on the card
        self._stream = None        # the capture stream
        self._warmed = False
        self.graph_stats = {}
        self.last_warm_up_launches = 0

    # ---- what every call reads --------------------------------------------

    def _begin(self, timings):
        self.last_warm_up_launches = 0
        if self.device.type == "cuda":
            from superlu_dist_tpu_torch.numeric.fused import (
                check_graph_scatter)
            if timings is not None:
                raise ValueError("timings synchronize the device: the "
                                 "segment graphs cannot hold them")
            check_graph_scatter(self.scatter)
        super()._begin(timings)

    def _collective_sizes(self, rows) -> tuple:
        """(elements of the largest panel broadcast, of the largest
        exchange) this rank receives, with ``rows[gi]`` local slots in
        group gi."""
        bcast = recv = 0
        for gi, (grp, gl) in enumerate(zip(self.plan.groups,
                                           self.layout.groups)):
            if rows[gi] and self.grid.npcol > 1:
                from superlu_dist_tpu_torch.ops.dense import panel_width
                bcast = max(bcast, rows[gi] * gl.m_ext
                            * panel_width(grp.w)[0])
            recv = max(recv, int(np.sum(gl.recv_counts)))
        return bcast, recv

    def _buffers(self, avals, thresh):
        if self.device.type != "cuda":
            bufs = super()._buffers(avals, thresh)
            bufs.got, bufs.bcast = self._got_buffer(self.device), None
            return bufs
        if self._static is None:
            dev = self.device
            real = torch.empty((), dtype=self.dtype).real.dtype
            pool = torch.zeros(self._pool_len(), dtype=self.dtype,
                               device=dev)
            bcast, _ = self._collective_sizes(self._rows())
            self._static = types.SimpleNamespace(
                avals=torch.zeros(avals.shape[0], dtype=self.dtype,
                                  device=dev),
                thresh=torch.ones((), dtype=real, device=dev), pool=pool,
                kpool=pool[:self.layout.pool_len],
                tiny=torch.zeros((), dtype=torch.int64, device=dev),
                bcast=torch.empty(max(bcast, 1), dtype=self.dtype,
                                  device=dev),
                got=self._got_buffer(dev))
            self._stream = torch.cuda.Stream(dev)
        st = self._static
        st.avals.copy_(avals.to(dtype=self.dtype))
        st.thresh.copy_(thresh)
        st.pool.zero_()
        st.tiny.zero_()
        return st

    def _got_buffer(self, device):
        recv = self._collective_sizes(self._rows())[1]
        return torch.empty(max(recv, 1), dtype=self.dtype, device=device)

    def _rows(self) -> list:
        """Local slots per group in this executor's programs."""
        return [len(gl.slots) for gl in self.layout.groups]

    def _static_collective(self, bufs):
        """``_collective`` writing into the call's static buffers: a
        broadcast's result lands in ``bufs.bcast`` on a rank that does
        not own the panel, an exchange's in ``bufs.got`` (the whole
        buffer is the reply: the puts' padding reads past the data)."""
        def run(req):
            if isinstance(req, Exchange):
                self._collective(req, out=bufs.got)
                return bufs.got
            t, owner, shape = req
            out = None
            if owner != self.grid.pcol and bufs.bcast is not None:
                out = bufs.bcast[:int(np.prod(shape))].view(shape)
            return self._collective(req, out=out)
        return run

    # ---- capture and replay -----------------------------------------------

    def _warm(self, states, bufs) -> None:
        """Each distinct group shape's program once on the capture
        stream, on scratch buffers, its collectives answered locally (a
        rank's own panel, zeros elsewhere): cuBLAS handles, workspaces
        and the kernel's launch attributes exist before any capture."""
        from superlu_dist_tpu_torch.numeric.fused import warm_up
        dev = self.device
        scratch = types.SimpleNamespace(
            avals=bufs.avals.clone(), thresh=bufs.thresh.clone(),
            pool=torch.zeros_like(bufs.pool), tiny=bufs.tiny.clone(),
            bcast=None, got=torch.zeros_like(bufs.got))
        scratch.kpool = scratch.pool[:self.layout.pool_len]

        def local(req):
            if isinstance(req, Exchange):
                return scratch.got
            t, owner, shape = req
            return t if owner == self.grid.pcol else torch.zeros(
                shape, dtype=self.dtype, device=dev)

        def step(gi):
            drive(self._group(gi, states(gi), scratch), local)

        from superlu_dist_tpu_torch.numeric import kernels
        keys = ((gi, (self._rows()[gi], grp.m, grp.w))
                for gi, grp in enumerate(self.plan.groups))
        before = dict(kernels.LAUNCHES)
        self.graph_stats["warm_up_s"] = warm_up(step, keys, self._stream)
        # the warm-up's launches are real ones, of the call that captures
        self.last_warm_up_launches = (kernels.LAUNCHES["front_assemble"]
                                      - before["front_assemble"])
        self._warmed = True

    def _capture(self, program, bufs, pool) -> list:
        """A group program's segments: each captured on the capture
        stream into ``pool`` (a graph pool handle), replayed, then the
        collective that ends it run into the static buffers.  Returns
        [(Graph, request or _Done)] — the last entry's ``_Done`` holds
        the program's outputs."""
        from superlu_dist_tpu_torch.numeric.fused import Graph
        run = self._static_collective(bufs)
        segs, reply = [], None
        while True:
            with warnings.catch_warnings():
                # a segment without a launch (a rank with nothing to do
                # before an exchange) is an empty graph: valid, a no-op
                warnings.filterwarnings("ignore", "The CUDA Graph is empty")
                graph = Graph(lambda: _advance(program, reply), self.device,
                              self._stream, pool=pool)
            graph.replay()
            req = graph.outputs
            segs.append((graph, req))
            if isinstance(req, _Done):
                return segs
            reply = run(req)

    def _replay(self, segs, gl, bufs):
        """One program's segments replayed, the collectives between them
        run eagerly — an exchange on group layout ``gl``'s counts (None:
        the captured request's own); returns the program's outputs."""
        run = self._static_collective(bufs)
        for graph, req in segs:
            graph.replay()
            if isinstance(req, _Done):
                return req.value
            if isinstance(req, Exchange) and gl is not None:
                req = Exchange(req.send, gl)
            run(req)
        raise RuntimeError("a segment list without its end")

    def _graphs(self) -> list:
        raise NotImplementedError

    def report(self) -> dict:
        from superlu_dist_tpu_torch.numeric.fused import graph_totals
        rep = super().report()
        graphs = self._graphs()
        if graphs:
            rep.update(graph_totals(graphs), segments=len(graphs),
                       **self.graph_stats)
        rep["warm_up_launches"] = self.last_warm_up_launches
        return rep


class MeshFusedExecutor(_GridGraphs):
    """``Options(executor="fused")`` on a grid of several ranks: every
    group's segments captured at the first call and replayed by the later
    ones — one graph per (group, segment), kept per (plan, dtype, tier,
    grid) in ``numeric/factor.get_executor``'s cache.  No offload: the
    JAX fused program has none."""

    name = "mesh-fused"

    def __init__(self, plan, dtype, device, grid, gemm_prec=None,
                 scatter=None, pool_partition=False, panel=None):
        super().__init__(plan, dtype, device, grid, gemm_prec=gemm_prec,
                         scatter=scatter, pool_partition=pool_partition,
                         offload="none", panel=panel)
        self._segs = {}            # group -> its segments

    def _run_group(self, gi, bufs):
        if self.device.type != "cuda":
            return super()._run_group(gi, bufs)
        states = self._device_state()
        if not self._warmed:
            self._warm(lambda g: states[g], bufs)
            self._pool = torch.cuda.graph_pool_handle()
        segs = self._segs.get(gi)
        if segs is None:
            segs = self._segs[gi] = self._capture(
                self._group(gi, states[gi], bufs), bufs, self._pool)
            out = segs[-1][1].value
        else:
            out = self._replay(segs, self.layout.groups[gi], bufs)
        return self._finish(gi, *out, clone=True)

    def _graphs(self) -> list:
        return [g for segs in self._segs.values() for g, _ in segs]


class MeshLevelExecutor(_GridGraphs):
    """``MeshStreamExecutor(granularity="level")``: the 2-D executor run
    wave by wave.  On the card each schedule wave's group programs run as
    one program whose segments are captured at the first call and
    replayed by the later ones, the collectives eagerly between them —
    one graph per (wave, segment), kept in one private pool; on the CPU
    the groups' programs run eagerly, bit for bit the "group"
    granularity's.  Offload as on the 2-D executor: a wave's groups go to
    host memory after its last segment."""

    name = "mesh-stream"

    def __init__(self, *args, granularity="level", **kw):
        super().__init__(*args, granularity=granularity, **kw)
        self._segs = {}            # wave (its first group) -> its segments

    def _wave(self, lo, hi, states, bufs):
        """Groups lo..hi-1's programs as one program: the outputs of
        each, in order."""
        outs = []
        for gi in range(lo, hi):
            outs.append((yield from self._group(gi, states[gi], bufs)))
        return outs

    def _run_unit(self, lo, hi, bufs) -> list:
        if self.device.type != "cuda":
            return super()._run_unit(lo, hi, bufs)
        states = self._device_state()
        if not self._warmed:
            self._warm(lambda g: states[g], bufs)
            self._pool = torch.cuda.graph_pool_handle()
        segs = self._segs.get(lo)
        if segs is None:
            segs = self._segs[lo] = self._capture(
                self._wave(lo, hi, states, bufs), bufs, self._pool)
            outs = segs[-1][1].value
        else:
            outs = self._replay(segs, None, bufs)
        return [self._finish(gi, *o, clone=True)
                for gi, o in zip(range(lo, hi), outs)]

    def _graphs(self) -> list:
        return [g for segs in self._segs.values() for g, _ in segs]


def _pad_segments(seg, rows: int, total: int, dump: int) -> Segments:
    """``seg`` padded to ``rows`` segments covering ``total`` elements: a
    zero-length tail, then one last segment of the missing elements at
    ``dump`` (stride 0) reading buffer positions from 0."""
    n = len(seg.length)
    out = [np.zeros(rows, dtype=np.int64) for _ in range(4)]
    for arr, src in zip(out, (seg.start, seg.length, seg.stride, seg.buf)):
        arr[:n] = src
    out[0][-1], out[1][-1] = dump, total - seg.total
    return Segments(*out)


class MeshMegaExecutor(_GridGraphs):
    """``Options(executor="mega")`` on a grid of several ranks: one graph
    per (closed key, segment position) — a closed key is (w, u, this
    process row has slots) — the group's padded tables copied into the
    key's static buffers before its replays (module docstring).  Offload
    as on the 2-D executor (the JAX MegaExecutor streams too)."""

    name = "mesh-mega"

    def __init__(self, plan, dtype, device, grid, gemm_prec=None,
                 scatter=None, pool_partition=False, offload="auto",
                 front_bytes_limit=6e9, offload_lag=8, panel=None):
        super().__init__(plan, dtype, device, grid, gemm_prec=gemm_prec,
                         scatter=scatter, pool_partition=pool_partition,
                         offload=offload, front_bytes_limit=front_bytes_limit,
                         offload_lag=offload_lag, panel=panel)
        self.key_of = [(g.w, g.u, bool(len(gl.slots)))
                       for g, gl in zip(plan.groups, self.layout.groups)]
        self.spec = {}
        for g, gl, key in zip(plan.groups, self.layout.groups, self.key_of):
            rows, batch = self.spec.get(key, (0, 0))
            self.spec[key] = (max(rows, len(gl.slots)), max(batch, g.batch))
        self.spec = {k: (bucket_rung(r, lo=1, growth=2.0) if r else 0,
                         bucket_rung(b, lo=1, growth=2.0))
                     for k, (r, b) in self.spec.items()}
        self._tables = None        # per group: its padded state
        self._keys = {}            # key -> (static state, segments)

    @property
    def closed_keys(self) -> int:
        return len(self.spec)

    def _padded_batch(self, gi) -> int:
        return self.spec[self.key_of[gi]][1]

    def _pool_len(self) -> int:
        return self.layout.pool_len + 1          # the dump element

    def _rows(self) -> list:
        return [self.spec[k][0] for k in self.key_of]

    def _padded_tables(self):
        """Per group: its program state at the key's padded shapes — the
        share's maps at the key's rung of slots, the pivot stack at the
        key's batch rung plus a dump element, every segment table at the
        key's largest count and total."""
        if self._tables is not None:
            return self._tables
        plan, dev = self.plan, self.device
        pool_dump = self.layout.pool_len
        kinds = ("send", "recv_piv", "recv_pool")
        most = {}
        for key, gl in zip(self.key_of, self.layout.groups):
            segs = [getattr(gl, k) for k in kinds] + [gl.self_piv[0],
                                                      gl.self_pool[0]]
            old = most.get(key, [(0, 0)] * len(segs))
            most[key] = [(max(n, len(s.length)), max(t, s.total))
                         for (n, t), s in zip(old, segs)]
        out = []
        for gi, (grp, gl, key) in enumerate(zip(plan.groups,
                                                self.layout.groups,
                                                self.key_of)):
            rows, b_pad = self.spec[key]
            piv_dump = b_pad * grp.w * grp.w
            (ns, ts), (npv, tpv), (npl, tpl), (nsp, tsp), (nso, tso) = \
                [(n + 1, t) for n, t in most[key]]
            frm_p, to_p = gl.self_piv
            frm_o, to_o = gl.self_pool
            out.append(dict(
                maps=share_maps(gl, dev, batch=rows)
                if rows and gl.mc else None,
                ws=torch.as_tensor(np.pad(np.asarray(gl.maps.ws, np.int64),
                                          (0, rows - len(gl.slots))),
                                   device=dev),
                rows=rows, piv_len=piv_dump + 1,
                send=_segments(_pad_segments(gl.send, ns, ts, 0), dev),
                piv=_segments(_pad_segments(gl.recv_piv, npv, tpv,
                                            piv_dump), dev),
                pool=_segments(_pad_segments(gl.recv_pool, npl, tpl,
                                             pool_dump), dev),
                self_piv=[_segments(_pad_segments(frm_p, nsp, tsp, 0), dev),
                          _segments(_pad_segments(to_p, nsp, tsp, piv_dump),
                                    dev)],
                self_pool=[_segments(_pad_segments(frm_o, nso, tso, 0), dev),
                           _segments(_pad_segments(to_o, nso, tso,
                                                   pool_dump), dev)]))
        self._tables = out
        return out

    def _key_state(self, key):
        """A closed key's static state on the card: every tensor of a
        group's padded state at the key's largest size, filled by
        ``_load`` before each replay."""
        from superlu_dist_tpu_torch.numeric import kernels
        hit = self._keys.get(key)
        if hit is not None:
            return hit[0]
        tables = [t for t, k in zip(self._padded_tables(), self.key_of)
                  if k == key]
        first = tables[0]

        def like(ts):
            return torch.zeros((max(t.shape[0] for t in ts),)
                               + tuple(ts[0].shape[1:]), dtype=ts[0].dtype,
                               device=self.device)

        def seg(name, i=None):
            parts = [t[name] if i is None else t[name][i] for t in tables]
            d = {k: like([p[k] for p in parts])
                 for k in ("start", "length", "stride", "buf", "first")}
            d["total"] = parts[0]["total"]
            return d

        maps = None
        if first["maps"] is not None:
            fm0 = first["maps"]
            fronts = [t["maps"].front for t in tables]
            tens = [like([fm.tensors()[k] for fm in fronts])
                    for k in range(6)]
            front = kernels.FrontMaps(
                fm0.front.kind, fm0.front.batch, fm0.front.m,
                fm0.front.pool_len, *tens,
                pairs=max(fm.pairs for fm in fronts), mc=fm0.front.mc,
                cols=fm0.front.cols)
            maps = kernels.GroupMaps(
                ws=like([t["maps"].ws for t in tables]), off=fm0.off,
                a_slot=fm0.a_slot[:0], a_flat=fm0.a_flat[:0],
                a_src=fm0.a_src[:0], children=[], front=front,
                gcol=fm0.gcol)
        state = dict(maps=maps, ws=like([t["ws"] for t in tables]),
                     rows=first["rows"], piv_len=first["piv_len"],
                     send=seg("send"), piv=seg("piv"), pool=seg("pool"),
                     self_piv=[seg("self_piv", 0), seg("self_piv", 1)],
                     self_pool=[seg("self_pool", 0), seg("self_pool", 1)])
        self._keys[key] = (state, None)
        return state

    @staticmethod
    def _load(state, table) -> None:
        """Copy one group's padded tables into its key's static state
        (each into the front of its buffer)."""
        def put(dst, src):
            dst.view(-1)[:src.numel()].copy_(src.view(-1))
        put(state["ws"], table["ws"])
        if state["maps"] is not None:
            put(state["maps"].ws, table["maps"].ws)
            for dst, src in zip(state["maps"].front.tensors(),
                                table["maps"].front.tensors()):
                put(dst, src)
        for name in ("send", "piv", "pool"):
            for k in ("start", "length", "stride", "buf", "first"):
                put(state[name][k], table[name][k])
        for name in ("self_piv", "self_pool"):
            for d, s in zip(state[name], table[name]):
                for k in ("start", "length", "stride", "buf", "first"):
                    put(d[k], s[k])

    def _run_group(self, gi, bufs):
        tables = self._padded_tables()
        if self.device.type != "cuda":
            return self._finish(gi, *drive(
                self._group(gi, tables[gi], bufs),
                self._static_collective(bufs)))
        key = self.key_of[gi]
        if not self._warmed:
            self._warm(lambda g: tables[g], bufs)
            # one private pool for every key's graphs: a group's segments
            # run to their end and its outputs are cloned out before any
            # other group's replay, so no key's data is live while
            # another key's graphs run (numeric/mega.py keeps a pool per
            # bucket on one card)
            self._pool = torch.cuda.graph_pool_handle()
        state = self._key_state(key)
        self._load(state, tables[gi])
        segs = self._keys[key][1]
        if segs is None:
            segs = self._capture(self._group(gi, state, bufs), bufs,
                                 self._pool)
            self._keys[key] = (state, segs)
            out = segs[-1][1].value
        else:
            out = self._replay(segs, self.layout.groups[gi], bufs)
        return self._finish(gi, *out, clone=True)

    def _graphs(self) -> list:
        return [g for _, segs in self._keys.values() if segs
                for g, _ in segs]

    def report(self) -> dict:
        rep = super().report()
        rep["closed_keys"] = self.closed_keys
        return rep
