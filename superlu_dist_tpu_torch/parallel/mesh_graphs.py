"""The fused, level and mega executors on a grid: the 2-D mesh
executor's group programs captured as CUDA graphs.

The JAX package builds them over a mesh as single programs —
``make_factor_fn(plan, mesh=, pool_partition=)`` traces the whole group
loop into one GSPMD program (numeric/factor.py:240-388),
``MegaExecutor(mesh=, pool_partition=)`` one program per closed bucket
(numeric/mega.py:75-147), each with its collectives as in-program ops.
Here a grid is one process per rank, and a group program
(``MeshStreamExecutor._group``, a generator) yields at each of its
collectives: each panel's broadcast over the process row
(``ProcessGrid.bcast_row``) and the group's exchange
(``ProcessGrid.exchange``).  What a rank captures depends on whether its
grid's collectives can be captured (``ProcessGrid.capturable``):

* **NCCL, each rank on a card of its own: one graph a unit.**  The whole
  program of a unit — a group (fused), a schedule wave (level), a closed
  key (mega) — is one graph: its collectives are answered inside the
  capture (``ProcessGrid.recording``: no host work, a record each) into
  the static buffers the later launches read (``bcast_row(out=)``,
  ``exchange(out=)``), so a replay launches one graph a unit and no
  collective runs from the host between two.  Verify mode checks the
  recorded collectives against the peers' once, before the graph's first
  replay (``ProcessGrid.check_tape``), and ``comm`` counts a graph's
  bytes at each replay (``ProcessGrid.replayed``).  Census site
  ``mesh_graphs.unit``, one record a graph.
* **gloo (ranks sharing a card): segments.**  gloo's collectives go
  through host memory, which no graph can hold, so each rank captures
  the launches between two collectives as one graph (a *segment*: per
  group one more than it has broadcasts, plus the one after its
  exchange) and runs each collective eagerly between two segment
  replays, into the same static buffers.  Census site
  ``mesh_graphs.segment``, one record a segment.

Either way, at the first call every group shape's program runs once on
the capture stream with its collectives answered locally (``warm_up``:
cuBLAS handles, workspaces and the kernel's launch attributes exist
before any capture, and the runtime audits' digest exchange runs there,
outside any capture); then each unit is captured, replayed at once, and
its outputs cloned out; a later call (refactor, SamePattern, the ladder)
replays.  The pattern values, the threshold, the pool and the tiny count
are static buffers; the tiny count's all-reduce stays eager at the end.

:class:`MeshFusedExecutor` keeps the graphs of each group,
:class:`MeshLevelExecutor` (``MeshStreamExecutor(granularity="level")``)
those of each schedule wave (a wave's group programs run as one
program), :class:`MeshMegaExecutor` those of each closed key — a group
shape (w, u) and whether this rank's process row has slots in it: the
row's slots are padded to the key's rung (identity fronts, ``ws`` 0)
and the group's tables are copied into the key's static buffers before
its replays, as ``numeric/mega.py`` does on one card.  On NCCL the
exchange a mega graph holds moves the same counts at every replay, so
each (rank, peer) leg is padded to the largest of the shape's groups (a
dump segment a leg: padding read from the front's first element,
received into a dump element of the pivot stack and of the pool); rank
r's padded send to d equals d's padded receive from r on every rank
pair, checked over the grid when the tables are built.  On gloo and on
the CPU the exchange stays eager and moves each group's own counts
(``MeshMegaExecutor.pad_legs``).  All graphs of an executor
share one private pool: the units replay in their capture order and
each one's outputs are cloned out before the next, so no graph's data
is live while another's replay reuses its memory, and every collective
of a graph ends inside it (NCCL's stream joins the capture stream
before the graph's next launch).

On the CPU the three run the same programs eagerly — bit for bit the
2-D executor's.  A failed capture, replay or NCCL call raises; nothing
falls back to segments, to gloo or to one card.
"""

from __future__ import annotations

import types
import warnings

import numpy as np
import torch

from superlu_dist_tpu_torch.numeric.plan import bucket_rung
from superlu_dist_tpu_torch.ops.dense import capture_stream
from superlu_dist_tpu_torch.parallel.layout2d import Segments, layout
from superlu_dist_tpu_torch.parallel.mesh_stream import (Exchange,
                                                         MeshStreamExecutor,
                                                         _segments, drive,
                                                         share_maps)


#: the graphs' build sites in the census (obs/compilestats.py): a
#: segment between two collectives (gloo), a whole unit (NCCL)
SEGMENT_SITE = "mesh_graphs.segment"
UNIT_SITE = "mesh_graphs.unit"


class _Done:
    """A program's end, captured as its last graph's output, with the
    collectives a unit graph holds (``tape``: their records; None for a
    segment)."""

    __slots__ = ("value", "tape")

    def __init__(self, value, tape=None):
        self.value, self.tape = value, tape


def _advance(program, reply):
    """The program's next request (or :class:`_Done`) after ``reply``."""
    try:
        return program.send(reply)
    except StopIteration as done:
        return _Done(done.value)


class _GridGraphs(MeshStreamExecutor):
    """The 2-D mesh executor whose group programs run as CUDA graphs on
    the card — one a unit on NCCL, segments on gloo (module docstring);
    the subclasses say which program state a group runs on and how its
    graphs are kept."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._static = None        # the call's static buffers on the card
        self._stream = None        # the capture stream
        self._warmed = False
        self.graph_stats = {}
        self.last_warm_up_launches = 0

    def device_estimate(self) -> dict:
        """``numeric/stream.offload_estimate`` for the graphs, from this
        rank's share (``share_parts`` at the rows its programs run,
        :meth:`_rows`): the static pool of :meth:`_pool_len` elements,
        held for the executor's life; while the graphs warm up
        (:meth:`_warm`) a scratch pool as large and a step's working set
        beside it; after the captures the one private pool the graphs
        share, which keeps the programs' outputs (the rank's share of the
        factors) and the largest step's working set; the static
        broadcast and exchange buffers."""
        from superlu_dist_tpu_torch.numeric.stream import offload_estimate
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        kept, work = self.share_parts(itemsize)
        step = max(work, default=0)
        pool = self._pool_len() * itemsize
        static = sum(self._collective_sizes(self._rows())) * itemsize
        return offload_estimate(
            self.plan, self.dtype, pool_len=self._pool_len(),
            graphs=self._output_bytes(itemsize) + step + static,
            warm=pool + step + static, lag=self.offload_lag,
            units=self.units(),
            share=(kept, work, self.solve_copy_bytes(itemsize)))

    def _output_bytes(self, itemsize: int) -> int:
        """The graphs' outputs, which their pool keeps: every group's
        columns and pivot stack once."""
        return itemsize * sum(self.offload_sizes())

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
        from superlu_dist_tpu_torch.ops.dense import panel_width
        bcast = recv = 0
        for gi, (grp, gl, (_, got)) in enumerate(zip(
                self.plan.groups, self.layout.groups,
                self.exchange_counts())):
            if rows[gi] and self.grid.npcol > 1:
                bcast = max(bcast, rows[gi] * gl.m_ext
                            * panel_width(grp.w)[0])
            recv = max(recv, int(np.sum(got)))
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
            self._stream = capture_stream(dev)
        st = self._static
        st.avals.copy_(avals.to(dtype=self.dtype))
        st.thresh.copy_(thresh)
        st.pool.zero_()
        st.tiny.zero_()
        return st

    def _got_buffer(self, device):
        recv = self._collective_sizes(self._rows())[1]
        return torch.empty(max(recv, 1), dtype=self.dtype, device=device)

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
        # every group's program audited before anything of it runs
        for gi in range(len(self.plan.groups)):
            self._audit_group(gi, states(gi), bufs)
        keys = ((gi, (self._rows()[gi], grp.m, grp.w))
                for gi, grp in enumerate(self.plan.groups))
        before = dict(kernels.LAUNCHES)
        self.graph_stats["warm_up_s"] = warm_up(step, keys, self._stream)
        # the warm-up's launches are real ones, of the call that captures
        self.last_warm_up_launches = (kernels.LAUNCHES["front_assemble"]
                                      - before["front_assemble"])
        # the warm-up's blocks back to the card before the captures: the
        # graphs' private pool cannot take torch's cached blocks, and a
        # capture cannot free them when it needs the room
        scratch.__dict__.clear()
        torch.cuda.empty_cache()
        self._warmed = True

    def _capture(self, program, bufs, pool, label) -> list:
        """A unit's program captured on the capture stream into ``pool``
        (a graph pool handle) and run once: [(Graph, request or _Done)],
        the last entry's ``_Done`` holding the program's outputs.  On a
        capturable grid one graph holds the whole program
        (:meth:`_capture_unit`); else each segment is captured, replayed,
        then the collective that ends it run into the static buffers —
        one build in the census each, site ``mesh_graphs.segment``, key
        ``{label} s{index}``."""
        from superlu_dist_tpu_torch.numeric.fused import Graph
        if self.grid.capturable:
            return [self._capture_unit(program, bufs, pool, label)]
        run = self._static_collective(bufs)
        segs, reply = [], None
        while True:
            with warnings.catch_warnings():
                # a segment without a launch (a rank with nothing to do
                # before an exchange) is an empty graph: valid, a no-op
                warnings.filterwarnings("ignore", "The CUDA Graph is empty")
                graph = Graph(lambda: _advance(program, reply), self.device,
                              self._stream, pool=pool, site=SEGMENT_SITE,
                              key=f"{label} s{len(segs)}")
            self.captures += 1
            graph.replay()
            req = graph.outputs
            segs.append((graph, req))
            if isinstance(req, _Done):
                return segs
            reply = run(req)

    def _capture_unit(self, program, bufs, pool, label) -> tuple:
        """A unit's whole program as one graph: its collectives answered
        inside the capture (``ProcessGrid.recording``) into the static
        buffers; verify mode's checks of them against the peers' before
        the graph first runs; then its first replay.  One build in the
        census, site ``mesh_graphs.unit``, key ``label``.  Returns
        (Graph, _Done with the outputs and the collectives' records)."""
        from superlu_dist_tpu_torch.numeric.fused import Graph
        grid = self.grid
        run = self._static_collective(bufs)
        with grid.recording() as tape:
            graph = Graph(lambda: _Done(drive(program, run)), self.device,
                          self._stream, pool=pool, site=UNIT_SITE,
                          key=label)
        self.captures += 1
        grid.check_tape(tape)
        done = graph.outputs
        done.tape = tape
        graph.replay()
        grid.replayed(tape)
        return graph, done

    def _replay(self, segs, bufs, gl=None):
        """One program's graphs replayed — a unit graph alone, or the
        segments with the collectives between them run eagerly, an
        exchange on group layout ``gl``'s counts (None: the captured
        request's own); returns the program's outputs."""
        run = self._static_collective(bufs)
        for graph, req in segs:
            graph.replay()
            if isinstance(req, _Done):
                if req.tape is not None:
                    self.grid.replayed(req.tape)
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
        # one graph a unit, its collectives inside (NCCL), or segments
        rep["graph_kind"] = "unit" if self.grid.capturable else "segment"
        return rep


class MeshFusedExecutor(_GridGraphs):
    """``Options(executor="fused")`` on a grid of several ranks: every
    group's program captured at the first call and replayed by the later
    ones — one graph a group on NCCL, one per (group, segment) on gloo,
    kept per (plan, dtype, tier, grid) in ``numeric/factor.
    get_executor``'s cache.  No offload: the
    JAX fused program has none, so on the card the card's rule refuses
    it on every rank where it does not fit."""

    name = "mesh-fused"
    offloads = False

    def __init__(self, plan, dtype, device, grid, gemm_prec=None,
                 scatter=None, pool_partition=False, panel=None):
        # "auto" under the card's rule: "none", or refused on every rank
        # where the graphs do not fit
        super().__init__(plan, dtype, device, grid, gemm_prec=gemm_prec,
                         scatter=scatter, pool_partition=pool_partition,
                         offload="auto", panel=panel)
        self._segs = {}            # group -> its graphs

    def _run_group(self, gi, bufs):
        if self.device.type != "cuda":
            return super()._run_group(gi, bufs)
        states = self._device_state()
        if not self._warmed:
            self._warm(lambda g: states[g], bufs)
            self._pool = torch.cuda.graph_pool_handle()
        segs = self._segs.get(gi)
        if segs is None:
            # bufs: on the card, the executor's static buffers (_buffers),
            # the same tensors every call — not a key input
            segs = self._capture(self._group(gi, states[gi], bufs), bufs,
                                 self._pool, f"g{gi}")
            self._segs[gi] = segs  # slulint: disable=SLU105
            out = segs[-1][1].value
        else:
            out = self._replay(segs, bufs)
        return self._finish(gi, *out, clone=True)

    def _graphs(self) -> list:
        return [g for segs in self._segs.values() for g, _ in segs]


class MeshLevelExecutor(_GridGraphs):
    """``MeshStreamExecutor(granularity="level")``: the 2-D executor run
    wave by wave.  On the card each schedule wave's group programs run as
    one program, captured at the first call and replayed by the later
    ones — one graph a wave on NCCL, one per (wave, segment) on gloo
    with the collectives eagerly between them — kept in one private
    pool; on the CPU the groups' programs run eagerly, bit for bit the
    "group" granularity's.  Offload as on the 2-D executor: a wave's
    groups go to host memory after its last graph."""

    name = "mesh-stream"

    def __init__(self, *args, granularity="level", **kw):
        super().__init__(*args, granularity=granularity, **kw)
        self._segs = {}            # wave (lo, hi) -> its graphs

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
        segs = self._segs.get((lo, hi))
        if segs is None:
            # bufs: the executor's static buffers (see MeshFusedExecutor)
            segs = self._capture(
                self._wave(lo, hi, states, bufs), bufs, self._pool,
                f"level{self.plan.groups[lo].level} g{lo}-{hi - 1}")
            self._segs[(lo, hi)] = segs  # slulint: disable=SLU105
            outs = segs[-1][1].value
        else:
            outs = self._replay(segs, bufs)
        return [self._finish(gi, *o, clone=True)
                for gi, o in zip(range(lo, hi), outs)]

    def _graphs(self) -> list:
        return [g for segs in self._segs.values() for g, _ in segs]


def _pad_legs(seg, counts, padded, dump: int = 0) -> Segments:
    """Send segments ``seg`` (in destination order, ``counts[d]``
    elements for rank d) with each destination's leg padded to
    ``padded[d]`` elements: after its segments one of the missing
    elements, read at ``dump`` (stride 0)."""
    ends = np.cumsum(counts)
    dest = np.searchsorted(ends, seg.buf, side="right")
    parts = []
    for d in range(len(counts)):
        mine = dest == d
        parts.append((seg.start[mine], seg.length[mine], seg.stride[mine]))
        parts.append(([dump], [int(padded[d] - counts[d])], [0]))
    return Segments.of(parts)


def _rebase_legs(seg, counts, padded) -> Segments:
    """Receive segments ``seg`` reading a buffer of ``counts[r]``
    elements from each source r, in rank order, moved to read the buffer
    of ``padded[r]`` elements a source."""
    old = np.concatenate([[0], np.cumsum(counts)])
    new = np.concatenate([[0], np.cumsum(padded)])
    src = np.searchsorted(old[1:], seg.buf, side="right")
    return Segments(seg.start, seg.length, seg.stride,
                    seg.buf - old[src] + new[src])


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
    a closed key on NCCL, one per (closed key, segment position) on gloo
    — a closed key is (w, u, this process row has slots) — the group's
    padded tables copied into the key's static buffers before its
    replays (module docstring).  ``pad_legs``: the exchange moves its
    group shape's padded counts, which a captured all-to-all needs (a
    capturable grid); else each group's own, eagerly between segments.
    Offload as on the 2-D executor (the JAX MegaExecutor streams too)."""

    name = "mesh-mega"

    def __init__(self, plan, dtype, device, grid, gemm_prec=None,
                 scatter=None, pool_partition=False, offload="auto",
                 front_bytes_limit=None, offload_lag=8, panel=None):
        # the keys and their padded shapes first: the card's rule reads
        # them (device_estimate) while the base class is built
        groups = layout(plan, grid.nprow, grid.npcol, grid.rank,
                        bool(pool_partition)).groups
        self.key_of = [(g.w, g.u, bool(len(gl.slots)))
                       for g, gl in zip(plan.groups, groups)]
        self.spec = {}
        for g, gl, key in zip(plan.groups, groups, self.key_of):
            rows, batch = self.spec.get(key, (0, 0))
            self.spec[key] = (max(rows, len(gl.slots)), max(batch, g.batch))
        self.spec = {k: (bucket_rung(r, lo=1, growth=2.0) if r else 0,
                         bucket_rung(b, lo=1, growth=2.0))
                     for k, (r, b) in self.spec.items()}
        self._tables = None        # per group: its padded state
        self._keys = {}            # key -> (static state, its graphs)
        self._legs = None          # per group shape: its padded counts
        self.pad_legs = grid.capturable
        super().__init__(plan, dtype, device, grid, gemm_prec=gemm_prec,
                         scatter=scatter, pool_partition=pool_partition,
                         offload=offload, front_bytes_limit=front_bytes_limit,
                         offload_lag=offload_lag, panel=panel)

    @property
    def closed_keys(self) -> int:
        return len(self.spec)

    def _padded_batch(self, gi) -> int:
        return self.spec[self.key_of[gi]][1]

    def _pool_len(self) -> int:
        return self.layout.pool_len + 1          # the dump element

    def _rows(self) -> list:
        return [self.spec[k][0] for k in self.key_of]

    def _output_bytes(self, itemsize: int) -> int:
        """Each closed key's graph outputs at its padded rows and pivot
        stack: the largest of its groups' columns, once a key."""
        out = {}
        for g, gl, key in zip(self.plan.groups, self.layout.groups,
                              self.key_of):
            rows, b_pad = self.spec[key]
            n = rows * (g.m * gl.kw + g.w * (gl.mc - gl.kw)) \
                + b_pad * g.w * g.w + 1
            out[key] = max(out.get(key, 0), n)
        return itemsize * sum(out.values())

    def _padded_legs(self) -> dict:
        """Per group shape (w, u): the exchange's (send, receive) counts
        by peer rank, each the largest of the shape's groups — the counts
        every graph of the shape moves, whichever group it replays.
        Rank r's send to d is d's receive from r: both are the largest of
        the same groups' counts of that leg."""
        if self._legs is None:
            legs = {}
            for g, gl in zip(self.plan.groups, self.layout.groups):
                send, recv = legs.get((g.w, g.u), (0, 0))
                legs[(g.w, g.u)] = (np.maximum(send, gl.send_counts),
                                    np.maximum(recv, gl.recv_counts))
            self._legs = legs
        return self._legs

    def exchange_counts(self) -> list:
        if not self.pad_legs:
            return super().exchange_counts()
        legs = self._padded_legs()
        return [legs[(g.w, g.u)] for g in self.plan.groups]

    def _check_legs(self) -> None:
        """The padded counts of every group shape against every rank's,
        in one gather over the grid: a captured all-to-all whose legs
        disagree would hang, so a mismatch raises CollectiveMismatchError
        on every rank before anything runs."""
        legs = self._padded_legs()
        shapes = sorted(legs)
        nd = self.grid.nproc
        mine = np.concatenate([np.concatenate(legs[k]) for k in shapes])
        got = self.grid._gather_host(torch.as_tensor(
            mine, dtype=torch.float64)).reshape(nd, len(shapes), 2, nd)
        # got[r, k, 0, d]: r's send to d; got[d, k, 1, r]: d's receive
        if np.array_equal(got[:, :, 0, :], got[:, :, 1, :].transpose(2, 1,
                                                                     0)):
            return
        from superlu_dist_tpu_torch.utils.errors import CollectiveMismatchError
        raise CollectiveMismatchError(
            [{"rank": r, "seq": -1, "op": "exchange",
              "shape": tuple(int(c) for c in got[r].reshape(-1)),
              "dtype": 0, "site": "mesh-mega padded exchange counts"}
             for r in range(nd)], rank=self.rank)

    def _padded_tables(self):
        """Per group: its program state at the key's padded shapes — the
        share's maps at the key's rung of slots, the pivot stack at the
        key's batch rung plus a dump element, every segment table at the
        key's largest count and total; with ``pad_legs`` the exchange at
        its shape's padded counts (``xchg``)."""
        if self._tables is not None:
            return self._tables
        plan, dev = self.plan, self.device
        pool_dump = self.layout.pool_len
        counts = self.exchange_counts()
        if self.pad_legs:
            self._check_legs()
            # each group's exchange tables at its shape's padded counts
            moved = [(_pad_legs(gl.send, gl.send_counts, send),
                      _rebase_legs(gl.recv_piv, gl.recv_counts, recv),
                      _rebase_legs(gl.recv_pool, gl.recv_counts, recv))
                     for gl, (send, recv) in zip(self.layout.groups, counts)]
        else:
            moved = [(gl.send, gl.recv_piv, gl.recv_pool)
                     for gl in self.layout.groups]
        most = {}
        for key, gl, mv in zip(self.key_of, self.layout.groups, moved):
            segs = list(mv) + [gl.self_piv[0], gl.self_pool[0]]
            old = most.get(key, [(0, 0)] * len(segs))
            most[key] = [(max(n, len(s.length)), max(t, s.total))
                         for (n, t), s in zip(old, segs)]
        out = []
        for gi, (grp, gl, key, (snd, rpv, rpl)) in enumerate(zip(
                plan.groups, self.layout.groups, self.key_of, moved)):
            rows, b_pad = self.spec[key]
            piv_dump = b_pad * grp.w * grp.w
            (ns, ts), (npv, tpv), (npl, tpl), (nsp, tsp), (nso, tso) = \
                [(n + 1, t) for n, t in most[key]]
            frm_p, to_p = gl.self_piv
            frm_o, to_o = gl.self_pool
            send, recv = counts[gi]
            out.append(dict(
                maps=share_maps(gl, dev, batch=rows)
                if rows and gl.mc else None,
                ws=torch.as_tensor(np.pad(np.asarray(gl.maps.ws, np.int64),
                                          (0, rows - len(gl.slots))),
                                   device=dev),
                rows=rows, piv_len=piv_dump + 1,
                xchg=types.SimpleNamespace(
                    send=types.SimpleNamespace(total=int(send.sum())),
                    send_counts=send, recv_counts=recv)
                if self.pad_legs else None,
                send=_segments(_pad_segments(snd, ns, ts, 0), dev),
                piv=_segments(_pad_segments(rpv, npv, tpv, piv_dump), dev),
                pool=_segments(_pad_segments(rpl, npl, tpl, pool_dump),
                               dev),
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
                     xchg=first["xchg"],
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
            self._audit_group(gi, tables[gi], bufs)
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
                                 self._pool, "w{} u{} r{:d}".format(*key))
            # bufs: the executor's static buffers (see MeshFusedExecutor)
            self._keys[key] = (state, segs)  # slulint: disable=SLU105
            out = segs[-1][1].value
        else:
            # segments (gloo): the exchange between them on the group's
            # own counts
            out = self._replay(segs, bufs, None if self.pad_legs
                               else self.layout.groups[gi])
        return self._finish(gi, *out, clone=True)

    def _graphs(self) -> list:
        return [g for _, segs in self._keys.values() if segs
                for g, _ in segs]

    def report(self) -> dict:
        rep = super().report()
        rep["closed_keys"] = self.closed_keys
        return rep
