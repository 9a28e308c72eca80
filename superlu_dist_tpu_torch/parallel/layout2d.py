"""The layout of the 2-D mesh tier (parallel/mesh_stream.py): which rank
of an nprow × npcol grid holds which slot, which front column and which
Schur element, and the tables that move the Schur elements to the ranks
that extend-add them.  Host numpy, built once per (plan, nprow, npcol,
rank, pool_partition) and cached on the plan, as ``spmd.local_plan`` is.

* **Slots** — slot j of a group lives on process row ``j % nprow``
  (``spmd._cyclic_layout`` over the process rows), local slot ``j //
  nprow`` there.
* **Columns** — the columns of a front (padded to M_ext, as the blocked
  partial LU pads it) are dealt in panels of ``ops.dense.panel_width(w)``
  columns: panel p (columns [p·pb, (p+1)·pb)) to process column
  ``p % npcol``.  The pivot columns [0, w) are the blocked LU's own
  panels, so each panel's column loop runs on one rank; the Schur
  columns [w, M) continue the same blocks (the last pivot panel's
  trailing columns stay with its owner, which updates them in the loop).
  This is the reference's block-cyclic column map (SURVEY.md §2.4); the
  JAX package's GSPMD splits the column axis into contiguous blocks
  instead, and no slot's arithmetic depends on the choice.  A rank's
  columns are contiguous pb-blocks in its local front, ascending.
* **Schur elements** — element (i, j) of slot s's Schur block (rows and
  columns below its real update size) is extend-added by the process row
  of s's parent slot and the process column that owns parent column
  ``rel[j]``.  With ``pool_partition`` that rank is its only receiver and
  keeps it in a compacted local pool: each child block it reads is a
  dense (rows, own columns) block there, allocated first-fit with
  coalescing in the plan's group order (a group frees its children's
  blocks, then allocates its own — the plan's discipline, whose
  size-class free lists suit only its bucket-padded square blocks).
  Without it every rank receives every element into the plan's global
  pool (the JAX stream's replicated pool).

Every transfer is a list of strided segments (start, length, stride):
a column of a Schur block or of a pivot block is one segment on both
sides, so the tables grow with the number of front columns, not with
the number of elements; the executor expands them on the device per
group (``expand``).
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from superlu_dist_tpu_torch.ops.dense import panel_width


def col_owner(m_ext: int, w: int, npcol: int) -> np.ndarray:
    """The process column of each of the m_ext (padded) front columns."""
    pb, _ = panel_width(w)
    return (np.arange(m_ext) // pb) % npcol


def front_cols(m: int, w: int, npcol: int, pcol: int):
    """(pb, M_ext, this column's global columns in [0, M_ext) ascending —
    its local order —, how many of them lie in [0, m))."""
    pb, nsteps = panel_width(w)
    m_ext = max(m, nsteps * pb)
    cols = np.flatnonzero(col_owner(m_ext, w, npcol) == pcol)
    return pb, m_ext, cols, int(np.searchsorted(cols, m))


@dataclasses.dataclass
class Segments:
    """Strided segments in order: segment k covers ``length[k]`` elements
    at ``start[k] + t·stride[k]`` of its target, read from (or written
    to) the exchange buffer at ``buf[k] + t``."""

    start: np.ndarray
    length: np.ndarray
    stride: np.ndarray
    buf: np.ndarray = None

    @property
    def total(self) -> int:
        return int(self.length.sum())

    @staticmethod
    def of(parts) -> "Segments":
        """Concatenation of (start, length, stride) array triples, the
        buffer positions running on from one segment to the next."""
        parts = [p for p in parts if len(p[0])]
        if not parts:
            z = np.zeros(0, np.int64)
            return Segments(z, z, z, z)
        start, length, stride = (np.concatenate([np.asarray(p[i], np.int64)
                                                 for p in parts])
                                 for i in range(3))
        buf = np.concatenate([[0], np.cumsum(length)[:-1]]).astype(np.int64)
        return Segments(start, length, stride, buf)


def expand(seg, total: int, device) -> tuple:
    """(target indices, buffer indices) of device segments ``seg`` (a
    dict of int64 tensors start / length / stride / buf, and first: each
    segment's first element in the expanded order) holding
    ``total`` elements — one ``repeat_interleave`` (its output size given,
    so nothing waits for the device)."""
    n = seg["start"].shape[0]
    k = torch.repeat_interleave(torch.arange(n, device=device),
                                seg["length"], output_size=total)
    t = torch.arange(total, device=device) - seg["first"][k]
    return seg["start"][k] + t * seg["stride"][k], seg["buf"][k] + t


@dataclasses.dataclass
class GroupLayout:
    """One rank's share of one group: its slots and columns, its front
    assembly maps, its Schur block's routing and what it receives."""

    slots: np.ndarray        # the group's slots on this process row
    m_ext: int
    gcol: np.ndarray         # own global columns in [0, M_ext), ascending
    mc: int                  # how many of them lie in [0, m)
    kw: int                  # how many lie in [0, w) (the leading ones)
    maps: object             # the plan-shaped group record of the share
    send: Segments = None    # into the local (c, M_ext, mc_ext) array, by
    send_counts: np.ndarray = None   # destination rank (none to itself)
    recv_piv: Segments = None        # into the (B, w, w) pivot stack
    recv_pool: Segments = None       # into the pool
    recv_counts: np.ndarray = None   # by source rank (none from itself)
    # this rank's own leg, copied on the device and never sent: (source
    # segments in the local array, target segments), pair by pair
    self_piv: tuple = None
    self_pool: tuple = None

    @property
    def mc_ext(self) -> int:
        return len(self.gcol)

    @property
    def pool_in(self) -> int:
        """The elements this rank writes into its pool in this group."""
        return self.recv_pool.total + self.self_pool[1].total


def layout(plan, nprow: int, npcol: int, rank: int,
           pool_partition: bool) -> types.SimpleNamespace:
    """Rank ``rank``'s layout of ``plan`` on an nprow × npcol grid
    (module docstring), cached on the plan: ``groups`` (per group a
    :class:`GroupLayout`), ``pool_len`` (this rank's pool: the plan's
    with the replicated pool, its compacted share with
    ``pool_partition``) and ``pool_elems`` (the elements it ever
    receives into its pool)."""
    cache = plan.__dict__.setdefault("_mesh2d_layout", {})
    key = (int(nprow), int(npcol), int(rank), bool(pool_partition))
    hit = cache.get(key)
    if hit is None:
        hit = cache[key] = _build(plan, *key)
    return hit


class _FirstFit:
    """First-fit allocation over one array with coalescing free ranges:
    a rank's compacted pool, whose blocks (rows × own columns) come in
    every size, so the plan's exact-size free lists would seldom reuse
    one.  ``top`` is the array's length so far."""

    def __init__(self):
        self.ranges = []        # free (start, size), ascending, disjoint
        self.top = 0

    def alloc(self, size: int) -> int:
        for i, (at, n) in enumerate(self.ranges):
            if n >= size:
                if n == size:
                    del self.ranges[i]
                else:
                    self.ranges[i] = (at + size, n - size)
                return at
        if self.ranges and sum(self.ranges[-1]) == self.top:
            at = self.ranges.pop()[0]       # grow the free tail
        else:
            at = self.top
        self.top = at + size
        return at

    def free(self, at: int, size: int) -> None:
        import bisect
        i = bisect.bisect(self.ranges, (at, size))
        self.ranges.insert(i, (at, size))
        # merge with the neighbours
        if i + 1 < len(self.ranges) and at + size == self.ranges[i + 1][0]:
            self.ranges[i] = (at, size + self.ranges.pop(i + 1)[1])
        if i and sum(self.ranges[i - 1]) == at:
            prev = self.ranges.pop(i - 1)
            self.ranges[i - 1] = (prev[0], prev[1] + self.ranges[i - 1][1])


def _child_index(plan):
    """(G, child_off) -> (set index, child index) over every group G."""
    out = {}
    for gi, grp in enumerate(plan.groups):
        for q, cs in enumerate(grp.children):
            for k, off in enumerate(np.asarray(cs.child_off)):
                out[gi, int(off)] = (q, k)
    return out


def schur_routes(plan, nprow: int, npcol: int):
    """Every Schur column of every slot and where it goes, on an nprow ×
    npcol grid: per group None (no Schur block) or a dict of the slots
    with a block (``have``), their real update sizes (``ur_slot``) and
    parent groups (``pg``), and per (slot, j) pair — j below the slot's
    real update size, in slot then column order — ``s``, ``j``, ``ur``,
    the rank holding column j (``sender``) and the rank extend-adding it
    (``receiver``); and {(parent group, pool offset): (group, slot)}."""
    sf = plan.sf
    us = np.array([len(r) for r in sf.sn_rows], dtype=np.int64)
    groups = plan.groups
    pbs = [panel_width(g.w)[0] for g in groups]
    cidx = _child_index(plan)
    pairs, prod = [], {}
    for gi, g in enumerate(groups):
        off = np.asarray(g.off, dtype=np.int64)
        have = np.flatnonzero(off < plan.pool_size)
        if g.u == 0 or not len(have):
            pairs.append(None)
            continue
        sns = np.asarray(g.sns)[have]
        ur = us[sns]
        par = sf.sn_parent[sns]
        pg, ps = plan.sn_group[par], plan.sn_slot[par]
        j_of = np.concatenate([np.arange(u) for u in ur])
        recv_pc = np.empty(len(j_of), dtype=np.int64)
        at = 0
        for s, u, G in zip(have, ur, pg):
            q, k = cidx[int(G), int(off[s])]
            rel = np.asarray(groups[G].children[q].rel[k])[:u]
            recv_pc[at:at + u] = (rel // pbs[G]) % npcol
            prod[int(G), int(off[s])] = (gi, int(s))
            at += u
        send_pc = ((g.w + j_of) // pbs[gi]) % npcol
        pairs.append(dict(
            have=have, ur_slot=ur, pg=pg, s=np.repeat(have, ur), j=j_of,
            ur=np.repeat(ur, ur),
            sender=(np.repeat(have, ur) % nprow) * npcol + send_pc,
            receiver=(np.repeat(ps, ur) % nprow) * npcol + recv_pc))
    return pairs, prod


def _build(plan, nprow, npcol, rank, partition):
    nproc = nprow * npcol
    prow, pcol = rank // npcol, rank % npcol
    groups = plan.groups
    cols = [[front_cols(g.m, g.w, npcol, c) for c in range(npcol)]
            for g in groups]
    pairs, prod = schur_routes(plan, nprow, npcol)

    # --- this rank's pool: the plan's, or its compacted share -----------
    # per group: each slot's (local offset, own column count) of the block
    # this rank reads (offset -1: none)
    loff = [None] * len(groups)
    if partition:
        pool = _FirstFit()
        pool_elems = 0
        consumed = {}           # G -> [(offset, size)]
        for gi, g in enumerate(groups):
            for at, size in consumed.pop(gi, []):
                pool.free(at, size)
            pr = pairs[gi]
            if pr is None:
                continue
            k_of = np.bincount(pr["s"][pr["receiver"] == rank],
                               minlength=g.batch)
            at_of = np.full(g.batch, -1, dtype=np.int64)
            for s, ur, G in zip(pr["have"], pr["ur_slot"], pr["pg"]):
                if not k_of[s]:
                    continue
                size = int(ur * k_of[s])
                at_of[s] = at = pool.alloc(size)
                consumed.setdefault(int(G), []).append((at, size))
                pool_elems += size
            loff[gi] = (at_of, k_of)
        pool_len = pool.top
    else:
        pool_len = int(plan.pool_size)
        pool_elems = sum(int(pr["ur"].sum()) for pr in pairs
                         if pr is not None)

    out = []
    for gi, g in enumerate(groups):
        pb, m_ext, gcol, mc = cols[gi][pcol]
        slots = np.arange(prow, g.batch, nprow)
        kw = int(np.searchsorted(gcol, g.w))
        gl = GroupLayout(slots=slots, m_ext=m_ext, gcol=gcol, mc=mc, kw=kw,
                         maps=_share_maps(g, gi, slots, nprow, prow,
                                          gcol[:mc], partition, loff, prod,
                                          pool_len))
        gl.maps.share = (pb, npcol, pcol)
        _routes(gl, g, pairs[gi], cols[gi], nprow, npcol, rank, nproc,
                partition, loff[gi])
        out.append(gl)
    return types.SimpleNamespace(
        groups=out, pool_len=pool_len, pool_elems=pool_elems,
        nprow=nprow, npcol=npcol, rank=rank, partition=partition)


def _share_maps(g, gi, slots, nprow, prow, own, partition, loff, prod,
                pool_len):
    """The plan-shaped record of this rank's share of group g
    (``mesh_stream.share_maps`` makes the device maps of it): its slots
    renumbered, the A entries of its slots and columns (flat = row·mc +
    local column; ``a_flat_global`` the plan's), and each child set's
    children whose parent slot it holds, with their row maps, local
    column maps and pool strides."""
    m = g.m
    mc = len(own)
    loc = np.full(m + 1, -1, dtype=np.int64)
    loc[own] = np.arange(mc)
    a_slot = np.asarray(g.a_slot, dtype=np.int64)
    a_flat = np.asarray(g.a_flat, dtype=np.int64)
    a_src = np.asarray(g.a_src, dtype=np.int64)
    keep = (a_slot % nprow == prow) & (a_slot >= 0) & (a_flat >= 0) \
        & (a_flat < m * m)
    keep[keep] = loc[a_flat[keep] % m] >= 0
    children = []
    for cs in g.children:
        cslot = np.asarray(cs.child_slot, dtype=np.int64)
        coff = np.asarray(cs.child_off, dtype=np.int64)
        sel = np.flatnonzero(cslot % nprow == prow)
        if not len(sel):
            continue
        rel = np.asarray(cs.rel, dtype=np.int64)[sel]
        crel = np.where((rel >= 0) & (rel < m), loc[np.clip(rel, 0, m)], -1)
        if partition:
            offs = np.full(len(sel), pool_len, dtype=np.int64)
            stride = np.zeros(len(sel), dtype=np.int64)
            packed = np.full(crel.shape, -1, dtype=np.int64)
            for n, k in enumerate(sel):
                own_k = crel[n][crel[n] >= 0]
                src = prod.get((gi, int(coff[k])))
                at = -1 if src is None else int(loff[src[0]][0][src[1]])
                if at < 0:
                    if len(own_k):
                        raise AssertionError("layout: a child block this "
                                             "rank reads was not routed")
                    continue                  # offset pool_len: dropped
                offs[n], stride[n] = at, int(loff[src[0]][1][src[1]])
                if stride[n] != len(own_k):
                    raise AssertionError("layout: a child block's columns "
                                         "disagree with its routing")
                packed[n, :len(own_k)] = own_k
            crel = packed[:, :max(int(stride.max(initial=0)), 1)]
        else:
            offs = coff[sel]
            stride = np.full(len(sel), cs.ub, dtype=np.int64)
        children.append((cs.ub, offs, cslot[sel] // nprow, rel, crel,
                         stride))
    return types.SimpleNamespace(
        batch=len(slots), m=m, w=g.w, u=g.u, own=own,
        ws=np.asarray(g.ws)[slots],
        a_slot=a_slot[keep] // nprow,
        a_flat=(a_flat[keep] // m) * mc + loc[a_flat[keep] % m],
        a_flat_global=a_flat[keep], a_src=a_src[keep], children=children,
        pool_len=pool_len)


def _routes(gl, g, pr, cols_g, nprow, npcol, rank, nproc, partition,
            loff):
    """The send and receive segments of group g for this rank: every
    other rank's pivot columns of every slot, and the Schur columns this
    rank sends and receives (module docstring).  What this rank would
    send itself is split off as its own leg (``self_piv``,
    ``self_pool``): the same pairs in the same order on both sides."""
    w = g.w
    c = len(gl.slots)
    plane = gl.m_ext * gl.mc_ext
    send_parts = [[] for _ in range(nproc)]
    recv_p = [[] for _ in range(nproc)]
    recv_q = [[] for _ in range(nproc)]
    # pivot columns: this rank's to every rank; every rank's to this one
    self_piv = []
    if c:
        s_loc = np.repeat(np.arange(c), gl.kw)
        k = np.tile(np.arange(gl.kw), c)
        piv_send = (s_loc * plane + k, np.full(len(k), w),
                    np.full(len(k), gl.mc_ext))
        for d in range(nproc):
            send_parts[d].append(piv_send)
        self_piv = send_parts[rank][:]
    for r in range(nproc):
        rp, rc = r // npcol, r % npcol
        r_slots = np.arange(rp, g.batch, nprow)
        r_cols = cols_g[rc][2]
        r_piv = r_cols[r_cols < w]
        s = np.repeat(r_slots, len(r_piv))
        j = np.tile(r_piv, len(r_slots))
        recv_p[r].append((s * w * w + j, np.full(len(j), w),
                          np.full(len(j), w)))
    if pr is not None:
        col_pos = np.full(gl.m_ext + 1, -1, dtype=np.int64)
        col_pos[gl.gcol] = np.arange(gl.mc_ext)
        # what this rank sends: its own Schur columns, by destination
        mine = pr["sender"] == rank
        if mine.any():
            s, j, ur = pr["s"][mine], pr["j"][mine], pr["ur"][mine]
            src = (s // nprow) * plane + w * gl.mc_ext + col_pos[w + j]
            dests = (pr["receiver"][mine] if partition
                     else None)
            for d in range(nproc):
                sel = slice(None) if dests is None else dests == d
                send_parts[d].append((src[sel], ur[sel],
                                      np.full(len(src[sel]), gl.mc_ext)))
        # what this rank receives into its pool, by source
        got = (pr["receiver"] == rank) if partition \
            else np.ones(len(pr["s"]), dtype=bool)
        if got.any():
            s, j, ur = pr["s"][got], pr["j"][got], pr["ur"][got]
            src_rank = pr["sender"][got]
            if partition:
                # the position of each column among the block's own ones
                first = np.searchsorted(s, s)          # s ascending
                kpos = np.arange(len(s)) - first
                dst, stride = loff[0][s] + kpos, loff[1][s]
            else:
                off = np.asarray(g.off, dtype=np.int64)[s]
                dst, stride = off + j, np.full(len(s), g.u)
            for r in range(nproc):
                sel = src_rank == r
                recv_q[r].append((dst[sel], ur[sel], stride[sel]))
    gl.self_piv = (Segments.of(self_piv), Segments.of(recv_p[rank]))
    gl.self_pool = (Segments.of(send_parts[rank][len(self_piv):]),
                    Segments.of(recv_q[rank]))
    send_parts[rank] = recv_p[rank] = recv_q[rank] = []
    gl.send = Segments.of([p for d in range(nproc) for p in send_parts[d]])
    gl.send_counts = np.array([sum(int(np.sum(p[1])) for p in send_parts[d])
                               for d in range(nproc)], dtype=np.int64)
    # the buffer holds, per source in rank order, its pivot columns then
    # its Schur columns
    piv_parts, pool_parts, counts = [], [], []
    at = 0
    for r in range(nproc):
        pp = Segments.of(recv_p[r])
        qq = Segments.of(recv_q[r])
        piv_parts.append((pp.start, pp.length, pp.stride, pp.buf + at))
        at += pp.total
        pool_parts.append((qq.start, qq.length, qq.stride, qq.buf + at))
        at += qq.total
        counts.append(pp.total + qq.total)
    gl.recv_piv = _cat4(piv_parts)
    gl.recv_pool = _cat4(pool_parts)
    gl.recv_counts = np.array(counts, dtype=np.int64)


def _cat4(parts) -> Segments:
    arrs = [np.concatenate([np.asarray(p[i], np.int64) for p in parts])
            if parts else np.zeros(0, np.int64) for i in range(4)]
    return Segments(*arrs)
