"""Distributed-memory analysis for the mesh tier (ParSymbFact).

Port of the JAX package's ``parallel/panalysis.py``, host numpy over the
shared-memory tree collectives (parallel/treecomm.py) and the port's own
native library (native/: mlnd, etree, postorder, symbolic).  Capability
analog of the reference's parallel ordering + parallel symbolic
factorization (options->ParSymbFact):

* get_perm_c_parmetis (SRC/get_perm_c_parmetis.c:104,255) computes a
  nested-dissection ordering on the DISTRIBUTED graph — no rank ever
  assembles the full adjacency structure.
* psymbfact (SRC/psymbfact.c:140,228-242) partitions the symbolic
  factorization by separator subtree across the ranks so the
  O(nnz(L))-sized symbolic work and the O(nnz(A)) graph memory stop
  being replicated per process.

1. **Distributed ordering** (the ParMETIS shape).  Each rank holds block
   rows of the structurally-symmetrized, equilibrated, row-permuted
   pattern.  Ranks coarsen their LOCAL subgraphs by greedy heavy-edge
   matching (only same-rank vertex pairs contract) until the global
   coarse graph is small; only that coarse graph is gathered to rank 0,
   which splits it into P parts by recursive BFS-level-set bisection
   (``_coarse_bisect``).  The coarse separators project back through the
   contraction maps to fine vertex labels and are thinned on the fine
   graph (``_trim_separators``); each rank then receives its part's rows
   (an all-to-all over the tree) and orders its own ~n/P subgraph with
   the serial nested dissection (native mlnd, or ``bfs_nd`` with
   ``Options(native=False)``).
2. **Subtree-partitioned symbolic** (the psymbfact shape).  Every rank
   runs the supernodal symbolic on its OWN part only, as a bordered
   problem (``_bordered_symbolic``): part columns first, the touched
   separator vertices as opaque trailing boundary columns.  The
   elimination layout is [part 0]…[part P-1][separators, deepest tree
   level first, top separator last] — fill-equivalent to the
   interleaved ND order.  Each part's local-root supernodes contribute
   their boundary row sets as cliques; rank 0 folds them into the
   separator block's own symbolic.
3. **Assembly.**  The per-part symbolic pieces are gathered and stitched
   into one global SymbolicFact on rank 0, amalgamated, planned
   (numeric.plan.build_plan) and broadcast — the same skeleton the SPMD
   factorization (parallel/spmd.py) consumes on every rank.

Equilibration is computed distributed (the pdgsequ analog).
LargeDiag_MC64/AWPM row matchings are serial on rank 0 over a TRANSIENT
gather of the scaled matrix, as the reference does (pdgssvx.c:775);
NOROWPERM and MY_PERMR stay fully distributed.

The SamePattern reuse tiers need the serial analysis' value_perm gather
map; a panalyze-produced skeleton records none (values are assembled
directly), so such a handle is refactored by a new analysis, not reused.
"""

from __future__ import annotations

import numpy as np

from superlu_dist_tpu_torch.parallel.dist import DistributedCSR
from superlu_dist_tpu_torch.parallel.treecomm import TreeComm
from superlu_dist_tpu_torch.sparse.formats import (SparseCSR, coo_to_csr,
                                                   invert_perm)
from superlu_dist_tpu_torch.utils.errors import SuperLUError


# ---------------------------------------------------------------------------
# collective helpers over the (sum/bcast-only) tree
# ---------------------------------------------------------------------------

def _allreduce_max(tc: TreeComm, vec: np.ndarray,
                   chunk: int = 1 << 16) -> np.ndarray:
    """Elementwise max across ranks over the sum-typed tree: ranks
    stack CHUNKS into disjoint slots and reduce, so the transient
    buffer is O(P·chunk), never O(P·n) — the module's O(part)-memory
    property must survive its own collectives."""
    vec = np.asarray(vec, dtype=np.float64)
    out = np.empty(len(vec))
    for lo in range(0, len(vec), chunk):
        hi = min(lo + chunk, len(vec))
        buf = np.zeros((tc.n_ranks, hi - lo))
        buf[tc.rank] = vec[lo:hi]
        out[lo:hi] = tc.allreduce_sum_any(buf).max(axis=0)
    return out


def _gather_concat(tc: TreeComm, arr: np.ndarray, root: int = 0,
                   all_ranks: bool = False, dtype=np.float64,
                   window: int = 1 << 21):
    """Concatenate every rank's 1-D array in rank order (on root, or on
    every rank) via WINDOWED disjoint-slot sum-reduction: only the
    receiver materializes the O(total) result; every other rank's
    transient is O(window) — the gathers must not break the module's
    O(part)-per-rank memory property."""
    counts = np.zeros(tc.n_ranks)
    counts[tc.rank] = len(arr)
    counts = tc.allreduce_sum_any(counts)
    offs = np.zeros(tc.n_ranks + 1, dtype=np.int64)
    offs[1:] = np.cumsum(counts).astype(np.int64)
    total = int(offs[-1])
    my_lo, my_hi = int(offs[tc.rank]), int(offs[tc.rank + 1])
    op = tc.allreduce_sum_any if all_ranks else tc.reduce_sum_any
    keep = all_ranks or tc.rank == root
    out = np.empty(total, dtype=dtype) if keep else None
    for lo in range(0, total, window):
        hi = min(lo + window, total)
        buf = np.zeros(hi - lo, dtype=dtype)
        a, b = max(my_lo, lo), min(my_hi, hi)
        if a < b:
            buf[a - lo:b - lo] = arr[a - my_lo:b - my_lo]
        buf = op(buf, root=root)
        if keep:
            out[lo:hi] = buf
    return out, offs


def _route(tc: TreeComm, dest: np.ndarray, payloads: dict):
    """All-to-all: item i (with its payload row) goes to rank dest[i].
    Returns {name: received array} on every rank.  Per destination, ONE
    counts-allreduce sizes the slots and the same-dtype keys ride one
    packed disjoint-slot reduction — O(P) rounds, volume O(items)."""
    keys = list(payloads)
    is_cplx = [np.issubdtype(np.asarray(payloads[k]).dtype,
                             np.complexfloating) for k in keys]
    out = {}
    for d in range(tc.n_ranks):
        mask = dest == d
        counts = np.zeros(tc.n_ranks)
        counts[tc.rank] = int(mask.sum())
        counts = tc.allreduce_sum_any(counts)
        offs = np.zeros(tc.n_ranks + 1, dtype=np.int64)
        offs[1:] = np.cumsum(counts).astype(np.int64)
        total = int(offs[-1])
        lo = int(offs[tc.rank])
        for cplx in (False, True):
            ks = [k for k, c in zip(keys, is_cplx) if c == cplx]
            if not ks:
                continue
            dt = np.complex128 if cplx else np.float64
            buf = np.zeros(len(ks) * total, dtype=dt)
            for i, k in enumerate(ks):
                part = np.asarray(payloads[k])[mask]
                buf[i * total + lo:i * total + lo + len(part)] = part
            buf = tc.reduce_sum_any(buf, root=d)
            if tc.rank == d:
                for i, k in enumerate(ks):
                    out[k] = buf[i * total:(i + 1) * total]
    return {k: out.get(k, np.empty(
        0, dtype=np.complex128 if c else np.float64))
        for k, c in zip(keys, is_cplx)}


# ---------------------------------------------------------------------------
# distributed equilibration (pdgsequ/pdlaqgs analog, SRC/pdgsequ.c)
# ---------------------------------------------------------------------------

def _pgsequ(tc: TreeComm, a_loc: DistributedCSR):
    """Distributed gsequ: row scales from local rows, column maxima
    tree-allreduced.  Returns (r_full, c, rowcnd, colcnd, amax) with the
    full global r (assembled — O(n), every rank)."""
    n = a_loc.n
    rows = np.repeat(np.arange(a_loc.m_loc), np.diff(a_loc.indptr))
    absa = np.abs(np.asarray(a_loc.data))
    rowmax_loc = np.zeros(a_loc.m_loc)
    np.maximum.at(rowmax_loc, rows, absa)
    rowmax = np.zeros(n)
    rowmax[a_loc.fst_row:a_loc.fst_row + a_loc.m_loc] = rowmax_loc
    # rows are rank-disjoint: a disjoint-slot sum-reduce IS the max
    rowmax = tc.allreduce_sum_any(rowmax)
    if np.any(rowmax == 0):
        raise SuperLUError(
            f"row {int(np.argmin(rowmax != 0))} of A is exactly zero")
    r = 1.0 / rowmax
    r_loc = r[a_loc.fst_row:a_loc.fst_row + a_loc.m_loc]
    colmax = np.zeros(n)
    np.maximum.at(colmax, np.asarray(a_loc.indices), absa * r_loc[rows])
    colmax = _allreduce_max(tc, colmax)
    if np.any(colmax == 0):
        raise SuperLUError(
            f"column {int(np.argmin(colmax != 0))} of A is exactly zero")
    c = 1.0 / colmax
    smlnum = np.finfo(np.float64).tiny
    bignum = 1.0 / smlnum
    rowcnd = max(r.min(), smlnum) / min(r.max(), bignum)
    colcnd = max(c.min(), smlnum) / min(c.max(), bignum)
    amax = float(_allreduce_max(tc, np.array([absa.max(initial=0.0)]))[0])
    return r, c, float(rowcnd), float(colcnd), amax


# ---------------------------------------------------------------------------
# coarse bisection on rank 0 (the separator-tree builder)
# ---------------------------------------------------------------------------

def _bfs_order(indptr, indices, sub_nodes, start):
    """BFS level sets within the vertex subset; returns list of level
    arrays covering the connected component of `start`."""
    n = len(indptr) - 1
    in_sub = np.zeros(n, dtype=bool)
    in_sub[sub_nodes] = True
    seen = np.zeros(n, dtype=bool)
    seen[start] = True
    frontier = np.array([start], dtype=np.int64)
    levels = [frontier]
    while True:
        nxt = []
        for u in frontier:
            nbr = indices[indptr[u]:indptr[u + 1]]
            nxt.append(nbr)
        if nxt:
            cand = np.unique(np.concatenate(nxt)) if len(nxt) else \
                np.empty(0, dtype=np.int64)
            cand = cand[in_sub[cand] & ~seen[cand]]
        else:
            cand = np.empty(0, dtype=np.int64)
        if len(cand) == 0:
            return levels
        seen[cand] = True
        levels.append(cand)
        frontier = cand


def _coarse_bisect(n, indptr, indices, vwgt, nparts):
    """Recursive BFS-level-set bisection of the coarse graph into
    `nparts` leaf parts.  Returns (labels, n_sep_nodes, part_anc):
    labels[v] = part id in [0, nparts) or -(sep_node_id + 1);
    separator tree nodes are numbered so that DEEPER separators get
    LOWER ids (they are eliminated first; the top separator is the last
    block).  part_anc[p] lists the final separator ids on part p's path
    to the root — the ancestor sets the fine-level separator trimming
    validates moves against.

    The get_perm_c_parmetis.c:255 role: build the separator tree that
    the symbolic phase partitions over."""
    labels = np.full(n, -1, dtype=np.int64)
    sep_nodes = []          # (depth, vertices) in creation order
    part_anc_cre = {}       # part -> ancestor sep CREATION indices
    # work items: (vertex subset, rank ids, depth, ancestor creation ids)
    work = [(np.arange(n, dtype=np.int64), list(range(nparts)), 0, ())]
    while work:
        nodes, ranks, depth, anc = work.pop()
        if len(ranks) == 1:
            labels[nodes] = ranks[0]
            part_anc_cre[ranks[0]] = anc
            continue
        if len(nodes) == 0:
            # empty rank subtree: record the chain anyway so
            # part_anc/anc_allowed coverage stays total for every rank
            for r in ranks:
                part_anc_cre[r] = anc
            continue
        levels = _bfs_order(indptr, indices, nodes, int(nodes[0]))
        comp = np.concatenate(levels)
        if len(comp) < len(nodes):
            # disconnected: split whole components across the two rank
            # halves by weight, no separator needed
            rest = nodes[~np.isin(nodes, comp)]
            # len(ranks) >= 2 here (singleton handled above), so both
            # halves are non-empty; ranks[half:] is the LARGER half when
            # the count is odd and must take the heavier component
            half = len(ranks) // 2
            wc, wr = vwgt[comp].sum(), vwgt[rest].sum()
            if wc >= wr:
                work.append((comp, ranks[half:], depth, anc))
                work.append((rest, ranks[:half], depth, anc))
            else:
                work.append((rest, ranks[half:], depth, anc))
                work.append((comp, ranks[:half], depth, anc))
            continue
        # pseudo-peripheral restart for a better diameter
        levels = _bfs_order(indptr, indices, nodes, int(levels[-1][0]))
        if len(levels) <= 2:
            # clique-ish blob: no useful separator; give it to the first
            # rank half entirely (the other half gets an empty part)
            half = max(len(ranks) // 2, 1)
            work.append((nodes, ranks[:half], depth, anc))
            work.append((np.empty(0, dtype=np.int64), ranks[half:],
                         depth, anc))
            continue
        lw = np.array([vwgt[l].sum() for l in levels], dtype=float)
        half_ranks = len(ranks) // 2
        target = lw.sum() * half_ranks / len(ranks)
        cut = int(np.clip(np.searchsorted(np.cumsum(lw), target),
                          1, len(levels) - 2))
        sep = levels[cut]
        left = np.concatenate(levels[:cut])
        right = (np.concatenate(levels[cut + 1:])
                 if cut + 1 < len(levels) else np.empty(0, dtype=np.int64))
        cre = len(sep_nodes)
        sep_nodes.append((depth, sep))
        work.append((left, ranks[:half_ranks], depth + 1, anc + (cre,)))
        work.append((right, ranks[half_ranks:], depth + 1, anc + (cre,)))
    # separator ids: deeper first, top (depth 0) last
    order = sorted(range(len(sep_nodes)),
                   key=lambda i: -sep_nodes[i][0])
    cre2sid = {i: sid for sid, i in enumerate(order)}
    for sid, i in enumerate(order):
        labels[sep_nodes[i][1]] = -(sid + 1)
    part_anc = {p: [cre2sid[c] for c in anc]
                for p, anc in part_anc_cre.items()}
    return labels, len(sep_nodes), part_anc


def _trim_separators(tc: TreeComm, lab, sr, sc, my_lo, my_hi, part_anc,
                     P, passes: int = 6):
    """Fine-graph separator refinement (the multilevel 'sep thinning'
    step ParMETIS applies during uncoarsening): a projected separator
    vertex whose every neighbor lies in ONE part p or in a separator on
    p's root path moves into p — peeling a k-layer slab from both faces
    until a ~1-layer true separator remains.  Each rank trims only the
    vertices it owns; updates combine by disjoint-slot reduction, and a
    verify round reverts (to separator status — always safe) the
    higher-indexed endpoint of any cross-part edge two simultaneous
    moves created."""
    n = len(lab)
    # allowed (part, separator-label) pairs: p's ancestor chain as a
    # dense boolean table over sep ids (sep label -s-1 -> row s)
    n_sep_ids = int(-lab.min()) if (lab < 0).any() else 0
    allowed = np.zeros((P, n_sep_ids + 1), dtype=bool)
    for p in range(P):
        for s in part_anc.get(p, []):
            if s < n_sep_ids:
                allowed[p, s] = True
    # my owned vertices' adjacency (CSR over the block), self-loops out
    keep = sr != sc
    order = np.argsort(sr[keep], kind="stable")
    sr_s, sc_s = sr[keep][order], sc[keep][order]
    ptr = np.searchsorted(sr_s, np.arange(my_lo, my_hi + 1))
    row_of = sr_s - my_lo
    for _ in range(passes):
        moves = np.zeros(n)
        nl = lab[sc_s]
        # per owned row: are all part-labeled neighbors one part p?
        big = np.where(nl >= 0, nl, P + 1)     # sentinel above any part
        small = np.where(nl >= 0, nl, -2)      # sentinel below any part
        pmax = np.full(my_hi - my_lo, -2, dtype=np.int64)
        pmin = np.full(my_hi - my_lo, P + 1, dtype=np.int64)
        np.minimum.at(pmin, row_of, big)
        np.maximum.at(pmax, row_of, small)
        one_part = (pmin == pmax) & (pmax >= 0)
        # and is every separator-labeled neighbor either the vertex's
        # own slab or an ancestor of that part?
        vlab = lab[my_lo:my_hi]
        is_sep_n = nl < 0
        own = nl[is_sep_n] == vlab[row_of[is_sep_n]]
        p_row = np.clip(pmax[row_of[is_sep_n]], 0, P - 1)
        anc_ok = allowed[p_row, np.clip(-nl[is_sep_n] - 1, 0, n_sep_ids)]
        sep_bad = np.zeros(my_hi - my_lo, dtype=bool)
        np.logical_or.at(sep_bad, row_of[is_sep_n], ~(own | anc_ok))
        movable = (vlab < 0) & one_part & ~sep_bad
        mv = np.flatnonzero(movable)
        moves[mv + my_lo] = pmax[mv] - vlab[mv]     # encode the delta
        moves = tc.allreduce_sum_any(moves)
        if not moves.any():
            break
        cand = lab + moves.astype(np.int64)
        # verify: two adjacent vertices moved into different parts makes
        # a cross-part edge — revert the higher-indexed endpoint
        bad = ((cand[sr_s] >= 0) & (cand[sc_s] >= 0)
               & (cand[sr_s] != cand[sc_s]))
        revert = np.zeros(n)
        if bad.any():
            hi_end = np.maximum(sr_s[bad], sc_s[bad])
            revert[hi_end] = 1.0
        revert = tc.allreduce_sum_any(revert)
        lab = np.where(revert > 0, lab, cand)
    return lab


# ---------------------------------------------------------------------------
# bordered supernodal symbolic (per part, and for the separator block)
# ---------------------------------------------------------------------------

def _constrained_postorder(parent, m, native: bool = True):
    """Postorder of the bordered etree, stable-partitioned so the m part
    columns keep positions 0..m-1 (in postorder relative order) and the
    boundary columns keep m..q-1 in their original ascending order.
    Ancestor chains keep their relative order under postorder, so
    parent > child still holds afterwards."""
    if native:
        from superlu_dist_tpu_torch import native as nat
        post = nat.postorder(parent)
    else:
        from superlu_dist_tpu_torch.ordering.etree import postorder
        post = postorder(parent)
    part = post[post < m]                    # postorder among part cols
    bnd = np.arange(m, len(parent), dtype=np.int64)  # natural boundary
    return np.concatenate([part, bnd])


def _bordered_symbolic(m, q, indptr, indices, relax, max_supernode,
                       native: bool = True):
    """Supernodal symbolic of the leading m columns of a q×q bordered
    pattern (columns m..q-1 are boundary: they appear only as row
    indices; their own fill is computed but discarded).

    Returns (post_part, sn_start, sn_rows, sn_parent, parent_cols):
    post_part maps new part position -> input part column; sn_* describe
    supernodes over the m part columns in the new labels, with row
    indices in the new labeling (boundary rows keep labels >= m, whose
    relative order equals the input's); sn_parent is -1 for local roots.
    parent_cols is the column etree over the m part columns (-1 when the
    parent is a boundary column).

    The machinery is symbolic_factorize's (symbolic/symbfact.py) applied
    to the bordered square: the augmented matrix has empty boundary
    columns, native.etree sees their incident edges through the part
    rows, and the constrained postorder keeps the part block leading.
    ``native`` runs the native library's etree, postorder and symbolic,
    else their Python twins."""
    if native:
        from superlu_dist_tpu_torch import native as nat
        parent0 = nat.etree(q, indptr, indices)
    else:
        from superlu_dist_tpu_torch.ordering.etree import etree_symmetric
        parent0 = etree_symmetric(q, indptr, indices)
    post = _constrained_postorder(parent0, m, native=native)
    inv_post = invert_perm(post)
    # relabel the pattern (tracer-free: no value alignment needed here)
    tr = SparseCSR(q, q, indptr, indices,
                   np.zeros(len(indices), dtype=np.float64))
    b = tr.permute(post, post)
    old_parents = parent0[post]
    parent = np.where(old_parents >= 0,
                      inv_post[np.clip(old_parents, 0, None)], -1)

    if native:
        sn_start, col_to_sn, sn_parent, _lev, rows_ptr, rows_data = \
            nat.symbolic(q, b.indptr, b.indices, parent, relax,
                         max_supernode)
        sn_rows = np.split(rows_data, rows_ptr[1:-1])
    else:
        from superlu_dist_tpu_torch.symbolic.symbfact import (
            build_supernodes_py)
        sn_start, col_to_sn, sn_rows, sn_parent = build_supernodes_py(
            q, b.indptr, b.indices, parent, relax, max_supernode,
            strict=False)

    # split any supernode straddling the part/boundary frontier, then
    # drop the boundary supernodes (their structures were scaffolding)
    sn_start = np.asarray(sn_start, dtype=np.int64)
    keep_start, keep_rows = [], []
    for s in range(len(sn_start) - 1):
        f, l = int(sn_start[s]), int(sn_start[s + 1])
        if l <= m:
            keep_start.append(f)
            keep_rows.append(np.asarray(sn_rows[s], dtype=np.int64))
        elif f < m:
            # lower piece [f, m): its columns' structure is the removed
            # upper piece's columns plus the full row set (a supernodal
            # superset — stored zeros, same contract as amalgamation)
            keep_start.append(f)
            keep_rows.append(np.concatenate([
                np.arange(m, l, dtype=np.int64),
                np.asarray(sn_rows[s], dtype=np.int64)]))
    ns = len(keep_start)
    sn_start_p = np.array(keep_start + [m], dtype=np.int64)
    col_to_sn_p = np.repeat(np.arange(ns), np.diff(sn_start_p))
    sn_parent_p = np.full(ns, -1, dtype=np.int64)
    for s in range(ns):
        r = keep_rows[s]
        if len(r) and r[0] < m:
            sn_parent_p[s] = col_to_sn_p[r[0]]
    # column etree over part columns (supernodal rule: next member
    # column, else first row)
    parent_cols = np.full(m, -1, dtype=np.int64)
    for s in range(ns):
        f, l = int(sn_start_p[s]), int(sn_start_p[s + 1])
        parent_cols[f:l - 1] = np.arange(f + 1, l)
        r = keep_rows[s]
        parent_cols[l - 1] = int(r[0]) if len(r) and r[0] < m else -1
    return post[:m], sn_start_p, keep_rows, sn_parent_p, parent_cols


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

def panalyze(tc: TreeComm, options, a_loc: DistributedCSR, stats=None,
             coarse_target: int | None = None, device=None):
    """Distributed analysis: EQUIL → ROWPERM → distributed COLPERM →
    subtree-partitioned SYMBFACT → assembly + plan on root → skeleton
    broadcast.  Returns (lu, bvals) on EVERY rank — drop-in for the
    root-analysis path of parallel/pgssvx._pgssvx_mesh.

    Falls back to the serial root analysis for problems too small to
    partition (n < 64·P).

    Rank-failure tolerance: every stage is parameterized ONLY by
    (tc.n_ranks, tc.rank) and the re-dealt input rows, never by a
    remembered world size — which is what lets a recovery epoch
    (parallel/recover.pgssvx_ft, Options.ft="shrink") simply re-run this
    partitioning over the surviving rank set after a peer died
    mid-analysis; a death inside any collective here surfaces as
    RankFailureError on every survivor once SLU_TPU_COMM_TIMEOUT_S
    bounds the legs.  The skeleton records ``device`` (None: the card),
    where the caller's factorization runs; nothing here touches it."""
    from superlu_dist_tpu_torch.drivers.gssvx import LUFactorization
    from superlu_dist_tpu_torch.numeric.plan import build_plan
    from superlu_dist_tpu_torch.parallel.pgssvx import (bcast_result,
                                                        gather_distributed,
                                                        root_analyze_bcast)
    from superlu_dist_tpu_torch.rowperm.equil import _THRESH
    from superlu_dist_tpu_torch.utils.options import (ColPerm, Fact, RowPerm,
                                                      resolve_device)
    from superlu_dist_tpu_torch.utils.stats import Stats

    if stats is None:
        stats = Stats()
    n = a_loc.n
    P = tc.n_ranks
    if options.fact != Fact.DOFACT:
        raise SuperLUError("panalyze supports Fact=DOFACT only "
                           "(reuse tiers need the serial analysis)")
    if options.col_perm != ColPerm.ND_AT_PLUS_A:
        # the reference likewise rejects ParSymbFact with any ColPerm
        # but PARMETIS — the distributed ordering IS the column perm
        raise SuperLUError(
            "ParSymbFact computes its own distributed nested-dissection "
            "ordering; col_perm must be ND/METIS_AT_PLUS_A")
    device = resolve_device("cuda" if device is None else device)
    if P == 1 or n < 64 * P:
        return root_analyze_bcast(tc, options, a_loc, stats, device=device)

    complex_in = np.issubdtype(np.asarray(a_loc.data).dtype,
                               np.complexfloating)
    vdtype = np.complex128 if complex_in else np.float64
    lo_row = a_loc.fst_row
    m_loc = a_loc.m_loc

    # ---- EQUIL (distributed pdgsequ/pdlaqgs) -----------------------------
    rows_l = np.repeat(np.arange(m_loc), np.diff(a_loc.indptr))
    with stats.timer("EQUIL"):
        vals = np.asarray(a_loc.data, dtype=vdtype)
        if options.equil:
            r, c, rowcnd, colcnd, amax = _pgsequ(tc, a_loc)
            small = np.finfo(np.float64).tiny / np.finfo(np.float64).eps
            large = 1.0 / small
            do_row = rowcnd < _THRESH
            do_col = colcnd < _THRESH or amax < small or amax > large
            equed = {(False, False): "N", (True, False): "R",
                     (False, True): "C", (True, True): "B"}[(do_row, do_col)]
            dr = r if do_row else np.ones(n)
            dc = c if do_col else np.ones(n)
            vals = vals * dr[lo_row + rows_l] * dc[a_loc.indices]
        else:
            equed = "N"
            dr = dc = np.ones(n)

    # ---- ROWPERM ---------------------------------------------------------
    # LargeDiag matchings are inherently serial — transient gather on
    # root ONLY (freed before the memory-heavy phases), like the
    # reference's gather before dldperm_dist (pdgssvx.c:775).
    with stats.timer("ROWPERM"):
        rp = options.row_perm
        if rp in (RowPerm.LargeDiag_MC64, RowPerm.LargeDiag_AWPM):
            from superlu_dist_tpu_torch.rowperm.matching import (
                approximate_weight_matching, maximum_product_matching)
            scaled = DistributedCSR(n=n, m_loc=m_loc, fst_row=lo_row,
                                    indptr=a_loc.indptr,
                                    indices=a_loc.indices, data=vals)
            a1_root = gather_distributed(tc, scaled, root=0)

            def _match():
                if rp == RowPerm.LargeDiag_MC64:
                    return maximum_product_matching(a1_root,
                                                    native=options.native)
                return (approximate_weight_matching(a1_root,
                                                    native=options.native),
                        np.ones(n), np.ones(n))

            row_order, r1, c1 = bcast_result(tc, _match)
            del a1_root
        elif rp == RowPerm.MY_PERMR:
            row_order = np.asarray(options.user_perm_r, dtype=np.int64)
            r1 = c1 = np.ones(n)
        else:
            row_order = np.arange(n, dtype=np.int64)
            r1 = c1 = np.ones(n)
        inv_row = invert_perm(row_order)
        vals = vals * r1[lo_row + rows_l] * c1[a_loc.indices]
        # a2-space labels: orig row i -> inv_row[i]; columns unchanged
        gr = inv_row[lo_row + rows_l]            # a2 row label per entry
        gc = np.asarray(a_loc.indices, dtype=np.int64)

    # anorm of a2 = max |entry| (norm_max), scale-invariant to labels
    anorm = float(_allreduce_max(
        tc, np.array([np.abs(vals).max(initial=0.0)]))[0])

    # ---- distributed symmetrization --------------------------------------
    # Route (r, c, v) to owner(r) and the transpose marker (c, r, 0) to
    # owner(c); owners aggregate duplicates by sum (transpose zeros do
    # not perturb) — symmetrize_pattern's union, distributed.
    step = -(-n // P)
    owner_of = lambda v: np.minimum(v // step, P - 1)
    dest = np.concatenate([owner_of(gr), owner_of(gc)])
    got = _route(tc, dest, {
        "r": np.concatenate([gr, gc]),
        "c": np.concatenate([gc, gr]),
        "v": np.concatenate([vals, np.zeros_like(vals)]),
    })
    sr = got["r"].real.astype(np.int64)
    sc = got["c"].real.astype(np.int64)
    sv = got["v"].astype(vdtype)
    # aggregate (r, c) duplicates (empty receive: an overhanging rank)
    if len(sr):
        key = sr * n + sc
        order_k = np.argsort(key, kind="stable")
        key, sr, sc, sv = (key[order_k], sr[order_k], sc[order_k],
                           sv[order_k])
        uniq = np.concatenate([[True], key[1:] != key[:-1]])
        grp = np.cumsum(uniq) - 1
        sv_agg = np.zeros(int(grp[-1]) + 1, dtype=vdtype)
        np.add.at(sv_agg, grp, sv)
        sr, sc, sv = sr[uniq], sc[uniq], sv_agg
    my_lo = min(tc.rank * step, n)
    my_hi = min((tc.rank + 1) * step, n)

    # ---- distributed COLPERM (coarsen -> coarse ND on root) --------------
    with stats.timer("COLPERM"):
        if coarse_target is None:
            coarse_target = max(2048, 64 * P)
        # current level: rank owns contiguous label block [cur_lo, cur_hi)
        cur_r, cur_c = sr - my_lo, sc      # rows local, cols global
        cur_w = np.ones(my_hi - my_lo, dtype=np.int64)   # vertex weights
        cur_ew = np.ones(len(cur_r), dtype=np.int64)     # edge weights
        cur_n = n
        blocks = _block_bounds(tc, my_hi - my_lo)
        maps = []                          # replicated fine->coarse maps
        for _lvl in range(20):
            if cur_n <= coarse_target:
                break
            match = _local_match(len(cur_w), cur_r, cur_c, cur_ew,
                                 blocks[tc.rank])
            # coarse ids: contiguous per rank via count scan
            n_coarse_loc = int(match.max() + 1) if len(match) else 0
            counts = np.zeros(P)
            counts[tc.rank] = n_coarse_loc
            counts = tc.allreduce_sum_any(counts)
            coff = np.zeros(P + 1, dtype=np.int64)
            coff[1:] = np.cumsum(counts).astype(np.int64)
            # replicated fine->coarse map for this level
            fmap = np.zeros(cur_n, dtype=np.int64)
            fmap[blocks[tc.rank][0]:blocks[tc.rank][1]] = \
                match + coff[tc.rank]
            fmap = tc.allreduce_sum_any(fmap).astype(np.int64)
            maps.append(fmap)
            # contract local edges
            ncr = fmap[cur_r + blocks[tc.rank][0]]
            ncc = fmap[cur_c]
            keep = ncr != ncc
            ncr, ncc, new_ew = ncr[keep], ncc[keep], cur_ew[keep]
            k2 = ncr * int(coff[-1]) + ncc
            o2 = np.argsort(k2, kind="stable")
            k2, ncr, ncc, new_ew = k2[o2], ncr[o2], ncc[o2], new_ew[o2]
            u2 = np.concatenate([[True], k2[1:] != k2[:-1]]) \
                if len(k2) else np.empty(0, dtype=bool)
            g2 = np.cumsum(u2) - 1
            ew_agg = np.zeros(int(g2[-1]) + 1 if len(g2) else 0,
                              dtype=np.int64)
            np.add.at(ew_agg, g2, new_ew)
            nw = np.zeros(n_coarse_loc, dtype=np.int64)
            np.add.at(nw, match, cur_w)
            new_n = int(coff[-1])
            if new_n >= 0.95 * cur_n:      # stalled — stop coarsening
                maps.pop()
                break
            cur_r = ncr[u2] - coff[tc.rank]
            cur_c = ncc[u2]
            cur_ew = ew_agg
            cur_w = nw
            cur_n = new_n
            blocks = [(int(coff[i]), int(coff[i + 1])) for i in range(P)]
        # gather the coarse graph (edges + vertex weights) on root
        er, _ = _gather_concat(tc, (cur_r + blocks[tc.rank][0]).astype(
            np.float64))
        ec, _ = _gather_concat(tc, cur_c.astype(np.float64))
        ew, _ = _gather_concat(tc, cur_ew.astype(np.float64))
        vw_full = np.zeros(cur_n)
        vw_full[blocks[tc.rank][0]:blocks[tc.rank][1]] = cur_w
        vw_full = tc.reduce_sum_any(vw_full, root=0)

        def _bisect():
            cg = coo_to_csr(cur_n, cur_n, er.astype(np.int64),
                            ec.astype(np.int64), ew)
            labels, _nsep, part_anc = _coarse_bisect(
                cur_n, cg.indptr, cg.indices, vw_full, P)
            return labels, part_anc

        clabels, part_anc = bcast_result(tc, _bisect)
        clabels = np.asarray(clabels, dtype=np.int64)
        # project through the contraction maps: label of fine vertex v
        lab = clabels
        for fmap in reversed(maps):
            lab = lab[fmap]
        # lab[v] >= 0: part id; < 0: separator node -(id+1), deeper first
        # projected separators are THICK SLABS (one matching level ~
        # doubles the width) and top-separator width enters the fill
        # cubically — refine them on the fine graph before partitioning
        lab = _trim_separators(tc, lab, sr, sc, my_lo, my_hi, part_anc,
                               P)

    # ---- route rows to their part owners (seps to root) ------------------
    dest = np.where(lab[sr] >= 0, lab[sr], 0).astype(np.int64)
    got = _route(tc, dest, {"r": sr.astype(np.float64),
                            "c": sc.astype(np.float64), "v": sv})
    pr = got["r"].real.astype(np.int64)
    pc = got["c"].real.astype(np.int64)
    pv = got["v"].astype(vdtype)
    # rank 0 also received every separator row; split them out
    sep_mask = lab[pr] < 0
    part_mask = lab[pr] == tc.rank
    ppr, ppc, ppv = pr[part_mask], pc[part_mask], pv[part_mask]

    sr0, sc0, sv0 = pr[sep_mask], pc[sep_mask], pv[sep_mask]
    with stats.timer("SYMBFACT"):
        ctx = _part_symbolic(tc, n, P, lab, ppr, ppc, ppv, options,
                             vdtype)

    def _finish_root():
        # root-only: separator symbolic + assembly + plan.  Runs inside
        # bcast_result so an assembly failure reaches every rank
        # instead of stranding them in the skeleton broadcast.
        sf, bvals = _assemble_root(ctx, n, P, lab, sr0, sc0, sv0,
                                   options, vdtype)
        with stats.timer("DIST"):
            # the same scheduler as the serial analysis: per-rank plans
            # are this one root-built skeleton broadcast to every rank,
            # so schedule/window/align must come from the SAME options
            # (a rank-varying env knob would desynchronize the SPMD
            # dispatch sequence)
            plan = build_plan(sf, min_bucket=options.min_bucket,
                              growth=options.bucket_growth,
                              schedule=options.schedule,
                              window=options.sched_window,
                              align=options.sched_align,
                              closed=options.bucket_closed,
                              max_keys=options.bucket_keys,
                              native=options.native)
        return LUFactorization(
            n=n, options=options, device=device, equed=equed, dr=dr,
            dc=dc, r1=r1, c1=c1, row_order=row_order, col_order=None,
            sf=sf, plan=plan, numeric=None, anorm=anorm, a=None,
            a_sym_indptr=None, a_sym_indices=None), bvals

    return bcast_result(tc, _finish_root)


def _block_bounds(tc, m_mine):
    counts = np.zeros(tc.n_ranks)
    counts[tc.rank] = m_mine
    counts = tc.allreduce_sum_any(counts)
    offs = np.zeros(tc.n_ranks + 1, dtype=np.int64)
    offs[1:] = np.cumsum(counts).astype(np.int64)
    return [(int(offs[i]), int(offs[i + 1])) for i in range(tc.n_ranks)]


def _local_match(m, er_loc, ec, ew, block):
    """Greedy heavy-edge matching among THIS rank's vertices (both
    endpoints owned); returns fine-local -> coarse-local map."""
    lo, hi = block
    # local-local edges only
    ll = (ec >= lo) & (ec < hi)
    r_l, c_l, w_l = er_loc[ll], ec[ll] - lo, ew[ll]
    order = np.argsort(-w_l, kind="stable")
    matched = np.full(m, -1, dtype=np.int64)
    for i in order:
        u, v = int(r_l[i]), int(c_l[i])
        if u != v and matched[u] < 0 and matched[v] < 0:
            matched[u] = v
            matched[v] = u
    out = np.full(m, -1, dtype=np.int64)
    nxt = 0
    for u in range(m):
        if out[u] >= 0:
            continue
        out[u] = nxt
        if matched[u] >= 0:
            out[matched[u]] = nxt
        nxt += 1
    return out


def _part_symbolic(tc, n, P, lab, pr, pc, pv, options, vdtype):
    """Per-part bordered symbolic + the piece gathers.  Returns the
    gathered context for _assemble_root on rank 0, None elsewhere.
    Everything rank-local here is O(part), the psymbfact property."""
    from superlu_dist_tpu_torch import native as nat
    from superlu_dist_tpu_torch.ordering.dissection import bfs_nd

    relax = options.relax
    max_supernode = options.max_supernode

    # ---- local ordering + bordered symbolic on my part -------------------
    verts = np.unique(pr)                   # my part's vertices (a2 labels)
    m = len(verts)
    r_l = np.searchsorted(verts, pr)
    is_int = lab[pc] == tc.rank
    # the separator invariant must fail COLLECTIVELY: a single-rank
    # assert here would strand the peers in the allreduces below
    # (slulint SLU101 — rank-dependent early exit before a collective)
    bad = np.zeros(1)
    bad[0] = float(np.any(~(is_int | (lab[pc] < 0))))
    if int(tc.allreduce_sum_any(bad)[0]):
        raise SuperLUError(
            "cross-part edge: projected separator is not a separator")
    bnd = np.unique(pc[~is_int])            # touched separator vertices
    c_l = np.where(is_int, np.searchsorted(verts, pc),
                   m + np.searchsorted(bnd, pc))
    if m:
        # internal subgraph CSR for the ordering
        sub = coo_to_csr(m, m, r_l[is_int], c_l[is_int],
                         np.zeros(int(is_int.sum())))
        order0 = (nat.mlnd(m, sub.indptr, sub.indices) if options.native
                  else bfs_nd(m, sub.indptr, sub.indices))
        inv0 = invert_perm(order0)
        q = m + len(bnd)
        aug = coo_to_csr(q, q, inv0[r_l],
                         np.where(c_l < m, inv0[np.clip(c_l, 0, m - 1)],
                                  c_l),
                         np.zeros(len(r_l)))
        post_part, sn_start_p, sn_rows_p, sn_parent_p, parent_cols = \
            _bordered_symbolic(m, q, aug.indptr, aug.indices, relax,
                               max_supernode, native=options.native)
        # my part's final order: position t holds a2 label
        # verts[order0[post_part[t]]]
        part_perm = verts[order0[post_part]]
    else:
        part_perm = np.empty(0, dtype=np.int64)
        sn_start_p = np.array([0], dtype=np.int64)
        sn_rows_p, sn_parent_p = [], np.empty(0, dtype=np.int64)
        parent_cols = np.empty(0, dtype=np.int64)
        bnd = np.empty(0, dtype=np.int64)

    # part offsets in the global elimination layout
    sizes = np.zeros(P)
    sizes[tc.rank] = m
    sizes = tc.allreduce_sum_any(sizes)
    poffs = np.zeros(P + 1, dtype=np.int64)
    poffs[1:] = np.cumsum(sizes).astype(np.int64)
    off_p = int(poffs[tc.rank])
    sep_start = int(poffs[-1])

    # ---- ship symbolic pieces + pattern/value slices to root -------------
    # rows encoding: in-part -> final global (off_p + local); separator
    # -> -(a2_label + 1), decoded on root once the separator order exists
    def enc_rows(rr):
        if len(bnd) == 0:
            return rr + off_p
        return np.where(rr < m, rr + off_p,
                        -(bnd[np.clip(rr - m, 0, len(bnd) - 1)] + 1))
    rows_flat = (np.concatenate([enc_rows(r) for r in sn_rows_p])
                 if sn_rows_p else np.empty(0, dtype=np.int64))
    rows_cnt = np.array([len(r) for r in sn_rows_p], dtype=np.int64)

    # pattern slice: for each of my part columns IN FINAL LOCAL ORDER,
    # its full adjacency (values included) with the same encoding
    if m:
        final_of_vert = np.empty(m, dtype=np.int64)     # vert idx -> final
        final_of_vert[np.searchsorted(verts, part_perm)] = \
            np.arange(m) + off_p
        er_fin = final_of_vert[r_l]
        if len(bnd) == 0:
            ec_enc = final_of_vert[c_l]
        else:
            ec_enc = np.where(c_l < m,
                              final_of_vert[np.clip(c_l, 0, m - 1)],
                              -(bnd[np.clip(c_l - m, 0,
                                            len(bnd) - 1)] + 1))
        o = np.argsort(er_fin, kind="stable")
        er_fin, ec_enc, ev = er_fin[o], ec_enc[o], pv[o]
        row_cnt_pat = np.bincount(er_fin - off_p, minlength=m)
    else:
        er_fin = ec_enc = np.empty(0, dtype=np.int64)
        ev = np.empty(0, dtype=vdtype)
        row_cnt_pat = np.empty(0, dtype=np.int64)

    g = {}
    g["perm"], _ = _gather_concat(tc, part_perm.astype(np.float64))
    g["snw"], _ = _gather_concat(
        tc, np.diff(sn_start_p).astype(np.float64))
    g["snp"], snp_offs = _gather_concat(
        tc, sn_parent_p.astype(np.float64))
    g["rcnt"], _ = _gather_concat(tc, rows_cnt.astype(np.float64))
    g["rflat"], _ = _gather_concat(tc, rows_flat.astype(np.float64))
    g["pcnt"], _ = _gather_concat(tc, row_cnt_pat.astype(np.float64))
    g["pcol"], _ = _gather_concat(tc, ec_enc.astype(np.float64))
    g["pval"], _ = _gather_concat(tc, ev, dtype=vdtype)
    g["pcols_etree"], _ = _gather_concat(
        tc, np.where(parent_cols >= 0, parent_cols + off_p, -1).astype(
            np.float64))

    if tc.rank != 0:
        return None
    return {"g": g, "snp_offs": snp_offs, "sep_start": sep_start}


def _assemble_root(ctx, n, P, lab, sr0, sc0, sv0, options, vdtype):
    """Root-only tail of the distributed symbolic: separator-block
    symbolic with the parts' boundary cliques folded in, then global
    assembly into one SymbolicFact + the permuted values.  Split from
    _part_symbolic so panalyze can run it under the exception-shipping
    broadcast."""
    from superlu_dist_tpu_torch.symbolic.symbfact import (
        _finish, amalgamate_supernodes)

    relax = options.relax
    max_supernode = options.max_supernode
    g = ctx["g"]
    snp_offs = ctx["snp_offs"]
    sep_start = ctx["sep_start"]

    # ---- root: separator block symbolic ---------------------------------
    # separator vertices ordered by (deeper tree node first, then label);
    # the bordered-symbolic's own etree postorder refines within
    sep_verts_all = np.flatnonzero(lab < 0)
    n_sep = len(sep_verts_all)
    assert sep_start + n_sep == n
    sep_sort = np.lexsort((sep_verts_all, -lab[sep_verts_all]))
    sep_init = sep_verts_all[sep_sort]      # initial sep order (a2 labels)
    sep_pos0_arr = np.full(n, -1, dtype=np.int64)
    sep_pos0_arr[sep_init] = np.arange(n_sep)

    # pattern among separators (root received all separator rows)
    ss_mask = lab[sc0] < 0
    ssr = sep_pos0_arr[sr0[ss_mask]]
    ssc = sep_pos0_arr[sc0[ss_mask]]
    # cliques: local-root supernodes' separator rows, from every part
    widths_all = g["snw"].astype(np.int64)
    snp_all = g["snp"].astype(np.int64)
    rcnt_all = g["rcnt"].astype(np.int64)
    rflat_all = g["rflat"].astype(np.int64)
    # the float64 transport copies are dead once decoded — the root's
    # transient peak is THE assembly cost, keep it one copy per payload
    del g["snw"], g["snp"], g["rcnt"], g["rflat"]
    rows_split = np.split(rflat_all, np.cumsum(rcnt_all)[:-1]) \
        if len(rcnt_all) else []
    clique_r, clique_c = [], []
    for s, rowsv in enumerate(rows_split):
        if snp_all[s] >= 0:
            continue
        sep_rows = -rowsv[rowsv < 0] - 1     # a2 labels
        if len(sep_rows) > 1:
            p0 = sep_pos0_arr[sep_rows]
            cmin = p0.min()
            others = p0[p0 != cmin]
            clique_r.append(np.full(len(others), cmin, dtype=np.int64))
            clique_c.append(others)
    if clique_r:
        ssr = np.concatenate([ssr] + clique_r + clique_c)
        ssc = np.concatenate([ssc] + clique_c + clique_r)
    if n_sep:
        sgraph = coo_to_csr(n_sep, n_sep, ssr, ssc, np.zeros(len(ssr)))
        post_sep, sn_start_s, sn_rows_s, sn_parent_s, parent_cols_s = \
            _bordered_symbolic(n_sep, n_sep, sgraph.indptr,
                               sgraph.indices, relax, max_supernode,
                               native=options.native)
        sep_final = sep_init[post_sep]       # final sep order (a2 labels)
    else:
        sep_final = np.empty(0, dtype=np.int64)
        sn_start_s = np.array([0], dtype=np.int64)
        sn_rows_s, sn_parent_s = [], np.empty(0, dtype=np.int64)
        parent_cols_s = np.empty(0, dtype=np.int64)
    sep_final_pos = np.full(n, -1, dtype=np.int64)
    sep_final_pos[sep_final] = np.arange(n_sep) + sep_start

    # ---- root: global assembly ------------------------------------------
    perm = np.concatenate([g["perm"].astype(np.int64), sep_final])
    assert len(perm) == n
    widths = np.concatenate([widths_all, np.diff(sn_start_s)])
    sn_start = np.zeros(len(widths) + 1, dtype=np.int64)
    np.cumsum(widths, out=sn_start[1:])
    assert sn_start[-1] == n
    ns_part = len(widths_all)
    col_to_sn = np.repeat(np.arange(len(widths)), widths)

    def dec_rows(rv):
        out = np.where(rv >= 0, rv, sep_final_pos[-rv - 1])
        out.sort()
        return out

    sn_rows = [dec_rows(r) for r in rows_split]
    del rows_split, rflat_all          # decoded copies supersede them
    sn_rows += [np.asarray(r, dtype=np.int64) + sep_start
                for r in sn_rows_s]
    # parents: per-part ids shift by the rank's supernode offset; local
    # roots resolve through their (now decoded) first row
    sn_parent = np.empty(len(widths), dtype=np.int64)
    for rk in range(P):
        lo, hi = int(snp_offs[rk]), int(snp_offs[rk + 1])
        for s in range(lo, hi):
            sn_parent[s] = snp_all[s] + lo if snp_all[s] >= 0 else -2
    for s in range(ns_part, len(widths)):
        sp = sn_parent_s[s - ns_part]
        sn_parent[s] = sp + ns_part if sp >= 0 else -1
    for s in range(ns_part):
        if sn_parent[s] == -2:
            r = sn_rows[s]
            sn_parent[s] = col_to_sn[r[0]] if len(r) else -1
    sn_level = np.zeros(len(widths), dtype=np.int64)
    for s in range(len(widths)):
        p = sn_parent[s]
        if p >= 0:
            sn_level[p] = max(sn_level[p], sn_level[s] + 1)

    # column etree (supernodal rule)
    parent = np.full(n, -1, dtype=np.int64)
    pce = g["pcols_etree"].astype(np.int64)
    parent[:sep_start] = pce
    need = np.flatnonzero(parent[:sep_start] < 0)
    for j in need:
        s = col_to_sn[j]
        if j < sn_start[s + 1] - 1:
            parent[j] = j + 1
        else:
            r = sn_rows[s]
            parent[j] = r[0] if len(r) else -1
    for t in range(n_sep):
        j = sep_start + t
        pc_ = parent_cols_s[t]
        if pc_ >= 0:
            parent[j] = pc_ + sep_start
        else:
            s = col_to_sn[j]
            if j < sn_start[s + 1] - 1:
                parent[j] = j + 1
            else:
                r = sn_rows[s]
                parent[j] = r[0] if len(r) else -1

    # ---- root: permuted pattern + values (bvals) -------------------------
    pcnt = g["pcnt"].astype(np.int64)
    pcol_enc = g["pcol"].astype(np.int64)
    pval = g["pval"]
    del g["pcnt"], g["pcol"], g["pval"]
    # separator rows' pattern (root-held), in final labels
    srow_fin = sep_final_pos[sr0]
    scol_fin = np.where(lab[sc0] < 0, sep_final_pos[sc0], -1)
    # non-separator columns in separator rows: their final position is a
    # part position — recover via the part perm
    part_final_pos = np.full(n, -1, dtype=np.int64)
    part_final_pos[perm[:sep_start]] = np.arange(sep_start)
    scol_fin = np.where(scol_fin >= 0, scol_fin, part_final_pos[sc0])
    o = np.argsort(srow_fin, kind="stable")
    srow_fin, scol_fin, sv_fin = srow_fin[o], scol_fin[o], sv0[o]
    sep_cnt = np.bincount(srow_fin - sep_start, minlength=n_sep) \
        if n_sep else np.empty(0, dtype=np.int64)
    # decode part columns' encodings
    pcol_fin = np.where(pcol_enc >= 0, pcol_enc,
                        sep_final_pos[np.where(pcol_enc < 0,
                                               -pcol_enc - 1, 0)])
    counts = np.concatenate([pcnt, sep_cnt])
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = np.concatenate([pcol_fin, scol_fin])
    bvals = np.concatenate([pval, sv_fin]).astype(vdtype)
    del pcol_enc, pcol_fin, scol_fin, pval, sv_fin
    # sort within each row by final column
    rowid = np.repeat(np.arange(n), counts)
    o = np.lexsort((indices, rowid))
    indices, bvals = indices[o], bvals[o]

    us = np.array([len(r) for r in sn_rows], dtype=np.int64)
    sf = _finish(n, perm, parent, sn_start, col_to_sn, sn_rows,
                 sn_parent, sn_level, us, indptr, indices, None)
    tol = options.amalg_tol
    if tol and tol > 1.0 and sf.n_supernodes > 1:
        sf = amalgamate_supernodes(sf, tol=float(tol),
                                   max_width=max_supernode,
                                   native=options.native)
    return sf, bvals
