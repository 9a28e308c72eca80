"""Supernodal symbolic factorization.

Capability analog of the reference's serial symbolic factorization
(symbfact, SRC/symbfact.c:80: column DFS, T2 supernode detection, relaxed
supernodes via relax_snode at :224) — redesigned for a batched-front numeric phase:

* The pattern is structurally symmetrized first (sparse.formats.
  symmetrize_pattern).  Under static pivoting (GESP — no row exchanges
  during factorization, reference pdgstrf2.c:218) the LU fill of a
  symmetric pattern equals the Cholesky fill of that pattern, so the
  symbolic phase is exact and L and U share one structure (U = Lᵀ pattern),
  halving the bookkeeping.
* Row structures are computed per *supernode*, not per column: for a
  supernode with root (last) column r, the below-diagonal structure equals
  struct(r) — by the etree subset theorem struct(j)\\{parent(j)} ⊆
  struct(parent(j)), applied along the path from any member column to r.
  Bottom-up set unions over the supernode tree give O(fill)-ish work.
* Supernodes = relaxed leaf subtrees (≤ `relax` columns; reference NREL,
  sp_ienv(2)) plus zero-extra-fill chain merges capped at `max_supernode`
  (reference NSUP, sp_ienv(3)).  The merge test — child's row structure
  exactly equals parent's columns ∪ parent's rows, with contiguous column
  ranges — recovers the fundamental supernodes the reference's T2 test
  finds, at supernode granularity.

The output feeds the FactorPlan ("distribution" analog, numeric.plan) that
maps supernodes onto level-batched dense fronts on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from superlu_dist_tpu_torch.sparse.formats import SparseCSR, invert_perm
from superlu_dist_tpu_torch.ordering.etree import etree_symmetric, postorder


@dataclasses.dataclass
class SymbolicFact:
    n: int
    perm: np.ndarray          # combined fill-reducing + postorder: new k <- old perm[k]
    parent: np.ndarray        # column etree in final labels
    sn_start: np.ndarray      # (ns+1,) supernode column ranges [start, end)
    col_to_sn: np.ndarray     # (n,)
    sn_rows: list             # per supernode: sorted below-diagonal rows (final labels)
    sn_parent: np.ndarray     # (ns,) parent supernode id or -1
    sn_level: np.ndarray      # (ns,) batching level (leaves 0)
    nnz_L: int                # including the dense diagonal-block lower triangle
    nnz_U: int
    flops: float              # factorization flop estimate
    pattern_indptr: np.ndarray = None    # symmetrized pattern permuted by `perm` (CSR)
    pattern_indices: np.ndarray = None
    value_perm: np.ndarray = None        # gather map: permuted-pattern values
                                         # = sym_pattern.data[value_perm]

    @property
    def n_supernodes(self) -> int:
        return len(self.sn_start) - 1

    def sn_width(self, s: int) -> int:
        return int(self.sn_start[s + 1] - self.sn_start[s])


def symbolic_factorize(sym_pattern: SparseCSR, order: np.ndarray,
                       relax: int = 20, max_supernode: int = 256,
                       stats=None, amalg_tol: float = 1.2) -> SymbolicFact:
    """Symbolic phase on a symmetrized pattern with a fill-reducing order.

    Returns all structures in the final (order ∘ postorder) labeling.
    When `stats` is given, the etree+postorder step is timed into the ETREE
    phase (the reference times sp_colorder separately from symbfact,
    pdgssvx.c:1044-1073).

    amalg_tol > 1 enables fill-tolerant supernode amalgamation
    (amalgamate_supernodes); 0 disables.  The reference's zero-fill T2
    supernodes leave median widths of ~1 on 3D-mesh problems, and skinny
    panels waste a batched dense factorization, so fill-tolerant merging
    is the default.
    """
    import contextlib

    n = sym_pattern.n_rows
    relax = min(relax, max_supernode)

    # ---- permute, etree, postorder, combine --------------------------------
    b0 = sym_pattern.permute(order, order)
    with (stats.timer("ETREE") if stats is not None
          else contextlib.nullcontext()):
        parent0 = etree_symmetric(n, b0.indptr, b0.indices)
        post = postorder(parent0)
    inv_post = invert_perm(post)
    perm = np.asarray(order, dtype=np.int64)[post]
    old_parents = parent0[post]
    parent = np.where(old_parents >= 0, inv_post[np.clip(old_parents, 0, None)], -1)
    # permute once, carrying entry ids so later refactorizations can align
    # values with a single gather instead of re-permuting (SamePattern reuse)
    tracer = SparseCSR(n, n, sym_pattern.indptr, sym_pattern.indices,
                       np.arange(sym_pattern.nnz, dtype=np.int64))
    b = tracer.permute(perm, perm)
    indptr, indices, value_perm = b.indptr, b.indices, b.data

    # ---- supernode partition + row structures ------------------------------
    sn_start, col_to_sn, sn_rows, sn_parent = build_supernodes_py(
        n, indptr, indices, parent, relax, max_supernode)
    sn_level = np.zeros(len(sn_rows), dtype=np.int64)
    for s in range(len(sn_rows)):
        p = sn_parent[s]
        if p >= 0:
            sn_level[p] = max(sn_level[p], sn_level[s] + 1)
    us = np.array([len(r) for r in sn_rows], dtype=np.int64)
    sf = _finish(n, perm, parent, sn_start, col_to_sn, sn_rows, sn_parent,
                 sn_level, us, indptr, indices, value_perm)
    return _amalg_if(sf, amalg_tol, max_supernode)


def build_supernodes_py(n, indptr, indices, parent, relax, max_supernode,
                        strict: bool = True):
    """Relaxed-leaf supernode partition + bottom-up row structures +
    zero-fill chain merging.  Returns (sn_start,
    col_to_sn, sn_rows, sn_parent); sn_parent is -1 for roots (columns
    whose structure is empty or leaves the n-column range).

    strict asserts relaxed-subtree contiguity, which postordered labels
    guarantee; strict=False lets non-contiguous subtrees of partially
    ordered labels degrade to singleton starts."""
    # ---- relaxed leaf supernodes (relax_snode analog) ----------------------
    cnt = np.ones(n, dtype=np.int64)
    for j in range(n):
        p = parent[j]
        if p >= 0:
            cnt[p] += cnt[j]
    is_relaxed_root = (cnt <= relax) & np.where(
        parent >= 0, cnt[np.clip(parent, 0, None)] > relax, True)
    starts = []
    j = 0
    relaxed_roots = np.flatnonzero(is_relaxed_root)
    root_iter = iter(relaxed_roots)
    next_root = next(root_iter, None)
    while j < n:
        if not strict:
            # skip roots whose subtree window we already walked past
            # (non-postordered labels make windows overlap) BEFORE the
            # append: advancing after it re-appended the same j and
            # manufactured a zero-width duplicate supernode
            while (next_root is not None
                   and next_root - cnt[next_root] + 1 < j):
                next_root = next(root_iter, None)
        starts.append(j)
        if next_root is not None and next_root - cnt[next_root] + 1 == j:
            j = int(next_root) + 1
            next_root = next(root_iter, None)
        else:
            if strict:
                assert (next_root is None
                        or j < next_root - cnt[next_root] + 1), \
                    "relaxed subtrees must be contiguous and disjoint"
            j += 1
    starts.append(n)
    first = np.array(starts[:-1], dtype=np.int64)
    last = np.array(starts[1:], dtype=np.int64) - 1
    ns0 = len(first)
    col_to_sn0 = np.repeat(np.arange(ns0), last - first + 1)

    # ---- bottom-up structures + zero-fill chain merging --------------------
    rows_of: list = [None] * ns0
    kids: list[list[int]] = [[] for _ in range(ns0)]
    alive = np.ones(ns0, dtype=bool)
    by_last = {int(l): s for s, l in enumerate(last)}   # live supernode by last col

    for s in range(ns0):
        l = int(last[s])
        pieces = [np.empty(0, dtype=np.int64)]
        for j in range(int(first[s]), l + 1):
            rj = indices[indptr[j]:indptr[j + 1]]
            pieces.append(rj[rj > l].astype(np.int64))
        for g in kids[s]:
            rg = rows_of[g]
            pieces.append(rg[rg > l])
        rows = np.unique(np.concatenate(pieces))
        rows_of[s] = rows
        # chain-merge the supernode ending just before first[s] while the
        # merge adds no fill: rows(c) ≡ cols(s) ∪ rows(s), contiguous cols
        while True:
            c = by_last.get(int(first[s]) - 1)
            if c is None or not alive[c]:
                break
            if int(last[s]) - int(first[c]) + 1 > max_supernode:
                break
            rc = rows_of[c]
            if (len(rc) == 0 or rc[0] != first[s]
                    or len(rc) != (last[s] - first[s] + 1) + len(rows)):
                break
            del by_last[int(last[c])]
            alive[c] = False
            first[s] = first[c]
        if len(rows) and rows[0] < n:
            kids[int(col_to_sn0[rows[0]])].append(s)

    # ---- compact to live supernodes ----------------------------------------
    live = np.flatnonzero(alive)
    ns = len(live)
    sn_start = np.concatenate([first[live], [n]]).astype(np.int64)
    assert np.all(np.diff(sn_start) > 0)
    col_to_sn = np.repeat(np.arange(ns), np.diff(sn_start))
    sn_rows = [rows_of[s] for s in live]
    sn_parent = np.full(ns, -1, dtype=np.int64)
    for s in range(ns):
        if len(sn_rows[s]) and sn_rows[s][0] < n:
            sn_parent[s] = col_to_sn[sn_rows[s][0]]
        assert sn_parent[s] > s or sn_parent[s] == -1
    return sn_start, col_to_sn, sn_rows, sn_parent


def _amalg_if(sf: SymbolicFact, tol, max_width: int) -> SymbolicFact:
    if tol and tol > 1.0 and sf.n_supernodes > 1:
        return amalgamate_supernodes(sf, tol=float(tol), max_width=max_width)
    return sf


def _front_flops(w, u):
    """Dense partial-factorization flops of a front: LU(w) + two
    triangular solves (w²u each) + Schur GEMM (2wu²)."""
    w = np.asarray(w, dtype=float)
    u = np.asarray(u, dtype=float)
    return 2.0 / 3.0 * w ** 3 + 2.0 * w * w * u + 2.0 * w * u * u


def amalgamate_supernodes(sf: SymbolicFact, tol: float = 1.2,
                          max_width: int = 1024, narrow: int = 64,
                          hard_tol: float = 4.0) -> SymbolicFact:
    """Fill-tolerant supernode amalgamation (the classic multifrontal
    relaxation, applied over the whole tree rather than only at leaves as
    the reference's relax_snode does, SRC/symbfact.c:224).

    Greedily merges each supernode p with the column-adjacent supernode c
    ending exactly at p's first column when find(parent(c)) == p — i.e. the
    rightmost descendant path — while the merged front's dense flops stay
    within `tol`× the *original* (pre-amalgamation) flops of its
    constituent supernodes, or within `hard_tol`× when the merged width is
    still ≤ `narrow` (skinny supernodes waste a batched dense kernel enough that extra
    fill is cheaper than a rank-1-class GEMM).  Testing against original
    constituent flops (not the current pair) keeps chained merges from
    compounding: total structure flops stay ≤ max(tol, hard_tol)× the
    input structure's.  Explicit zeros are stored and factored like any
    front entry; the flop/nnz counts returned are those of the amalgamated
    structure (the reference likewise counts its relaxed-supernode zeros
    in ops[FACT]).

    Motivation: on 3D Poisson with an ND order the unamalgamated median
    supernode width is 1, and padded batched fronts then execute many
    times the structural flops.
    """
    ns = sf.n_supernodes
    start = sf.sn_start
    us0 = np.array([len(r) for r in sf.sn_rows], dtype=np.int64)
    first = start[:-1].copy()
    end = start[1:].copy()              # exclusive end column; fixed
    rows_of = list(sf.sn_rows)
    alive = np.ones(ns, dtype=bool)
    rep = np.arange(ns)
    col_to_sn = sf.col_to_sn
    # original constituent flops per live supernode (the merge budget)
    base = np.asarray(_front_flops(np.diff(start), us0), dtype=float)

    def find(s: int) -> int:
        while rep[s] != s:
            rep[s] = rep[rep[s]]
            s = rep[s]
        return s

    by_end = {int(end[s]): s for s in range(ns)}
    for p in range(ns):
        if not alive[p]:
            continue
        while True:
            c = by_end.get(int(first[p]))
            if c is None:
                break
            c = find(c)
            if not alive[c]:
                break
            rc = rows_of[c]
            if len(rc) == 0 or find(int(col_to_sn[rc[0]])) != p:
                break
            w_c = int(end[c] - first[c])
            w_p = int(end[p] - first[p])
            w_m = w_c + w_p
            if w_m > max_width:
                break
            rp = rows_of[p]
            merged = np.union1d(rc[rc >= end[p]], rp)
            fl_m = float(_front_flops(w_m, len(merged)))
            budget = base[p] + base[c]
            if not (fl_m <= tol * budget
                    or (w_m <= narrow and fl_m <= hard_tol * budget)):
                break
            del by_end[int(first[p])]
            first[p] = first[c]
            rows_of[p] = merged
            alive[c] = False
            rep[c] = p
            base[p] = budget
    live = np.flatnonzero(alive)
    old2new = -np.ones(ns, dtype=np.int64)
    old2new[live] = np.arange(len(live))
    sn_start = np.concatenate([first[live], [sf.n]]).astype(np.int64)
    col_to_sn_new = np.repeat(np.arange(len(live)), np.diff(sn_start))
    sn_rows = [rows_of[s] for s in live]
    sn_parent = np.full(len(live), -1, dtype=np.int64)
    for i in range(len(live)):
        r = sn_rows[i]
        if len(r):
            sn_parent[i] = old2new[find(int(col_to_sn[r[0]]))]
    sn_level = np.zeros(len(live), dtype=np.int64)
    for i in range(len(live)):
        p = sn_parent[i]
        if p >= 0:
            sn_level[p] = max(sn_level[p], sn_level[i] + 1)
    us = np.array([len(r) for r in sn_rows], dtype=np.int64)
    return _finish(sf.n, sf.perm, sf.parent, sn_start, col_to_sn_new,
                   sn_rows, sn_parent, sn_level, us, sf.pattern_indptr,
                   sf.pattern_indices, sf.value_perm)


def supernode_nnz(widths, us) -> tuple:
    """(nnz of the dense diagonal-block triangles, nnz of the rectangular
    panels) for supernode widths w and below-diagonal row counts u.

    Promotes to int64 BEFORE the products: w·u and w·(w+1)/2 wrap int32
    at supernode scale (w=u=50,000 → 2.5·10^9 > 2^31) even though every
    individual width/count fits easily — the int_t accumulator
    discipline."""
    w = np.asarray(widths, dtype=np.int64)
    u = np.asarray(us, dtype=np.int64)
    return (int(np.sum(w * (w + 1) // 2)), int(np.sum(w * u)))


def dispatch_dependencies(sn_parent) -> np.ndarray:
    """Per-supernode count of direct dispatch dependencies for the
    dataflow scheduler (numeric/plan.py): supernode s may be dispatched
    once every child that extend-adds a Schur block into s's front has
    been dispatched in an earlier group.  Under the multifrontal
    structure every below-diagonal row of a child lies in an ancestor's
    column range and the Schur scatter targets exactly the PARENT front
    (the dscatter.c:111 analog in plan.ChildSet), so the dependency
    graph over Schur scatter targets is precisely the supernode etree —
    reachability beyond the parent is transitive through it.  Returns
    the in-degree (number of children) of each supernode."""
    sn_parent = np.asarray(sn_parent, dtype=np.int64)
    deps = np.zeros(len(sn_parent), dtype=np.int64)
    has_p = sn_parent >= 0
    np.add.at(deps, sn_parent[has_p], 1)
    return deps


def _finish(n, perm, parent, sn_start, col_to_sn, sn_rows, sn_parent,
            sn_level, us, indptr, indices, value_perm) -> SymbolicFact:
    widths = np.diff(sn_start)
    nnz_tri, nnz_rect = supernode_nnz(widths, us)
    w = np.asarray(widths, dtype=float)
    u = np.asarray(us, dtype=float)
    flops = float(np.sum(2.0 / 3.0 * w ** 3 + 2.0 * w ** 2 * u + 2.0 * w * u ** 2))
    return SymbolicFact(
        n=n, perm=perm, parent=parent, sn_start=sn_start, col_to_sn=col_to_sn,
        sn_rows=sn_rows, sn_parent=sn_parent, sn_level=sn_level,
        nnz_L=nnz_tri + nnz_rect, nnz_U=nnz_tri + nnz_rect, flops=flops,
        pattern_indptr=indptr, pattern_indices=indices, value_perm=value_perm)
