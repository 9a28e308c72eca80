"""COLAMD-class column ordering + AᵀA pattern (MMD_ATA support).

Capability analogs of the reference's colamd (SRC/colamd.c, dispatched for
colperm_t COLAMD) and getata_dist (SRC/get_perm_c.c:164, the AᵀA pattern
behind MMD_ATA) — both fresh implementations, not translations.

The COLAMD idea (as published by Davis/Gilbert/Larimore/Ng): order the
columns of A by approximate minimum degree in AᵀA *without forming AᵀA*.
The rows of A serve as the initial quotient-graph elements; eliminating a
column merges every element containing it into one fill element whose
column set is the union; a column's score is the sum of its live element
sizes — an upper bound on its external degree in AᵀA.  Dense rows are
dropped from the analysis and dense columns ordered last so one dense
stripe cannot poison every score.

The native implementation (slu_host.cpp slu_colamd / slu_ata_pattern) is
the default path; the Python versions here are the specification and
test oracle (same tie-breaking: smallest column id on equal score), run
under ``native=False``.
"""

from __future__ import annotations

import heapq

import numpy as np

from superlu_dist_tpu_torch import native as slu_host


def dense_row_threshold(n: int) -> int:
    """Single definition of the colamd dense-row/column heuristic cutoff
    (entries > 10·sqrt(n) ⇒ sidelined).  Used by the Python oracle, the
    MMD_ATA dispatch, and mirrored by the C++ fast path
    (slu_host.cpp slu_colamd / slu_ata_pattern — keep in sync)."""
    return max(16, int(10.0 * np.sqrt(max(n, 1))))


def colamd_order(n_rows: int, n_cols: int, indptr: np.ndarray,
                 indices: np.ndarray, native: bool = True) -> np.ndarray:
    """Return order[k] = old index of the k-th pivot column."""
    if native:
        return slu_host.colamd(n_rows, n_cols, indptr, indices)
    return _colamd_py(n_rows, n_cols, indptr, indices)


def _colamd_py(n_rows, n_cols, indptr, indices):
    dense_row = dense_row_threshold(n_cols)
    dense_col = dense_row_threshold(n_rows)
    elem_cols = {}                       # element id -> sorted col list
    col_elems = [[] for _ in range(n_cols)]
    for r in range(n_rows):
        cols = sorted(set(int(j) for j in indices[indptr[r]:indptr[r + 1]]))
        if len(cols) > dense_row:
            continue
        elem_cols[r] = cols
        for j in cols:
            col_elems[j].append(r)
    alive = np.ones(n_cols, dtype=bool)
    score = np.zeros(n_cols, dtype=np.int64)
    dense_cols = []

    def col_score(j):
        s = sum(len(elem_cols[e]) - 1 for e in col_elems[j]
                if e in elem_cols)
        return min(max(s, 0), n_cols - 1)

    heap = []
    for j in range(n_cols):
        if len(col_elems[j]) > dense_col:
            alive[j] = False
            dense_cols.append(j)
            continue
        score[j] = col_score(j)
        heap.append((int(score[j]), j))
    heapq.heapify(heap)
    for j in dense_cols:
        for e in col_elems[j]:
            if e in elem_cols and j in elem_cols[e]:
                elem_cols[e].remove(j)
    dense_cols.sort(key=lambda j: (len(col_elems[j]), j))

    order = np.empty(n_cols, dtype=np.int64)
    k = 0
    n_live = n_cols - len(dense_cols)
    while k < n_live:
        while True:
            s, c = heapq.heappop(heap)
            if alive[c] and s == score[c]:
                break
        order[k] = c
        alive[c] = False
        merged = set()
        for e in col_elems[c]:
            if e in elem_cols:
                merged.update(elem_cols[e])
                del elem_cols[e]
        merged.discard(c)
        live = sorted(j for j in merged if alive[j])
        eid = n_rows + k
        elem_cols[eid] = live
        # aggressive absorption (the colamd trick): an old element whose
        # every LIVE column lies
        # inside the new element is dominated by it — drop it, which
        # tightens the scores AND stops the per-column element lists
        # from accumulating (the 3D-mesh slowdown)
        live_set = set(live)
        tested = set()
        for j in live:
            for e in col_elems[j]:
                if e == eid or e in tested or e not in elem_cols:
                    continue
                tested.add(e)
                if all(not alive[x] or x in live_set
                       for x in elem_cols[e]):
                    del elem_cols[e]
        for j in live:
            col_elems[j] = [e for e in col_elems[j]
                            if e in elem_cols] + [eid]
            score[j] = col_score(j)
            heapq.heappush(heap, (int(score[j]), j))
        k += 1
    for j in dense_cols:
        order[k] = j
        k += 1
    return order


def ata_adjacency(n_rows: int, n_cols: int, indptr: np.ndarray,
                  indices: np.ndarray, dense_row: int = 0,
                  native: bool = True):
    """Symmetric adjacency (no diagonal) of AᵀA in CSR form — the
    getata_dist analog.  Every row of A is a clique over its column
    support; rows longer than dense_row (when > 0) are dropped."""
    if native:
        return slu_host.ata_pattern(n_rows, n_cols, indptr, indices,
                                    dense_row)
    adj = [set() for _ in range(n_cols)]
    for r in range(n_rows):
        cols = list(set(int(j) for j in indices[indptr[r]:indptr[r + 1]]))
        if len(cols) <= 1 or (dense_row > 0 and len(cols) > dense_row):
            continue
        cs = set(cols)
        for j in cols:
            adj[j].update(cs - {j})
    out_ptr = np.zeros(n_cols + 1, dtype=np.int64)
    out_idx = []
    for j in range(n_cols):
        s = sorted(adj[j])
        out_idx.extend(s)
        out_ptr[j + 1] = out_ptr[j] + len(s)
    return out_ptr, np.asarray(out_idx, dtype=np.int64)
