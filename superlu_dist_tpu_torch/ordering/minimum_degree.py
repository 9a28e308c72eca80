"""Minimum-degree fill-reducing ordering.

Capability analog of the reference's MMD (genmmd_dist_, SRC/mmd.c, 1025 LoC
of f2c'd Fortran) dispatched for ColPerm=MMD_AT_PLUS_A
(SRC/get_perm_c.c:463-530).  This is a fresh implementation of exact-external-
degree minimum degree on a quotient graph with element absorption — not a
translation.  The native library's ``slu_mmd`` (same algorithm and
tie-breaking, compiled) runs by default; the Python version here is the
specification, run under ``native=False``.  Intended for small/medium
graphs and test leaves; large problems should use nested dissection
(ordering.dissection).
"""

from __future__ import annotations

import heapq

import numpy as np

from superlu_dist_tpu_torch import native as slu_host


def minimum_degree(n: int, indptr: np.ndarray, indices: np.ndarray,
                   native: bool = True) -> np.ndarray:
    """Return an elimination order (order[k] = k-th pivot, old index).

    Input is the symmetric adjacency pattern (diagonal ignored).
    """
    if native:
        return slu_host.mmd(n, indptr, indices)
    adj = [set() for _ in range(n)]
    for i in range(n):
        for j in indices[indptr[i]:indptr[i + 1]]:
            j = int(j)
            if j != i:
                adj[i].add(j)
                adj[j].add(i)

    var_elems = [set() for _ in range(n)]   # elements adjacent to variable
    elem_vars = {}                           # element id -> variable set
    alive = np.ones(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)

    def external(v):
        s = set(adj[v])
        for e in var_elems[v]:
            s |= elem_vars[e]
        s.discard(v)
        return s

    heap = [(len(adj[v]), v) for v in range(n)]
    heapq.heapify(heap)
    degree = np.array([len(adj[v]) for v in range(n)], dtype=np.int64)

    for k in range(n):
        while True:
            d, v = heapq.heappop(heap)
            if alive[v] and d == degree[v]:
                break
        order[k] = v
        alive[v] = False
        le = external(v)                 # the new element's variable set
        # absorb v's elements
        for e in var_elems[v]:
            del elem_vars[e]
        eid = n + k
        elem_vars[eid] = le
        absorbed = set(var_elems[v])
        for u in le:
            adj[u].discard(v)
            adj[u] -= le                 # edges now covered by the element
            var_elems[u] -= absorbed
            var_elems[u].add(eid)
            s = set(adj[u])
            for e in var_elems[u]:
                s |= elem_vars[e]
            s.discard(u)
            nd = len(s)
            if nd != degree[u]:
                degree[u] = nd
                heapq.heappush(heap, (nd, u))
            else:
                heapq.heappush(heap, (nd, u))
    return order
