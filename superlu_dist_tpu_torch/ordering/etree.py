"""Elimination tree and postorder.

Analog of sp_coletree_dist / TreePostorder_dist (SRC/etree.c:222) — but we
compute the etree of a *symmetrized* pattern (see
sparse.formats.symmetrize_pattern), which under static pivoting gives the
exact elimination structure, where the reference uses the column etree of
AᵀA as an upper bound for partial pivoting.

Liu's algorithm with path compression, O(nnz·α), in numpy/python.
"""

from __future__ import annotations

import numpy as np


def etree_symmetric(n: int, indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """parent[j] of the elimination tree of a symmetric-pattern CSR/CSC matrix.

    Only entries below the diagonal (j < i when scanning row i) are used, so
    either triangle or the full pattern may be passed.  Roots get parent -1.
    """
    parent = np.full(n, -1, dtype=np.int64)
    ancestor = np.full(n, -1, dtype=np.int64)
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    for i in range(n):
        for j in indices[indptr[i]:indptr[i + 1]]:
            j = int(j)
            # walk from j up to the root of its subtree, compressing to i
            while j != -1 and j < i:
                nxt = ancestor[j]
                ancestor[j] = i
                if nxt == -1:
                    parent[j] = i
                    break
                j = int(nxt)
    return parent


def children_lists(parent: np.ndarray):
    """Children adjacency (first_child/next_sibling style, vectorized)."""
    n = len(parent)
    order = np.argsort(parent, kind="stable")
    counts = np.bincount(parent[parent >= 0], minlength=n)
    # skip roots (parent == -1 sorts first)
    nroots = int(np.sum(parent == -1))
    child_ptr = np.zeros(n + 1, dtype=np.int64)
    child_ptr[1:] = np.cumsum(counts)
    child_list = order[nroots:]
    return child_ptr, child_list


def postorder(parent: np.ndarray) -> np.ndarray:
    """Postorder permutation: post[new] = old node id, children before parents.

    Iterative DFS over the children lists (TreePostorder_dist analog).
    """
    n = len(parent)
    child_ptr, child_list = children_lists(parent)
    post = np.empty(n, dtype=np.int64)
    out = 0
    stack = []
    roots = np.flatnonzero(parent == -1)
    # visit roots in natural order; push children reversed so DFS pops
    # the smallest-numbered child first (stable, matches recursive defn)
    for r in roots[::-1]:
        stack.append((int(r), False))
    while stack:
        node, expanded = stack.pop()
        if expanded:
            post[out] = node
            out += 1
            continue
        stack.append((node, True))
        for c in child_list[child_ptr[node]:child_ptr[node + 1]][::-1]:
            stack.append((int(c), False))
    assert out == n
    return post


def tree_levels(parent: np.ndarray) -> np.ndarray:
    """level[j] = height of j in the tree: leaves 0, parent > max(children).

    All nodes at one level are independent and factor as one batch.  It
    replaces the reference's etree-based static schedule
    (dstatic_schedule.c:46).
    """
    n = len(parent)
    level = np.zeros(n, dtype=np.int64)
    # process in topological order: children before parents.  Any postorder
    # works; node indices are NOT guaranteed topological pre-relabel, so use
    # postorder explicitly.
    for j in postorder(parent):
        p = parent[j]
        if p >= 0:
            level[p] = max(level[p], level[j] + 1)
    return level
