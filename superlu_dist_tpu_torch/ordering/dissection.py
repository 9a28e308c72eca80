"""Nested-dissection fill-reducing orderings.

Capability analog of the reference's METIS_AT_PLUS_A / ParMETIS orderings
(SRC/get_perm_c.c:90, get_perm_c_parmetis.c:255).  Two implementations:

* :func:`geometric_nd` — exact recursive coordinate bisection for matrices
  that carry a ``grid_shape`` attribute (the model-problem gallery).  For a
  d-dimensional grid this gives the optimal O(n^{ (d+? )}) fill growth the
  reference obtains from ParMETIS on mesh problems (SURVEY.md §5).
* :func:`bfs_nd` — general-graph nested dissection using BFS level-set
  separators from a pseudo-peripheral vertex (numpy-vectorized frontiers),
  recursing until small leaves.

Both return an elimination *order* (order[k] = old index of the k-th pivot).
"""

from __future__ import annotations

import numpy as np


def geometric_nd(grid_shape) -> np.ndarray:
    """Recursive coordinate bisection on a structured grid."""
    dims = tuple(int(d) for d in grid_shape)
    n = int(np.prod(dims))
    strides = np.array([int(np.prod(dims[i + 1:])) for i in range(len(dims))],
                       dtype=np.int64)
    out = np.empty(n, dtype=np.int64)
    pos = 0
    # stack of boxes: (lo tuple, hi tuple) half-open
    stack = [(tuple(0 for _ in dims), dims)]
    emit_stack = []   # (box, kind) processed iteratively: we emit via explicit
                      # ordering: children first then separator, so run a
                      # post-order traversal with an explicit output list.

    def box_indices(lo, hi):
        slices = [np.arange(l, h) for l, h in zip(lo, hi)]
        grids = np.meshgrid(*slices, indexing="ij")
        idx = np.zeros_like(grids[0])
        for g, s in zip(grids, strides):
            idx = idx + g * s
        return idx.ravel()

    def rec(lo, hi):
        nonlocal pos
        sizes = [h - l for l, h in zip(lo, hi)]
        if max(sizes) <= 3:
            idx = box_indices(lo, hi)
            out[pos:pos + len(idx)] = idx
            pos += len(idx)
            return
        ax = int(np.argmax(sizes))
        mid = (lo[ax] + hi[ax]) // 2
        lo1, hi1 = list(lo), list(hi)
        hi1[ax] = mid
        lo2, hi2 = list(lo), list(hi)
        lo2[ax] = mid + 1
        rec(tuple(lo1), tuple(hi1))
        rec(tuple(lo2), tuple(hi2))
        sep_lo, sep_hi = list(lo), list(hi)
        sep_lo[ax], sep_hi[ax] = mid, mid + 1
        idx = box_indices(tuple(sep_lo), tuple(sep_hi))
        out[pos:pos + len(idx)] = idx
        pos += len(idx)

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        rec(tuple(0 for _ in dims), dims)
    finally:
        sys.setrecursionlimit(old)
    assert pos == n
    return out


def _bfs_levels(indptr, indices, start, mask, comp_nodes):
    """BFS level sets within the masked subgraph; returns (levels dict list)."""
    level = {}
    frontier = [start]
    level_of = {start: 0}
    levels = [[start]]
    seen = {start}
    while frontier:
        nxt = []
        for u in frontier:
            for v in indices[indptr[u]:indptr[u + 1]]:
                v = int(v)
                if mask[v] and v not in seen:
                    seen.add(v)
                    nxt.append(v)
        if nxt:
            levels.append(nxt)
        frontier = nxt
    return levels, seen


def bfs_nd(n, indptr, indices, leaf_size: int = 32) -> np.ndarray:
    """General-graph nested dissection via BFS level-set separators."""
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    out = np.empty(n, dtype=np.int64)
    pos = 0
    mask = np.ones(n, dtype=bool)

    def emit(nodes):
        nonlocal pos
        out[pos:pos + len(nodes)] = nodes
        pos += len(nodes)

    stack = [np.arange(n, dtype=np.int64)]
    # Work items: ('part', nodes) to dissect, ('emit', nodes) to output.
    work = [("part", np.arange(n, dtype=np.int64))]
    while work:
        kind, nodes = work.pop()
        if kind == "emit":
            emit(nodes)
            continue
        if len(nodes) <= leaf_size:
            emit(nodes)
            continue
        sub = np.zeros(n, dtype=bool)
        sub[nodes] = True
        # find a connected component and a pseudo-peripheral vertex
        start = int(nodes[0])
        levels, seen = _bfs_levels(indptr, indices, start, sub, nodes)
        if len(seen) < len(nodes):
            # disconnected: split off this component, requeue the rest
            comp = np.fromiter(seen, dtype=np.int64)
            rest = nodes[~np.isin(nodes, comp)]
            work.append(("part", rest))
            work.append(("part", comp))
            continue
        # second BFS from the farthest vertex for a better diameter estimate
        far = levels[-1][0]
        levels, _ = _bfs_levels(indptr, indices, int(far), sub, nodes)
        if len(levels) <= 2:
            emit(nodes)      # tightly-coupled clique-ish blob: no separator
            continue
        sizes = np.array([len(l) for l in levels])
        half = np.searchsorted(np.cumsum(sizes), len(nodes) / 2.0)
        half = int(np.clip(half, 1, len(levels) - 2))
        sep = np.array(levels[half], dtype=np.int64)
        a_part = np.concatenate([np.array(l, dtype=np.int64)
                                 for l in levels[:half]])
        b_part = (np.concatenate([np.array(l, dtype=np.int64)
                                  for l in levels[half + 1:]])
                  if half + 1 < len(levels) else np.empty(0, dtype=np.int64))
        # order: A, B, then separator last (post-order emit via stack: push
        # reversed)
        work.append(("emit", sep))
        if len(b_part):
            work.append(("part", b_part))
        work.append(("part", a_part))
    assert pos == n, (pos, n)
    return out
